"""Mamba2 SSD chunked scan: the hand-written CUDA kernel and its plain version.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.ssd_scan.ssd_scan``: per (batch row, head) a sequential
loop over chunks of ``chunk`` positions computes the intra-chunk term
(masked decay matrix ``exp(cum_i - cum_j)`` times ``(C_i . B_j) dt_j``
applied to x), the inter-chunk term ``exp(cum_i) C_i . h`` and the state
update ``h <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j``.
Its bound on an H100 is operations; the source says what its design does
about it.

``ssd_scan`` launches the kernel for CUDA tensors and runs
``ssd_scan_plain`` (the ``repro.models.ssm.ssd_chunked`` algorithm) for CPU
tensors. ``mask`` (B, S), True at valid positions, zeroes x, dA, dt and B
at the pads before the scan, as the TPU kernel's wrapper does, so masked
positions neither write into nor decay the state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, exact_fp32

SSD_MAX_P = 64
SSD_MAX_N = 128
SSD_MAX_CHUNK = 256


def _apply_mask(x, dA, dt, Bm, mask):
    if mask is None:
        return x, dA, dt, Bm
    m = mask.to(device=x.device, dtype=torch.float32)
    return (x * m[:, :, None, None].to(x.dtype), dA * m[:, :, None].to(dA.dtype),
            dt * m[:, :, None].to(dt.dtype), Bm * m[:, :, None].to(Bm.dtype))


def ssd_scan_plain(x, dA, dt, Bm, Cm, *, mask=None, chunk=256):
    """x (B,S,H,P); dA, dt (B,S,H); Bm, Cm (B,S,N) -> (y (B,S,H,P) in x's
    dtype, final state (B,H,P,N) fp32). The SSD dual form in fp32: the tail
    is padded with zeros to a multiple of ``min(chunk, S)``."""
    x, dA, dt, Bm = _apply_mask(x, dA, dt, Bm, mask)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nc, Q, H, P)
    dAc = F.pad(dA.float(), (0, 0, 0, pad)).reshape(B, nc, Q, H)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(B, nc, Q, H)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    with exact_fp32():
        cum = torch.cumsum(dAc, dim=2)  # (B,nc,Q,H)
        # intra-chunk "attention": M[i,j] = exp(cum_i - cum_j) (C_i . B_j) dt_j, i >= j
        seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
        tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
        L = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
        cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
        M = cb[..., None] * L * dtc[:, :, None, :, :]
        y_diag = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
        # per-chunk state: S_c = sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
        w = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B,nc,Q,H)
        Sc = torch.einsum("bcjhp,bcjn->bchpn", xc * w[..., None], Bc)
        a_chunk = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
        h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
        h_prev = []
        for c in range(nc):  # inter-chunk recurrence
            h_prev.append(h)
            h = h * a_chunk[:, c, :, None, None] + Sc[:, c]
        h_in = torch.stack(h_prev, dim=1)  # (B,nc,H,P,N): state entering each chunk
        y_off = torch.einsum("bcin,bchpn->bcihp", Cc, h_in) * torch.exp(cum)[..., None]
        y = (y_diag + y_off).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h


def check_cuda_inputs(x, dA, dt, Bm, Cm, chunk) -> None:
    """Raise on what the CUDA kernel does not take."""
    if x.dim() != 4 or dA.dim() != 3 or dt.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError("x must be (B,S,H,P), dA/dt (B,S,H), Bm/Cm (B,S,N)")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if dA.shape != (B, S, H) or dt.shape != (B, S, H) or Bm.shape != (B, S, N) \
            or Cm.shape != (B, S, N):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} dA {tuple(dA.shape)} "
                         f"dt {tuple(dt.shape)} Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in DTYPES:
        raise ValueError(f"x, Bm, Cm must share one dtype of {list(DTYPES)}")
    if dA.dtype != torch.float32 or dt.dtype != torch.float32:
        raise ValueError("dA and dt must be float32")
    if len({t.device for t in (x, dA, dt, Bm, Cm)}) != 1:
        raise ValueError("x, dA, dt, Bm, Cm must lie on one device")
    if not all(t.is_contiguous() for t in (x, dA, dt, Bm, Cm)):
        raise ValueError("x, dA, dt, Bm, Cm must be contiguous")
    if S == 0 or P > SSD_MAX_P or N > SSD_MAX_N or not 0 < min(chunk, S) <= SSD_MAX_CHUNK:
        raise ValueError(f"the kernel takes S > 0, P <= {SSD_MAX_P}, N <= {SSD_MAX_N} and "
                         f"a chunk of at most {SSD_MAX_CHUNK}; got S {S}, P {P}, N {N}, "
                         f"chunk {chunk}")


def ssd_scan(x, dA, dt, Bm, Cm, *, mask=None, chunk=256):
    """x (B,S,H,P); dA, dt (B,S,H) fp32; Bm, Cm (B,S,N) -> (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) fp32)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dA, dt, Bm, Cm, mask=mask, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    x, dA, dt, Bm = _apply_mask(x, dA, dt, Bm, mask)
    check_cuda_inputs(x, dA, dt, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.ssd_scan_fwd(
            *(t.data_ptr() for t in (x, dA, dt, Bm, Cm, y, h)), B, S, H, P, N, min(chunk, S),
            build.DTYPE_CODES[DTYPES[x.dtype]], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ssd_scan_fwd")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
