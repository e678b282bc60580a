"""Mamba2 SSD chunked scan: the hand-written CUDA kernels and their plain versions.

The kernels replace the Pallas TPU kernel ``repro.kernels.ssd_scan.ssd_scan``:
per (batch row, head) and chunk of ``chunk`` positions, the intra-chunk term
(masked decay matrix ``exp(cum_i - cum_j)`` times ``(C_i . B_j) dt_j``
applied to x), the inter-chunk term ``exp(cum_i) C_i . h`` and the state
update ``h <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j``.
The route is chosen by dtype alone (``ssd_route``): bf16, which the serving
path runs, goes to the tensor cores (``csrc/ssd_scan_bf16.cu``: chunk
states and the fp32 state pass, then chunk outputs with ``C . B^T`` shared
by a pair of heads; two CUDA launches per call); fp32 runs exactly on the
CUDA cores (``csrc/ssd_scan.cu``, for the fp32 parity checks). Their bound
on an H100 at the serving shapes is bytes in bf16 (0.0327 ms at mamba2-2.7b
B=8 S=512, against 0.0165 ms of operations) and operations in fp32; the
sources say what their designs do about it.

``ssd_scan`` launches a kernel for CUDA tensors and runs ``ssd_scan_plain``
(the ``repro.models.ssm.ssd_chunked`` algorithm) for CPU tensors. Meta
tensors (the dry run) take the meta route: the card's checks, meta
outputs, the call's work on the op counter (``kernels.cost``).
``ssd_scan_split_plain`` repeats the bf16 kernel's own arithmetic (its
passes and its bf16 rounding points) for the CPU tests. ``mask`` (B, S),
True at valid positions, zeroes x, dA, dt and B at the pads before the
scan, as the TPU kernel's wrapper does, so masked positions neither write
into nor decay the state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, cost
from repro_torch.kernels.flash_attention import DTYPES, check_aligned, exact_fp32, refuse_grad

SSD_MAX_P = 64
SSD_MAX_N = 128
SSD_MAX_CHUNK = 256


def _apply_mask(x, dA, dt, Bm, mask):
    if mask is None:
        return x, dA, dt, Bm
    m = mask.to(device=x.device, dtype=torch.float32)
    return (x * m[:, :, None, None].to(x.dtype), dA * m[:, :, None].to(dA.dtype),
            dt * m[:, :, None].to(dt.dtype), Bm * m[:, :, None].to(Bm.dtype))


def ssd_chunked(x, dA, dt, Bm, Cm, *, chunk=256, cum_dtype=torch.float32):
    """The SSD dual-form chunked scan in fp32, the JAX package's
    ``repro.models.ssm.ssd_chunked``: Mamba2's train forward (as it is,
    differentiated by autograd) and, with an fp64 cum, the body of
    ``ssd_scan_plain``. x (B,S,H,P); dA (B,S,H) per-step log decay (dt * A,
    negative); dt (B,S,H); Bm, Cm (B,S,N) -> (y (B,S,H,P) in x's dtype,
    final state (B,H,P,N) fp32). The tail is padded with zeros to a
    multiple of ``min(chunk, S)``; cum is summed and differenced in
    ``cum_dtype``. The decay matrix exponentiates only its kept lower
    triangle (the reference exponentiates every entry and zeroes the upper
    one: the same values, but an entry that overflows there gives its
    gradient 0 * inf)."""
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
    cum = torch.cumsum(dAc.to(cum_dtype), dim=2)  # (B,nc,Q,H)
    # intra-chunk "attention": M[i,j] = exp(cum_i - cum_j) (C_i . B_j) dt_j, i >= j
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).float()  # (B,nc,Q,Q,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    L = torch.exp(torch.where(tri, seg, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    M = cb[..., None] * L * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
    # per-chunk state: S_c = sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
    w = torch.exp((cum[:, :, -1:, :] - cum).float()) * dtc  # (B,nc,Q,H)
    Sc = torch.einsum("bcjhp,bcjn->bchpn", xc * w[..., None], Bc)
    a_chunk = torch.exp(cum[:, :, -1, :].float())  # (B,nc,H)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):  # inter-chunk recurrence
        h_prev.append(h)
        h = h * a_chunk[:, c, :, None, None] + Sc[:, c]
    h_in = torch.stack(h_prev, dim=1)  # (B,nc,H,P,N): state entering each chunk
    y_off = torch.einsum("bcin,bchpn->bcihp", Cc, h_in) * torch.exp(cum.float())[..., None]
    y = (y_diag + y_off).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_scan_plain(x, dA, dt, Bm, Cm, *, mask=None, chunk=256):
    """x (B,S,H,P); dA, dt (B,S,H); Bm, Cm (B,S,N) -> (y (B,S,H,P) in x's
    dtype, final state (B,H,P,N) fp32): ``ssd_chunked`` with cum summed and
    differenced in fp64 (at large dt an fp32 cum costs y ~1e-3, as in the
    fp32 kernel) and fp32 products in full fp32, after the pad mask."""
    x, dA, dt, Bm = _apply_mask(x, dA, dt, Bm, mask)
    with exact_fp32():
        return ssd_chunked(x, dA, dt, Bm, Cm, chunk=chunk, cum_dtype=torch.float64)


def _bf16(t):
    """Round fp32 to bf16 (nearest even) and back, as the kernel's packs do."""
    return t.to(torch.bfloat16).float()


def _hi_lo(t):
    """fp32 as the sum of a bf16 hi part and a bf16 lo part (the rounding
    residual), as the kernel feeds an fp32 operand to the tensor cores:
    ~16 significant bits where bf16 alone keeps 8."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def ssd_scan_split_plain(x, dA, dt, Bm, Cm, *, mask=None, chunk=256):
    """What the bf16 kernels (``csrc/ssd_scan_bf16.cu``) compute, in plain
    PyTorch, rounding where they round. Their two passes:

    1. chunk states: cum = cumsum(dA) over each chunk; per chunk
       ``S_c = sum_j w_j x_j (x) B_j`` with ``w_j = exp(cum_last - cum_j)
       dt_j``, the fp32 ``w_j x_j`` fed to the tensor cores as bf16 hi +
       lo; the fp32 state pass ``h <- exp(cum_last) h + S_c`` hands each
       chunk the state entering it, as bf16 hi + lo;
    2. chunk outputs: ``C_i . B_j`` in fp32, once for a pair of heads; per
       head the masked decay matrix ``M_ij = CB_ij exp(cum_i - cum_j) dt_j``
       (j <= i) as bf16 hi + lo, ``y = M x + exp(cum_i) C_i . h_in``.

    x, B and C are rounded to bf16 first (the kernels take bf16 only); the
    products of bf16 operands are exact in fp32. Returns (y in x's dtype,
    final state fp32)."""
    x, dA, dt, Bm = _apply_mask(x, dA, dt, Bm, mask)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xc = _bf16(F.pad(x.float(), (0, 0, 0, 0, 0, pad))).reshape(B, nc, Q, H, P)
    dAc = F.pad(dA.float(), (0, 0, 0, pad)).reshape(B, nc, Q, H)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(B, nc, Q, H)
    Bc = _bf16(F.pad(Bm.float(), (0, 0, 0, pad))).reshape(B, nc, Q, N)
    Cc = _bf16(F.pad(Cm.float(), (0, 0, 0, pad))).reshape(B, nc, Q, N)
    with exact_fp32():
        cum = torch.cumsum(dAc, dim=2)  # (B,nc,Q,H)
        # pass 1: chunk states, then the sequential state pass in fp32
        wx = _hi_lo(xc * (torch.exp(cum[:, :, -1:, :] - cum) * dtc)[..., None])
        Sc = torch.einsum("bcjhp,bcjn->bchpn", wx, Bc)
        decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
        h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
        h_in = []
        for c in range(nc):
            h_in.append(_hi_lo(h))
            h = h * decay[:, c, :, None, None] + Sc[:, c]
        h_in = torch.stack(h_in, dim=1)  # (B,nc,H,P,N)
        # pass 2: C.B^T shared by the heads, the masked decay matrix per head
        cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
        seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
        tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
        L = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
        M = _hi_lo(cb[..., None] * L * dtc[:, :, None, :, :])
        y = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
        y = y + torch.einsum("bcin,bchpn->bcihp", Cc, h_in) * torch.exp(cum)[..., None]
        y = y.reshape(B, nc * Q, H, P)[:, :S]
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


def ssd_route(dtype) -> str:
    """The C entry point for a dtype, by dtype alone: bf16 to the
    tensor-core kernels, fp32 to the exact CUDA-core kernel."""
    routes = {torch.bfloat16: "ssd_scan_fwd_bf16", torch.float32: "ssd_scan_fwd_fp32"}
    if dtype not in routes:
        raise ValueError(f"ssd_scan has no kernel for {dtype}")
    return routes[dtype]


def ssd_checks(x, dA, dt, Bm, Cm, chunk) -> str:
    """Raise on what the kernels do not take; return the C entry point of
    x's dtype (``ssd_route``). The wrapper calls it before a launch."""
    check_cuda_inputs(x, dA, dt, Bm, Cm, chunk)
    route = ssd_route(x.dtype)
    if x.dtype == torch.bfloat16:
        P, N = x.shape[-1], Bm.shape[-1]
        if P % 16 or N % 16:
            raise ValueError(f"the bf16 SSD kernel takes P and N that are multiples of 16; "
                             f"got P {P}, N {N}")
        check_aligned(x, Bm, Cm)
    return route


def ssd_scan(x, dA, dt, Bm, Cm, *, mask=None, chunk=256):
    """x (B,S,H,P); dA, dt (B,S,H) fp32; Bm, Cm (B,S,N) -> (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) fp32). One call counts one launch,
    whatever the number of CUDA launches of its route."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dA, dt, Bm, Cm, mask=mask, chunk=chunk)
    refuse_grad("ssd_scan", "kernels.ssd_scan.ssd_chunked", x, dA, dt, Bm, Cm)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    x, dA, dt, Bm = _apply_mask(x, dA, dt, Bm, mask)
    route = ssd_checks(x, dA, dt, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if x.is_meta:
        return cost.meta_call("ssd_scan", cost.ssd_work(B, S, H, P, N, chunk, x.element_size()),
                              torch.empty_like(x), x.new_empty((B, H, P, N), dtype=torch.float32))
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, dA, dt, Bm, Cm, y, h)]
    if route == "ssd_scan_fwd_bf16":
        nc = -(-S // Q)
        # the state entering each chunk after the first (bf16 hi, lo) and
        # each chunk's cum (log2 units) and dt per head, for the output pass
        h_in = torch.empty((B, nc - 1, H, 2, P, N), dtype=torch.bfloat16, device=x.device)
        cdt = torch.empty((2, B, H, nc * Q), dtype=torch.float32, device=x.device)
        ptrs += [h_in.data_ptr(), cdt.data_ptr()]
    lib = build.load_library()
    with torch.cuda.device(x.device):
        rc = getattr(lib, route)(*ptrs, B, S, H, P, N, Q,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, route)
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
