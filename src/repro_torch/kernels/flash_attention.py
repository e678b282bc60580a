"""Prefill attention: the hand-written CUDA kernel and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: blockwise online-softmax
attention with causal mask, sliding window, logit softcap ``c*tanh(s/c)``,
GQA (kv head ``h // G``, no repeated KV) and ``q_offset``/``kv_len``, which
here may be per batch row. Its bound on an H100 is FLOPs at the serving
path's prefill shapes; the source says what its design does about it.

``flash_attention`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors. Both give 0 for a query row that
keeps no key, as the TPU kernel does (``repro.models.attention
.full_attention`` gives the mean of v there instead; the serving path never
has such a row).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
FLASH_DV = (32, 64, 128, 256)
_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may opt into


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in full fp32, not TF32, whatever the process set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def per_row(x, B: int, device) -> torch.Tensor:
    """A scalar or (B,) position/length as a contiguous (B,) int32 tensor."""
    if isinstance(x, (int, np.integer)):
        return torch.full((B,), int(x), dtype=torch.int32, device=device)
    t = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    return t.expand(B).contiguous() if t.numel() == 1 else t.contiguous()


def attention_plain(q, k, v, *, causal, window, softcap, q_offset, kv_len, scale):
    """The kernels' arithmetic with materialised scores: fp32 scores and
    softmax state, per-row q_offset/kv_len, 0 for a row that keeps no key."""
    B, Sq, H, Dk = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    dev = q.device
    with exact_fp32():
        s = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(B, Sq, Hkv, G, Dk),
                         k.float()) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        qpos = per_row(q_offset, B, dev)[:, None] + torch.arange(Sq, device=dev)  # (B,Sq)
        kpos = torch.arange(Sk, device=dev)
        klen = per_row(Sk if kv_len is None else kv_len, B, dev)
        keep = (kpos < klen[:, None, None]).expand(B, Sq, Sk)
        if causal:
            keep = keep & (kpos <= qpos[..., None])
        if window is not None:
            keep = keep & ((qpos[..., None] - kpos) < window)
        keep = keep[:, None, None]  # (B,1,1,Sq,Sk)
        s = s.masked_fill(~keep, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * keep
        p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          q_offset=0, kv_len=None, scale=None):
    """q (B,Sq,H,Dk); k (B,Sk,Hkv,Dk); v (B,Sk,Hkv,Dv) -> (B,Sq,H,Dv)."""
    return attention_plain(q, k, v, causal=causal, window=window, softcap=softcap,
                           q_offset=q_offset, kv_len=kv_len, scale=scale)


def check_cuda_inputs(q, k, v, dvs) -> None:
    """Raise on what the CUDA kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, head_dim)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"q, k, v must share one dtype of {list(DTYPES)}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    B, _, H, Dk = q.shape
    if k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[-1] != Dk:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} q heads are not a multiple of {k.shape[2]} kv heads")
    if v.shape[-1] not in dvs:
        raise ValueError(f"value head dim {v.shape[-1]} not in {dvs}")


def launch_args(q, k, v, out, q_offset, kv_len):
    """Device pointers for a launch, and the (B,) int32 position tensors
    they point into (the caller holds them until the launch is queued)."""
    B, Sk = q.shape[0], k.shape[1]
    qo = per_row(q_offset, B, q.device)
    kl = per_row(Sk if kv_len is None else kv_len, B, q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, out, qo, kl)]
    return ptrs, (qo, kl)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    q_offset=0, kv_len=None, scale=None):
    """q (B,Sq,H,Dk); k (B,Sk,Hkv,Dk); v (B,Sk,Hkv,Dv) -> (B,Sq,H,Dv) in q's
    dtype. ``q_offset``/``kv_len``: int or (B,) per-row values."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap,
                                     q_offset=q_offset, kv_len=kv_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    check_cuda_inputs(q, k, v, FLASH_DV)
    B, Sq, H, Dk = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    smem = 4 * (64 * Dk + 32 * (Dk + 1) + 32 * Dv + 8 * 8 * 32)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"head dim {Dk} needs {smem} B of shared memory per block")
    scale = scale if scale is not None else Dk ** -0.5
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    ptrs, _keep = launch_args(q, k, v, out, q_offset, kv_len)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            *ptrs, B, Sq, Sk, H, Hkv, Dk, Dv, int(causal), int(window or 0),
            float(softcap or 0.0), float(scale), build.DTYPE_CODES[DTYPES[q.dtype]],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
