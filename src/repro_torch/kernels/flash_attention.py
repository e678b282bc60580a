"""Prefill attention: the hand-written CUDA kernel and its plain version.

The kernels replace the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: blockwise online-softmax
attention with causal mask, sliding window, logit softcap ``c*tanh(s/c)``,
GQA (kv head ``h // G``, no repeated KV) and ``q_offset``/``kv_len``, which
here may be per batch row. At the serving path's prefill shapes their
work sits near the H100's bf16 ridge (bytes bound at S=512, operations at
S=1024); the sources say what their designs do about it.
The route is chosen by dtype alone (``flash_route``): bf16 runs on the
tensor cores (``csrc/flash_attention_bf16.cu``), fp32 exactly on the CUDA
cores (``csrc/flash_attention.cu``, for the fp32 parity checks).

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
FLASH_BF16_DK_MAX = 256  # the tensor-core kernel takes Dk % 16 == 0 up to this
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
    if (isinstance(x, torch.Tensor) and x.dtype == torch.int32 and x.shape == (B,)
            and x.device == torch.device(device) and x.is_contiguous()):
        return x  # the serving path's (B,) int32 positions, as they are
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


def check_aligned(*tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the kernels
    copy and load 16 bytes at a time)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"tensor at {t.data_ptr():#x} is not 16-byte aligned")


def flash_route(dtype) -> str:
    """The C entry point for a dtype, by dtype alone: bf16 to the
    tensor-core kernel, fp32 to the exact CUDA-core kernel."""
    routes = {torch.bfloat16: "flash_attention_fwd_bf16",
              torch.float32: "flash_attention_fwd_fp32"}
    if dtype not in routes:
        raise ValueError(f"flash_attention has no kernel for {dtype}")
    return routes[dtype]


def flash_checks(q, k, v) -> str:
    """Raise on what the kernels do not take; return the C entry point of
    q's dtype (``flash_route``). The wrapper calls it before a launch."""
    check_cuda_inputs(q, k, v, FLASH_DV)
    route = flash_route(q.dtype)
    Dk, Dv = q.shape[-1], v.shape[-1]
    if q.dtype == torch.bfloat16:
        if Dk % 16 or not 16 <= Dk <= FLASH_BF16_DK_MAX:
            raise ValueError(f"the bf16 flash kernel takes a head dim that is a multiple of 16 "
                             f"up to {FLASH_BF16_DK_MAX}, not {Dk}")
    else:  # the fp32 kernel stages Q, K, V and P in fp32 shared memory
        smem = 4 * (64 * Dk + 32 * (Dk + 1) + 32 * Dv + 8 * 8 * 32)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"head dim {Dk} needs {smem} B of shared memory per block")
    check_aligned(q, k, v)
    return route


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
    route = flash_checks(q, k, v)
    B, Sq, H, Dk = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale if scale is not None else Dk ** -0.5
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    ptrs, _keep = launch_args(q, k, v, out, q_offset, kv_len)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, route)(
            *ptrs, B, Sq, Sk, H, Hkv, Dk, Dv, int(causal), int(window or 0),
            float(softcap or 0.0), float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, route)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
