"""Decode attention: the hand-written CUDA kernel and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``: one query token per
batch row against the KV cache, all G q heads of a kv group against each
K/V entry read once, with sliding window, logit softcap and
``q_offset``/``kv_len``, which here may be per batch row (the continuous
engine's ragged slot pool passes ``q_offset = pos``, ``kv_len = pos + 1``).
Its bound on an H100 is the KV bytes it reads; the source says what its
design does about it.

``decode_attention`` launches the kernel for CUDA tensors and runs
``decode_attention_plain`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, attention_plain, check_cuda_inputs, launch_args

DECODE_DV = (64, 128, 256)
DECODE_GROUPS = (1, 2, 4, 8)


def decode_attention_plain(q, k, v, *, q_offset=0, kv_len=None, window=None,
                           softcap=None, scale=None):
    """q (B,1,H,Dk); k (B,Sk,Hkv,Dk); v (B,Sk,Hkv,Dv) -> (B,1,H,Dv)."""
    return attention_plain(q, k, v, causal=False, window=window, softcap=softcap,
                           q_offset=q_offset, kv_len=kv_len, scale=scale)


def decode_attention(q, k, v, *, q_offset=0, kv_len=None, window=None,
                     softcap=None, scale=None):
    """q (B,1,H,Dk); k (B,Smax,Hkv,Dk); v (B,Smax,Hkv,Dv) -> (B,1,H,Dv) in
    q's dtype. ``q_offset``/``kv_len``: int or (B,) per-row values; keys at
    or past ``kv_len`` (clamped to Smax) are never read."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, q_offset=q_offset, kv_len=kv_len,
                                      window=window, softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    check_cuda_inputs(q, k, v, DECODE_DV)
    B, Sq, H, Dk = q.shape
    Smax, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if Sq != 1:
        raise ValueError(f"decode_attention takes one query token, got {Sq}")
    if H // Hkv not in DECODE_GROUPS:
        raise ValueError(f"GQA group {H // Hkv} not in {DECODE_GROUPS}")
    scale = scale if scale is not None else Dk ** -0.5
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    ptrs, _keep = launch_args(q, k, v, out, q_offset, kv_len)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_fwd(
            *ptrs, B, Smax, H, Hkv, Dk, Dv, int(window or 0), float(softcap or 0.0),
            float(scale), build.DTYPE_CODES[DTYPES[q.dtype]],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "decode_attention_fwd")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
