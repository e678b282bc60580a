"""Decode attention: the hand-written CUDA kernel and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``: one query token per
batch row against the KV cache, all G q heads of a kv group against each
K/V entry read once, with sliding window, logit softcap and
``q_offset``/``kv_len``, which here may be per batch row (the continuous
engine's ragged slot pool passes ``q_offset = pos``, ``kv_len = pos + 1``).
Its bound on an H100 is the KV bytes it reads; the source says what its
design does about it. The kernel splits the KV axis across blocks
(``plan_splits``, from the shapes alone) and merges the splits' softmax
states in the same launch; ``decode_attention_split_plain`` is that
split-and-merge arithmetic in plain PyTorch, for the tests.

``decode_attention`` launches the kernel for CUDA tensors and runs
``decode_attention_plain`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (NEG_INF, DTYPES, attention_plain, check_aligned,
                                                 check_cuda_inputs, exact_fp32, launch_args,
                                                 per_row)

DECODE_DV = (64, 128, 256)
DECODE_GROUPS = (1, 2, 4, 8)
# the split planner's targets: blocks for several waves of an H100's 132
# SMs, and no split shorter than 64 keys (its merge would cost more than
# its keys)
_SMS, _WAVES, _MIN_SPLIT = 132, 4, 64
_counters: dict = {}  # (device, stream) -> int32 merge counters, all 0 between launches


def plan_splits(Smax: int, B: int, Hkv: int) -> tuple[int, int]:
    """(n_splits, split_len) for a (B, Smax, Hkv, D) cache, from the shapes
    alone: never from the positions, which stay on the device. Split s
    covers keys [s * split_len, (s + 1) * split_len); together they cover
    [0, Smax) once, the last one cut at Smax."""
    for name, x in (("Smax", Smax), ("B", B), ("Hkv", Hkv)):
        if not isinstance(x, int) or isinstance(x, bool) or x < 1:
            raise TypeError(f"{name} must be a positive Python int, got {x!r}")
    want = -(-_WAVES * _SMS // (B * Hkv))
    n = max(1, min(want, -(-Smax // _MIN_SPLIT)))
    split_len = -(-(-(-Smax // n)) // 16) * 16
    return -(-Smax // split_len), split_len


def decode_attention_split_plain(q, k, v, *, q_offset=0, kv_len=None, window=None,
                                 softcap=None, scale=None, split_len=None):
    """The kernel's split-and-merge arithmetic in plain PyTorch (the tests
    hold it against the Pallas kernel): per split of ``split_len`` keys
    (``plan_splits``'s by default) the fp32 softmax state (m, l, acc), -1e30
    / 0 / 0 for a split with no kept key, then the merge
    sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, 0 where no key is kept."""
    B, _, H, Dk = q.shape
    Smax, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    if split_len is None:
        split_len = plan_splits(Smax, B, Hkv)[1]
    n = -(-Smax // split_len)
    scale = scale if scale is not None else Dk ** -0.5
    dev = q.device
    with exact_fp32():
        s = torch.einsum("bhgd,bkhd->bhgk", q.float().reshape(B, Hkv, G, Dk), k.float()) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        pos = per_row(q_offset, B, dev)
        kpos = torch.arange(Smax, device=dev)
        keep = kpos < per_row(Smax if kv_len is None else kv_len, B, dev)[:, None]
        if window is not None:
            keep = keep & (pos[:, None] - kpos < window)
        pad = n * split_len - Smax
        s = torch.nn.functional.pad(s, (0, pad)).reshape(B, Hkv, G, n, split_len)
        keep = torch.nn.functional.pad(keep, (0, pad)).reshape(B, 1, 1, n, split_len)
        vs = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
        vs = vs.reshape(B, n, split_len, Hkv, Dv)
        s = s.masked_fill(~keep, NEG_INF)
        m = s.amax(dim=-1)  # (B,Hkv,G,n); -1e30 for a split with no kept key
        p = torch.exp(s - m[..., None]) * keep
        l = p.sum(dim=-1)
        acc = torch.einsum("bhgnk,bnkhd->bhgnd", p, vs)
        mx = m.amax(dim=-1, keepdim=True)
        f = torch.exp(m - mx)
        o = (acc * f[..., None]).sum(dim=3) / (l * f).sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, 1, H, Dv).to(q.dtype)


def merge_counters(device, stream: int, n: int) -> torch.Tensor:
    """Persistent int32 merge counters for launches on one stream, at least
    n of them. Every launch leaves them at 0, so they are zeroed once."""
    buf = _counters.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _counters[(device, stream)] = buf
    return buf


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
    G = H // Hkv
    if G not in DECODE_GROUPS:
        raise ValueError(f"GQA group {G} not in {DECODE_GROUPS}")
    if (Dk * q.element_size()) % 16:
        raise ValueError(f"key head dim {Dk} is not a multiple of 16 bytes")
    check_aligned(q, k, v)
    scale = scale if scale is not None else Dk ** -0.5
    n_splits, split_len = plan_splits(Smax, B, Hkv)
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    part = torch.empty(B * Hkv * n_splits * G * (Dv + 4), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = merge_counters(q.device, stream, B * Hkv)
    ptrs, _keep = launch_args(q, k, v, out, q_offset, kv_len)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_fwd(
            *ptrs, part.data_ptr(), counters.data_ptr(), B, Smax, H, Hkv, Dk, Dv,
            int(window or 0), n_splits, split_len, float(softcap or 0.0), float(scale),
            build.DTYPE_CODES[DTYPES[q.dtype]], stream)
    build.check(rc, "decode_attention_fwd")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
