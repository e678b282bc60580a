"""Decode attention: the hand-written CUDA kernel and its plain version.

The kernel (``csrc/decode_attention.cuh``, its whole-cache entry
``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
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

The absorbed-MLA shapes (16, 8, 4, 2 or 1 query heads on one latent
head, Dk 576, Dv 512) have kernels of their own (``kernels.mla_attention``), to which
``ops.flash_attention`` sends it at any query length; ``decode_route``
names no entry point for it.

``decode_attention`` launches a kernel for CUDA tensors and runs
``decode_attention_plain`` for CPU tensors; on the card a shape that no
kernel takes raises. Meta tensors take the meta route (the card's checks,
a meta output, the call's work on the op counter: ``kernels.cost``), the
piece mode's too.

The piece mode (``decode_attention_piece``, the same kernel through its
own entry point) attends over one piece of the sequence: a cache that the
ranks of a kv group, or the data ranks, hold cut on its sequence
(``sharding.placement.plan_cache``), whose first key sits at global
position ``k_start``, for every query head of the kv group. ``q_offset``,
``kv_len`` and the window stay in global positions. It returns each (row,
query head)'s fp32 output normalised over the piece's kept keys and its
fp32 log-sum-exp ``m + log l`` (0 and ``NEG_INF`` for a row that keeps no
key of the piece), which ``sharding.collectives`` merges over the ranks;
``decode_attention_piece_plain`` is its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.flash_attention import (ATTN_TRAIN_ROUTE, NEG_INF, DTYPES, attention_plain,
                                                 check_aligned, check_cuda_inputs, exact_fp32,
                                                 launch_args, per_row, refuse_grad)

DECODE_DV = (64, 112, 128, 256)  # 112: kimi-k2's heads
DECODE_GROUPS = (1, 2, 4, 7, 8)
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


def decode_attention_piece_plain(q, k, v, *, k_start, q_offset=0, kv_len=None, window=None,
                                 softcap=None, scale=None):
    """The piece mode in plain PyTorch: q (B,1,H,Dk) against the piece k
    (B,Sp,Hkv,Dk), v (B,Sp,Hkv,Dv) whose key j sits at global position
    ``k_start + j``; ``q_offset``/``kv_len`` (int or (B,)) global, None
    keeping every key of the piece. Returns (o (B,1,H,Dv) fp32, lse
    (B,1,H) fp32), o normalised over the piece's kept keys (0 where none)
    and lse = m + log l in natural log (``NEG_INF`` where none)."""
    B, _, H, Dk = q.shape
    Sp, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    dev = q.device
    with exact_fp32():
        s = torch.einsum("bhgd,bkhd->bhgk", q.float().reshape(B, Hkv, G, Dk), k.float()) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kpos = k_start + torch.arange(Sp, device=dev)
        keep = kpos < per_row(k_start + Sp if kv_len is None else kv_len, B, dev)[:, None]
        if window is not None:
            keep = keep & (per_row(q_offset, B, dev)[:, None] - kpos < window)
        keep = keep[:, None, None]
        s = s.masked_fill(~keep, NEG_INF)
        m = s.amax(dim=-1)  # (B,Hkv,G); NEG_INF where the piece keeps no key
        p = torch.exp(s - m[..., None]) * keep
        l = p.sum(dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", p, v.float()) / l.clamp_min(1e-30)[..., None]
        lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), torch.full_like(m, NEG_INF))
    return o.reshape(B, 1, H, Dv), lse.reshape(B, 1, H)


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


def decode_route(G: int, Dk: int, Dv: int) -> str:
    """The C entry point for a decode shape, by shape alone: the split-KV
    kernel at a group of ``DECODE_GROUPS`` and a value width of
    ``DECODE_DV``; any other shape has no decode kernel (the absorbed-MLA
    shape goes to ``mla_attention``)."""
    if G not in DECODE_GROUPS:
        raise ValueError(f"GQA group {G} not in {DECODE_GROUPS}")
    if Dv not in DECODE_DV:
        raise ValueError(f"value head dim {Dv} not in {DECODE_DV}")
    return "decode_attention_fwd"


def _on_card(name, q):
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{name} takes one query token, (B, 1, H, Dk); got {tuple(q.shape)}")


def decode_attention(q, k, v, *, q_offset=0, kv_len=None, window=None,
                     softcap=None, scale=None):
    """q (B,1,H,Dk); k (B,Smax,Hkv,Dk); v (B,Smax,Hkv,Dv) -> (B,1,H,Dv) in
    q's dtype. ``q_offset``/``kv_len``: int or (B,) per-row values; keys at
    or past ``kv_len`` (clamped to Smax) are never read."""
    kw = dict(q_offset=q_offset, kv_len=kv_len, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, **kw)
    refuse_grad("decode_attention", ATTN_TRAIN_ROUTE, q, k, v)
    _on_card("decode_attention", q)
    decode_route(q.shape[2] // k.shape[2], q.shape[-1], v.shape[-1])
    check_cuda_inputs(q, k, v, DECODE_DV)
    B, _, H, Dk = q.shape
    Smax, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    if (Dk * q.element_size()) % 16:
        raise ValueError(f"key head dim {Dk} is not a multiple of 16 bytes")
    check_aligned(q, k, v)
    scale = scale if scale is not None else Dk ** -0.5
    n_splits, split_len = plan_splits(Smax, B, Hkv)
    if q.is_meta:
        work = cost.decode_work(B, Smax, H, Hkv, Dk, Dv, q.element_size(), window=window,
                                q_offset=cost.host_rows(q_offset, Smax - 1),
                                kv_len=cost.host_rows(kv_len, None))
        return cost.meta_call("decode_attention", work, q.new_empty((B, 1, H, Dv)))
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


def decode_attention_piece(q, k, v, *, k_start, q_offset=0, kv_len=None, window=None,
                           softcap=None, scale=None):
    """The piece mode (module docstring): q (B,1,H,Dk) against the cache
    piece k (B,Sp,Hkv,Dk), v (B,Sp,Hkv,Dv) whose first key sits at global
    position ``k_start`` -> (o (B,1,H,Dv) fp32, lse (B,1,H) fp32), as
    ``decode_attention_piece_plain`` gives them."""
    kw = dict(k_start=k_start, q_offset=q_offset, kv_len=kv_len, window=window,
              softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return decode_attention_piece_plain(q, k, v, **kw)
    refuse_grad("decode_attention_piece", ATTN_TRAIN_ROUTE, q, k, v)
    _on_card("decode_attention_piece", q)
    decode_route(q.shape[2] // k.shape[2], q.shape[-1], v.shape[-1])
    check_cuda_inputs(q, k, v, DECODE_DV)
    B, _, H, Dk = q.shape
    Sp, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    if (Dk * q.element_size()) % 16:
        raise ValueError(f"key head dim {Dk} is not a multiple of 16 bytes")
    check_aligned(q, k, v)
    scale = scale if scale is not None else Dk ** -0.5
    n_splits, split_len = plan_splits(Sp, B, Hkv)
    if q.is_meta:
        work = cost.decode_work(B, Sp, H, Hkv, Dk, Dv, q.element_size(), window=window,
                                q_offset=cost.host_rows(q_offset, int(k_start) + Sp - 1),
                                kv_len=cost.host_rows(kv_len, None), k_start=int(k_start))
        return cost.meta_call("decode_attention_piece", work,
                              q.new_empty((B, 1, H, Dv), dtype=torch.float32),
                              q.new_empty((B, 1, H), dtype=torch.float32))
    out = torch.empty((B, 1, H, Dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, 1, H), dtype=torch.float32, device=q.device)
    part = torch.empty(B * Hkv * n_splits * G * (Dv + 4), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = merge_counters(q.device, stream, B * Hkv)
    ptrs, _keep = launch_args(q, k, v, out, q_offset,
                              int(k_start) + Sp if kv_len is None else kv_len)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_piece_fwd(
            *ptrs, lse.data_ptr(), part.data_ptr(), counters.data_ptr(), B, Sp, int(k_start), H,
            Hkv, Dk, Dv, int(window or 0), n_splits, split_len, float(softcap or 0.0),
            float(scale), build.DTYPE_CODES[DTYPES[q.dtype]], stream)
    build.check(rc, "decode_attention_piece_fwd")
    decode_attention_piece.launches += 1
    return out, lse


decode_attention_piece.launches = 0
