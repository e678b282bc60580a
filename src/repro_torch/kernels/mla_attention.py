"""Absorbed-MLA attention: the hand-written CUDA kernels and their plain version.

At DeepSeek's absorbed shape, G query heads on one latent KV head of
width 576 (kv_lora_rank 512 + qk_rope_dim 64) whose first 512 columns are
the values, with G = 16 (deepseek-v2-lite's heads) or a model rank's 8,
4, 2 or 1 of them at a model axis of 2, 4, 8 or 16 (``MLA_GROUPS``; a
sharded serve runs the piece mode below at 16 instead, so no serving path
reaches G < 16 since the latent is cut on its sequence), the kernels
replace two Pallas TPU kernels:
``repro.kernels.decode_attention.decode_attention`` (one query position,
the decode step) and ``repro.kernels.flash_attention.flash_attention``
(T > 1 query positions per row: the speculative verify and the draft's
catch-up). The route is chosen by dtype alone (``mla_route``): bf16 runs
on the tensor cores (``csrc/mla_attention_bf16.cu``), fp32 exactly on the
CUDA cores (``csrc/decode_attention_mla.cu``, for the fp32 parity checks).
Both split the cache as the decode kernel does (``plan_splits``, from the
shapes alone) and run one block per query position, so a row's arithmetic
does not depend on T. Their bound on an H100 is the latent rows they read;
the sources say what their designs do about it.

The piece mode (``mla_attention_piece``, a ``PIECE`` instance of each
kernel with entry points of its own) attends over one piece of the
sequence: a latent cut on its sequence over the model ranks (and the data
ranks; ``sharding.placement.plan_cache``), whose first row sits at global
position ``k_start``, at G = 16 (``MLA_PIECE_GROUPS``: each rank gathers
its group's queries, so it runs every head over its rows). ``q_offset``,
``kv_len`` and the window stay global, each query position's kept range
ends at that position + 1, and it returns fp32 o normalised over the
piece's kept keys and the fp32 log-sum-exp (0 and ``NEG_INF`` for a row
that keeps none of the piece), which ``sharding.collectives`` merges, as
it merges the decode kernel's piece mode's; ``mla_attention_piece_plain``
is its plain version.

``mla_attention`` launches a kernel for CUDA tensors and runs
``mla_attention_plain`` for CPU tensors; on the card a shape that the
kernels do not take (a G outside ``MLA_GROUPS`` among them) raises. Meta
tensors (the dry run) take the meta route: the card's checks, a meta
output, the call's work on the op counter (``kernels.cost``); there the
values are the latent's leading columns when they share its storage,
offset and strides (every meta tensor's ``data_ptr()`` is 0).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.decode_attention import merge_counters, plan_splits
from repro_torch.kernels.flash_attention import (ATTN_TRAIN_ROUTE, NEG_INF, attention_plain,
                                                 check_aligned, exact_fp32, launch_args, per_row,
                                                 refuse_grad)

MLA_DIMS = (576, 512)  # (Dk, Dv): the latent and value widths
# query heads per latent head: the whole model's, and a rank's at M = 2, 4, 8, 16
MLA_GROUPS = (16, 8, 4, 2, 1)
# (G, Dk, Dv) of every shape the kernels take
MLA_SHAPES = frozenset((g,) + MLA_DIMS for g in MLA_GROUPS)
# query heads per latent head of the piece mode: a kv group's gathered heads
MLA_PIECE_GROUPS = (16,)


def is_mla_shape(q, k, v) -> bool:
    """Whether (q, k, v) have an absorbed-MLA shape of ``MLA_SHAPES``,
    whatever their length."""
    H, Hkv = q.shape[-2], k.shape[-2]
    return Hkv > 0 and H % Hkv == 0 and (H // Hkv, q.shape[-1], v.shape[-1]) in MLA_SHAPES


def mla_route(dtype) -> str:
    """The C entry point for a dtype, by dtype alone: bf16 to the
    tensor-core kernel, fp32 to the exact CUDA-core kernel."""
    routes = {torch.bfloat16: "mla_attention_fwd_bf16", torch.float32: "mla_attention_fwd_fp32"}
    if dtype not in routes:
        raise ValueError(f"mla_attention has no kernel for {dtype}")
    return routes[dtype]


def mla_piece_route(dtype) -> str:
    """The piece mode's C entry point for a dtype (``mla_route``'s kernels)."""
    return mla_route(dtype).replace("mla_attention_fwd", "mla_attention_piece_fwd")


def mla_attention_plain(q, k, v, *, causal=True, q_offset=0, kv_len=None, window=None,
                        softcap=None, scale=None):
    """The kernels' arithmetic with materialised scores (``attention_plain``):
    q (B,T,H,Dk); k (B,Smax,Hkv,Dk); v (B,Smax,Hkv,Dv) -> (B,T,H,Dv)."""
    return attention_plain(q, k, v, causal=causal, window=window, softcap=softcap,
                           q_offset=q_offset, kv_len=kv_len, scale=scale)


def mla_checks(q, k, v) -> tuple[str, bool]:
    """Raise on what the kernels do not take; return the C entry point of
    q's dtype (``mla_route``) and whether v is the leading 512 columns of
    k's rows (the latent cache), which the kernels then read once."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, head_dim)")
    B, T = q.shape[:2]
    if T < 1 or k.shape[0] != B or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not is_mla_shape(q, k, v):
        raise ValueError(f"the MLA kernels take (G, Dk, Dv) in {sorted(MLA_SHAPES)}; got q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must share one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    route = mla_route(q.dtype)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.is_meta:  # the same storage, start and strides: v is k's leading columns
        v_shared = (v.untyped_storage()._cdata == k.untyped_storage()._cdata
                    and v.storage_offset() == k.storage_offset() and v.stride() == k.stride())
    else:
        v_shared = v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
    if not (q.is_contiguous() and k.is_contiguous() and (v_shared or v.is_contiguous())):
        raise ValueError("q and k must be contiguous, v contiguous or the leading columns of k")
    check_aligned(q, k, v)
    return route, v_shared


def mla_attention(q, k, v, *, causal=True, q_offset=0, kv_len=None, window=None,
                  softcap=None, scale=None):
    """q (B,T,G·Hkv,576), G in ``MLA_GROUPS``, T >= 1; k (B,Smax,Hkv,576) contiguous; v
    (B,Smax,Hkv,512) contiguous, or the first 512 columns of k
    (``k[..., :512]``, the latent cache's c_kv) -> (B,T,H,512) in q's dtype.
    Query t of row b sits at ``q_offset[b] + t``; keys at or past ``kv_len``
    (clamped to Smax) are never read; ``q_offset``/``kv_len``: int or (B,)
    per-row values."""
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window, softcap=softcap,
              scale=scale)
    if q.device.type == "cpu":
        return mla_attention_plain(q, k, v, **kw)
    refuse_grad("mla_attention", ATTN_TRAIN_ROUTE, q, k, v)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"mla_attention runs on cuda or cpu, not {q.device}")
    route, v_shared = mla_checks(q, k, v)
    B, T, H, Dk = q.shape
    Smax, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if q.is_meta:
        work = cost.mla_work(B, T, Smax, H, Hkv, Dk, Dv, q.element_size(), causal=causal,
                             window=window, q_offset=cost.host_rows(q_offset, Smax - T),
                             kv_len=cost.host_rows(kv_len, None), v_shared=v_shared)
        return cost.meta_call("mla_attention", work, q.new_empty((B, T, H, Dv)))
    scale = scale if scale is not None else Dk ** -0.5
    n_splits, split_len = plan_splits(Smax, B, Hkv)
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    rows = B * Hkv * T  # row groups: G heads at one query position
    part = torch.empty(rows * n_splits * (H // Hkv) * (Dv + 4), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = merge_counters(q.device, stream, rows)
    ptrs, _keep = launch_args(q, k, v, out, q_offset, kv_len)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, route)(
            *ptrs, part.data_ptr(), counters.data_ptr(), B, T, Smax, H, Hkv, Dk, Dv, k.stride(1),
            v.stride(1), v.stride(2), int(v_shared), int(causal), int(window or 0), n_splits,
            split_len, float(softcap or 0.0), float(scale), stream)
    build.check(rc, route)
    mla_attention.launches += 1
    return out


mla_attention.launches = 0


def mla_attention_piece_plain(q, k, v, *, k_start, causal=True, q_offset=0, kv_len=None,
                              window=None, softcap=None, scale=None):
    """The piece mode in plain PyTorch: q (B,T,H,Dk) against the piece k
    (B,Sp,Hkv,Dk), v (B,Sp,Hkv,Dv) whose row j sits at global position
    ``k_start + j``. Query t of row b sits at ``q_offset[b] + t`` and keeps
    the keys below ``kv_len[b]`` (None: every key of the piece), at or
    before its position if ``causal``, within ``window``; ``q_offset`` /
    ``kv_len`` int or (B,). Returns (o (B,T,H,Dv) fp32, lse (B,T,H) fp32),
    o normalised over the piece's kept keys (0 where none) and lse = m +
    log l in natural log (``NEG_INF`` where none)."""
    B, T, H, Dk = q.shape
    Sp, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    dev = q.device
    with exact_fp32():
        s = torch.einsum("bthgd,bkhd->bhgtk", q.float().reshape(B, T, Hkv, G, Dk),
                         k.float()) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kpos = k_start + torch.arange(Sp, device=dev)
        qpos = per_row(q_offset, B, dev)[:, None] + torch.arange(T, device=dev)  # (B,T)
        klen = per_row(k_start + Sp if kv_len is None else kv_len, B, dev)
        keep = (kpos < klen[:, None, None]).expand(B, T, Sp)
        if causal:
            keep = keep & (kpos <= qpos[..., None])
        if window is not None:
            keep = keep & (qpos[..., None] - kpos < window)
        keep = keep[:, None, None]  # (B,1,1,T,Sp)
        s = s.masked_fill(~keep, NEG_INF)
        m = s.amax(dim=-1)  # (B,Hkv,G,T); NEG_INF where the piece keeps no key
        p = torch.exp(s - m[..., None]) * keep
        l = p.sum(dim=-1)
        o = torch.einsum("bhgtk,bkhd->bthgd", p, v.float()) / l.clamp_min(1e-30).permute(
            0, 3, 1, 2)[..., None]
        lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), torch.full_like(m, NEG_INF))
    return o.reshape(B, T, H, Dv), lse.permute(0, 3, 1, 2).reshape(B, T, H)


def mla_attention_piece(q, k, v, *, k_start, causal=True, q_offset=0, kv_len=None, window=None,
                        softcap=None, scale=None):
    """The piece mode (module docstring): q (B,T,16·Hkv,576), T >= 1,
    against the piece k (B,Sp,Hkv,576), v (B,Sp,Hkv,512) or ``k[..., :512]``,
    whose first row sits at global position ``k_start`` -> (o (B,T,H,512)
    fp32, lse (B,T,H) fp32), as ``mla_attention_piece_plain`` gives them."""
    kw = dict(k_start=k_start, causal=causal, q_offset=q_offset, kv_len=kv_len, window=window,
              softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return mla_attention_piece_plain(q, k, v, **kw)
    refuse_grad("mla_attention_piece", ATTN_TRAIN_ROUTE, q, k, v)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"mla_attention_piece runs on cuda or cpu, not {q.device}")
    v_shared = mla_checks(q, k, v)[1]
    route = mla_piece_route(q.dtype)
    B, T, H, Dk = q.shape
    Sp, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if H // Hkv not in MLA_PIECE_GROUPS:
        raise ValueError(f"the MLA piece mode takes G in {MLA_PIECE_GROUPS}; got {H // Hkv}")
    k_start = int(k_start)
    if q.is_meta:
        work = cost.mla_work(B, T, Sp, H, Hkv, Dk, Dv, q.element_size(), causal=causal,
                             window=window, q_offset=cost.host_rows(q_offset, k_start + Sp - T),
                             kv_len=cost.host_rows(kv_len, None), v_shared=v_shared,
                             k_start=k_start)
        return cost.meta_call("mla_attention_piece", work,
                              q.new_empty((B, T, H, Dv), dtype=torch.float32),
                              q.new_empty((B, T, H), dtype=torch.float32))
    scale = scale if scale is not None else Dk ** -0.5
    n_splits, split_len = plan_splits(Sp, B, Hkv)
    out = torch.empty((B, T, H, Dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    rows = B * Hkv * T
    part = torch.empty(rows * n_splits * (H // Hkv) * (Dv + 4), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = merge_counters(q.device, stream, rows)
    ptrs, _keep = launch_args(q, k, v, out, q_offset, k_start + Sp if kv_len is None else kv_len)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, route)(
            *ptrs, lse.data_ptr(), part.data_ptr(), counters.data_ptr(), B, T, Sp, k_start, H,
            Hkv, Dk, Dv, k.stride(1), v.stride(1), v.stride(2), int(v_shared), int(causal),
            int(window or 0), n_splits, split_len, float(softcap or 0.0), float(scale), stream)
    build.check(rc, route)
    mla_attention_piece.launches += 1
    return out, lse


mla_attention_piece.launches = 0
