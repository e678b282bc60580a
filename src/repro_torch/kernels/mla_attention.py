"""Absorbed-MLA attention: the hand-written CUDA kernels and their plain version.

At DeepSeek's absorbed shape, G query heads on one latent KV head of
width 576 (kv_lora_rank 512 + qk_rope_dim 64) whose first 512 columns are
the values, with G = 16 (deepseek-v2-lite's heads) or a model rank's 8,
4, 2 or 1 of them at a model axis of 2, 4, 8 or 16 (``MLA_GROUPS``), the
kernels replace two Pallas TPU kernels:
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
from repro_torch.kernels.flash_attention import (ATTN_TRAIN_ROUTE, attention_plain, check_aligned,
                                                 launch_args, refuse_grad)

MLA_DIMS = (576, 512)  # (Dk, Dv): the latent and value widths
# query heads per latent head: the whole model's, and a rank's at M = 2, 4, 8, 16
MLA_GROUPS = (16, 8, 4, 2, 1)
# (G, Dk, Dv) of every shape the kernels take
MLA_SHAPES = frozenset((g,) + MLA_DIMS for g in MLA_GROUPS)


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
