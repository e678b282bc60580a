"""Attention, GQA half: the counterpart of ``repro.models.attention``.

``attend`` routes to the hand-written kernels through ``kernels.ops``: on
CUDA tensors the flash (prefill) and decode kernels, on CPU tensors their
plain versions; ``impl="plain"`` takes the plain versions on any device.
``full_attention`` is the JAX package's XLA path, kept as a reference.

MLA, cross-attention and the chunked path wait for later slices (see
ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope

IMPLS = (None, "plain")


def _mask(qpos, kpos, causal, window, kv_len):
    """qpos (Sq,) or (B,Sq), kpos (Sk,) absolute positions; kv_len int or
    (B,). A bool keep-mask (Sq,Sk), or (B,Sq,Sk) when an input is per row."""
    qp = torch.as_tensor(qpos)[..., :, None]
    kp = torch.as_tensor(kpos, device=qp.device)
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                   device=qp.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & ((qp - kp) < window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=qp.device)
        if kl.dim():
            kl = kl[:, None, None]
        m = m & (kp < kl)
    return m


def full_attention(q, k, v, *, causal=True, window=None, softcap=None,
                   q_offset=0, kv_len=None, scale=None):
    """Materialised softmax over ``-1e30``-masked scores (a row that keeps
    no key gets the mean of v, unlike the kernels' 0)."""
    B, Sq, H, Dk = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    qh = q.reshape(B, Sq, Hkv, G, Dk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qoff = torch.as_tensor(q_offset, device=q.device)
    ar = torch.arange(Sq, device=q.device)
    qpos = (qoff[..., None] if qoff.dim() else qoff) + ar
    m = _mask(qpos, torch.arange(Sk, device=q.device), causal, window, kv_len)
    m = m[:, None, None] if m.dim() == 3 else m[None, None, None]
    s = torch.where(m, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def attend(q, k, v, *, causal=True, window=None, softcap=None, q_offset=0,
           kv_len=None, scale=None, impl=None):
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; choose from {IMPLS}")
    return ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset, kv_len=kv_len, scale=scale,
                               plain=impl == "plain")


class GQA(nn.Module):
    """GQA projections (counterpart of ``init_gqa``'s param dict)."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        if cfg.qkv_bias or cfg.qk_norm:
            raise NotImplementedError(
                "qkv bias and qk-norm are not ported yet (see ROADMAP.md)")
        kw = dict(bias=False, device=device, dtype=dtype)
        self.wq = nn.Linear(cfg.d_model, cfg.q_dim, **kw)
        self.wk = nn.Linear(cfg.d_model, cfg.kv_dim, **kw)
        self.wv = nn.Linear(cfg.d_model, cfg.kv_dim, **kw)
        self.wo = nn.Linear(cfg.q_dim, cfg.d_model, **kw)


def _project_qkv(p: GQA, x, cfg, positions):
    B, S, _ = x.shape
    q = p.wq(x).view(B, S, cfg.num_heads, cfg.head_dim)
    k = p.wk(x).view(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = p.wv(x).view(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p: GQA, x, cfg, *, window=None, impl=None):
    """Prefill: full causal self-attention. Returns (out, (k, v)) so the
    caller can fill the cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = attend(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap, impl=impl)
    return p.wo(o.reshape(B, S, cfg.q_dim)), (k, v)


def gqa_decode(p: GQA, x, cfg, cache_k, cache_v, pos, *, window=None, impl=None):
    """Decode against the cache. x (B,T,D); cache_k/v (B,Smax,Hkv,Dh),
    updated in place (the JAX package donates the buffers instead).

    ``pos`` is an int (position-synchronous batch, one token) or a (B,)
    tensor of per-row write positions (the continuous engine's ragged slot
    pool): each row writes its K/V at its own position and attends with
    kv_len = pos + 1. A row whose position is past the cache (a retired slot
    parked at ``max_len``) writes nothing, as JAX's ``mode="drop"`` scatter
    does.

    Speculative verify (a (B,) ``pos`` with T > 1): each row scores T
    candidate positions pos..pos+T-1 in one forward, through the flash
    kernel. K/V scatter at the (B,T) position grid, writes past the cache
    dropped; the new queries attend causally with no kv_len. Stale entries
    past a row's committed frontier (a rejected draft suffix of an earlier
    round) sit at kpos > qpos, so the causal mask hides them until they are
    overwritten. Returns (out, (cache_k, cache_v))."""
    B, T = x.shape[0], x.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    Smax = cache_k.shape[1]
    if T > 1:
        if not pos.dim():
            raise ValueError("multi-position decode takes (B,) per-row positions")
        return _verify(p, x, cfg, cache_k, cache_v, pos, window, impl)
    q, k, v = _project_qkv(p, x, cfg, pos.reshape(-1, 1).expand(B, 1))
    if pos.dim():  # ragged: per-slot positions
        bidx = torch.arange(B, device=x.device)
        keep = (pos < Smax)[:, None, None]
        row = pos.long().clamp(max=Smax - 1)
        cache_k[bidx, row] = torch.where(keep, k[:, 0].to(cache_k.dtype), cache_k[bidx, row])
        cache_v[bidx, row] = torch.where(keep, v[:, 0].to(cache_v.dtype), cache_v[bidx, row])
        o = attend(q, cache_k, cache_v, causal=False, window=window,
                   softcap=cfg.attn_softcap, q_offset=pos, kv_len=pos + 1, impl=impl)
        return p.wo(o.reshape(B, 1, cfg.q_dim)), (cache_k, cache_v)
    idx = int(pos)
    if not 0 <= idx < Smax:
        raise ValueError(f"decode position {idx} outside the cache of {Smax}")
    cache_k[:, idx] = k[:, 0].to(cache_k.dtype)
    cache_v[:, idx] = v[:, 0].to(cache_v.dtype)
    o = attend(q, cache_k, cache_v, causal=False, window=window,
               softcap=cfg.attn_softcap, q_offset=idx, kv_len=idx + 1, impl=impl)
    return p.wo(o.reshape(B, 1, cfg.q_dim)), (cache_k, cache_v)


def _verify(p: GQA, x, cfg, cache_k, cache_v, pos, window, impl):
    """The multi-position branch of ``gqa_decode``. One indexed write per
    cache holds the whole (B,T) grid; a position past the cache takes the
    index and value of its row's last position inside it, and a row with
    none writes the cache's last entry back unchanged, so every repeated
    index carries one value and the drop needs no host sync."""
    B, T = x.shape[0], x.shape[1]
    Smax = cache_k.shape[1]
    ar = torch.arange(T, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, pos[:, None] + ar)
    t_src = torch.minimum(ar, (Smax - 1 - pos).clamp(min=0)[:, None])  # (B,T)
    rows = (pos[:, None] + t_src).long().clamp(max=Smax - 1)
    live = (pos < Smax)[:, None, None, None]
    bidx = torch.arange(B, device=x.device)[:, None]
    for new, cache in ((k, cache_k), (v, cache_v)):
        src = new[bidx, t_src].to(cache.dtype)
        cache[bidx, rows] = torch.where(live, src, cache[bidx, rows])
    o = attend(q, cache_k, cache_v, causal=True, window=window, softcap=cfg.attn_softcap,
               q_offset=pos, kv_len=None, impl=impl)
    return p.wo(o.reshape(B, T, cfg.q_dim)), (cache_k, cache_v)
