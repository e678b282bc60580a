"""Attention: GQA (qkv bias, qk-norm, softcap, sliding window), the
encoder-decoder family's encoder self-attention and cross-attention, and
MLA, the counterpart of ``repro.models.attention``.

``attend`` routes to the hand-written kernels through ``kernels.ops``: on
CUDA tensors the flash (prefill) and decode kernels, on CPU tensors their
plain versions; ``impl="plain"`` takes the plain versions on any device.
``impl=TRAIN_IMPL`` takes the JAX package's XLA route (its ``impl="xla"``):
``full_attention`` up to ``_FULL_KV_LIMIT`` keys (and for one query row),
``chunked_attention`` above. Train mode takes that route whatever
``ctx.attn_impl`` says: no kernel of either package has a backward, and the
reference trains by differentiating this route, as autograd does here.

MLA (DeepSeek's multi-head latent attention) keeps one latent cache row
per position, ``[c_kv | k_rope]`` of width ``kv_lora_rank + qk_rope_dim``:
the JAX package's two caches side by side in one tensor, written with the
same values at the same positions. Its absorbed decode attends with that
row as the single KV head and its first ``kv_lora_rank`` columns as the
values, views of one tensor, so no step concatenates the cache.

On a model axis of M > 1 the GQA, cross-attention and MLA projections
hold the rank's heads (column-parallel q/k/v, MLA's ``wq`` and ``w_ukv``,
row-parallel wo): the functions take the head count from the tensors, so
they run unchanged on H/M query and Hkv/M kv heads, and the caller sums the
ranks' wo outputs. Where M is a multiple of Hkv, a rank holds one kv head
whole and its H/M query heads of that head's group; a group that its M/Hkv
ranks do not divide is padded with zero query heads, whose zero ``wo``
columns add nothing (``sharding.placement``). MLA's ``w_dkv`` and
``kv_norm`` are whole on every rank, which computes the whole latent row.
In train mode a rank's latent feeds only its own heads, so the gradients
of ``w_dkv`` and ``kv_norm`` are partial sums, marked ``ParamPlan.partial``
and summed over the model axis after the backward; the latent's input is
the mixer's ``copy_to_model`` output, whose backward already sums the
residual stream's gradient once over the ranks.

Cross-attention (``gqa_cross``) has no rope and no causal mask; at decode
it reads a cross cache preallocated at the slot pool's ``max_enc_len`` and
masks each row to its own encoder length (``kv_len = enc_len``; 0 on a
slot never admitted, whose row the kernels write as 0).

A serving cache cut on its sequence (``sharding.placement.plan_cache``:
over the kv group of the ranks that share a GQA kv head or MLA's latent,
and over the data group where ``ExecContext.kv_seq`` says so) holds the
rank's piece p = ``ctx.piece_index(cfg)`` of every row of ``k``, ``v``,
``xk``, ``xv`` and ``latent``: the positions [p n, (p + 1) n), n its
length. Prefill and decode write only the positions the rank holds
(``write_prefix``, and ``write_rows`` / ``write_grid`` at the piece's local
positions), and a decode attends over the piece (``attend_piece``): the
kv group's queries gathered (``collectives.gather_kv_group``: the G =
H / Hkv heads of the rank's kv head, padded; MLA's 16), one piece-mode
launch for all of them (the decode kernel's ``decode_attention_piece``
per query position, the MLA kernels' ``mla_attention_piece`` for all T
positions at once), the pieces' fp32 (o, log-sum-exp) merged over the kv
group (``collectives.merge_kv_group``), the rank's own heads kept, then
merged over the data group (``collectives.merge_attention``) where it cuts
the sequence too. A GQA verify of T positions is T piece decodes and one
merge at each level. The prefill's own attention runs over the prompt's
whole K/V (or latent), which every rank computes, so it is unchanged.

The plan knob ``attn_seq_shard`` (``ExecContext.plan``, the reference's
sequence-sharded attention) acts in GQA's train and prefill forward at
M > 1 only (``gqa_forward``): each rank attends for every head over its
piece of the query sequence against the whole K/V (``attend_seq_shard``).
MLA, the encoder, cross-attention and decode do not read it, as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.layers import RMSNorm, apply_rope, rms_norm_head, row_linear
from repro_torch.sharding import collectives
from repro_torch.sharding.context import ATTN_IMPLS

# the JAX package's differentiable XLA attention (its impl="xla"): train
# mode's route, chosen by mode (``ExecContext.attn_impl`` does not take it)
TRAIN_IMPL = "xla"
IMPLS = ATTN_IMPLS + (TRAIN_IMPL,)
_FULL_KV_LIMIT = 2048
_KV_BLOCK = 1024


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


def chunked_attention(q, k, v, *, causal=True, window=None, softcap=None,
                      q_offset=0, kv_len=None, scale=None, block=_KV_BLOCK):
    """Online softmax over key blocks of ``block``, in fp32, each block's
    body under ``torch.utils.checkpoint`` (its scores are recomputed in the
    backward, never kept): the JAX package's ``chunked_attention``. Heads
    stay flat, each K/V block repeated per query-head group. A row that
    keeps no key gets the mean of v, as in ``full_attention``."""
    B, Sq, H, Dk = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    nb = -(-Sk // block)
    pad = nb * block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float()
    qoff = torch.as_tensor(q_offset, device=q.device)
    qpos = (qoff[..., None] if qoff.dim() else qoff) + torch.arange(Sq, device=q.device)
    eff_len = Sk if kv_len is None else torch.clamp(torch.as_tensor(kv_len, device=q.device),
                                                    max=Sk)

    def body(acc, m_run, l_run, kblk, vblk, j0):
        kx = kblk.repeat_interleave(G, dim=2).float()  # (B,block,H,Dk)
        vx = vblk.repeat_interleave(G, dim=2).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kx) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        keep = _mask(qpos, j0 + torch.arange(block, device=q.device), causal, window, eff_len)
        keep = keep[:, None] if keep.dim() == 3 else keep[None, None]
        s = torch.where(keep, s, torch.tensor(-1e30, device=q.device))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l_run * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vx)
        return acc_new, m_new, l_new

    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    m_run = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for j in range(nb):
        sl = slice(j * block, (j + 1) * block)
        acc, m_run, l_run = checkpoint(body, acc, m_run, l_run, k[:, sl], v[:, sl], j * block,
                                       use_reentrant=False)
    o = acc / torch.clamp(l_run[..., None], min=1e-30)
    return o.transpose(1, 2).to(q.dtype)


def attend(q, k, v, *, causal=True, window=None, softcap=None, q_offset=0,
           kv_len=None, scale=None, impl=None):
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; choose from {IMPLS}")
    if impl == TRAIN_IMPL:
        fn = (full_attention if k.shape[1] <= _FULL_KV_LIMIT or q.shape[1] == 1
              else chunked_attention)
        return fn(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                  kv_len=kv_len, scale=scale)
    return ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset, kv_len=kv_len, scale=scale,
                               plain=impl == "plain")


def is_cut(cfg, ctx) -> bool:
    """Whether ``ctx``'s caches of ``cfg`` are cut on their sequence
    (module docstring)."""
    return ctx is not None and ctx.seq_pieces(cfg) > 1


def piece_start(cache, cfg, ctx) -> int:
    """The global position of the first entry of this rank's piece of a
    sequence-cut cache: its piece index (data piece, position in the kv
    group) times the pieces' length ``cache.shape[1]``."""
    return ctx.piece_index(cfg) * cache.shape[1]


def piece_span(cache, cfg, ctx):
    """(global length S, first position) of this rank's piece of a cut
    cache: S is ``ctx.kv_seq``, else the pieces' length times their
    number (the last piece holds no position past S)."""
    return ctx.kv_seq or cache.shape[1] * ctx.seq_pieces(cfg), piece_start(cache, cfg, ctx)


def attend_piece(q, k, v, cfg, ctx, *, causal=False, window=None, softcap=None, q_offset=0,
                 kv_len=None, scale=None, impl=None):
    """Decode attention (q (B,T,H,Dk), the rank's heads, T query positions
    at ``q_offset``, ``q_offset + 1``, ... per row) over this rank's piece
    ``k``, ``v`` of a sequence-cut cache (module docstring): the kv group's
    queries gathered, the pieces' states merged over the kv group and the
    rank's own heads kept, then merged over the data group with
    ``ctx.kv_seq``. ``causal``: the MLA kernels' piece mode, all T
    positions in one launch, each keeping the keys up to its own position
    and below ``kv_len`` (an int or (B,)); else one decode piece launch
    per position, ``kv_len`` a list of T per-row lengths (or one for
    T = 1). ``q_offset`` (B,) or int. Returns (B,T,H,Dv) in q's dtype."""
    T, H = q.shape[1], q.shape[2]
    qg = collectives.gather_kv_group(q, cfg, ctx, dim=2)
    kw = dict(k_start=piece_start(k, cfg, ctx), window=window, softcap=softcap, scale=scale,
              plain=impl == "plain")
    if causal:
        o, lse = ops.decode_attention_piece(qg, k, v, q_offset=q_offset, kv_len=kv_len,
                                            causal=True, **kw)
    else:
        lens = kv_len if isinstance(kv_len, (list, tuple)) else [kv_len]
        parts = [ops.decode_attention_piece(qg[:, t:t + 1].contiguous(), k, v,
                                            q_offset=q_offset + t, kv_len=lens[t], **kw)
                 for t in range(T)]
        o = torch.cat([a for a, _ in parts], dim=1)
        lse = torch.cat([b for _, b in parts], dim=1)
    o, lse = collectives.merge_kv_group(o, lse, cfg, ctx)
    if qg.shape[2] != H:  # the rank's own heads of its group's
        j = ctx.kv_group_rank(cfg)
        o, lse = o[:, :, j * H:(j + 1) * H], lse[:, :, j * H:(j + 1) * H]
    if ctx.kv_seq:
        o = collectives.merge_attention(o, lse, ctx)
    return o.to(q.dtype)


def write_prefix(cache, new, cfg, ctx):
    """cache (B, n, ...) [:, :S] = new (B, S, ...) (a prefill's K/V or
    latent rows), cast to the cache's dtype; of a sequence-cut cache
    (``is_cut``) only the positions this rank's piece holds."""
    S = new.shape[1]
    if not is_cut(cfg, ctx):
        cache[:, :S] = new.to(cache.dtype)
        return
    lo = piece_start(cache, cfg, ctx)
    hi = min(lo + cache.shape[1], S)
    if hi > lo:
        cache[:, :hi - lo] = new[:, lo:hi].to(cache.dtype)


def _local_rows(pos, start, n, S):
    """(local positions, limit) of global positions ``pos`` in a piece of
    ``n`` entries from ``start`` of a sequence of S: writes at or past the
    limit (the last piece's padding past S) are dropped."""
    return (pos - start if start else pos), min(n, max(S - start, 0))


class GQA(nn.Module):
    """GQA projections (counterpart of ``init_gqa``'s param dict). The qkv
    biases (qwen2) and the per-head qk-norm scales (chameleon) are fp32, as
    in the JAX package."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.wq = nn.Linear(cfg.d_model, cfg.q_dim, **kw)
        self.wk = nn.Linear(cfg.d_model, cfg.kv_dim, **kw)
        self.wv = nn.Linear(cfg.d_model, cfg.kv_dim, **kw)
        self.wo = nn.Linear(cfg.q_dim, cfg.d_model, **kw)
        if cfg.qkv_bias:
            f32 = dict(dtype=torch.float32, device=device)
            self.bq = nn.Parameter(torch.zeros(cfg.q_dim, **f32))
            self.bk = nn.Parameter(torch.zeros(cfg.kv_dim, **f32))
            self.bv = nn.Parameter(torch.zeros(cfg.kv_dim, **f32))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, device)
            self.k_norm = RMSNorm(cfg.head_dim, device)


def _project_qkv(p: GQA, x, cfg, positions):
    """Each bias is added after its projection, cast to the projection's
    dtype (not fused into a bf16 ``nn.Linear``, which would round at another
    place); the qk-norm runs before rope, as in the JAX package."""
    B, S, _ = x.shape
    q, k, v = p.wq(x), p.wk(x), p.wv(x)
    if cfg.qkv_bias:
        q, k, v = q + p.bq.to(q.dtype), k + p.bk.to(k.dtype), v + p.bv.to(v.dtype)
    q = q.view(B, S, -1, cfg.head_dim)  # the rank's heads on a model axis
    k = k.view(B, S, -1, cfg.head_dim)
    v = v.view(B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm_head(q, p.q_norm.scale)
        k = rms_norm_head(k, p.k_norm.scale)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend_seq_shard(q, k, v, cfg, ctx, *, window=None, impl=None):
    """Causal self-attention with the queries cut on their sequence over the
    model axis (the plan knob ``attn_seq_shard``): q (B, S, h, Dk), k and v
    (B, S, hkv, D) hold this rank's heads of the whole sequence. q goes to
    this rank's piece of every head (``collectives.seq_to_heads``: pieces
    of n = ceil(S / M) positions, rank r the positions [r n, (r + 1) n)),
    every kv head is gathered whole (``gather_kv_heads``), the piece
    attends causally from ``q_offset`` = r n against the whole K/V, and
    the output goes back to the rank's heads of the whole sequence
    (``heads_to_seq``): (B, S, h, Dv). Where M does not divide S the
    sequence is padded with zero queries to M n and the pad rows dropped
    after (``kv_len`` S keeps their keys inside the sequence), so every
    rank runs the same ops and collectives, the backward's included.
    Padded query heads travel with the rest (their zero ``wo`` columns
    drop them)."""
    B, S = q.shape[:2]
    M, r = ctx.model_parallel, ctx.model_rank
    n = -(-S // M)
    if M * n != S:
        q = F.pad(q, (0, 0, 0, 0, 0, M * n - S))
    qs = collectives.seq_to_heads(q, ctx)  # (B, n, M h, Dk)
    kw, vw = collectives.gather_kv_heads(k, cfg, ctx), collectives.gather_kv_heads(v, cfg, ctx)
    o = attend(qs, kw, vw, causal=True, window=window, softcap=cfg.attn_softcap, q_offset=r * n,
               kv_len=min(S, r * n + n), impl=impl)
    return collectives.heads_to_seq(o, ctx)[:, :S]


def gqa_forward(p: GQA, x, cfg, *, window=None, impl=None, ctx=None):
    """Train and prefill: full causal self-attention. Returns (out, (k, v))
    so the caller can fill the cache (this rank's kv heads). With the plan
    knob ``attn_seq_shard`` on a model axis of M > 1 the attention runs
    with the queries cut on their sequence (``attend_seq_shard``)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if ctx is not None and ctx.model_parallel > 1 and ctx.plan.get("attn_seq_shard"):
        o = attend_seq_shard(q, k, v, cfg, ctx, window=window, impl=impl)
    else:
        o = attend(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap, impl=impl)
    return row_linear(p.wo, o.reshape(B, S, -1)), (k, v)


def gqa_encode(p: GQA, x, cfg, *, impl=None):
    """The encoder's self-attention: roped at positions 0..S-1, non-causal
    over the whole input (the JAX stack's ``causal=False`` branch)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = attend(q, k, v, causal=False, impl=impl)
    return row_linear(p.wo, o.reshape(B, S, -1))


def gqa_cross(p: GQA, x, cfg, enc_k, enc_v, enc_len=None, impl=None, ctx=None):
    """Cross-attention of x (B,S,D) over the encoder's K/V (B,T,Hkv,Dh): no
    rope, no causal mask, no qkv bias; ``enc_len`` (an int or (B,)) masks
    each row to its own encoder length, None attends to all T. A decode
    over this rank's piece of a sequence-cut cross cache (``is_cut``)
    attends through ``attend_piece``; ``enc_len`` must be given."""
    B, S, _ = x.shape
    q = p.wq(x).view(B, S, -1, cfg.head_dim)  # the rank's heads on a model axis
    if is_cut(cfg, ctx):
        if enc_len is None:
            raise ValueError("a decode over a sequence-cut cross cache needs enc_len")
        o = attend_piece(q, enc_k, enc_v, cfg, ctx, kv_len=enc_len, impl=impl)
    else:
        o = attend(q, enc_k, enc_v, causal=False, kv_len=enc_len, impl=impl)
    return row_linear(p.wo, o.reshape(B, S, -1))


def cross_kv(p: GQA, enc_out, cfg):
    """The cross-attention's K/V of the encoder output (B,T,D)."""
    B, T, _ = enc_out.shape
    return (p.wk(enc_out).view(B, T, -1, cfg.head_dim),
            p.wv(enc_out).view(B, T, -1, cfg.head_dim))


def gqa_decode(p: GQA, x, cfg, cache_k, cache_v, pos, *, window=None, impl=None, ctx=None):
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
    overwritten. Returns (out, (cache_k, cache_v)).

    A sequence-cut cache (``is_cut``): the caches are this rank's pieces
    of a sequence of S positions (module docstring, ``piece_span``): the
    new K/V are written where the rank holds their positions (and below
    S), and the T query positions attended through ``attend_piece``
    (kv_len = position + 1, at most S: the whole cache's causal bound)."""
    B, T = x.shape[0], x.shape[1]
    piece = is_cut(cfg, ctx)
    n = cache_k.shape[1]
    S, start = piece_span(cache_k, cfg, ctx) if piece else (n, 0)
    if not torch.is_tensor(pos) or not pos.dim():  # position-synchronous: one token, one position
        if T > 1:
            raise ValueError("multi-position decode takes (B,) per-row positions")
        idx = _scalar_pos(pos, S)  # on the host: a meta position has no value
        q, k, v = _project_qkv(p, x, cfg, torch.full((B, 1), idx, device=x.device))
        if 0 <= idx - start < n:
            cache_k[:, idx - start] = k[:, 0].to(cache_k.dtype)
            cache_v[:, idx - start] = v[:, 0].to(cache_v.dtype)
        kw = dict(window=window, softcap=cfg.attn_softcap, q_offset=idx, kv_len=idx + 1,
                  impl=impl)
        o = (attend_piece(q, cache_k, cache_v, cfg, ctx, **kw) if piece else
             attend(q, cache_k, cache_v, causal=False, **kw))
        return row_linear(p.wo, o.reshape(B, 1, -1)), (cache_k, cache_v)
    pos = torch.as_tensor(pos, device=x.device)
    positions = (pos.reshape(-1, 1).expand(B, 1) if T == 1 else
                 pos[:, None] + torch.arange(T, device=x.device))
    q, k, v = _project_qkv(p, x, cfg, positions)
    local, limit = _local_rows(pos, start, n, S)
    if T == 1:  # ragged: per-slot positions
        if limit < n:  # the last piece's padding past the sequence
            local = torch.where(local < limit, local, torch.full_like(local, n))
        write_rows(cache_k, k[:, 0], local)
        write_rows(cache_v, v[:, 0], local)
    else:
        write_grid(cache_k, k, local, limit)
        write_grid(cache_v, v, local, limit)
    if piece:
        lens = [torch.clamp(pos + t + 1, max=S) for t in range(T)]
        o = attend_piece(q, cache_k, cache_v, cfg, ctx, window=window, softcap=cfg.attn_softcap,
                         q_offset=pos, kv_len=lens, impl=impl)
    else:  # a verify (T > 1) attends causally with no kv_len
        o = attend(q, cache_k, cache_v, causal=T > 1, window=window, softcap=cfg.attn_softcap,
                   q_offset=pos, kv_len=pos + 1 if T == 1 else None, impl=impl)
    return row_linear(p.wo, o.reshape(B, T, -1)), (cache_k, cache_v)


def _scalar_pos(pos, Smax: int) -> int:
    idx = int(pos)
    if not 0 <= idx < Smax:
        raise ValueError(f"decode position {idx} outside the cache of {Smax}")
    return idx


def write_rows(cache, new, pos):
    """cache (B, Smax, ...) [b, pos[b]] = new (B, ...), cast to the cache's
    dtype; a row whose position is past the cache (or before it: a piece's
    local position of a key another rank holds) writes nothing (JAX's
    ``mode="drop"``)."""
    Smax = cache.shape[1]
    bidx = torch.arange(cache.shape[0], device=cache.device)
    keep = ((pos >= 0) & (pos < Smax)).view(-1, *([1] * (new.dim() - 1)))
    row = pos.long().clamp(0, Smax - 1)
    cache[bidx, row] = torch.where(keep, new.to(cache.dtype), cache[bidx, row])


def write_grid(cache, new, pos, limit=None):
    """cache (B, Smax, ...) [b, pos[b] + t] = new (B, T, ...) for every t,
    writes outside [0, ``limit``) (the cache's length by default) dropped,
    in one indexed write: a dropped position takes the index and value of
    its row's nearest position inside, and a row with none writes an entry
    back unchanged, so every repeated index carries one value and the drop
    needs no host sync. ``pos`` may be negative (a piece's local start)."""
    B, T = new.shape[:2]
    Smax = cache.shape[1]
    lim = Smax if limit is None else limit
    ar = torch.arange(T, device=cache.device)
    t0 = (-pos).clamp(min=0)  # the row's first t inside, and one past its last
    t1 = (lim - pos).clamp(max=T)
    t_src = torch.minimum(torch.maximum(ar, t0[:, None]),
                          torch.maximum(t1 - 1, t0)[:, None]).clamp(max=T - 1)  # (B,T)
    rows = (pos[:, None] + t_src).long().clamp(0, Smax - 1)
    live = (t0 < t1).view(-1, 1, *([1] * (new.dim() - 2)))
    bidx = torch.arange(B, device=cache.device)[:, None]
    src = new[bidx, t_src].to(cache.dtype)
    cache[bidx, rows] = torch.where(live, src, cache[bidx, rows])


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """MLA projections (counterpart of ``init_mla``'s param dict): the
    up-projection ``w_ukv`` is stored (lr, H, nope + vd), as in the JAX
    package, for the absorbed decode's slices; ``kv_norm`` is fp32."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        H, nope, rope_d, vd, lr = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                                   cfg.v_head_dim, cfg.kv_lora_rank)
        kw = dict(bias=False, device=device, dtype=dtype)
        self.wq = nn.Linear(cfg.d_model, H * (nope + rope_d), **kw)
        self.w_dkv = nn.Linear(cfg.d_model, lr + rope_d, **kw)
        self.kv_norm = RMSNorm(lr, device)
        self.w_ukv = nn.Parameter(torch.empty(lr, H, nope + vd, device=device, dtype=dtype))
        self.wo = nn.Linear(H * vd, cfg.d_model, **kw)


def latent_width(cfg) -> int:
    """Width of one MLA latent cache row, ``[c_kv | k_rope]``."""
    return cfg.kv_lora_rank + cfg.qk_rope_dim


def _mla_scale(cfg):
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def _mla_compress(p: MLA, x, cfg, positions):
    """x -> (c_kv normed, k_rope roped): c_kv (B,S,lr), k_rope (B,S,rope_d)."""
    ckr = p.w_dkv(x)
    lr = cfg.kv_lora_rank
    c_kv = rms_norm_head(ckr[..., :lr], p.kv_norm.scale)
    k_rope = apply_rope(ckr[..., None, lr:], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _mla_queries(p: MLA, x, cfg, positions):
    B, S, _ = x.shape
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = p.wq(x).view(B, S, -1, nope + rope_d)  # the rank's heads on a model axis
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def mla_forward(p: MLA, x, cfg, impl=None):
    """Prefill: the latents expanded to per-head K/V (the naive form), then
    causal attention with Dk = nope + rope, Dv = vd through the flash
    kernel. Returns (out, (c_kv, k_rope)), the latent cache's two parts."""
    B, S, _ = x.shape
    H, nope, vd = p.w_ukv.shape[1], cfg.qk_nope_dim, cfg.v_head_dim  # H: the rank's heads
    positions = torch.arange(S, device=x.device).expand(B, S)
    c_kv, k_rope = _mla_compress(p, x, cfg, positions)
    q_nope, q_rope = _mla_queries(p, x, cfg, positions)
    kv = torch.einsum("bsr,rhd->bshd", c_kv, p.w_ukv)
    k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(B, S, H, cfg.qk_rope_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attend(q, k, kv[..., nope:].contiguous(), causal=True, scale=_mla_scale(cfg), impl=impl)
    return row_linear(p.wo, o.reshape(B, S, H * vd)), (c_kv, k_rope)


def mla_decode(p: MLA, x, cfg, cache, pos, impl=None, ctx=None):
    """Absorbed decode against the latent cache (B, Smax, lr + rope),
    updated in place: scores and values live in the kv_lora latent space,
    one KV head of width lr + rope for all H query heads, values its first
    lr columns. ``pos`` as in ``gqa_decode``: an int, a (B,) tensor of
    per-slot positions (a row past the cache writes nothing), or with
    T > 1 a (B,) tensor for the speculative verify (latents scattered at
    the (B,T) grid, the new queries causal, stale latents of a rejected
    suffix causal-masked until overwritten). A sequence-cut latent
    (``is_cut``: over the model ranks at M > 1, and the data ranks with
    ``ctx.kv_seq``) is this rank's piece: the rank writes only the rows it
    holds, at local positions, and attends through ``attend_piece``, its
    q_eff gathered over the kv group so that it runs every head over its
    rows (the MLA kernels at G = 16), the pieces merged and its own heads
    kept. Returns (out, cache)."""
    B, T = x.shape[0], x.shape[1]
    H, nope, vd, lr = p.w_ukv.shape[1], cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    n = cache.shape[1]
    piece = is_cut(cfg, ctx)
    S, start = piece_span(cache, cfg, ctx) if piece else (n, 0)
    scalar = not torch.is_tensor(pos) or not pos.dim()
    idx = _scalar_pos(pos, S) if scalar and T == 1 else None  # on the host
    pos = torch.as_tensor(pos, device=x.device)
    if T > 1:
        if not pos.dim():
            raise ValueError("multi-position decode takes (B,) per-row positions")
        positions = pos[:, None] + torch.arange(T, device=x.device)
        c_kv, k_rope = _mla_compress(p, x, cfg, positions)
        rows = torch.cat([c_kv.to(cache.dtype), k_rope.to(cache.dtype)], -1)
        write_grid(cache, rows, *_local_rows(pos, start, n, S))
        causal, q_off, kv_len = True, pos, (S if piece else None)
    else:
        positions = (pos.reshape(-1, 1).expand(B, 1) if idx is None else
                     torch.full((B, 1), idx, device=x.device))
        c_kv, k_rope = _mla_compress(p, x, cfg, positions)
        row = torch.cat([c_kv.to(cache.dtype), k_rope.to(cache.dtype)], -1)[:, 0]
        if idx is None:  # ragged: per-slot positions
            local, limit = _local_rows(pos, start, n, S)
            if limit < n:  # the last piece's padding past the sequence
                local = torch.where(local < limit, local, torch.full_like(local, n))
            write_rows(cache, row, local)
            q_off = pos
            kv_len = torch.clamp(pos + 1, max=S) if piece else pos + 1
        else:
            q_off = idx
            if 0 <= idx - start < n:
                cache[:, idx - start] = row
            kv_len = q_off + 1
        causal = False
    q_nope, q_rope = _mla_queries(p, x, cfg, positions)
    w_uk = p.w_ukv[..., :nope]  # (lr, H, nope)
    # absorb: q' = q_nope W_uk^T, latent-space queries (B,T,H,lr)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk.float()).to(x.dtype)
    q_eff = torch.cat([q_lat, q_rope], dim=-1)
    kw = dict(causal=causal, q_offset=q_off, kv_len=kv_len, scale=_mla_scale(cfg), impl=impl)
    if piece:
        o_lat = attend_piece(q_eff, cache[:, :, None, :], cache[:, :, None, :lr], cfg, ctx,
                             **kw)
    else:
        o_lat = attend(q_eff, cache[:, :, None, :], cache[:, :, None, :lr], **kw)
    w_uv = p.w_ukv[..., nope:]  # (lr, H, vd)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat.float(), w_uv.float()).to(x.dtype)
    return row_linear(p.wo, o.reshape(B, T, H * vd)), cache
