"""Shared building blocks: norms, rotary embeddings, the MLP, embeddings
and the LM head — the counterpart of ``repro.models.layers``.

Parameters live in ``nn.Module``s; the apply functions keep the JAX
package's names and numerics:

* RMSNorm multiplies by the plain ``scale`` (not ``1 + scale``), eps 1e-6,
  computed in fp32 and cast back;
* LayerNorm (the encoder-decoder family) takes the population variance
  (``jnp.var``, ``correction=0``), eps 1e-6 (not torch's 1e-5), in fp32;
* RoPE rotates split halves, not interleaved pairs;
* gemma2's MLP and the layernorm models' classic FFN (``wi``/``wo``) use
  the tanh-approximated GELU (``jax.nn.gelu``'s default);
* gemma2 scales embeddings by ``sqrt(d_model)`` cast to the activation
  dtype;
* logits are cast to fp32 before the final softcap.

On a model axis of M > 1 (``ctx.model_parallel``) the MLPs hold a 1/M
slice of ``d_ff`` (gate/up or the GELU FFN's ``wi`` column-parallel,
``w_down`` or ``wo`` row-parallel through ``row_linear``, whose partial
sums the caller adds over the ranks), and the embedding and the
LM head hold a 1/M slice of the vocab: ``embed_tokens`` looks up the ids
its slice holds, 0 for the rest, and sums the ranks' rows; ``lm_logits``
gathers the ranks' vocab columns, so every rank has the whole logits (in
train mode through the differentiable collectives: the head's input goes
through ``copy_to_model``, so its gradient sums the ranks' columns), or
with ``gather=False`` keeps the rank's slice (the train loss's route).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import collectives


class RMSNorm(nn.Module):
    """Counterpart of ``init_norm`` for rmsnorm models: an fp32 scale."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device))


class LayerNorm(nn.Module):
    """Counterpart of ``init_norm`` for layernorm models: fp32 scale and
    bias."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


def init_norm(cfg, device=None):
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.d_model, device)
    if cfg.norm != "rmsnorm":
        raise ValueError(f"unknown norm {cfg.norm!r}")
    return RMSNorm(cfg.d_model, device)


def apply_norm(p, x, eps=1e-6):
    if isinstance(p, LayerNorm):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        return ((xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias).to(x.dtype)
    return rms_norm_head(x, p.scale, eps)


def rms_norm_head(x, scale, eps=1e-6):
    """RMSNorm over the last axis with a plain fp32 ``scale`` (Mamba2's gated
    norm), computed in fp32 and cast back to ``x``'s dtype."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta):
    """x: (..., S, H, Dh) ; positions: (..., S) integer."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (Dh/2,)
    ang = positions[..., :, None, None].float() * freqs  # (...,S,1,Dh/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU / GeGLU feed-forward (counterpart of ``init_mlp``)."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.w_gate = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.w_up = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.w_down = nn.Linear(cfg.d_ff, cfg.d_model, **kw)


class FFN(nn.Module):
    """The classic transformer FFN of layernorm models (counterpart of
    ``init_mlp``'s ``wi``/``wo``): GELU between two projections."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.wi = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, **kw)


def init_mlp(cfg, device=None, dtype=None):
    return FFN(cfg, device, dtype) if cfg.norm == "layernorm" else MLP(cfg, device, dtype)


def row_linear(lin: nn.Linear, x):
    """``lin(x)``; when serving (no grad) with a row-parallel weight of a
    model rank (one whose input dim the rank holds 1/M of, marked
    ``partial_fp32`` by ``models.model.place``), the rank's partial sum in
    fp32, from fp32 operands: the caller sums the ranks' partials over the
    model axis and casts the sum to the activation dtype, so a bf16 output
    is rounded once, as the unsharded layer's is, not once per rank. Train
    mode keeps the partials in the activation dtype: on the card fp32 ones
    made a warm (1, 2) step 5-22% slower and did not keep the loss and
    grad norm nearer the unsharded run's over 6 steps on every family
    (PERF.md)."""
    if getattr(lin, "partial_fp32", False) and not torch.is_grad_enabled():
        return F.linear(x.float(), lin.weight.float())
    return lin(x)


def apply_mlp(p, x, cfg):
    if isinstance(p, FFN):
        return row_linear(p.wo, F.gelu(p.wi(x), approximate="tanh"))
    gate = p.w_gate(x)
    if cfg.name.startswith("gemma2"):
        act = F.gelu(gate, approximate="tanh")
    else:
        act = F.silu(gate)
    return row_linear(p.w_down, act * p.w_up(x))


def embed_tokens(embedding, ids, cfg, ctx=None):
    if ctx is not None and ctx.model_parallel > 1:  # this rank's vocab rows [v0, v0 + n)
        n = embedding.shape[0]
        v0 = ctx.model_rank * n
        mine = (ids >= v0) & (ids < v0 + n)
        x = F.embedding((ids - v0).clamp(0, n - 1), embedding) * mine[..., None]
        x = collectives.reduce_from_model(x, ctx)
    else:
        x = F.embedding(ids, embedding)
    if cfg.name.startswith("gemma2"):
        x = x * torch.tensor(float(cfg.d_model), dtype=torch.float32).sqrt().to(x.dtype)
    return x


def lm_logits(embedding, lm_head, x, cfg, ctx=None, gather=True):
    """``embedding`` (V, d) when tied, else ``lm_head`` (an ``nn.Linear``).
    The fp32 logits, softcapped: of the whole (padded) vocabulary, or
    without ``gather`` the rank's own slice of it on a model axis of M > 1
    (the columns [r V/M, (r + 1) V/M) of model rank r, no all-gather: the
    vocabulary-parallel loss's input, ``models.model.loss_fn``)."""
    if ctx is not None:
        x = collectives.copy_to_model(x, ctx)
    logits = F.linear(x, embedding) if cfg.tie_embeddings else lm_head(x)
    if ctx is not None and gather:
        logits = collectives.all_gather_last(logits, ctx)
    logits = logits.float()
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits
