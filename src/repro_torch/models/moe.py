"""Mixture-of-Experts: the counterpart of ``repro.models.moe.moe_apply``,
its unsharded branch and, on a model axis of M > 1, its expert-parallel
branch.

Top-k routing over fp32 router logits, then a capacity-bounded dispatch:
the (token, choice) assignments are sorted by expert (stably, as JAX's
``argsort(stable=True)``), each expert takes its first ``C`` assignments
(``_capacity``, from ``moe_capacity_factor``) and drops the rest, the
experts' SwiGLU FFNs run as batched matmuls over an (E, C, D) buffer, and
each token sums its kept contributions weighted by its gates. Shared
experts (DeepSeek) add a dense SwiGLU FFN on every token. The expert
products are plain batched matmuls, as the JAX package leaves them to XLA
outside any Pallas kernel.

The combine is deterministic: each token's k contributions are summed in
choice order (0, 1, ..., k-1), never by atomic scatter-adds.

Expert parallelism (M > 1, E % M == 0): rank m holds experts
[m E_l, (m+1) E_l), E_l = E / M. The router is replicated, so every rank
of the model axis routes its tokens alike; a rank computes only its
experts' contributions, with the capacity C of the unsharded branch over
the same tokens (a rank's stable sort keeps each expert's assignments in
the global order, so the same assignments are kept and dropped), and the
ranks' fp32 partial sums are added by one all-reduce. Every rank of the
model axis computes the same aux loss (the reference's ``pmean`` of equal
values). In train mode the gates and the experts' input enter through
``collectives.copy_to_model``, so the router's and the input's gradients
sum the ranks' experts.

Experts that M does not divide (E % M != 0): every rank holds every
expert whole and computes all of them, as the reference's ``moe_apply``
does then (no all-reduce of the expert output); the shared experts stay
cut and summed. In train mode the routed path reads the replicated input
outside ``collectives.copy_to_model``, so its input's, the router's and
the experts' gradients are whole and equal on every model rank: the
input's is not summed over the ranks, and the experts' and the router's
need no model-axis sum (``sharding.placement``).

With the batch split over the data axes (D > 1), x holds this data rank's
rows, so each branch sizes its capacity from the local tokens, as the
reference's expert-parallel branch does (``T_local``), and each data rank
takes its own aux loss into its loss (the averaged gradient is that of the
mean aux). At M = 1 the reference's GSPMD view sizes the capacity and the
aux from the global batch instead; the two agree wherever nothing is
dropped (ROADMAP.md, Queue 3).

The 2-D MoE (``ctx.plan["moe_2d"]``, under the reference's condition: M >
1, E % M == 0, D divides ``moe_d_ff``) is weight-stationary: experts are
cut on the model axis and each expert's F on the data axes (rank (d, m)
uses F columns [d F/D, (d+1) F/D) of its experts: its FSDP piece, which
``sharding.collectives.gathered`` leaves ungathered here, or that slice of
a whole weight); the tokens are replicated (every data rank's rows are
gathered when they differ, ``ctx.batch_split``), routed alike everywhere
with the capacity of all of them, and one sum over both axes (an
all-reduce over the model axis, then a reduce-scatter back to each data
rank's rows, or an all-reduce over the data axis for replicated rows)
combines the partials. Its aux loss is that of all the tokens.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import MLP, apply_mlp
from repro_torch.sharding import collectives
from repro_torch.sharding.context import ExecContext


class MoE(nn.Module):
    """Counterpart of ``init_moe``: an fp32 router (D, E) and the experts'
    stacked weights, gate/up (E, D, F) and down (E, F, D), in the JAX
    layout (applied as ``x @ W``); the shared experts (the ``shared``
    dict) are one SwiGLU MLP of width num_shared_experts * F."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        E, F_, D = cfg.num_experts, cfg.moe_d_ff, cfg.d_model
        self.router = nn.Parameter(torch.empty(D, E, dtype=torch.float32, device=device))
        self.w_gate = nn.Parameter(torch.empty(E, D, F_, dtype=dtype, device=device))
        self.w_up = nn.Parameter(torch.empty(E, D, F_, dtype=dtype, device=device))
        self.w_down = nn.Parameter(torch.empty(E, F_, D, dtype=dtype, device=device))
        self.shared = (MLP(dataclasses.replace(cfg, d_ff=cfg.num_shared_experts * F_), device,
                           dtype) if cfg.num_shared_experts else None)


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    """Per-expert capacity for T tokens (``repro.models.moe._capacity``)."""
    per = T * k * cf / E
    return max(1, int(-(-per // 1)))


def route(xt, router, k: int):
    """(probs (T,E), gates (T,k) renormalised, ids (T,k)). Top-k by a stable
    descending sort: among equal probabilities the lower expert id comes
    first, as ``lax.top_k`` orders ties."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, ids


def dispatch(ids, E: int, C: int):
    """The assignments' places in the (E, C) buffer. ids (T,k) -> (order,
    slot, valid): ``order`` sorts the flat (token, choice) assignments by
    expert, stably; sorted assignment i goes to row ``slot[i]`` of the
    flattened buffer when ``valid[i]`` (its rank within its expert is
    below C), else it is dropped. An id of E (an expert of another rank)
    sorts after all the others and is dropped."""
    flat_e = ids.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(E, device=ids.device))
    rank = torch.arange(se.numel(), device=ids.device) - starts[se.clamp(max=E - 1)]
    valid = (se < E) & (rank < C)
    slot = torch.where(valid, se * C + rank, torch.zeros_like(se))
    return order, slot, valid


def experts_apply(p: MoE, xt, gates, ids, C: int, e0: int = 0):
    """The contribution of the experts ``p`` holds, experts [e0, e0 + E_l),
    to the T tokens xt (T,D), summed per token in choice order in fp32:
    (T,D) fp32."""
    T, D = xt.shape
    k = ids.shape[1]
    E = p.w_gate.shape[0]
    if E != p.router.shape[1]:  # a rank's experts, numbered from 0; the others' E
        ids = ids - e0
        ids = torch.where((ids >= 0) & (ids < E), ids, torch.full_like(ids, E))
    order, slot, valid = dispatch(ids, E, C)
    tok = order // k  # the token of each sorted assignment
    # kept slots are distinct; the dropped assignments all land in one spare
    # row past the buffer (shapes that do not depend on how many are kept)
    buf = xt.new_zeros(E * C + 1, D)
    buf[torch.where(valid, slot, torch.full_like(slot, E * C))] = xt[tok]
    buf = buf[:E * C].view(E, C, D)
    h = F.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    yb = torch.bmm(h, p.w_down).view(E * C, D)
    contrib = torch.where(valid[:, None], yb[slot], yb.new_zeros(())).float()
    contrib = contrib * gates.reshape(-1)[order][:, None]
    per_choice = torch.empty_like(contrib)
    per_choice[order] = contrib  # back to (token, choice) order
    per_choice = per_choice.view(T, k, D)
    out = per_choice[:, 0]
    for j in range(1, k):
        out = out + per_choice[:, j]
    return out


def aux_loss(probs, ids, E: int):
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    flat = ids.reshape(-1)
    counts = torch.zeros(E, device=ids.device).index_add_(
        0, flat, torch.ones(flat.shape, device=ids.device))
    f_e = counts / counts.sum().clamp_min(1.0)
    return E * torch.sum(f_e * probs.mean(dim=0))


def uses_2d(cfg, ctx) -> bool:
    """The reference's condition for the 2-D MoE (``moe_apply``)."""
    M = ctx.model_parallel
    return bool(M > 1 and cfg.num_experts % M == 0 and ctx.plan.get("moe_2d")
                and cfg.moe_d_ff % max(1, ctx.batch_parallel) == 0)


def _f_slice(w, dim: int, F_: int, ctx):
    """Data rank d's F columns of an expert weight: the weight itself when
    it is already this rank's FSDP piece, else its slice of the whole."""
    D = ctx.batch_parallel
    if w.shape[dim] == F_ // D:
        return w
    return w.narrow(dim, ctx.data_rank * (F_ // D), F_ // D)


def _moe_2d(p: MoE, x, cfg, ctx):
    """The weight-stationary 2-D MoE (module docstring): (out (B,S,D) in
    x's dtype, aux)."""
    B, S, D = x.shape
    E, k, F_ = cfg.num_experts, cfg.top_k, cfg.moe_d_ff
    E_l = E // ctx.model_parallel
    split = ctx.batch_parallel > 1 and ctx.batch_split
    xa = collectives.gather_batch(x, ctx) if split else x
    xt = xa.reshape(-1, D)
    probs, gates, ids = route(xt, p.router, k)
    C = _capacity(xt.shape[0], k, E, cfg.moe_capacity_factor)
    local = _Experts(_f_slice(p.w_gate, 2, F_, ctx), _f_slice(p.w_up, 2, F_, ctx),
                     _f_slice(p.w_down, 1, F_, ctx), p.router)
    out = experts_apply(local, collectives.copy_to_model(xt, ctx),
                        collectives.copy_to_model(gates, ctx), ids, C,
                        e0=ctx.model_rank * E_l)
    out = collectives.reduce_from_model(out, ctx).view(xa.shape)
    if split:
        out = collectives.scatter_batch(out, ctx)
    elif ctx.batch_parallel > 1:
        out = collectives.all_reduce_data(out, ctx)
    return out.to(x.dtype), aux_loss(probs, ids, E)


class _Experts:
    """The expert weights ``experts_apply`` reads, as plain tensors."""

    def __init__(self, w_gate, w_up, w_down, router):
        self.w_gate, self.w_up, self.w_down, self.router = w_gate, w_up, w_down, router


def moe_apply(p: MoE, x, cfg, ctx=ExecContext()):
    """x (B,S,D) -> (out (B,S,D) in x's dtype, aux loss, an fp32 scalar).
    On a model axis of M > 1, ``p`` holds this rank's E / M experts, or
    every expert where M does not divide E (and its slice of the shared
    experts' width either way); on a data axis of D > 1, x
    holds this data rank's rows (module docstring)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    M = ctx.model_parallel
    if uses_2d(cfg, ctx):
        out, aux = _moe_2d(p, x, cfg, ctx)
    else:
        xt = x.reshape(B * S, D)
        probs, gates, ids = route(xt, p.router, k)
        # the local tokens: this data rank's rows when the batch is split
        C = _capacity(B * S, k, E, cfg.moe_capacity_factor)
        if M > 1 and E % M == 0:
            out = experts_apply(p, collectives.copy_to_model(xt, ctx),
                                collectives.copy_to_model(gates, ctx), ids, C,
                                e0=ctx.model_rank * (E // M))
            out = collectives.reduce_from_model(out, ctx)  # psum over the model axis
        else:  # M = 1, or experts that M does not divide: every expert whole here
            out = experts_apply(p, xt, gates, ids, C)
        aux = aux_loss(probs, ids, E)
        out = out.view(B, S, D).to(x.dtype)
    if p.shared is not None:
        y = apply_mlp(p.shared, collectives.copy_to_model(x, ctx), cfg)
        out = out + collectives.reduce_from_model(y, ctx).to(out.dtype)
    return out, aux
