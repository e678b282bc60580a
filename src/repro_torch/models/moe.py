"""Mixture-of-Experts, single device: the counterpart of the unsharded
branch of ``repro.models.moe.moe_apply``.

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
choice order (0, 1, ..., k-1), never by atomic scatter-adds. The sharded
branches (expert parallelism, the 2-D variant) wait for the sharding
slice (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import MLP, apply_mlp


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
    below C), else it is dropped."""
    flat_e = ids.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(E, device=ids.device))
    rank = torch.arange(se.numel(), device=ids.device) - starts[se]
    valid = rank < C
    slot = torch.where(valid, se * C + rank, torch.zeros_like(se))
    return order, slot, valid


def experts_apply(p: MoE, xt, gates, ids, C: int):
    """Every expert's contribution to the T tokens xt (T,D), summed per
    token in choice order in fp32: (T,D) fp32."""
    T, D = xt.shape
    k = ids.shape[1]
    E = p.w_gate.shape[0]
    order, slot, valid = dispatch(ids, E, C)
    tok = order // k  # the token of each sorted assignment
    buf = xt.new_zeros(E * C, D)
    buf[slot[valid]] = xt[tok[valid]]  # kept slots are distinct
    buf = buf.view(E, C, D)
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
    counts = torch.bincount(ids.reshape(-1), minlength=E).float()
    f_e = counts / counts.sum().clamp_min(1.0)
    return E * torch.sum(f_e * probs.mean(dim=0))


def moe_apply(p: MoE, x, cfg):
    """x (B,S,D) -> (out (B,S,D) in x's dtype, aux loss, an fp32 scalar)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(B * S, D)
    probs, gates, ids = route(xt, p.router, k)
    C = _capacity(B * S, k, E, cfg.moe_capacity_factor)
    out = experts_apply(p, xt, gates, ids, C).view(B, S, D).to(x.dtype)
    if p.shared is not None:
        out = out + apply_mlp(p.shared, x, cfg)
    return out, aux_loss(probs, ids, E)
