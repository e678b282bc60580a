"""AdamW, global-norm clipping and the warmup-cosine schedule: the
counterpart of ``repro.training.optimizer``, as plain functions over
named parameters.

``params``, ``grads`` and the moments are dicts name -> tensor (a model's
``dict(model.named_parameters())``, or any such dict). The moments are
kept in the parameter dtype (bf16 for the full configs), as the reference
keeps them: each update reads them and the parameter into fp32, computes
in fp32 and casts back. Bf16 moments lose updates below their rounding;
that is the reference's choice, kept. ``torch.optim.AdamW`` is not used:
its decay, bias correction and moment dtype differ from the reference's.

On a (data, model) mesh each rank updates its own pieces: ``plan`` (a
``sharding.placement.ParamPlan``) and ``ctx`` make ``global_norm`` the
norm of the whole gradient (each element's square divided by the number
of ranks that hold it, summed over every rank: the rows of a segmented
leaf that every model rank holds whole, ``ParamPlan.shared_rows``, count
M times as many holders as the rank's own rows), so every element of the
tree counts once and clipping and the elementwise AdamW arithmetic
reproduce the unsharded step.

Each fp32 operation is its own rounding step, in the reference's order
(no fused multiply-add, no ``alpha=`` forms), and the scalars (learning
rate, bias corrections) are computed in fp32 as the reference computes
them, so that a step rounds where the reference's does. Each leaf is
updated ``PIECE`` elements at a time (one piece for most leaves): the
arithmetic is elementwise, so the bits are the same, and its fp32
temporaries stay at 128 MiB each (whole, the 16 experts' 0.94 G-element
leaf of a jamba-v0.1-52b layer took ~30 GiB of them on the card).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.sharding import collectives

PIECE = 1 << 25  # elements of a leaf that one AdamW update computes at a time


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def init_opt_state(params: dict) -> dict:
    """Zero moments in each parameter's dtype and device, step 0."""
    return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()},
            "step": 0}


def schedule(oc: OptConfig, step: int) -> float:
    """Linear warmup to ``oc.lr`` over ``warmup_steps``, then a cosine decay
    to 0 at ``total_steps``, in fp32 (an fp32 value returned as a float)."""
    f32 = np.float32
    warm = min(f32(1.0), f32(step + 1) / f32(max(oc.warmup_steps, 1)))
    prog = f32(step - oc.warmup_steps) / f32(max(oc.total_steps - oc.warmup_steps, 1))
    prog = min(max(prog, f32(0.0)), f32(1.0))
    cos = np.cos(f32(np.pi) * prog, dtype=np.float32)
    return float(f32(oc.lr) * warm * (f32(0.5) * (f32(1.0) + cos)))


def global_norm(tensors: dict, plan=None, ctx=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32: a 0-d tensor
    on the tensors' device. With ``plan`` and ``ctx`` (a mesh), ``tensors``
    are this rank's pieces and the norm is the whole tree's (module
    docstring)."""
    total = None
    for name, t in tensors.items():
        s = torch.sum(torch.square(t.float()))
        if plan is not None:  # each element over the ranks that hold it
            for lo, hi in plan.shared_rows(name):  # held by M times as many
                shared = torch.sum(torch.square(t.narrow(plan.dims[name], lo, hi - lo).float()))
                s = s - (1 - 1 / plan.shape[1]) * shared
            s = s / plan.replicas(name)
        total = s if total is None else total + s
    if plan is not None:
        total = collectives.all_reduce_world(total, ctx)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, oc: OptConfig, plan=None,
                 ctx=None) -> dict:
    """One AdamW step in place: every parameter of ``params`` from its
    gradient in ``grads`` (same names), the gradients clipped together to
    global norm ``oc.clip_norm``; ``state``'s moments and step advance.
    On a mesh (``plan``, ``ctx``) the tensors are this rank's pieces and
    the norm is the whole gradient's. Returns {"grad_norm": the raw
    gradients' global norm (a 0-d fp32 tensor), "lr": the step's learning
    rate}."""
    step = state["step"] + 1
    gn = global_norm(grads, plan, ctx)
    # true divisions by 0-d tensors (a python divisor turns into a multiply
    # by its reciprocal, another rounding)
    scale = torch.clamp(gn.new_tensor(oc.clip_norm) / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(oc, step)
    f32 = np.float32
    bc1 = gn.new_tensor(float(f32(1.0) - f32(oc.b1) ** f32(step)))
    bc2 = gn.new_tensor(float(f32(1.0) - f32(oc.b2) ** f32(step)))
    for name, p in params.items():
        # elementwise: a piece at a time, the same bits (module docstring);
        # view(-1) raises on a tensor that is not contiguous
        flat = [t.view(-1) for t in (p, state["m"][name], state["v"][name], grads[name])]
        for i in range(0, p.numel(), PIECE):
            p_, m, v, g = (t[i:i + PIECE] for t in flat)
            g = g.float() * scale
            m_new = oc.b1 * m.float() + (1 - oc.b1) * g
            v_new = oc.b2 * v.float() + (1 - oc.b2) * g * g
            mh = m_new / bc1
            vh = v_new / bc2
            p32 = p_.float()
            delta = lr * (mh / (torch.sqrt(vh) + oc.eps) + oc.weight_decay * p32)
            p_.copy_(p32 - delta)
            m.copy_(m_new)
            v.copy_(v_new)
    state["step"] = step
    return {"grad_norm": gn, "lr": lr}
