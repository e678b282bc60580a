"""The train step and a host loop: the counterpart of
``repro.training.train_loop``.

A step runs the forward and ``loss.backward()``, then updates the
parameters and the optimizer state in place under ``torch.no_grad()``;
the in-place update replaces the reference's buffer donation. The history
rows carry the reference's keys: ``loss``, ``nll``, ``aux``, ``grad_norm``
and ``lr``, and the step's wall time ``step_s``.

On a (D, M) mesh (``ctx.mesh``) every rank runs the step on its shard of
the model (``convert.shard_params`` / ``init_params(ctx=...)``) and its
rows of the global batch (``shard_batch``: ``batch_shardings``' split of
dim 0 over the batch axes, from the same ``SyntheticLM`` batch). The loss
is the global mean over tokens, the mean of the data ranks' means (equal
row counts): after the backward the partial gradients of the leaves and
segments that every model rank holds whole but applies to its own heads
or channels (``ParamPlan.partial``: the qk-norm scales, MLA's ``w_dkv``
and ``kv_norm``, Mamba1's dt / B / C norm scales;
``ParamPlan.shared_rows``: the B and C segments of Mamba2's ``in_proj``,
``conv_w`` and ``conv_b``) are summed over the model axis, those of a GQA
kv leaf cut fewer ways than M (``ParamPlan.ways``: each kv head on
M / Hkv ranks, each rank's gradient a partial sum over its query heads)
over the ranks that hold its kv head (``collectives.all_reduce_model_groups``),
and those of zero-padded query heads (``ParamPlan.pad_rows``: ``wq`` and
``bq`` rows, ``wo`` columns) are set to 0. A pad head has q = 0, so its
attention output is the running mean of v, not 0, and the gradient of its
``wo`` columns would not be 0: zeroed, the pad weights and their moments
stay exactly 0 under AdamW (its decay of a zero weight is 0) and add
nothing to the norm. Then each gradient is summed over the data group (an
all-reduce for the leaves every data rank holds whole; the FSDP leaves'
gather already reduce-scattered theirs) and divided by D, and the
optimizer clips by the whole tree's norm (``optimizer.global_norm``). The
metrics are the data group's means. Train mode takes every layout that
serving places (``sharding.placement``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.model import loss_fn, mesh_rank, train_params
from repro_torch.sharding import collectives
from repro_torch.sharding import partition_specs as ps
from repro_torch.sharding.context import ExecContext
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state


def shard_batch(batch: dict, cfg, ctx: ExecContext) -> dict:
    """This data rank's rows of a global batch: each leaf that
    ``batch_shardings`` puts on the batch axes is cut on dim 0 into D
    equal parts (the whole batch without a data axis)."""
    D = ctx.batch_parallel
    if D == 1:
        return batch
    specs = ps.batch_shardings(cfg, ctx.mesh, "train", ctx.batch_axes)
    out = {}
    for k, v in batch.items():
        if specs.get(k, (None,))[0] is None:
            out[k] = v
            continue
        if v.shape[0] % D:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split over {D} data ranks")
        n = v.shape[0] // D
        out[k] = v[ctx.data_rank * n:(ctx.data_rank + 1) * n]
    return out


@torch.no_grad()
def sync_grads(grads: dict, plan, ctx: ExecContext) -> dict:
    """The gradients of the global mean loss from this rank's backward
    (module docstring), in place where they can be."""
    D = ctx.batch_parallel
    rank = mesh_rank(ctx)
    for name, g in grads.items():
        if name in plan.partial:
            g = collectives.all_reduce_model(g, ctx)
        for lo, hi in plan.shared_rows(name):
            rows = g.narrow(plan.dims[name], lo, hi - lo)
            rows.copy_(collectives.all_reduce_model(rows, ctx))
        if name in plan.ways:
            g = collectives.all_reduce_model_groups(g, plan.ways[name], ctx)
        for lo, hi in plan.pad_rows(name, rank):
            g.narrow(plan.dims[name], lo, hi - lo).zero_()
        if D > 1:
            if plan.data_dims[name] is None:
                g = collectives.all_reduce_data(g, ctx)
            g = g.div_(D)
        grads[name] = g
    return grads


def loss_and_grads(params, cfg, batch, ctx: ExecContext = ExecContext(), plan=None):
    """The forward and backward of one step: (loss, metrics, gradients by
    name), the gradients those of the global mean loss on a mesh
    (``plan``: ``placement.plan_params(cfg, ctx)``). The loss and metrics
    are detached: their graph's nodes would keep the model alive after
    the caller has let it go."""
    if (plan is not None and any(d is not None for d in plan.data_dims.values())
            and params.data_shard != (plan.shape[0], ctx.data_rank)):
        raise ValueError(f"the plan cuts weights on the data axis (FSDP), but params hold "
                         f"{params.data_shard}, not this rank's (D, rank) = "
                         f"{(plan.shape[0], ctx.data_rank)}: cut them with convert.shard_params")
    named = dict(params.named_parameters())
    for p in named.values():
        p.grad = None
    loss, metrics = loss_fn(params, cfg, batch, ctx)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in named.items()}
    if plan is not None:
        sync_grads(grads, plan, ctx)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def batch_to_device(batch: dict, device) -> dict:
    """A ``data.pipeline`` batch (numpy) as tensors on ``device``: token ids
    and labels int64, ``enc_inputs`` fp32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=torch.int64 if k in ("tokens", "labels") else None)
    return out


def make_train_step(cfg, ctx: ExecContext = ExecContext(), oc: OptConfig = OptConfig()):
    """``train_step(params, opt_state, batch) -> metrics``: one AdamW step of
    the model ``params`` (its gradients on) on ``batch`` (tensors on its
    device); ``params`` and ``opt_state`` are updated in place. The metrics
    are 0-d tensors (``grad_norm``, ``loss``, ``nll``, ``aux``) and the
    learning rate. On a mesh, ``params`` is this rank's shard and
    ``batch`` its rows (``shard_batch``)."""
    plan = None
    if ctx.mesh is not None:
        from repro_torch.sharding.placement import plan_params
        plan = plan_params(cfg, ctx)

    def mean(t):
        t = t.detach()
        D = ctx.batch_parallel
        return t if D == 1 else collectives.all_reduce_data(t.float(), ctx) / D

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        loss, metrics, grads = loss_and_grads(params, cfg, batch, ctx, plan)
        opt_metrics = adamw_update(named, grads, opt_state, oc, plan, ctx)
        for p in named.values():
            p.grad = None
        return {"loss": mean(loss), "nll": mean(metrics["nll"]), "aux": mean(metrics["aux"]),
                **opt_metrics}

    return train_step


def train_loop(cfg, params, batches, ctx=ExecContext(), oc=OptConfig(), log_every=10):
    """Train ``params`` (a model, updated in place; on a mesh this rank's
    shard) on ``batches`` (numpy global batches, of which each data rank
    takes its rows) from a fresh optimizer state. Returns (params,
    opt_state, history), a history row of floats per step."""
    named = train_params(params)
    device = next(iter(named.values())).device
    step_fn = make_train_step(cfg, ctx, oc)
    opt_state = init_opt_state(named)
    history = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        ts = time.perf_counter()
        m = step_fn(params, opt_state, batch_to_device(shard_batch(batch, cfg, ctx), device))
        row = {k: float(v) for k, v in m.items()}  # waits for the device
        history.append(dict(row, step_s=time.perf_counter() - ts))
        if log_every and i % log_every == 0:
            print(f"step {i:5d} loss={history[-1]['loss']:.4f} "
                  f"|g|={history[-1]['grad_norm']:.3f} ({time.time()-t0:.1f}s)")
    return params, opt_state, history
