"""The train step and a host loop: the counterpart of
``repro.training.train_loop``.

A step runs the forward and ``loss.backward()``, then updates the
parameters and the optimizer state in place under ``torch.no_grad()``;
the in-place update replaces the reference's buffer donation. The history
rows carry the reference's keys: ``loss``, ``nll``, ``aux``, ``grad_norm``
and ``lr``, and the step's wall time ``step_s``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.model import loss_fn, train_params
from repro_torch.sharding.context import ExecContext
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state


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
    learning rate."""

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        loss, metrics = loss_fn(params, cfg, batch, ctx)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        opt_metrics = adamw_update(named, grads, opt_state, oc)
        for p in named.values():
            p.grad = None
        return {"loss": loss.detach(), "nll": metrics["nll"].detach(),
                "aux": metrics["aux"].detach(), **opt_metrics}

    return train_step


def train_loop(cfg, params, batches, ctx=ExecContext(), oc=OptConfig(), log_every=10):
    """Train ``params`` (a model, updated in place) on ``batches`` (numpy
    batches) from a fresh optimizer state. Returns (params, opt_state,
    history), a history row of floats per step."""
    named = train_params(params)
    device = next(iter(named.values())).device
    step_fn = make_train_step(cfg, ctx, oc)
    opt_state = init_opt_state(named)
    history = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        ts = time.perf_counter()
        m = step_fn(params, opt_state, batch_to_device(batch, device))
        row = {k: float(v) for k, v in m.items()}  # waits for the device
        history.append(dict(row, step_s=time.perf_counter() - ts))
        if log_every and i % log_every == 0:
            print(f"step {i:5d} loss={history[-1]['loss']:.4f} "
                  f"|g|={history[-1]['grad_norm']:.3f} ({time.time()-t0:.1f}s)")
    return params, opt_state, history
