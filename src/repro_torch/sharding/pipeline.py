"""Circular pipeline parallelism over a stack's layers: the counterpart of
``repro.sharding.pipeline``.

The maxtext microbatch-rotation idiom: the batch splits into M
microbatches, the layers into S contiguous stage groups, and a buffer of
per-stage activations rotates one slot per tick: stage 0 takes
microbatch t while stage S-1 emits microbatch t-(S-1), so after S-1 ticks
of warm-up every stage computes every tick. On one device this is the
sequential arithmetic reordered, stage by stage within each tick (the
reference runs a tick's stages under one ``jax.vmap``). A stage on a
bubble tick (one that holds no microbatch, during warm-up or drain) is not
run: its output would reach no microbatch's result, and the reference
masks its aux out.

``models.transformer.apply_stack`` consults ``ExecContext.plan
["pipeline"] = {"stages": S, "microbatches": M}`` for the stages of a
train-mode stack whose repeat count S divides, exactly where the reference
does; without it, the layers run in order.
"""
from __future__ import annotations

import torch


def split_stages(layers, n_stages: int) -> list:
    """The stage groups of ``layers`` (a list, a ``ModuleList`` or a tensor
    of per-layer rows): ``n_stages`` slices of contiguous layers."""
    L = len(layers)
    if L % n_stages:
        raise ValueError(f"{L} stacked layers do not divide into {n_stages} stages")
    n = L // n_stages
    return [layers[s * n:(s + 1) * n] for s in range(n_stages)]


def circular_pipeline(stage_fn, layers, x, n_stages: int, n_microbatches: int):
    """Run ``x`` through all ``layers`` by microbatch rotation.

    ``stage_fn(group, x_mb) -> (x_mb, aux)`` applies one stage's contiguous
    group of layers; ``x`` is (B, ...) with B divisible by
    ``n_microbatches``. Returns ``(y, aux_sum)``: y what applying the
    layers in order gives, aux summed over the stages' real (non-bubble)
    runs."""
    S, M = int(n_stages), int(n_microbatches)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not divide into {M} microbatches")
    groups = split_stages(layers, S)
    xs = x.reshape((M, B // M) + tuple(x.shape[1:]))
    state = [None] * S  # stage s's microbatch at this tick (None: a bubble)
    outputs = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(pipeline_ticks(S, M)):
        # rotate: stage s takes stage s-1's previous output, stage 0 takes
        # microbatch t (a bubble once the microbatches run out)
        state = [xs[t] if t < M else None] + state[:-1]
        for s in range(S):
            if state[s] is not None:  # stage s holds microbatch t - s
                state[s], aux = stage_fn(groups[s], state[s])
                aux_total = aux_total + aux
        if t >= S - 1:
            outputs.append(state[-1])
    return torch.stack(outputs).reshape(x.shape), aux_total


def pipeline_ticks(n_stages: int, n_microbatches: int) -> int:
    """Rotation ticks: M real waves plus S-1 warm-up/drain bubbles."""
    return n_microbatches + n_stages - 1
