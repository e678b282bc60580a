"""The collectives of explicit SPMD over the model axis.

Column-parallel layers (q/k/v, gate/up, the LM head's vocab columns) leave
each rank a slice of the output; row-parallel layers (the attention output
and MLP down projections, the vocab-sharded embedding, the expert-parallel
MoE) leave each rank a partial sum of the whole output. ``all_reduce`` sums
the partials and ``all_gather_last`` concatenates the slices over the model
axis's process group, in place of the ``psum`` / ``all_gather`` that GSPMD
inserts for the JAX package. Both return their input untouched at a model
axis of one (a mesh of one runs no collective, so it computes exactly what
the single-device path computes).

The tensors stay where the model runs: CUDA tensors on the card, also over
``gloo`` when two ranks share one card (NCCL refuses two ranks on one
device), whose CUDA all-reduce and all-gather copy through host memory
inside the backend. Every rank gets the same bits from a collective, so
ranks that start from the same inputs take the same decisions
(``serving.workers``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, ctx) -> torch.Tensor:
    """Sum ``x`` over the model axis, in place; ``x`` at one shard."""
    if ctx.model_parallel == 1:
        return x
    dist.all_reduce(x, group=ctx.model_group)
    all_reduce.calls += 1
    return x


def all_gather_last(x: torch.Tensor, ctx) -> torch.Tensor:
    """Concatenate the ranks' slices along the last dim, rank order."""
    n = ctx.model_parallel
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=ctx.model_group)
    all_gather_last.calls += 1
    return torch.cat(parts, dim=-1)


def mean(x: torch.Tensor, ctx) -> torch.Tensor:
    """The mean over the model axis (``pmean``)."""
    n = ctx.model_parallel
    return x if n == 1 else all_reduce(x.clone(), ctx) / n


all_reduce.calls = 0
all_gather_last.calls = 0
