"""Processor-fallback replanning (the Parallax-style recovery primitive), a
copy of ``repro.faults.recovery``.

When a processor rail is faulted the DP partitioner's whole search space
collapses: every op must run entirely on the surviving class. Rather than
running a degenerate DP, :func:`pinned_partition` builds the all-``alpha``
plan directly and prices it with one batched cost evaluation — same
``batch_cols``/``batch``/scalar preference order as the partitioner, so the
predicted totals match what ``dp_partition`` would report for the same
assignment.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.opgraph import OpGraph
from repro_torch.core.partitioner import CostFn, PartitionPlan
from repro_torch.faults.errors import ProcessorFault


def surviving_alpha(sim) -> Optional[float]:
    """The partition ratio every op must be pinned to given ``sim``'s
    faulted rails: ``None`` when all rails are healthy (no pinning), 0.0
    when the GPU is out (all-CPU), 1.0 when the CPU is out (all-GPU).
    Raises :class:`ProcessorFault` when no rail survives."""
    rails = getattr(sim, "faulted_rails", frozenset())
    if not rails:
        return None
    if "gpu" in rails and "cpu" in rails:
        raise ProcessorFault("no surviving processor rail: both cpu and gpu "
                             "are faulted")
    return 0.0 if "gpu" in rails else 1.0


def pinned_partition(graph: OpGraph, cost_fn: CostFn,
                     alpha: float) -> PartitionPlan:
    """The degraded-mode plan: every op at ``alpha``, totals from one
    batched cost evaluation over the pinned assignment."""
    n = len(graph)
    alphas = np.full(n, float(alpha))
    prevs = alphas  # uniform plan: no repartition boundary traffic
    if hasattr(cost_fn, "batch_cols"):
        lat_v, en_v = cost_fn.batch_cols(graph.nodes, None, alphas, prevs)
    elif hasattr(cost_fn, "batch"):
        lat_v, en_v = cost_fn.batch(
            [(op, float(a), float(p))
             for op, a, p in zip(graph.nodes, alphas, prevs)])
    else:
        lat_v = np.empty(n)
        en_v = np.empty(n)
        for j, op in enumerate(graph.nodes):
            lat_v[j], en_v[j] = cost_fn(op, float(alpha), float(alpha))
    return PartitionPlan(alphas, float(np.sum(lat_v)), float(np.sum(en_v)))
