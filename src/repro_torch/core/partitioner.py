"""Energy-aware operator partitioner — AdaOper module #2 (a copy of
``repro.core.partitioner``).

Bottom-up iterative dynamic program over the operator chain. The DP state is
the partition ratio of the *previous* operator only (the paper's "utilize
only a few previous states ... storing only those states"), so memory is
O(|ratio levels|), independent of model depth.

Objectives:
  * "energy"  — minimize predicted energy
  * "latency" — minimize predicted latency (the CoDL-like baseline)
  * "edp"     — minimize energy x delay via a Lagrangian sweep over
                J(lam) = E + lam*T (each fixed-lam DP is additive => exact);
                the sweep picks the lam whose plan minimizes true E*T.
  * SLO mode  — min energy s.t. latency <= slo, via a batched bracketed
                search on lam.

Fast path (see docs/planner.md): the whole Lagrangian sweep runs as ONE
lambda-batched DP (``_dp_solve_batch`` over (L, A, P) tensors) instead of L
sequential scalar DPs, and edge-cost tables are served from the profiler's
``CostTableCache`` when the cost callable exposes one. Both paths produce
bit-identical plans (same ``argmin`` tie-breaking); ``vectorize=False``
keeps the scalar reference alive for equivalence tests and benchmarks.

Incremental re-partition: when runtime energy drifts on a segment of
operators, only that segment is re-solved with its boundary placements
pinned — the paper's "redistribution of partial operators ... rather than
the entire model".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.opgraph import OpGraph

ALPHA_LEVELS = np.array([0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0])
ALPHA_LEVELS_FINE = np.linspace(0.0, 1.0, 17)  # 1/16 grain (CoDL uses ~continuous ratios)

# cost_fn(op, alpha, prev_alpha) -> (latency_s, energy_j)
CostFn = Callable[[object, float, float], Tuple[float, float]]


@dataclass
class PartitionPlan:
    alphas: np.ndarray
    pred_latency: float
    pred_energy: float

    @property
    def edp(self) -> float:
        return self.pred_latency * self.pred_energy


def _levels_for(op) -> np.ndarray:
    lv = getattr(op, "_alpha_levels", None)
    if lv is not None:
        return lv
    if not op.splittable:
        lv = np.array([0.0, 1.0])
    elif op.split_grain < 8:
        k = max(1, op.split_grain)
        lv = np.unique(np.concatenate([[0.0, 1.0], np.arange(1, k) / k]))
    elif op.split_grain >= 16:
        lv = ALPHA_LEVELS_FINE
    else:
        lv = ALPHA_LEVELS
    try:
        op._alpha_levels = lv
    except AttributeError:
        pass
    return lv


def _edge_costs(graph: OpGraph, cost_fn: CostFn,
                seg: Optional[Tuple[int, int]] = None):
    """Precompute (lat, en) for every (op, alpha, prev_alpha) in the segment.

    Preference order for evaluating the table entries:
      1. ``cost_fn.batch_cols(ops, counts, alphas, prevs)`` — fully columnar,
         no per-item Python tuples (the profiler's fast path);
      2. ``cost_fn.batch(items)`` — one vectorised call over tuples;
      3. plain per-item calls.

    If ``cost_fn`` carries a ``table_cache`` + ``cache_key()`` (the profiler
    cost callable does), tables are served from / stored into that cache,
    keyed by (graph id, segment, state bucket, correction version).
    """
    lo, hi = seg if seg else (0, len(graph) - 1)
    cache = getattr(cost_fn, "table_cache", None)
    key = None
    if cache is not None and hasattr(cost_fn, "cache_key"):
        key = (id(graph), lo, hi, cost_fn.cache_key())
        hit = cache.get(key, graph)
        if hit is not None:
            return hit
    ops, counts, a_cols, p_cols = [], [], [], []
    layout = []  # (levels, n_prev)
    for i in range(lo, hi + 1):
        op = graph.nodes[i]
        levels = _levels_for(op)
        if i == lo:
            # segment head: no transition edge — prev is the op's own alpha
            layout.append((levels, 1))
            a_cols.append(levels)
            p_cols.append(levels)
            counts.append(len(levels))
        else:
            prev_levels = _levels_for(graph.nodes[i - 1])
            layout.append((levels, len(prev_levels)))
            a_cols.append(np.repeat(levels, len(prev_levels)))
            p_cols.append(np.tile(prev_levels, len(levels)))
            counts.append(len(levels) * len(prev_levels))
        ops.append(op)
    alphas = np.concatenate(a_cols)
    prevs = np.concatenate(p_cols)
    if hasattr(cost_fn, "batch_cols"):
        lat_flat, en_flat = cost_fn.batch_cols(ops, counts, alphas, prevs)
    elif hasattr(cost_fn, "batch"):
        items = [(op, float(a), float(p))
                 for op, c, off in zip(ops, counts, np.cumsum([0] + counts[:-1]))
                 for a, p in zip(alphas[off:off + c], prevs[off:off + c])]
        lat_flat, en_flat = cost_fn.batch(items)
    else:
        lat_flat = np.empty(len(alphas))
        en_flat = np.empty(len(alphas))
        op_of = np.repeat(np.arange(len(ops)), counts)
        for j in range(len(alphas)):
            lat_flat[j], en_flat[j] = cost_fn(ops[op_of[j]], float(alphas[j]),
                                              float(prevs[j]))
    tables = []
    off = 0
    for (levels, n_prev), n in zip(layout, counts):
        lat = np.ascontiguousarray(lat_flat[off: off + n].reshape(len(levels), n_prev))
        en = np.ascontiguousarray(en_flat[off: off + n].reshape(len(levels), n_prev))
        off += n
        tables.append((levels, lat, en))
    if key is not None:
        cache.put(key, graph, tables)
    return tables


def _dp_solve(tables, lam: float, exit_costs=None):
    """Bottom-up DP minimizing sum(en + lam*lat). Returns (alphas, lat, en).

    ``exit_costs``: optional ``(lat, en)`` arrays over the LAST op's alpha
    levels — the cost of a pinned *next* op (outside the segment) given each
    candidate boundary alpha. Charged into the final DP column so segment
    re-solves account for the exit transition edge.
    """
    # forward pass, keeping only the previous column of states
    back: List[np.ndarray] = []
    prev_cost = None
    prev_lat = prev_en = None
    for i, (levels, lat, en) in enumerate(tables):
        J = en + lam * lat  # (A, P)
        if i == 0:
            cost = J[:, 0]
            cum_lat, cum_en = lat[:, 0].copy(), en[:, 0].copy()
            bp = np.zeros(len(levels), np.int32)
        else:
            total = J + prev_cost[None, :]  # (A, P)
            bp = np.argmin(total, axis=1).astype(np.int32)
            cost = total[np.arange(len(levels)), bp]
            cum_lat = prev_lat[bp] + lat[np.arange(len(levels)), bp]
            cum_en = prev_en[bp] + en[np.arange(len(levels)), bp]
        back.append(bp)
        prev_cost, prev_lat, prev_en = cost, cum_lat, cum_en
    # boundary: charge the exit transition edge (if pinned) before the argmin
    if exit_costs is not None:
        exit_lat, exit_en = exit_costs
        ai = int(np.argmin(prev_cost + exit_en + lam * exit_lat))
    else:
        ai = int(np.argmin(prev_cost))
    total_lat, total_en = float(prev_lat[ai]), float(prev_en[ai])
    # backtrack
    alphas = []
    for i in range(len(tables) - 1, -1, -1):
        alphas.append(float(tables[i][0][ai]))
        ai = int(back[i][ai])
    alphas.reverse()
    return np.array(alphas), total_lat, total_en


def _dp_solve_batch(tables, lams, exit_costs=None):
    """Lambda-batched twin of ``_dp_solve``: solves ALL of ``lams`` in one
    forward/backtrack pass over (L, A, P) tensors.

    Returns ``(alphas (L, N), lat (L,), en (L,))``, bit-identical per lambda
    to the scalar solver (same elementwise arithmetic, same first-occurrence
    ``argmin`` tie-breaking).
    """
    lams = np.asarray(lams, np.float64)
    L = len(lams)
    lam3 = lams[:, None, None]
    back: List[np.ndarray] = []
    prev_cost = prev_lat = prev_en = None
    for i, (levels, lat, en) in enumerate(tables):
        A = len(levels)
        if i == 0:
            cost = en[None, :, 0] + lams[:, None] * lat[None, :, 0]  # (L, A)
            cum_lat = np.broadcast_to(lat[:, 0], (L, A)).copy()
            cum_en = np.broadcast_to(en[:, 0], (L, A)).copy()
            bp = np.zeros((L, A), np.int32)
        else:
            total = (en[None] + lam3 * lat[None]) + prev_cost[:, None, :]  # (L, A, P)
            bp = np.argmin(total, axis=2).astype(np.int32)
            cost = np.take_along_axis(total, bp[:, :, None], axis=2)[:, :, 0]
            ar = np.arange(A)[None, :]
            cum_lat = np.take_along_axis(prev_lat, bp, axis=1) + lat[ar, bp]
            cum_en = np.take_along_axis(prev_en, bp, axis=1) + en[ar, bp]
        back.append(bp)
        prev_cost, prev_lat, prev_en = cost, cum_lat, cum_en
    if exit_costs is not None:
        exit_lat, exit_en = exit_costs
        final = prev_cost + exit_en[None] + lams[:, None] * exit_lat[None]
        ai = np.argmin(final, axis=1).astype(np.int32)
    else:
        ai = np.argmin(prev_cost, axis=1).astype(np.int32)
    total_lat = np.take_along_axis(prev_lat, ai[:, None], axis=1)[:, 0]
    total_en = np.take_along_axis(prev_en, ai[:, None], axis=1)[:, 0]
    # batched backtrack
    n = len(tables)
    alphas = np.empty((L, n))
    cur = ai
    for i in range(n - 1, -1, -1):
        alphas[:, i] = tables[i][0][cur]
        cur = np.take_along_axis(back[i], cur[:, None], axis=1)[:, 0]
    return alphas, total_lat, total_en


def _edp_sweep_lambdas(tables, n_lambda: int, vectorize: bool) -> np.ndarray:
    """Endpoint solves (lam=0, lam=inf) fix the lambda scale for the sweep."""
    if vectorize:
        _, ts, es = _dp_solve_batch(tables, np.array([0.0, 1e12]))
        t0, e0, t1, e1 = float(ts[0]), float(es[0]), float(ts[1]), float(es[1])
    else:
        _, t0, e0 = _dp_solve(tables, lam=0.0)
        _, t1, e1 = _dp_solve(tables, lam=1e12)
    lam_scale = (e0 - e1) / max(t1 - t0, 1e-12) if t1 > t0 else 1.0
    return np.concatenate([[0.0], np.geomspace(0.05, 20.0, n_lambda) * abs(lam_scale)])


def _slo_partition(tables, slo: float, vectorize: bool) -> PartitionPlan:
    """Min energy s.t. latency <= slo.

    T(lam) is weakly decreasing and E(lam) weakly increasing along the
    Lagrangian frontier, so the optimum is the smallest feasible lam. The
    batched path evaluates a geometric lam grid in one DP pass, then
    narrows the bracket with a few more batched rounds; the scalar path is
    the original 40-step bisection.
    """
    if vectorize:
        lams = np.concatenate([[0.0], np.geomspace(1e-3, 1e4, 28)])
        al, ts, es = _dp_solve_batch(tables, lams)
        feas = ts <= slo
        if not feas.any():
            # cost magnitudes can push the feasibility threshold past 1e4
            # (the scalar reference's doubling phase reaches ~1e9) — extend
            # the grid before declaring the SLO infeasible
            lams = np.geomspace(1e4, 1e12, 24)
            al, ts, es = _dp_solve_batch(tables, lams)
            feas = ts <= slo
        if not feas.any():  # SLO infeasible: fall back to latency-optimal
            a, t, e = _dp_solve(tables, lam=1e12)
            return PartitionPlan(a, t, e)
        i = int(np.argmax(feas))
        best = (al[i], float(ts[i]), float(es[i]))
        if i > 0:
            lo_l, hi_l = float(lams[i - 1]), float(lams[i])
            for _ in range(3):
                grid = (np.geomspace(lo_l, hi_l, 10) if lo_l > 0
                        else np.linspace(lo_l, hi_l, 10))
                ag, tg, eg = _dp_solve_batch(tables, grid)
                fg = tg <= slo
                j = int(np.argmax(fg))
                if not fg[j]:
                    break
                if eg[j] <= best[2]:
                    best = (ag[j], float(tg[j]), float(eg[j]))
                hi_l = float(grid[j])
                if j > 0:
                    lo_l = float(grid[j - 1])
                if (hi_l - lo_l) < 1e-6 * max(hi_l, 1e-12):
                    break
        return PartitionPlan(best[0], best[1], best[2])
    # scalar reference: bisection on lam
    lo, hi = 0.0, 1e4
    best = None
    for _ in range(40):
        mid = 0.5 * (lo + hi) if hi < 1e4 else (lo * 2 + 1e-3)
        a, t, e = _dp_solve(tables, lam=mid)
        if t <= slo:
            best = PartitionPlan(a, t, e)
            hi = mid
        else:
            lo = mid
        if hi < 1e4 and (hi - lo) < 1e-6 * hi:
            break
    if best is None:
        a, t, e = _dp_solve(tables, lam=1e12)
        best = PartitionPlan(a, t, e)
    return best


def dp_partition(graph: OpGraph, cost_fn: CostFn, objective: str = "edp",
                 lam: Optional[float] = None, slo: Optional[float] = None,
                 n_lambda: int = 12, vectorize: bool = True) -> PartitionPlan:
    tables = _edge_costs(graph, cost_fn)
    if objective == "latency":
        a, t, e = _dp_solve(tables, lam=1e12)
        return PartitionPlan(a, t, e)
    if objective == "energy":
        a, t, e = _dp_solve(tables, lam=0.0)
        return PartitionPlan(a, t, e)
    if slo is not None:
        return _slo_partition(tables, slo, vectorize)
    # EDP via Lagrangian sweep (each fixed-lam DP is exact for E + lam*T)
    if lam is not None:
        a, t, e = _dp_solve(tables, lam=lam)
        return PartitionPlan(a, t, e)
    lams = _edp_sweep_lambdas(tables, n_lambda, vectorize)
    if vectorize:
        al, ts, es = _dp_solve_batch(tables, lams)
        i = int(np.argmin(ts * es))
        return PartitionPlan(al[i], float(ts[i]), float(es[i]))
    best = None
    for l in lams:
        a, t, e = _dp_solve(tables, lam=float(l))
        plan = PartitionPlan(a, t, e)
        if best is None or plan.edp < best.edp:
            best = plan
    return best


def score_plan(graph: OpGraph, alphas: np.ndarray, cost_fn: CostFn) -> PartitionPlan:
    """Price a fixed assignment of alphas under ``cost_fn`` (one batched
    call). Used wherever a plan was *found* with a different objective or a
    wrapped cost model — segment re-solves, contention-priced joint plans —
    but must be *accounted* on the base predictor's scale."""
    alphas = np.asarray(alphas, np.float64)
    prevs = np.empty_like(alphas)
    prevs[0] = alphas[0]
    prevs[1:] = alphas[:-1]
    if hasattr(cost_fn, "batch_cols"):
        lat_v, en_v = cost_fn.batch_cols(graph.nodes, None, alphas, prevs)
    elif hasattr(cost_fn, "batch"):
        lat_v, en_v = cost_fn.batch(
            [(op, float(a), float(p)) for op, a, p in zip(graph.nodes, alphas, prevs)])
    else:
        lat_v = np.empty(len(alphas))
        en_v = np.empty(len(alphas))
        for j, (op, a, p) in enumerate(zip(graph.nodes, alphas, prevs)):
            lat_v[j], en_v[j] = cost_fn(op, float(a), float(p))
    return PartitionPlan(alphas, float(np.sum(lat_v)), float(np.sum(en_v)))


def incremental_repartition(graph: OpGraph, plan: PartitionPlan, cost_fn: CostFn,
                            segment: Tuple[int, int], objective: str = "edp",
                            lam: Optional[float] = None) -> PartitionPlan:
    """Re-solve only ops in [segment], pinning boundary placements.

    The entry boundary is honored by closing the first op's cost over the
    pinned previous alpha; the exit boundary by charging the pinned next
    op's transition cost (an ``exit_costs`` column over the last op's alpha
    levels) into the final DP column — so the boundary alpha is chosen
    with the exit edge priced in, not forced to mirror the next op.
    """
    lo, hi = segment
    lo, hi = max(0, lo), min(len(graph) - 1, hi)
    entry = float(plan.alphas[lo - 1]) if lo > 0 else None

    first_op = graph.nodes[lo]

    class _SegCost:
        # NOTE: deliberately does NOT forward ``table_cache`` — segment
        # tables depend on the pinned entry alpha, which the cache key
        # cannot see.
        def __call__(self, op, a, p):
            if op is first_op and entry is not None:
                return cost_fn(op, a, entry)
            return cost_fn(op, a, p)

        if hasattr(cost_fn, "batch"):
            def batch(self, items):
                fixed = [(op, a, entry if (op is first_op and entry is not None) else p)
                         for op, a, p in items]
                return cost_fn.batch(fixed)

        if hasattr(cost_fn, "batch_cols"):
            def batch_cols(self, ops, counts, alphas, prevs):
                if entry is not None and len(ops) and ops[0] is first_op:
                    prevs = np.array(prevs, np.float64, copy=True)
                    prevs[: counts[0]] = entry
                return cost_fn.batch_cols(ops, counts, alphas, prevs)

    seg_cost = _SegCost()

    # exit edge: cost of the pinned NEXT op for each candidate boundary alpha
    exit_costs = None
    if hi < len(graph) - 1:
        next_op = graph.nodes[hi + 1]
        exit_a = float(plan.alphas[hi + 1])
        boundary = _levels_for(graph.nodes[hi])
        if hasattr(cost_fn, "batch_cols"):
            exit_costs = cost_fn.batch_cols(
                [next_op], [len(boundary)],
                np.full(len(boundary), exit_a), boundary)
        elif hasattr(cost_fn, "batch"):
            exit_costs = cost_fn.batch([(next_op, exit_a, float(p)) for p in boundary])
        else:
            el = np.empty(len(boundary))
            ee = np.empty(len(boundary))
            for j, p in enumerate(boundary):
                el[j], ee[j] = cost_fn(next_op, exit_a, float(p))
            exit_costs = (el, ee)

    tables = _edge_costs(graph, seg_cost, seg=(lo, hi))
    if objective == "latency":
        l = 1e12
    elif objective == "energy":
        l = 0.0
    else:
        l = lam if lam is not None else 1.0
    a_seg, _, _ = _dp_solve(tables, lam=l, exit_costs=exit_costs)
    alphas = plan.alphas.copy()
    alphas[lo : hi + 1] = a_seg
    # recompute plan-level totals with the true cost_fn (one batched call)
    return score_plan(graph, alphas, cost_fn)
