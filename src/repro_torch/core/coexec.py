"""Contention-aware joint co-execution planning: a copy of
``repro.core.coexec`` (described in the repo's docs/coexec.md).

AdaOper's thesis — partitioning for speedup does not imply partitioning for
energy — bites hardest when several models are resident: the partitioner
plans each model as if it owned the device, and only `DeviceSim.set_coexec`
discovers the shared bus/background/thermal contention *after the fact*.
This module closes that gap the way "Optimizing Multi-DNN Inference on
Mobile Devices through Heterogeneous Processor Co-Execution" and Parallax
do — price processor overlap *inside* the planner:

* :class:`RailLoad` / :func:`plan_rail_load` — a plan's demand profile per
  rail (cpu / gpu / bus), the overlap signal co-runners expose to each other.
* :class:`ContentionModel` — multiplicative per-rail contention pricing
  seeded from the *same constants* the simulator's physics uses
  (``COEXEC_BG_PER_RUNNER``, ``BG_AVAIL_SLOPE``, bus time-sharing, thermal
  slopes), wrapped around any partitioner cost callable.  Corrected online:
  :meth:`ContentionModel.observe` compares the fractions a joint plan
  *predicted* against the per-rail ledger attribution the execution
  *measured*, folds sustained residuals into per-rail corrections behind a
  hysteresis threshold (the drift path's discipline), and bumps a version
  that invalidates every cached joint plan.
* :func:`joint_partition` — Gauss-Seidel coordinate descent over the
  resident set: each model re-solves its DP against the contention-priced
  cost of its co-runners' current plans, then every final plan is re-scored
  on the *base* predictor so joint and independent plans stay comparable.
* :class:`CoexecPlanner` — the cache + feedback facade the controller and
  the serving scheduler share (keyed by resident set, state bucket,
  correction versions and fault epoch; bit-identical fallback to
  independent planning when fewer than two models are live).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.opgraph import OpGraph
from repro_torch.core.partitioner import PartitionPlan, dp_partition, score_plan
from repro_torch.core.simulator import (
    BG_AVAIL_SLOPE,
    BUS_GBPS,
    BUS_PJ_PER_BYTE,
    COEXEC_BG_PER_RUNNER,
    COEXEC_THERM_PER_RUNNER,
    CPU,
    GPU,
    THERM_EN_SLOPE,
    THERM_LAT_SLOPE,
)

RAILS = ("cpu", "gpu", "bus")

# residual clamp for one feedback observation (log-space): a single wild
# attribution sample must not swing a correction by more than ~4.5x
_RESID_CLIP = 1.5


@dataclass(frozen=True)
class RailLoad:
    """One plan's demand profile per rail, each in [0, 1].

    ``cpu``/``gpu`` are the shares of the plan's FLOPs landing on each
    processor class; ``bus`` is staged boundary traffic relative to the
    plan's total tensor bytes. This is what a model's plan looks like *to
    its co-runners* — the overlap the contention model prices."""
    cpu: float = 0.0
    gpu: float = 0.0
    bus: float = 0.0


def plan_rail_load(graph: OpGraph, alphas) -> RailLoad:
    """Demand profile of running ``graph`` under ``alphas`` (pure function
    of the plan — no simulator state, no RNG)."""
    a = np.asarray(alphas, np.float64)
    if len(a) == 0:
        return RailLoad()
    flops = np.array([op.flops for op in graph.nodes], np.float64)
    b_in = np.array([op.bytes_in for op in graph.nodes], np.float64)
    b_out = np.array([op.bytes_out for op in graph.nodes], np.float64)
    comm = np.array([op.comm_bytes_if_split for op in graph.nodes], np.float64)
    prev = np.empty_like(a)
    prev[0] = a[0]
    prev[1:] = a[:-1]
    total_flops = max(float(flops.sum()), 1.0)
    split = (a > 0.0) & (a < 1.0)
    moved = float((np.abs(a - prev) * b_in).sum() + 0.5 * comm[split].sum())
    tensor_bytes = max(float((b_in + b_out).sum()), 1.0)
    return RailLoad(
        cpu=float(((1.0 - a) * flops).sum()) / total_flops,
        gpu=float((a * flops).sum()) / total_flops,
        bus=min(1.0, moved / tensor_bytes))


def combine_loads(loads: Sequence[RailLoad]) -> RailLoad:
    """Aggregate co-runner demand: rails saturate, so sums clip at 1."""
    if not loads:
        return RailLoad()
    return RailLoad(cpu=min(1.0, sum(l.cpu for l in loads)),
                    gpu=min(1.0, sum(l.gpu for l in loads)),
                    bus=min(1.0, sum(l.bus for l in loads)))


# worst-case co-runner profile for callers that know *how many* models are
# resident but not what their plans look like (the serving scheduler prices
# admission before co-runners' shapes are known); the ledger feedback loop
# scales it per rail from there
FULL_DUTY = RailLoad(cpu=1.0, gpu=1.0, bus=1.0)


def predicted_rail_fractions(graph: OpGraph, alphas
                             ) -> Optional[Tuple[float, float, float]]:
    """The (cpu, gpu, bus) energy fractions the *planner* expects for a
    plan, from nominal silicon constants only — deliberately the planner's
    view, not the simulator's: it is blind to DVFS state, background load
    and the latent thermal walk, so the gap between this prediction and the
    ledger's measured rail attribution is exactly the signal
    :meth:`ContentionModel.observe` corrects from."""
    a = np.asarray(alphas, np.float64)
    if len(a) == 0:
        return None
    flops = np.array([op.flops for op in graph.nodes], np.float64)
    b_in = np.array([op.bytes_in for op in graph.nodes], np.float64)
    comm = np.array([op.comm_bytes_if_split for op in graph.nodes], np.float64)
    prev = np.empty_like(a)
    prev[0] = a[0]
    prev[1:] = a[:-1]
    # nominal-clock execution times per class, and the op latency envelope
    t_gpu = a * flops / (GPU.gflops_per_ghz * GPU.f_nominal_ghz * 1e9)
    t_cpu = (1.0 - a) * flops / (CPU.gflops_per_ghz * CPU.f_nominal_ghz * 1e9)
    split = (a > 0.0) & (a < 1.0)
    moved = np.abs(a - prev) * b_in + np.where(split, 0.5 * comm, 0.0)
    lat = np.maximum(t_gpu, t_cpu) + moved / (BUS_GBPS * 1e9)
    # active power while the class computes, leakage while it waits
    e_cpu = float((t_cpu * CPU.p_dyn_w_at_nominal + lat * CPU.p_idle_w).sum())
    e_gpu = float((t_gpu * GPU.p_dyn_w_at_nominal + lat * GPU.p_idle_w).sum())
    e_bus = float(moved.sum()) * BUS_PJ_PER_BYTE * 1e-12
    total = e_cpu + e_gpu + e_bus
    if total <= 0.0:
        return None
    return (e_cpu / total, e_gpu / total, e_bus / total)


class ContentionModel:
    """Per-rail contention pricing, physics-seeded and ledger-corrected.

    Seeds (see ``repro_torch.core.simulator``): every co-runner adds
    ``COEXEC_BG_PER_RUNNER`` background utilization on both compute classes
    and each unit of background steals ``BG_AVAIL_SLOPE`` of throughput; the
    staging bus is time-shared ``n`` ways; the die runs
    ``COEXEC_THERM_PER_RUNNER`` hotter per co-runner, inflating latency and
    energy by the thermal slopes.  Each rail carries a multiplicative
    ``correction`` (starting at 1.0) that :meth:`observe` tunes from the
    telemetry ledger with hysteresis — corrections only move on *sustained*
    prediction/measurement divergence, and every move bumps
    :meth:`version` so cached joint plans are invalidated (the same
    discipline as the serving drift path)."""

    def __init__(self, bg_per_runner: float = COEXEC_BG_PER_RUNNER,
                 avail_slope: float = BG_AVAIL_SLOPE,
                 therm_per_runner: float = COEXEC_THERM_PER_RUNNER,
                 hysteresis: float = 0.25, ema_alpha: float = 0.3,
                 correction_bounds: Tuple[float, float] = (0.25, 4.0)):
        self.bg_per_runner = bg_per_runner
        self.avail_slope = avail_slope
        self.therm_per_runner = therm_per_runner
        self.hysteresis = hysteresis
        self.ema_alpha = ema_alpha
        self.correction_bounds = correction_bounds
        self.corrections: Dict[str, float] = {r: 1.0 for r in RAILS}
        self._resid_ema: Dict[str, float] = {r: 0.0 for r in RAILS}
        self._version = 0
        self.observations = 0

    def version(self) -> int:
        """Bumps on every applied correction — joint-plan cache scope."""
        return self._version

    # ------------------------------------------------------------------
    # pricing
    def wrap(self, cost_fn, n_resident: int, co: RailLoad):
        """Contention-priced view of ``cost_fn`` while ``n_resident`` models
        are live and the co-runners present demand ``co``.

        Returns ``cost_fn`` unchanged when there is no contention
        (``n_resident <= 1``) — the independent path stays bit-identical.
        The wrapper mirrors the cost-callable protocol (``batch`` /
        ``batch_cols`` / ``table_cache`` + ``cache_key``); its cache key
        extends the base key with the contention fingerprint so cached
        tables never leak between contention levels."""
        n = int(n_resident)
        if n <= 1:
            return cost_fn
        return _ContendedCost(self, cost_fn, n, co)

    def observe(self, predicted: Optional[Tuple[float, float, float]],
                measured) -> bool:
        """Feed one (predicted fractions, measured breakdown) pair back.

        ``measured`` is an :class:`~repro_torch.core.telemetry.EnergyBreakdown`
        (or a raw fraction triple). Residuals are folded into a log-space
        EMA per rail; once a rail's EMA crosses the hysteresis threshold the
        correction absorbs it (clipped to ``correction_bounds``), the EMA
        resets, and the version bumps. Returns True when any correction
        moved (i.e. cached joint plans just went stale)."""
        if predicted is None:
            return False
        meas = measured.fractions() if hasattr(measured, "fractions") else measured
        if isinstance(meas, dict):
            tot = sum(float(meas.get(r, 0.0)) for r in RAILS)
            meas = (tuple(float(meas.get(r, 0.0)) / tot for r in RAILS)
                    if tot > 0.0 else None)
        if meas is None:
            return False
        self.observations += 1
        lo, hi = self.correction_bounds
        changed = False
        for rail, p, m in zip(RAILS, predicted, meas):
            resid = float(np.clip(np.log((m + 1e-6) / (p + 1e-6)),
                                  -_RESID_CLIP, _RESID_CLIP))
            ema = ((1.0 - self.ema_alpha) * self._resid_ema[rail]
                   + self.ema_alpha * resid)
            if abs(ema) > self.hysteresis:
                self.corrections[rail] = float(
                    np.clip(self.corrections[rail] * np.exp(ema), lo, hi))
                self._resid_ema[rail] = 0.0
                changed = True
            else:
                self._resid_ema[rail] = ema
        if changed:
            self._version += 1
        return changed


class _ContendedCost:
    """Cost-callable wrapper applying :class:`ContentionModel` pricing.

    Per op with split ``a`` (prev ``p``), against ``extra = n - 1``
    co-runners:

    * compute: each co-runner acts as ``bg_per_runner`` background load on
      *both* classes (the simulator's contention is deliberately
      shape-blind — a co-runner steals cycles whichever rail its plan
      favours), so a rail's time inflates by
      ``avail_slope * bg_per_runner`` per co-runner;
    * bus: the staging bus is time-shared ``n`` ways, so the op's boundary
      traffic costs ``extra`` additional bus passes (latency), with both
      classes leaking while the transfer blocks (energy);
    * thermal: ``extra`` co-runners lift the die's steady state, inflating
      latency/energy by the simulator's thermal slopes.

    Each term is scaled by its rail's ledger-learned correction — that is
    the only place per-rail *asymmetry* can enter, and only when the
    ledger has measured it (a phantom asymmetry the physics doesn't have
    would push plans onto the "quiet" rail for no real gain). The uniform
    thermal/compute multipliers keep predicted costs honest under
    contention but cancel inside a single model's EDP argmin; the
    decision-relevant signal is the bus term — under co-execution a
    boundary move costs ``n`` bus passes while the profiler (calibrated
    solo) still prices one."""

    def __init__(self, model: ContentionModel, base, n: int, co: RailLoad):
        self.model = model
        self.base = base
        self.n = n
        self.co = co
        extra = n - 1
        c = model.corrections
        self._k_cpu = (model.avail_slope * model.bg_per_runner * extra
                       * c["cpu"])
        self._k_gpu = (model.avail_slope * model.bg_per_runner * extra
                       * c["gpu"])
        self._k_bus = extra * c["bus"]
        dtherm = model.therm_per_runner * extra
        self._m_lat_th = 1.0 + THERM_LAT_SLOPE * dtherm
        self._m_en_th = 1.0 + THERM_EN_SLOPE * dtherm
        self._idle_w = CPU.p_idle_w + GPU.p_idle_w
        if hasattr(base, "table_cache") and hasattr(base, "cache_key"):
            self.table_cache = base.table_cache

    def cache_key(self):
        co = self.co
        return (self.base.cache_key(), "coex", self.n,
                round(co.cpu, 3), round(co.gpu, 3), round(co.bus, 3),
                self.model.version())

    def _inflate(self, b_in, comm, alphas, prevs, lat, en):
        a = np.asarray(alphas, np.float64)
        p = np.asarray(prevs, np.float64)
        split = (a > 0.0) & (a < 1.0)
        moved = np.abs(a - p) * b_in + np.where(split, 0.5 * comm, 0.0)
        t_bus_extra = self._k_bus * moved / (BUS_GBPS * 1e9)
        m_comp = 1.0 + (1.0 - a) * self._k_cpu + a * self._k_gpu
        lat2 = np.asarray(lat) * (m_comp * self._m_lat_th) + t_bus_extra
        en2 = np.asarray(en) * self._m_en_th + t_bus_extra * self._idle_w
        return lat2, en2

    def __call__(self, op, a, p):
        lat, en = self.base(op, a, p)
        l2, e2 = self._inflate(np.array([op.bytes_in]),
                               np.array([op.comm_bytes_if_split]),
                               np.array([a]), np.array([p]),
                               np.array([lat]), np.array([en]))
        return float(l2[0]), float(e2[0])

    def batch(self, items):
        if hasattr(self.base, "batch"):
            lat, en = self.base.batch(items)
        else:
            lat = np.empty(len(items))
            en = np.empty(len(items))
            for j, (op, a, p) in enumerate(items):
                lat[j], en[j] = self.base(op, float(a), float(p))
        b_in = np.array([op.bytes_in for op, _, _ in items])
        comm = np.array([op.comm_bytes_if_split for op, _, _ in items])
        a = np.array([a for _, a, _ in items])
        p = np.array([p for _, _, p in items])
        return self._inflate(b_in, comm, a, p, lat, en)

    def batch_cols(self, ops, counts, alphas, prevs):
        reps = (np.asarray(counts, np.int64) if counts is not None
                else np.ones(len(ops), np.int64))
        if hasattr(self.base, "batch_cols"):
            lat, en = self.base.batch_cols(ops, counts, alphas, prevs)
        else:
            ops_flat = np.repeat(np.asarray(ops, object), reps)
            lat = np.empty(len(ops_flat))
            en = np.empty(len(ops_flat))
            for j, (op, a, p) in enumerate(zip(ops_flat, alphas, prevs)):
                lat[j], en[j] = self.base(op, float(a), float(p))
        b_in = np.repeat([op.bytes_in for op in ops], reps)
        comm = np.repeat([op.comm_bytes_if_split for op in ops], reps)
        return self._inflate(b_in, comm, alphas, prevs, lat, en)


def joint_partition(graphs: Sequence[OpGraph], cost_fn,
                    model: Optional[ContentionModel] = None,
                    n_resident: Optional[int] = None,
                    objective: str = "edp", rounds: int = 2
                    ) -> Dict[str, PartitionPlan]:
    """Solve the resident set's partitions *together*.

    Gauss-Seidel coordinate descent seeded from the independent plans: each
    round, every model re-solves its DP against ``cost_fn`` wrapped with the
    contention price of its co-runners' *current* plans, for ``rounds``
    sweeps; the fixed point is a plan set where no model wants to move
    given the others. Under the physics-seeded :class:`ContentionModel`
    the pricing depends on the co-runners only through their *count* (the
    simulator's contention is shape-blind), so the sweep converges in one
    round — the coordinate-descent structure is what lets a shape-aware or
    ledger-corrected model (asymmetric rail corrections) couple the plans
    for real.

    ``n_resident`` may exceed ``len(graphs)`` when other workers (e.g. a
    serving-engine LLM) share the device without a graph here.

    Every returned plan is finally re-scored with the *base* ``cost_fn``
    (:func:`~repro_torch.core.partitioner.score_plan`), so ``pred_latency`` /
    ``pred_energy`` live on the same predictor scale as independent plans —
    inflated planning costs steer the search, never the accounting.

    Falls back bit-identically to independent planning when fewer than two
    models are live, there is no contention model, or ``n_resident <= 1``."""
    plans = {g.name: dp_partition(g, cost_fn, objective=objective)
             for g in graphs}
    n = len(graphs) if n_resident is None else int(n_resident)
    if model is None or n <= 1 or len(graphs) <= 1:
        return plans
    loads = {g.name: plan_rail_load(g, plans[g.name].alphas) for g in graphs}
    for _ in range(max(1, rounds)):
        for g in graphs:
            co = combine_loads([loads[h.name] for h in graphs
                                if h.name != g.name])
            plans[g.name] = dp_partition(g, model.wrap(cost_fn, n, co),
                                         objective=objective)
            loads[g.name] = plan_rail_load(g, plans[g.name].alphas)
    for g in graphs:
        plans[g.name] = score_plan(g, plans[g.name].alphas, cost_fn)
    return plans


class CoexecPlanner:
    """Joint-plan cache + ledger-feedback facade shared by the controller
    and the serving scheduler (one instance per device).

    Cache keys span the sorted resident-model set, the co-execution level,
    the base cost callable's key (state bucket + profiler correction
    version), the contention model's correction version and the sim's fault
    epoch — any drift, contention correction or fault transition misses the
    cache and replans jointly."""

    def __init__(self, model: Optional[ContentionModel] = None,
                 objective: str = "edp", rounds: int = 2,
                 cache_size: int = 64):
        self.model = model or ContentionModel()
        self.objective = objective
        self.rounds = rounds
        self.cache_size = cache_size
        self._cache: OrderedDict = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0

    def plans(self, graphs: Sequence[OpGraph], cost_fn,
              n_resident: Optional[int] = None, fault_epoch: int = 0
              ) -> Dict[str, PartitionPlan]:
        """Joint plans for ``graphs`` (cached). Every plan is stamped with
        ``coexec_rails`` — the planner's predicted rail fractions — which
        the execution path reconciles against the ledger via
        :meth:`observe`."""
        names = tuple(sorted(g.name for g in graphs))
        n = len(graphs) if n_resident is None else int(n_resident)
        base_key = (cost_fn.cache_key() if hasattr(cost_fn, "cache_key")
                    else None)
        key = (names, n, base_key, self.model.version(), fault_epoch)
        if base_key is not None:
            hit = self._cache.get(key)
            if hit is not None:
                self.cache_hits += 1
                self._cache.move_to_end(key)
                return hit
        self.cache_misses += 1
        plans = joint_partition(graphs, cost_fn, model=self.model,
                                n_resident=n, objective=self.objective,
                                rounds=self.rounds)
        for g in graphs:
            plans[g.name].coexec_rails = predicted_rail_fractions(
                g, plans[g.name].alphas)
        if base_key is not None:
            self._cache[key] = plans
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        return plans

    def observe(self, predicted, measured) -> bool:
        """Ledger feedback passthrough (see :meth:`ContentionModel.observe`);
        a True return means every cached joint plan is now version-stale."""
        return self.model.observe(predicted, measured)
