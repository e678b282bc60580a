"""AdaOper runtime controller: profiler + partitioner closed loop.

Drives concurrent DNN tasks on the device simulator:
  1. plan each task's operator partitioning from profiler predictions
     under the *observed* device state,
  2. execute (ground-truth physics), feed energy/latency back to the
     profiler (GRU online refinement),
  3. detect per-segment energy drift and trigger INCREMENTAL re-partition
     of the drifted operator segments (not the whole model),
  4. periodically (or on large drift) re-plan fully.

A copy of ``repro.core.controller``, the paper's own system: all numpy, no
device. Without an uncertainty model on the profiler (the layer is not
ported; see ROADMAP.md) drift is the fixed ``drift_threshold`` hysteresis.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.coexec import CoexecPlanner, predicted_rail_fractions
from repro_torch.core.opgraph import OpGraph
from repro_torch.core.partitioner import PartitionPlan, dp_partition, incremental_repartition
from repro_torch.core.profiler import RuntimeEnergyProfiler
from repro_torch.core.simulator import DeviceSim
from repro_torch.core.telemetry import EnergyBreakdown
from repro_torch.faults.errors import FaultError, TransientOpFault
from repro_torch.faults.recovery import pinned_partition, surviving_alpha


@dataclass
class ArrivalRecord:
    """One replayed request: virtual-time accounting from ``run_trace``."""
    t_arrival: float
    t_start: float
    t_done: float
    latency_s: float  # completion - arrival (includes queueing)
    energy_j: float
    meta: object = None


def round_robin_arrivals(graphs: List[OpGraph], iters: int):
    """The legacy synthetic workload as an arrival source: every task
    resident from t=0, served round-robin ``iters`` times."""
    return [(0.0, g) for _ in range(iters) for g in graphs]


@dataclass
class TaskStats:
    latencies: List[float] = field(default_factory=list)
    energies: List[float] = field(default_factory=list)
    repartitions: int = 0
    incremental: int = 0
    drift_events: int = 0

    def totals(self) -> Tuple[float, float]:
        return float(np.sum(self.latencies)), float(np.sum(self.energies))


class AdaOperController:
    def __init__(self, sim: DeviceSim, profiler: RuntimeEnergyProfiler,
                 objective: str = "edp", drift_threshold: float = 0.35,
                 replan_period: int = 16, segment_halo: int = 2,
                 max_op_retries: int = 3,
                 coexec: "CoexecPlanner" = None,
                 legacy_drift: bool = False):
        self.sim = sim
        self.profiler = profiler
        self.objective = objective
        self.drift_threshold = drift_threshold
        self.replan_period = replan_period
        self.segment_halo = segment_halo
        self.max_op_retries = max_op_retries
        # with an uncertainty model attached to the profiler, repartition
        # triggers on observations falling outside the calibrated interval
        # instead of the fixed drift_threshold hysteresis; legacy_drift=True
        # keeps the fixed threshold for bit-exact legacy baselines
        self.legacy_drift = legacy_drift
        # contention-aware joint planner (repro_torch.core.coexec): None (the
        # default) keeps every planning path bit-identical to independent
        # per-model planning
        self.coexec = coexec
        self._resident: Dict[str, OpGraph] = {}
        self.plans: Dict[str, PartitionPlan] = {}
        self.stats: Dict[str, TaskStats] = {}
        self._fault_epoch_seen = getattr(sim, "fault_epoch", 0)

    def set_resident(self, graphs) -> None:
        """Declare the concurrently-resident graph set for joint planning
        (no-op for plan routing unless a ``coexec`` planner is attached and
        at least two models are resident)."""
        self._resident = {g.name: g for g in graphs}

    def _check_fault_epoch(self) -> None:
        """Invalidate every cached plan when the device's fault state moved
        (a rail dropped OR recovered): stale plans would either dispatch
        onto a dead rail or keep limping on the survivor after restoration.
        The next inference replans automatically."""
        epoch = self.sim.fault_epoch
        if epoch != self._fault_epoch_seen:
            self._fault_epoch_seen = epoch
            self.plans.clear()

    def _cost_fn(self, obs_state):
        # the profiler cost callable carries its CostTableCache, so periodic
        # replans of the same graph under an unchanged (state bucket,
        # correction version) reuse the edge-cost tables instead of
        # re-running the GBDT over every placement
        return self.profiler.cost_fn(obs_state)

    def cache_stats(self) -> Dict[str, int]:
        c = self.profiler.table_cache
        return {"hits": c.hits, "misses": c.misses, "entries": len(c)}

    def _joint_active(self, graph: OpGraph) -> bool:
        return (self.coexec is not None and len(self._resident) > 1
                and graph.name in self._resident and self.sim.coexec > 1)

    def plan(self, graph: OpGraph) -> PartitionPlan:
        obs = self.sim.observe()
        pinned = surviving_alpha(self.sim)  # raises when no rail survives
        if pinned is None:
            if self._joint_active(graph):
                # joint co-execution plan: the whole resident set is solved
                # together (cached in the CoexecPlanner; co-residents get
                # their plan from the same solve at their next plan() call)
                plan = self.coexec.plans(
                    list(self._resident.values()), self._cost_fn(obs),
                    n_resident=self.sim.coexec,
                    fault_epoch=getattr(self.sim, "fault_epoch", 0),
                )[graph.name]
            else:
                plan = dp_partition(graph, self._cost_fn(obs),
                                    objective=self.objective)
        else:
            # processor fallback (Parallax-style): a rail is faulted, so the
            # DP collapses — pin every op to the surviving class
            plan = pinned_partition(graph, self._cost_fn(obs), pinned)
            self.sim.ledger.count("fault_replans")
        self.plans[graph.name] = plan
        self.stats.setdefault(graph.name, TaskStats()).repartitions += 1
        self.sim.ledger.count("repartitions")
        return plan

    def run_inference(self, graph: OpGraph) -> Tuple[float, float]:
        """One inference of `graph` under its current plan, with feedback and
        drift-triggered incremental re-partitioning."""
        lat, en, _ = self.run_inference_rails(graph)
        return lat, en

    def run_inference_rails(self, graph: OpGraph
                            ) -> Tuple[float, float, EnergyBreakdown]:
        """``run_inference`` with the ground-truth energy split per rail.
        Appends one ``infer`` StepEvent to the device ledger — the record
        every downstream aggregate (fleet report, benchmarks) folds."""
        self._check_fault_epoch()
        if graph.name not in self.plans:
            self.plan(graph)
        plan = self.plans[graph.name]
        stats = self.stats[graph.name]
        obs = self.sim.observe()
        lat = en = 0.0
        eb = EnergyBreakdown()
        prev = plan.alphas[0]
        items, lats, ens = [], [], []
        retried = 0
        for i, (op, a) in enumerate(zip(graph.nodes, plan.alphas)):
            # bounded retry on injected transient op failures; a
            # ProcessorFault propagates (the plan should have been pinned —
            # run_trace turns it into an explicit rejected record)
            for attempt in range(self.max_op_retries + 1):
                try:
                    l, op_eb = self.sim.exec_op_rails(op, float(a), float(prev))
                    break
                except TransientOpFault:
                    if attempt == self.max_op_retries:
                        raise
                    retried += 1
                    self.sim.ledger.count("op_retries")
            e = op_eb.total_j
            items.append((op, float(a), float(prev)))
            lats.append(l)
            ens.append(e)
            lat += l
            en += e
            eb += op_eb
            prev = a
            self.sim.step(l)
        if retried:
            # the transient fault's matching recovery record (its injector
            # event arms a failure budget instead of opening a window)
            self.sim.ledger.count("recoveries")
            self.sim.ledger.emit(
                "recovery", 0.0, EnergyBreakdown(), t_s=self.sim.now_s,
                model=graph.name,
                meta={"fault": "transient_op", "retries": retried})
        drifts = self.profiler.feedback_batch(items, obs, lats, ens)
        # interval coverage accounting rides the ledger's integer counters
        # (absent without an attached uncertainty model, so non-uncertainty
        # baselines keep the exact pre-existing counter schema)
        unc_stats = self.profiler.take_interval_stats()
        if unc_stats is not None:
            self.sim.ledger.count("interval_observations", unc_stats["n"])
            self.sim.ledger.count("interval_covered", unc_stats["covered"])
            self.sim.ledger.count("interval_width_uj", unc_stats["width_uj"])
            # per-op-class coverage from the (state bucket, op class)
            # conformal keying — fleet reports surface these when nonzero
            for cls, (cn, cc) in unc_stats.get("by_class", {}).items():
                self.sim.ledger.count(f"interval_obs_{cls}", cn)
                self.sim.ledger.count(f"interval_cov_{cls}", cc)
        outside = self.profiler.take_interval_outside()
        interval_mode = outside is not None and not self.legacy_drift
        if interval_mode:
            # principled replacement for the fixed hysteresis: an op drifted
            # when its observed energy fell outside the calibrated interval
            drifted = [int(i) for i in np.nonzero(outside)[0]]
        else:
            drifted = [i for i, d in enumerate(drifts)
                       if d > self.drift_threshold]
        stats.latencies.append(lat)
        stats.energies.append(en)
        if drifted:
            stats.drift_events += 1
            self.sim.ledger.count("drift_events")
        # incremental re-partition of drifted segments (merged + halo);
        # pointless while a rail is down — the plan is pinned to the
        # survivor and any segment re-solve could wander back onto the
        # faulted class
        if drifted and self.sim.faulted_rails:
            drifted = []
        if drifted:
            if interval_mode:
                # the gated counter: repartitions whose *trigger* was an
                # observation escaping its calibrated interval
                self.sim.ledger.count("interval_repartitions")
            obs2 = self.sim.observe()
            segs = self._merge_segments(drifted, len(graph))
            new_plan = plan
            for lo, hi in segs:
                new_plan = incremental_repartition(
                    graph, new_plan, self._cost_fn(obs2), (lo, hi),
                    objective=self.objective,
                    lam=self._lam_estimate(new_plan))
                stats.incremental += 1
                self.sim.ledger.count("incremental")
            if self._joint_active(graph):
                # the incremental solve changed the alphas, so the joint
                # plan's rail prediction is stale — re-stamp it, else the
                # ledger feedback loop goes dark after the first drift
                new_plan.coexec_rails = predicted_rail_fractions(
                    graph, new_plan.alphas)
            self.plans[graph.name] = new_plan
        self.sim.ledger.emit("infer", lat, eb, model=graph.name)
        # joint-planning feedback: reconcile the plan's predicted rail
        # fractions against the measured per-rail attribution; a correction
        # crossing the hysteresis bumps the contention-model version, so
        # every cached joint plan goes stale and the next plan() re-solves
        if self.coexec is not None:
            pred = getattr(plan, "coexec_rails", None)
            if pred is not None and self.coexec.observe(pred, eb):
                self.sim.ledger.count("coexec_corrections")
        n = len(stats.latencies)
        if n % self.replan_period == 0:
            self.plan(graph)
        return lat, en, eb

    def _lam_estimate(self, plan: PartitionPlan) -> float:
        return plan.pred_energy / max(plan.pred_latency, 1e-9)

    def _merge_segments(self, idxs: List[int], n: int) -> List[Tuple[int, int]]:
        h = self.segment_halo
        segs: List[Tuple[int, int]] = []
        for i in idxs:
            lo, hi = max(0, i - h), min(n - 1, i + h)
            if segs and lo <= segs[-1][1] + 1:
                segs[-1] = (segs[-1][0], hi)
            else:
                segs.append((lo, hi))
        return segs

    # ----- trace-driven workload replay (pluggable arrival source) -----
    def run_trace(self, arrivals) -> List[ArrivalRecord]:
        """Discrete-event replay of an arrival source in *virtual* time.

        ``arrivals``: iterable of ``(t_arrival_s, graph)`` or
        ``(t_arrival_s, graph, meta)`` tuples (any order; sorted here). The
        device executes one inference at a time: among the requests that have
        arrived, the highest ``meta.priority`` (then FIFO) is served next;
        gaps with an empty queue advance the device dynamics at idle and
        drain the battery at the leakage floor (``DeviceSim.advance_idle``).
        Latency in the returned records is completion minus arrival, i.e. it
        includes queueing delay — the number an SLO is written against.
        """
        items = []
        for k, item in enumerate(arrivals):
            meta = item[2] if len(item) > 2 else None
            items.append((float(item[0]), k, item[1],
                          int(getattr(meta, "priority", 0)), meta))
        items.sort(key=lambda it: (it[0], it[1]))
        t = 0.0
        i = 0
        pending: List[Tuple] = []  # (-priority, arrival, seq, graph, meta)
        out: List[ArrivalRecord] = []
        while i < len(items) or pending:
            if not pending and items[i][0] > t:
                self.sim.advance_idle(items[i][0] - t)
                t = items[i][0]
            # scheduled fault/recovery boundaries up to the current virtual
            # time take effect before the next request is served (no-op
            # without an attached injector)
            self.sim.advance_faults(t)
            while i < len(items) and items[i][0] <= t + 1e-12:
                t_arr, k, g, prio, meta = items[i]
                heapq.heappush(pending, (-prio, t_arr, k, g, meta))
                i += 1
            _, t_arr, _, g, meta = heapq.heappop(pending)
            try:
                lat, en, eb = self.run_inference_rails(g)
            except FaultError as exc:
                # unservable under the current fault state (no surviving
                # rail / transient budget outlasted the retries): explicit
                # rejected record, never a silent drop or a replay abort
                self.sim.ledger.count("aborted")
                self.sim.ledger.emit(
                    "rejected", 0.0, EnergyBreakdown(), t_s=t,
                    model=getattr(meta, "model", g.name),
                    uid=getattr(meta, "uid", None),
                    meta={"reason": str(exc), "arrival": meta})
                continue
            self.sim.drain(en)
            out.append(ArrivalRecord(t_arr, t, t + lat, t + lat - t_arr, en, meta))
            # the per-request accounting stream the fleet report folds:
            # latency is completion - arrival (the SLO number)
            self.sim.ledger.emit(
                "request", t + lat - t_arr, eb, t_s=t_arr,
                model=getattr(meta, "model", g.name),
                uid=getattr(meta, "uid", None), meta={"arrival": meta})
            t += lat
        return out

    # ----- concurrent workload -----
    def run_concurrent(self, graphs: List[OpGraph], iters: int = 50):
        """Round-robin concurrent inference (paper's concurrent-DNN setting).

        Declares the co-execution level to the device simulator for the
        duration: with several tasks resident, the shared staging bus is
        time-shared and co-runners appear as background load, so the profiler
        learns (and the partitioner plans against) contended physics — the
        same contention model the serving engine's continuous scheduler runs
        under. Implemented as a ``run_trace`` replay of the all-resident
        round-robin arrival source (identical execution order). With a
        ``coexec`` planner attached, the resident set is declared so every
        plan is solved *jointly* with its co-runners' contention priced in."""
        prev_coexec = self.sim.coexec
        prev_resident = self._resident
        self.sim.set_coexec(len(graphs))
        if self.coexec is not None:
            self.set_resident(graphs)
        try:
            self.run_trace(round_robin_arrivals(graphs, iters))
        finally:
            self.sim.set_coexec(prev_coexec)
            self._resident = prev_resident
        return {g.name: self.stats[g.name] for g in graphs}
