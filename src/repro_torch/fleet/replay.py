"""Discrete-event fleet replay: one AdaOper stack per simulated device (the
counterpart of ``repro.fleet.replay``).

For every device sampled by :mod:`repro_torch.fleet.population`, the harness
builds the full closed loop — a :class:`DeviceSim` with that device's
silicon and battery, a per-device :class:`RuntimeEnergyProfiler` calibrated
against *that* device's physics, and an :class:`AdaOperController` (and, in
serving mode, a :class:`ServingEngine`) — then replays a scenario trace from
:mod:`repro_torch.fleet.workloads` in virtual time and rolls the records up into a
:class:`FleetReport`.

Backends:
  * ``graph``   — every request is one inference of its model's operator
    graph through ``AdaOperController.run_trace`` (ground-truth simulator
    physics; fast; all scenarios; numpy only).
  * ``serving`` — LLM requests are served token-by-token through the
    continuous-batching ``ServingEngine`` (batched prefill admission,
    energy-aware admission, virtual clock) while vision frames run through
    the graph path's ``AdaOperController`` on the same device — one merged
    virtual timeline, so ``mixed`` (vision+LLM) diurnal traces replay
    end-to-end. Requires per-LLM-model (cfg, params); each model runs on
    the device its params lie on (the CUDA kernels on the card, their plain
    versions on the CPU); models without a serving worker resolve against
    the graph registry. The serving workers are single-device: a mesh in
    ``serving_ctx`` is refused until sharded serving is ported.

The simulated device's joules, latencies and battery are DeviceSim's (a
mobile SoC's rails on a virtual clock), never the serving card's.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.controller import AdaOperController
from repro_torch.core.opgraph import OP_TYPES, OpGraph, build_transformer_graph, build_yolo_graph
from repro_torch.core.profiler import RuntimeEnergyProfiler
from repro_torch.core.telemetry import EnergyBreakdown
from repro_torch.faults import FaultError, FaultInjector, FaultPlan, chaos_plan
from repro_torch.fleet.population import DeviceProfile
from repro_torch.fleet.report import DeviceMetrics, FleetReport, RequestRecord
from repro_torch.fleet.workloads import ASSISTANT, Trace, make_trace

# trace seeds are decorrelated across devices with a fixed stride (prime, so
# device k's stream never aliases device 0's at small fleet seeds)
_DEVICE_SEED_STRIDE = 7919

# graceful-degradation counters surfaced in fleet reports when nonzero
# (kept out of the schema when zero so pre-chaos baselines stay identical)
_ROBUST_COUNTER_KEYS = ("faults", "recoveries", "fault_replans", "op_retries",
                        "aborted", "shed", "deadline_requeues",
                        "deadline_misses", "deadline_evictions",
                        "battery_dead")

# speculative-decoding counters (repro_torch.serving.speculative), surfaced only
# when nonzero: replays without a draft keep the report schema byte-for-byte
_SPEC_COUNTER_KEYS = ("spec_rounds", "spec_drafted", "spec_accepted",
                      "spec_fallbacks")

# uncertainty counters (repro_torch.uncertainty), surfaced only when nonzero like
# the robustness set: runs without an attached uncertainty model keep the
# pre-uncertainty report schema byte-for-byte; the per-op-class pairs come
# from the conformal model's (state bucket, op class) keying, so fleet
# reports expose coverage per operator class, not just in aggregate
_UNCERTAINTY_COUNTER_KEYS = (
    ("interval_observations", "interval_covered",
     "interval_width_uj", "interval_repartitions")
    + tuple(f"interval_obs_{t}" for t in OP_TYPES)
    + tuple(f"interval_cov_{t}" for t in OP_TYPES))


def _require_models(trace: Trace, known, backend: str) -> None:
    """Fail fast when a trace names models the backend cannot serve. The
    serving backend resolves against serving workers *and* the graph
    registry (vision frames route to the graph path), so ``known`` is that
    union for ``backend='serving'``."""
    missing = {r.model for r in trace} - set(known)
    if not missing:
        return
    uids = {m: [r.uid for r in trace if r.model == m] for m in sorted(missing)}
    detail = "; ".join(
        f"{m!r} (request uids {u[:8]}{' ...' if len(u) > 8 else ''}, "
        f"{len(u)} total)" for m, u in uids.items())
    if backend == "graph":
        raise ValueError(f"trace references unknown models: {detail}")
    raise ValueError(
        f"serving backend has neither a serving worker nor an operator "
        f"graph for: {detail}; register the model in serving_models or "
        f"the graph registry")


def default_graph_registry() -> Dict[str, OpGraph]:
    """Model id -> operator graph for the graph backend. The detector is the
    paper's YOLOv2-tiny at capture resolution, AR segmentation is the same
    backbone at 224 (lighter, tighter SLO), and the assistant is the reduced
    LLM's decode graph — one graph pass per utterance."""
    from repro_torch.configs.base import get_config, reduced

    vision = build_yolo_graph(resolution=416)
    vision.name = "vision-det"
    ar = build_yolo_graph(resolution=224)
    ar.name = "ar-seg"
    cfg = reduced(get_config("tinyllama-1.1b"))
    assistant = build_transformer_graph(cfg, 1, 48, kind="decode")
    assistant.name = ASSISTANT
    return {vision.name: vision, ar.name: ar, assistant.name: assistant}


class DeviceReplay:
    """One simulated device's replay runtime (see module docstring)."""

    def __init__(self, profile: DeviceProfile, graphs: Dict[str, OpGraph],
                 calib_samples: int = 350, use_gru: bool = False,
                 objective: str = "edp", backend: str = "graph",
                 serving_models: Optional[Dict[str, tuple]] = None,
                 max_slots: int = 4, fault_plan: Optional[FaultPlan] = None,
                 joint: bool = False, uncertainty: bool = False,
                 risk_level: Optional[float] = None, serving_ctx=None,
                 serving_drafts: Optional[Dict[str, tuple]] = None):
        if backend not in ("graph", "serving"):
            raise ValueError(f"unknown replay backend {backend!r}; choose "
                             "from ('graph', 'serving')")
        if getattr(serving_ctx, "mesh", None) is not None:
            raise NotImplementedError("sharded serving (a mesh in serving_ctx) is not "
                                      "ported to repro_torch yet (see ROADMAP.md)")
        self.profile = profile
        self.graphs = graphs
        self.backend = backend
        # explicit fault schedule; chaos_* scenario traces derive one from
        # (scenario, duration, trace seed) at run() when this is None
        self.fault_plan = fault_plan
        self.sim = profile.make_sim()
        self.profiler = RuntimeEnergyProfiler(use_gru=use_gru,
                                              seed=profile.seed)
        # uncertainty=True: per-device quantile ensembles + conformal
        # calibration (repro_torch.uncertainty), attached before calibration so
        # the spread members fit on this device's trace; False keeps every
        # prediction and plan bit-identical (the inert default)
        self.uncertainty = None
        if uncertainty:
            from repro_torch.uncertainty import UncertaintyModel
            self.uncertainty = UncertaintyModel(seed=profile.seed)
            self.profiler.attach_uncertainty(self.uncertainty)
        self.profiler.offline_calibrate(list(graphs.values()),
                                        n_samples=calib_samples,
                                        seed=profile.seed,
                                        sim_factory=profile.sim_factory())
        # joint=True: one contention model + joint-plan cache per device,
        # shared by the controller and (in serving mode) the scheduler —
        # both plan against the same ledger-corrected contention pricing
        self.coexec = None
        if joint:
            from repro_torch.core.coexec import CoexecPlanner
            self.coexec = CoexecPlanner(objective=objective)
        self.controller = AdaOperController(self.sim, self.profiler,
                                            objective=objective,
                                            coexec=self.coexec)
        self.engine = None
        # the engine's responses of the last serving run (tokens per uid);
        # no number of the report reads them
        self.responses: List = []
        if backend == "serving":
            from repro_torch.serving.engine import AdaOperScheduler, ServingEngine
            self.engine = ServingEngine(
                scheduler=AdaOperScheduler(self.profiler, self.sim,
                                           coexec=self.coexec),
                mode="continuous", max_slots=max_slots,
                sampling_seed=profile.seed, risk_level=risk_level)
            # serving_ctx: a shared single-device ExecContext applied to
            # every worker (e.g. attn_impl="plain"); None keeps the default
            # serving_drafts: model name -> (draft_cfg, draft_params) turns
            # on energy-aware speculative decoding for that worker
            # (repro_torch.serving.speculative); absent names keep plain decode
            for name, (cfg, params) in (serving_models or {}).items():
                kw = {}
                if serving_ctx is not None:
                    kw["ctx"] = serving_ctx
                draft = (serving_drafts or {}).get(name)
                if draft is not None:
                    kw["draft"] = draft
                self.engine.add_model(name, cfg, params, max_len=64, **kw)

    def _set_resident_graphs(self, trace: Trace) -> None:
        """Declare the trace's distinct graph-path models as the
        controller's resident set for joint planning (no-op without a
        coexec planner)."""
        if self.coexec is None:
            return
        models = sorted({r.model for r in trace if r.model in self.graphs})
        self.controller.set_resident([self.graphs[m] for m in models])

    def run(self, trace: Trace) -> Tuple[List[RequestRecord], Dict[str, int]]:
        b0 = self.sim.battery_pct
        # chaos scenarios replay under their seeded fault schedule; other
        # scenarios (chaos_plan -> None) attach nothing and stay inert
        plan = self.fault_plan
        if plan is None:
            plan = chaos_plan(trace.scenario, trace.duration_s,
                              seed=trace.seed)
        if plan is not None and self.sim.faults is None:
            FaultInjector(self.sim, plan)
        # the ledger is cumulative over the device's life; fold only this
        # run's window so back-to-back runs stay independent
        mark = len(self.sim.ledger.events)
        self._counters0 = dict(self.sim.ledger.counters)
        if self.backend == "graph":
            counters = self._run_graph(trace)
        else:
            counters = self._run_serving(trace)
        self.battery_start_pct, self.battery_end_pct = b0, self.sim.battery_pct
        # every number in the report folds out of the device's ledger: the
        # run_* drivers only emit events + counters, this derives the records
        return self._records_from_ledger(trace, mark), counters

    def metrics(self, records, counters) -> DeviceMetrics:
        return DeviceMetrics.from_records(
            self.profile.name, self.profile.tier, records,
            self.battery_start_pct, self.battery_end_pct, counters,
            time_to_empty_s=self.sim.battery_dead_t_s)

    def _records_from_ledger(self, trace: Trace,
                             mark: int = 0) -> List[RequestRecord]:
        """Join the ledger's per-request events (one per served arrival,
        appended at completion by the controller / engine, starting at
        event index ``mark``) with the trace for SLO and priority context.
        Sorted by uid for a stable order."""
        by_uid = {r.uid: r for r in trace}
        records = []
        for ev in self.sim.ledger.events[mark:]:
            if ev.kind != "request":
                continue
            tr = by_uid[ev.uid]
            records.append(RequestRecord(
                uid=tr.uid, model=tr.model, priority=tr.priority,
                t_arrival_s=tr.t_arrival_s,
                t_done_s=tr.t_arrival_s + ev.latency_s,
                latency_s=ev.latency_s, energy_j=ev.energy.total_j,
                slo_s=tr.slo_s, slo_met=ev.latency_s <= tr.slo_s,
                energy_cpu_j=ev.energy.cpu_j, energy_gpu_j=ev.energy.gpu_j,
                energy_bus_j=ev.energy.bus_j))
        records.sort(key=lambda rec: rec.uid)
        return records

    # ------------------------------------------------------------------
    def _run_graph(self, trace: Trace) -> Dict[str, int]:
        _require_models(trace, self.graphs, "graph")
        # resident concurrent tasks contend like run_concurrent's setting
        prev = self.sim.coexec
        self.sim.set_coexec(max(1, len({r.model for r in trace})))
        self._set_resident_graphs(trace)
        try:
            self.controller.run_trace(
                [(r.t_arrival_s, self.graphs[r.model], r) for r in trace])
        finally:
            self.sim.set_coexec(prev)
            self.controller.set_resident(())
        c = self._ledger_counter_delta()
        out = {"repartitions": c.get("repartitions", 0),
               "incremental": c.get("incremental", 0),
               "drift_events": c.get("drift_events", 0)}
        out.update(self._robust_counters(c))
        out.update(self._uncertainty_counters(c))
        return out

    def _ledger_counter_delta(self) -> Dict[str, int]:
        """This run's raw ledger counters (cumulative minus the snapshot
        taken at the start of ``run``)."""
        base = getattr(self, "_counters0", {})
        return {k: v - base.get(k, 0)
                for k, v in self.sim.ledger.counters.items()}

    @staticmethod
    def _robust_counters(c: Dict[str, int]) -> Dict[str, int]:
        """Nonzero graceful-degradation counters (fault/recovery, shed,
        deadline machinery). Zero counters are omitted so non-chaos runs
        keep the pre-chaos report schema byte-for-byte."""
        return {k: c[k] for k in _ROBUST_COUNTER_KEYS if c.get(k)}

    @staticmethod
    def _uncertainty_counters(c: Dict[str, int]) -> Dict[str, int]:
        """Nonzero interval coverage/width/repartition counters — absent
        without an attached uncertainty model (same only-when-nonzero rule
        as the robustness set)."""
        return {k: c[k] for k in _UNCERTAINTY_COUNTER_KEYS if c.get(k)}

    def _llm_request(self, trace: Trace, r):
        """Deterministic synthetic prompt for one LLM trace request."""
        from repro_torch.serving.engine import Request

        vocab = self.engine.workers[r.model].cfg.vocab_size
        rng = np.random.default_rng([trace.seed, r.uid])
        prompt = rng.integers(1, vocab, max(r.prompt_len, 1), dtype=np.int32)
        return Request(r.uid, prompt, max_new_tokens=max(r.max_new_tokens, 1),
                       priority=r.priority,
                       deadline_s=getattr(r, "deadline_s", None))

    def _serving_counters(self) -> Dict[str, int]:
        """Fleet counter schema from the shared ledger. The engine counts
        its drift events under ``engine_drift_events`` (the controller owns
        the plain ``drift_events`` name on the same ledger); ``rejected``
        (error-Response) requests were never served: they are surfaced as a
        counter, not as records — a NaN energy must not poison the fleet
        aggregates or count toward SLO attainment."""
        c = self._ledger_counter_delta()
        out = {"drift_events": c.get("engine_drift_events", 0),
               "preemptions": c.get("preemptions", 0),
               "admission_denials": c.get("admission_denials", 0),
               "rejected": c.get("rejected", 0)}
        out.update(self._robust_counters(c))
        # speculative decoding (only-when-nonzero, like the robustness set)
        out.update({k: c[k] for k in _SPEC_COUNTER_KEYS if c.get(k)})
        out.update(self._uncertainty_counters(c))
        return out

    def _run_serving(self, trace: Trace) -> Dict[str, int]:
        known = set(self.engine.workers) | set(self.graphs)
        _require_models(trace, known, "serving")
        if any(r.model not in self.engine.workers for r in trace):
            return self._run_serving_mixed(trace)
        arrivals = [(r.t_arrival_s, r.model, self._llm_request(trace, r))
                    for r in trace]
        self.responses = self.engine.run_trace(arrivals)
        return self._serving_counters()

    def _run_serving_mixed(self, trace: Trace) -> Dict[str, int]:
        """Mixed vision+LLM trace on one merged virtual timeline: LLM
        requests stream through the continuous engine, vision/AR frames run
        as one operator-graph inference each through the controller —
        both advance the same clock, so queueing couples across modalities
        the way co-execution does on a real device. Per outer iteration the
        highest-priority arrived frame executes, then one engine round
        serves the busy LLM workers."""
        eng, sim = self.engine, self.sim
        items = list(trace)  # time-sorted, uids in arrival order
        by_uid = {r.uid: r for r in trace}
        n_resident = len({r.model for r in trace})
        # joint planning: vision/AR frames plan against each other (and the
        # LLM co-runner, via n_resident > len(resident graphs))
        self._set_resident_graphs(trace)
        responses: List = []
        frames: List[Tuple] = []  # (-priority, t_arrival, uid) heap
        t = 0.0
        i = 0
        eng._vtime = 0.0
        try:
            while True:
                sim.advance_faults(t)
                while i < len(items) and items[i].t_arrival_s <= t + 1e-12:
                    r = items[i]
                    if r.model in eng.workers:
                        req = self._llm_request(trace, r)
                        req.t_submit = r.t_arrival_s
                        eng.queues[r.model].append(req)
                    else:
                        heapq.heappush(frames,
                                       (-r.priority, r.t_arrival_s, r.uid))
                    i += 1
                busy = [m for m in eng.workers if eng._busy(m)]
                if not frames and not busy:
                    if i >= len(items):
                        sim.set_coexec(1)
                        break
                    sim.advance_idle(items[i].t_arrival_s - t)
                    t = items[i].t_arrival_s
                    eng._vtime = t
                    continue
                if frames:
                    _, t_arr, uid = heapq.heappop(frames)
                    r = by_uid[uid]
                    sim.set_coexec(n_resident)
                    try:
                        lat, en, eb = self.controller.run_inference_rails(
                            self.graphs[r.model])
                    except FaultError as exc:
                        # unservable under the current fault state: an
                        # explicit rejected record, never a replay abort
                        sim.ledger.count("aborted")
                        sim.ledger.emit("rejected", 0.0, EnergyBreakdown(),
                                        t_s=t, model=r.model, uid=uid,
                                        meta={"reason": str(exc)})
                    else:
                        sim.drain(en)
                        t += lat
                        eng._vtime = t
                        # the frame's per-request event (the engine appends
                        # its own at retirement) — latency is completion -
                        # arrival
                        sim.ledger.emit("request", t - t_arr, eb, t_s=t_arr,
                                        model=r.model, uid=uid)
                    busy = [m for m in eng.workers if eng._busy(m)]
                if busy:
                    eng._serve_round(busy, responses)
                    t = eng._vtime
        finally:
            eng._vtime = None
            self.controller.set_resident(())
        self.responses = responses
        counters = self._serving_counters()
        c = self._ledger_counter_delta()
        counters["repartitions"] = c.get("repartitions", 0)
        counters["incremental"] = c.get("incremental", 0)
        counters["graph_drift_events"] = c.get("drift_events", 0)
        return counters


class FleetReplay:
    """Replay one scenario across a device population and aggregate."""

    def __init__(self, population: List[DeviceProfile],
                 scenario: str = "mixed", duration_s: float = 12.0,
                 seed: int = 0, calib_samples: int = 350,
                 use_gru: bool = False, backend: str = "graph",
                 graphs: Optional[Dict[str, OpGraph]] = None,
                 serving_models: Optional[Dict[str, tuple]] = None,
                 rate_scale: float = 1.0, max_slots: int = 4,
                 joint: bool = False, uncertainty: bool = False,
                 risk_level: Optional[float] = None, serving_ctx=None,
                 serving_drafts: Optional[Dict[str, tuple]] = None):
        self.population = population
        self.scenario = scenario
        self.duration_s = duration_s
        self.seed = seed
        self.calib_samples = calib_samples
        self.use_gru = use_gru
        self.backend = backend
        self.graphs = graphs
        self.serving_models = serving_models
        self.rate_scale = rate_scale
        self.max_slots = max_slots
        # contention-aware joint co-execution planning per device
        # (repro_torch.core.coexec); False keeps independent planning bit-identical
        self.joint = joint
        # per-device calibrated uncertainty + risk-aware admission
        # (repro_torch.uncertainty); False stays bit-identical to point estimates
        self.uncertainty = uncertainty
        self.risk_level = risk_level
        # shared ExecContext for every device's serving workers (sharded
        # fleet replays); None keeps the single-device default
        self.serving_ctx = serving_ctx
        # per-model speculative-decoding drafts for every device's engine
        self.serving_drafts = serving_drafts
        # each device's runtime (its engine, its responses) of the last run
        self.device_replays: List[DeviceReplay] = []

    def device_trace(self, idx: int) -> Trace:
        return make_trace(self.scenario, self.duration_s,
                          seed=self.seed + _DEVICE_SEED_STRIDE * idx,
                          rate_scale=self.rate_scale)

    def run(self) -> FleetReport:
        graphs = self.graphs if self.graphs is not None else default_graph_registry()
        devices: List[DeviceMetrics] = []
        all_latencies: List[float] = []
        self.device_replays = []
        for idx, profile in enumerate(self.population):
            trace = self.device_trace(idx)
            # fail before the expensive per-device calibration, for either
            # backend (DeviceReplay re-checks for direct callers); serving
            # resolves against workers AND graphs (vision frames route to
            # the graph path)
            _require_models(trace,
                            graphs if self.backend == "graph"
                            else set(self.serving_models or {}) | set(graphs),
                            self.backend)
            dr = DeviceReplay(profile, graphs,
                              calib_samples=self.calib_samples,
                              use_gru=self.use_gru, backend=self.backend,
                              serving_models=self.serving_models,
                              max_slots=self.max_slots, joint=self.joint,
                              uncertainty=self.uncertainty,
                              risk_level=self.risk_level,
                              serving_ctx=self.serving_ctx,
                              serving_drafts=self.serving_drafts)
            self.device_replays.append(dr)
            records, counters = dr.run(trace)
            devices.append(dr.metrics(records, counters))
            all_latencies.extend(r.latency_s for r in records)
        return FleetReport.build(self.scenario, self.seed, self.duration_s,
                                 self.backend, devices, all_latencies)
