"""Concurrent serving engine with AdaOper energy-aware scheduling — the
counterpart of ``repro.serving.engine.ServingEngine``.

Two serving modes: ``continuous`` (default, iteration-level scheduling,
below) and ``bucketed`` (the position-synchronous reference path,
``serving.bucketed``: ``step`` serves one equal-prompt-length batch of a
queue through ``ModelWorker.generate``; ``run_all`` repeats it until the
queues drain; it never speculates).

Several models share the engine. Each round (``_serve_round``) declares the
co-execution level to the device simulator, runs the drift check once,
preempts the lowest-priority decoding worker on a drift event, then steps
each busy model at token granularity (``step_continuous``): degradation
pass, energy-aware admission into the model's slot pool, batched prefill,
one decode round over the whole pool (a ragged single-token step, or a
speculative draft-verify round for a model registered with a draft),
retirement. ``run_all`` repeats rounds until every queue drains;
``run_trace`` replays timed arrivals on a virtual clock that advances by
the planner's predicted latencies. This module is orchestration only: the
machinery lives in ``slots``, ``sampling``, ``workers``, ``admission``,
``scheduler``, ``planning``, ``decoding``, ``speculative`` and
``robustness``.

With a scheduler (``AdaOperScheduler``) every energy number goes to the
simulator's :class:`~repro_torch.core.telemetry.EnergyLedger`: ``prefill``
and ``decode`` events per iteration, one ``request`` event per retirement,
split per rail by the plan's fractions. Those joules are the device
simulator's predictions for a mobile SoC (``core.simulator``), not the
energy the serving device draws. ``scheduler=None`` is FIFO admission with
an engine-private ledger of ``request`` events.

The uncertainty knobs keep the reference's inert defaults: ``risk_level``
prices admission and speculation at a quantile of the plans' calibrated
intervals (``AdmissionPolicy``), ``legacy_drift`` pins the fixed drift
hysteresis when the profiler carries an uncertainty model
(``planning.drift_event``), ``ssm_prompt_buckets`` lets pure-SSM stacks
admit pow2 prompt-length buckets (``admission.ssm_prompt_bucketed``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.telemetry import EnergyLedger
from repro_torch.serving import admission as adm
from repro_torch.serving import decoding, planning, robustness, sampling, speculative
from repro_torch.serving.admission import AdmissionPolicy
from repro_torch.serving.bucketed import step_bucketed
from repro_torch.serving.scheduler import AdaOperScheduler
from repro_torch.serving.slots import Request, Response, _ActiveSeq, _SlotPool
from repro_torch.serving.workers import ModelWorker
from repro_torch.sharding.context import ExecContext


class ServingEngine:
    """``mode="continuous"`` (default) serves at token granularity;
    ``mode="bucketed"`` keeps the position-synchronous reference path."""

    def __init__(self, scheduler: Optional[AdaOperScheduler] = None,
                 mode: str = "continuous", max_slots: int = 8,
                 slo_s: Optional[float] = None, sampling_seed: int = 0,
                 batch_prefill: bool = True, max_retries: int = 1,
                 deadline_backoff: float = 1.5, shed_below_priority: int = 1,
                 risk_level: Optional[float] = None,
                 legacy_drift: bool = False, ssm_prompt_buckets: bool = True):
        if mode not in ("continuous", "bucketed"):
            raise ValueError(f"unknown serving mode {mode!r}; choose from "
                             "('continuous', 'bucketed')")
        self.mode = mode
        self.workers: Dict[str, ModelWorker] = {}
        self.queues: Dict[str, List[Request]] = {}
        self.scheduler = scheduler
        self.stats: Dict[str, list] = {}
        self.max_slots = max_slots
        self.sampling_seed = sampling_seed
        # batched admission: one prefill per same-shape group; False = serial
        self.batch_prefill = batch_prefill
        self.prefill_batches = 0
        self.prefill_batch_requests = 0
        # telemetry spine: the simulator's ledger when a scheduler is attached
        self.ledger: EnergyLedger = (scheduler.sim.ledger if scheduler is not None
                                     else EnergyLedger())
        self.admission = AdmissionPolicy(scheduler, slo_s=slo_s, risk_level=risk_level)
        self.admission.ledger = self.ledger
        self.legacy_drift = legacy_drift
        self.ssm_prompt_buckets = ssm_prompt_buckets
        self.pools: Dict[str, _SlotPool] = {}
        # speculative decoding state per target model; empty unless
        # add_model was given a draft
        self.spec: Dict[str, speculative.SpecState] = {}
        self.priorities: Dict[str, int] = {}
        self.preemptions: Dict[str, int] = {}
        self.drift_events = 0
        # drift-scoped step-plan memo (see repro_torch.serving.planning)
        self._plan_memo: Dict = {}
        self._drift_ref = None
        # graceful degradation (repro_torch.serving.robustness): deadline
        # requeue with backoff then error Response; battery-critical shedding
        self.max_retries = max_retries
        self.deadline_backoff = deadline_backoff
        self.shed_below_priority = shed_below_priority
        # virtual clock for run_trace: None => wall time; a float advances
        # by predicted prefill/decode latencies
        self._vtime: Optional[float] = None

    def _now(self) -> float:
        return self._vtime if self._vtime is not None else time.time()

    def _advance_vtime(self, dt: float) -> None:
        """Advance the virtual clock (no-op in wall mode) and mirror it to
        the simulator so fault timestamps line up with the replay."""
        if self._vtime is not None:
            self._vtime += dt
            if self.scheduler is not None:
                self.scheduler.sim.now_s = self._vtime

    def _stream_key(self, model: str, uid) -> int:
        return sampling.stream_key(self.sampling_seed, model, uid)

    def _sample_batch(self, model: str, seqs: List[_ActiveSeq], logits,
                      temperature: float) -> List[int]:
        for seq in seqs:
            if seq.rng is None:
                seq.rng = self._stream_key(model, seq.req.uid)
        return sampling.sample_batch(seqs, logits, temperature)

    def _row_keys(self, model: str, reqs: List[Request]) -> List[int]:
        """The per-request streams of a bucketed batch, row by row."""
        return [self._stream_key(model, r.uid) for r in reqs]

    def add_model(self, name, cfg, params, max_len=512, ctx=ExecContext(),
                  priority: int = 0, max_enc_len: Optional[int] = None, draft=None,
                  spec=None):
        """``max_enc_len``: the encoder-decoder slot pool's cross-attention
        region per slot (``max_len`` by default). ``draft=(draft_cfg,
        draft_params)`` attaches a speculative-decoding draft worker to this
        model (``spec`` is an optional ``speculative.SpecConfig``); the
        default ``draft=None`` leaves every decode the plain step."""
        self.workers[name] = ModelWorker(name, cfg, params, max_len, ctx,
                                         max_enc_len=max_enc_len)
        self.queues[name] = []
        self.stats[name] = []
        self.priorities[name] = priority
        self.preemptions[name] = 0
        if draft is not None:
            self.spec[name] = speculative.attach_draft(self, name, draft, spec)

    def submit(self, model: str, req: Request):
        if req.t_submit == 0.0:
            req.t_submit = self._now()
        self.queues[model].append(req)

    def step(self, model: str, temperature: float = 0.0) -> List[Response]:
        """Serve one batch from ``model``'s queue (same-length bucket), the
        position-synchronous reference path (``serving.bucketed``)."""
        return step_bucketed(self, model, temperature)

    # drift-scoped plan memoisation lives in repro_torch.serving.planning

    def _plan_for(self, model: str, batch: int, seq_len: int, max_new: int):
        return planning.step_plan_for(self, model, batch, seq_len, max_new)

    def _prefill_plan_for(self, model: str, batch: int, prompt_len: int):
        return planning.prefill_plan_for(self, model, batch, prompt_len)

    def _drift_event(self) -> bool:
        return planning.drift_event(self)

    def _pool(self, model: str) -> _SlotPool:
        pool = self.pools.get(model)
        if pool is None:
            pool = self.pools[model] = _SlotPool(self.workers[model], self.max_slots)
        return pool

    def _busy(self, model: str) -> bool:
        return bool(self.queues[model]) or bool(
            model in self.pools and self.pools[model].active)

    def _plan_shape(self, pool: _SlotPool, extra: Optional[Request] = None):
        """(seq-length, remaining-tokens) envelope of the pool for planning."""
        seqs = [int(a.pos) for a in pool.active.values()]
        rems = [a.req.max_new_tokens - len(a.tokens) for a in pool.active.values()]
        if extra is not None:
            seqs.append(len(extra.prompt))
            rems.append(extra.max_new_tokens)
        return max(seqs, default=1), max(max(rems, default=1), 1)

    def _retire(self, pool: _SlotPool, seq: _ActiveSeq, out: List[Response]):
        pool.alloc.free(seq.slot)
        del pool.active[seq.slot]
        energy = seq.energy_j if self.scheduler is not None else float("nan")
        latency = self._now() - seq.req.t_submit
        self.ledger.emit("request", latency, seq.rails, t_s=seq.req.t_submit,
                         model=seq.model, uid=seq.req.uid)
        out.append(Response(seq.req.uid,
                            np.asarray(seq.tokens[: seq.req.max_new_tokens], np.int32),
                            latency, energy, rails=seq.rails))

    def step_continuous(self, model: str, decode: bool = True, check_drift: bool = True,
                        temperature: float = 0.0) -> List[Response]:
        """One engine iteration for ``model``: degradation pass, admission,
        one decode round over the slot pool, retirement.
        ``decode=False`` (a preempted worker) holds the pool's state — no
        admitted request is dropped; ``check_drift=False`` is for drivers
        that already ran the round's drift check."""
        if check_drift and self.scheduler is not None:
            self._drift_event()
        pool = self._pool(model)
        out: List[Response] = []
        robustness.expire_and_shed(self, model, pool, out)
        t0 = self._now()
        n_admitted = adm.admit_requests(self, model, pool, out, temperature)
        if decode and pool.active:
            decoding.decode_round(self, model, pool, out, temperature, t0)
        if n_admitted or pool.active or out:
            self.stats[model].append({
                "mode": "continuous", "active": len(pool.active),
                "admitted": n_admitted, "retired": len(out),
                "wall_s": self._now() - t0,
                "pred_energy_j": float(sum(r.energy_j_pred for r in out))
                if self.scheduler is not None else float("nan")})
        return out

    def _serve_round(self, busy: List[str], out: List[Response],
                     temperature: float = 0.0) -> None:
        """One continuous round over the busy models: declare the
        co-execution level, run the drift check once, preempt the
        lowest-priority decoding worker on a drift event, then step each
        model at token granularity."""
        if self.scheduler is not None:
            self.scheduler.sim.set_coexec(len(busy))
            # joint planning: the scheduler prices contention per resident
            # set; its plan caches key on residency, but the engine's memo
            # does not — clear it when the busy set moves under a coexec
            # planner (a no-op on the default independent path)
            if (self.scheduler.set_resident(busy)
                    and getattr(self.scheduler, "coexec", None) is not None):
                self._plan_memo.clear()
        victim = None
        if self.scheduler is not None and self._drift_event():
            decoding_models = [m for m in busy if m in self.pools and self.pools[m].active]
            if len(decoding_models) > 1:
                # the cached plans just got invalidated: yield the
                # lowest-priority worker's iteration to the higher-priority
                # pools while the planner re-solves
                victim = min(decoding_models, key=lambda m: (self.priorities[m], m))
                self.preemptions[victim] += 1
                self.ledger.count("preemptions")
        for m in busy:
            out.extend(self.step_continuous(m, decode=(m != victim), check_drift=False,
                                            temperature=temperature))

    def run_all(self, temperature: float = 0.0) -> List[Response]:
        """Rounds over the busy models until every queue drains (the paper's
        concurrent-DNN workload), interleaved at token granularity under the
        declared co-execution level; in bucketed mode, one ``step`` per
        model in turn."""
        if self.mode == "bucketed":
            out = []
            while any(self.queues.values()):
                for m in list(self.workers):
                    out.extend(self.step(m, temperature))
            return out
        out: List[Response] = []
        while True:
            busy = [m for m in self.workers if self._busy(m)]
            if not busy:
                if self.scheduler is not None:
                    self.scheduler.sim.set_coexec(1)
                break
            self._serve_round(busy, out, temperature)
        return out

    def run_trace(self, arrivals, start_t: float = 0.0,
                  temperature: float = 0.0) -> List[Response]:
        """Trace-driven serving in *virtual* time: ``arrivals`` is an
        iterable of ``(t_arrival_s, model_name, Request)`` (any order). The
        clock starts at ``start_t`` and advances by the planner's
        *predicted* prefill/decode latencies; idle gaps jump to the next
        arrival while the simulator relaxes and drains at the leakage floor.
        Latencies are deterministic simulated seconds measured from arrival
        (queueing included). Requires continuous mode and a scheduler."""
        if self.mode != "continuous" or self.scheduler is None:
            raise ValueError("run_trace requires mode='continuous' and a scheduler (the "
                             "virtual clock advances by predicted step latencies)")
        items = sorted(((float(t), m, r) for t, m, r in arrivals), key=lambda it: it[0])
        unknown = {m for _, m, _ in items} - set(self.workers)
        if unknown:
            raise ValueError(f"run_trace arrivals name models with no registered worker: "
                             f"{sorted(unknown)}")
        sim = self.scheduler.sim
        out: List[Response] = []
        self._vtime = float(start_t)
        i = 0
        try:
            while True:
                # fault/recovery boundaries scheduled up to now take effect
                # before this round (no-op without an attached injector)
                sim.advance_faults(self._vtime)
                while i < len(items) and items[i][0] <= self._vtime + 1e-12:
                    t_arr, model, req = items[i]
                    req.t_submit = t_arr
                    self.queues[model].append(req)
                    i += 1
                busy = [m for m in self.workers if self._busy(m)]
                if not busy:
                    if i >= len(items):
                        sim.set_coexec(1)
                        break
                    sim.advance_idle(items[i][0] - self._vtime)
                    self._vtime = items[i][0]
                    continue
                self._serve_round(busy, out, temperature)
        finally:
            self._vtime = None
        return out
