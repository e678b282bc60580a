"""Concurrent serving engine, continuous mode — the counterpart of
``repro.serving.engine.ServingEngine`` with ``scheduler=None``.

Several models share the engine. Each iteration (``step_continuous``)
admits waiting requests into a model's slot pool in FIFO order, prefills
them in same-length batches, runs one ragged decode step over the whole
pool and retires finished requests; ``run_all`` round-robins over the busy
models until every queue drains. This module is orchestration only: the
machinery lives in ``slots``, ``sampling``, ``workers``, ``admission``,
``decoding`` and ``robustness``. Every retirement appends a ``request``
event to the :class:`~repro_torch.core.telemetry.EnergyLedger`.

Not ported yet (each raises; see ROADMAP.md): the AdaOper scheduler,
``mode="bucketed"``, ``run_trace`` and speculative drafts.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.core.telemetry import EnergyLedger
from repro_torch.serving import admission as adm
from repro_torch.serving import decoding, robustness, sampling
from repro_torch.serving.admission import AdmissionPolicy
from repro_torch.serving.slots import Request, Response, _ActiveSeq, _SlotPool
from repro_torch.serving.workers import ModelWorker
from repro_torch.sharding.context import ExecContext


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet (see ROADMAP.md)")


class ServingEngine:
    def __init__(self, scheduler=None, mode: str = "continuous", max_slots: int = 8,
                 sampling_seed: int = 0, batch_prefill: bool = True, max_retries: int = 1,
                 deadline_backoff: float = 1.5):
        if scheduler is not None:
            raise _not_ported("the AdaOper scheduler")
        if mode != "continuous":
            raise _not_ported(f"serving mode {mode!r}")
        self.workers: Dict[str, ModelWorker] = {}
        self.queues: Dict[str, List[Request]] = {}
        self.stats: Dict[str, list] = {}
        self.max_slots = max_slots
        self.sampling_seed = sampling_seed
        self.batch_prefill = batch_prefill
        self.prefill_batches = 0
        self.prefill_batch_requests = 0
        self.ledger = EnergyLedger()
        self.admission = AdmissionPolicy()
        self.admission.ledger = self.ledger
        self.pools: Dict[str, _SlotPool] = {}
        self.max_retries = max_retries
        self.deadline_backoff = deadline_backoff

    def _now(self) -> float:
        return time.time()

    def _sample_batch(self, model: str, seqs: List[_ActiveSeq], logits,
                      temperature: float) -> List[int]:
        for seq in seqs:
            if seq.rng is None:
                seq.rng = sampling.stream_key(self.sampling_seed, model, seq.req.uid)
        return sampling.sample_batch(seqs, logits, temperature)

    def add_model(self, name, cfg, params, max_len=512, ctx=ExecContext(), draft=None):
        if draft is not None:
            raise _not_ported("speculative decoding")
        self.workers[name] = ModelWorker(name, cfg, params, max_len, ctx)
        self.queues[name] = []
        self.stats[name] = []

    def submit(self, model: str, req: Request):
        if req.t_submit == 0.0:
            req.t_submit = self._now()
        self.queues[model].append(req)

    def run_trace(self, arrivals, start_t: float = 0.0, temperature: float = 0.0):
        raise _not_ported("trace-driven serving (run_trace)")

    def _pool(self, model: str) -> _SlotPool:
        pool = self.pools.get(model)
        if pool is None:
            pool = self.pools[model] = _SlotPool(self.workers[model], self.max_slots)
        return pool

    def _busy(self, model: str) -> bool:
        return bool(self.queues[model]) or bool(
            model in self.pools and self.pools[model].active)

    def _retire(self, pool: _SlotPool, seq: _ActiveSeq, out: List[Response]):
        pool.alloc.free(seq.slot)
        del pool.active[seq.slot]
        latency = self._now() - seq.req.t_submit
        self.ledger.emit("request", latency, seq.rails, t_s=seq.req.t_submit,
                         model=seq.model, uid=seq.req.uid)
        out.append(Response(seq.req.uid,
                            np.asarray(seq.tokens[: seq.req.max_new_tokens], np.int32),
                            latency, float("nan"), rails=seq.rails))

    def step_continuous(self, model: str, temperature: float = 0.0) -> List[Response]:
        """One engine iteration for ``model``: deadline pass, admission, one
        ragged decode step over the slot pool, retirement."""
        pool = self._pool(model)
        out: List[Response] = []
        robustness.expire_deadlines(self, model, pool, out)
        t0 = self._now()
        n_admitted = adm.admit_requests(self, model, pool, out, temperature)
        if pool.active:
            decoding.plain_step(self, model, pool, out, temperature)
        if n_admitted or pool.active or out:
            self.stats[model].append({
                "mode": "continuous", "active": len(pool.active),
                "admitted": n_admitted, "retired": len(out),
                "wall_s": self._now() - t0, "pred_energy_j": float("nan")})
        return out

    def run_all(self, temperature: float = 0.0) -> List[Response]:
        """Round-robin across models, one continuous iteration each, until
        all queues drain."""
        out: List[Response] = []
        while True:
            busy = [m for m in self.workers if self._busy(m)]
            if not busy:
                break
            for m in busy:
                out.extend(self.step_continuous(m, temperature=temperature))
        return out
