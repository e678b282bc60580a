"""Graceful degradation for the serving engine: per-request deadlines with
bounded requeue-and-backoff, and priority-aware load shedding under the
simulator's ``battery_critical`` — the counterpart of
``repro.serving.robustness``.

The invariant: every admitted request ends in a completion or an explicit
error ``Response``, and each rejection lands in the ledger (a ``rejected``
event plus its counter). All checks are inert on requests without
deadlines and devices that never go battery-critical.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.telemetry import EnergyBreakdown
from repro_torch.serving.slots import Request, Response, _SlotPool


def reject_request(eng, model: str, req: Request, reason: str,
                   out: List[Response]) -> None:
    """The one explicit-error exit: ledger ``rejected`` event + counter and
    an error ``Response``."""
    wait = eng._now() - req.t_submit
    eng.ledger.count("rejected")
    eng.ledger.emit("rejected", wait, EnergyBreakdown(), t_s=req.t_submit,
                    model=model, uid=req.uid, meta={"error": reason})
    out.append(Response(req.uid, np.zeros(0, np.int32), wait, float("nan"),
                        error=reason))


def _timeout(eng, model: str, req: Request,
             out: List[Response]) -> Optional[Request]:
    """A request blew its deadline: requeue with backoff while retries
    remain (returns the refreshed request), else a final deadline-miss
    error ``Response`` (returns None)."""
    if req.retries < eng.max_retries:
        req.retries += 1
        req.t_submit = eng._now()
        req.deadline_s = req.deadline_s * eng.deadline_backoff
        eng.ledger.count("deadline_requeues")
        return req
    eng.ledger.count("deadline_misses")
    reject_request(eng, model, req,
                   f"deadline exceeded after {req.retries} retries", out)
    return None


def expire_and_shed(eng, model: str, pool: _SlotPool,
                    out: List[Response]) -> None:
    """One degradation pass over ``model``'s queue and slot pool.

    1. ``battery_critical`` (the scheduler's simulated battery): shed queued
       requests below the engine's priority floor with explicit error
       responses (residents finish — their energy is already sunk).
    2. Deadlines, queued: expired waiters are requeued with backoff or
       errored out (``_timeout``).
    3. Deadlines, active: an expired resident is evicted (its slot freed,
       generated tokens discarded) and then requeued/errored like a waiter.
    """
    now = eng._now()
    q = eng.queues[model]
    sim = eng.scheduler.sim if eng.scheduler is not None else None
    if sim is not None and sim.battery_critical and q:
        keep: List[Request] = []
        for req in q:
            if req.priority < eng.shed_below_priority:
                eng.ledger.count("shed")
                reject_request(eng, model, req,
                               f"shed: battery critical (priority "
                               f"{req.priority} < {eng.shed_below_priority})", out)
            else:
                keep.append(req)
        q = eng.queues[model] = keep
    if not any(r.deadline_s is not None for r in q) and not pool.active:
        return
    keep = []
    for req in q:
        if req.deadline_s is not None and now - req.t_submit > req.deadline_s:
            req = _timeout(eng, model, req, out)
        if req is not None:
            keep.append(req)
    eng.queues[model] = keep
    for slot, seq in list(pool.active.items()):
        req = seq.req
        if req.deadline_s is not None and now - req.t_submit > req.deadline_s:
            pool.alloc.free(slot)
            del pool.active[slot]
            eng.ledger.count("deadline_evictions")
            req = _timeout(eng, model, req, out)
            if req is not None:
                eng.queues[model].append(req)
