"""Drift-scoped plan memoisation for the continuous engine: the counterpart
of ``repro.serving.planning``.

Iteration-level scheduling consults the planner every step, so steady-state
admission/accounting must cost dict lookups, not DP solves: step and
prefill plans are memoised on the engine between drift events, and a drift
event (device-state move past the hysteresis thresholds, or a profiler
correction-version bump) clears the memo — the scheduler's own caches key
on the new state, so subsequent queries replan automatically. Every
memoised plan goes through ``sharding.comm.shard_plan``, which returns it
unchanged while every context has ``model_parallel == 1``.

The lookups keep the reference's order byte for byte (memo first, the
scheduler — and its ``sim.observe()`` draw — only on a miss), so the port's
admission log and ledger match the JAX engine's. The speculative round is
priced here too (``spec_round_cost``, ``expected_tokens``) from the
target's step plan and the draft's own plans (``spec_plan_for``,
``draft_prefill_plan_for``), memoised beside the step plans so a drift
event invalidates them with everything else. With an uncertainty model on
the profiler the fixed hysteresis gives way to the interval-exit check
(``_interval_exit``).
"""
from __future__ import annotations

from repro_torch.sharding import comm

# hysteresis thresholds for drift events, sized ~4 sigma above the resource
# monitor's observation noise: genuine governor moves and background bursts
# trip them, per-observation flicker does not
DRIFT_CPU_F = 0.15
DRIFT_GPU_F = 0.06
DRIFT_BG = 0.12

# speculative verify cost model: scoring k extra positions in the target's
# verify forward is much cheaper in latency than k extra sequential steps
# (one weight pass amortised over k+1 positions), but each position still
# pays most of its energy (the operations happen however they are
# scheduled). verify(k) = base * (1 + MARGINAL * k) on each axis.
SPEC_VERIFY_MARGINAL_LAT = 0.2
SPEC_VERIFY_MARGINAL_EN = 0.55


def spec_round_cost(base_lat: float, base_en: float, draft_lat: float,
                    draft_en: float, k: int):
    """(latency, energy) of one speculative round: k sequential draft steps
    (catch-up + k-1 proposals) plus one k+1-position verify forward."""
    lat = k * draft_lat + base_lat * (1.0 + SPEC_VERIFY_MARGINAL_LAT * k)
    en = k * draft_en + base_en * (1.0 + SPEC_VERIFY_MARGINAL_EN * k)
    return lat, en


def expected_tokens(alpha: float, k: int) -> float:
    """Expected committed tokens per verify round under i.i.d. per-token
    acceptance rate ``alpha``: 1 (the bonus token) + sum_{i=1..k} alpha^i."""
    a = min(max(float(alpha), 0.0), 1.0)
    return 1.0 + sum(a ** i for i in range(1, int(k) + 1))


def spec_plan_for(eng, model: str, batch: int, seq_len: int, max_new: int):
    """The target's base decode-step plan plus the draft worker's own step
    plan, each from the drift-scoped memo, so a round's draft and verify
    charges carry their own rail fractions to the ledger."""
    base = step_plan_for(eng, model, batch, seq_len, max_new)
    sch = eng.scheduler
    key = ("spec", model, sch._new_bucket(batch), sch._len_bucket(seq_len),
           sch._new_bucket(max_new))
    draft = eng._plan_memo.get(key)
    if draft is None:
        dcfg = eng.spec[model].worker.cfg
        draft = sch.step_plan(dcfg, batch, seq_len, max_new)
        draft = comm.shard_plan(
            draft, comm.comm_term(dcfg, eng.workers[model].ctx, draft["batch"], 1),
            "step_energy", "step_latency")
        eng._plan_memo[key] = draft
    return {"base": base, "draft": draft}


def draft_prefill_plan_for(eng, model: str, batch: int, prompt_len: int):
    """Prefill plan for ``model``'s draft worker (its cache is warmed at
    admission, so verify rounds only catch up 1-2 tokens)."""
    sch = eng.scheduler
    key = ("dpre", model, sch._new_bucket(batch), sch._len_bucket(prompt_len))
    plan = eng._plan_memo.get(key)
    if plan is None:
        dcfg = eng.spec[model].worker.cfg
        plan = sch.prefill_plan(dcfg, batch, prompt_len)
        plan = comm.shard_plan(
            plan, comm.comm_term(dcfg, eng.workers[model].ctx, plan["batch"],
                                 sch._len_bucket(prompt_len)),
            "energy", "latency")
        eng._plan_memo[key] = plan
    return plan


def step_plan_for(eng, model: str, batch: int, seq_len: int, max_new: int):
    """Step plan served from the engine's drift-scoped memo."""
    sch = eng.scheduler
    key = (model, sch._new_bucket(batch), sch._len_bucket(seq_len),
           sch._new_bucket(max_new))
    plan = eng._plan_memo.get(key)
    if plan is None:
        w = eng.workers[model]
        plan = sch.step_plan(w.cfg, batch, seq_len, max_new)
        # one decode step moves (bucketed-batch, 1 token) of activations
        plan = comm.shard_plan(
            plan, comm.comm_term(w.cfg, w.ctx, plan["batch"], 1),
            "step_energy", "step_latency")
        eng._plan_memo[key] = plan
    return plan


def prefill_plan_for(eng, model: str, batch: int, prompt_len: int):
    """Admission (prefill) plan served from the drift-scoped memo; the
    batched admission path charges one bucketed-batch plan per group."""
    sch = eng.scheduler
    key = ("pre", model, sch._new_bucket(batch), sch._len_bucket(prompt_len))
    plan = eng._plan_memo.get(key)
    if plan is None:
        w = eng.workers[model]
        plan = sch.prefill_plan(w.cfg, batch, prompt_len)
        plan = comm.shard_plan(
            plan, comm.comm_term(w.cfg, w.ctx, plan["batch"],
                                 sch._len_bucket(prompt_len)),
            "energy", "latency")
        eng._plan_memo[key] = plan
    return plan


def _interval_exit(eng, obs) -> bool:
    """Re-price each memoised decode plan's alphas under the current
    observed state: the plan drifted when the fresh point prediction
    escapes the calibrated interval the plan was stamped with — a
    per-device, per-plan replacement for the fixed state hysteresis (wide
    intervals tolerate more state movement than confident ones)."""
    prof = eng.scheduler.profiler
    for plan in eng._plan_memo.values():
        iv, rc = plan.get("interval"), plan.get("recheck")
        if iv is None or rc is None:
            continue
        graph, alphas = rc
        _, en = prof.predict_graph(graph, alphas, obs)
        lo, hi = iv["energy"]
        if en < lo or en > hi:
            return True
    return False


def drift_event(eng) -> bool:
    """Compare the observed device state / profiler version / fault epoch
    against the last planning reference; on a drift event the step-plan
    memo is invalidated and the ledger's ``engine_drift_events`` counter
    bumps.

    With an uncertainty model attached to the profiler (and the engine not
    pinned to ``legacy_drift``), the fixed state hysteresis is replaced by
    the calibrated-interval check: a drift event fires when re-pricing a
    memoised plan under the current state escapes the interval it was
    stamped with (counted as ``interval_repartitions``), or on the usual
    correction-version / fault-epoch moves."""
    sch = eng.scheduler
    obs = sch.sim.observe()
    ver = sch.profiler.correction_version()
    epoch = getattr(sch.sim, "fault_epoch", 0)
    ref = eng._drift_ref
    eng._drift_ref = (obs, ver, epoch)
    if ref is None:
        return False
    robs, rver, repoch = ref
    interval_exit = False
    if sch.profiler.uncertainty is not None and not eng.legacy_drift:
        interval_exit = ver == rver and epoch == repoch and _interval_exit(eng, obs)
        event = ver != rver or epoch != repoch or interval_exit
    else:
        event = (ver != rver
                 or epoch != repoch
                 or abs(obs.cpu_f - robs.cpu_f) > DRIFT_CPU_F
                 or abs(obs.gpu_f - robs.gpu_f) > DRIFT_GPU_F
                 or abs(obs.cpu_bg - robs.cpu_bg) > DRIFT_BG
                 or abs(obs.gpu_bg - robs.gpu_bg) > DRIFT_BG)
    if event:
        eng.drift_events += 1
        eng.ledger.count("engine_drift_events")
        if interval_exit:
            eng.ledger.count("interval_repartitions")
        eng._plan_memo.clear()
    else:
        eng._drift_ref = ref  # keep the reference until a real move
    return event
