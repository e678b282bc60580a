"""Energy-aware iteration-level admission and batched prefill — the
counterpart of ``repro.serving.admission``.

``AdmissionPolicy`` is the decision rule (the AdaOper objective applied at
token granularity); ``admit_requests`` / ``prefill_group`` are the engine's
admission machinery: pull waiting requests into free slots while the policy
approves, then prefill the approved set in bucketed same-shape batches.
They operate *on* a ``ServingEngine`` so the engine module stays pure
orchestration. ``AdmissionPolicy.spec_decision`` prices a speculative round
against the plain step it replaces, and ``prefill_group`` warms an
attached draft's cache beside the target's. With a ``risk_level`` both
price plans at a quantile of their calibrated intervals (the uncertainty
layer, ``repro_torch.uncertainty``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.telemetry import EnergyBreakdown
from repro_torch.serving import planning, speculative
from repro_torch.serving.robustness import reject_request
from repro_torch.serving.scheduler import AdaOperScheduler
from repro_torch.serving.slots import Request, Response, _ActiveSeq, _SlotPool
from repro_torch.serving.workers import ModelWorker

_len_bucket = AdaOperScheduler._len_bucket
_new_bucket = AdaOperScheduler._new_bucket


class AdmissionPolicy:
    """Energy-aware iteration-level admission: admit a waiting request into
    the slot pool only when the profiler/partitioner fast path predicts the
    per-request energy-delay product of a decode step does not worsen, and
    the added step latency does not push the pool past the SLO. A
    starvation guard admits regardless once the request's queueing delay
    exceeds the SLO, and an empty pool always admits (idle silicon costs
    leakage only). Without a scheduler every request a free slot can take
    is admitted (FIFO)."""

    def __init__(self, scheduler: Optional[AdaOperScheduler] = None,
                 slo_s: Optional[float] = None, edp_slack: float = 1.05,
                 risk_level: Optional[float] = None):
        self.scheduler = scheduler
        self.slo_s = slo_s
        self.edp_slack = edp_slack
        # risk-aware admission: 0..1 position between the point prediction
        # and the calibrated upper interval bound at which latency/energy
        # are priced. None (default) keeps the point-estimate arithmetic;
        # plans without a stamped interval fall back to the point value too
        self.risk_level = risk_level
        self.log: List[dict] = []
        # speculation pricing decisions, kept apart from the admission log
        # so denial counts stay request-scoped
        self.spec_log: List[dict] = []
        # engine-attached ledger: denials are counted at the source
        self.ledger = None

    def _risk(self, plan: dict, which: str) -> float:
        """Latency ("latency") or energy ("energy") of one decode step at
        the configured risk level."""
        point = plan["step_latency" if which == "latency" else "step_energy"]
        if self.risk_level is None:
            return point
        iv = plan.get("interval")
        if iv is None:
            return point
        return point + self.risk_level * (iv[which][1] - point)

    def decide(self, cfg, n_active: int, seq_len: int, max_new: int,
               wait_s: float, plan_fn=None) -> Tuple[bool, str]:
        """``plan_fn(batch)`` overrides the plan source (the engine passes
        its drift-scoped memo so steady-state decisions cost dict lookups)."""
        if self.scheduler is None:
            return True, "no-scheduler"
        if n_active == 0:
            return True, "idle-pool"
        if self.slo_s is not None and wait_s > self.slo_s:
            return True, "slo-starvation"
        if plan_fn is None:
            plan_fn = lambda b: self.scheduler.step_plan(cfg, b, seq_len, max_new)  # noqa: E731
        cur = plan_fn(n_active)
        new = plan_fn(n_active + 1)
        # per-request EDP of one decode step: latency is shared by the actual
        # batch, energy scales ~linearly with the plan's (bucketed) batch.
        # With a risk level set, both sides are priced at the same upper
        # quantile; the SLO check prices the risk-adjusted latency, so a
        # wide (uncertain) interval admits more conservatively
        edp_cur = ((self._risk(cur, "latency") / n_active)
                   * (self._risk(cur, "energy") / cur["batch"]))
        edp_new = ((self._risk(new, "latency") / (n_active + 1))
                   * (self._risk(new, "energy") / new["batch"]))
        if self.slo_s is not None and self._risk(new, "latency") * max_new > self.slo_s:
            return False, "slo-violation"
        if edp_new <= edp_cur * self.edp_slack:
            return True, "edp-improves"
        return False, "edp-worsens"

    def _record(self, admit: bool, reason: str, n_active: int, uid) -> None:
        self.log.append({"admit": admit, "reason": reason,
                         "n_active": n_active, "uid": uid})
        if self.ledger is not None and not admit:
            self.ledger.count("admission_denials")

    def spec_decision(self, base: dict, draft: dict, k: int,
                      alpha: float) -> Tuple[bool, str]:
        """Price one speculative round against the plain step it replaces:
        speculate only when the per-token EDP of the round (k draft steps +
        one k+1-position verify, divided by the expected committed tokens)
        beats the base step's per-token EDP. Verify latency amortises across
        positions but verify energy does not
        (``planning.SPEC_VERIFY_MARGINAL_*``), so a latency win can still
        lose on EDP; those rounds fall back to the plain step. Both sides
        are priced at the configured ``risk_level`` quantile, as admission
        prices them."""
        if self.scheduler is None:
            return True, "no-scheduler"
        lat_b, en_b = self._risk(base, "latency"), self._risk(base, "energy")
        lat_s, en_s = planning.spec_round_cost(lat_b, en_b, self._risk(draft, "latency"),
                                               self._risk(draft, "energy"), k)
        tau = planning.expected_tokens(alpha, k)
        edp_spec = (lat_s / tau) * (en_s / (tau * base["batch"]))
        edp_base = lat_b * (en_b / base["batch"])
        if edp_spec <= edp_base * self.edp_slack:
            return True, "spec-edp-wins"
        return False, "spec-edp-loses"


def ssm_prompt_bucketed(eng, w: ModelWorker) -> bool:
    """True when ``w``'s admission groups key on the pow2 prompt-length
    bucket instead of the exact length: pure-SSM stacks with batched
    prefill (no encoder) under ``eng.ssm_prompt_buckets`` — the pad-safe
    scan makes a LEFT-padded, masked bucket prefill match an exact-length
    prefill, so mixed-length admissions share one prefill. Attention stacks
    keep exact-length grouping (padding would corrupt their KV caches)."""
    if (not eng.ssm_prompt_buckets or not eng.batch_prefill
            or w.cfg.is_encoder_decoder):
        return False
    kinds = w.cfg.layer_kinds()
    return bool(kinds) and all(k in ("mamba", "ssd") for k in kinds)


def validate_request(w: ModelWorker, req: Request) -> Optional[str]:
    """Reason the request can never be served by ``w``, or None."""
    if len(req.prompt) + req.max_new_tokens > w.max_len:
        return (f"prompt {len(req.prompt)} + max_new "
                f"{req.max_new_tokens} exceeds max_len {w.max_len}")
    if w.cfg.is_encoder_decoder:
        if req.enc_inputs is None:
            return "encoder-decoder request without enc_inputs"
        if req.enc_inputs.shape[0] > w.max_enc_len:
            return (f"enc_inputs length {req.enc_inputs.shape[0]} "
                    f"exceeds max_enc_len {w.max_enc_len}")
    return None


def admit_requests(eng, model: str, pool: _SlotPool, out: List[Response],
                   temperature: float = 0.0) -> int:
    """Pull waiting requests into free slots while the policy approves,
    then prefill the admitted set in same-shape batches, keyed on the
    prompt length and the encoder input's shape (``batch_prefill=False``
    keeps the serial batch-1 reference). A request that can never be
    served (oversized, missing encoder inputs) is rejected with an error
    ``Response`` and the loop keeps draining. Returns #admitted."""
    w, q = eng.workers[model], eng.queues[model]
    admitted: List[_ActiveSeq] = []
    while q and pool.alloc.n_free:
        req = q[0]
        err = validate_request(w, req)
        if err is not None:
            q.pop(0)
            eng.admission._record(False, f"invalid: {err}", len(pool.active), req.uid)
            reject_request(eng, model, req, err, out)
            continue
        seq_len, max_new = eng._plan_shape(pool, extra=req)
        plan_fn = (None if eng.scheduler is None else
                   (lambda b: eng._plan_for(model, b, seq_len, max_new)))
        admit, reason = eng.admission.decide(
            w.cfg, len(pool.active), seq_len, max_new,
            eng._now() - req.t_submit, plan_fn=plan_fn)
        eng.admission._record(admit, reason, len(pool.active), req.uid)
        if not admit:
            break
        q.pop(0)
        slot = pool.alloc.alloc()
        seq = _ActiveSeq(req, slot, pos=len(req.prompt), model=model)
        # resident immediately so the next decision's plan shape sees it
        pool.active[slot] = seq
        admitted.append(seq)
    if eng.batch_prefill:
        bucketed = ssm_prompt_bucketed(eng, w)
        groups: Dict[tuple, List[_ActiveSeq]] = {}
        for seq in admitted:
            plen, enc = len(seq.req.prompt), seq.req.enc_inputs
            key = (_len_bucket(plen) if bucketed else plen, None if enc is None else enc.shape)
            groups.setdefault(key, []).append(seq)
        group_list = list(groups.values())
    else:
        group_list = [[seq] for seq in admitted]
    for group in group_list:
        prefill_group(eng, model, pool, group, out, temperature)
    return len(admitted)


def _left_padded(group: List[_ActiveSeq], length: int, pad_rows: int):
    """(prompts, mask) (G + pad_rows, length): each prompt LEFT-padded to
    ``length`` with a validity mask; the pad rows repeat the first row."""
    G = len(group)
    prompts = np.zeros((G, length), np.int32)
    mask = np.zeros((G, length), bool)
    for i, s in enumerate(group):
        n = len(s.req.prompt)
        prompts[i, length - n:] = s.req.prompt
        mask[i, length - n:] = True
    return (np.concatenate([prompts, prompts[:1].repeat(pad_rows, 0)]),
            np.concatenate([mask, mask[:1].repeat(pad_rows, 0)]))


def prefill_group(eng, model: str, pool: _SlotPool,
                  group: List[_ActiveSeq], out: List[Response],
                  temperature: float) -> None:
    """One prefill for a same-shape group of admitted requests: the batch
    is padded to a pow2 bucket (padding rows repeat the first prompt), the
    resulting caches scatter into the slots in one ``write_slots`` call
    (padding rows carry slot ``n_slots`` and are dropped), and with a
    scheduler the admission plan is charged once per bucket — per-request
    energy normalised by the plan's bucketed batch, the simulated battery
    drained, one ``prefill`` event appended to the ledger.

    Pure-SSM groups share a pow2 prompt-length bucket: every prompt is
    LEFT-padded to it with a mask (the pad-safe scan leaves masked
    positions out of the state), and per-slot positions stay the true
    prompt lengths."""
    w = eng.workers[model]
    G = len(group)
    b = _new_bucket(G)
    lens = [len(s.req.prompt) for s in group]
    plan_len = lens[0]
    pad_mask = None
    if ssm_prompt_bucketed(eng, w):
        plan_len = _len_bucket(max(lens))
        if any(n != plan_len for n in lens):
            prompts, pad_mask = _left_padded(group, plan_len, b - G)
    enc = None
    if pad_mask is None:
        prompts = np.stack([s.req.prompt for s in group] + [group[0].req.prompt] * (b - G))
        if group[0].req.enc_inputs is not None:
            enc = np.stack([s.req.enc_inputs for s in group]
                           + [group[0].req.enc_inputs] * (b - G))
    slots = np.full(b, pool.alloc.n_slots, np.int32)
    slots[:G] = [s.slot for s in group]
    logits, g_cache = w.prefill_batch(prompts, enc, pad_mask=pad_mask, slots=slots,
                                      n_slots=pool.alloc.n_slots)
    pool.cache = w.write_slots(pool.cache, g_cache, slots)
    if temperature > 0.0:
        def pick(rows, idx):
            return eng._sample_batch(model, [group[i] for i in idx], rows, temperature)
    else:
        def pick(rows, idx):
            return [int(t) for t in rows.argmax(dim=-1).cpu().numpy()]
    toks = w.group_tokens(logits, slots[:G], pool.alloc.n_slots, pick)
    pp = None
    if eng.scheduler is not None:
        # bucketed SSM groups charge the bucket-length plan (the same pow2
        # length bucket the planner keys on)
        pp = eng._prefill_plan_for(model, G, plan_len)
        charge = EnergyBreakdown.from_total(pp["energy"] * G / pp["batch"], pp["rails"])
        eng.scheduler.sim.drain(pp["energy"] * G / pp["batch"])
        eng.ledger.emit("prefill", pp["latency"], charge, t_s=eng._now(), model=model,
                        n_active=G)
        eng._advance_vtime(pp["latency"])
    spec = eng.spec.get(model)
    if spec is not None:
        # warm the draft cache for the admitted group (same prompts, the
        # draft's own params) so verify rounds only catch up 1-2 tokens
        speculative.prefill_draft(eng, model, spec, group, prompts, slots, G, plan_len)
    for seq, tok in zip(group, toks):
        seq.tokens.append(tok)
        if pp is not None:
            seq.rails += EnergyBreakdown.from_total(pp["energy"] / pp["batch"], pp["rails"])
        pool.tokens[seq.slot, 0] = tok
        pool.pos[seq.slot] = seq.pos
        pool.enc_len[seq.slot] = (0 if seq.req.enc_inputs is None
                                  else seq.req.enc_inputs.shape[0])
        if len(seq.tokens) >= seq.req.max_new_tokens:
            eng._retire(pool, seq, out)
    eng.prefill_batches += 1
    eng.prefill_batch_requests += G
