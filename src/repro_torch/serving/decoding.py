"""The engine's per-iteration decode round over a model's slot pool — the
counterpart of ``repro.serving.decoding``. ``decode_round`` dispatches each
iteration: a model registered with a draft (``add_model(draft=...)``) tries
a speculative draft-verify round first (``serving.speculative``) and falls
back to ``plain_step`` when speculation is declined or not worth it, so
``draft=None`` runs exactly the plain step."""
from __future__ import annotations

from typing import List

from repro_torch.core.telemetry import EnergyBreakdown
from repro_torch.serving import speculative
from repro_torch.serving.slots import Response, _SlotPool


def decode_round(eng, model: str, pool: _SlotPool, out: List[Response],
                 temperature: float, t0: float) -> None:
    """One decode iteration for ``model``'s pool: a speculative round when a
    draft is attached and the policy approves, else the plain ragged step."""
    spec = eng.spec.get(model)
    if spec is not None and speculative.step_round(eng, model, pool, spec, out,
                                                   temperature, t0):
        return
    plain_step(eng, model, pool, out, temperature, t0)


def plain_step(eng, model: str, pool: _SlotPool, out: List[Response],
               temperature: float, t0: float) -> None:
    """One single-token ragged decode step over the whole slot pool, charged
    once per iteration when the engine has a scheduler: the simulator steps
    by the plan's latency and drains what the resident requests are charged
    (step_energy/batch each), one ``decode`` event goes to the ledger and a
    trace replay's virtual clock advances by the plan's latency."""
    w = eng.workers[model]
    enc_len = pool.enc_len if w.cfg.is_encoder_decoder else None
    next_tok, logits, pool.cache = w.decode_pool(pool.cache, pool.tokens, pool.pos,
                                                 enc_len=enc_len)
    n_active = len(pool.active)
    step_energy = 0.0
    if eng.scheduler is not None:
        seq_len, max_new = eng._plan_shape(pool)
        sp = eng._plan_for(model, n_active, seq_len, max_new)
        step_energy = sp["step_energy"]
        eng.scheduler.sim.step(sp["step_latency"])
        eng.scheduler.sim.drain(step_energy * n_active / sp["batch"])
        eng.ledger.emit(
            "decode", sp["step_latency"],
            EnergyBreakdown.from_total(step_energy * n_active / sp["batch"], sp["rails"]),
            t_s=t0, model=model, n_active=n_active)
        eng._advance_vtime(sp["step_latency"])
    seqs = list(pool.active.values())
    if temperature > 0.0:
        toks = w.slot_tokens(logits, [seq.slot for seq in seqs], pool.alloc.n_slots,
                             lambda rows, idx: eng._sample_batch(
                                 model, [seqs[i] for i in idx], rows, temperature))
    else:
        toks = [int(next_tok[seq.slot]) for seq in seqs]
    for seq, tok in zip(seqs, toks):
        seq.tokens.append(tok)
        seq.pos += 1
        if eng.scheduler is not None:
            # energy of the (bucketed-batch) step plan, shared per slot
            seq.rails += EnergyBreakdown.from_total(step_energy / sp["batch"], sp["rails"])
        pool.tokens[seq.slot, 0] = tok
        pool.pos[seq.slot] = seq.pos
        if len(seq.tokens) >= seq.req.max_new_tokens:
            eng._retire(pool, seq, out)
