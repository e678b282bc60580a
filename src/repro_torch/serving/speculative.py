"""Energy-aware draft-verify speculative decoding on the slot pool — the
counterpart of ``repro.serving.speculative``.

A small draft worker proposes k tokens per slot; the target scores all k
(plus the pending token) in ONE multi-position ragged forward
(``ModelWorker.decode_verify``, through the flash kernel) and commits the
longest prefix the target itself would have produced. Greedy speculative
decode is therefore the target's own greedy decode, and sampled decode
replays the per-request streams: token i's draw depends only on (stream, i),
never on whether it came alone or inside an accepted run
(``sampling.sample_grid``). On the card the verify (flash kernel) and the
plain step (decode kernel) round differently, so in bf16 the two agree up
to near-ties of the logits.

Rollback is free: rejected suffixes leave stale K/V past each slot's
committed frontier, which causal masking hides until the next round
overwrites them (``models.attention.gqa_decode``). The draft keeps its own
slot-pool cache, warmed at admission (``prefill_draft``) and caught up 1-2
tokens per round through the same primitives.

Every round charges k draft steps and one verify forward to the ledger
separately (``spec_draft`` / ``spec_verify`` events, each with its own
plan's rail fractions), ``AdmissionPolicy.spec_decision`` declines
speculation when its energy premium beats the latency win on per-token EDP
(``spec_fallbacks``), and k adapts per slot from a windowed acceptance-rate
estimate. ``draft=None`` (the default everywhere) never reaches this module.

On a data group of D > 1 the draft worker takes the target's context, so
its pool is cut as the target's is (``serving.workers``). On a row-split
pool each rank drafts, verifies and accepts for the slots it holds, and
every slot's accepted count and committed tokens are all-gathered, so every
rank updates every sequence alike and takes the same k from the same
acceptance history: k is a joint decision. On a sequence-cut pool every
rank runs every slot.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.telemetry import EnergyBreakdown
from repro_torch.models.model import CausalLM
from repro_torch.models.transformer import ATTN_KINDS
from repro_torch.serving import planning, sampling
from repro_torch.serving.slots import _ActiveSeq
from repro_torch.serving.workers import ModelWorker


@dataclass(frozen=True)
class SpecConfig:
    """Per-target speculation knobs (``ServingEngine.add_model(spec=...)``)."""
    k_max: int = 4           # most drafts offered per slot per round
    window: int = 8          # acceptance-history window behind adaptive k
    alpha0: float = 0.75     # optimistic prior acceptance rate
    prior_weight: float = 2.0  # pseudo-observations backing the prior


class SpecState:
    """Draft-side state attached to one target model: the draft worker and
    its own slot-pool cache (one row per target slot, same max_len)."""

    def __init__(self, worker: ModelWorker, knobs: SpecConfig):
        self.worker = worker
        self.knobs = knobs
        self.cache = None

    def pool_cache(self, max_slots: int):
        if self.cache is None:
            self.cache = self.worker.init_pool(max_slots)
        return self.cache


def validate_draft(target: ModelWorker, draft_cfg) -> None:
    """Speculation needs a rollback-free multi-position decode on BOTH
    models: pure-attention decoder-only stacks (stale KV past the frontier
    is causally masked; SSM state advances irreversibly), plus a shared
    vocab so draft proposals index the target's distribution."""
    for role, cfg in (("target", target.cfg), ("draft", draft_cfg)):
        if cfg.is_encoder_decoder:
            raise ValueError(
                f"speculative decode: {role} model {cfg.name!r} is "
                "encoder-decoder; only decoder-only stacks are supported")
        bad = [k for k in cfg.layer_kinds() if k not in ATTN_KINDS]
        if bad:
            raise ValueError(
                f"speculative decode: {role} model {cfg.name!r} has "
                f"non-attention mixers {sorted(set(bad))}; SSM state cannot "
                "roll back a rejected suffix")
    if draft_cfg.vocab_size != target.cfg.vocab_size:
        raise ValueError(
            f"speculative decode: draft vocab {draft_cfg.vocab_size} != "
            f"target vocab {target.cfg.vocab_size}")


def attach_draft(eng, model: str, draft: Tuple, knobs: Optional[SpecConfig]) -> SpecState:
    """Build the draft worker for ``model`` (same max_len and ExecContext as
    the target, so slot rows line up)."""
    draft_cfg, draft_params = draft
    target = eng.workers[model]
    validate_draft(target, draft_cfg)
    worker = ModelWorker(f"{model}::draft", draft_cfg, draft_params,
                         max_len=target.max_len, ctx=target.ctx)
    return SpecState(worker, knobs or SpecConfig())


def _model_from(cfg, tensors) -> CausalLM:
    """A ``CausalLM`` for ``cfg`` whose parameters are ``tensors[name]``
    (shared, not copied)."""
    model = CausalLM(cfg, device="meta")
    for name, _ in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(tensors[name], requires_grad=False))
    return model


def truncated_draft(cfg, params: CausalLM):
    """Exact-acceptance draft construction for benches and tests: the draft
    is the target's FIRST layer (shared embedding, head and final norm) and
    the returned target is a copy of ``params`` whose later layers have
    their output projections (``wo``, ``w_down``, an MoE layer's experts
    and shared experts included) zeroed, so residual
    passthrough makes the target's logits the draft's (acceptance 1.0 up to
    the rounding of the two attention kernels) while the scheduler still
    prices the full-depth target. Every other tensor is shared with
    ``params``, which is not changed. Returns (draft_cfg, draft_params,
    target_params)."""
    draft_cfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft1", num_layers=1)
    src = dict(params.named_parameters())

    def zeroed(name: str) -> bool:
        # an nn.Linear's "....wo.weight", or an MoE layer's stacked experts
        # "....mlp.w_down" (its shared experts' "....shared.w_down.weight")
        parts = name.split(".")
        return (parts[0] == "layers" and int(parts[1]) >= 1
                and bool({"wo", "w_down"} & set(parts[-2:])))

    target = _model_from(cfg, {n: torch.zeros_like(t) if zeroed(n) else t
                               for n, t in src.items()})
    return draft_cfg, _model_from(draft_cfg, src), target


# ---------------------------------------------------------------------------
# the per-round machinery
# ---------------------------------------------------------------------------


def _alpha_hat(seq: _ActiveSeq, knobs: SpecConfig) -> float:
    """Windowed acceptance-rate estimate with an optimistic prior (new
    sequences speculate until the evidence says otherwise)."""
    acc = sum(a for a, _ in seq.spec_hist)
    off = sum(o for _, o in seq.spec_hist)
    return (knobs.alpha0 * knobs.prior_weight + acc) / (knobs.prior_weight + off)


def _choose_k(alpha: float, lat_ratio: float, k_max: int) -> int:
    """k maximising expected committed tokens per unit round latency
    (relative units: draft step = ``lat_ratio`` base steps, verify =
    1 + MARGINAL*k base steps)."""
    best_k, best = 0, 1.0  # k=0 == the plain step: 1 token / 1 base latency
    for k in range(1, k_max + 1):
        lat = k * lat_ratio + 1.0 + planning.SPEC_VERIFY_MARGINAL_LAT * k
        score = planning.expected_tokens(alpha, k) / lat
        if score > best:
            best_k, best = k, score
    return best_k


def prefill_draft(eng, model: str, spec: SpecState, group: List[_ActiveSeq],
                  prompts: np.ndarray, slots: np.ndarray, G: int, plan_len: int) -> None:
    """Warm the draft cache for an admitted group (called from
    ``admission.prefill_group`` after the target prefill): one batched draft
    prefill scattered into the draft pool's rows, charged as a
    ``spec_draft`` event with the draft prefill plan's rails."""
    cache = spec.pool_cache(eng.max_slots)
    _, g_cache = spec.worker.prefill_batch(prompts, slots=slots, n_slots=eng.max_slots)
    spec.cache = spec.worker.write_slots(cache, g_cache, slots)
    for seq in group:
        seq.draft_pos = len(seq.req.prompt)
        seq.spec_hist = []
    if eng.scheduler is None:
        return
    dpp = planning.draft_prefill_plan_for(eng, model, G, plan_len)
    share = dpp["energy"] / dpp["batch"]
    eng.scheduler.sim.drain(share * G)
    eng.ledger.emit("spec_draft", dpp["latency"],
                    EnergyBreakdown.from_total(share * G, dpp["rails"]),
                    t_s=eng._now(), model=model, n_active=G)
    eng._advance_vtime(dpp["latency"])
    for seq in group:
        seq.rails += EnergyBreakdown.from_total(share, dpp["rails"])


def step_round(eng, model: str, pool, spec: SpecState, out: List,
               temperature: float, t0: float) -> bool:
    """One speculative round over ``model``'s pool. Returns False when the
    round should fall back to the plain single-token step (nothing worth
    speculating, or ``spec_decision`` priced the energy premium above the
    latency win — the latter counts ``spec_fallbacks``)."""
    w = eng.workers[model]
    knobs = spec.knobs
    seqs = list(pool.active.values())
    n_active = len(seqs)
    # ---- pick k: per-slot adaptive (windowed acceptance), bounded by the
    # remaining-token budget so a round never overshoots max_new ----
    base = draft = None
    if eng.scheduler is not None:
        seq_len, max_new = eng._plan_shape(pool)
        plans = planning.spec_plan_for(eng, model, n_active, seq_len, max_new)
        base, draft = plans["base"], plans["draft"]
        lat_ratio = draft["step_latency"] / max(base["step_latency"], 1e-12)
    else:
        lat_ratio = (spec.worker.cfg.active_param_count()
                     / max(w.cfg.active_param_count(), 1))
    alphas = [_alpha_hat(s, knobs) for s in seqs]
    rems = [s.req.max_new_tokens - len(s.tokens) - 1 for s in seqs]
    k = max(min(_choose_k(al, lat_ratio, knobs.k_max), r) for al, r in zip(alphas, rems))
    if eng.scheduler is None and k == 0 and max(rems) > 0:
        # no energy model to price the round against: a draft attached to a
        # scheduler-less engine always speculates (the param-count ratio
        # stand-in for lat_ratio over-prices small-config drafts, whose
        # embeddings dominate); adaptive k still widens with acceptance
        k = 1
    if k <= 0:
        return False  # every slot is on its last token: plain step
    # acceptance cap: the remaining-token budget only — a slot whose
    # adaptive k_i < k still accepts up to k (the extra drafts are free
    # once the round's verify width is set by the most optimistic slot)
    caps = [min(k, r) for r in rems]
    if eng.scheduler is not None:
        ok, reason = eng.admission.spec_decision(base, draft, k, sum(alphas) / n_active)
        eng.admission.spec_log.append(
            {"speculate": ok, "reason": reason, "n_active": n_active, "k": k})
        if not ok:
            eng.ledger.count("spec_fallbacks")
            return False
    if temperature > 0.0:
        for seq in seqs:
            if seq.rng is None:
                seq.rng = eng._stream_key(model, seq.req.uid)
    # the slots this rank holds (every slot but on a row-split pool at D > 1),
    # as indices of ``seqs`` and as rows of the rank's logits
    lo, n_rows = w.pool_rows(eng.max_slots)
    mine = [i for i, s in enumerate(seqs) if lo <= s.slot < lo + n_rows]
    slot_rows = [seqs[i].slot - lo for i in mine]
    # ---- draft catch-up: feed each slot the committed tokens its cache has
    # not consumed (1 normally; 2 after a fully-accepted round; more only
    # after plain-step fallbacks), left-aligned at per-slot draft_pos ----
    dcache = spec.pool_cache(eng.max_slots)
    chunks = []
    for s in seqs:
        full = s.req.prompt.tolist() + s.tokens
        chunks.append(full[s.draft_pos: s.pos + 1])
    Tc = max(len(c) for c in chunks)
    tok_c = np.zeros((eng.max_slots, Tc), np.int32)
    pos_c = np.zeros(eng.max_slots, np.int32)
    for s, c in zip(seqs, chunks):
        tok_c[s.slot, : len(c)] = c
        pos_c[s.slot] = s.draft_pos
    if Tc == 1:
        _, logits_c, dcache = spec.worker.decode_pool(dcache, tok_c, pos_c)
        logits_c = logits_c[:, None]  # (max_slots, 1, V)
    else:
        _, logits_c, dcache = spec.worker.decode_verify(dcache, tok_c, pos_c)
    head = logits_c[slot_rows, [len(chunks[i]) - 1 for i in mine]]  # (len(mine), V)
    # ---- k draft proposals: d_1 from the catch-up logits, then k-1 more
    # single-token draft steps; sampled mode draws with the TARGET's stream
    # keys (d_j tries to match s_{j-1} = draw #(g+j-1)), so a draft whose
    # logits match the target's is accepted with probability 1 ----
    g0 = [len(s.tokens) for s in seqs]
    d = np.zeros((n_active, k), np.int32)

    def _draw(rows, j):
        if temperature <= 0.0 or not mine:
            return rows.argmax(dim=-1).to(torch.int32).cpu().numpy()
        return sampling._sample_rows([seqs[i].rng for i in mine], [g0[i] + j for i in mine],
                                     rows, temperature)

    d[mine, 0] = _draw(head, 0)
    dpos = np.zeros(eng.max_slots, np.int32)
    cur = np.zeros((eng.max_slots, 1), np.int32)
    for i, (s, c) in enumerate(zip(seqs, chunks)):
        dpos[s.slot] = s.draft_pos + len(c)
        cur[s.slot, 0] = d[i, 0]
    for j in range(1, k):
        _, dl, dcache = spec.worker.decode_pool(dcache, cur, dpos)
        d[mine, j] = _draw(dl[slot_rows], j)
        for i, s in enumerate(seqs):
            cur[s.slot, 0] = d[i, j]
        dpos += 1
    spec.cache = dcache
    # ---- one multi-position target verify: [t_pending, d_1..d_k] ----
    vt = np.zeros((eng.max_slots, k + 1), np.int32)
    for i, s in enumerate(seqs):
        vt[s.slot, 0] = pool.tokens[s.slot, 0]
        vt[s.slot, 1:] = d[i]
    greedy_v, logits_v, pool.cache = w.decode_verify(pool.cache, vt, pool.pos)
    if temperature > 0.0 and mine:
        s_tok = sampling.sample_grid([seqs[i] for i in mine], logits_v[slot_rows], temperature)
    else:
        s_tok = greedy_v[slot_rows]
    # ---- per-slot acceptance of this rank's slots: the longest matching
    # prefix, then the bonus; every slot's (accepted, committed tokens)
    # all-gathered where the ranks hold other slots ----
    caps_mine = [caps[i] for i in mine]
    accepted = np.zeros((len(mine), k + 2), np.int64)
    for r, (i, cap) in enumerate(zip(mine, caps_mine)):
        a = 0
        while a < cap and d[i, a] == s_tok[r, a]:
            a += 1
        accepted[r, 0] = a
        accepted[r, 1:a + 2] = s_tok[r, : a + 1]
    if w.rows_split:  # every rank gathers, whether or not it holds a slot
        accepted = w.gather_rows(mine, accepted, n_active, k + 2)
    # ---- accounting: k draft steps + one verify, charged per rail ----
    if eng.scheduler is not None:
        b = base["batch"]
        d_lat, d_en = k * draft["step_latency"], k * draft["step_energy"]
        v_lat = base["step_latency"] * (1.0 + planning.SPEC_VERIFY_MARGINAL_LAT * k)
        v_en = base["step_energy"] * (1.0 + planning.SPEC_VERIFY_MARGINAL_EN * k)
        eng.scheduler.sim.step(d_lat + v_lat)
        eng.scheduler.sim.drain((d_en + v_en) * n_active / b)
        eng.ledger.emit("spec_draft", d_lat,
                        EnergyBreakdown.from_total(d_en * n_active / b, draft["rails"]),
                        t_s=t0, model=model, n_active=n_active)
        eng.ledger.emit("spec_verify", v_lat,
                        EnergyBreakdown.from_total(v_en * n_active / b, base["rails"]),
                        t_s=t0, model=model, n_active=n_active)
        eng._advance_vtime(d_lat + v_lat)
    n_drafted = n_accepted = 0
    for i, (seq, cap) in enumerate(zip(seqs, caps)):
        a = int(accepted[i, 0])
        commit = [int(t) for t in accepted[i, 1:a + 2]]
        n_drafted += cap
        n_accepted += a
        if cap > 0:
            seq.spec_hist.append((a, cap))
            del seq.spec_hist[: -knobs.window]
        seq.tokens.extend(commit)
        seq.pos += a + 1
        # draft frontier: the catch-up chunk plus proposals d_1..d_{k-1}
        # were consumed; entries past the accepted prefix are stale (masked
        # until the next catch-up overwrites them)
        seq.draft_pos = min(seq.draft_pos + len(chunks[i]) + (k - 1), seq.pos)
        if eng.scheduler is not None:
            seq.rails += EnergyBreakdown.from_total(d_en / b, draft["rails"])
            seq.rails += EnergyBreakdown.from_total(v_en / b, base["rails"])
        pool.tokens[seq.slot, 0] = commit[-1]
        pool.pos[seq.slot] = seq.pos
        if len(seq.tokens) >= seq.req.max_new_tokens:
            eng._retire(pool, seq, out)
    eng.ledger.count("spec_rounds")
    eng.ledger.count("spec_drafted", n_drafted)
    eng.ledger.count("spec_accepted", n_accepted)
    return True
