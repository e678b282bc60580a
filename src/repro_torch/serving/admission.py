"""Iteration-level admission and batched prefill — the counterpart of
``repro.serving.admission`` on its ``scheduler=None`` branch (FIFO: every
valid request is admitted while a slot is free).

``admit_requests`` / ``prefill_group`` operate *on* a ``ServingEngine`` so
the engine module stays pure orchestration. The energy-aware branch of
``AdmissionPolicy.decide`` arrives with the scheduler slice (see
ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.robustness import reject_request
from repro_torch.serving.slots import Request, Response, _ActiveSeq, _SlotPool
from repro_torch.serving.workers import ModelWorker


def _len_bucket(n: int) -> int:
    """Next power of two (min 16), ``AdaOperScheduler._len_bucket``."""
    return max(16, 1 << (max(int(n), 1) - 1).bit_length())


def _new_bucket(n: int) -> int:
    """Next power of two (min 1), ``AdaOperScheduler._new_bucket``: the
    pow2 prefill batch bucket."""
    return 1 << (max(int(n), 1) - 1).bit_length()


class AdmissionPolicy:
    """Admission decision rule. With no scheduler (this slice) it admits
    every request a free slot can take; the log keeps the JAX engine's
    record format."""

    def __init__(self):
        self.log: List[dict] = []
        self.ledger = None

    def decide(self) -> Tuple[bool, str]:
        return True, "no-scheduler"

    def _record(self, admit: bool, reason: str, n_active: int, uid) -> None:
        self.log.append({"admit": admit, "reason": reason,
                         "n_active": n_active, "uid": uid})
        if self.ledger is not None and not admit:
            self.ledger.count("admission_denials")


def validate_request(w: ModelWorker, req: Request) -> Optional[str]:
    """Reason the request can never be served by ``w``, or None."""
    if len(req.prompt) + req.max_new_tokens > w.max_len:
        return (f"prompt {len(req.prompt)} + max_new "
                f"{req.max_new_tokens} exceeds max_len {w.max_len}")
    return None


def admit_requests(eng, model: str, pool: _SlotPool, out: List[Response],
                   temperature: float = 0.0) -> int:
    """Pull waiting requests into free slots while the policy approves,
    then prefill the admitted set in same-length batches
    (``batch_prefill=False`` keeps the serial batch-1 reference). A request
    that can never be served is rejected with an error ``Response`` and the
    loop keeps draining. Returns #admitted."""
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
        admit, reason = eng.admission.decide()
        eng.admission._record(admit, reason, len(pool.active), req.uid)
        if not admit:
            break
        q.pop(0)
        slot = pool.alloc.alloc()
        seq = _ActiveSeq(req, slot, pos=len(req.prompt), model=model)
        pool.active[slot] = seq
        admitted.append(seq)
    if eng.batch_prefill:
        groups: Dict[int, List[_ActiveSeq]] = {}
        for seq in admitted:
            groups.setdefault(len(seq.req.prompt), []).append(seq)
        group_list = list(groups.values())
    else:
        group_list = [[seq] for seq in admitted]
    for group in group_list:
        prefill_group(eng, model, pool, group, out, temperature)
    return len(admitted)


def prefill_group(eng, model: str, pool: _SlotPool,
                  group: List[_ActiveSeq], out: List[Response],
                  temperature: float) -> None:
    """One prefill for a same-length group of admitted requests: the batch
    is padded to a pow2 bucket (padding rows repeat the first prompt), and
    the resulting caches scatter into the slots in one ``write_slots`` call
    (padding rows carry slot ``n_slots`` and are dropped)."""
    w = eng.workers[model]
    G = len(group)
    b = _new_bucket(G)
    pad = b - G
    prompts = np.stack([s.req.prompt for s in group] + [group[0].req.prompt] * pad)
    logits, g_cache = w.prefill_batch(prompts)
    slots = np.full(b, pool.alloc.n_slots, np.int32)
    slots[:G] = [s.slot for s in group]
    pool.cache = w.write_slots(pool.cache, g_cache, slots)
    if temperature > 0.0:
        toks = eng._sample_batch(model, group, logits[:G], temperature)
    else:
        toks = [int(t) for t in logits[:G].argmax(dim=-1).cpu().numpy()]
    for seq, tok in zip(group, toks):
        seq.tokens.append(tok)
        pool.tokens[seq.slot, 0] = tok
        pool.pos[seq.slot] = seq.pos
        if len(seq.tokens) >= seq.req.max_new_tokens:
            eng._retire(pool, seq, out)
    eng.prefill_batches += 1
    eng.prefill_batch_requests += G
