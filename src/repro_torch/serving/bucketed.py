"""The position-synchronous (bucketed) serving path: the counterpart of
``repro.serving.bucketed``.

Kept behind ``ServingEngine(mode="bucketed")`` the way ``vectorize=False``
keeps the scalar DP: requests are grouped into equal-prompt-length buckets
and decoded in lockstep (``ModelWorker.generate``: one prefill, then one
decode step per token at one shared position), which the continuous engine
matches token for token. A draft registered on the model is never used.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np

from repro_torch.core.telemetry import EnergyBreakdown
from repro_torch.serving.slots import Response


def step_bucketed(eng, model: str, temperature: float = 0.0) -> List[Response]:
    """Serve one batch from ``model``'s queue (same-length bucket)."""
    q = eng.queues[model]
    if not q:
        return []
    w = eng.workers[model]
    plen = len(q[0].prompt)
    # one O(n) scan collects the equal-length bucket and where its members sit
    bucket_idx = [i for i, r in enumerate(q) if len(r.prompt) == plen]
    bucket = [q[i] for i in bucket_idx]
    max_new = max(r.max_new_tokens for r in bucket)
    if eng.scheduler is not None:
        choice = eng.scheduler.choose(w.cfg, len(bucket), plen, max_new)
        bsz = choice["batch"]
    else:
        choice = {"energy": float("nan"), "rails": None}
        bsz = min(8, len(bucket))
    batch = bucket[:bsz]
    # decode only as deep as the served batch needs: a long request left in
    # the bucket must not pad this batch's horizon
    max_new = max(r.max_new_tokens for r in batch)
    served = set(bucket_idx[:bsz])
    eng.queues[model] = [r for i, r in enumerate(q) if i not in served]
    prompts = np.stack([r.prompt for r in batch])
    enc = (np.stack([r.enc_inputs for r in batch])
           if batch[0].enc_inputs is not None else None)
    # sampled decode draws every row from its uid-derived stream, so the
    # bucketed and continuous modes emit identical sampled tokens
    row_keys = eng._row_keys(model, batch) if temperature > 0.0 else None
    t0 = time.time()
    toks = w.generate(prompts, max_new, enc_inputs=enc, temperature=temperature,
                      row_keys=row_keys)
    dt = time.time() - t0
    eng.stats[model].append({"batch": bsz, "wall_s": dt, "pred_energy_j": choice["energy"]})
    # the predicted batch energy is shared by the requests it served
    per_req_energy = choice["energy"] / bsz
    out = []
    for i, r in enumerate(batch):
        eb = (EnergyBreakdown.from_total(per_req_energy, choice["rails"])
              if eng.scheduler is not None else EnergyBreakdown())
        eng.ledger.emit("request", dt, eb, model=model, uid=r.uid)
        out.append(Response(r.uid, toks[i, : r.max_new_tokens], dt, per_req_energy, rails=eb))
    return out
