"""The engine's per-iteration decode step over a model's slot pool — the
counterpart of ``repro.serving.decoding.plain_step``. Speculative rounds
(``decode_round``) wait for the speculative slice (see ROADMAP.md)."""
from __future__ import annotations

from typing import List

from repro_torch.serving.slots import Response, _SlotPool


def plain_step(eng, model: str, pool: _SlotPool, out: List[Response],
               temperature: float) -> None:
    """One single-token ragged decode step over the whole slot pool."""
    w = eng.workers[model]
    next_tok, logits, pool.cache = w.decode_pool(pool.cache, pool.tokens, pool.pos)
    seqs = list(pool.active.values())
    if temperature > 0.0:
        rows = logits[[seq.slot for seq in seqs]]
        toks = eng._sample_batch(model, seqs, rows, temperature)
    else:
        toks = [int(next_tok[seq.slot]) for seq in seqs]
    for seq, tok in zip(seqs, toks):
        seq.tokens.append(tok)
        seq.pos += 1
        pool.tokens[seq.slot, 0] = tok
        pool.pos[seq.slot] = seq.pos
        if len(seq.tokens) >= seq.req.max_new_tokens:
            eng._retire(pool, seq, out)
