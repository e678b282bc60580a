"""Per-request sampling streams — the counterpart of
``repro.serving.sampling``, keeping its contract rather than its bits.

Token ``i`` of request ``uid`` of ``model`` under engine seed ``seed`` is
drawn with Gumbel-max noise from a ``torch.Generator`` seeded by a fixed
hash of (seed, model, uid, i). The stream is independent of admission
order, slot placement and co-resident requests, and the batched draw
stacks exactly the noise rows the scalar draws use, so the two agree. The
same holds for the speculative verify's grid (``sample_grid``): token i's
draw depends only on (stream, i), never on whether it came alone or inside
an accepted run. The noise is drawn on the CPU and moved to the logits'
device, so a stream gives the same noise on the CPU and on the card. JAX's
threefry streams are not reproduced.
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np
import torch


def stream_key(sampling_seed: int, model: str, uid) -> int:
    """Per-request stream id: a fixed hash of seed ⊕ model ⊕ uid."""
    h = hashlib.blake2b(f"{int(sampling_seed)}|{model}|{int(uid)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def _noise(key: int, token_idx: int, vocab: int) -> torch.Tensor:
    """Gumbel noise for token ``token_idx`` of stream ``key``."""
    h = hashlib.blake2b(f"{key}|{int(token_idx)}".encode(), digest_size=8)
    gen = torch.Generator().manual_seed(int.from_bytes(h.digest(), "little") >> 1)
    u = torch.rand(vocab, generator=gen, dtype=torch.float64)
    return -torch.log(-torch.log(u.clamp(1e-300, 1.0 - 1e-16)))


def _sample_rows(keys, idx, logits, temperature: float) -> np.ndarray:
    """Row b draws token ``idx[b]`` of stream ``keys[b]`` from ``logits[b]``."""
    noise = torch.stack([_noise(k, i, logits.shape[-1]) for k, i in zip(keys, idx)])
    scores = logits.double() / temperature + noise.to(logits.device)
    return scores.argmax(dim=-1).cpu().numpy()


def _sample_grid(keys, idx0, logits, temperature: float) -> np.ndarray:
    """(B, T) draws: position t of row b is token ``idx0[b] + t`` of stream
    ``keys[b]`` from ``logits[b, t]``, the very draw ``_sample_rows`` makes
    for that token alone."""
    B, T, V = logits.shape
    keys = [k for k in keys for _ in range(T)]
    idx = [int(i0) + t for i0 in idx0 for t in range(T)]
    return _sample_rows(keys, idx, logits.reshape(B * T, V), temperature).reshape(B, T)


def sample_one(seq, logits, temperature: float) -> int:
    """Token #len(seq.tokens) of ``seq``'s stream from (V,) logits — the
    scalar reference for ``sample_batch`` and ``sample_grid``."""
    return int(_sample_rows([seq.rng], [len(seq.tokens)], logits[None], temperature)[0])


def sample_batch(seqs: List, logits, temperature: float) -> List[int]:
    """Token #len(seq.tokens) of each seq's stream from its logits row."""
    toks = _sample_rows([s.rng for s in seqs], [len(s.tokens) for s in seqs], logits,
                        temperature)
    return [int(t) for t in toks]


def sample_grid(seqs: List, logits, temperature: float) -> np.ndarray:
    """(B, T) tokens for the verify grid from ``logits`` (B, T, V): position
    t of row b is token #(len(seq.tokens) + t) of that seq's stream, the
    batched counterpart of T sequential ``sample_one`` calls."""
    return _sample_grid([s.rng for s in seqs], [len(s.tokens) for s in seqs], logits,
                        temperature).astype(np.int64)
