"""Deterministic synthetic token pipeline: the port's own numpy copy of
``repro.data.pipeline``.

Reproducible language-modeling batches: Zipfian unigram tokens with a
learnable bigram structure (each next token follows a fixed random
permutation of the current one with probability 0.75), so that a loss can
fall. An encoder-decoder model also gets frame embeddings for its stubbed
speech frontend. For the same config, seed and step the batches equal the
JAX package's element for element. Batches are numpy; the train loop moves
each one to the model's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    enc_frames: int = 64


class SyntheticLM:
    """Markov-ish synthetic corpus: token_{t+1} depends on token_t via a
    fixed random permutation mixed with Zipf noise."""

    def __init__(self, cfg, dc: DataConfig):
        self.cfg = cfg
        self.dc = dc
        self.V = max(cfg.vocab_size, 2)
        rng = np.random.default_rng(dc.seed)
        self.perm = rng.permutation(self.V)
        ranks = np.arange(1, self.V + 1)
        p = 1.0 / ranks ** 1.1
        self.zipf = p / p.sum()

    def batch(self, step: int) -> dict:
        """{"tokens", "labels"} (B, S) int32, labels the tokens shifted by
        one; an encoder-decoder model adds "enc_inputs" (B, enc_frames,
        d_model) fp32."""
        rng = np.random.default_rng((self.dc.seed, step))
        B, S = self.dc.batch, self.dc.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(self.V, size=B, p=self.zipf)
        noise = rng.random((B, S))
        nxt = rng.choice(self.V, size=(B, S), p=self.zipf)
        for t in range(S):
            det = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, det, nxt[:, t])
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.is_encoder_decoder:
            out["enc_inputs"] = rng.standard_normal(
                (B, self.dc.enc_frames, self.cfg.d_model)).astype(np.float32) * 0.1
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def batches(self, n: int):
        return (self.batch(i) for i in range(n))
