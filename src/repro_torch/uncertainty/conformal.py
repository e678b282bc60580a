"""Split-conformal calibration over scaled nonconformity scores.

The quantile predictor (``repro_torch.uncertainty.model``) turns ensemble spread
into a per-op scale sigma(x); this module calibrates the *multiplier* q so
that intervals ``mu(x) +/- q * sigma(x)`` hit a target coverage on held-out
observations. Scores ``s_i = |y_i - mu(x_i)| / sigma(x_i)`` stream in from
the profiler's online feedback into bounded ring buffers (one per
(quantized device-state bucket, op class) key plus a global fallback —
attention and conv residuals calibrate separately under the same device
state), and q is the finite-sample
conformal quantile: the ``ceil((n+1) * coverage)``-th order statistic of
the n most recent scores.

Recalibration is hysteretic and versioned: q is recomputed every
``recalib_every`` observations, and only a *material* move (relative change
past ``rel_tol``) commits it and bumps ``version`` — the profiler folds
``version`` into ``correction_version()``, so every cost-table and plan
cache downstream invalidates exactly when the calibrated intervals change,
and not on every single feedback sample.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


def conformal_quantile(scores, coverage: float) -> Optional[float]:
    """Finite-sample split-conformal quantile of ``scores``.

    Returns the ``k = ceil((n+1) * coverage)``-th smallest score, the
    classic split-conformal correction that guarantees >= ``coverage``
    marginal coverage for exchangeable scores; ``None`` when n is too small
    for the target (k > n), i.e. the requested coverage is not certifiable
    from this many scores.
    """
    xs = np.asarray(scores, np.float64)
    n = len(xs)
    if n == 0:
        return None
    k = math.ceil((n + 1) * coverage)
    if k > n:
        return None
    return float(np.sort(xs)[k - 1])


class _Ring:
    """Fixed-capacity ring buffer of floats (oldest-out)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._buf = np.zeros(capacity, np.float64)
        self._n = 0       # filled entries (<= capacity)
        self._head = 0    # next write index

    def append(self, x: float) -> None:
        self._buf[self._head] = x
        self._head = (self._head + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def values(self) -> np.ndarray:
        return self._buf[: self._n].copy()

    def __len__(self) -> int:
        return self._n


class SplitConformal:
    """Online split-conformal calibrator with per-bucket score rings.

    ``observe(scores, bucket)`` appends nonconformity scores;
    ``quantile(bucket)`` returns the current committed q — the bucket's own
    calibrated value when that ring has seen enough scores, the global ring's
    otherwise, and the prior ``q_default`` until any ring is large enough.
    q values are clamped to ``q_max`` so one pathological residual cannot
    blow intervals out to uselessness.
    """

    def __init__(self, coverage: float = 0.9, capacity: int = 256,
                 min_scores: int = 24, q_default: float = 2.0,
                 q_max: float = 8.0, recalib_every: int = 16,
                 rel_tol: float = 0.05):
        self.coverage = coverage
        self.capacity = capacity
        self.min_scores = min_scores
        self.q_default = q_default
        self.q_max = q_max
        self.recalib_every = recalib_every
        self.rel_tol = rel_tol
        self.version = 0
        self._global = _Ring(capacity)
        self._buckets: Dict[tuple, _Ring] = {}
        self._q_global = q_default
        self._q_buckets: Dict[tuple, float] = {}
        self._since_recalib = 0

    def n_scores(self) -> int:
        return len(self._global)

    def quantile(self, bucket=None) -> float:
        q = self._q_buckets.get(bucket) if bucket is not None else None
        return q if q is not None else self._q_global

    def _ring_for(self, key) -> _Ring:
        ring = self._buckets.get(key)
        if ring is None:
            ring = self._buckets[key] = _Ring(self.capacity)
        return ring

    def observe(self, scores, bucket=None, buckets=None) -> None:
        """Append nonconformity scores. ``bucket`` routes the whole batch to
        one ring; ``buckets`` (a per-row sequence of hashable keys, same
        length as ``scores``) routes each score to its own ring — the
        (state bucket, op class) keying the profiler uses, so a matmul's
        residual never widens a conv's interval. Every score also feeds the
        global ring (the fallback quantile)."""
        xs = np.atleast_1d(np.asarray(scores, np.float64))
        if buckets is not None:
            if len(buckets) != len(xs):
                raise ValueError(
                    f"buckets has {len(buckets)} keys for {len(xs)} scores")
            for x, key in zip(xs, buckets):
                self._global.append(float(x))
                self._ring_for(key).append(float(x))
        else:
            ring = self._ring_for(bucket) if bucket is not None else None
            for x in xs:
                self._global.append(float(x))
                if ring is not None:
                    ring.append(float(x))
        self._since_recalib += len(xs)
        if self._since_recalib >= self.recalib_every:
            self._since_recalib = 0
            self._recalibrate()

    # ------------------------------------------------------------------
    def _candidate(self, ring: _Ring) -> Optional[float]:
        if len(ring) < self.min_scores:
            return None
        q = conformal_quantile(ring.values(), self.coverage)
        return None if q is None else min(q, self.q_max)

    def _commit(self, cur: float, cand: Optional[float]) -> tuple:
        """(new value, moved?) — hysteresis: only material moves commit."""
        if cand is None:
            return cur, False
        if abs(cand - cur) <= self.rel_tol * max(abs(cur), 1e-12):
            return cur, False
        return cand, True

    def _recalibrate(self) -> None:
        moved = False
        self._q_global, m = self._commit(self._q_global,
                                         self._candidate(self._global))
        moved |= m
        for b, ring in self._buckets.items():
            cur = self._q_buckets.get(b, self._q_global)
            new, m = self._commit(cur, self._candidate(ring))
            if m:
                self._q_buckets[b] = new
            moved |= m
        if moved:
            self.version += 1
