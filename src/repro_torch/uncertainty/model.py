"""Quantile predictor layer: ensemble spread + split-conformal intervals.

``UncertaintyModel`` wraps the profiler's point predictions with calibrated
prediction intervals, fit from the *same* offline-calibration trace as the
point GBDTs (``RuntimeEnergyProfiler.offline_calibrate`` calls ``fit`` when
a model is attached) and calibrated online from the same feedback stream
(``feedback_batch`` calls ``observe_batch``). The pieces:

* **scale** — a seeded ensemble of :class:`~repro_torch.core.gbdt.GBDTRegressor`
  members per target (energy, latency); ``sigma(x)`` is the member spread,
  floored at a fraction of the point prediction so intervals never collapse
  to zero width.
* **calibration** — :class:`~repro_torch.uncertainty.conformal.SplitConformal`
  turns streamed scores ``|obs - mu| / sigma`` into the multiplier ``q``
  such that ``mu +/- q * sigma`` hits the coverage target; its ``version``
  is folded into the profiler's ``correction_version()`` so cost-table and
  plan caches invalidate when the calibrated widths change.
* **accounting** — coverage is *prequential*: each observation batch is
  scored against the interval that was in force *before* its scores update
  the calibrator, so the reported coverage is an honest out-of-sample
  number. ``take_outside()`` / ``take_stats()`` hand the per-op
  outside-interval mask and the batch coverage/width tallies to the caller
  exactly once (the controller folds them into ``EnergyLedger`` counters).

The profiler never imports this package — it is attached by callers
(fleet replay, benchmarks, tests) and duck-typed, the same inert-by-default
discipline as the fault injector: unattached, every existing number is
bit-identical and zero extra model evaluations happen.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.gbdt import GBDTRegressor, fit_ensemble
from repro_torch.uncertainty.conformal import SplitConformal


class UncertaintyModel:
    """Calibrated prediction intervals for the runtime energy profiler."""

    def __init__(self, seed: int = 0, n_members: int = 4,
                 coverage: float = 0.9, n_estimators: int = 60,
                 sigma_floor: float = 0.05, ring_capacity: int = 256,
                 min_scores: int = 24, q_default: float = 2.0,
                 q_max: float = 8.0, recalib_every: int = 16):
        self.seed = seed
        self.n_members = n_members
        self.coverage = coverage
        self.n_estimators = n_estimators
        self.sigma_floor = sigma_floor
        conf = dict(coverage=coverage, capacity=ring_capacity,
                    min_scores=min_scores, q_default=q_default, q_max=q_max,
                    recalib_every=recalib_every)
        self.conformal_e = SplitConformal(**conf)
        self.conformal_t = SplitConformal(**conf)
        self._e_members: List[GBDTRegressor] = []
        self._t_members: List[GBDTRegressor] = []
        # prequential coverage accounting (energy intervals — the drift
        # trigger and the benchmark-gated number)
        self.n_obs = 0
        self.n_covered = 0
        self.width_sum_j = 0.0
        # cumulative per-op-class coverage tallies (populated when callers
        # pass op_classes — the (state bucket, op class) conformal keying)
        self.class_obs: Dict[str, int] = {}
        self.class_cov: Dict[str, int] = {}
        self._pending_outside: Optional[np.ndarray] = None
        self._pending_stats: Optional[Dict] = None

    # ------------------------------------------------------------------
    def fitted(self) -> bool:
        return bool(self._e_members)

    def calibration_version(self) -> int:
        """Monotone stamp folded into ``correction_version()``: bumps when
        either target's calibrated quantile materially moves."""
        return self.conformal_e.version + self.conformal_t.version

    def fit(self, X: np.ndarray, y_energy: np.ndarray,
            y_latency: np.ndarray) -> "UncertaintyModel":
        """Fit on the offline-calibration trace (the profiler passes the
        very arrays its point models were fit on), as a *proper* split:
        the spread ensembles train on one random half, and the held-out
        half's nonconformity scores seed the conformal calibrators — so
        the very first online intervals already carry a data-driven
        quantile instead of riding the ``q_default`` prior until the
        feedback stream warms the rings up."""
        X = np.asarray(X, np.float64)
        y_energy = np.asarray(y_energy, np.float64)
        y_latency = np.asarray(y_latency, np.float64)
        n = len(X)
        split = n // 2 if n // 2 >= self.conformal_e.min_scores else n
        perm = np.random.default_rng(self.seed).permutation(n)
        tr, cal = perm[:split], perm[split:]
        self._e_members = fit_ensemble(X[tr], y_energy[tr], self.n_members,
                                       seed=self.seed,
                                       n_estimators=self.n_estimators)
        self._t_members = fit_ensemble(X[tr], y_latency[tr], self.n_members,
                                       seed=self.seed + 1,
                                       n_estimators=self.n_estimators)
        if len(cal):
            self._seed_conformal(self.conformal_e, self._e_members,
                                 X[cal], y_energy[cal])
            self._seed_conformal(self.conformal_t, self._t_members,
                                 X[cal], y_latency[cal])
        return self

    def _seed_conformal(self, conformal: SplitConformal,
                        members: List[GBDTRegressor],
                        Xc: np.ndarray, yc: np.ndarray) -> None:
        """Held-out scores with the ensemble mean as center (a stand-in for
        the profiler's point prediction, whose correction starts at 1.0)."""
        center = np.stack([m.predict(Xc) for m in members]).mean(axis=0)
        sig = self._sigma(members, Xc, center)
        conformal.observe(np.abs(yc - center) / np.maximum(sig, 1e-12))

    # ------------------------------------------------------------------
    def _sigma(self, members: List[GBDTRegressor], X: np.ndarray,
               center: np.ndarray) -> np.ndarray:
        P = np.stack([m.predict(X) for m in members])
        return np.maximum(P.std(axis=0),
                          self.sigma_floor * np.maximum(center, 1e-12))

    @staticmethod
    def _row_keys(bucket, op_classes, n: int):
        """Per-row conformal keys: ``(state bucket, op class)`` when
        ``op_classes`` is given (each op's residual calibrates its own
        ring), else ``None`` — callers fall through to the single-bucket
        path bit-identically."""
        if op_classes is None:
            return None
        if len(op_classes) != n:
            raise ValueError(
                f"op_classes has {len(op_classes)} entries for {n} rows")
        return [(bucket, c) for c in op_classes]

    def _q_rows(self, conformal: SplitConformal, bucket, op_classes, n: int):
        keys = self._row_keys(bucket, op_classes, n)
        if keys is None:
            return conformal.quantile(bucket)
        return np.array([conformal.quantile(k) for k in keys], np.float64)

    def interval_energy(self, X, center, bucket=None, op_classes=None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(lo, hi, sigma) per row: ``center +/- q_hat * sigma`` clamped to
        non-negative energies. ``center`` is the profiler's corrected point
        prediction — the interval brackets the number decisions actually
        use. ``op_classes`` keys each row's quantile on its
        ``(state bucket, op class)`` ring (global fallback until the ring
        certifies)."""
        center = np.asarray(center, np.float64)
        sig = self._sigma(self._e_members, X, center)
        q = self._q_rows(self.conformal_e, bucket, op_classes, len(center))
        return np.maximum(center - q * sig, 0.0), center + q * sig, sig

    def interval_latency(self, X, center, bucket=None, op_classes=None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        center = np.asarray(center, np.float64)
        sig = self._sigma(self._t_members, X, center)
        q = self._q_rows(self.conformal_t, bucket, op_classes, len(center))
        return np.maximum(center - q * sig, 0.0), center + q * sig, sig

    # ------------------------------------------------------------------
    def observe_batch(self, X, pred_lat, pred_en, obs_lat, obs_en,
                      bucket=None, op_classes=None) -> None:
        """One inference batch of (prediction, ground truth) pairs from the
        profiler's feedback path. Prequential order: coverage is judged with
        the quantile in force *now*, then the scores update the calibrator.
        ``op_classes`` (one op-type string per row) switches the conformal
        keying to ``(state bucket, op class)`` and tallies coverage per
        class (``coverage_per_class`` / ``take_stats()['by_class']``)."""
        if not self.fitted():
            return
        pred_en = np.asarray(pred_en, np.float64)
        pred_lat = np.asarray(pred_lat, np.float64)
        obs_en = np.asarray(obs_en, np.float64)
        obs_lat = np.asarray(obs_lat, np.float64)
        lo_e, hi_e, sig_e = self.interval_energy(X, pred_en, bucket,
                                                 op_classes)
        _, _, sig_t = self.interval_latency(X, pred_lat, bucket, op_classes)
        covered = (obs_en >= lo_e) & (obs_en <= hi_e)
        n, n_cov = len(obs_en), int(covered.sum())
        width = hi_e - lo_e
        self.n_obs += n
        self.n_covered += n_cov
        self.width_sum_j += float(width.sum())
        self._pending_outside = ~covered
        # integer micro-joules so the width flows through the ledger's
        # integer counters (fleet reports derive the mean back out)
        self._pending_stats = {"n": n, "covered": n_cov,
                               "width_uj": int(round(width.sum() * 1e6))}
        if op_classes is not None:
            by_class: Dict[str, list] = {}
            for c, cov in zip(op_classes, covered):
                cn = by_class.setdefault(c, [0, 0])
                cn[0] += 1
                cn[1] += int(cov)
            for c, (cn, cc) in by_class.items():
                self.class_obs[c] = self.class_obs.get(c, 0) + cn
                self.class_cov[c] = self.class_cov.get(c, 0) + cc
            self._pending_stats["by_class"] = {
                c: tuple(v) for c, v in by_class.items()}
        keys = self._row_keys(bucket, op_classes, n)
        self.conformal_e.observe(np.abs(obs_en - pred_en)
                                 / np.maximum(sig_e, 1e-12), bucket,
                                 buckets=keys)
        self.conformal_t.observe(np.abs(obs_lat - pred_lat)
                                 / np.maximum(sig_t, 1e-12), bucket,
                                 buckets=keys)

    def take_outside(self) -> Optional[np.ndarray]:
        """Per-op outside-interval mask of the last observed batch (the
        interval-drift repartition trigger); consumed exactly once."""
        out, self._pending_outside = self._pending_outside, None
        return out

    def take_stats(self) -> Optional[Dict[str, int]]:
        """Last batch's {n, covered, width_uj} tallies; consumed exactly
        once (the controller folds them into ledger counters)."""
        st, self._pending_stats = self._pending_stats, None
        return st

    # ------------------------------------------------------------------
    def empirical_coverage(self) -> Optional[float]:
        return self.n_covered / self.n_obs if self.n_obs else None

    def coverage_per_class(self) -> Dict[str, float]:
        """Cumulative prequential coverage per op class (empty unless
        callers stream ``op_classes`` through ``observe_batch``)."""
        return {c: self.class_cov.get(c, 0) / n
                for c, n in sorted(self.class_obs.items()) if n}

    def mean_width_j(self) -> Optional[float]:
        return self.width_sum_j / self.n_obs if self.n_obs else None
