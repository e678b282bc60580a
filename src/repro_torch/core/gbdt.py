"""Gradient-Boosted Decision Trees (regression), from scratch in numpy — a
copy of ``repro.core.gbdt``, the seeded spread ensemble (``fit_ensemble``)
of the uncertainty layer included.

AdaOper's offline energy model: squared-loss boosting over histogram-binned
features (quantile bins, exact greedy split on bins). Small and fast enough
to refit on-device; no external ML deps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class _Node:
    feature: int = -1
    threshold_bin: int = 0
    left: int = -1
    right: int = -1
    value: float = 0.0
    is_leaf: bool = True


class _Tree:
    def __init__(self, max_depth: int, min_samples: int, lam: float):
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.lam = lam  # L2 on leaf values
        self.nodes: List[_Node] = []

    def fit(self, Xb: np.ndarray, g: np.ndarray, n_bins: int):
        """Xb: (N, F) uint8 binned features; g: residual targets."""
        self.nodes = [_Node()]
        stack = [(0, np.arange(Xb.shape[0]), 0)]
        while stack:
            nid, idx, depth = stack.pop()
            node = self.nodes[nid]
            gi = g[idx]
            node.value = float(gi.sum() / (len(gi) + self.lam))
            if depth >= self.max_depth or len(idx) < self.min_samples:
                continue
            best = self._best_split(Xb[idx], gi, n_bins)
            if best is None:
                continue
            f, t, gain = best
            mask = Xb[idx, f] <= t
            li, ri = idx[mask], idx[~mask]
            if len(li) == 0 or len(ri) == 0:
                continue
            node.is_leaf = False
            node.feature, node.threshold_bin = f, t
            node.left, node.right = len(self.nodes), len(self.nodes) + 1
            self.nodes.extend([_Node(), _Node()])
            stack.append((node.left, li, depth + 1))
            stack.append((node.right, ri, depth + 1))

    def _best_split(self, Xb, g, n_bins):
        N, F = Xb.shape
        G = g.sum()
        parent = G * G / (N + self.lam)
        best = None
        best_gain = 1e-12
        for f in range(F):
            # histogram of gradient sums + counts per bin
            hist_g = np.bincount(Xb[:, f], weights=g, minlength=n_bins)
            hist_n = np.bincount(Xb[:, f], minlength=n_bins)
            cg = np.cumsum(hist_g)[:-1]
            cn = np.cumsum(hist_n)[:-1]
            valid = (cn > 0) & (cn < N)
            if not valid.any():
                continue
            gain = (cg**2 / (cn + self.lam) + (G - cg) ** 2 / (N - cn + self.lam)) - parent
            gain = np.where(valid, gain, -np.inf)
            t = int(np.argmax(gain))
            if gain[t] > best_gain:
                best_gain = float(gain[t])
                best = (f, t, best_gain)
        return best

    def _pack(self):
        """Vectorised node arrays for batch predict."""
        self._feat = np.array([x.feature for x in self.nodes], np.int32)
        self._thr = np.array([x.threshold_bin for x in self.nodes], np.int32)
        self._left = np.array([x.left for x in self.nodes], np.int32)
        self._right = np.array([x.right for x in self.nodes], np.int32)
        self._leaf = np.array([x.is_leaf for x in self.nodes])
        self._val = np.array([x.value for x in self.nodes])

    def predict(self, Xb: np.ndarray) -> np.ndarray:
        if not hasattr(self, "_feat"):
            self._pack()
        nid = np.zeros(Xb.shape[0], np.int32)
        for _ in range(self.max_depth + 1):
            active = ~self._leaf[nid]
            if not active.any():
                break
            f = self._feat[nid]
            go_left = Xb[np.arange(Xb.shape[0]), np.maximum(f, 0)] <= self._thr[nid]
            nid = np.where(active, np.where(go_left, self._left[nid], self._right[nid]), nid)
        return self._val[nid]


@dataclass
class GBDTRegressor:
    n_estimators: int = 120
    learning_rate: float = 0.1
    max_depth: int = 4
    min_samples: int = 8
    n_bins: int = 64
    lam: float = 1.0
    subsample: float = 0.9
    log_target: bool = True  # energies span decades -> fit log1p
    seed: int = 0
    # instrumentation: number of predict() invocations (each is one ensemble
    # traversal over its batch). Planner caches are verified against this —
    # a warm-cache schedule decision must not touch the trees at all.
    n_predict_calls: int = 0

    _bin_edges: Optional[np.ndarray] = None
    _trees: List[_Tree] = field(default_factory=list)
    _base: float = 0.0

    # ----- binning -----
    def _fit_bins(self, X):
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        self._bin_edges = np.quantile(X, qs, axis=0)  # (n_bins-1, F)

    def _bin(self, X):
        # digitize each feature against its quantile edges
        Xb = np.zeros(X.shape, np.uint8)
        for f in range(X.shape[1]):
            Xb[:, f] = np.searchsorted(self._bin_edges[:, f], X[:, f]).astype(np.uint8)
        return Xb

    def _tx(self, y):
        return np.log1p(np.maximum(y, 0)) if self.log_target else y

    def _itx(self, y):
        # log-space fit can land slightly below 0 for tiny targets; energies
        # and latencies are non-negative by construction
        return np.maximum(np.expm1(y), 0.0) if self.log_target else y

    # ----- API -----
    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDTRegressor":
        X = np.asarray(X, np.float64)
        y = self._tx(np.asarray(y, np.float64))
        rng = np.random.default_rng(self.seed)
        self._fit_bins(X)
        Xb = self._bin(X)
        self._base = float(y.mean())
        pred = np.full(y.shape, self._base)
        self._trees = []
        for _ in range(self.n_estimators):
            res = y - pred
            t = _Tree(self.max_depth, self.min_samples, self.lam)
            if self.subsample < 1.0:
                idx = rng.random(len(y)) < self.subsample
                t.fit(Xb[idx], res[idx], self.n_bins)
            else:
                t.fit(Xb, res, self.n_bins)
            self._trees.append(t)
            pred += self.learning_rate * t.predict(Xb)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        self.n_predict_calls += 1
        X = np.asarray(X, np.float64)
        Xb = self._bin(X)
        pred = np.full(Xb.shape[0], self._base)
        for t in self._trees:
            pred += self.learning_rate * t.predict(Xb)
        return self._itx(pred)

    def score_rmse(self, X, y) -> float:
        p = self.predict(X)
        return float(np.sqrt(np.mean((p - np.asarray(y)) ** 2)))


# seed stride between ensemble members: prime, so member subsample streams
# never alias each other (or a neighbouring profiler's base models)
_MEMBER_SEED_STRIDE = 7919


def fit_ensemble(X: np.ndarray, y: np.ndarray, n_members: int = 4,
                 seed: int = 0, n_estimators: int = 60,
                 subsample: float = 0.7, **kwargs) -> List[GBDTRegressor]:
    """Seeded diversity ensemble for spread-based uncertainty.

    Members share the training data but draw independent boosting-subsample
    streams (distinct seeds, aggressive ``subsample``), so their predictive
    *spread* tracks where the data pins the cost surface down and where it
    does not — the heteroscedastic scale ``sigma(x)`` the conformal layer
    (``repro_torch.uncertainty``) calibrates into honest intervals. Fewer, shorter
    boosters than the point model: the spread, not each member's accuracy,
    is the product.
    """
    return [GBDTRegressor(n_estimators=n_estimators, subsample=subsample,
                          seed=seed + _MEMBER_SEED_STRIDE * (i + 1),
                          **kwargs).fit(X, y)
            for i in range(n_members)]
