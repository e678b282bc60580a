"""Runtime energy profiler — AdaOper module #1.

Offline: GBDT regressors (energy + latency) fit on calibration traces
sampled across device states, operators and partition ratios.
Online: a resource monitor reads (noisy) device state; a GRU consumes the
recent feedback window and predicts a log-space correction to the GBDT
energy estimate, tracking dynamics the offline model cannot (governor
moves, thermal, contention bursts).

A copy of ``repro.core.profiler``, the uncertainty hooks included
(``attach_uncertainty``, ``predict_plan_interval``, the intervals fed from
``feedback_batch``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.gbdt import GBDTRegressor
from repro_torch.core.gru import GRUCorrector
from repro_torch.core.opgraph import OP_TYPES, STATIC_FEATURE_DIM, OpGraph, OpNode
from repro_torch.core.simulator import PRESETS, DeviceSim, DeviceState

FEATURE_DIM = 6 + len(OP_TYPES) + 4

# feature layout: [log flops, log io, log wb | alpha, is_split, |a-p| moved to
# columns 3..5 | op-type one-hot | 4 state features]. The static per-op block
# (scalars + one-hot) is cached on each OpNode; only the dynamic columns are
# assembled per call.
_N_TYPES = len(OP_TYPES)
_STATE_OFF = 6 + _N_TYPES


def op_features(op: OpNode, alpha: float, prev_alpha: float, state: DeviceState) -> np.ndarray:
    x = np.empty(FEATURE_DIM)
    s = op.static_features()
    x[0:3] = s[0:3]
    x[3] = alpha
    x[4] = 1.0 if 0.0 < alpha < 1.0 else 0.0
    x[5] = abs(alpha - prev_alpha)
    x[6:_STATE_OFF] = s[3:]
    x[_STATE_OFF:] = state.as_features()
    return x


def op_features_batch(ops: Sequence[OpNode], alphas, prevs, state: DeviceState,
                      counts=None, static_block=None) -> np.ndarray:
    """Vectorised ``op_features`` over N placements.

    ``ops`` lists the (distinct or repeated) operators; with ``counts``,
    op ``i`` accounts for ``counts[i]`` consecutive rows and ``alphas`` /
    ``prevs`` are already expanded to the full row count. Static per-op
    blocks come from the OpNode cache (or a pre-stacked ``static_block``,
    e.g. ``OpGraph.static_feature_matrix()``) so only the dynamic columns
    (alpha, split flag, transition, device state) are computed here.
    """
    alphas = np.asarray(alphas, np.float64)
    prevs = np.asarray(prevs, np.float64)
    if static_block is not None:
        S = static_block
    else:
        S = (np.stack([op.static_features() for op in ops])
             if len(ops) else np.zeros((0, STATIC_FEATURE_DIM)))
    if counts is not None:
        S = np.repeat(S, np.asarray(counts, np.int64), axis=0)
    X = np.empty((len(alphas), FEATURE_DIM))
    X[:, 0:3] = S[:, 0:3]
    X[:, 3] = alphas
    X[:, 4] = ((alphas > 0.0) & (alphas < 1.0)).astype(np.float64)
    X[:, 5] = np.abs(alphas - prevs)
    X[:, 6:_STATE_OFF] = S[:, 3:]
    X[:, _STATE_OFF:] = state.as_features()[None]
    return X


def state_bucket(state: DeviceState, f_step: float = 0.05,
                 bg_step: float = 0.05) -> Tuple[int, int, int, int]:
    """Quantize a device state into a hashable bucket for table/plan caches.

    Steps are sized to the resource monitor's observation noise (~1% on
    clocks, ~0.03 absolute on utilization) so repeated observations of the
    same underlying state usually land in the same bucket, while genuine
    governor moves or load shifts change it.
    """
    return (int(round(state.cpu_f / f_step)),
            int(round(state.gpu_f / (0.5 * f_step))),
            int(round(state.cpu_bg / bg_step)),
            int(round(state.gpu_bg / bg_step)))


class CostTableCache:
    """LRU cache of partitioner edge-cost tables.

    Keys are ``(graph id, segment, state bucket, correction version)`` —
    see ``docs/planner.md``. Each entry keeps a strong reference to its
    graph so a recycled ``id()`` can never alias a dead graph's tables.
    """

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key, graph):
        ent = self._d.get(key)
        if ent is None or ent[0] is not graph:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return ent[1]

    def put(self, key, graph, tables):
        self._d[key] = (graph, tables)
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    def clear(self):
        self._d.clear()

    def __len__(self):
        return len(self._d)


class RuntimeEnergyProfiler:
    def __init__(self, seed: int = 0, use_gru: bool = True,
                 table_cache_entries: int = 64):
        self.energy_model = GBDTRegressor(seed=seed)
        self.latency_model = GBDTRegressor(seed=seed + 1)
        self.use_gru = use_gru
        # GRU input = features + [log gbdt pred, log ratio] (built in record())
        self.gru_e = GRUCorrector(in_dim=FEATURE_DIM + 2, seed=seed)
        self.gru_t = GRUCorrector(in_dim=FEATURE_DIM + 2, seed=seed + 1)
        self._calibrated = False
        self._n_feedback = 0
        # monotone version stamp: bumped whenever predictions can change
        # (recalibration, or any GRU feedback — the correction is a function
        # of the feedback history). Caches key on it for invalidation.
        self._version = 0
        self.table_cache = CostTableCache(max_entries=table_cache_entries)
        # optional quantile/conformal layer (repro_torch.uncertainty), duck-typed
        # like the fault injector: None (the default) keeps every prediction,
        # cache key and feedback path bit-identical with zero extra model
        # evaluations
        self.uncertainty = None

    def attach_uncertainty(self, model) -> "RuntimeEnergyProfiler":
        """Attach an :class:`repro_torch.uncertainty.UncertaintyModel` (or any
        duck-type with ``fit`` / ``observe_batch`` / ``interval_*`` /
        ``calibration_version``). Attach *before* ``offline_calibrate`` so
        the spread ensembles fit on the same calibration trace."""
        self.uncertainty = model
        return self

    def correction_version(self) -> int:
        # calibration_version is monotone, so the sum stays a valid
        # monotone cache stamp; a conformal recalibration that moves the
        # interval widths invalidates cost tables and plans exactly like a
        # GRU correction or a refit does
        if self.uncertainty is not None:
            return self._version + self.uncertainty.calibration_version()
        return self._version

    # ------------------------------------------------------------------
    # offline calibration (factory/first-run energy benchmarking pass)
    # ------------------------------------------------------------------
    def offline_calibrate(self, graphs, n_samples: int = 4000, seed: int = 0,
                          sim_factory=None):
        """Fit the GBDT energy/latency models on simulated calibration traces.

        ``sim_factory(preset_name, seed) -> DeviceSim`` overrides how the
        calibration devices are built — the fleet population passes a factory
        that bakes in each device's perturbed silicon (clocks, throughput,
        power), so a per-device profiler learns *that* device's physics
        rather than the stock Snapdragon-855 presets.
        """
        if sim_factory is None:
            sim_factory = DeviceSim
        rng = np.random.default_rng(seed)
        X, ye, yt = [], [], []
        presets = list(PRESETS)
        ops = [op for g in graphs for op in g.nodes]
        for i in range(n_samples):
            sim = sim_factory(presets[rng.integers(len(presets))], int(rng.integers(1 << 30)))
            for _ in range(int(rng.integers(0, 8))):
                sim.step()
            op = ops[rng.integers(len(ops))]
            alpha = float(rng.choice([0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0])) \
                if op.splittable else float(rng.integers(2))
            prev = float(rng.choice([0, 0.5, 1.0]))
            lat, en = sim.exec_op(op, alpha, prev)
            X.append(op_features(op, alpha, prev, sim.state))
            ye.append(en)
            yt.append(lat)
        X = np.stack(X)
        self.energy_model.fit(X, np.array(ye))
        self.latency_model.fit(X, np.array(yt))
        if self.uncertainty is not None:
            # spread ensembles fit on the very trace the point models saw
            self.uncertainty.fit(X, np.array(ye), np.array(yt))
        self._calibrated = True
        self._version += 1  # refit invalidates any cached cost tables
        return self

    # ------------------------------------------------------------------
    # runtime prediction + feedback
    # ------------------------------------------------------------------
    def _corrections(self) -> Tuple[float, float]:
        if not self.use_gru:
            return 1.0, 1.0
        return (float(np.exp(np.clip(self.gru_e.predict_correction(), -1.5, 1.5))),
                float(np.exp(np.clip(self.gru_t.predict_correction(), -1.5, 1.5))))

    def predict(self, op: OpNode, alpha: float, prev_alpha: float,
                obs_state: DeviceState) -> Tuple[float, float]:
        """Returns (latency_s, energy_j) prediction under observed state."""
        x = op_features(op, alpha, prev_alpha, obs_state)[None]
        ce, ct = self._corrections()
        en = float(self.energy_model.predict(x)[0]) * ce
        lat = float(self.latency_model.predict(x)[0]) * ct
        return max(lat, 1e-9), max(en, 1e-12)

    def _predict_xy(self, X):
        ce, ct = self._corrections()
        en = np.maximum(self.energy_model.predict(X) * ce, 1e-12)
        lat = np.maximum(self.latency_model.predict(X) * ct, 1e-9)
        return lat, en

    def predict_batch(self, items, obs_state):
        """items: list of (op, alpha, prev_alpha). One vectorised GBDT pass —
        the partitioner's DP tables evaluate ~1e3 placements per plan."""
        ops = [it[0] for it in items]
        alphas = np.fromiter((it[1] for it in items), np.float64, len(items))
        prevs = np.fromiter((it[2] for it in items), np.float64, len(items))
        return self._predict_xy(op_features_batch(ops, alphas, prevs, obs_state))

    def predict_batch_cols(self, ops, counts, alphas, prevs, obs_state):
        """Columnar twin of ``predict_batch``: ``ops`` + repeat ``counts``
        (None => one row per op) with pre-built alpha/prev columns. This is
        the path the partitioner's table builder uses — no per-item Python
        tuples at all."""
        return self._predict_xy(
            op_features_batch(ops, alphas, prevs, obs_state, counts=counts))

    def cost_fn(self, obs_state):
        """Batched cost callable for the DP partitioner. Exposes the
        profiler's cost-table cache plus a ``cache_key()`` combining the
        quantized device-state bucket and the correction version, so
        ``dp_partition`` can reuse tables across calls and invalidate them
        on state or drift changes."""
        prof = self

        class _Fn:
            table_cache = prof.table_cache

            def cache_key(self):
                return (state_bucket(obs_state), prof.correction_version())

            def __call__(self, op, a, p):
                return prof.predict(op, a, p, obs_state)

            def batch(self, items):
                return prof.predict_batch(items, obs_state)

            def batch_cols(self, ops, counts, alphas, prevs):
                return prof.predict_batch_cols(ops, counts, alphas, prevs, obs_state)

            def plan_interval(self, graph, alphas):
                """Calibrated (latency, energy) plan interval, or None
                without an attached uncertainty model (the inert default)."""
                return prof.predict_plan_interval(graph, alphas, obs_state)

        return _Fn()

    def predict_graph(self, graph: OpGraph, plan, obs_state) -> Tuple[float, float]:
        alphas = np.asarray(plan, np.float64)
        if len(alphas) == 0:
            return 0.0, 0.0
        prevs = np.empty_like(alphas)
        prevs[0] = alphas[0]
        prevs[1:] = alphas[:-1]
        lat, en = self._predict_xy(op_features_batch(
            graph.nodes[:len(alphas)], alphas, prevs, obs_state,
            static_block=graph.static_feature_matrix()[:len(alphas)]))
        return float(lat.sum()), float(en.sum())

    def predict_plan_interval(self, graph: OpGraph, alphas, obs_state):
        """Calibrated prediction interval for executing ``alphas`` on
        ``graph`` under the observed state: per-op intervals centered on the
        corrected point prediction, summed (a conservative union bound —
        the plan is outside its interval only if the op-level calibration
        genuinely broke). Returns ``{"latency": (lo, hi), "energy":
        (lo, hi)}`` or None when no uncertainty model is attached."""
        unc = self.uncertainty
        if unc is None or not unc.fitted():
            return None
        alphas = np.asarray(alphas, np.float64)
        if len(alphas) == 0:
            return None
        prevs = np.empty_like(alphas)
        prevs[0] = alphas[0]
        prevs[1:] = alphas[:-1]
        X = op_features_batch(
            graph.nodes[:len(alphas)], alphas, prevs, obs_state,
            static_block=graph.static_feature_matrix()[:len(alphas)])
        lat, en = self._predict_xy(X)
        bucket = state_bucket(obs_state)
        classes = [op.op_type for op in graph.nodes[:len(alphas)]]
        lo_e, hi_e, _ = unc.interval_energy(X, en, bucket, classes)
        lo_t, hi_t, _ = unc.interval_latency(X, lat, bucket, classes)
        return {"latency": (float(lo_t.sum()), float(hi_t.sum())),
                "energy": (float(lo_e.sum()), float(hi_e.sum()))}

    def take_interval_outside(self):
        """Per-op outside-interval mask of the last ``feedback_batch`` (the
        interval-drift trigger); None without an attached model."""
        return (None if self.uncertainty is None
                else self.uncertainty.take_outside())

    def take_interval_stats(self):
        """Last ``feedback_batch``'s coverage/width tallies for ledger
        counters; None without an attached model."""
        return (None if self.uncertainty is None
                else self.uncertainty.take_stats())

    def feedback(self, op: OpNode, alpha: float, prev_alpha: float,
                 obs_state: DeviceState, observed_lat: float, observed_en: float):
        x = op_features(op, alpha, prev_alpha, obs_state)
        gb_e = float(self.energy_model.predict(x[None])[0])
        gb_t = float(self.latency_model.predict(x[None])[0])
        self._record(x, gb_e, gb_t, observed_lat, observed_en)

    def _record(self, x, gb_e, gb_t, observed_lat, observed_en):
        if self.use_gru:
            self.gru_e.record(x, gb_e, observed_en)
            self.gru_t.record(x, gb_t, observed_lat)
            self._n_feedback += 1
            # the correction is a function of the feedback window, so every
            # recorded observation can shift predictions -> stamp a new
            # version (cost-table / plan caches key on it)
            self._version += 1
            if self._n_feedback % 8 == 0:
                self.gru_e.train_steps(6)
                self.gru_t.train_steps(6)

    def feedback_batch(self, items, obs_state, observed_lats, observed_ens):
        """Vectorised per-inference feedback + drift computation.
        Returns per-op relative energy drift (the re-partition trigger)."""
        ops = [it[0] for it in items]
        alphas = np.fromiter((it[1] for it in items), np.float64, len(items))
        prevs = np.fromiter((it[2] for it in items), np.float64, len(items))
        X = op_features_batch(ops, alphas, prevs, obs_state)
        gb_e = self.energy_model.predict(X)
        gb_t = self.latency_model.predict(X)
        ce, ct = self._corrections()
        drift = np.abs(np.asarray(observed_ens) - gb_e * ce) / np.maximum(gb_e * ce, 1e-12)
        if self.uncertainty is not None:
            # prequential interval accounting + online conformal update,
            # centered on the same corrected predictions decisions use;
            # keyed per (state bucket, op class) so each operator class
            # calibrates its own quantile
            self.uncertainty.observe_batch(
                X, gb_t * ct, gb_e * ce, observed_lats, observed_ens,
                bucket=state_bucket(obs_state),
                op_classes=[op.op_type for op in ops])
        for j in range(len(items)):
            self._record(X[j], float(gb_e[j]), float(gb_t[j]),
                         float(observed_lats[j]), float(observed_ens[j]))
        return drift

    def drift(self, op, alpha, prev_alpha, obs_state, observed_en) -> float:
        """Relative energy prediction error — the re-partition trigger."""
        _, pred = self.predict(op, alpha, prev_alpha, obs_state)
        return abs(observed_en - pred) / max(pred, 1e-12)
