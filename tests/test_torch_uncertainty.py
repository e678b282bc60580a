"""The uncertainty layer of the PyTorch port (``repro_torch.uncertainty``,
``core.gbdt.fit_ensemble`` and the hooks in the profiler, the scheduler,
admission and planning) against the JAX package's: the same seeded numpy
inputs through both, and the quantiles, intervals, coverage tallies and
calibration versions must be identical. Then the scheduled engine with
``risk_level=0.9`` on reduced models: the same admission log, ledger
counters (``interval_repartitions`` among them) and tokens as the JAX
engine's."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import DeviceSim as JaxSim  # noqa: E402
from repro.core import RuntimeEnergyProfiler as JaxProfiler  # noqa: E402
from repro.core import build_transformer_graph as jax_graph  # noqa: E402
from repro.core import build_yolo_graph as jax_yolo  # noqa: E402
from repro.core.controller import AdaOperController as JaxController  # noqa: E402
from repro.core.gbdt import fit_ensemble as jax_fit_ensemble  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.admission import AdmissionPolicy as JaxPolicy  # noqa: E402
from repro.serving.engine import AdaOperScheduler as JaxScheduler  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.uncertainty import SplitConformal as JaxConformal  # noqa: E402
from repro.uncertainty import UncertaintyModel as JaxModel  # noqa: E402
from repro.uncertainty import conformal_quantile as jax_quantile  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.controller import AdaOperController  # noqa: E402
from repro_torch.core.gbdt import _MEMBER_SEED_STRIDE, fit_ensemble  # noqa: E402
from repro_torch.core.opgraph import build_transformer_graph, build_yolo_graph  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler, state_bucket  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.serving.admission import AdmissionPolicy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import AdaOperScheduler  # noqa: E402
from repro_torch.serving.slots import Request  # noqa: E402
from repro_torch.uncertainty import SplitConformal, UncertaintyModel, conformal_quantile  # noqa: E402,E501

OP_CLASSES = ("matmul", "attention", "conv", "embed")


def _synthetic(seed, n=240, d=5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d))
    scale = 0.05 + 0.3 * X[:, 1]
    y_e = np.abs(np.exp(X[:, 0]) + rng.normal(0, scale))
    y_t = np.abs(1.0 + X[:, 2] + rng.normal(0, scale))
    return X, y_e, y_t


# ---------------------------------------------------------------------------
# conformal calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conformal_quantile_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 5, 9, 24, 100):
        scores = rng.exponential(1.0, n)
        for cov in (0.5, 0.8, 0.9, 0.95, 0.99):
            assert conformal_quantile(scores, cov) == jax_quantile(scores, cov)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_conformal_stream_matches_jax(seed):
    """A seeded stream of observations — whole batches to one bucket, per-row
    bucket keys, and the global ring alone — gives the same committed
    quantile per key and the same version after every call."""
    rng = np.random.default_rng(seed)
    kw = dict(coverage=0.9, capacity=64, min_scores=12, recalib_every=8, q_max=6.0)
    t, j = SplitConformal(**kw), JaxConformal(**kw)
    keys = [None, ("b0",), ("b1",), (("b0",), "conv"), (("b1",), "matmul")]
    for step in range(60):
        n = int(rng.integers(1, 20))
        scores = rng.gamma(2.0, 0.5 + step / 40, n)
        how = step % 3
        if how == 0:
            b = keys[int(rng.integers(len(keys)))]
            t.observe(scores, b)
            j.observe(scores, b)
        elif how == 1:
            rows = [keys[int(i)] for i in rng.integers(1, len(keys), n)]
            t.observe(scores, buckets=rows)
            j.observe(scores, buckets=rows)
        else:
            t.observe(scores)
            j.observe(scores)
        assert t.version == j.version and t.n_scores() == j.n_scores()
        assert [t.quantile(k) for k in keys] == [j.quantile(k) for k in keys]
    assert t.version > 2
    with pytest.raises(ValueError, match="buckets has"):
        t.observe([1.0, 2.0], buckets=[("b0",)])


# ---------------------------------------------------------------------------
# the spread ensemble and the uncertainty model
# ---------------------------------------------------------------------------


def test_fit_ensemble_matches_jax():
    X, ye, _ = _synthetic(3)
    tm = fit_ensemble(X, ye, 3, seed=11, n_estimators=20)
    jm = jax_fit_ensemble(X, ye, 3, seed=11, n_estimators=20)
    assert _MEMBER_SEED_STRIDE == 7919
    assert [m.seed for m in tm] == [m.seed for m in jm] == [11 + 7919 * i for i in (1, 2, 3)]
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.predict(X), b.predict(X))


@pytest.mark.parametrize("classes", [False, True], ids=["single-bucket", "per-class"])
def test_uncertainty_model_stream_matches_jax(classes):
    """The seeded half-split fit, then a prequential feedback stream with
    and without per-row op classes: identical intervals (energy and
    latency), outside masks, batch stats, coverage tallies (per class too),
    widths and ``calibration_version`` after every batch."""
    X, ye, yt = _synthetic(4, n=360)
    kw = dict(seed=5, n_members=3, n_estimators=25, min_scores=16, recalib_every=8)
    t = UncertaintyModel(**kw).fit(X[:200], ye[:200], yt[:200])
    j = JaxModel(**kw).fit(X[:200], ye[:200], yt[:200])
    assert t.conformal_e.n_scores() == j.conformal_e.n_scores() == 100
    rng = np.random.default_rng(6)
    versions = []
    for i in range(200, 360, 20):
        Xb = X[i:i + 20]
        ce = np.stack([m.predict(Xb) for m in t._e_members]).mean(0)
        ct = np.stack([m.predict(Xb) for m in t._t_members]).mean(0)
        bucket = (int(rng.integers(3)),)
        cls = ([OP_CLASSES[int(c)] for c in rng.integers(len(OP_CLASSES), size=20)]
               if classes else None)
        for fn in ("interval_energy", "interval_latency"):
            for a, b in zip(getattr(t, fn)(Xb, ce if fn == "interval_energy" else ct,
                                           bucket, cls),
                            getattr(j, fn)(Xb, ce if fn == "interval_energy" else ct,
                                           bucket, cls)):
                np.testing.assert_array_equal(a, b)
        noise = rng.normal(1.0, 0.3, 20)
        t.observe_batch(Xb, ct, ce, yt[i:i + 20] * noise, ye[i:i + 20] * noise, bucket, cls)
        j.observe_batch(Xb, ct, ce, yt[i:i + 20] * noise, ye[i:i + 20] * noise, bucket, cls)
        np.testing.assert_array_equal(t.take_outside(), j.take_outside())
        assert t.take_stats() == j.take_stats()
        assert t.take_outside() is None and t.take_stats() is None
        versions.append((t.calibration_version(), j.calibration_version()))
    assert all(a == b for a, b in versions) and versions[-1][0] > 0
    assert (t.n_obs, t.n_covered, t.width_sum_j) == (j.n_obs, j.n_covered, j.width_sum_j)
    assert t.empirical_coverage() == j.empirical_coverage()
    assert t.mean_width_j() == j.mean_width_j()
    assert t.coverage_per_class() == j.coverage_per_class()
    assert bool(t.coverage_per_class()) == classes
    with pytest.raises(ValueError, match="op_classes has"):
        t.interval_energy(X[:3], ye[:3], None, ["conv"])


# ---------------------------------------------------------------------------
# the profiler's hooks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def profilers():
    """(port, JAX) profilers with an uncertainty model attached, calibrated
    on the same YOLO graph and trace, and a point-only port profiler."""
    out = []
    for prof, model, graph in ((RuntimeEnergyProfiler, UncertaintyModel, build_yolo_graph),
                               (JaxProfiler, JaxModel, jax_yolo)):
        p = prof(use_gru=False, seed=0)
        assert p.attach_uncertainty(model(seed=0, n_estimators=30)) is p
        p.offline_calibrate([graph()], n_samples=400, seed=0)
        out.append(p)
    plain = RuntimeEnergyProfiler(use_gru=False, seed=0)
    plain.offline_calibrate([build_yolo_graph()], n_samples=400, seed=0)
    return out[0], out[1], plain


def test_profiler_plan_interval_and_feedback_match_jax(profilers):
    """``predict_plan_interval`` and ``cost_fn.plan_interval`` on the same
    plans and states; then feedback batches: the same correction version
    (folding in the calibration version) and interval tallies."""
    tp, jp, _ = profilers
    tg, jg = build_yolo_graph(), jax_yolo()
    ts, js = DeviceSim("moderate", seed=3), JaxSim("moderate", seed=3)
    rng = np.random.default_rng(7)
    for _ in range(6):
        ts.step(0.05, 0.5)
        js.step(0.05, 0.5)
        to, jo = ts.observe(), js.observe()
        assert state_bucket(to) == state_bucket(jo)
        alphas = rng.uniform(0, 1, len(tg.nodes))
        ti = tp.predict_plan_interval(tg, alphas, to)
        assert ti == jp.predict_plan_interval(jg, alphas, jo)
        assert ti["energy"][0] <= tp.predict_graph(tg, alphas, to)[1] <= ti["energy"][1]
        assert tp.cost_fn(to).plan_interval(tg, alphas) == jp.cost_fn(jo).plan_interval(
            jg, alphas)
        items_t = [(op, a, a) for op, a in zip(tg.nodes, alphas)]
        items_j = [(op, a, a) for op, a in zip(jg.nodes, alphas)]
        lats = rng.uniform(1e-4, 1e-2, len(items_t)).tolist()
        ens = rng.uniform(1e-4, 5e-2, len(items_t)).tolist()
        tp.feedback_batch(items_t, to, lats, ens)
        jp.feedback_batch(items_j, jo, lats, ens)
        assert tp.correction_version() == jp.correction_version()
        assert tp.uncertainty.take_stats() == jp.uncertainty.take_stats()
    assert tp.uncertainty.coverage_per_class() == jp.uncertainty.coverage_per_class()


def test_unattached_profiler_is_inert(profilers):
    """Attaching the model changes no point prediction and no plan; without
    it there is no plan interval."""
    tp, _, plain = profilers
    g = build_yolo_graph()
    obs = DeviceSim("moderate", seed=0).observe()
    alphas = np.full(len(g.nodes), 0.5)
    assert plain.predict_plan_interval(g, alphas, obs) is None
    fresh = RuntimeEnergyProfiler(use_gru=False, seed=0)
    fresh.attach_uncertainty(UncertaintyModel(seed=0, n_estimators=30))
    fresh.offline_calibrate([build_yolo_graph()], n_samples=400, seed=0)
    assert fresh.predict_graph(g, alphas, obs) == plain.predict_graph(g, alphas, obs)


def test_controller_interval_repartition_matches_jax():
    """The closed loop on a YOLO graph with an uncertainty model attached:
    the same repartitions and interval counters as the JAX controller."""
    out = []
    for prof, model, graph, sim, ctl in (
            (RuntimeEnergyProfiler, UncertaintyModel, build_yolo_graph, DeviceSim,
             AdaOperController),
            (JaxProfiler, JaxModel, jax_yolo, JaxSim, JaxController)):
        p = prof(use_gru=False, seed=1)
        p.attach_uncertainty(model(seed=1, n_estimators=25))
        g = graph()
        p.offline_calibrate([g], n_samples=300, seed=1)
        s = sim("high", seed=2)
        st = ctl(s, p).run_concurrent([g], iters=12)[g.name]
        out.append((dict(s.ledger.counters), st.latencies, st.energies, st.repartitions,
                    st.incremental, st.drift_events))
    assert out[0] == out[1]
    assert out[0][0].get("interval_observations", 0) > 0


# ---------------------------------------------------------------------------
# risk-priced admission and interval-exit drift in the engine
# ---------------------------------------------------------------------------


def _plan(lat, en, iv_lat=None, iv_en=None, batch=2):
    p = {"batch": batch, "step_latency": lat, "step_energy": en, "rails": None}
    if iv_lat is not None:
        p["interval"] = {"latency": iv_lat, "energy": iv_en}
    return p


@pytest.mark.parametrize("risk", [None, 0.0, 0.5, 0.9, 1.0])
def test_admission_decisions_match_jax(risk):
    """``decide`` and ``spec_decision`` on stamped and unstamped plans at
    every risk level: the same decisions and reasons."""
    rng = np.random.default_rng(8)
    for _ in range(40):
        lat, en = rng.uniform(1e-3, 1e-2, 2), rng.uniform(0.5, 3.0, 2)
        plans = {b: _plan(lat[k], en[k], (0.5 * lat[k], lat[k] * rng.uniform(1, 6)),
                          (0.5 * en[k], en[k] * rng.uniform(1, 3)), batch=2 * b)
                 for k, b in enumerate((2, 3))}
        if rng.random() < 0.3:
            del plans[3]["interval"]
        slo = float(rng.uniform(0.05, 0.5))
        fn = plans.__getitem__
        t = AdmissionPolicy(scheduler=object(), slo_s=slo, risk_level=risk)
        j = JaxPolicy(scheduler=object(), slo_s=slo, risk_level=risk)
        assert t.decide(None, 2, 64, 20, 0.0, plan_fn=fn) == j.decide(
            None, 2, 64, 20, 0.0, plan_fn=fn)
        k, alpha = int(rng.integers(1, 5)), float(rng.uniform(0.2, 0.95))
        assert t.spec_decision(plans[2], plans[3], k, alpha) == j.spec_decision(
            plans[2], plans[3], k, alpha)
        for which in ("latency", "energy"):
            assert t._risk(plans[3], which) == j._risk(plans[3], which)


ARCHS = ["tinyllama-1.1b", "mamba2-2.7b"]
MIXED = [(12, 4), (20, 6), (12, 2), (16, 5), (20, 1), (16, 6), (30, 3)]
MAX_LEN = 48


@pytest.fixture(scope="module")
def llms():
    out = {}
    for k, arch in enumerate(ARCHS):
        jcfg = jax_configs.reduced(jax_configs.get_config(arch))
        tcfg = configs.reduced(configs.get_config(arch))
        jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(k), jcfg)
        out[arch] = (jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return out


def _risk_engine(llms, port, legacy):
    graph, prof, sim, sched, model, eng = (
        (build_transformer_graph, RuntimeEnergyProfiler, DeviceSim, AdaOperScheduler,
         UncertaintyModel, ServingEngine) if port else
        (jax_graph, JaxProfiler, JaxSim, JaxScheduler, JaxModel, JaxEngine))
    p = prof(seed=0)
    # narrow intervals (coverage 0.2), so that the state's moves during the
    # serve take some re-priced plan out of its interval
    p.attach_uncertainty(model(seed=0, n_estimators=25, coverage=0.2, sigma_floor=0.01))
    p.offline_calibrate([graph(llms[a][2 if port else 0], 4, 40) for a in ARCHS],
                        n_samples=300)
    e = eng(scheduler=sched(p, sim("moderate", seed=0)), max_slots=4, slo_s=0.5,
            risk_level=0.9, legacy_drift=legacy)
    for k, arch in enumerate(ARCHS):
        jcfg, jp, tcfg, tp = llms[arch]
        cfg = tcfg if port else jcfg
        e.add_model(arch, cfg, tp if port else jp, max_len=MAX_LEN)
        r = np.random.default_rng(k)
        for i, (plen, mn) in enumerate(MIXED):
            e.submit(arch, (Request if port else JaxRequest)(
                100 * k + i, r.integers(1, cfg.vocab_size, plen, dtype=np.int32), mn))
    return e


@pytest.mark.parametrize("legacy", [False, True], ids=["interval-drift", "legacy-drift"])
def test_risk_priced_scheduled_engine_matches_jax(llms, legacy):
    """The scheduled engine under ``risk_level=0.9`` with an uncertainty
    model on its profiler: the same admission log, ledger counters
    (``interval_repartitions`` with interval drift, none with
    ``legacy_drift``), drift events, stamped plan intervals and tokens."""
    teng, jeng = _risk_engine(llms, True, legacy), _risk_engine(llms, False, legacy)
    tres = {r.uid: r for r in teng.run_all()}
    jres = {r.uid: r for r in jeng.run_all()}
    assert sorted(tres) == sorted(jres) and len(tres) == 2 * len(MIXED)
    for uid, r in jres.items():
        np.testing.assert_array_equal(tres[uid].tokens, r.tokens)
    assert teng.admission.log == jeng.admission.log
    assert teng.ledger.counters == jeng.ledger.counters
    assert teng.drift_events == jeng.drift_events
    stamped = [p for p in teng._plan_memo.values() if "interval" in p]
    assert stamped
    for key, plan in teng._plan_memo.items():
        assert plan.get("interval") == jeng._plan_memo[key].get("interval")
    iv = teng.ledger.counters.get("interval_repartitions", 0)
    assert (iv == 0) if legacy else (iv > 0)
