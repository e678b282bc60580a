"""Contention-aware joint planning of the PyTorch port (``repro_torch.core.
coexec``, ``core.baselines``) against the JAX package on the same graphs,
profilers and seeds.

Both packages run the same numpy code, and the profilers here have no GRU
(``use_gru=False``), so every number must agree exactly: rail loads,
predicted rail fractions, contended costs and cache keys bit for bit, plan
alphas equal and plan totals to rtol 1e-12, contention corrections,
versions and cache counters equal. Each test is the port's counterpart of
one state-free test of ``tests/test_coexec.py`` (lines 58-327 and 446): it
runs that test's scenario in both packages, holds the port to the JAX
result, and keeps the original's own assertions on the port. Left out are
the tests at ``tests/test_coexec.py:329-436``: three of the benchmark
baseline gate (``benchmarks/baseline_gate.py``) and five of the docs
checker (``tools/check_docs.py``), tooling of the JAX package's repo that
the port does not carry."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import coexec as jax_coexec  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.core import opgraph as jax_opgraph  # noqa: E402
from repro.core import partitioner as jax_part  # noqa: E402
from repro.core import profiler as jax_prof  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro.serving import scheduler as jax_sched  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.core import baselines, coexec, controller, opgraph, partitioner  # noqa: E402
from repro_torch.core import profiler, simulator  # noqa: E402
from repro_torch.core.coexec import FULL_DUTY, RAILS, RailLoad  # noqa: E402
from repro_torch.serving import scheduler  # noqa: E402

PLAN_RTOL = 1e-12


class Side:
    """One package's modules under common names."""

    def __init__(self, port):
        self.port = port
        (self.opgraph, self.coexec, self.part, self.prof, self.sim, self.controller,
         self.baselines, self.sched, self.configs) = (
            (opgraph, coexec, partitioner, profiler, simulator, controller, baselines,
             scheduler, configs) if port else
            (jax_opgraph, jax_coexec, jax_part, jax_prof, jax_sim, jax_controller,
             jax_baselines, jax_sched, jax_configs))


PORT, JAX = Side(True), Side(False)


def _graphs(s):
    ga = s.opgraph.build_yolo_graph(batch=1)
    gb = s.opgraph.OpGraph(name="yolo_b2", nodes=s.opgraph.build_yolo_graph(batch=2).nodes)
    return ga, gb


@pytest.fixture(scope="module")
def sides():
    """(side, (ga, gb), calibrated no-GRU profiler) per package, as
    tests/test_coexec.py's fixtures build them."""
    out = {}
    for s in (PORT, JAX):
        g = _graphs(s)
        prof = s.prof.RuntimeEnergyProfiler(use_gru=False, seed=0)
        prof.offline_calibrate(list(g), n_samples=200, seed=0)
        out[s.port] = (s, g, prof)
    return out


def _each(sides):
    return sides[True], sides[False]


def _cost(s, prof, preset="moderate", seed=0):
    return prof.cost_fn(s.sim.DeviceSim(preset, seed=seed).observe())


def _exec_all(sim, graph, alphas):
    lat = en = 0.0
    prev = alphas[0]
    for op, a in zip(graph.nodes, alphas):
        l, eb = sim.exec_op_rails(op, float(a), float(prev))
        lat += l
        en += eb.total_j
        prev = a
        sim.step(l)
    return lat, en


def _same_plan(a, b):
    np.testing.assert_array_equal(a.alphas, b.alphas)
    np.testing.assert_allclose([a.pred_energy, a.pred_latency],
                               [b.pred_energy, b.pred_latency], rtol=PLAN_RTOL, atol=0)


# ---------------------------------------------------------------------------
# DeviceSim.set_coexec physics (the port's simulator under co-runners)
# ---------------------------------------------------------------------------


def test_set_coexec_one_is_bit_identical_noop(sides):
    res = {}
    for s, (ga, _), _ in _each(sides):
        alphas = np.full(len(ga.nodes), 0.5)
        a = s.sim.DeviceSim("moderate", seed=0)
        b = s.sim.DeviceSim("moderate", seed=0)
        b.set_coexec(1)  # declaring the single-task setting must change nothing
        res[s.port] = _exec_all(a, ga, alphas)
        assert res[s.port] == _exec_all(b, ga, alphas)
    assert res[True] == res[False]


def test_set_coexec_contention_monotone_in_n(sides):
    res = {}
    for s, (ga, _), _ in _each(sides):
        alphas = np.full(len(ga.nodes), 0.5)  # every op split: bus traffic exists
        out = []
        for n in (1, 2, 4):
            sim = s.sim.DeviceSim("moderate", seed=0)
            sim.set_coexec(n)
            out.append(_exec_all(sim, ga, alphas))
        (l1, e1), (l2, e2), (l4, e4) = out
        assert l1 < l2 < l4, "co-runners must strictly slow a split plan"
        assert e1 < e2 < e4, "co-runners must strictly cost a split plan energy"
        res[s.port] = out
    assert res[True] == res[False]


# ---------------------------------------------------------------------------
# RailLoad / plan_rail_load / combine_loads
# ---------------------------------------------------------------------------


def test_plan_rail_load_ranges_and_extremes(sides):
    (tp, (tg, _), _), (jp, (jg, _), _) = _each(sides)
    n = len(tg.nodes)
    r = np.random.default_rng(0)
    for alphas in (np.zeros(n), np.ones(n), np.full(n, 0.5), r.choice(partitioner.ALPHA_LEVELS, n)):
        load = coexec.plan_rail_load(tg, alphas)
        ref = jax_coexec.plan_rail_load(jg, alphas)
        assert (load.cpu, load.gpu, load.bus) == (ref.cpu, ref.gpu, ref.bus)
        for v in (load.cpu, load.gpu, load.bus):
            assert 0.0 <= v <= 1.0
        assert load.cpu + load.gpu == pytest.approx(1.0)
    assert coexec.plan_rail_load(tg, np.ones(n)).gpu == pytest.approx(1.0)
    assert coexec.plan_rail_load(tg, np.zeros(n)).bus == 0.0
    assert coexec.plan_rail_load(tg, np.full(n, 0.5)).bus > 0.0
    assert coexec.plan_rail_load(tg, np.array([])) == RailLoad()


def test_combine_loads_saturates():
    for a in (RailLoad(0.7, 0.6, 0.9), RailLoad(0.2, 0.3, 0.1)):
        c = coexec.combine_loads([a, a])
        ref = jax_coexec.combine_loads([jax_coexec.RailLoad(a.cpu, a.gpu, a.bus)] * 2)
        assert (c.cpu, c.gpu, c.bus) == (ref.cpu, ref.gpu, ref.bus)
    c = coexec.combine_loads([RailLoad(0.7, 0.6, 0.9)] * 2)
    assert (c.cpu, c.gpu, c.bus) == (1.0, 1.0, 1.0)
    assert coexec.combine_loads([]) == RailLoad()
    assert RAILS == jax_coexec.RAILS
    assert (FULL_DUTY.cpu, FULL_DUTY.gpu, FULL_DUTY.bus) == (
        jax_coexec.FULL_DUTY.cpu, jax_coexec.FULL_DUTY.gpu, jax_coexec.FULL_DUTY.bus)


# ---------------------------------------------------------------------------
# ContentionModel pricing
# ---------------------------------------------------------------------------


def test_wrap_single_resident_returns_base_unchanged(sides):
    for s, _, prof in _each(sides):
        cost_fn = _cost(s, prof)
        model = s.coexec.ContentionModel()
        assert model.wrap(cost_fn, 1, s.coexec.FULL_DUTY) is cost_fn
        assert model.wrap(cost_fn, 0, s.coexec.FULL_DUTY) is cost_fn


def test_contended_cost_never_cheaper_and_batches_agree(sides):
    res = {}
    for s, (ga, _), prof in _each(sides):
        cost_fn = _cost(s, prof)
        wrapped = s.coexec.ContentionModel().wrap(cost_fn, 3, s.coexec.FULL_DUTY)
        items = [(op, a, p) for op in ga.nodes[:8]
                 for a, p in ((0.0, 0.0), (1.0, 1.0), (0.5, 0.0), (1.0, 0.0))]
        single = []
        for op, a, p in items:
            l0, e0 = cost_fn(op, a, p)
            l1, e1 = wrapped(op, a, p)
            assert l1 >= l0 and e1 >= e0
            single.append((l1, e1))
        lb, eb = wrapped.batch(items)
        for j, (l1, e1) in enumerate(single):
            assert lb[j] == pytest.approx(l1) and eb[j] == pytest.approx(e1)
        ops = ga.nodes[:8]
        alphas = np.tile([0.0, 1.0, 0.5, 1.0], len(ops))
        prevs = np.tile([0.0, 1.0, 0.0, 0.0], len(ops))
        lc, ec = wrapped.batch_cols(ops, [4] * len(ops), alphas, prevs)
        np.testing.assert_allclose(lc, lb, rtol=1e-12)
        np.testing.assert_allclose(ec, eb, rtol=1e-12)
        res[s.port] = (single, lb, eb, lc, ec)
    t, j = res[True], res[False]
    assert t[0] == j[0]
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(a, b)


def test_contended_cache_key_scopes_contention(sides):
    keys = {}
    for s, _, prof in _each(sides):
        cost_fn = _cost(s, prof)
        model = s.coexec.ContentionModel()
        k2 = model.wrap(cost_fn, 2, s.coexec.FULL_DUTY).cache_key()
        k3 = model.wrap(cost_fn, 3, s.coexec.FULL_DUTY).cache_key()
        assert k2 != k3
        assert k2[0] == cost_fn.cache_key()  # extends, never replaces, the base
        model.corrections["bus"] = 2.0
        model._version += 1
        k2b = model.wrap(cost_fn, 2, s.coexec.FULL_DUTY).cache_key()
        assert k2b != k2
        keys[s.port] = (k2, k3, k2b)
    assert keys[True] == keys[False]


# ---------------------------------------------------------------------------
# observe(): ledger feedback with hysteresis
# ---------------------------------------------------------------------------


def _observe_trace(m):
    out = [m.observe((0.4, 0.5, 0.1), (0.41, 0.49, 0.1))]
    for _ in range(6):
        out.append(m.observe((0.6, 0.35, 0.05), (0.2, 0.75, 0.05)))
    return out, dict(m.corrections), dict(m._resid_ema), m.version(), m.observations


def test_observe_hysteresis_and_version_bump():
    m = coexec.ContentionModel()
    v0 = m.version()
    # small residuals: EMA stays under the hysteresis, nothing moves
    assert m.observe((0.4, 0.5, 0.1), (0.41, 0.49, 0.1)) is False
    assert m.version() == v0 and all(m.corrections[r] == 1.0 for r in RAILS)
    # sustained large divergence crosses the hysteresis and applies
    changed = False
    for _ in range(6):
        changed = m.observe((0.6, 0.35, 0.05), (0.2, 0.75, 0.05)) or changed
    assert changed and m.version() > v0
    assert m.corrections["cpu"] < 1.0 < m.corrections["gpu"]
    lo, hi = m.correction_bounds
    assert all(lo <= m.corrections[r] <= hi for r in RAILS)
    assert _observe_trace(coexec.ContentionModel()) == _observe_trace(
        jax_coexec.ContentionModel())


def test_observe_accepts_dict_and_rejects_empty():
    res = {}
    for mod in (coexec, jax_coexec):
        m = mod.ContentionModel()
        assert m.observe(None, (0.3, 0.3, 0.4)) is False
        assert m.observe((0.3, 0.3, 0.4), {"cpu": 0.0, "gpu": 0.0, "bus": 0.0}) is False
        for _ in range(6):
            m.observe((0.6, 0.35, 0.05), {"cpu": 0.1, "gpu": 0.85, "bus": 0.05})
        assert m.corrections["cpu"] < 1.0
        res[mod is coexec] = (dict(m.corrections), m.version(), m.observations)
    assert res[True] == res[False]


# ---------------------------------------------------------------------------
# joint_partition: fallback bit-identity + honest accounting
# ---------------------------------------------------------------------------


def test_joint_partition_fallback_bit_identical(sides):
    res = {}
    for s, (ga, gb), prof in _each(sides):
        cost_fn = _cost(s, prof)
        indep = {g.name: s.part.dp_partition(g, cost_fn, objective="edp") for g in (ga, gb)}
        for kwargs in (dict(model=None), dict(model=s.coexec.ContentionModel(), n_resident=1)):
            plans = s.coexec.joint_partition([ga, gb], cost_fn, **kwargs)
            for g in (ga, gb):
                assert np.array_equal(plans[g.name].alphas, indep[g.name].alphas)
                assert plans[g.name].pred_energy == indep[g.name].pred_energy
                assert plans[g.name].pred_latency == indep[g.name].pred_latency
        single = s.coexec.joint_partition([ga], cost_fn, model=s.coexec.ContentionModel(),
                                          n_resident=4)
        assert np.array_equal(single[ga.name].alphas, indep[ga.name].alphas)
        res[s.port] = indep
    for name in res[True]:
        _same_plan(res[True][name], res[False][name])


def test_joint_plans_scored_on_base_predictor(sides):
    res = {}
    for s, (ga, gb), prof in _each(sides):
        cost_fn = _cost(s, prof)
        for n in (2, 3):
            plans = s.coexec.joint_partition([ga, gb], cost_fn, model=s.coexec.ContentionModel(),
                                             n_resident=n)
            for g in (ga, gb):
                rescored = s.part.score_plan(g, plans[g.name].alphas, cost_fn)
                assert plans[g.name].pred_energy == rescored.pred_energy
                assert plans[g.name].pred_latency == rescored.pred_latency
            res[(s.port, n)] = plans
    for n in (2, 3):
        for name, plan in res[(True, n)].items():
            _same_plan(plan, res[(False, n)][name])


def test_joint_partition_couples_plans_under_asymmetric_corrections(sides):
    """A ledger-corrected (asymmetric) contention model: the coordinate
    descent's rounds and objectives agree between the packages."""
    res = {}
    for s, (ga, gb), prof in _each(sides):
        cost_fn = _cost(s, prof, "high", 3)
        model = s.coexec.ContentionModel()
        model.corrections.update(cpu=0.5, gpu=3.0, bus=4.0)
        for objective in ("edp", "energy", "latency"):
            for rounds in (1, 3):
                res[(s.port, objective, rounds)] = s.coexec.joint_partition(
                    [ga, gb], cost_fn, model=model, n_resident=3, objective=objective,
                    rounds=rounds)
    for key, plans in res.items():
        if key[0]:
            for name, plan in plans.items():
                _same_plan(plan, res[(False,) + key[1:]][name])


# ---------------------------------------------------------------------------
# CoexecPlanner cache + rails stamp
# ---------------------------------------------------------------------------


def test_planner_cache_and_version_invalidation(sides):
    res = {}
    for s, (ga, gb), prof in _each(sides):
        cost_fn = _cost(s, prof)
        pl = s.coexec.CoexecPlanner()
        p1 = pl.plans([ga, gb], cost_fn, n_resident=2, fault_epoch=0)
        assert pl.cache_misses == 1
        p2 = pl.plans([ga, gb], cost_fn, n_resident=2, fault_epoch=0)
        assert p2[ga.name] is p1[ga.name] and pl.cache_hits == 1
        assert pl.plans([ga, gb], cost_fn, n_resident=2, fault_epoch=1)[ga.name] \
            is not p1[ga.name]  # fault transitions miss
        pl.model._version += 1  # contention correction applied
        p3 = pl.plans([ga, gb], cost_fn, n_resident=2, fault_epoch=0)
        assert p3[ga.name] is not p1[ga.name]
        # another resident count or another state bucket misses too
        assert pl.plans([ga, gb], cost_fn, n_resident=3)[ga.name] is not p3[ga.name]
        assert pl.plans([ga, gb], _cost(s, prof, "high", 5), n_resident=2)[ga.name] \
            is not p3[ga.name]
        rails = p1[ga.name].coexec_rails
        assert rails is not None and sum(rails) == pytest.approx(1.0)
        res[s.port] = (p1, (pl.cache_hits, pl.cache_misses), list(pl._cache))
    (tp1, tcount, tkeys), (jp1, jcount, jkeys) = res[True], res[False]
    assert tcount == jcount and tkeys == jkeys
    for name in tp1:
        _same_plan(tp1[name], jp1[name])
        assert tp1[name].coexec_rails == jp1[name].coexec_rails


def test_planner_skips_cache_without_cache_key(sides):
    res = {}
    for s, (ga, gb), _ in _each(sides):

        def plain_cost(op, a, p):  # no cache_key/table_cache protocol
            return 1e-4 * (1.0 + a), 1e-5 * (2.0 - a)

        pl = s.coexec.CoexecPlanner()
        first = pl.plans([ga, gb], plain_cost, n_resident=2)
        pl.plans([ga, gb], plain_cost, n_resident=2)
        assert pl.cache_hits == 0 and len(pl._cache) == 0 and pl.cache_misses == 2
        res[s.port] = first
    for name in res[True]:
        _same_plan(res[True][name], res[False][name])


# ---------------------------------------------------------------------------
# controller wiring: joint predictions reconcile with the measured ledger
# ---------------------------------------------------------------------------


def _ledger(sim):
    return [(e.kind, e.model, e.latency_s, e.energy.total_j, e.energy.cpu_j, e.energy.gpu_j,
             e.energy.bus_j) for e in sim.ledger.events]


def test_run_concurrent_joint_rails_reconcile_with_ledger(sides):
    res = {}
    for s, (ga, gb), prof in _each(sides):
        sim = s.sim.DeviceSim("moderate", seed=0)
        ctl = s.controller.AdaOperController(sim, prof, objective="edp",
                                             coexec=s.coexec.CoexecPlanner())
        ctl.run_concurrent([ga, gb], iters=6)
        infers = [ev for ev in sim.ledger.events if ev.kind == "infer"]
        assert len(infers) == 12
        # the planner's nominal-constants rail prediction must land in the
        # same neighborhood as the measured attribution
        for name in (ga.name, gb.name):
            pred = ctl.plans[name].coexec_rails
            assert pred is not None
            meas = [ev.energy.fractions() for ev in infers
                    if ev.model == name and ev.energy.fractions()]
            mean = np.mean(np.array(meas), axis=0)
            assert np.abs(np.array(pred) - mean).max() < 0.3, (pred, tuple(mean))
        res[s.port] = (ctl, sim)
    (tc, ts), (jc, js) = res[True], res[False]
    assert _ledger(ts) == _ledger(js)
    assert ts.ledger.counters == js.ledger.counters
    assert (tc.coexec.cache_hits, tc.coexec.cache_misses) == (jc.coexec.cache_hits,
                                                              jc.coexec.cache_misses)
    assert tc.coexec.model.corrections == jc.coexec.model.corrections
    assert tc.coexec.model.version() == jc.coexec.model.version()
    for name in tc.plans:
        _same_plan(tc.plans[name], jc.plans[name])
        assert tc.plans[name].coexec_rails == jc.plans[name].coexec_rails


def test_run_concurrent_without_planner_keeps_plans_unstamped(sides):
    res = {}
    for s, (ga, gb), prof in _each(sides):
        sim = s.sim.DeviceSim("moderate", seed=0)
        ctl = s.controller.AdaOperController(sim, prof, objective="edp")
        ctl.run_concurrent([ga, gb], iters=2)
        assert getattr(ctl.plans[ga.name], "coexec_rails", None) is None
        assert "coexec_corrections" not in sim.ledger.counters
        assert sim.coexec == 1 and ctl._resident == {}  # restored after the run
        res[s.port] = sim
    assert _ledger(res[True]) == _ledger(res[False])
    assert res[True].ledger.counters == res[False].ledger.counters


# ---------------------------------------------------------------------------
# serving scheduler wiring
# ---------------------------------------------------------------------------


def test_scheduler_joint_keying_and_single_resident_fallback(sides):
    res = {}
    for s, _, prof in _each(sides):
        sim = s.sim.DeviceSim("moderate", seed=0)
        sched = s.sched.AdaOperScheduler(prof, sim, coexec=s.coexec.CoexecPlanner())
        cost_fn = prof.cost_fn(sim.observe())
        # single resident: the base callable and an empty key — bit-identical
        assert sched.set_resident(("m1",)) is True
        c1, k1 = sched._coexec_cost(cost_fn)
        assert c1 is cost_fn and k1 == ()
        # two resident: contention-wrapped, key carries set + n + version
        assert sched.set_resident(("m1", "m2")) is True
        assert sched.set_resident(("m2", "m1")) is False  # order-insensitive
        c2, k2 = sched._coexec_cost(cost_fn)
        assert c2 is not cost_fn and ("m1", "m2") in k2
        sim.set_coexec(3)  # the sim's declared level wins when it is larger
        c3, k3 = sched._coexec_cost(cost_fn)
        assert c3.n == 3 and k3[2] == 3
        # no planner attached: always the base path
        plain = s.sched.AdaOperScheduler(prof, sim)
        plain.set_resident(("m1", "m2"))
        c4, k4 = plain._coexec_cost(cost_fn)
        assert c4 is cost_fn and k4 == ()
        res[s.port] = (k2, k3, c2.cache_key(), c3.cache_key())
    assert res[True] == res[False]


def test_scheduler_joint_plan_rescored_on_base(sides):
    res = {}
    for s, _, prof in _each(sides):
        cfg = s.configs.reduced(s.configs.get_config("tinyllama-1.1b"))
        sim = s.sim.DeviceSim("moderate", seed=0)
        sched = s.sched.AdaOperScheduler(prof, sim, coexec=s.coexec.CoexecPlanner())
        sched.set_resident(("a", "b"))
        obs = sim.observe()
        cost_fn = prof.cost_fn(obs)
        ent = sched._plan_one(cfg, 2, 32, "prefill", cost_fn, sched._cache_key(obs))
        g = sched._graph(cfg, 2, 32, "prefill")
        base = s.part.score_plan(g, ent.alphas, cost_fn)
        assert ent.pred_energy == base.pred_energy  # accounting on base predictor
        assert ent.pred_latency == base.pred_latency
        res[s.port] = (ent, list(sched._plan_cache))
    _same_plan(res[True][0], res[False][0])
    assert res[True][0].rail_fractions == res[False][0].rail_fractions
    assert res[True][1] == res[False][1]


# ---------------------------------------------------------------------------
# predicted_rail_fractions edge cases
# ---------------------------------------------------------------------------


def test_predicted_rail_fractions_extremes(sides):
    (_, (tg, _), _), (_, (jg, _), _) = _each(sides)
    n = len(tg.nodes)
    r = np.random.default_rng(1)
    for alphas in (np.ones(n), np.zeros(n), np.full(n, 0.5),
                   r.choice(partitioner.ALPHA_LEVELS, n), np.array([])):
        assert coexec.predicted_rail_fractions(tg, alphas) == \
            jax_coexec.predicted_rail_fractions(jg, alphas)
    all_gpu = coexec.predicted_rail_fractions(tg, np.ones(n))
    assert all_gpu[1] > 0.5 and all_gpu[2] == 0.0  # gpu-dominant, no bus
    all_cpu = coexec.predicted_rail_fractions(tg, np.zeros(n))
    assert all_cpu[0] > 0.5
    split = coexec.predicted_rail_fractions(tg, np.full(n, 0.5))
    assert split[2] > 0.0
    assert coexec.predicted_rail_fractions(tg, np.array([])) is None


# ---------------------------------------------------------------------------
# baselines (the paper's Fig. 2 comparison)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["idle", "moderate", "high"])
def test_mace_and_codl_plans_match_jax(sides, preset):
    (_, (tg, tgb), _), (_, (jg, jgb), _) = _each(sides)
    for t, j in ((tg, jg), (tgb, jgb)):
        m = baselines.mace_gpu_plan(t)
        assert np.array_equal(m.alphas, np.ones(len(t))) and m.pred_energy == 0.0
        _same_plan(m, jax_baselines.mace_gpu_plan(j))
        _same_plan(baselines.codl_plan(t, calibration_preset=preset),
                   jax_baselines.codl_plan(j, calibration_preset=preset))
        obs = simulator.DeviceSim("high", seed=9).observe()
        jobs = jax_sim.DeviceSim("high", seed=9).observe()
        plan = baselines.codl_plan(t, obs, calibration_preset=preset)
        _same_plan(plan, jax_baselines.codl_plan(j, jobs, calibration_preset=preset))
        assert np.isfinite(plan.pred_latency) and plan.pred_latency > 0.0
