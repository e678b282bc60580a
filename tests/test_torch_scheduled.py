"""AdaOper-scheduled serving of the PyTorch port against the JAX engine:
reduced tinyllama-1.1b and mamba2-2.7b in one continuous engine under
``AdaOperScheduler`` with ``DeviceSim("moderate", seed=0)`` and no SLO, on
converted weights and the same requests. The numpy planning core is a copy,
and the port calls ``sim.observe()`` at the reference's points, so the
admission log, the ledger (kinds, models, n_active, simulated joules to
1e-9) and the plan-cache counters must match exactly; the greedy tokens
per uid must be identical, with independent planning and with
contention-aware joint planning (``coexec=CoexecPlanner()``). Then the
port's own scheduled-path invariants."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import CoexecPlanner as JaxCoexecPlanner  # noqa: E402
from repro.core import DeviceSim as JaxSim  # noqa: E402
from repro.core import RuntimeEnergyProfiler as JaxProfiler  # noqa: E402
from repro.core import build_transformer_graph as jax_graph  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.engine import AdaOperScheduler as JaxScheduler  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.coexec import CoexecPlanner  # noqa: E402
from repro_torch.core.opgraph import build_transformer_graph  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import AdaOperScheduler  # noqa: E402
from repro_torch.serving.slots import Request  # noqa: E402

ARCHS = ["tinyllama-1.1b", "mamba2-2.7b"]
# (prompt length, max_new_tokens): mamba2 groups key on the pow2 length
# bucket, so 12/16 share a 16-long masked prefill and 20/30 a 32-long one
MIXED = [(12, 4), (20, 6), (12, 2), (16, 5), (20, 1), (16, 6), (30, 3)]
MAX_LEN = 48
CALIB = 400  # offline calibration samples (the same trace on both sides)


@pytest.fixture(scope="module")
def models():
    out = {}
    for k, arch in enumerate(ARCHS):
        jcfg = jax_configs.reduced(jax_configs.get_config(arch))
        tcfg = configs.reduced(configs.get_config(arch))
        jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(k), jcfg)
        out[arch] = (jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return out


def _scheduler(models, port, preset="moderate", coexec=False):
    cfgs = [models[a][2 if port else 0] for a in ARCHS]
    graph, prof, sim, sched, planner = (
        (build_transformer_graph, RuntimeEnergyProfiler, DeviceSim, AdaOperScheduler,
         CoexecPlanner) if port else
        (jax_graph, JaxProfiler, JaxSim, JaxScheduler, JaxCoexecPlanner))
    p = prof(seed=0)
    p.offline_calibrate([graph(c, 4, 40) for c in cfgs], n_samples=CALIB)
    return sched(p, sim(preset, seed=0), coexec=planner() if coexec else None)


def _serve(eng, models, port):
    for k, arch in enumerate(ARCHS):
        jcfg, jp, tcfg, tp = models[arch]
        cfg, params = (tcfg, tp) if port else (jcfg, jp)
        eng.add_model(arch, cfg, params, max_len=MAX_LEN)
        r = np.random.default_rng(k)
        make = Request if port else JaxRequest
        for i, (plen, mn) in enumerate(MIXED):
            eng.submit(arch, make(100 * k + i, r.integers(1, cfg.vocab_size, plen,
                                                          dtype=np.int32), mn))
    return {r.uid: r for r in eng.run_all()}


def _events(eng):
    return [(e.kind, e.model, e.n_active, e.uid) for e in eng.ledger.events]


def _joint_keys(sched):
    return [k for k in sched._plan_cache if "coex" in k]


def _engines_match(models, coexec):
    jeng = JaxEngine(scheduler=_scheduler(models, port=False, coexec=coexec), max_slots=4)
    teng = ServingEngine(scheduler=_scheduler(models, port=True, coexec=coexec), max_slots=4)
    jres, tres = _serve(jeng, models, port=False), _serve(teng, models, port=True)
    assert sorted(tres) == sorted(jres) and len(tres) == 2 * len(MIXED)
    for uid, r in jres.items():
        assert tres[uid].error is None and r.error is None
        np.testing.assert_array_equal(tres[uid].tokens, r.tokens)
        np.testing.assert_allclose(tres[uid].energy_j_pred, r.energy_j_pred, rtol=1e-9)
    assert teng.admission.log == jeng.admission.log
    assert {e["reason"] for e in teng.admission.log} - {"idle-pool"}, \
        "the workload must exercise the energy-aware branch"
    assert _events(teng) == _events(jeng)
    for te, je in zip(teng.ledger.events, jeng.ledger.events):
        np.testing.assert_allclose([te.energy.total_j, te.energy.cpu_j, te.energy.gpu_j,
                                    te.energy.bus_j],
                                   [je.energy.total_j, je.energy.cpu_j, je.energy.gpu_j,
                                    je.energy.bus_j], rtol=1e-9, atol=0)
        if te.kind != "request":  # request latencies are wall time
            np.testing.assert_allclose(te.latency_s, je.latency_s, rtol=1e-9)
    assert teng.ledger.counters == jeng.ledger.counters
    tsch, jsch = teng.scheduler, jeng.scheduler
    assert (tsch.plan_cache_hits, tsch.plan_cache_misses) == (
        jsch.plan_cache_hits, jsch.plan_cache_misses)
    assert list(tsch._plan_cache) == list(jsch._plan_cache)
    joint = _joint_keys(tsch)
    if coexec:  # plans were solved under the joint key: both models resident
        assert joint and all(k[-4:-2] == ("coex", tuple(sorted(ARCHS))) for k in joint), joint
        assert {k[-2] for k in joint} == {2}
    else:
        assert joint == []
    assert teng.drift_events == jeng.drift_events
    assert teng.preemptions == jeng.preemptions
    assert teng.prefill_batches == jeng.prefill_batches
    # mamba2's mixed lengths went through left-padded, masked pow2 buckets
    assert teng.prefill_batch_requests == jeng.prefill_batch_requests
    assert teng.workers["mamba2-2.7b"].prefill_calls < len(MIXED)


def test_scheduled_engine_matches_jax_engine(models):
    _engines_match(models, coexec=False)


def test_joint_scheduled_engine_matches_jax_engine(models):
    """Contention-aware joint planning (``AdaOperScheduler(coexec=
    CoexecPlanner())``) with both models busy: the same tokens, admission
    log, ledger and plan-cache counters as the JAX engine, and plans solved
    under the joint key."""
    _engines_match(models, coexec=True)


def test_choose_matches_jax(models):
    """The scheduler's batch choice (prefill + decode plans, EDP per
    request) and its rail fractions on the same graphs and device state."""
    tsch, jsch = _scheduler(models, port=True), _scheduler(models, port=False)
    for arch in ARCHS:
        t = tsch.choose(models[arch][2], 5, 20, 6)
        j = jsch.choose(models[arch][0], 5, 20, 6)
        assert t["batch"] == j["batch"]
        np.testing.assert_array_equal(t["plan_decode"].alphas, j["plan_decode"].alphas)
        np.testing.assert_allclose([t["score"], t["latency"], t["energy"], *t["rails"]],
                                   [j["score"], j["latency"], j["energy"], *j["rails"]],
                                   rtol=1e-12)


def test_coexec_none_keeps_keys_and_plans(models):
    """``coexec=None`` with two models resident, and a planner with one,
    give the plain scheduler's cache keys, plans and choices bit for bit."""
    plain = _scheduler(models, port=True)
    none2 = _scheduler(models, port=True)
    none2.set_resident(ARCHS)
    joint1 = _scheduler(models, port=True, coexec=True)
    joint1.set_resident(ARCHS[:1])
    joint2 = _scheduler(models, port=True, coexec=True)
    joint2.set_resident(ARCHS)
    out = {}
    for name, sch in (("plain", plain), ("none2", none2), ("joint1", joint1),
                      ("joint2", joint2)):
        out[name] = [sch.choose(models[a][2], 5, 20, 6) for a in ARCHS] + [
            sch.step_plan(models[a][2], 3, 20, 6) for a in ARCHS] + [
            sch.prefill_plan(models[a][2], 2, 30) for a in ARCHS]
    for name in ("none2", "joint1"):
        sch = {"none2": none2, "joint1": joint1}[name]
        assert list(sch._plan_cache) == list(plain._plan_cache)
        assert (sch.plan_cache_hits, sch.plan_cache_misses) == (
            plain.plan_cache_hits, plain.plan_cache_misses)
        for a, b in zip(out[name], out["plain"]):
            assert a.keys() == b.keys()
            for k in a:
                if k.startswith("plan_"):
                    assert np.array_equal(a[k].alphas, b[k].alphas)
                    assert (a[k].pred_energy, a[k].pred_latency) == (
                        b[k].pred_energy, b[k].pred_latency)
                else:
                    assert a[k] == b[k], (name, k)
    # two resident under a planner: every key carries the joint suffix, and
    # the plans are priced under contention (re-scored on the base predictor)
    assert len(joint2._plan_cache) == len(plain._plan_cache)
    assert all(k[-4] == "coex" for k in joint2._plan_cache)
    assert [k[:-4] for k in joint2._plan_cache] == list(plain._plan_cache)


@pytest.mark.parametrize("coexec", [False, True], ids=["independent", "joint"])
def test_engine_clears_plan_memo_only_when_busy_set_moves_under_planner(models, coexec):
    """``_serve_round`` clears the engine's drift-scoped plan memo when the
    busy set changes and a coexec planner is attached, and only then; the
    JAX engine does the same on the same sequence of busy sets."""
    seq = [["a", "b"], ["b", "a"], ["a"], ["a"], ["a", "b"], []]
    res = {}
    for port in (True, False):
        eng = (ServingEngine if port else JaxEngine)(
            scheduler=_scheduler(models, port=port, coexec=coexec))
        eng.step_continuous = lambda *a, **k: []
        eng._drift_event = lambda: False
        cleared = []
        for busy in seq:
            eng._plan_memo["sentinel"] = 1
            eng._serve_round(busy, [])
            cleared.append("sentinel" not in eng._plan_memo)
            assert eng.scheduler.sim.coexec == max(1, len(busy))
        res[port] = cleared
    assert res[True] == res[False]
    want = [True, False, True, False, True, True] if coexec else [False] * len(seq)
    assert res[True] == want


@pytest.mark.parametrize("slo_s", [None, 1e-9, 1e-3, 10.0])
def test_admission_decisions_match_jax(models, slo_s):
    """Every branch of ``AdmissionPolicy.decide`` (idle pool, SLO
    starvation, SLO violation, EDP improves / worsens) decides as the JAX
    policy does on the same scheduler state."""
    from repro.serving.admission import AdmissionPolicy as JaxPolicy
    from repro_torch.serving.admission import AdmissionPolicy
    tsch, jsch = _scheduler(models, port=True), _scheduler(models, port=False)
    tpol, jpol = AdmissionPolicy(tsch, slo_s=slo_s), JaxPolicy(jsch, slo_s=slo_s)
    seen = set()
    for arch in ARCHS:
        for n_active in (0, 1, 3, 4, 7):
            for wait_s in (0.0, 5e-4, 20.0):
                t = tpol.decide(models[arch][2], n_active, 40, 16, wait_s)
                assert t == jpol.decide(models[arch][0], n_active, 40, 16, wait_s)
                seen.add(t[1])
    assert (tsch.plan_cache_hits, tsch.plan_cache_misses) == (
        jsch.plan_cache_hits, jsch.plan_cache_misses)
    assert "idle-pool" in seen and (slo_s is None or "slo-starvation" in seen)
    if slo_s == 1e-9:
        assert "slo-violation" in seen


def test_preemption_never_drops_admitted_requests(models):
    """A drift event every round: the lowest-priority worker is preempted
    while plans re-solve, but every admitted request completes with exactly
    its token budget (the port of the reference's preemption test)."""
    tiny, mamba = models["tinyllama-1.1b"][2:], models["mamba2-2.7b"][2:]
    prof = RuntimeEnergyProfiler(use_gru=False)
    prof.offline_calibrate([build_transformer_graph(tiny[0], 2, 32)], n_samples=600, seed=0)
    eng = ServingEngine(scheduler=AdaOperScheduler(prof, DeviceSim("high", seed=0)),
                        max_slots=3)
    eng.add_model("hi", *tiny, max_len=48, priority=1)
    eng.add_model("lo", *mamba, max_len=48, priority=0)
    eng._drift_event = lambda: True
    r = np.random.default_rng(11)
    n = 4
    for i in range(n):
        eng.submit("hi", Request(i, r.integers(1, tiny[0].vocab_size, 12, dtype=np.int32), 3))
        eng.submit("lo", Request(100 + i, r.integers(1, mamba[0].vocab_size, 16,
                                                     dtype=np.int32), 4))
    res = {x.uid: x for x in eng.run_all()}
    assert len(res) == 2 * n
    for i in range(n):
        assert res[i].tokens.shape == (3,) and res[100 + i].tokens.shape == (4,)
    assert eng.preemptions["hi"] == 0 and eng.preemptions["lo"] > 0
    assert eng.ledger.counters["preemptions"] == eng.preemptions["lo"]


def test_battery_critical_sheds_low_priority_waiters(models):
    """A simulated battery that dies during the first prefill flips
    ``battery_critical``: queued low-priority requests end in explicit
    ``shed`` errors, residents finish."""
    tiny = models["tinyllama-1.1b"][2:]
    prof = RuntimeEnergyProfiler(use_gru=False)
    prof.offline_calibrate([build_transformer_graph(tiny[0], 2, 32)], n_samples=300, seed=0)
    sim = DeviceSim("moderate", seed=0, battery_capacity_j=1e-9)
    eng = ServingEngine(scheduler=AdaOperScheduler(prof, sim), max_slots=1)
    eng.add_model("m", *tiny, max_len=48)
    for i in range(3):
        eng.submit("m", Request(i, np.full(8, i + 1, np.int32), 2))
    res = {x.uid: x for x in eng.run_all()}
    assert sim.battery_dead and res[0].error is None and res[0].tokens.shape == (2,)
    assert all("shed: battery critical" in res[i].error for i in (1, 2))
    assert eng.ledger.counters["shed"] == 2 and eng.ledger.counters["battery_dead"] == 1


def test_scheduled_serve_entry_point_on_cpu():
    """``repro_torch.launch.serve`` is scheduled by default: every request
    completes and the report carries the scheduler's decisions and the
    simulated joules per model and per rail."""
    report = serve_cli.main(["--device", "cpu", "--models", ",".join(ARCHS), "--requests", "3",
                             "--prompt-lens", "8,12", "--max-new", "3", "--max-slots", "2"])
    assert report["scheduler"] == "adaoper" and report["errors"] == 0
    assert report["requests"] == 6 and report["tokens"] == 18
    assert sum(report["admission_reasons"].values()) >= 6
    assert report["plan_cache"]["misses"] > 0
    energy = report["energy_j"]
    assert energy["label"] == "simulated (DeviceSim moderate)"
    assert set(energy["per_model"]) == set(ARCHS)
    assert sum(energy["per_rail"].values()) == pytest.approx(sum(energy["per_model"].values()))
    assert {"prefill", "decode", "request"} <= set(energy["events"])


def test_joint_planned_serve_through_the_api_on_cpu():
    """The serve that chip_smoke.py's joint phase drives, on reduced models:
    ``make_scheduler(coexec=True)`` + ``build_engine``. Every request
    completes and plans are solved under the joint key of both models; at
    these shapes the joint plans pick the independent ones' alphas, so the
    tokens, the admission log and the simulated joules equal the
    independent serve's."""
    cfgs = serve_cli.model_configs(ARCHS, full=False)
    out = {}
    for coexec in (True, False):
        sched = serve_cli.make_scheduler(cfgs.values(), 12, 3, "moderate", 0, coexec=coexec)
        eng = serve_cli.build_engine(ARCHS, 3, (8, 12), 3, 2, 64, 0, "cpu", scheduler=sched)
        res = {r.uid: r for r in eng.run_all()}
        assert len(res) == 6 and all(r.error is None and len(r.tokens) == 3
                                     for r in res.values())
        joint = [k for k in sched._plan_cache if "coex" in k]
        assert bool(joint) == coexec
        assert {k[-3] for k in joint} <= {tuple(sorted(ARCHS))}
        out[coexec] = (res, eng)
    (jres, jeng), (ires, ieng) = out[True], out[False]
    assert sorted(jres) == list(range(6))  # uids k * requests + i name their model
    for uid, r in ires.items():
        np.testing.assert_array_equal(jres[uid].tokens, r.tokens)
        np.testing.assert_allclose(jres[uid].energy_j_pred, r.energy_j_pred, rtol=1e-9)
    assert jeng.admission.log == ieng.admission.log
    assert jeng.scheduler.plan_cache_misses == ieng.scheduler.plan_cache_misses
