"""The fault plans and the injector of the PyTorch port
(``repro_torch.faults.plan``, ``repro_torch.faults.injector``) against the
JAX package's: ``chaos_plan`` gives equal events for both chaos scenarios
over several seeds and durations, and ``FaultInjector`` driving the port's
``DeviceSim`` gives the same ledger events, counters, ``fault_epoch``
sequence and derived fault state as the reference's on its own simulator.
Then the closed loop and the engine under an injected schedule, against
the JAX package's."""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import DeviceSim as JaxSim  # noqa: E402
from repro.core import RuntimeEnergyProfiler as JaxProfiler  # noqa: E402
from repro.core import build_transformer_graph as jax_graph  # noqa: E402
from repro.core import build_yolo_graph as jax_yolo  # noqa: E402
from repro.core.controller import AdaOperController as JaxController  # noqa: E402
from repro.faults import plan as jax_plan  # noqa: E402
from repro.faults.injector import FaultInjector as JaxInjector  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.engine import AdaOperScheduler as JaxScheduler  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.controller import AdaOperController  # noqa: E402
from repro_torch.core.opgraph import build_transformer_graph, build_yolo_graph  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.faults import plan as port_plan  # noqa: E402
from repro_torch.faults.injector import FaultInjector  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import AdaOperScheduler  # noqa: E402
from repro_torch.serving.slots import Request  # noqa: E402


def _nan_free(x):
    """``x`` with every float NaN (an idle event's timestamp) as None, so
    that == compares it."""
    if isinstance(x, float) and math.isnan(x):
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(_nan_free(v) for v in x)
    if isinstance(x, dict):
        return {k: _nan_free(v) for k, v in x.items()}
    return x


def _events(plan):
    return [(e.kind, e.t_start_s, e.duration_s, e.params) for e in plan]


def test_fault_package_exports_the_reference_names():
    import repro.faults as jax_faults
    assert faults.__all__ == jax_faults.__all__
    assert port_plan.KINDS == jax_plan.KINDS
    assert port_plan.CHAOS_SCENARIOS == jax_plan.CHAOS_SCENARIOS == (
        "chaos_mixed", "chaos_voice")


@pytest.mark.parametrize("scenario", ["chaos_voice", "chaos_mixed"])
@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2**31 + 5])
def test_chaos_plan_matches_jax(scenario, seed):
    """The seeded ±2% boundary jitter, the clamps and the windows: equal
    events, boundaries and summaries for several durations."""
    for duration in (3.0, 10.0, 30.0):
        t = port_plan.chaos_plan(scenario, duration, seed=seed)
        j = jax_plan.chaos_plan(scenario, duration, seed=seed)
        assert _events(t) == _events(j)
        assert [(b[0], b[1], b[2], b[3].kind) for b in t.boundaries()] == [
            (b[0], b[1], b[2], b[3].kind) for b in j.boundaries()]
        assert t.summary() == j.summary()
        assert any(math.isinf(e.duration_s) for e in t)
    assert port_plan.chaos_plan(scenario, 10.0, seed=seed) == port_plan.chaos_plan(
        scenario, 10.0, seed=seed)


def test_non_chaos_scenarios_and_invalid_events():
    for name in ("voice", "mixed", "video"):
        assert port_plan.chaos_plan(name, 10.0) is None
        assert jax_plan.chaos_plan(name, 10.0) is None
    for bad in (port_plan.FaultEvent("meteor", 0.0, 1.0),
                port_plan.FaultEvent("gpu_dropout", -1.0, 1.0)):
        with pytest.raises(ValueError):
            port_plan.FaultPlan([bad])
    # clears before applies at one instant, transient_op without a clear
    plan = port_plan.FaultPlan([port_plan.FaultEvent("gpu_dropout", 0.0, 1.0),
                                port_plan.FaultEvent("cpu_dropout", 1.0, 1.0),
                                port_plan.FaultEvent("transient_op", 1.0, 0.0, {"count": 2})])
    assert [(t, a, ev.kind) for t, _, a, ev in plan.boundaries()] == [
        (0.0, "apply", "gpu_dropout"), (1.0, "clear", "gpu_dropout"),
        (1.0, "apply", "cpu_dropout"), (1.0, "apply", "transient_op"),
        (2.0, "clear", "cpu_dropout")]


def _overlap(mod):
    E = mod.FaultEvent
    return mod.FaultPlan([
        E("mem_pressure", 1.0, 1.0, {"inflation": 1.6}),
        E("mem_pressure", 1.5, 1.0, {"inflation": 1.25}),
        E("gpu_dropout", 3.0, 2.0),
        E("cpu_dropout", 4.2, 0.3),
        E("thermal_throttle", 4.0, 2.0, {"scale": 0.5}),
        E("thermal_throttle", 4.5, 0.5, {"scale": 0.3}),
        E("transient_op", 6.5, 0.0, {"count": 3}),
        E("battery_critical", 7.0, float("inf")),
    ])


def _walk(sim, inj, grid):
    """Advance the injector along ``grid`` with device steps between, and
    record the fault state after each advance."""
    out = []
    for t in grid:
        n = sim.advance_faults(t)
        sim.step(0.05, 0.7)
        out.append((n, sim.fault_epoch, tuple(sorted(sim.faulted_rails)), sim.freq_cap,
                    sim.lat_inflation, sim.battery_critical, sim.transient_fails,
                    sim.state.cpu_f, sim.state.gpu_f, inj.done(),
                    tuple(e.kind for e in inj.active)))
    return out


def _ledger(sim):
    return [(e.kind, e.t_s, e.meta) for e in sim.ledger.events
            if e.kind in ("fault", "recovery")], dict(sim.ledger.counters)


@pytest.mark.parametrize("which", ["overlap", "chaos_voice", "chaos_mixed"])
def test_injector_on_port_sim_matches_jax(which):
    """Overlapping windows (inflations multiply, caps take the min, rails
    union), both chaos schedules: the same transitions per advance, the same
    epoch sequence, state and audit trail as the JAX injector."""
    if which == "overlap":
        tp, jp = _overlap(port_plan), _overlap(jax_plan)
    else:
        tp, jp = (m.chaos_plan(which, 8.0, seed=3) for m in (port_plan, jax_plan))
    ts, js = DeviceSim("high", seed=4), JaxSim("high", seed=4)
    ti, ji = FaultInjector(ts, tp), JaxInjector(js, jp)
    assert ts.faults is ti and ts.fault_epoch == 0
    grid = np.concatenate([np.arange(0.0, 9.0, 0.25), [1e9]])
    got, want = _walk(ts, ti, grid), _walk(js, ji, grid)
    assert got == want
    assert _ledger(ts) == _ledger(js)
    c = ts.ledger.counters
    assert ts.fault_epoch == c["faults"] + c["recoveries"] and ti.done()


@pytest.fixture(scope="module")
def profilers():
    out = []
    for prof, graph in ((RuntimeEnergyProfiler, build_yolo_graph), (JaxProfiler, jax_yolo)):
        p = prof(use_gru=False, seed=0)
        p.offline_calibrate([graph()], n_samples=300, seed=0)
        out.append(p)
    return out


def test_controller_under_chaos_matches_jax(profilers):
    """``run_trace`` of YOLO frames under the chaos_mixed schedule (gpu
    dropout, throttle, transient op failures): the same latencies, energies,
    fault replans, op retries and ledger as the JAX controller."""
    res = []
    for (prof, sim, ctl, graph, mod, inj) in (
            (profilers[0], DeviceSim, AdaOperController, build_yolo_graph, port_plan,
             FaultInjector),
            (profilers[1], JaxSim, JaxController, jax_yolo, jax_plan, JaxInjector)):
        s = sim("moderate", seed=5)
        inj(s, mod.chaos_plan("chaos_mixed", 4.0, seed=1))
        c = ctl(s, prof)
        g = graph()
        c.run_trace([(0.1 * i, g, None) for i in range(40)])
        st = c.stats[g.name]
        res.append((st.latencies, st.energies, st.repartitions, dict(s.ledger.counters),
                    [(e.kind, e.t_s) for e in s.ledger.events]))
    assert _nan_free(res[0]) == _nan_free(res[1])
    assert res[0][3]["fault_replans"] > 0 and res[0][3]["op_retries"] > 0


def test_engine_trace_under_faults_matches_jax():
    """The scheduled engine's ``run_trace`` on reduced tinyllama under the
    chaos_voice schedule (gpu dropout, throttle, battery-critical shedding):
    the same responses, errors, ledger counters and events as the JAX
    engine's."""
    arch = "tinyllama-1.1b"
    jcfg = jax_configs.reduced(jax_configs.get_config(arch))
    tcfg = configs.reduced(configs.get_config(arch))
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    res = []
    for port in (True, False):
        graph, prof, sim, sched, eng, mod, inj, make = (
            (build_transformer_graph, RuntimeEnergyProfiler, DeviceSim, AdaOperScheduler,
             ServingEngine, port_plan, FaultInjector, Request) if port else
            (jax_graph, JaxProfiler, JaxSim, JaxScheduler, JaxEngine, jax_plan, JaxInjector,
             JaxRequest))
        cfg = tcfg if port else jcfg
        p = prof(seed=0)
        p.offline_calibrate([graph(cfg, 4, 40)], n_samples=300)
        s = sim("moderate", seed=0)
        inj(s, mod.chaos_plan("chaos_voice", 2.0, seed=2))
        e = eng(scheduler=sched(p, s), max_slots=4)
        e.add_model(arch, cfg, tparams if port else jp, max_len=48)
        rng = np.random.default_rng(1)
        arrivals = [(0.05 * i, arch, make(i, rng.integers(1, cfg.vocab_size, 12, dtype=np.int32),
                                          4, priority=i % 3, deadline_s=0.6))
                    for i in range(40)]
        out = sorted(e.run_trace(arrivals), key=lambda r: r.uid)
        res.append(([(r.uid, r.error, [int(t) for t in r.tokens], r.latency_s) for r in out],
                    dict(e.ledger.counters),
                    [(ev.kind, ev.uid, ev.t_s) for ev in e.ledger.events]))
    assert _nan_free(res[0]) == _nan_free(res[1])
    c = res[0][1]
    assert c["faults"] > 0 and c["recoveries"] > 0 and c.get("shed", 0) > 0
