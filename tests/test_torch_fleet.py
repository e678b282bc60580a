"""The fleet replay of the PyTorch port (``repro_torch.fleet``) against the
JAX package's ``repro.fleet``: traces, device populations and the graph
registry are equal; the graph backend's reports are equal by ``to_dict()``
for voice, mixed and both chaos scenarios, with and without the
uncertainty layer (``use_gru=False``); the serving backend on reduced
tinyllama-1.1b (weights converted with ``convert.params_from_numpy``)
gives equal counters and floats within 1e-9 relative. Then the port's own
accounting: every arrival is a record or a rejection, and a rerun gives
the same report."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro import fleet as jfleet  # noqa: E402
from repro.configs import base as jax_configs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch import fleet  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.fleet.workloads import ASSISTANT  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402

GRAPH_SCENARIOS = ["voice", "mixed", "chaos_voice", "chaos_mixed"]
# one device, a short window and a small calibration trace keep each
# replay to seconds on a CPU
FLEET = dict(duration_s=2.5, seed=3, calib_samples=60)


@pytest.mark.parametrize("scenario", sorted(fleet.SCENARIOS))
def test_traces_match_jax(scenario):
    for seed in (0, 5):
        for rate in (1.0, 2.5):
            t = fleet.make_trace(scenario, 12.0, seed=seed, rate_scale=rate)
            j = jfleet.make_trace(scenario, 12.0, seed=seed, rate_scale=rate)
            assert t.requests == tuple(
                fleet.TraceRequest(**r.__dict__) for r in j.requests)
            assert t.summary() == j.summary()
    with pytest.raises(ValueError, match="unknown scenario"):
        fleet.make_trace("nope")


def test_population_and_graph_registry_match_jax():
    for n, seed in ((1, 0), (3, 0), (7, 11)):
        t, j = fleet.sample_population(n, seed=seed), jfleet.sample_population(n, seed=seed)
        assert [p.describe() for p in t] == [p.describe() for p in j]
        assert [(p.seed, p.vol_scale, p.cpu_spec.__dict__, p.gpu_spec.__dict__) for p in t] == [
            (p.seed, p.vol_scale, p.cpu_spec.__dict__, p.gpu_spec.__dict__) for p in j]
    tg, jg = fleet.default_graph_registry(), jfleet.default_graph_registry()
    assert sorted(tg) == sorted(jg) == sorted([fleet.workloads.VISION, fleet.workloads.AR,
                                               ASSISTANT])
    for name in tg:
        a, b = tg[name], jg[name]
        assert [(n.name, n.op_type, n.flops, n.bytes_in, n.bytes_out) for n in a.nodes] == [
            (n.name, n.op_type, n.flops, n.bytes_in, n.bytes_out) for n in b.nodes]


@pytest.mark.parametrize("uncertainty", [False, True], ids=["point", "uncertainty"])
@pytest.mark.parametrize("scenario", GRAPH_SCENARIOS)
def test_graph_backend_report_matches_jax(scenario, uncertainty):
    kw = dict(FLEET, scenario=scenario, uncertainty=uncertainty, use_gru=False)
    t = fleet.FleetReplay(fleet.sample_population(1, seed=1), **kw).run().to_dict()
    j = jfleet.FleetReplay(jfleet.sample_population(1, seed=1), **kw).run().to_dict()
    assert t == j
    assert ("interval_coverage" in t["fleet"]) == (
        uncertainty and t["fleet"]["counters"].get("interval_observations", 0) > 0)
    if scenario.startswith("chaos"):
        assert t["fleet"]["counters"]["faults"] > 0


@pytest.fixture(scope="module")
def tiny():
    arch = "tinyllama-1.1b"
    jcfg = jax_configs.reduced(jax_configs.get_config(arch))
    tcfg = configs.reduced(configs.get_config(arch))
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _close(a, b, path="report"):
    """Equal structure, ints and strings; floats within 1e-9 relative."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("scenario,uncertainty", [("mixed", True), ("chaos_voice", False)])
def test_serving_backend_matches_jax(tiny, scenario, uncertainty):
    """The assistant served token by token through the continuous engine
    (mixed: beside vision and AR frames on one virtual timeline, with the
    uncertainty layer and ``risk_level=0.9``; chaos_voice: under its fault
    schedule): counters equal, floats within 1e-9 relative."""
    jcfg, jp, tcfg, tp = tiny
    kw = dict(FLEET, scenario=scenario, backend="serving", uncertainty=uncertainty,
              risk_level=0.9 if uncertainty else None)
    t = fleet.FleetReplay(fleet.sample_population(1, seed=2),
                          serving_models={ASSISTANT: (tcfg, tp)}, **kw).run().to_dict()
    j = jfleet.FleetReplay(jfleet.sample_population(1, seed=2),
                           serving_models={ASSISTANT: (jcfg, jp)}, **kw).run().to_dict()
    _close(t, j)
    assert [d["counters"] for d in t["devices"]] == [d["counters"] for d in j["devices"]]
    c = t["fleet"]["counters"]
    if scenario == "mixed":
        assert "interval_coverage" in t["fleet"] and c["repartitions"] >= 1
    else:
        assert c["faults"] > 0 and c["recoveries"] > 0


def test_serving_replay_accounts_for_every_arrival_and_repeats(tiny):
    """Each device's records plus its rejected requests are its trace's
    arrivals, and a second run of the same replay gives the same report
    (virtual time, seeded traces and weights); an explicit single-device
    context is taken, a mesh of one gives the same report, and a serving
    mesh of two devices on its data axis is taken: each device's engine
    serves data-parallel (the replay on two ranks:
    tests/test_torch_data_axis.py)."""
    _, _, tcfg, tp = tiny
    kw = dict(FLEET, scenario="chaos_voice", backend="serving", uncertainty=True,
              risk_level=0.9, serving_models={ASSISTANT: (tcfg, tp)},
              serving_ctx=ExecContext())
    pop = fleet.sample_population(1, seed=4)
    rep = fleet.FleetReplay(pop, **kw)
    a = rep.run()
    assert rep.run().to_dict() == a.to_dict()
    for idx, d in enumerate(a.devices):
        n = len(rep.device_trace(idx))
        assert d.n_requests + d.counters.get("rejected", 0) + d.counters.get("aborted", 0) == n
    assert a.fleet["counters"]["faults"] > 0 and a.fleet["counters"]["recoveries"] > 0
    assert fleet.FleetReport.from_dict(a.to_dict()).to_dict() == a.to_dict()

    mesh1 = ExecContext(mesh=make_debug_mesh(1, 1, "cpu"), batch_axes=("data",), model_axis="model")
    assert fleet.FleetReplay(pop, **dict(kw, serving_ctx=mesh1)).run().to_dict() == a.to_dict()

    class DataMesh:
        shape = {"data": 2, "model": 1}
    data2 = ExecContext(mesh=DataMesh(), batch_axes=("data",), model_axis="model")
    dr = fleet.replay.DeviceReplay(pop[0], fleet.default_graph_registry(),
                                   calib_samples=FLEET["calib_samples"], backend="serving",
                                   serving_models={ASSISTANT: (tcfg, tp)}, serving_ctx=data2)
    assert dr.engine.workers[ASSISTANT].data_parallel == 2


@pytest.mark.parametrize("scenario", ["mixed", "chaos_voice"])
def test_serving_replay_keeps_each_devices_runtime_and_responses(tiny, scenario):
    """After a run the replay holds each device's runtime in population
    order, each with its engine's responses: one per assistant arrival of
    the device's trace (mixed: beside frames on the merged timeline;
    chaos_voice: through ``run_trace``), a served one with 1 to
    ``max_new_tokens`` tokens."""
    _, _, tcfg, tp = tiny
    pop = fleet.sample_population(2, seed=1)
    rep = fleet.FleetReplay(pop, **dict(FLEET, scenario=scenario, backend="serving",
                                        serving_models={ASSISTANT: (tcfg, tp)}))
    assert rep.device_replays == []
    rep.run()
    assert [dr.profile for dr in rep.device_replays] == pop
    n_served = 0
    for idx, dr in enumerate(rep.device_replays):
        asked = {r.uid: r.max_new_tokens for r in rep.device_trace(idx) if r.model == ASSISTANT}
        assert sorted(r.uid for r in dr.responses) == sorted(asked)
        served = [r for r in dr.responses if r.error is None]
        assert all(1 <= len(r.tokens) <= max(asked[r.uid], 1) for r in served)
        n_served += len(served)
    assert n_served > 0
