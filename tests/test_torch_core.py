"""The AdaOper core of the PyTorch port against the JAX package: the numpy
modules are copies, so op graphs, GBDT predictions, DP plans, the device
simulator's trajectory and the fault-recovery plans must agree exactly on
the same inputs and seeds (plan totals to 1e-12); the GRU corrector, the
one core module that runs a network, agrees to 1e-5 on carried weights."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import gbdt as jax_gbdt  # noqa: E402
from repro.core import gru as jax_gru  # noqa: E402
from repro.core import opgraph as jax_opgraph  # noqa: E402
from repro.core import partitioner as jax_part  # noqa: E402
from repro.core import profiler as jax_prof  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro.faults import recovery as jax_recovery  # noqa: E402
from repro.sharding import comm as jax_comm  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import gru_params_from_numpy  # noqa: E402
from repro_torch.core import gbdt, gru, opgraph, partitioner, profiler, simulator  # noqa: E402
from repro_torch.faults import recovery  # noqa: E402
from repro_torch.faults.errors import ProcessorFault  # noqa: E402
from repro_torch.sharding import comm  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402

ARCHS = ["tinyllama-1.1b", "gemma2-2b", "mamba2-2.7b"]


def _graphs(arch, batch, seq, kind):
    j = jax_opgraph.build_transformer_graph(jax_configs.get_config(arch), batch, seq, kind=kind)
    t = opgraph.build_transformer_graph(configs.get_config(arch), batch, seq, kind=kind)
    return j, t


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_graphs_are_identical(arch):
    j, t = jax_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for batch, seq, kind in ((1, 64, "prefill"), (8, 512, "prefill"), (4, 1040, "decode")):
        jg, tg = _graphs(arch, batch, seq, kind)
        assert tg.name == jg.name and len(tg) == len(jg)
        for a, b in zip(tg.nodes, jg.nodes):
            assert (a.name, a.op_type, a.flops, a.bytes_in, a.bytes_out, a.weight_bytes,
                    a.splittable, a.split_grain, a.comm_bytes_if_split) == (
                b.name, b.op_type, b.flops, b.bytes_in, b.bytes_out, b.weight_bytes,
                b.splittable, b.split_grain, b.comm_bytes_if_split)
        np.testing.assert_array_equal(tg.static_feature_matrix(), jg.static_feature_matrix())


def test_gbdt_predictions_are_equal():
    r = np.random.default_rng(0)
    X = r.standard_normal((400, 7))
    y = np.exp(X[:, 0]) + X[:, 1] ** 2 + 0.1 * r.standard_normal(400)
    Xq = r.standard_normal((50, 7))
    for kw in (dict(seed=0), dict(seed=3, subsample=0.7, n_estimators=40)):
        a = gbdt.GBDTRegressor(**kw).fit(X, y)
        b = jax_gbdt.GBDTRegressor(**kw).fit(X, y)
        np.testing.assert_array_equal(a.predict(Xq), b.predict(Xq))


@pytest.fixture(scope="module")
def profilers():
    """Port and JAX profilers calibrated on the same graphs and trace."""
    graphs = [_graphs(a, 4, 80, "prefill") for a in ARCHS]
    tp = profiler.RuntimeEnergyProfiler(seed=0).offline_calibrate(
        [t for _, t in graphs], n_samples=500, seed=1)
    jp = jax_prof.RuntimeEnergyProfiler(seed=0).offline_calibrate(
        [j for j, _ in graphs], n_samples=500, seed=1)
    return tp, jp


@pytest.mark.parametrize("objective", ["edp", "energy", "latency"])
def test_dp_partition_plans_are_identical(profilers, objective):
    tp, jp = profilers
    state = simulator.DeviceSim("high", seed=4).observe()
    jstate = jax_sim.DeviceState(**dataclasses.asdict(state))
    for arch in ARCHS:
        for kind in ("prefill", "decode"):
            jg, tg = _graphs(arch, 2, 96, kind)
            a = partitioner.dp_partition(tg, tp.cost_fn(state), objective=objective)
            b = jax_part.dp_partition(jg, jp.cost_fn(jstate), objective=objective)
            np.testing.assert_array_equal(a.alphas, b.alphas)
            np.testing.assert_allclose([a.pred_energy, a.pred_latency],
                                       [b.pred_energy, b.pred_latency], rtol=1e-12)
            sa = partitioner.score_plan(tg, a.alphas, tp.cost_fn(state))
            sb = jax_part.score_plan(jg, b.alphas, jp.cost_fn(jstate))
            np.testing.assert_allclose([sa.pred_energy, sa.pred_latency],
                                       [sb.pred_energy, sb.pred_latency], rtol=1e-12)


def test_simulator_trajectory_drain_and_rail_fractions_are_equal():
    jg, tg = _graphs("mamba2-2.7b", 2, 64, "prefill")
    plan = np.linspace(0.0, 1.0, len(tg)).round(3)
    for preset in ("idle", "moderate", "high"):
        a = simulator.DeviceSim(preset, seed=7, battery_capacity_j=2.0)
        b = jax_sim.DeviceSim(preset, seed=7, battery_capacity_j=2.0)
        for i in range(40):
            a.set_coexec(1 + i % 3)
            b.set_coexec(1 + i % 3)
            a.step(0.01 * (1 + i % 4))
            b.step(0.01 * (1 + i % 4))
            assert dataclasses.asdict(a.observe()) == dataclasses.asdict(b.observe())
            assert dataclasses.asdict(a.state) == dataclasses.asdict(b.state)
            assert a.rail_fractions(tg, plan) == b.rail_fractions(jg, plan)
            assert a.exec_graph(tg, plan) == b.exec_graph(jg, plan)
            a.drain(0.07)
            b.drain(0.07)
            assert (a.battery_pct, a.battery_dead, a.battery_critical) == (
                b.battery_pct, b.battery_dead, b.battery_critical)
        a.advance_idle(0.3)
        b.advance_idle(0.3)
        assert dataclasses.asdict(a.state) == dataclasses.asdict(b.state)
        assert ([(e.kind, e.energy.total_j) for e in a.ledger.events]
                == [(e.kind, e.energy.total_j) for e in b.ledger.events])


def test_state_bucket_pinned_partition_and_comm_are_equal(profilers):
    tp, jp = profilers
    sim = simulator.DeviceSim("moderate", seed=2)
    for _ in range(20):
        sim.step()
        s = sim.observe()
        assert profiler.state_bucket(s) == jax_prof.state_bucket(
            jax_sim.DeviceState(**dataclasses.asdict(s)))
    jg, tg = _graphs("tinyllama-1.1b", 4, 128, "decode")
    jstate = jax_sim.DeviceState(**dataclasses.asdict(s))
    for alpha in (0.0, 1.0):
        a = recovery.pinned_partition(tg, tp.cost_fn(s), alpha)
        b = jax_recovery.pinned_partition(jg, jp.cost_fn(jstate), alpha)
        np.testing.assert_array_equal(a.alphas, b.alphas)
        np.testing.assert_allclose([a.pred_energy, a.pred_latency],
                                   [b.pred_energy, b.pred_latency], rtol=1e-12)
    faulted = simulator.DeviceSim()
    assert recovery.surviving_alpha(faulted) is None
    faulted.faulted_rails = frozenset({"gpu"})
    assert recovery.surviving_alpha(faulted) == 0.0
    faulted.faulted_rails = frozenset({"gpu", "cpu"})
    with pytest.raises(ProcessorFault):
        recovery.surviving_alpha(faulted)
    # model_parallel == 1: no communication term, the plan object unchanged
    plan = {"step_energy": 1.0, "step_latency": 2.0, "rails": (0.2, 0.7, 0.1)}
    cfg = configs.get_config("tinyllama-1.1b")
    assert comm.comm_term(cfg, ExecContext(), 8, 1) is None
    assert comm.shard_plan(plan, None, "step_energy", "step_latency") is plan
    assert comm.step_collective_bytes(cfg, 8, 16, 4) == jax_comm.step_collective_bytes(
        jax_configs.get_config("tinyllama-1.1b"), 8, 16, 4)


def test_gru_corrector_matches_jax_on_carried_weights():
    """The corrector's prediction and one Adam step (the online training
    the profiler runs on feedback) agree with the JAX corrector to 1e-5."""
    in_dim = 12
    jc = jax_gru.GRUCorrector(in_dim=in_dim, seed=0)
    tc = gru.GRUCorrector(in_dim=in_dim, seed=0)
    assert float(tc.cell.wo.detach().abs().max()) == 0.0 and tc.predict_correction() == 0.0
    gru_params_from_numpy(jax.tree.map(np.asarray, jc.params), tc)
    r = np.random.default_rng(0)
    for _ in range(20):
        feats = r.standard_normal(in_dim - 2)
        pred, obs = float(np.exp(r.standard_normal())), float(np.exp(r.standard_normal()))
        jc.record(feats, pred, obs)
        tc.record(feats, pred, obs)
    # the zero-initialised head keeps both at the identity until trained
    assert tc.predict_correction() == 0.0 == jc.predict_correction()
    jc.train_steps(1)
    tc.train_steps(1)
    assert tc.t == jc.t == 1
    for name, p in tc.cell.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jc.params[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert tc.predict_correction() != 0.0
    np.testing.assert_allclose(tc.predict_correction(), jc.predict_correction(),
                               atol=1e-5, rtol=1e-5)
    jc.train_steps(3)
    tc.train_steps(3)
    np.testing.assert_allclose(tc.predict_correction(), jc.predict_correction(),
                               atol=1e-5, rtol=1e-4)


def test_profiler_feedback_moves_the_version_and_the_correction(profilers):
    """Feedback through the GRU bumps the correction version (the plan
    caches' key) and, after training, moves predictions; an attached
    uncertainty model's calibration version folds into the correction
    version."""
    tp, _ = profilers
    prof = profiler.RuntimeEnergyProfiler(seed=0)
    prof.energy_model, prof.latency_model = tp.energy_model, tp.latency_model
    _, g = _graphs("tinyllama-1.1b", 1, 32, "prefill")
    s = simulator.DeviceSim("moderate", seed=0).observe()
    before = prof.predict(g.nodes[1], 0.5, 0.5, s)
    v0 = prof.correction_version()
    items = [(op, 0.5, 0.5) for op in g.nodes] * 2
    prof.feedback_batch(items, s, [1e-3] * len(items), [5e-3] * len(items))
    assert prof.correction_version() == v0 + len(items)
    assert prof.predict(g.nodes[1], 0.5, 0.5, s) != before
    assert isinstance(prof.gru_e.cell, torch.nn.Module)
    class Calibrated:  # the duck type attach_uncertainty takes
        def calibration_version(self):
            return 5
    assert prof.attach_uncertainty(Calibrated()) is prof
    assert prof.correction_version() == v0 + len(items) + 5
