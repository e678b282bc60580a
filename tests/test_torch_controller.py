"""The AdaOper closed loop of the PyTorch port (``repro_torch.core.
controller``) against the JAX package: the paper's YOLOv2-tiny graph and the
full-config tinyllama-1.1b decode graph (batch 4, 512 positions: 68 ops at
the published widths), the same calibration trace and the same device
seeds on both sides.

Tolerances. The controller, the partitioner and the simulator are the same
numpy code in both packages, so with ``use_gru=False`` everything agrees
exactly: per-inference latency and energy, plan alphas, ledger events and
counters, stats, and plan totals to rtol 1e-12. With ``use_gru=True`` the
GRU corrector is torch fp32 in the port and JAX fp32 in the reference, on
weights carried across (``convert.gru_params_from_numpy``); the corrections
agree to ~1e-5 (``tests/test_torch_core.py``), so the per-op relative
energy drifts (the repartition trigger) are held to atol 1e-4 and the
predicted plan totals to rtol 1e-4. Every decision must still be equal:
plans, drift events, incremental repartitions, and so the simulator's
ground-truth joules, which depend on the plans alone. That holds because no
drift in these runs falls within the drift error of the 0.35 threshold:
the closest, in ``test_run_inference_sequence_matches_jax[gru]``, are the
9th inferences of YOLO (op conv0, 5.9e-4 from the threshold) and of
tinyllama (op 2, 1.0e-3), while the two packages' drifts differ by at most
4.4e-5 there. The test asserts the margin, so that a change that moves a
drift into the band fails by name rather than by a branched trajectory."""
import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import coexec as jax_coexec  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.core import opgraph as jax_opgraph  # noqa: E402
from repro.core import profiler as jax_prof  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import gru_params_from_numpy  # noqa: E402
from repro_torch.core import baselines, coexec, controller, opgraph, profiler, simulator  # noqa: E402

DRIFT_THRESHOLD = 0.35  # AdaOperController's default
DRIFT_ATOL = 1e-4  # GRU-corrected drifts: fp32 corrections agree to ~1e-5
GRU_RTOL = 1e-4  # GRU-corrected plan totals
PLAN_RTOL = 1e-12


def _mods(port):
    return ((opgraph, configs, profiler, simulator, controller, coexec, baselines) if port else
            (jax_opgraph, jax_configs, jax_prof, jax_sim, jax_controller, jax_coexec,
             jax_baselines))


def _loop_graphs(port):
    og, cf = _mods(port)[:2]
    return [og.build_yolo_graph(),
            og.build_transformer_graph(cf.get_config("tinyllama-1.1b"), 4, 512, kind="decode")]


@pytest.fixture(scope="module")
def calibrated():
    """{(port, use_gru): profiler} calibrated on the YOLO and tinyllama
    graphs with 2000 samples (as tests/test_controller.py calibrates); the
    port's GRU correctors carry the JAX correctors' initial weights."""
    out = {}
    for use_gru in (False, True):
        for port in (False, True):
            p = _mods(port)[2].RuntimeEnergyProfiler(use_gru=use_gru, seed=0)
            out[(port, use_gru)] = p.offline_calibrate(_loop_graphs(port), n_samples=2000,
                                                       seed=0)
        if use_gru:
            jp, tp = out[(False, True)], out[(True, True)]
            for src, dst in ((jp.gru_e, tp.gru_e), (jp.gru_t, tp.gru_t)):
                gru_params_from_numpy(jax.tree.map(np.asarray, src.params), dst)
    return out


def _pair(calibrated, use_gru):
    """Fresh copies (the controller trains the GRU and bumps versions)."""
    return (copy.deepcopy(calibrated[(True, use_gru)]),
            copy.deepcopy(calibrated[(False, use_gru)]))


def _record_drifts(prof):
    drifts = []
    fb = prof.feedback_batch

    def recorded(items, obs, lats, ens):
        d = fb(items, obs, lats, ens)
        drifts.append(np.asarray(d))
        return d
    prof.feedback_batch = recorded
    return drifts


def _ledger(sim):
    """Every event's fields (``t_s`` is NaN on events stamped with no
    virtual time; None stands in for it so that equal ledgers compare equal)."""
    return [(e.kind, e.model, e.uid, None if e.t_s != e.t_s else e.t_s, e.latency_s,
             e.energy.total_j, e.energy.cpu_j, e.energy.gpu_j, e.energy.bus_j)
            for e in sim.ledger.events]


def _stats(ctl):
    return {k: (s.latencies, s.energies, s.repartitions, s.incremental, s.drift_events)
            for k, s in ctl.stats.items()}


def _plans_agree(tctl, jctl, rtol):
    assert sorted(tctl.plans) == sorted(jctl.plans)
    for name, t in tctl.plans.items():
        j = jctl.plans[name]
        np.testing.assert_array_equal(t.alphas, j.alphas, err_msg=name)
        np.testing.assert_allclose([t.pred_energy, t.pred_latency],
                                   [j.pred_energy, j.pred_latency], rtol=rtol, atol=0,
                                   err_msg=name)
        assert (getattr(t, "coexec_rails", None) is None) == (
            getattr(j, "coexec_rails", None) is None)


# ---------------------------------------------------------------------------
# the YOLO config and graph
# ---------------------------------------------------------------------------


def test_yolo_config_and_graph_are_identical():
    j, t = jax_configs.get_config("yolo-v2-tiny"), configs.get_config("yolo-v2-tiny")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert configs.EXTRA_ARCHS == jax_configs.EXTRA_ARCHS
    from repro.configs.yolo_v2_tiny import YOLO_STAGES as JAX_STAGES
    from repro_torch.configs.yolo_v2_tiny import YOLO_STAGES
    assert YOLO_STAGES == JAX_STAGES
    for kw in (dict(), dict(batch=2), dict(batch=1, resolution=320, dtype_bytes=2)):
        tg, jg = opgraph.build_yolo_graph(**kw), jax_opgraph.build_yolo_graph(**kw)
        assert tg.name == jg.name and len(tg) == len(jg)
        for a, b in zip(tg.nodes, jg.nodes):
            assert (a.name, a.op_type, a.flops, a.bytes_in, a.bytes_out, a.weight_bytes,
                    a.splittable, a.split_grain, a.comm_bytes_if_split) == (
                b.name, b.op_type, b.flops, b.bytes_in, b.bytes_out, b.weight_bytes,
                b.splittable, b.split_grain, b.comm_bytes_if_split)
        np.testing.assert_array_equal(tg.static_feature_matrix(), jg.static_feature_matrix())
    # tests/test_opgraph.py::test_yolo_graph_matches_model on the port
    g = opgraph.build_yolo_graph()
    assert len(g) == 9
    assert all(n.op_type == "conv" for n in g.nodes)
    assert 5e9 < g.total_flops() < 9e9  # ~7 GFLOPs for tiny-yolo at 416x416


# ---------------------------------------------------------------------------
# the closed loop, inference by inference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_gru", [False, True], ids=["no_gru", "gru"])
def test_run_inference_sequence_matches_jax(calibrated, use_gru):
    """12 inferences of each graph, interleaved, on DeviceSim("moderate",
    seed=1): plan, execute, feed back, repartition drifted segments
    (merged, with a halo of 2), replan every 16 inferences."""
    tp, jp = _pair(calibrated, use_gru)
    tdrift, jdrift = _record_drifts(tp), _record_drifts(jp)
    ts, js = simulator.DeviceSim("moderate", seed=1), jax_sim.DeviceSim("moderate", seed=1)
    tctl, jctl = controller.AdaOperController(ts, tp), jax_controller.AdaOperController(js, jp)
    tg, jg = _loop_graphs(True), _loop_graphs(False)
    margin = np.inf
    for i in range(12):
        for t, j in zip(tg, jg):
            assert tctl.run_inference(t) == jctl.run_inference(j), (i, t.name)
            dt, dj = tdrift[-1], jdrift[-1]
            if use_gru:
                np.testing.assert_allclose(dt, dj, atol=DRIFT_ATOL, rtol=0)
                # no decision may sit inside the drifts' disagreement
                margin = min(margin, float(np.abs(dj - DRIFT_THRESHOLD).min()))
                assert margin > DRIFT_ATOL, (i, t.name, margin)
            else:
                np.testing.assert_array_equal(dt, dj)
            _plans_agree(tctl, jctl, GRU_RTOL if use_gru else PLAN_RTOL)
    assert _stats(tctl) == _stats(jctl)
    assert ts.ledger.counters == js.ledger.counters
    assert _ledger(ts) == _ledger(js)
    assert tp.correction_version() == jp.correction_version()
    assert tctl.cache_stats() == jctl.cache_stats()
    st = tctl.stats
    assert sum(s.incremental for s in st.values()) > 0, "no drift-triggered repartition ran"
    assert all(s.drift_events > 0 and s.repartitions >= 1 for s in st.values())
    if use_gru:
        assert tp.gru_e.predict_correction() != 0.0
        np.testing.assert_allclose(tp.gru_e.predict_correction(), jp.gru_e.predict_correction(),
                                   atol=1e-4)


def test_merge_segments_and_lam_estimate_match_jax(calibrated):
    tp, jp = _pair(calibrated, False)
    tctl = controller.AdaOperController(simulator.DeviceSim(), tp, segment_halo=2)
    jctl = jax_controller.AdaOperController(jax_sim.DeviceSim(), jp, segment_halo=2)
    for idxs, n in (([0], 9), ([3, 4, 9], 12), ([3, 10], 20), ([0, 5, 6, 30, 67], 68),
                    ([8], 9), ([], 5)):
        assert tctl._merge_segments(idxs, n) == jctl._merge_segments(idxs, n)
    assert tctl._merge_segments([3, 4, 9], 12) == [(1, 11)]  # adjacent halos merge
    assert tctl._merge_segments([3, 10], 20) == [(1, 5), (8, 12)]
    tg, jg = _loop_graphs(True)[0], _loop_graphs(False)[0]
    assert tctl._lam_estimate(tctl.plan(tg)) == jctl._lam_estimate(jctl.plan(jg))


def test_controller_runs_and_adapts(calibrated):
    """tests/test_controller.py's loop on the port (use_gru=True), beside
    the JAX controller on the same seeds."""
    tp, jp = _pair(calibrated, True)
    res = {}
    for port, prof in ((True, tp), (False, jp)):
        og, _, _, sim_mod, ctl_mod = _mods(port)[:5]
        sim = sim_mod.DeviceSim("high", seed=2)
        ctl = ctl_mod.AdaOperController(sim, prof)
        g = og.build_yolo_graph()
        out = []
        for _ in range(12):
            lat, en = ctl.run_inference(g)
            assert np.isfinite(lat) and np.isfinite(en)
            out.append((lat, en))
        st = ctl.stats[g.name]
        assert len(st.latencies) == 12
        assert st.repartitions >= 1
        res[port] = (out, st.repartitions, st.incremental, st.drift_events, sim.ledger.counters)
    assert res[True] == res[False]


def test_adaoper_beats_codl_under_high_load(calibrated):
    """Directional reproduction of Fig. 2 (high workload) on the port: lower
    energy AND latency than the CoDL-like latency planner with offline
    calibration; the totals equal the JAX package's."""
    tp, jp = _pair(calibrated, True)
    res = {}
    for port, prof in ((True, tp), (False, jp)):
        og, _, _, sim_mod, ctl_mod, _, base_mod = _mods(port)
        g = og.build_yolo_graph()
        codl = base_mod.codl_plan(g)
        out = {}
        for name in ("codl", "adaoper"):
            sim = sim_mod.DeviceSim("high", seed=7)
            lat = en = 0.0
            if name == "codl":
                for _ in range(15):
                    l, e = sim.exec_graph(g, codl.alphas)
                    lat += l
                    en += e
                    sim.step(l)
            else:
                ctl = ctl_mod.AdaOperController(sim, prof)
                for _ in range(15):
                    l, e = ctl.run_inference(g)
                    lat += l
                    en += e
            out[name] = (lat, en)
        assert out["adaoper"][1] < out["codl"][1], out  # energy
        assert out["adaoper"][0] < out["codl"][0], out  # latency
        res[port] = out
    assert res[True] == res[False]


def test_concurrent_workload(calibrated):
    """tests/test_controller.py's concurrent run on the port (YOLO beside a
    reduced tinyllama decode graph, use_gru=True), equal to the JAX run."""
    tp, jp = _pair(calibrated, True)
    res = {}
    for port, prof in ((True, tp), (False, jp)):
        og, cf, _, sim_mod, ctl_mod = _mods(port)[:5]
        sim = sim_mod.DeviceSim("moderate", seed=1)
        ctl = ctl_mod.AdaOperController(sim, prof)
        g1 = og.build_yolo_graph()
        g2 = og.build_transformer_graph(cf.reduced(cf.get_config("tinyllama-1.1b")), 1, 64,
                                        kind="decode")
        stats = ctl.run_concurrent([g1, g2], iters=5)
        assert set(stats) == {g1.name, g2.name}
        for s in stats.values():
            assert len(s.latencies) == 5
        res[port] = (_stats(ctl), sim.ledger.counters)
    assert res[True] == res[False]


@pytest.mark.parametrize("joint", [False, True], ids=["independent", "coexec"])
def test_run_concurrent_matches_jax(calibrated, joint):
    """The paper's concurrent setting at full width: YOLO and the full
    tinyllama decode graph resident together, round-robin, with and
    without the joint planner (contention priced, ledger-corrected)."""
    tp, jp = _pair(calibrated, False)
    res = {}
    for port, prof in ((True, tp), (False, jp)):
        _, _, _, sim_mod, ctl_mod, cx_mod, _ = _mods(port)
        sim = sim_mod.DeviceSim("moderate", seed=0)
        ctl = ctl_mod.AdaOperController(sim, prof,
                                        coexec=cx_mod.CoexecPlanner() if joint else None)
        graphs = _loop_graphs(port)
        stats = ctl.run_concurrent(graphs, iters=6)
        assert sorted(stats) == sorted(g.name for g in graphs)
        assert sim.coexec == 1  # restored after the run
        res[port] = ctl, sim
    (tctl, ts), (jctl, js) = res[True], res[False]
    assert _stats(tctl) == _stats(jctl)
    assert _ledger(ts) == _ledger(js)
    assert ts.ledger.counters == js.ledger.counters
    _plans_agree(tctl, jctl, PLAN_RTOL)
    if joint:
        tpl, jpl = tctl.coexec, jctl.coexec
        assert (tpl.cache_hits, tpl.cache_misses) == (jpl.cache_hits, jpl.cache_misses)
        assert tpl.cache_misses >= 1
        assert tpl.model.corrections == jpl.model.corrections
        assert tpl.model.version() == jpl.model.version()
        assert tpl.model.observations == jpl.model.observations == 12
        for name, plan in tctl.plans.items():
            assert plan.coexec_rails == jctl.plans[name].coexec_rails
            assert plan.coexec_rails is not None
    else:
        assert "coexec_corrections" not in ts.ledger.counters


def test_run_trace_with_priorities_matches_jax(calibrated):
    """A timed arrival trace: bursts that queue (served by priority, then
    FIFO) and gaps that idle the device; latency includes queueing."""
    tp, jp = _pair(calibrated, False)
    arrivals = [(0.0, 0, 0), (0.0, 1, 0), (0.0, 0, 2), (0.0, 1, 1), (0.05, 0, 0), (3.0, 1, 0),
                (3.0, 0, 5), (3.0, 0, 0), (3.001, 1, 9), (9.0, 0, 0)]
    res = {}
    for port, prof in ((True, tp), (False, jp)):
        _, _, _, sim_mod, ctl_mod = _mods(port)[:5]
        sim = sim_mod.DeviceSim("moderate", seed=3, battery_capacity_j=500.0)
        ctl = ctl_mod.AdaOperController(sim, prof)
        graphs = _loop_graphs(port)
        items = [(t, graphs[g], SimpleNamespace(priority=p, uid=k, model=graphs[g].name))
                 for k, (t, g, p) in enumerate(arrivals)]
        # any order: sorted by arrival time, ties kept in the order given
        recs = ctl.run_trace(items[4:] + items[:4])
        assert len(recs) == len(arrivals)
        order = [r.meta.uid for r in recs]
        # at t=0 four arrive together: priority 2, then 1, then FIFO
        assert order[:4] == [2, 3, 0, 1]
        for r in recs:
            assert r.t_start >= r.t_arrival and r.latency_s == pytest.approx(
                r.t_done - r.t_arrival)
        res[port] = ([(r.t_arrival, r.t_start, r.t_done, r.latency_s, r.energy_j, r.meta.uid)
                      for r in recs], sim)
    (trec, ts), (jrec, js) = res[True], res[False]
    assert trec == jrec
    assert _ledger(ts) == _ledger(js)
    assert ts.ledger.counters == js.ledger.counters
    assert ts.battery_j == js.battery_j < 500.0
    assert [e.kind for e in ts.ledger.events].count("request") == len(arrivals)


def test_fault_epoch_pinned_fallback_and_transient_retry_match_jax(calibrated):
    """The fault paths without an injector (the simulator's hooks set by
    hand): a rail drop bumps the fault epoch, so every plan is dropped and
    the next one is pinned to the survivor; a transient budget within the
    retries is retried and recorded; one beyond them, or no surviving
    rail, ends the request in an explicit ``rejected`` record."""
    tp, jp = _pair(calibrated, False)
    res = {}
    for port, prof in ((True, tp), (False, jp)):
        _, _, _, sim_mod, ctl_mod = _mods(port)[:5]
        sim = sim_mod.DeviceSim("high", seed=4)
        ctl = ctl_mod.AdaOperController(sim, prof, max_op_retries=2)
        yolo, tiny = _loop_graphs(port)
        out = [ctl.run_inference(yolo), ctl.run_inference(tiny)]
        healthy = ctl.plans[yolo.name].alphas.copy()
        sim.faulted_rails, sim.fault_epoch = frozenset({"gpu"}), sim.fault_epoch + 1
        out.append(ctl.run_inference(yolo))
        assert np.all(ctl.plans[yolo.name].alphas == 0.0)  # pinned to the cpu
        assert tiny.name not in ctl.plans  # the epoch moved: every plan dropped
        out.append(ctl.run_inference(tiny))
        sim.transient_fails = 2  # within the retries
        out.append(ctl.run_inference(tiny))
        sim.faulted_rails, sim.fault_epoch = frozenset(), sim.fault_epoch + 1
        out.append(ctl.run_inference(yolo))
        restored = ctl.plans[yolo.name].alphas.copy()
        assert not np.all(restored == 0.0)
        sim.transient_fails = 3  # outlasts max_op_retries=2
        meta = SimpleNamespace(priority=0, uid=7, model=yolo.name)
        assert ctl.run_trace([(0.0, yolo, meta)]) == []
        sim.transient_fails = 0
        sim.faulted_rails, sim.fault_epoch = frozenset({"cpu", "gpu"}), sim.fault_epoch + 1
        assert ctl.run_trace([(1.0, tiny, SimpleNamespace(priority=0, uid=8,
                                                          model=tiny.name))]) == []
        c = sim.ledger.counters
        assert c["fault_replans"] == 2 and c["op_retries"] == 4 and c["recoveries"] == 1
        assert c["aborted"] == 2
        rejected = [e for e in sim.ledger.events if e.kind == "rejected"]
        assert [e.uid for e in rejected] == [7, 8]
        assert [e.kind for e in sim.ledger.events].count("recovery") == 1
        res[port] = (out, healthy, restored, _stats(ctl), c, _ledger(sim),
                     [str(e.meta["reason"]) for e in rejected])
    t, j = res[True], res[False]
    assert t[0] == j[0] and t[3:] == j[3:]
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], j[2])
