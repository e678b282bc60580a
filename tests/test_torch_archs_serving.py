"""The port's continuous engine against the JAX engine on reduced
deepseek-v2-lite-16b (MLA, MoE) and qwen2-7b (qkv bias) in one engine,
FIFO and AdaOper-scheduled, with ``moe_capacity_factor`` set back to the
published 1.25 (``reduced`` makes MoE drop-free): the same requests on
converted weights (random biases and norm scales) must give identical
tokens per uid, the same admission log and the same ledger (kinds, models,
n_active, simulated joules to 1e-9), and the MoE layers must have dropped
assignments on the way (asserted)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import DeviceSim as JaxSim  # noqa: E402
from repro.core import RuntimeEnergyProfiler as JaxProfiler  # noqa: E402
from repro.core import build_transformer_graph as jax_graph  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.engine import AdaOperScheduler as JaxScheduler  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.opgraph import build_transformer_graph  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import AdaOperScheduler  # noqa: E402
from repro_torch.serving.slots import Request  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "qwen2-7b"]
MIXED = [(12, 4), (20, 6), (7, 3), (16, 5), (20, 2), (9, 6)]
MAX_LEN, CALIB, CF = 40, 400, 1.25


def randomise(tree, seed):
    """A numpy copy of a JAX param tree with qkv biases N(0, 0.5) and norm
    scales 1 + N(0, 0.3) (as tests/test_torch_archs.py sets them)."""
    r = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (r.standard_normal(np.shape(v)).astype(np.float32) * 0.5
                        if k in ("bq", "bk", "bv") else
                        (1.0 + 0.3 * r.standard_normal(np.shape(v))).astype(np.float32)
                        if k in ("scale", "q_norm", "k_norm", "kv_norm")
                        and not isinstance(v, dict) else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return np.asarray(node)
    return walk(tree)


@pytest.fixture(scope="module")
def models():
    out = {}
    for k, arch in enumerate(ARCHS):
        jcfg = jax_configs.reduced(jax_configs.get_config(arch))
        tcfg = configs.reduced(configs.get_config(arch))
        if jcfg.num_experts:
            jcfg = dataclasses.replace(jcfg, moe_capacity_factor=CF)
            tcfg = dataclasses.replace(tcfg, moe_capacity_factor=CF)
        tree = randomise(jax.jit(jax_model.init_params, static_argnums=1)(
            jax.random.PRNGKey(k), jcfg), seed=k)
        out[arch] = (jcfg, jax.tree.map(jax.numpy.asarray, tree), tcfg,
                     params_from_numpy(tree, tcfg, "cpu"))
    return out


def _scheduler(models, port):
    cfgs = [models[a][2 if port else 0] for a in ARCHS]
    graph, prof, sim, sched = ((build_transformer_graph, RuntimeEnergyProfiler, DeviceSim,
                                AdaOperScheduler) if port else
                               (jax_graph, JaxProfiler, JaxSim, JaxScheduler))
    p = prof(seed=0)
    p.offline_calibrate([graph(c, 4, MAX_LEN) for c in cfgs], n_samples=CALIB)
    return sched(p, sim("moderate", seed=0))


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


@pytest.mark.parametrize("scheduled", [False, True], ids=["fifo", "scheduled"])
def test_engine_matches_jax_engine_with_moe_drops(models, scheduled, monkeypatch):
    drops = []
    dispatch = tmoe.dispatch

    def recorded(ids, E, C):  # every MoE call's dropped assignments
        order, slot, valid = dispatch(ids, E, C)
        drops.append(int((~valid).sum()))
        return order, slot, valid
    monkeypatch.setattr(tmoe, "dispatch", recorded)
    sched = (lambda port: _scheduler(models, port)) if scheduled else (lambda port: None)
    jeng = JaxEngine(scheduler=sched(False), max_slots=4)
    teng = ServingEngine(scheduler=sched(True), max_slots=4)
    jres, tres = _serve(jeng, models, port=False), _serve(teng, models, port=True)
    assert sorted(tres) == sorted(jres) and len(tres) == 2 * len(MIXED)
    for uid, r in jres.items():
        assert tres[uid].error is None and r.error is None
        np.testing.assert_array_equal(tres[uid].tokens, r.tokens)
        np.testing.assert_allclose(tres[uid].energy_j_pred, r.energy_j_pred, rtol=1e-9)
    assert teng.admission.log == jeng.admission.log
    assert [(e.kind, e.model, e.n_active, e.uid) for e in teng.ledger.events] == \
        [(e.kind, e.model, e.n_active, e.uid) for e in jeng.ledger.events]
    for te, je in zip(teng.ledger.events, jeng.ledger.events):
        np.testing.assert_allclose([te.energy.total_j, te.energy.cpu_j, te.energy.gpu_j,
                                    te.energy.bus_j],
                                   [je.energy.total_j, je.energy.cpu_j, je.energy.gpu_j,
                                    je.energy.bus_j], rtol=1e-9, atol=0)
    assert teng.ledger.counters == jeng.ledger.counters
    assert teng.prefill_batches == jeng.prefill_batches
    if scheduled:
        assert {e["reason"] for e in teng.admission.log} - {"idle-pool"}, \
            "the workload must exercise the energy-aware branch"
        tsch, jsch = teng.scheduler, jeng.scheduler
        assert (tsch.plan_cache_hits, tsch.plan_cache_misses) == (
            jsch.plan_cache_hits, jsch.plan_cache_misses)
        assert teng.drift_events == jeng.drift_events
    # one MoE layer (of 2) per deepseek pass, and the published capacity
    # factor dropped assignments
    ds = teng.workers["deepseek-v2-lite-16b"]
    assert len(drops) == ds.prefill_calls + ds.decode_calls
    assert sum(drops) > 0


def test_serve_entry_point_runs_the_new_archs_on_cpu():
    """``repro_torch.launch.serve`` with the scheduler (the default) and FIFO
    on reduced deepseek-v2-lite-16b and qwen2-7b; the calibration covers
    their op graphs (MLA attention, MoE)."""
    for flag in ([], ["--no-scheduler"]):
        report = serve_cli.main(["--device", "cpu", "--models", ",".join(ARCHS), "--requests",
                                 "3", "--prompt-lens", "8,12", "--max-new", "3",
                                 "--max-slots", "2", "--max-len", "32"] + flag)
        assert report["requests"] == 6 and report["errors"] == 0 and report["tokens"] == 18
        assert report["scheduler"] == ("fifo" if flag else "adaoper")
    graph = build_transformer_graph(configs.get_config("deepseek-v2-lite-16b"), 4, 64)
    kinds = {n.op_type for n in graph.nodes}
    assert {"moe", "attention", "matmul"} <= kinds


@pytest.mark.parametrize("kind", ["truncated", "random"])
def test_mla_moe_speculative_decode_is_token_identical_to_plain(models, kind):
    """Speculation on the latent cache: the MLA verify scatters latents at
    the (B, T) grid and rejected suffixes roll back by the causal mask.
    The truncated self-draft (layer 0; the MoE layer's experts, shared
    experts and the attention output zeroed in the target) is accepted in
    full; a separately seeded 1-layer draft is mostly rejected. Either way
    the tokens are the plain engine's (FIFO). The MoE runs drop-free here
    (``reduced``'s capacity): at 1.25 a verify of B x T tokens and a step of
    B tokens get other capacities, so their drops, and the tokens, may
    differ, in the JAX package as in the port."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.speculative import truncated_draft
    _, _, tcfg, tp = models["deepseek-v2-lite-16b"]
    tcfg = configs.reduced(configs.get_config("deepseek-v2-lite-16b"))
    assert tcfg.moe_capacity_factor == tcfg.num_experts / tcfg.top_k  # drop-free
    if kind == "truncated":
        dcfg, dparams, tp = truncated_draft(tcfg, tp)
    else:
        dcfg = dataclasses.replace(tcfg, name=f"{tcfg.name}-draft1", num_layers=1)
        dparams = init_params(dcfg, seed=7, device="cpu")

    def run(draft):
        eng = ServingEngine(max_slots=4)
        eng.add_model("m", tcfg, tp, max_len=MAX_LEN, draft=draft)
        r = np.random.default_rng(3)
        for i, (plen, mn) in enumerate(MIXED):
            eng.submit("m", Request(i, r.integers(1, tcfg.vocab_size, plen, dtype=np.int32), mn))
        return {x.uid: x.tokens.tolist() for x in eng.run_all()}, eng
    plain, _ = run(None)
    spec, eng = run((dcfg, dparams))
    assert spec == plain
    c = eng.ledger.counters
    assert c["spec_rounds"] > 0 and eng.workers["m"].verify_calls > 0
    if kind == "truncated":
        assert c["spec_accepted"] == c["spec_drafted"] > 0
    else:
        assert c["spec_accepted"] < c["spec_drafted"]


def test_mla_moe_speculative_engine_at_capacity_1_25_matches_jax(models):
    """At the published capacity factor a verify of B x T tokens and a step
    of B tokens get other capacities, so speculation changes which
    assignments drop: the spec run's tokens differ from the plain run's
    here, in the JAX engine as in the port, and the port's spec and plain
    runs each equal the JAX engine's (the same converted 1-layer draft)."""
    jcfg, jp, tcfg, tp = models["deepseek-v2-lite-16b"]
    assert tcfg.moe_capacity_factor == CF
    djcfg = dataclasses.replace(jcfg, name=f"{jcfg.name}-draft1", num_layers=1)
    dtcfg = dataclasses.replace(tcfg, name=f"{tcfg.name}-draft1", num_layers=1)
    dtree = jax.tree.map(np.asarray, jax_model.init_params(jax.random.PRNGKey(7), djcfg))
    jdraft = (djcfg, jax.tree.map(jax.numpy.asarray, dtree))
    tdraft = (dtcfg, params_from_numpy(dtree, dtcfg, "cpu"))

    def run(port, draft):
        eng = (ServingEngine if port else JaxEngine)(max_slots=4)
        eng.add_model("m", tcfg if port else jcfg, tp if port else jp, max_len=MAX_LEN,
                      draft=draft)
        r = np.random.default_rng(3)
        for i, (plen, mn) in enumerate(MIXED):
            eng.submit("m", (Request if port else JaxRequest)(
                i, r.integers(1, tcfg.vocab_size, plen, dtype=np.int32), mn))
        return {x.uid: x.tokens.tolist() for x in eng.run_all()}
    jplain, jspec = run(False, None), run(False, jdraft)
    tplain, tspec = run(True, None), run(True, tdraft)
    assert tplain == jplain and tspec == jspec
    assert tspec != tplain
