"""Sharded serving in the port against the JAX package: the rule table
(``repro_torch.sharding.partition_specs`` and the port's mapping of its
modules onto the JAX tree) makes the reference's decisions for every
config in ``ARCHS`` at its full published shape on three stand-in meshes,
leaf by leaf and in the reports; ``comm_term`` / ``shard_plan`` stamp the
reference's plans; a mesh of one is token- and ledger-identical to no
mesh, continuous and bucketed, greedy and sampled, and in the fleet
replay; two CPU ranks (gloo) give the JAX package's unsharded greedy
tokens for reduced tinyllama-1.1b and reduced kimi-k2; and what the port
does not shard, or does not train sharded, is refused naming the leaf, M
and ROADMAP.md."""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro.sharding import comm as jax_comm  # noqa: E402
from repro.sharding import partition_specs as jax_ps  # noqa: E402
from repro.sharding.context import ExecContext as JaxCtx  # noqa: E402
from repro_torch import convert, fleet  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.core.opgraph import build_transformer_graph  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.fleet.workloads import ASSISTANT  # noqa: E402
from repro_torch.launch.mesh import (batch_axes_for, make_debug_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.sharded import generate_rank, run_ranks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving.engine import AdaOperScheduler, ServingEngine  # noqa: E402
from repro_torch.serving.slots import Request, _SlotPool  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402
from repro_torch.sharding import comm, placement  # noqa: E402
from repro_torch.sharding import partition_specs as ps  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402

MESHES = [dict(data=1, model=2), dict(data=16, model=16), dict(pod=2, data=16, model=16)]
REQS = [(8, 4), (12, 3), (8, 2), (10, 4)]
TWO_RANK_LIMIT_S = 60.0


class _FakeMesh:
    """The reference tests' stand-in: only the axis sizes."""

    def __init__(self, **shape):
        self.shape = shape


def _norm(spec):
    """A placement with each one-name tuple written as the name (JAX's
    ``PartitionSpec`` normalises ('data',) to 'data'; both mean the same)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)


def _flat(tree):
    out = {}

    def one(path, leaf):
        keys = [str(p.key) if hasattr(p, "key") else str(p.idx) for p in path]
        out["/".join(keys)] = tuple(leaf.shape)
    jax.tree_util.tree_map_with_path(one, tree)
    return out


@functools.cache
def _jax_params(arch):
    cfg = jax_configs.get_config(arch)
    return _flat(jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), cfg)))


@functools.cache
def _port_params(arch):
    return placement.jax_shapes(configs.get_config(arch))


def _reference_specs(arch, mesh):
    """The reference's ``params_shardings`` decisions leaf by leaf (its
    NamedShardings need a real mesh, so its loop is run on ``param_spec``)."""
    cfg = jax_configs.get_config(arch)
    fsdp = tuple(batch_axes_for(mesh)) if jax_ps.fsdp_default(cfg) else None
    rep, specs = jax_ps.ShardingReport(), {}
    for path, shape in _jax_params(arch).items():
        lead = 1 if "stages" in path.split("/") else 0
        spec = jax_ps.param_spec(path, shape[lead:], mesh, "model", fsdp, report=rep)
        specs[path] = _norm((None,) * lead + tuple(spec))
    return specs, rep


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_rule_table_matches_the_reference_at_full_shape(arch, shape):
    """Every config at its full published shape (JAX through
    ``jax.eval_shape``, the port on the meta device: nothing allocated):
    the same leaves and shapes, the same placement of every leaf, the same
    sharded / replicated counts and replication events; and the cache
    rules on the slot pool's caches (8 slots of 1024)."""
    assert _port_params(arch) == _jax_params(arch)
    mesh = _FakeMesh(**shape)
    ref, ref_rep = _reference_specs(arch, mesh)
    rep = ps.ShardingReport()
    got = ps.params_shardings(_port_params(arch), configs.get_config(arch), mesh, "model",
                              batch_axes_for(mesh), report=rep)
    assert {p: _norm(s) for p, s in got.items()} == ref
    assert (rep.sharded, rep.replicated) == (ref_rep.sharded, ref_rep.replicated)
    assert sorted(rep.events) == sorted(ref_rep.events)
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    enc = 512 if cfg.is_encoder_decoder else 0
    jcache = _flat(jax.eval_shape(lambda: jax_model.init_cache(jcfg, 8, 1024, enc_len=enc)))
    tcache = placement.cache_shapes(cfg, 8, 1024, enc)
    jname = {path.split("/")[-1]: s for path, s in jcache.items()}
    for batch in (8, 3):
        batch_ok = batch % int(np.prod([shape[a] for a in batch_axes_for(mesh)])) == 0
        for name, s in tcache.items():
            ref_name = "c_kv" if name == "latent" else name
            want = jax_ps.cache_spec(ref_name, jname[ref_name], mesh, batch_ok, "model",
                                     batch_axes_for(mesh))
            assert _norm(ps.cache_spec(name, s, mesh, batch_ok, "model",
                                       batch_axes_for(mesh))) == _norm(want), (name, batch)


def test_rule_table_pins_of_the_reference():
    """The reference's own rule pins, on the port's tuples."""
    mesh = _FakeMesh(data=2, model=4)
    rep = ps.ShardingReport()
    assert ps.param_spec("stages/0/l0/attn/wq", (256, 512), mesh, fsdp_axes=("data",),
                         report=rep) == (("data",), "model")
    assert ps.param_spec("stages/0/l0/attn/wo", (512, 256), mesh, report=rep) == ("model", None)
    assert ps.param_spec("stages/0/l0/attn/wq", (256, 511), mesh, report=rep) == (None, None)
    assert rep.events == [("stages/0/l0/attn/wq", 1, 511, "model")]
    few = (2, 4, 16, 2, 64)
    assert ps.cache_spec("k", few, _FakeMesh(data=1, model=4), batch_ok=True) == (
        None, ("data",), "model", None, None)
    assert ps.fsdp_default(configs.get_config("kimi-k2-1t-a32b"))
    assert not ps.fsdp_default(configs.get_config("tinyllama-1.1b"))
    assert ps.batch_shardings(configs.get_config("seamless-m4t-medium"), mesh, "train") == {
        "tokens": (("data",), None), "labels": (("data",), None),
        "enc_inputs": (("data",), None, None)}


@pytest.mark.parametrize("n", [2, 8])
def test_comm_stamps_the_reference_plans(n):
    """``comm_term`` and ``shard_plan`` at a real model axis of ``n`` (a
    stand-in mesh in both contexts), bf16 and fp32 configs."""
    for arch in ("kimi-k2-1t-a32b", "tinyllama-1.1b"):
        for cfg in (configs.get_config(arch), configs.reduced(configs.get_config(arch))):
            jcfg = jax_configs.get_config(arch) if cfg.dtype == "bfloat16" else \
                jax_configs.reduced(jax_configs.get_config(arch))
            mesh = _FakeMesh(data=1, model=n)
            ctx = ExecContext(mesh=mesh, batch_axes=("data",), model_axis="model")
            jctx = JaxCtx(mesh=mesh, batch_axes=("data",), model_axis="model")
            assert ctx.model_parallel == n
            for batch, tokens in ((8, 1), (4, 5), (1, 512)):
                term = comm.comm_term(cfg, ctx, batch, tokens)
                assert term == jax_comm.comm_term(jcfg, jctx, batch, tokens)
                plan = {"batch": batch, "step_energy": 2e-3, "step_latency": 1e-2,
                        "rails": (0.2, 0.7, 0.1)}
                assert comm.shard_plan(plan, term, "step_energy", "step_latency") == \
                    jax_comm.shard_plan(plan, term, "step_energy", "step_latency")
    assert comm.comm_term(configs.get_config("tinyllama-1.1b"), ExecContext(), 8, 1) is None


# ---------------------------------------------------------------------------
# a mesh of one
# ---------------------------------------------------------------------------


def _mesh1():
    return ExecContext(mesh=make_debug_mesh(1, 1, "cpu"), batch_axes=("data",), model_axis="model")


@functools.cache
def _tiny():
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    return cfg, tmodel.init_params(cfg, 0, "cpu")


@functools.cache
def _profiler():
    cfg, _ = _tiny()
    p = RuntimeEnergyProfiler(use_gru=False)
    p.offline_calibrate([build_transformer_graph(cfg, 2, 24)], n_samples=400, seed=0)
    return p


def _engine(ctx, mode):
    cfg, params = _tiny()
    eng = ServingEngine(scheduler=AdaOperScheduler(_profiler(), DeviceSim("moderate", seed=0)),
                        mode=mode, max_slots=4, sampling_seed=7)
    eng.add_model("m", cfg, params, max_len=32, ctx=ctx)
    r = np.random.default_rng(5)
    reqs = [Request(i, r.integers(1, cfg.vocab_size, plen, dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(REQS)]
    return eng, reqs


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mode", ["continuous", "bucketed"])
def test_mesh_of_one_token_and_ledger_identity(mode, temperature):
    """A ported worker on a (1, 1) mesh against one with no mesh: the same
    tokens per uid and predicted joules, the same ledger, no plan stamped
    with a communication term, and in continuous mode (``run_trace``'s
    virtual clock) the same latencies; a bucketed step's latency is its
    wall time."""
    out = {}
    for key, ctx in (("none", ExecContext()), ("mesh1", _mesh1())):
        eng, reqs = _engine(ctx, mode)
        if mode == "continuous":
            res = eng.run_trace([(0.01 * i, "m", r) for i, r in enumerate(reqs)],
                                temperature=temperature)
        else:
            for r in reqs:
                eng.submit("m", r)
            res = []
            while any(eng.queues.values()):
                res.extend(eng.step("m", temperature))
        out[key] = (eng, {r.uid: r for r in res})
    (e0, r0), (e1, r1) = out["none"], out["mesh1"]
    w = e1.workers["m"]
    assert w.mesh is not None and w.shard_report.sharded > 0 and w.params is e0.workers["m"].params
    assert set(r0) == set(r1) == set(range(len(REQS)))
    for uid in r0:
        assert np.array_equal(r0[uid].tokens, r1[uid].tokens), uid
        assert r0[uid].energy_j_pred == r1[uid].energy_j_pred
        if mode == "continuous":
            assert r0[uid].latency_s == r1[uid].latency_s
    t0, t1 = e0.ledger.total_energy(), e1.ledger.total_energy()
    assert (t0.total_j, t0.bus_j) == (t1.total_j, t1.bus_j)
    assert all("comm" not in p for p in e1._plan_memo.values())


def test_mesh_of_one_slot_pool_placements():
    """The pool cache of a meshed worker: the same bytes as the unsharded
    worker's after the same prefill and writes, and the placement the
    activation rules give it (``_SlotPool.cache_shardings``)."""
    cfg, params = _tiny()
    w0 = ModelWorker("a", cfg, params, max_len=32)
    w1 = ModelWorker("b", cfg, params, max_len=32, ctx=_mesh1())
    assert _SlotPool(w0, 4).cache_shardings is None and w0.param_shardings is None
    pool = _SlotPool(w1, 4)
    assert set(pool.cache_shardings) == set(pool.cache) == {"k", "v"}
    assert pool.cache_shardings["k"] == (None, ("data",), None, "model", None)
    assert w1.param_shardings["stages/0/l0/attn/wq"] == (None, None, "model")
    prompts = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    caches = []
    for w in (w0, w1):
        _, c = w.prefill_batch(prompts)
        caches.append(w.write_slots(w.init_pool(4), c, np.array([0, 2])))
    for name in caches[0]:
        assert torch.equal(caches[0][name], caches[1][name])


def test_sharded_worker_allocates_its_piece_of_the_cache_placement():
    """A worker on a stand-in mesh of model 2 (no process group: its rank
    is 0) allocates its pool cache as its piece of ``plan_cache``'s
    placement: the K/V leaves hold half the kv heads, the rest is whole."""
    cfg, params = _tiny()
    ctx = ExecContext(mesh=_FakeMesh(data=1, model=2), batch_axes=("data",), model_axis="model")
    w = ModelWorker("a", cfg, params, max_len=32, ctx=ctx)
    pool = _SlotPool(w, 4)
    full = tmodel.init_cache(cfg, 4, 32, device="cpu")
    assert pool.cache_shardings == placement.plan_cache(cfg, ctx, 4, 32)
    for name, leaf in pool.cache.items():
        want = list(full[name].shape)
        if pool.cache_shardings[name][3] == "model":
            want[3] //= 2
        assert list(leaf.shape) == want and leaf.dtype == full[name].dtype, name
    assert pool.cache["k"].shape[3] == cfg.num_kv_heads // 2


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)],
                         ids=["single_pod", "multi_pod"])
def test_production_mesh_needs_its_devices(multi_pod, need):
    """The production builder names the devices it needs and raises when
    the process group does not hold them (none here)."""
    with pytest.raises(RuntimeError, match=f"needs {need} devices"):
        make_production_mesh(multi_pod=multi_pod)


def test_fleet_mesh_of_one_equals_no_mesh():
    """The serving fleet replay with a (1, 1) mesh in ``serving_ctx``: the
    same report and the same assistant tokens per device and uid."""
    cfg, params = _tiny()
    kw = dict(scenario="mixed", backend="serving", duration_s=2.5, seed=3, calib_samples=60,
              serving_models={ASSISTANT: (cfg, params)})
    runs = []
    for ctx in (None, _mesh1()):
        rep = fleet.FleetReplay(fleet.sample_population(1, seed=2), serving_ctx=ctx, **kw)
        out = rep.run().to_dict()
        toks = [{r.uid: r.tokens.tolist() for r in dr.responses} for dr in rep.device_replays]
        runs.append((out, toks))
    assert runs[0] == runs[1]
    assert sum(len(t) for t in runs[0][1]) > 0


# ---------------------------------------------------------------------------
# one rank's shard, and two ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "kimi-k2-1t-a32b", "gemma2-2b", "qwen2-7b",
                                  "deepseek-v2-lite-16b", "mamba2-2.7b", "seamless-m4t-medium",
                                  "jamba-v0.1-52b"])
def test_sharded_draw_is_a_slice_of_the_whole_draw(arch, monkeypatch):
    """``init_params(ctx=...)`` at a model axis of 2 draws each rank's
    shard without the whole model, and the shard is ``shard_params`` of the
    whole model's weights, leaf by leaf; also when the large leaves are
    drawn in pieces (thresholds lowered so that the reduced leaves are),
    the SSM mixers' segmented leaves included (``placement``)."""
    cfg = configs.reduced(configs.get_config(arch))
    ctx = ExecContext(mesh=_FakeMesh(data=1, model=2), batch_axes=("data",), model_axis="model")
    for pieces in (False, True):
        if pieces:
            monkeypatch.setattr(tmodel, "_WHOLE_DRAW", 5000)
            monkeypatch.setattr(tmodel, "_PIECE", 3000)
        whole = tmodel.init_params(cfg, 3, "cpu")
        for rank in (0, 1):
            want = convert.shard_params(whole, ctx, rank=rank)
            got = tmodel.init_params(cfg, 3, "cpu", ctx=ctx, rank=rank)
            assert got.shard == want.shard == (2, rank)
            a, b = dict(got.named_parameters()), dict(want.named_parameters())
            assert a.keys() == b.keys()
            for name in a:
                assert torch.equal(a[name], b[name]), (pieces, rank, name)
        # the cut leaves are halves: q heads, kv heads, d_ff or experts, vocab
        half = dict(want.named_parameters())
        assert half["embedding"].shape[0] == cfg.padded_vocab // 2
        if "layers.0.attn.wk.weight" in half:
            assert half["layers.0.attn.wk.weight"].shape[0] == cfg.kv_dim // 2


def test_two_ranks_match_the_jax_unsharded_tokens():
    """Two CPU ranks (gloo, a FileStore, spawned; a time limit of their
    own) run ``ModelWorker.generate(prompts, 6)`` in fp32 on reduced
    tinyllama-1.1b (2 on 1 heads per rank) and reduced kimi-k2 (2 of 4
    experts per rank), weights from the JAX package's tree: both ranks'
    greedy tokens equal the JAX package's unsharded worker's, and both
    ranks' reports count sharded dims."""
    jobs, refs = [], []
    prompts = (np.arange(1, 25, dtype=np.int32).reshape(2, 12) * 7) % 500
    for arch in ("tinyllama-1.1b", "kimi-k2-1t-a32b"):
        jcfg = jax_configs.reduced(jax_configs.get_config(arch))
        jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
        refs.append(JaxWorker("u", jcfg, jp, max_len=24).generate(prompts, 6))
        jobs.append(dict(cfg=configs.reduced(configs.get_config(arch)),
                         tree=jax.tree.map(np.asarray, jp), prompts=prompts, max_new=6,
                         max_len=24))
    ranks = run_ranks(generate_rank, 2, (jobs, 2, "cpu"), timeout=TWO_RANK_LIMIT_S,
                      device_type="cpu")
    for rank, out in enumerate(ranks):
        for job, ref, got in zip(jobs, refs, out):
            np.testing.assert_array_equal(got["tokens"], ref, err_msg=job["cfg"].name)
            assert got["sharded"] > 0 and got["shard"] == (2, rank)


def test_refusals_name_the_leaf_and_the_roadmap():
    """No process group needed: reduced tinyllama (2 kv heads) on a model
    axis of 4 (each kv head whole on 2 ranks, one kv head per rank in the
    K/V cache and half its sequence), reduced kimi with 6 experts on 4 (every expert whole on
    every rank) and reduced jamba (Mamba1 layers) on 2 are placed for
    serving and train alike: train mode's mesh check
    (``check_train_mesh``) takes each, as it takes reduced
    deepseek-v2-lite (MLA), mamba2 and seamless-m4t on 2 (their gradients:
    tests/test_torch_sharded_train_families.py), and ``make_train_step``
    draws each plan. What stays refused is refused for serving and
    training alike, naming the leaf, M and ROADMAP.md: kv heads that
    neither divide M nor are divided by it (6 on a model axis of 4). A
    slot pool that a data axis of 2 does not divide is placed with its
    K/V sequence cut over the data axis and its rows whole, the rule
    table's fallback."""
    from repro_torch.training.train_loop import make_train_step

    def ctx(**shape):
        return ExecContext(mesh=_FakeMesh(**shape), batch_axes=("data",), model_axis="model")
    kimi = dataclasses.replace(configs.reduced(configs.get_config("kimi-k2-1t-a32b")),
                               num_experts=6)
    cases = [("tinyllama-1.1b", 4), ("jamba-v0.1-52b", 2), (kimi, 4),
             ("deepseek-v2-lite-16b", 2), ("mamba2-2.7b", 2), ("seamless-m4t-medium", 2)]
    for arch, m in cases:
        cfg = arch if not isinstance(arch, str) else configs.reduced(configs.get_config(arch))
        assert placement.plan_params(cfg, ctx(data=1, model=m)).shape == (1, m)
        tmodel.check_train_mesh(SimpleNamespace(shard=(m, 0)), ctx(data=1, model=m))
        make_train_step(cfg, ctx(data=1, model=m))
    six = dataclasses.replace(configs.reduced(configs.get_config("tinyllama-1.1b")),
                              num_heads=12, num_kv_heads=6)
    for draw in (placement.plan_params, make_train_step):
        with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
            draw(six, ctx(data=1, model=4))
        msg = str(e.value)
        assert "attn/wk: 6 kv heads" in msg and "model axis of 4" in msg, msg
        assert "serving or training" in msg, msg
    kplan = placement.plan_params(kimi, ctx(data=1, model=4))
    assert all(kplan.dims[f"layers.0.mlp.{w}"] is None for w in ("w_gate", "w_up", "w_down"))
    tiny = configs.reduced(configs.get_config("tinyllama-1.1b"))
    wide = placement.plan_params(tiny, ctx(data=1, model=4))
    wk = "layers.0.attn.wk.weight"
    assert wide.dims[wk] == 0 and wide.ways[wk] == 2 and wide.replicas(wk) == 2
    assert [tmodel.cuts(wide, wk, r)[0][1:3] for r in range(4)] == [(2, 0), (2, 0), (2, 1),
                                                                     (2, 1)]
    specs = placement.plan_cache(tiny, ctx(data=1, model=4), 8, 32)
    assert specs["k"] == (None, ("data",), "model", "model", None)
    assert placement.local_cache_shape(tiny, ctx(data=1, model=4), "k", (2, 8, 32, 2, 64),
                                       specs["k"]) == (2, 8, 16, 1, 64)
    assert placement.plan_params(tiny, ctx(data=2, model=1)).shape == (2, 1)
    odd = placement.plan_cache(tiny, ctx(data=2, model=1), 3, 33)
    assert odd["k"] == odd["v"] == (None, None, "data", "model", None)
    assert placement.local_cache_shape(tiny, ctx(data=2, model=1), "k", (2, 3, 33, 2, 64),
                                       odd["k"]) == (2, 3, 17, 2, 64)
    plan = placement.plan_params(tiny, ctx(data=1, model=2))
    assert plan.dims["layers.0.attn.wq.weight"] == 0 and plan.dims["layers.0.attn.wo.weight"] == 1
    assert plan.dims["embedding"] == 0 and plan.dims["final_norm.scale"] is None


def _fail_or_linger(rank):
    """Rank 0 raises; rank 1 would go on for minutes (as a rank waiting on
    rank 0 in a collective does)."""
    import time
    if rank == 0:
        raise RuntimeError("rank 0 fails on purpose")
    time.sleep(300)


def test_run_ranks_fails_at_once_when_a_rank_raises():
    """``run_ranks`` reports a rank's error as soon as it comes and kills
    the other ranks, instead of waiting for them until its time limit."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 fails on purpose"):
        run_ranks(_fail_or_linger, 2, (), timeout=240.0, device_type="cpu")
    assert time.monotonic() - t0 < 60.0


def test_make_debug_mesh_asks_for_the_card_by_default(monkeypatch):
    """``launch.mesh.make_debug_mesh`` runs on the card unless the caller
    asks for the CPU: with no card there, the default raises naming
    ``device_type="cpu"`` (and starts no process group) instead of falling
    back to the CPU; with a card it asks for "cuda"."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    was = dist.is_initialized()
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        tmesh.make_debug_mesh(1, 1)
    assert dist.is_initialized() == was
    asked = []
    monkeypatch.setattr(tmesh, "_mesh", lambda device_type, shape, names: asked.append(
        (device_type, shape)))
    tmesh.make_debug_mesh(1, 1, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tmesh.make_debug_mesh(2, 2)
    assert asked == [("cpu", (1, 1)), ("cuda", (2, 2))]


# ---------------------------------------------------------------------------
# the data axis: FSDP placement, the batch split, data-parallel serving
# ---------------------------------------------------------------------------


def _reference_fsdp_specs(arch, mesh):
    """The reference's ``params_shardings(..., fsdp=True)`` decisions, leaf
    by leaf (its loop run on ``param_spec`` with the FSDP axes)."""
    rep, specs = jax_ps.ShardingReport(), {}
    for path, shape in _jax_params(arch).items():
        lead = 1 if "stages" in path.split("/") else 0
        spec = jax_ps.param_spec(path, shape[lead:], mesh, "model", tuple(batch_axes_for(mesh)),
                                 report=rep)
        specs[path] = _norm((None,) * lead + tuple(spec))
    return specs, rep


FSDP_MESHES = [dict(data=2, model=2), dict(data=16, model=16), dict(pod=2, data=16, model=16)]


@pytest.mark.parametrize("shape", FSDP_MESHES, ids=["2x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_rule_table_with_fsdp_matches_the_reference(arch, shape):
    """``fsdp=True`` (as the reference's ``build_lowered(fsdp=)`` passes
    it): every leaf's placement, counts and replication events equal the
    reference's on the stand-in meshes."""
    mesh = _FakeMesh(**shape)
    ref, ref_rep = _reference_fsdp_specs(arch, mesh)
    rep = ps.ShardingReport()
    got = ps.params_shardings(_port_params(arch), configs.get_config(arch), mesh, "model",
                              batch_axes_for(mesh), fsdp=True, report=rep)
    assert {p: _norm(s) for p, s in got.items()} == ref
    assert (rep.sharded, rep.replicated) == (ref_rep.sharded, ref_rep.replicated)
    assert sorted(rep.events) == sorted(ref_rep.events)


def test_plan_params_turns_fsdp_into_the_dims_a_rank_holds():
    """On a (2, 2) stand-in with FSDP, each port tensor's model dim and
    data dim follow the table's placement through the transposes of
    ``nn.Linear`` (JAX (d_in, d_out), the port (d_out, d_in)); without
    FSDP the data axis cuts nothing; the replica counts the global norm
    divides by."""
    tiny = configs.reduced(configs.get_config("tinyllama-1.1b"))
    ctx = ExecContext(mesh=_FakeMesh(data=2, model=2), batch_axes=("data",), model_axis="model",
                      fsdp=True)
    plan = placement.plan_params(tiny, ctx)
    assert plan.shape == (2, 2)
    assert (plan.dims["layers.0.attn.wq.weight"], plan.data_dims["layers.0.attn.wq.weight"]) == (
        0, 1)
    assert (plan.dims["layers.0.attn.wo.weight"], plan.data_dims["layers.0.attn.wo.weight"]) == (
        1, 0)
    assert (plan.dims["embedding"], plan.data_dims["embedding"]) == (0, 1)
    assert plan.data_dims["final_norm.scale"] is None and plan.replicas("final_norm.scale") == 4
    assert plan.replicas("layers.0.attn.wq.weight") == 1
    off = placement.plan_params(tiny, dataclasses.replace(ctx, fsdp=False))
    assert not any(d is not None for d in off.data_dims.values())
    assert off.replicas("layers.0.attn.wq.weight") == 2
    chameleon = configs.reduced(configs.get_config("chameleon-34b"))
    assert placement.plan_params(chameleon, ctx).partial == frozenset(
        n for n, _ in tmodel.CausalLM(chameleon, device="meta").named_parameters()
        if ".q_norm." in n or ".k_norm." in n)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "seamless-m4t-medium"])
def test_batch_shardings_match_the_reference(arch):
    """``batch_shardings`` against the reference's on a mesh of the host's
    one device (its NamedShardings need a real mesh): the batch dim on the
    batch axes, every other dim whole; and the rows a data rank takes."""
    from jax.sharding import Mesh

    from repro_torch.training.train_loop import shard_batch
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    want = {k: _norm(tuple(v.spec)) for k, v in jax_ps.batch_shardings(jcfg, jmesh, "train")
            .items()}
    got = {k: _norm(v) for k, v in ps.batch_shardings(cfg, _FakeMesh(data=1, model=1),
                                                      "train").items()}
    assert got == want
    ctx = ExecContext(mesh=_FakeMesh(data=2, model=1), batch_axes=("data",), model_axis="model")
    batch = {"tokens": np.arange(12).reshape(4, 3), "labels": np.arange(12).reshape(4, 3)}
    assert np.array_equal(shard_batch(batch, cfg, ctx)["tokens"], batch["tokens"][:2])


def _dp_requests(cfg):
    r = np.random.default_rng(5)
    return [(i, r.integers(1, cfg.vocab_size, plen, dtype=np.int32), mn)
            for i, (plen, mn) in enumerate([(8, 4), (12, 3), (8, 2), (10, 4), (8, 5), (12, 2)])]


# mesh -> (arch, fsdp, scheduled, temperature, plan)
DP_JOBS = {(2, 1): [("tinyllama-1.1b", None, False, 0.0, None),
                    ("tinyllama-1.1b", True, False, 0.8, None),
                    ("tinyllama-1.1b", None, True, 0.0, None),
                    ("mamba2-2.7b", None, False, 0.0, None)],
           (2, 2): [("tinyllama-1.1b", None, False, 0.0, None),
                    ("tinyllama-1.1b", True, True, 0.8, None),
                    ("kimi-k2-1t-a32b", None, False, 0.0, None),
                    ("kimi-k2-1t-a32b", True, False, 0.0, {"moe_2d": True})]}
DP_CASES = [(m, i) for m in DP_JOBS for i in range(len(DP_JOBS[m]))]


def _dp_job(arch, fsdp, scheduled, temperature, plan):
    cfg = configs.reduced(configs.get_config(arch))
    return dict(cfg=cfg, seed=0, requests=_dp_requests(cfg), max_slots=4, max_len=32,
                fsdp=fsdp, scheduled=scheduled, temperature=temperature, plan=plan)


@pytest.fixture(scope="module")
def dp_runs():
    """Each data-parallel mesh's ranks, once (spawned, gloo, a time limit)."""
    from repro_torch.launch.sharded import engine_rank
    return {mesh: run_ranks(engine_rank, mesh[0] * mesh[1],
                            ([_dp_job(*spec) for spec in jobs], mesh, "cpu"),
                            timeout=4 * TWO_RANK_LIMIT_S, device_type="cpu")
            for mesh, jobs in DP_JOBS.items()}


@pytest.mark.parametrize("mesh,i", DP_CASES,
                         ids=[f"{m[0]}x{m[1]}-{DP_JOBS[m][i][0]}-{i}" for m, i in DP_CASES])
def test_data_parallel_serving_matches_the_unsharded_port(dp_runs, mesh, i):
    """Continuous serving on a data axis of 2 (FIFO and scheduled, greedy
    and sampled, with and without FSDP; reduced tinyllama, mamba2, and
    kimi-k2's MoE at (2, 2), expert-parallel and 2-D): every rank's tokens
    per uid equal the unsharded port's in fp32, every rank holds half the
    slot pool and runs as many passes as the unsharded worker."""
    from repro_torch.launch.sharded import serve_job
    job = _dp_job(*DP_JOBS[mesh][i])
    want = serve_job(job, ExecContext(), "cpu")
    for rank, got in enumerate(r[i] for r in dp_runs[mesh]):
        assert got["errors"] == [] and got["tokens"] == want["tokens"], rank
        assert got["pool_rows"] == job["max_slots"] // mesh[0]
        assert (got["prefill_calls"], got["decode_calls"]) == (want["prefill_calls"],
                                                               want["decode_calls"])
        fsdp = bool(job["fsdp"])
        assert (got["data_shard"] is not None) == fsdp
        assert got["shard"] == ((mesh[1], rank % mesh[1]) if mesh[1] > 1 else None)


def test_data_axis_refusals_name_the_mode_and_the_roadmap():
    """On a data axis of 2 nothing of the serving modes is refused: the
    bucketed mode and a speculative draft are taken (their runs on two
    ranks: ``tests/test_torch_data_axis.py``), a pool of 3 slots is cut
    on its K/V sequence, one of 4 on its rows; a prefill of a row-split
    pool without the group's slots is refused."""
    cfg, params = _tiny()
    ctx = ExecContext(mesh=_FakeMesh(data=2, model=1), batch_axes=("data",), model_axis="model")
    w = ModelWorker("a", cfg, params, max_len=32, ctx=ctx)
    with pytest.raises(ValueError, match="needs the group's slots"):
        w.prefill_batch(np.ones((2, 4), np.int32))
    assert next(iter(w.init_pool(4).values())).shape[1:3] == (2, 32) and w.rows_split
    assert next(iter(w.init_pool(3).values())).shape[1:3] == (3, 16) and w.pool_seq
    eng = ServingEngine(mode="bucketed")
    eng.add_model("b", cfg, params, ctx=ctx)
    eng = ServingEngine()
    eng.add_model("m", cfg, params, ctx=ctx, draft=(cfg, params))
    assert eng.spec["m"].worker.ctx is eng.workers["m"].ctx
