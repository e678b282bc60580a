"""Sharded training of MLA, Mamba2 and the encoder-decoder in the port on a
(data, model) mesh of gloo ranks on the CPU: reduced deepseek-v2-lite-16b
(MLA and its MoE) and reduced mamba2-2.7b on (1, 2) and on (2, 2) with
FSDP, reduced seamless-m4t-medium on (1, 2). The JAX package's own sharded
``loss_fn`` raises ``ShardingTypeError`` on every mesh here (ROADMAP.md,
Queue 3), so each job is held, as ``tests/test_torch_sharded_train.py``
holds the GQA stacks, against the port's unsharded step and the JAX
package's unsharded ``loss_fn`` on each data shard's rows (the loss is the
mean of the data ranks' means; the MoE sizes its capacity and aux loss from
the rank's own tokens), on the same weights (the JAX tree carried over by
``convert``).

What these families add on a model axis is checked on its own too: the
gated norm's all-reduced sum of squares and MLA's replicated latent path
each give the unsharded gradient at M = 2, ``global_norm`` over the pieces
of a Mamba2 tree (whose B and C rows every model rank holds) is the whole
tree's, a Mamba2 checkpoint saved on (2, 2) with FSDP restores on no
mesh and on (1, 2) bit for bit, and ``checkpoint.whole`` puts the model
ranks' pieces of every leaf back into the unsharded leaf where a rank holds
other rows than its 1/M slice (Mamba2's segments, kv heads cut fewer ways
than M, padded query heads).

Each mesh runs once, in a module fixture (one spawn of its ranks, torch at
one thread per rank). Tolerances (fp32): the loss 1e-5 relative, each
gradient leaf 1e-5 of its largest |value| against the port and 2e-5
against JAX.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import named_arrays, params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.sharded import run_ranks, train_rank  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.sharding import collectives, placement  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402
from repro_torch.training.checkpoint import restore_checkpoint, whole  # noqa: E402
from repro_torch.training.optimizer import (OptConfig, adamw_update,  # noqa: E402
                                            global_norm, init_opt_state)
from repro_torch.training.train_loop import batch_to_device, loss_and_grads  # noqa: E402

# 40 positions cross the reduced Mamba2's 32-position SSD chunk
B, S, FRAMES = 4, 40, 12
OC = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL, GRAD_TOL, JAX_TOL = 1e-5, 1e-5, 2e-5
RANK_LIMIT_S = 180.0
ARCHS = {"mla": "deepseek-v2-lite-16b", "mamba2": "mamba2-2.7b",
         "seamless": "seamless-m4t-medium"}
# each mesh's jobs: (family, fsdp)
JOBS = {"1x2": [("mla", None), ("mamba2", None), ("seamless", None)],
        "2x2": [("mamba2", True), ("mla", True)]}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
CASES = [(m, i) for m in MESHES for i in range(len(JOBS[m]))]
IDS = [f"{m}-{JOBS[m][i][0]}" for m, i in CASES]
GATED_WIDTH = 24  # the gated-norm probe's channels, 12 per rank


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process too (the ranks pin their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _pair(family):
    arch = ARCHS[family]
    jcfg = jax_configs.reduced(jax_configs.get_config(arch))
    tcfg = configs.reduced(configs.get_config(arch))
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, jax.tree.map(np.asarray, jp)


def _data():
    return DataConfig(batch=B, seq_len=S, enc_frames=FRAMES)


def _batch(tcfg):
    return SyntheticLM(tcfg, _data()).batch(0)


def _job(family, fsdp, **kw):
    tcfg, tree = _pair(family)[2:]
    return dict(cfg=tcfg, tree=tree, batch=B, seq=S, enc_frames=FRAMES, steps=1, oc=OC,
                fsdp=fsdp, grads=True, weights=True, **kw)


# ---------------------------------------------------------------------------
# the probes each rank runs besides its jobs
# ---------------------------------------------------------------------------


def _gated_inputs():
    r = np.random.default_rng(5)
    y, z, coeff = (r.standard_normal((2, 5, GATED_WIDTH)).astype(np.float32) for _ in range(3))
    scale = r.uniform(0.5, 1.5, GATED_WIDTH).astype(np.float32)
    return y, z, scale, coeff


def _gated_grads(ctx):
    """The gradients of y, z and the scale of ``ssm._gated_rmsnorm`` under a
    fixed linear loss, on the model rank's channels (all of them without a
    model axis)."""
    from repro_torch.models import ssm
    y, z, scale, coeff = _gated_inputs()
    n = GATED_WIDTH // ctx.model_parallel
    mine = slice(ctx.model_rank * n, (ctx.model_rank + 1) * n)
    ts = [torch.from_numpy(a[..., mine].copy()).requires_grad_(True) for a in (y, z, scale)]
    out = ssm._gated_rmsnorm(*ts, SimpleNamespace(d_inner=GATED_WIDTH), ctx)
    (out * torch.from_numpy(coeff[..., mine].copy())).sum().backward()
    return [t.grad.numpy() for t in ts]


def _mla_inputs(d_model):
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 9, d_model)).astype(np.float32)
    return x, r.standard_normal((2, 9, d_model)).astype(np.float32)


def _mla_grads(attn, cfg, ctx):
    """The gradients of the input and of the latent path's whole leaves
    (``w_dkv``, ``kv_norm``; summed over the model axis as ``sync_grads``
    sums them) of MLA's train forward between the f/g pair, under a fixed
    linear loss."""
    from repro_torch.models import attention
    from repro_torch.sharding import collectives
    x, coeff = (torch.from_numpy(a) for a in _mla_inputs(cfg.d_model))
    x.requires_grad_(True)
    attn.requires_grad_(True)
    h = collectives.copy_to_model(x, ctx)
    y, _ = attention.mla_forward(attn, h, cfg, impl=attention.TRAIN_IMPL)
    (collectives.reduce_from_model(y, ctx) * coeff).sum().backward()
    return {"x": x.grad.numpy(),
            "w_dkv": collectives.all_reduce_model(attn.w_dkv.weight.grad, ctx).numpy(),
            "kv_norm": collectives.all_reduce_model(attn.kv_norm.scale.grad, ctx).numpy()}


def _norm_tree(tcfg):
    """Random fp32 tensors of the model's parameter shapes."""
    r = np.random.default_rng(7)
    return {n: torch.from_numpy(r.standard_normal(tuple(p.shape)).astype(np.float32))
            for n, p in tmodel.CausalLM(tcfg, device="meta").named_parameters()}


def _rank(rank, mesh, jobs, probes):
    """One rank: the training jobs (``launch.sharded.train_rank``), then on
    the same mesh the probes: at (1, 2) the gated norm and MLA's latent
    path (``probes["mla"]``: config and numpy tree), at (2, 2)
    ``global_norm`` over this rank's pieces of a Mamba2 tree
    (``probes["norm"]``: its config)."""
    torch.set_num_threads(1)
    from repro_torch.convert import shard_params
    from repro_torch.launch.mesh import make_debug_mesh
    out = {"train": train_rank(rank, jobs, mesh, "cpu")}
    ctx = ExecContext(mesh=make_debug_mesh(mesh[0], mesh[1], "cpu"), batch_axes=("data",),
                      model_axis="model", fsdp=True)
    if "mla" in probes:
        out["gated"] = _gated_grads(ctx)
        cfg, tree = probes["mla"]
        params = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
        out["mla"] = _mla_grads(params.layers[0].attn, cfg, ctx)
    if "norm" in probes:
        cfg = probes["norm"]
        plan = placement.plan_params(cfg, ctx)
        pieces = {n: tmodel.cut(t, tmodel.cuts(plan, n, rank))
                  for n, t in _norm_tree(cfg).items()}
        out["global_norm"] = float(global_norm(pieces, plan, ctx))
    return out


def _run(name, extra_jobs=(), save=None):
    """A mesh's ranks on its jobs (``save``: the first job's checkpoint
    directory) and its probes."""
    D, M = MESHES[name]
    jobs = [_job(*spec) for spec in JOBS[name]] + list(extra_jobs)
    if save:
        jobs[0]["save"] = save
    probes = ({"norm": _pair("mamba2")[2]} if D > 1 else
              {"mla": (_pair("mla")[2], _pair("mla")[3])})
    return run_ranks(_rank, D * M, ((D, M), jobs, probes), timeout=RANK_LIMIT_S,
                     device_type="cpu")


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt_mamba2_2x2"))


@pytest.fixture(scope="module")
def runs(ckpt_dir):
    """Each mesh's ranks, once: (2, 2) saves the Mamba2 job's checkpoint
    after its step, which (1, 2) restores."""
    out = {"2x2": _run("2x2", save=ckpt_dir)}
    restore = dict(_job("mamba2", None), steps=0, grads=False, restore=ckpt_dir)
    out["1x2"] = _run("1x2", [restore])
    return out


# ---------------------------------------------------------------------------
# references: the port's unsharded step and the JAX package's loss_fn
# ---------------------------------------------------------------------------


def _shards(batch, n):
    k = B // n
    return [{key: v[i * k:(i + 1) * k] for key, v in batch.items()} for i in range(n)]


@functools.cache
def _port_ref(family, D):
    """The unsharded port's mean over D data shards: (loss, grads, grad
    norm, params after one AdamW step)."""
    tcfg, tree = _pair(family)[2:]
    params = params_from_numpy(tree, tcfg, "cpu")
    named = tmodel.train_params(params)
    losses, acc = [], None
    for sh in _shards(_batch(tcfg), D):
        loss, _, g = loss_and_grads(params, tcfg, batch_to_device(sh, "cpu"))
        losses.append(float(loss.detach()))
        g = {k: v.clone() for k, v in g.items()}
        acc = g if acc is None else {k: acc[k] + g[k] for k in g}
    grads = {k: v / D for k, v in acc.items()}
    gn = float(global_norm(grads))
    state = init_opt_state(named)
    adamw_update(named, grads, state, OC)
    return (float(np.mean(losses)), {k: v.numpy() for k, v in grads.items()}, gn,
            {k: p.detach().numpy().copy() for k, p in named.items()})


@functools.cache
def _jax_ref(family, D):
    """The JAX package's unsharded loss_fn, the mean over D data shards."""
    jcfg, jp, tcfg, _ = _pair(family)
    b = jax_data.SyntheticLM(jcfg, jax_data.DataConfig(batch=B, seq_len=S,
                                                       enc_frames=FRAMES)).batch(0)
    fn = jax.jit(jax.value_and_grad(lambda p, bb: jax_model.loss_fn(p, jcfg, bb), has_aux=True))
    losses, acc = [], None
    for sh in _shards(b, D):
        (loss, _), g = fn(jp, jax.tree.map(jnp.asarray, sh))
        losses.append(float(loss))
        g = named_arrays(jax.tree.map(np.asarray, g), tcfg)
        acc = g if acc is None else {k: acc[k] + g[k] for k in g}
    return float(np.mean(losses)), {k: v / D for k, v in acc.items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _close(got, want, tol, msg):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=msg)


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,i", CASES, ids=IDS)
def test_loss_and_grads_match_the_unsharded_port(runs, name, i):
    """Every rank's global mean loss, its clipping norm (``global_norm``
    on the pieces) and every gradient leaf gathered whole (segmented
    leaves put back segment by segment) against the port's unsharded
    step, the mean over the data shards."""
    family = JOBS[name][i][0]
    loss, grads, gn, _ = _port_ref(family, MESHES[name][0])
    for rank, r in enumerate(runs[name]):
        res = r["train"][i]
        assert _rel(res["history"][0]["loss"], loss) <= LOSS_RTOL, (rank, res["history"][0])
        assert _rel(res["history"][0]["grad_norm"], gn) <= LOSS_RTOL
        assert set(res["grads"]) == set(grads)
        for leaf, ref in grads.items():
            _close(res["grads"][leaf], ref, GRAD_TOL, f"rank {rank} {leaf}")


@pytest.mark.parametrize("name,i", CASES, ids=IDS)
def test_loss_and_grads_match_the_jax_package(runs, name, i):
    """The same against the JAX package's unsharded ``loss_fn`` and its
    gradients (``jax.value_and_grad``), shard by shard."""
    family = JOBS[name][i][0]
    loss, grads = _jax_ref(family, MESHES[name][0])
    res = runs[name][0]["train"][i]
    assert _rel(res["history"][0]["loss"], loss) <= LOSS_RTOL
    for leaf, ref in grads.items():
        _close(res["grads"][leaf], ref, JAX_TOL, leaf)


@pytest.mark.parametrize("name,i", CASES, ids=IDS)
def test_one_adamw_step_matches_the_unsharded_step(runs, name, i):
    """The params after one AdamW step on the mesh, gathered whole, against
    the unsharded AdamW step of the whole model fed the gradients the mesh
    computed (gathered whole; the two tests above hold them to the
    unsharded ones): every element within 1e-5 of its leaf's scale. Fed
    the unsharded gradients instead, an element whose gradient is a few
    times AdamW's eps moves by ~1e3 times its gradient's relative error
    (seamless's cross-norm biases start at 0 with such gradients), so the
    gradients and the update are held apart."""
    family = JOBS[name][i][0]
    tcfg, tree = _pair(family)[2:]
    res = runs[name][-1]["train"][i]
    named = tmodel.train_params(params_from_numpy(tree, tcfg, "cpu"))
    adamw_update(named, {k: torch.from_numpy(g) for k, g in res["grads"].items()},
                 init_opt_state(named), OC)
    for leaf, p in named.items():
        _close(res["weights"][leaf], p.detach().numpy(), GRAD_TOL, leaf)


def test_the_families_train_on_their_shards(runs):
    """Each job ran on the rank's shard (FSDP cutting the data axis at
    (2, 2)), every rank of the mesh reports the same loss, and the steps
    summed the partial gradients over the model axis."""
    for name, rr in runs.items():
        D, M = MESHES[name]
        for i in range(len(JOBS[name])):
            got = [(r["train"][i]["shard"], r["train"][i]["data_shard"]) for r in rr]
            assert got == [((M, rank % M), (D, rank // M) if D > 1 else None)
                           for rank in range(D * M)]
            assert len({r["train"][i]["history"][0]["loss"] for r in rr}) == 1
            assert rr[0]["train"][i]["collectives"][0].get("all_reduce", 0) > 0


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------


def test_the_gated_norm_and_the_mla_latent_path_have_the_unsharded_gradients(runs):
    """At M = 2 the gated norm's sum of squares goes through
    ``sum_over_model``, whose backward sums the ranks' gradients: each
    rank's gradients of y, z and the scale are its channels of the
    unsharded ones. MLA's latent path between the f/g pair: the input's
    gradient is the unsharded one (counted once, not M times, though both
    the queries and the latent read it), and the partial gradients of
    ``w_dkv`` and ``kv_norm`` summed over the model axis are the whole
    ones."""
    want = _gated_grads(ExecContext())
    cfg, tree = _pair("mla")[2:]
    whole = params_from_numpy(tree, cfg, "cpu")
    mla_want = _mla_grads(whole.layers[0].attn, cfg, ExecContext())
    n = GATED_WIDTH // 2
    for rank, r in enumerate(runs["1x2"]):
        for got, ref, what in zip(r["gated"], want, ("y", "z", "scale")):
            _close(got, ref[..., rank * n:(rank + 1) * n], GRAD_TOL, f"rank {rank} {what}")
        for leaf, ref in mla_want.items():
            _close(r["mla"][leaf], ref, GRAD_TOL, f"rank {rank} {leaf}")


def test_global_norm_over_a_mamba2_shard_is_the_whole_norm(runs):
    """``global_norm`` over each (2, 2) FSDP rank's pieces of a Mamba2 tree
    equals the whole tree's norm: the B and C rows that every model rank
    holds count once (dividing the segmented leaves by their replicas
    alone would count them twice)."""
    cfg = _pair("mamba2")[2]
    tree = _norm_tree(cfg)
    want = float(global_norm(tree))
    for r in runs["2x2"]:
        assert _rel(r["global_norm"], want) <= 1e-6
    plan = placement.plan_params(cfg, ExecContext(mesh=placement.AxisSizes(data=2, model=2),
                                                  batch_axes=("data",), model_axis="model",
                                                  fsdp=True))
    assert any(plan.shared_rows(n) for n in tree)  # the B and C rows
    naive = sum(float(torch.sum(tmodel.cut(t, tmodel.cuts(plan, n, rank)) ** 2))
                / plan.replicas(n) for n, t in tree.items() for rank in range(4))
    assert _rel(naive ** 0.5, want) > 1e-3


def test_a_mamba2_checkpoint_moves_between_meshes(runs, ckpt_dir):
    """The checkpoint (2, 2) with FSDP wrote after its step (each rank's
    piece of a segmented leaf put back into the rows it holds, rank 0
    writing the unsharded layout) restores on no mesh and on (1, 2) to the very weights (2, 2)
    held, bit for bit."""
    tcfg, tree = _pair("mamba2")[2:]
    want = runs["2x2"][0]["train"][0]["weights"]
    params = params_from_numpy(tree, tcfg, "cpu")
    named = tmodel.train_params(params)
    state = init_opt_state(named)
    assert restore_checkpoint(ckpt_dir, params, state) == 1 and state["step"] == 1
    for leaf, p in named.items():
        assert np.array_equal(p.detach().numpy(), want[leaf]), leaf
    for r in runs["1x2"]:
        got = r["train"][-1]
        assert got["restored_step"] == 1
        for leaf in want:
            assert np.array_equal(got["weights"][leaf], want[leaf]), leaf


@pytest.mark.parametrize("arch,M", [("mamba2-2.7b", 2), ("tinyllama-1.1b", 4), ("qwen2-7b", 4)],
                         ids=["mamba2-segments", "tinyllama-kv-ways", "qwen2-padded-heads"])
def test_whole_puts_each_model_rank_piece_back(monkeypatch, arch, M):
    """``checkpoint.whole`` of rank 0's piece, the model group's gather
    replaced by the M ranks' pieces (``models.model.cut``), is the unsharded
    leaf, bit for bit, for every leaf of a reduced stack: Mamba2's B and C
    segments whole on every rank, tinyllama's kv heads cut 2 ways at M = 4,
    qwen2's query heads padded at M = 4."""
    cfg = configs.reduced(configs.get_config(arch))
    plan = placement.plan_params(cfg, ExecContext(mesh=placement.AxisSizes(data=1, model=M),
                                                  batch_axes=("data",), model_axis="model"))
    assert plan.segments or plan.ways
    named = dict(tmodel.init_params(cfg, 0, "cpu").named_parameters())
    for name, t in named.items():
        pieces = [tmodel.cut(t.detach(), tmodel.cuts(plan, name, r)) for r in range(M)]
        monkeypatch.setattr(collectives, "all_gather",
                            lambda x, dim, n, group: torch.cat(pieces, dim))
        got = whole(pieces[0], name, plan, SimpleNamespace(model_group=None, data_group=None))
        assert torch.equal(got, t.detach()), name
