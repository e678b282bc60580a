"""Sharded training of MLA, Mamba2, the encoder-decoder, the Jamba hybrid and
the wide GQA and MoE layouts in the port on a (data, model) mesh of gloo
ranks on the CPU: reduced deepseek-v2-lite-16b (MLA and its MoE), reduced
mamba2-2.7b and reduced jamba-v0.1-52b (Mamba1, GQA attention and the MoE)
on (1, 2) and on (2, 2) with FSDP (jamba's MoE 2-D there), reduced
seamless-m4t-medium and a reduced kimi-k2 with 3 experts (which M = 2 does
not divide: every expert whole on every rank) on (1, 2), and a reduced
qwen2-7b with 3 query heads on 1 kv head (the kv head on both model ranks,
the group padded with a zero head to 4) on (2, 2) with FSDP. The JAX package's own sharded
``loss_fn`` raises ``ShardingTypeError`` on every mesh here (ROADMAP.md,
Queue 3), so each job is held, as ``tests/test_torch_sharded_train.py``
holds the GQA stacks, against the port's unsharded step and the JAX
package's unsharded ``loss_fn`` on each data shard's rows (the loss is the
mean of the data ranks' means; the MoE sizes its capacity and aux loss from
the rank's own tokens), on the same weights (the JAX tree carried over by
``convert``).

What these families add on a model axis is checked on its own too: the
gated norm's all-reduced sum of squares, MLA's replicated latent path and
Mamba1's all-reduced ``x_proj`` with its dt / B / C norms each give the
unsharded gradient at M = 2; ``global_norm`` over the pieces of a Mamba2
tree (whose B and C rows every model rank holds) is the whole tree's; on a
(1, 4) mesh of the same four ranks the kv sub-group sum gives each kv head
the gradient of its query heads on both of its ranks, and reduced
tinyllama's gradient pieces and norm are the unsharded ones; the padded
qwen2's pad rows and columns, and their moments, stay exactly 0 over
several AdamW steps whose losses and grad norms are the unsharded run's;
Mamba2 and padded-qwen2 checkpoints saved on (2, 2) with FSDP restore on no
mesh (and the qwen2 one from there back onto (2, 2), the Mamba2 one on
(1, 2)) bit for bit; and ``checkpoint.whole`` puts the model ranks' pieces
of every leaf back into the unsharded leaf where a rank holds other rows
than its 1/M slice (Mamba2's segments, kv heads cut fewer ways than M,
padded query heads).

Each mesh runs once, in a module fixture (one spawn of its ranks, torch at
one thread per rank). Tolerances (fp32): the loss 1e-5 relative, each
gradient leaf 1e-5 of its largest |value| against the port and 2e-5
against JAX.
"""
import dataclasses
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
from repro_torch.training.train_loop import (batch_to_device, loss_and_grads,  # noqa: E402
                                             train_loop)

# 40 positions cross the reduced Mamba2's 32-position SSD chunk
B, S, FRAMES = 4, 40, 12
OC = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL, GRAD_TOL, JAX_TOL = 1e-5, 1e-5, 2e-5
RANK_LIMIT_S = 180.0
ARCHS = {"mla": "deepseek-v2-lite-16b", "mamba2": "mamba2-2.7b",
         "seamless": "seamless-m4t-medium", "jamba": "jamba-v0.1-52b",
         "kimi3": "kimi-k2-1t-a32b", "qwen2pad": "qwen2-7b", "tiny": "tinyllama-1.1b"}
# changes to a family's reduced config: kimi-k2 with 3 experts, which M = 2 does
# not divide (capacity 1.5 is drop-free at top-2 of 3), and a qwen2 with 3 query
# heads on 1 kv head, whose group M = 2 pads from 3 to 4 heads
CHANGES = {"kimi3": dict(num_experts=3, moe_capacity_factor=1.5),
           "qwen2pad": dict(num_heads=3, num_kv_heads=1)}
# each mesh's jobs: (family, fsdp, ExecContext.plan)
JOBS = {"1x2": [("mla", None, None), ("mamba2", None, None), ("seamless", None, None),
                ("jamba", None, None), ("kimi3", None, None)],
        "2x2": [("mamba2", True, None), ("mla", True, None), ("jamba", True, {"moe_2d": True}),
                ("qwen2pad", True, None)]}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
CASES = [(m, i) for m in MESHES for i in range(len(JOBS[m]))]
IDS = [f"{m}-{JOBS[m][i][0]}" for m, i in CASES]
GATED_WIDTH = 24  # the gated-norm probe's channels, 12 per rank
PAD_STEPS = 3  # the AdamW steps of the padded-qwen2 probe


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process too (the ranks pin their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _pair(family):
    arch, changes = ARCHS[family], CHANGES.get(family, {})
    jcfg = dataclasses.replace(jax_configs.reduced(jax_configs.get_config(arch)), **changes)
    tcfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), **changes)
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, jax.tree.map(np.asarray, jp)


def _data():
    return DataConfig(batch=B, seq_len=S, enc_frames=FRAMES)


def _batch(tcfg):
    return SyntheticLM(tcfg, _data()).batch(0)


def _job(family, fsdp, plan=None, **kw):
    tcfg, tree = _pair(family)[2:]
    return dict(cfg=tcfg, tree=tree, batch=B, seq=S, enc_frames=FRAMES, steps=1, oc=OC,
                fsdp=fsdp, plan=plan, grads=True, weights=True, **kw)


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


def _mamba1_inputs(d_model):
    r = np.random.default_rng(8)
    return tuple(r.standard_normal((2, S, d_model)).astype(np.float32) for _ in range(2))


def _mamba1_grads(mixer, cfg, ctx):
    """The gradients of the input, of the dt / B / C norm scales (summed
    over the model axis as ``sync_grads`` sums them) and of this rank's
    pieces of ``x_proj``, ``dt_proj`` and ``in_proj`` of Mamba1's train
    forward between the f/g pair, under a fixed linear loss (S crosses the
    scan's chunk)."""
    from repro_torch.models import ssm
    x, coeff = (torch.from_numpy(a) for a in _mamba1_inputs(cfg.d_model))
    x.requires_grad_(True)
    mixer.requires_grad_(True)
    y, _ = ssm.mamba1_forward(mixer, collectives.copy_to_model(x, ctx), cfg, ctx=ctx)
    (collectives.reduce_from_model(y, ctx) * coeff).sum().backward()
    out = {"x": x.grad.numpy()}
    for leaf in ("dt_norm", "b_norm", "c_norm"):
        out[leaf] = collectives.all_reduce_model(getattr(mixer, leaf).grad, ctx).numpy()
    for leaf in ("x_proj", "dt_proj", "in_proj"):
        out[f"{leaf}.weight"] = getattr(mixer, leaf).weight.grad.numpy()
    return out


def _wide(cfg, tree, rank):
    """On a (1, 4) mesh over the four ranks of the (2, 2) spawn: the kv
    sub-group sum of a tensor that holds 2^rank (ranks 0-1 and 2-3 are the
    groups), and reduced tinyllama's step-0 gradient pieces (its 2 kv heads
    each on 2 ranks) and their ``global_norm``."""
    from repro_torch.convert import shard_params
    from repro_torch.launch.mesh import make_debug_mesh
    ctx = ExecContext(mesh=make_debug_mesh(1, 4, "cpu"), batch_axes=("data",),
                      model_axis="model")
    groups = collectives.all_reduce_model_groups(torch.full((3,), 2.0 ** rank), 2, ctx)
    plan = placement.plan_params(cfg, ctx)
    params = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
    tmodel.train_params(params)
    _, _, grads = loss_and_grads(params, cfg, batch_to_device(_batch(cfg), "cpu"), ctx, plan)
    return {"groups": groups.numpy(), "grads": {n: g.numpy() for n, g in grads.items()},
            "norm": float(global_norm(grads, plan, ctx))}


def _padded(cfg, tree, ckpt, rank, ctx):
    """The padded qwen2 on (2, 2) with FSDP: PAD_STEPS AdamW steps (their
    history), the largest |value| in the pad rows and columns of each of
    this rank's params and moments, the weights gathered whole, and a
    checkpoint saved to ``ckpt``, which rank 0 restores on no mesh and
    saves again from there, and every rank restores from that onto a fresh
    (2, 2) shard: whether the restored pieces are the trained ones, bit for
    bit, and their pad maxima."""
    import os

    import torch.distributed as dist

    from repro_torch.convert import shard_params
    from repro_torch.launch.sharded import pad_maxima, piece_digests
    from repro_torch.training.checkpoint import leaves, save_checkpoint
    from repro_torch.training.train_loop import make_train_step, shard_batch
    plan = placement.plan_params(cfg, ctx)
    params = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
    named = tmodel.train_params(params)
    state = init_opt_state(named)
    step = make_train_step(cfg, ctx, OC)
    data = SyntheticLM(cfg, _data())
    hist = [{k: float(v) for k, v in step(params, state, batch_to_device(
        shard_batch(data.batch(i), cfg, ctx), "cpu")).items()} for i in range(PAD_STEPS)]
    save_checkpoint(ckpt, params, state, step=PAD_STEPS, ctx=ctx)
    back = os.path.join(ckpt, "back")
    if rank == 0:  # on no mesh, and saved again from there
        flat = params_from_numpy(tree, cfg, "cpu")
        flat_state = init_opt_state(tmodel.train_params(flat))
        restore_checkpoint(ckpt, flat, flat_state)
        save_checkpoint(back, flat, flat_state, step=PAD_STEPS)
    dist.barrier()
    fresh = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
    fresh_state = init_opt_state(tmodel.train_params(fresh))
    restored_step = restore_checkpoint(back, fresh, fresh_state, ctx)
    return {"history": hist, "pads": pad_maxima(leaves(params, state), plan, rank),
            "weights": {n: whole(p.detach(), n, plan, ctx).numpy() for n, p in named.items()},
            "restored_step": restored_step,
            "restored_equal": (piece_digests(leaves(fresh, fresh_state))
                               == piece_digests(leaves(params, state))),
            "restored_pads": pad_maxima(leaves(fresh, fresh_state), plan, rank)}


def _rank(rank, mesh, jobs, probes):
    """One rank: the training jobs (``launch.sharded.train_rank``), then on
    the same mesh the probes: at (1, 2) the gated norm, MLA's latent path
    (``probes["mla"]``: config and numpy tree) and Mamba1's mixer
    (``probes["mamba1"]``: jamba's); at (2, 2) ``global_norm`` over this
    rank's pieces of a Mamba2 tree (``probes["norm"]``: its config), the
    (1, 4) probes (``probes["wide"]``: tinyllama's config and tree) and the
    padded qwen2's steps and checkpoint (``probes["padded"]``: config,
    tree, directory)."""
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
    if "mamba1" in probes:
        cfg, tree = probes["mamba1"]
        params = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
        out["mamba1"] = _mamba1_grads(params.layers[0].mixer, cfg, ctx)
    if "norm" in probes:
        cfg = probes["norm"]
        plan = placement.plan_params(cfg, ctx)
        pieces = {n: tmodel.cut(t, tmodel.cuts(plan, n, rank))
                  for n, t in _norm_tree(cfg).items()}
        out["global_norm"] = float(global_norm(pieces, plan, ctx))
    if "wide" in probes:
        out["wide"] = _wide(*probes["wide"], rank)
    if "padded" in probes:
        out["padded"] = _padded(*probes["padded"], rank, ctx)
    return out


def _run(name, extra_jobs=(), save=None, padded_ckpt=None):
    """A mesh's ranks on its jobs (``save``: the first job's checkpoint
    directory) and its probes (``padded_ckpt``: the padded qwen2's
    checkpoint directory, at (2, 2))."""
    D, M = MESHES[name]
    jobs = [_job(*spec) for spec in JOBS[name]] + list(extra_jobs)
    if save:
        jobs[0]["save"] = save
    probes = ({"norm": _pair("mamba2")[2], "wide": _pair("tiny")[2:],
               "padded": (*_pair("qwen2pad")[2:], padded_ckpt)} if D > 1 else
              {"mla": _pair("mla")[2:], "mamba1": _pair("jamba")[2:]})
    return run_ranks(_rank, D * M, ((D, M), jobs, probes), timeout=RANK_LIMIT_S,
                     device_type="cpu")


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt_mamba2_2x2"))


@pytest.fixture(scope="module")
def padded_ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt_qwen2pad_2x2"))


@pytest.fixture(scope="module")
def runs(ckpt_dir, padded_ckpt_dir):
    """Each mesh's ranks, once: (2, 2) saves the Mamba2 job's checkpoint
    after its step, which (1, 2) restores, and the padded qwen2 probe's."""
    out = {"2x2": _run("2x2", save=ckpt_dir, padded_ckpt=padded_ckpt_dir)}
    restore = dict(_job("mamba2", None), steps=0, grads=False, restore=ckpt_dir)
    out["1x2"] = _run("1x2", [restore])
    return out


# ---------------------------------------------------------------------------
# references: the port's unsharded step and the JAX package's loss_fn
# ---------------------------------------------------------------------------


def _shards(batch, n):
    k = B // n
    return [{key: v[i * k:(i + 1) * k] for key, v in batch.items()} for i in range(n)]


def _ref_d(name, i):
    """The data shards a job's reference averages over: the whole batch
    for the 2-D MoE (its tokens and aux loss are the whole batch's)."""
    plan = JOBS[name][i][2]
    return 1 if plan and plan.get("moe_2d") else MESHES[name][0]


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
    loss, grads, gn, _ = _port_ref(family, _ref_d(name, i))
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
    loss, grads = _jax_ref(family, _ref_d(name, i))
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
    # the padded qwen2's kv head lives on both model ranks: its gradient is
    # summed over them, and counted by name
    i = [f for f, _, _ in JOBS["2x2"]].index("qwen2pad")
    assert runs["2x2"][0]["train"][i]["collectives"][0].get("all_reduce_kv_group", 0) > 0


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


def test_mamba1_x_proj_and_its_norms_have_the_unsharded_gradients(runs):
    """At M = 2 Mamba1's row-parallel ``x_proj`` sums its partials with
    ``sum_over_model``, whose backward sums the ranks' gradients, since
    every rank applies the whole dt / B / C to its own channels: each
    rank's gradients of the input (counted once, not twice), of its pieces
    of ``x_proj``, ``dt_proj`` and ``in_proj``, and of the whole dt / B / C
    norm scales summed over the model axis are the unsharded ones."""
    cfg, tree = _pair("jamba")[2:]
    flat = params_from_numpy(tree, cfg, "cpu")
    want = _mamba1_grads(flat.layers[0].mixer, cfg, ExecContext())
    plan = placement.plan_params(cfg, ExecContext(mesh=placement.AxisSizes(data=1, model=2),
                                                  batch_axes=("data",), model_axis="model"))
    assert {"layers.0.mixer.dt_norm", "layers.0.mixer.b_norm",
            "layers.0.mixer.c_norm"} <= plan.partial
    for rank, r in enumerate(runs["1x2"]):
        assert set(r["mamba1"]) == set(want)
        for leaf, ref in want.items():
            if leaf.endswith(".weight"):
                ref = tmodel.cut(torch.from_numpy(ref),
                                 tmodel.cuts(plan, f"layers.0.mixer.{leaf}", rank)).numpy()
            _close(r["mamba1"][leaf], ref, GRAD_TOL, f"rank {rank} {leaf}")


def test_the_kv_sub_group_sum_and_global_norm_over_a_wide_shard(runs):
    """On a (1, 4) mesh ``all_reduce_model_groups`` sums over ranks 0-1
    and 2-3 apart; reduced tinyllama (2 kv heads, each on 2 of the 4
    ranks) gives each rank its piece of the unsharded gradient, the kv
    leaves summed over their sub-group, and ``global_norm`` over the
    pieces is the unsharded norm (``ParamPlan.replicas`` counts each kv
    piece twice)."""
    cfg, tree = _pair("tiny")[2:]
    flat = params_from_numpy(tree, cfg, "cpu")
    tmodel.train_params(flat)
    _, _, grads = loss_and_grads(flat, cfg, batch_to_device(_batch(cfg), "cpu"))
    want_norm = float(global_norm(grads))
    plan = placement.plan_params(cfg, ExecContext(mesh=placement.AxisSizes(data=1, model=4),
                                                  batch_axes=("data",), model_axis="model"))
    assert plan.ways and all(plan.replicas(n) == 2 for n in plan.ways)
    for rank, r in enumerate(runs["2x2"]):
        w = r["wide"]
        np.testing.assert_array_equal(w["groups"], np.full(3, 3.0 if rank < 2 else 12.0))
        assert _rel(w["norm"], want_norm) <= 1e-6, (rank, w["norm"], want_norm)
        for name, g in grads.items():
            ref = tmodel.cut(g, tmodel.cuts(plan, name, rank)).numpy()
            _close(w["grads"][name], ref, GRAD_TOL, f"rank {rank} {name}")


def test_pad_rows_stay_zero_under_adamw(runs):
    """The padded qwen2 on (2, 2) with FSDP: after PAD_STEPS AdamW steps
    every pad row of ``wq`` and ``bq`` and every pad column of ``wo``, in
    the weights and both moments, is exactly 0 on every rank that holds
    one, and each step's loss and grad norm are the unsharded run's (pad
    columns that moved would add to the output and to the norm)."""
    cfg, tree = _pair("qwen2pad")[2:]
    flat = params_from_numpy(tree, cfg, "cpu")
    data = SyntheticLM(cfg, _data())
    _, _, want = train_loop(cfg, flat, [data.batch(i) for i in range(PAD_STEPS)], oc=OC,
                            log_every=0)
    held = set()
    for rank, r in enumerate(runs["2x2"]):
        got = r["padded"]
        assert all(v == 0.0 for v in got["pads"].values()), (rank, got["pads"])
        held |= set(got["pads"])
        for i, (h, ref) in enumerate(zip(got["history"], want)):
            assert _rel(h["loss"], ref["loss"]) <= LOSS_RTOL, (rank, i, h, ref)
            assert _rel(h["grad_norm"], ref["grad_norm"]) <= LOSS_RTOL, (rank, i, h, ref)
    for leaf in ("attn.wq.weight", "attn.bq", "attn.wo.weight"):
        for kind in ("params", "opt.m", "opt.v"):
            assert f"{kind}.layers.0.{leaf}" in held, (kind, leaf, sorted(held))


def test_a_padded_qwen2_checkpoint_moves_between_meshes(runs, padded_ckpt_dir):
    """The padded qwen2's checkpoint from (2, 2) with FSDP (each rank's
    real heads written back, the pad heads dropped) restores on no mesh to
    the weights the mesh held, bit for bit; saved again from there and
    restored onto a fresh (2, 2) shard it gives every rank its trained
    pieces, params and moments, bit for bit, with the pad rows 0."""
    tcfg, tree = _pair("qwen2pad")[2:]
    want = runs["2x2"][0]["padded"]["weights"]
    params = params_from_numpy(tree, tcfg, "cpu")
    named = tmodel.train_params(params)
    state = init_opt_state(named)
    assert restore_checkpoint(padded_ckpt_dir, params, state) == PAD_STEPS
    for leaf, p in named.items():
        assert np.array_equal(p.detach().numpy(), want[leaf]), leaf
    pads = set()
    for rank, r in enumerate(runs["2x2"]):
        got = r["padded"]
        assert got["restored_step"] == PAD_STEPS and got["restored_equal"], rank
        assert all(v == 0.0 for v in got["restored_pads"].values())
        pads |= set(got["restored_pads"])
    assert "params.layers.0.attn.wo.weight" in pads
