"""Sharded training in the port on a (data, model) mesh of gloo ranks on
the CPU: (2, 1), (1, 2) and (2, 2), with FSDP on and off, on reduced
tinyllama-1.1b, reduced deepseek-v2-lite-16b (MLA, at M = 1 here; MLA,
Mamba2 and the encoder-decoder at M > 1 are in
``tests/test_torch_sharded_train_families.py``) and reduced deepseek-v2-lite
with GQA attention in place of MLA (its MoE on a model axis). The JAX package's own sharded
``loss_fn`` raises ``ShardingTypeError`` on every mesh here (ROADMAP.md,
Queue 3), so each mesh is held against the port's unsharded step and the
JAX package's unsharded ``loss_fn``, run on each data shard's rows where
the semantics are per shard (the loss is the mean of the data ranks'
means; the MoE sizes its capacity and its aux loss from the rank's own
tokens), on the same weights (the JAX tree carried over by ``convert``).

Each mesh runs once, in a module fixture (one spawn of its ranks, torch at
one thread per rank); the parametrised cases read its results: the loss,
every gradient leaf and the clipping norm, one AdamW step's params, the
MoE on a split batch against JAX's ``moe_apply`` per shard at capacity
1.25 (with drops), the 2-D MoE against the whole batch, a checkpoint
moved from (2, 2) to no mesh and to (1, 2), and the f/g pair's gradients.
At M > 1 the loss is the vocabulary-parallel cross-entropy on each rank's
slice of the logits (``collectives.vocab_parallel_nll``), gemma2's tied
embedding and final softcap included; on (1, 2) tinyllama and gemma2 also
train with the plan knob ``attn_seq_shard``, whose step is the step
without it (both are held against the same unsharded references).
Tolerances (fp32): the loss 1e-5 relative, each gradient leaf 1e-5 of its
largest |value| against the port and 2e-5 against JAX.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.sharding.context import ExecContext as JaxCtx  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import named_arrays, params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.sharded import run_ranks, train_rank  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.training.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.training.optimizer import (OptConfig, adamw_update,  # noqa: E402
                                            global_norm, init_opt_state)
from repro_torch.training.train_loop import batch_to_device, loss_and_grads  # noqa: E402

B, S = 4, 16
OC = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL, GRAD_TOL, JAX_TOL = 1e-5, 1e-5, 2e-5
RANK_LIMIT_S = 180.0
MOE_ROWS = 8  # rows of 6 tokens in the MoE case, split over the data ranks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process too (the ranks pin their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gqa(cfg):
    return dataclasses.replace(cfg, use_mla=False)


def _capacity(cfg):
    return dataclasses.replace(cfg, moe_capacity_factor=1.25)


# name -> (JAX config, port config): reduced configs, fp32; gemma2 ties its
# embedding to the LM head and softcaps its logits and attention scores
VARIANTS = {"tiny": ("tinyllama-1.1b", lambda c: c), "gemma": ("gemma2-2b", lambda c: c),
            "mla": ("deepseek-v2-lite-16b", lambda c: c),
            "moe": ("deepseek-v2-lite-16b", _gqa),
            "moe_cap": ("deepseek-v2-lite-16b", lambda c: _capacity(_gqa(c)))}


@functools.cache
def _pair(name):
    arch, f = VARIANTS[name]
    jcfg = f(jax_configs.reduced(jax_configs.get_config(arch)))
    tcfg = f(configs.reduced(configs.get_config(arch)))
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, jax.tree.map(np.asarray, jp)


def _batch(tcfg):
    return SyntheticLM(tcfg, DataConfig(batch=B, seq_len=S)).batch(0)


SEQ = {"attn_seq_shard": True}  # the plan knob: GQA attention cut on its query sequence
# each mesh's jobs: (variant, fsdp, plan)
JOBS = {"2x1": [("tiny", True, None), ("tiny", None, None), ("mla", True, None),
                ("moe_cap", None, None)],
        "1x2": [("tiny", None, None), ("moe", None, None), ("gemma", None, None),
                ("tiny", None, SEQ), ("gemma", None, SEQ)],
        "2x2": [("tiny", True, None), ("moe", True, None), ("moe", None, {"moe_2d": True}),
                ("moe_cap", True, None)]}
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
CASES = [(m, i) for m in MESHES for i in range(len(JOBS[m]))]


def _job(variant, fsdp, plan, **kw):
    tcfg, tree = _pair(variant)[2:]
    return dict(cfg=tcfg, tree=tree, batch=B, seq=S, steps=1, oc=OC, fsdp=fsdp, plan=plan,
                grads=True, weights=True, **kw)


def _moe_inputs(d_model):
    """Tokens that share a direction, so that the router favours some
    experts and capacity 1.25 drops assignments."""
    r = np.random.default_rng(3)
    return (r.standard_normal((MOE_ROWS, 6, d_model))
            + 0.5 * r.standard_normal(d_model)).astype(np.float32)


def _mesh_rank(rank, mesh, jobs, moe_case):
    """One rank: the training jobs (``train_rank``), then on the same mesh
    the f/g pair's and the data-axis collectives' gradients and, given
    ``moe_case`` (config, numpy tree), the MoE layer on this data rank's
    rows, expert-parallel and 2-D."""
    torch.set_num_threads(1)
    from repro_torch.convert import shard_params
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import collectives
    from repro_torch.sharding.context import ExecContext
    out = {"train": train_rank(rank, jobs, mesh, "cpu")}
    ctx = ExecContext(mesh=make_debug_mesh(mesh[0], mesh[1], "cpu"), batch_axes=("data",),
                      model_axis="model")
    M, D, m, d = ctx.model_parallel, ctx.batch_parallel, ctx.model_rank, ctx.data_rank
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    y = collectives.reduce_from_model(collectives.copy_to_model(x, ctx) * (m + 1.0), ctx)
    y.sum().backward()
    g = {"fg": x.grad.clone()}
    x.grad = None
    coeff = torch.arange(3.0 * M)
    (collectives.all_gather_last(x * (m + 1.0), ctx) * coeff).sum().backward()
    g["gather_last"] = x.grad.clone()
    x.grad = None
    coeff = torch.arange(2.0 * D * 3).reshape(2 * D, 3)
    (collectives.fsdp_gather(x, 0, ctx) * coeff).sum().backward()
    g["fsdp_gather"] = x.grad.clone()
    x.grad = None
    full = x.repeat(D, 1) * (d + 1.0)
    (collectives.scatter_batch(full, ctx) * coeff[:2]).sum().backward()
    g["scatter_batch"] = x.grad.clone()
    out["collectives"] = {k: v.numpy() for k, v in g.items()}
    if moe_case is not None:
        cfg, tree = moe_case
        mlp = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx).layers[1].mlp
        xs = torch.from_numpy(_moe_inputs(cfg.d_model))
        n = xs.shape[0] // D
        mine = xs[d * n:(d + 1) * n]
        with torch.no_grad():
            ep, ep_aux = moe.moe_apply(mlp, mine, cfg, ctx)
            ctx2 = dataclasses.replace(ctx, plan={"moe_2d": True})
            two, two_aux = moe.moe_apply(mlp, mine, cfg, ctx2)
        out["moe"] = {"ep": ep.numpy(), "ep_aux": float(ep_aux), "2d": two.numpy(),
                      "2d_aux": float(two_aux), "uses_2d": moe.uses_2d(cfg, ctx2)}
    return out


def _run(name, extra_jobs=(), save=None):
    """A mesh's ranks on its jobs (``save``: the first job's checkpoint
    directory) and, at (2, 2), the MoE case."""
    D, M = MESHES[name]
    jobs = [_job(*spec) for spec in JOBS[name]] + list(extra_jobs)
    if save:
        jobs[0]["save"] = save
    moe_case = _pair("moe_cap")[2:] if M > 1 and D > 1 else None
    return run_ranks(_mesh_rank, D * M, ((D, M), jobs, moe_case), timeout=RANK_LIMIT_S,
                     device_type="cpu")


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt_2x2"))


@pytest.fixture(scope="module")
def runs(ckpt_dir):
    """Each mesh's ranks, once: (2, 2) saves its first job's checkpoint
    after its step, which (1, 2) restores."""
    out = {"2x1": _run("2x1"), "2x2": _run("2x2", save=ckpt_dir)}
    restore = dict(_job("tiny", None, None), steps=0, grads=False, restore=ckpt_dir)
    out["1x2"] = _run("1x2", [restore])
    return out


# ---------------------------------------------------------------------------
# references: the port's unsharded step and the JAX package's loss_fn
# ---------------------------------------------------------------------------


def _shards(batch, n):
    k = B // n
    return [{key: v[i * k:(i + 1) * k] for key, v in batch.items()} for i in range(n)]


@functools.cache
def _port_ref(variant, D):
    """The unsharded port's mean over D data shards: (loss, grads, grad
    norm, params after one AdamW step); D = 1 is the whole batch."""
    tcfg, tree = _pair(variant)[2:]
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
def _jax_ref(variant, D):
    """The JAX package's unsharded loss_fn, the mean over D data shards."""
    jcfg, jp, tcfg, _ = _pair(variant)
    b = jax_data.SyntheticLM(jcfg, jax_data.DataConfig(batch=B, seq_len=S)).batch(0)
    fn = jax.jit(jax.value_and_grad(lambda p, bb: jax_model.loss_fn(p, jcfg, bb), has_aux=True))
    losses, acc = [], None
    for sh in _shards(b, D):
        (loss, _), g = fn(jp, jax.tree.map(jnp.asarray, sh))
        losses.append(float(loss))
        g = named_arrays(jax.tree.map(np.asarray, g), tcfg)
        acc = g if acc is None else {k: acc[k] + g[k] for k in g}
    return float(np.mean(losses)), {k: v / D for k, v in acc.items()}


def _ref_D(name, i):
    """How many shards the reference averages: the data axis, or the whole
    batch for the 2-D MoE (its tokens and aux loss are the whole batch's)."""
    _, fsdp, plan = JOBS[name][i]
    return 1 if plan and plan.get("moe_2d") else MESHES[name][0]


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,i", CASES, ids=[f"{m}-{JOBS[m][i][0]}-{i}" for m, i in CASES])
def test_loss_and_grads_match_the_unsharded_port(runs, name, i):
    """Every rank's global mean loss, its clipping norm (``global_norm``
    on the shards) and every gradient leaf gathered whole against the
    port's unsharded step, the mean over the data shards."""
    variant = JOBS[name][i][0]
    loss, grads, gn, _ = _port_ref(variant, _ref_D(name, i))
    for rank, r in enumerate(runs[name]):
        res = r["train"][i]
        assert _rel(res["history"][0]["loss"], loss) <= LOSS_RTOL, (rank, res["history"][0])
        assert _rel(res["history"][0]["grad_norm"], gn) <= LOSS_RTOL
        assert set(res["grads"]) == set(grads)
        for leaf, ref in grads.items():
            np.testing.assert_allclose(res["grads"][leaf], ref, rtol=0,
                                       atol=GRAD_TOL * np.abs(ref).max(), err_msg=leaf)


@pytest.mark.parametrize("name,i", CASES, ids=[f"{m}-{JOBS[m][i][0]}-{i}" for m, i in CASES])
def test_loss_and_grads_match_the_jax_package(runs, name, i):
    """The same against the JAX package's unsharded ``loss_fn`` and its
    gradients (``jax.value_and_grad``), shard by shard."""
    variant = JOBS[name][i][0]
    loss, grads = _jax_ref(variant, _ref_D(name, i))
    res = runs[name][0]["train"][i]
    assert _rel(res["history"][0]["loss"], loss) <= LOSS_RTOL
    for leaf, ref in grads.items():
        np.testing.assert_allclose(res["grads"][leaf], ref, rtol=0,
                                   atol=JAX_TOL * np.abs(ref).max(), err_msg=leaf)


@pytest.mark.parametrize("name,i", CASES, ids=[f"{m}-{JOBS[m][i][0]}-{i}" for m, i in CASES])
def test_one_adamw_step_matches_the_unsharded_step(runs, name, i):
    """The params after one AdamW step, gathered whole, against the
    unsharded update with the reference gradients: within 1e-5 of each
    leaf's scale; on the first step AdamW moves each element by about lr
    times the sign of its gradient, so an element whose reference gradient
    lies within 1e-4 of its leaf's largest may move the other way (2 lr)."""
    variant = JOBS[name][i][0]
    _, grads, _, want = _port_ref(variant, _ref_D(name, i))
    res = runs[name][-1]["train"][i]
    for leaf, ref in want.items():
        got = res["weights"][leaf]
        g = np.abs(grads[leaf])
        err = np.abs(got - ref)
        tied = g <= 1e-4 * g.max()
        assert (err[~tied] <= GRAD_TOL * np.abs(ref).max()).all(), leaf
        assert (err[tied] <= 2 * OC.lr + GRAD_TOL * np.abs(ref).max()).all(), leaf


def test_shards_hold_their_pieces(runs):
    """(2, 1) with FSDP holds half of every cut leaf; (1, 2) half the heads
    and experts; (2, 2) with FSDP both; without FSDP a data axis cuts
    nothing; every rank of a data group reports the same loss."""
    shards = {name: [(r["train"][0]["shard"], r["train"][0]["data_shard"]) for r in rr]
              for name, rr in runs.items()}
    assert shards["2x1"] == [(None, (2, 0)), (None, (2, 1))]
    assert shards["1x2"] == [((2, 0), None), ((2, 1), None)]
    assert shards["2x2"] == [((2, 0), (2, 0)), ((2, 1), (2, 0)), ((2, 0), (2, 1)),
                             ((2, 1), (2, 1))]
    assert [r["train"][1]["data_shard"] for r in runs["2x1"]] == [None, None]
    for name, rr in runs.items():
        for i in range(len(JOBS[name])):
            assert len({r["train"][i]["history"][0]["loss"] for r in rr}) == 1
    steps = runs["2x2"][0]["train"][0]["collectives"][0]
    assert steps.get("all_gather", 0) > 0 and steps.get("all_reduce", 0) > 0


@pytest.mark.parametrize("name,i", [c for c in CASES if MESHES[c[0]][1] > 1],
                         ids=[f"{m}-{JOBS[m][i][0]}-{i}" for m, i in CASES if MESHES[m][1] > 1])
def test_the_loss_keeps_the_vocabulary_cut(runs, name, i):
    """At M > 1 a train step's loss is the vocabulary-parallel
    cross-entropy on each rank's slice of the logits: no
    ``all_gather_last`` call, one all-reduce (max) of the rows' largest
    logit; with the plan knob, per attention layer the two all-to-alls
    (queries, outputs) and the two kv-head gathers of the forward, again
    in the backward's recomputation (remat "full"), and the two
    all-to-alls of the backward (the gathers' backward reduce-scatters)."""
    cfg = _pair(JOBS[name][i][0])[2]
    layers = sum(k in ("attn", "local", "global") for k in cfg.layer_kinds())
    for r in runs[name]:
        steps = r["train"][i]["collectives"][0]
        assert "all_gather_last" not in steps and steps["all_reduce_max"] == 1, steps
        knob = bool(JOBS[name][i][2] and JOBS[name][i][2].get("attn_seq_shard"))
        assert steps.get("all_to_all", 0) == (6 * layers if knob else 0), steps
        assert steps.get("gather_kv_heads", 0) == (4 * layers if knob else 0), steps


def test_moe_on_a_split_batch_matches_jax_per_shard(runs):
    """The expert-parallel MoE on (2, 2), each data rank on its rows at
    capacity 1.25, against the JAX package's unsharded ``moe_apply`` run on
    that data shard's rows (its capacity from them): outputs within 1e-5 of
    their scale, the aux loss the shard's. The whole batch's capacity drops
    other assignments, so the per-shard result is not the whole batch's."""
    jcfg, jp = _pair("moe_cap")[:2]
    p = jax.tree.map(lambda a: a[0], jp["stages"][0]["l1"]["mlp"])
    xs = _moe_inputs(jcfg.d_model)
    D = MESHES["2x2"][0]
    n = xs.shape[0] // D
    whole, _ = jax_moe.moe_apply(p, jnp.asarray(xs), jcfg, JaxCtx())
    differs = False
    for r in runs["2x2"]:
        d = runs["2x2"].index(r) // MESHES["2x2"][1]
        mine = xs[d * n:(d + 1) * n]
        want, aux = jax_moe.moe_apply(p, jnp.asarray(mine), jcfg, JaxCtx())
        want = np.asarray(want)
        np.testing.assert_allclose(r["moe"]["ep"], want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())
        assert _rel(r["moe"]["ep_aux"], aux) <= LOSS_RTOL
        differs |= not np.allclose(want, np.asarray(whole)[d * n:(d + 1) * n], atol=1e-4)
    assert differs


def test_moe_2d_matches_the_whole_batch(runs):
    """``moe_2d`` under the reference's condition on (2, 2): experts cut on
    the model axis, each expert's F on the data axis, the tokens gathered:
    each data rank's rows equal the unsharded (expert-parallel at D = 1)
    MoE on the whole batch, at its capacity, and the aux loss is the whole
    batch's."""
    jcfg, jp = _pair("moe_cap")[:2]
    p = jax.tree.map(lambda a: a[0], jp["stages"][0]["l1"]["mlp"])
    xs = _moe_inputs(jcfg.d_model)
    want, aux = jax_moe.moe_apply(p, jnp.asarray(xs), jcfg, JaxCtx())
    want = np.asarray(want)
    D, M = MESHES["2x2"]
    n = xs.shape[0] // D
    for rank, r in enumerate(runs["2x2"]):
        d = rank // M
        assert r["moe"]["uses_2d"]
        np.testing.assert_allclose(r["moe"]["2d"], want[d * n:(d + 1) * n], rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())
        assert _rel(r["moe"]["2d_aux"], aux) <= LOSS_RTOL


@pytest.mark.parametrize("name", list(MESHES))
def test_the_f_g_pair_and_the_data_collectives_have_the_right_gradients(runs, name):
    """``copy_to_model`` / ``reduce_from_model`` around a product by the
    model rank's (m + 1): the input's gradient is the sum over the model
    axis (3 at M = 2), not M times it; ``all_gather_last``'s backward takes
    the rank's slice; ``fsdp_gather``'s sums its slice over the data group
    (D times the coefficient here); ``scatter_batch``'s all-gathers."""
    D, M = MESHES[name]
    for rank, r in enumerate(runs[name]):
        d, m = divmod(rank, M)
        g = r["collectives"]
        assert np.array_equal(g["fg"], np.full((2, 3), M * (M + 1) / 2))
        coeff = np.arange(3.0 * M)
        assert np.array_equal(g["gather_last"],
                              np.tile(coeff[m * 3:(m + 1) * 3] * (m + 1), (2, 1)))
        c = np.arange(2.0 * D * 3).reshape(2 * D, 3)
        assert np.array_equal(g["fsdp_gather"], c[d * 2:(d + 1) * 2] * D)
        assert np.array_equal(g["scatter_batch"], c[:2] * (d + 1) * D)


def test_a_checkpoint_moves_between_meshes(runs, ckpt_dir):
    """The checkpoint (2, 2) wrote after its step (FSDP and the model axis
    gathered, rank 0 writing the unsharded layout) restores on no mesh and
    on (1, 2) to the very weights (2, 2) held, bit for bit."""
    tcfg, tree = _pair("tiny")[2:]
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
