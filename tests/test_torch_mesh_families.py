"""Serving MLA, Mamba2, the encoder-decoder and the Jamba hybrid on a model
axis of M > 1 in the port, on gloo CPU ranks, against the JAX package.

Reduced deepseek-v2-lite-16b (MLA; 2 of 4 heads per rank, 2 of 4 experts),
mamba2-2.7b (8 of 16 SSD heads, B and C whole), seamless-m4t-medium (the
encoder, the self- and cross-attention on 2 of 4 heads, 1 of 2 kv heads,
the GELU FFN) and jamba-v0.1-52b (Mamba1 on half its inner channels, GQA,
the expert-parallel MoE), fp32, weights from the JAX package's tree
through ``convert``. Two ranks on a (1, 2) mesh, spawned once for every
job: ``ModelWorker.generate`` (the bucketed mode; mamba2's rows
LEFT-padded under a pad mask, seamless with encoder frames) and the
continuous FIFO engine give, on both ranks, the JAX package's unsharded
greedy tokens; the engine's prefill logits lie within 1e-5 of each row's
largest |logit| of the port's unsharded run. Four ranks on a (2, 2) mesh
(the slot pool split over the data axis) serve reduced deepseek-v2-lite
and mamba2 with the port's unsharded tokens. The JAX package's own
sharded path raises ``ShardingTypeError`` here (ROADMAP.md, Queue 3), so
the meshes are held against unsharded runs. Without a process group: each
rank's draw is ``shard_params`` of the whole draw, segmented leaves
included, and a rank's cache holds its piece of the MLA latent's
sequence, all 576 columns wide, and a Mamba2 ``conv`` state di/M + 2N
wide.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.launch.sharded import (engine_rank, generate_rank, run_ranks,  # noqa: E402
                                        serve_job)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving.slots import _SlotPool  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402
from repro_torch.sharding import placement  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "mamba2-2.7b", "seamless-m4t-medium", "jamba-v0.1-52b"]
MESH2X2 = ["deepseek-v2-lite-16b", "mamba2-2.7b"]
MAX_LEN, MAX_ENC, SLOTS = 32, 16, 4
SHAPES = [(8, 9, 4), (12, 5, 3), (5, 9, 2), (10, 7, 4), (6, 12, 3)]  # (prompt, frames, max_new)
GEN_B, GEN_S, GEN_NEW, GEN_FRAMES = 2, 10, 4, 7
LOGIT_TOL = 1e-5  # of each row's largest |logit|: fp32, sums split over the ranks
RANK_LIMIT_S = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process too (the ranks pin their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


@functools.cache
def _pair(arch):
    jcfg = jax_configs.reduced(jax_configs.get_config(arch))
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, configs.reduced(configs.get_config(arch)), jax.tree.map(np.asarray, jp)


def _requests(cfg):
    """(uid, prompt, max_new[, frames]) of ``SHAPES``."""
    r = np.random.default_rng(3)
    out = []
    for i, (plen, frames, new) in enumerate(SHAPES):
        req = (i, r.integers(1, cfg.vocab_size, plen, dtype=np.int32), new)
        if cfg.is_encoder_decoder:
            req += (r.standard_normal((frames, cfg.d_model)).astype(np.float32),)
        out.append(req)
    return out


def _gen_job(arch):
    """``generate``'s inputs: (2, 10) prompts; mamba2's second row 3 pad
    tokens then 7 valid ones under a pad mask, seamless with frames."""
    cfg, tree = _pair(arch)[2:]
    r = np.random.default_rng(4)
    job = dict(cfg=cfg, tree=tree, max_new=GEN_NEW, max_len=MAX_LEN,
               prompts=r.integers(1, cfg.vocab_size, (GEN_B, GEN_S), dtype=np.int32))
    if cfg.family == "ssm":
        mask = np.ones((GEN_B, GEN_S), bool)
        mask[1, :3] = False
        job["prompts"][1, :3] = 0
        job["pad_mask"] = mask
    if cfg.is_encoder_decoder:
        job["enc_inputs"] = r.standard_normal((GEN_B, GEN_FRAMES, cfg.d_model)).astype(np.float32)
    return job


def _eng_job(arch, logits=True):
    """The continuous engine's job; with ``logits`` a (2, 9) prefill after
    the serve (seamless with 11 frames), whose logits it returns."""
    cfg, tree = _pair(arch)[2:]
    r = np.random.default_rng(6)
    job = dict(cfg=cfg, tree=tree, requests=_requests(cfg), max_slots=SLOTS, max_len=MAX_LEN)
    if cfg.is_encoder_decoder:
        job["max_enc_len"] = MAX_ENC
    if logits:
        job["logit_prompts"] = r.integers(1, cfg.vocab_size, (2, 9), dtype=np.int32)
        if cfg.is_encoder_decoder:
            job["logit_frames"] = r.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    return job


def _rank(rank, gen_jobs, eng_jobs):
    """One rank of the (1, 2) mesh: every ``generate`` job, then every
    continuous-engine job."""
    torch.set_num_threads(1)
    return (generate_rank(rank, gen_jobs, 2, "cpu"),
            engine_rank(rank, eng_jobs, (1, 2), "cpu"))


def _rank2x2(rank, jobs):
    torch.set_num_threads(1)
    return engine_rank(rank, jobs, (2, 2), "cpu")


@pytest.fixture(scope="module")
def ranks():
    """The (1, 2) mesh's two ranks, spawned once for every job."""
    return run_ranks(_rank, 2, ([_gen_job(a) for a in ARCHS], [_eng_job(a) for a in ARCHS]),
                     timeout=RANK_LIMIT_S, device_type="cpu")


@pytest.fixture(scope="module")
def ranks2x2():
    """The (2, 2) mesh's four ranks, spawned once."""
    return run_ranks(_rank2x2, 4, ([_eng_job(a, logits=False) for a in MESH2X2],),
                     timeout=RANK_LIMIT_S, device_type="cpu")


@functools.cache
def _unsharded(arch):
    return serve_job(_eng_job(arch), ExecContext(), "cpu")


@functools.cache
def _jax_engine_tokens(arch):
    """The JAX package's continuous FIFO engine, unsharded, uid -> tokens."""
    jcfg, jp = _pair(arch)[:2]
    eng = JaxEngine(mode="continuous", max_slots=SLOTS)
    eng.add_model("m", jcfg, jp, max_len=MAX_LEN,
                  max_enc_len=MAX_ENC if jcfg.is_encoder_decoder else None)
    for req in _requests(jcfg):
        eng.submit("m", JaxRequest(req[0], req[1], req[2],
                                   enc_inputs=req[3] if len(req) > 3 else None))
    out = {r.uid: r for r in eng.run_all()}
    assert all(r.error is None for r in out.values())
    return {uid: [int(t) for t in r.tokens] for uid, r in out.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_on_two_ranks_matches_jax(ranks, arch):
    """``ModelWorker.generate`` on both ranks (the bucketed mode): the JAX
    package's unsharded worker's greedy tokens, mamba2 through the masked
    prefill of a LEFT-padded row, seamless with encoder frames; every rank
    holds its half of the model and the report counts sharded dims."""
    i = ARCHS.index(arch)
    job = _gen_job(arch)
    jcfg, jp = _pair(arch)[:2]
    want = JaxWorker("u", jcfg, jp, max_len=MAX_LEN).generate(
        job["prompts"], GEN_NEW, enc_inputs=job.get("enc_inputs"), pad_mask=job.get("pad_mask"))
    for rank, r in enumerate(ranks):
        got = r[0][i]
        np.testing.assert_array_equal(got["tokens"], np.asarray(want), err_msg=f"rank {rank}")
        assert got["shard"] == (2, rank) and got["sharded"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_two_ranks_matches_jax(ranks, arch):
    """The continuous FIFO engine on both ranks: per uid the JAX package's
    unsharded engine's greedy tokens, and the port's unsharded run's, as
    many passes as the unsharded worker, no error."""
    i = ARCHS.index(arch)
    want, jax_tokens = _unsharded(arch), _jax_engine_tokens(arch)
    assert want["tokens"] == jax_tokens
    for rank, r in enumerate(ranks):
        got = r[1][i]
        assert got["errors"] == [] and got["tokens"] == jax_tokens, rank
        assert (got["prefill_calls"], got["decode_calls"]) == (want["prefill_calls"],
                                                               want["decode_calls"])
        assert got["shard"] == (2, rank) and got["all_reduces"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_on_two_ranks_match_unsharded(ranks, arch):
    """A (2, 9) prefill after the serve (seamless with 11 frames): each
    rank's last-position logits within 1e-5 of each row's largest |logit|
    of the port's unsharded run, and the two ranks' logits equal."""
    i = ARCHS.index(arch)
    want = _unsharded(arch)["logits"]
    scale = np.abs(want).max(axis=-1, keepdims=True)
    a, b = (r[1][i]["logits"] for r in ranks)
    np.testing.assert_array_equal(a, b)
    assert (np.abs(a - want) <= LOGIT_TOL * scale).all(), float((np.abs(a - want) / scale).max())


@pytest.mark.parametrize("arch", MESH2X2)
def test_engine_on_a_2x2_mesh_matches_unsharded(ranks2x2, arch):
    """Four ranks, (data 2, model 2): every rank's tokens per uid equal the
    port's unsharded run's; each holds half the slot pool and its model
    shard."""
    i = MESH2X2.index(arch)
    want = _unsharded(arch)
    for rank, r in enumerate(ranks2x2):
        got = r[i]
        assert got["errors"] == [] and got["tokens"] == want["tokens"], rank
        assert got["pool_rows"] == SLOTS // 2 and got["shard"] == (2, rank % 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_draw_cuts_the_segmented_leaves(arch):
    """``init_params(ctx=...)`` at a model axis of 2 equals ``shard_params``
    of the whole draw leaf by leaf; a segmented leaf holds the rank's half
    of each cut segment and the others whole (Mamba2's ``in_proj``: z, x,
    dt halved, B and C whole), and the per-channel leaves the table
    replicates hold the rank's channels."""
    cfg = configs.reduced(configs.get_config(arch))
    ctx = ExecContext(mesh=_FakeMesh(data=1, model=2), batch_axes=("data",), model_axis="model")
    whole = tmodel.init_params(cfg, 5, "cpu")
    plan = placement.plan_params(cfg, ctx)
    for rank in (0, 1):
        got = dict(tmodel.init_params(cfg, 5, "cpu", ctx=ctx, rank=rank).named_parameters())
        want = dict(convert.shard_params(whole, ctx, rank=rank).named_parameters())
        assert got.keys() == want.keys()
        for name in got:
            assert torch.equal(got[name], want[name]), (rank, name)
    w = dict(whole.named_parameters())
    di, N, H = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_num_heads
    if arch == "mamba2-2.7b":
        name = "layers.0.mixer.in_proj.weight"
        assert plan.segments[name] == ((di, True), (di, True), (N, False), (N, False),
                                       (H, True))
        full = w[name]
        z, x, bc, dt = full[:di], full[di:2 * di], full[2 * di:2 * di + 2 * N], full[-H:]
        assert torch.equal(got[name], torch.cat([z[di // 2:], x[di // 2:], bc, dt[H // 2:]]))
        assert torch.equal(got["layers.0.mixer.A_log"], w["layers.0.mixer.A_log"][H // 2:])
        assert got["layers.0.mixer.norm"].shape == (di // 2,)
    if arch == "jamba-v0.1-52b":
        mixer = "layers.0.mixer."
        assert plan.segments[mixer + "in_proj.weight"] == ((di, True), (di, True))
        assert plan.dims[mixer + "x_proj.weight"] == 1  # by its rows (the port's dim 1)
        assert torch.equal(got[mixer + "x_proj.weight"], w[mixer + "x_proj.weight"][:, di // 2:])
        for leaf in ("conv_b", "dt_proj_b", "A_log", "D"):
            assert torch.equal(got[mixer + leaf], w[mixer + leaf][di // 2:]), leaf
        assert torch.equal(got[mixer + "dt_norm"], w[mixer + "dt_norm"])
    if arch == "deepseek-v2-lite-16b":
        attn = "layers.0.attn."
        assert torch.equal(got[attn + "w_dkv.weight"], w[attn + "w_dkv.weight"])
        assert torch.equal(got[attn + "w_ukv"], w[attn + "w_ukv"][:, cfg.num_heads // 2:])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-2.7b", "jamba-v0.1-52b"])
def test_a_ranks_cache_holds_the_whole_latent_and_its_ssm_channels(arch):
    """A worker on a stand-in mesh of model 2 allocates its slot pool as its
    piece: the MLA ``latent`` with all its columns (the table's c_kv rule
    would cut them: the port departs) and half its sequence, cut over the
    model axis (no model rank holds the whole latent), a Mamba2 ``conv``
    state di/2 + 2N wide and its ``ssm`` state on half the heads, a Mamba1
    ``conv`` and ``ssm`` on half the inner channels."""
    cfg = configs.reduced(configs.get_config(arch))
    ctx = ExecContext(mesh=_FakeMesh(data=1, model=2), batch_axes=("data",), model_axis="model")
    w = ModelWorker("a", cfg, tmodel.init_params(cfg, 0, "cpu"), max_len=MAX_LEN, ctx=ctx)
    pool = _SlotPool(w, SLOTS)
    full = tmodel.init_cache(cfg, SLOTS, MAX_LEN, device="cpu")
    shapes = {n: tuple(t.shape) for n, t in pool.cache.items()}
    di, N = cfg.d_inner, cfg.ssm_d_state
    if cfg.use_mla:
        L, B, S, W = full["latent"].shape
        assert shapes["latent"] == (L, B, S // 2, W)
        assert pool.cache_shardings["latent"][2:] == ("model", None)
    if "ssd" in cfg.layer_kinds():
        assert shapes["conv"][-1] == di // 2 + 2 * N
        assert shapes["ssm"][2] == cfg.ssm_num_heads // 2
    if "mamba" in cfg.layer_kinds():
        assert shapes["conv"][-1] == di // 2 and shapes["ssm"][2] == di // 2
        assert shapes["k"][3] == cfg.num_kv_heads // 2
