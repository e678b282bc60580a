"""Serving GQA stacks on a model axis wider than their kv heads, query heads
that the ranks of a kv group do not divide, and experts that the model
axis does not divide, in the port, on four gloo CPU ranks (a (1, 4) mesh),
against the JAX package.

Reduced tinyllama-1.1b and gemma2-2b (4 on 2 heads: each kv head whole on
2 ranks, one query head per rank), a reduced qwen2-7b with 6 query heads on
2 kv heads (each group of 3 padded with a zero head to 4, 2 per rank) and
reduced kimi-k2 with 6 experts (every expert whole on every rank), fp32,
weights from the JAX package's ``init_params`` through ``convert``. One
spawn of four ranks runs ``ModelWorker.generate`` and the continuous FIFO
engine for every job: each rank's greedy tokens equal the port's unsharded
run's, and its prefill logits lie within 1e-5 of each row's largest
|logit| of it. The port's unsharded run gives the JAX package's unsharded
``generate`` tokens and its prefill logits within ``JAX_TOL`` of each row's
largest |logit|. The JAX package's own sharded path raises
``ShardingTypeError`` here (ROADMAP.md, Queue 3). Without a process group:
the plans (the kv ways, the padded heads, whole experts, one kv head per
rank in the cache), a padded head's zero share of the output, and train
mode taking these layouts. The spawn also serves qwen2 and gemma2 with
the plan knob ``attn_seq_shard`` (prefill attention cut on its query
sequence) against the same unsharded run. ``test_torch_mesh_wide8.py`` takes the
shipped ratio of 32 on 4 heads at a model axis of 8.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.launch.sharded import engine_rank, generate_rank, run_ranks, serve_job  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402
from repro_torch.sharding import placement  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402

M = 4
# (arch, changes to its reduced config): qwen2's 6 heads on 2 kv heads need
# padding at M = 4; kimi's 6 experts do not divide 4 (drop-free capacity)
CASES = {"tinyllama-1.1b": {}, "gemma2-2b": {}, "qwen2-7b": dict(num_heads=6),
         "kimi-k2-1t-a32b": dict(num_experts=6, moe_capacity_factor=3.0)}
MAX_LEN, SLOTS = 32, 4
REQS = [(8, 4), (12, 3), (5, 4), (10, 2), (6, 3)]  # (prompt, max_new)
GEN_B, GEN_S, GEN_NEW = 2, 9, 4
LOGIT_TOL = 1e-5  # of each row's largest |logit|: fp32, sums split over the ranks
JAX_TOL = 1e-4  # of each row's largest |logit|: fp32, XLA's and torch's summation orders
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


def _ctx(m=M):
    return ExecContext(mesh=_FakeMesh(data=1, model=m), batch_axes=("data",), model_axis="model")


@functools.cache
def _pair(arch):
    """(JAX config, JAX params, the port's config, the numpy tree)."""
    jcfg = dataclasses.replace(jax_configs.reduced(jax_configs.get_config(arch)), **CASES[arch])
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), **CASES[arch])
    return jcfg, jp, cfg, jax.tree.map(np.asarray, jp)


def _gen_job(arch):
    cfg, tree = _pair(arch)[2:]
    r = np.random.default_rng(4)
    return dict(cfg=cfg, tree=tree, max_new=GEN_NEW, max_len=MAX_LEN,
                prompts=r.integers(1, cfg.vocab_size, (GEN_B, GEN_S), dtype=np.int32))


def _eng_job(arch):
    cfg, tree = _pair(arch)[2:]
    r = np.random.default_rng(6)
    reqs = [(i, r.integers(1, cfg.vocab_size, n, dtype=np.int32), new)
            for i, (n, new) in enumerate(REQS)]
    return dict(cfg=cfg, tree=tree, requests=reqs, max_slots=SLOTS, max_len=MAX_LEN,
                logit_prompts=r.integers(1, cfg.vocab_size, (2, 9), dtype=np.int32))


# the engine again with the plan knob attn_seq_shard: GQA prefill attention
# cut on its query sequence (prompts of 5, 10 and 6 tokens: 4 does not
# divide them); qwen2's padded heads, gemma2's window and softcaps
SEQ_ARCHS = ("qwen2-7b", "gemma2-2b")


def _seq_job(arch):
    return dict(_eng_job(arch), plan={"attn_seq_shard": True})


def _rank(rank, gen_jobs, eng_jobs):
    """One rank of the (1, 4) mesh: every ``generate`` job, then every
    continuous-engine job."""
    torch.set_num_threads(1)
    return (generate_rank(rank, gen_jobs, M, "cpu"), engine_rank(rank, eng_jobs, (1, M), "cpu"))


@pytest.fixture(scope="module")
def ranks():
    """The four ranks, spawned once for every job."""
    return run_ranks(_rank, M, ([_gen_job(a) for a in CASES],
                                [_eng_job(a) for a in CASES] + [_seq_job(a) for a in SEQ_ARCHS]),
                     timeout=RANK_LIMIT_S, device_type="cpu")


@functools.cache
def _unsharded(arch):
    """The port's unsharded run: (generate's tokens, the engine's job result)."""
    job = _gen_job(arch)
    cfg = job["cfg"]
    w = ModelWorker("u", cfg, convert.params_from_numpy(job["tree"], cfg, "cpu"), MAX_LEN)
    return w.generate(job["prompts"], GEN_NEW), serve_job(_eng_job(arch), ExecContext(), "cpu")


@pytest.mark.parametrize("arch", list(CASES))
def test_unsharded_port_matches_jax(arch):
    """The port's unsharded run, on the JAX package's weights: ``generate``'s
    greedy tokens equal the JAX worker's, and the prefill logits lie within
    ``JAX_TOL`` of each row's largest |logit|."""
    jcfg, jp = _pair(arch)[:2]
    job, eng = _gen_job(arch), _eng_job(arch)
    jw = JaxWorker("u", jcfg, jp, max_len=MAX_LEN)
    np.testing.assert_array_equal(_unsharded(arch)[0], np.asarray(jw.generate(job["prompts"],
                                                                              GEN_NEW)))
    want = np.asarray(jw.prefill_batch(eng["logit_prompts"])[0], np.float32)
    got = _unsharded(arch)[1]["logits"]
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= JAX_TOL * scale).all(), float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("arch", list(CASES))
def test_generate_on_four_ranks_matches_unsharded(ranks, arch):
    """``ModelWorker.generate`` (the bucketed mode) on every rank of the
    (1, 4) mesh: the port's unsharded greedy tokens; each rank holds its
    shard and the report counts sharded dims."""
    i = list(CASES).index(arch)
    want = _unsharded(arch)[0]
    for rank, r in enumerate(ranks):
        got = r[0][i]
        np.testing.assert_array_equal(got["tokens"], want, err_msg=f"rank {rank}")
        assert got["shard"] == (M, rank) and got["sharded"] > 0


@pytest.mark.parametrize("arch", list(CASES))
def test_engine_on_four_ranks_matches_unsharded(ranks, arch):
    """The continuous FIFO engine on every rank: per uid the port's
    unsharded greedy tokens, as many passes, no error; the prefill logits
    after the serve within ``LOGIT_TOL`` of each row's largest |logit| and
    equal on every rank."""
    i = list(CASES).index(arch)
    want = _unsharded(arch)[1]
    scale = np.abs(want["logits"]).max(axis=-1, keepdims=True)
    for rank, r in enumerate(ranks):
        got = r[1][i]
        assert got["errors"] == [] and got["tokens"] == want["tokens"], rank
        assert (got["prefill_calls"], got["decode_calls"]) == (want["prefill_calls"],
                                                               want["decode_calls"])
        assert got["shard"] == (M, rank) and got["all_reduces"] > 0
        np.testing.assert_array_equal(got["logits"], ranks[0][1][i]["logits"])
        err = np.abs(got["logits"] - want["logits"])
        assert (err <= LOGIT_TOL * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_engine_with_attn_seq_shard_matches_unsharded(ranks, arch):
    """The FIFO engine with the plan knob ``attn_seq_shard`` on every rank:
    the port's unsharded greedy tokens and passes, the prefill logits
    within ``LOGIT_TOL`` of each row's largest |logit|, equal on every
    rank; two all-to-alls (queries, outputs) per layer per prefill pass."""
    i = len(CASES) + SEQ_ARCHS.index(arch)
    want = _unsharded(arch)[1]
    scale = np.abs(want["logits"]).max(axis=-1, keepdims=True)
    for rank, r in enumerate(ranks):
        got = r[1][i]
        assert got["errors"] == [] and got["tokens"] == want["tokens"], rank
        assert (got["prefill_calls"], got["decode_calls"]) == (want["prefill_calls"],
                                                               want["decode_calls"])
        assert got["all_to_alls"] == 2 * _pair(arch)[2].num_layers * got["prefill_calls"] > 0
        np.testing.assert_array_equal(got["logits"], ranks[0][1][i]["logits"])
        err = np.abs(got["logits"] - want["logits"])
        assert (err <= LOGIT_TOL * scale).all(), float((err / scale).max())


def test_plans_replicate_kv_heads_pad_query_heads_and_keep_experts_whole():
    """No process group: at M = 4 reduced tinyllama's kv leaves are cut 2
    ways (rank m holds kv head m // 2 whole), its query leaves 4 ways, its
    K/V cache holds one kv head per rank and half its sequence (the kv
    group of 2 ranks cuts it); qwen2's 6 on 2 heads are padded
    to 4 per group (a rank of odd index holds its group's last real head
    and a zero head); kimi's 6 experts are whole on every rank."""
    tiny = _pair("tinyllama-1.1b")[2]
    plan = placement.plan_params(tiny, _ctx())
    a = "layers.0.attn."
    assert plan.dims[a + "wk.weight"] == 0 and plan.ways[a + "wk.weight"] == 2
    assert plan.dims[a + "wq.weight"] == 0 and a + "wq.weight" not in plan.ways
    assert plan.replicas(a + "wv.weight") == 2 and plan.replicas(a + "wq.weight") == 1
    assert [tmodel.cuts(plan, a + "wk.weight", r)[0][2] for r in range(M)] == [0, 0, 1, 1]
    specs = placement.plan_cache(tiny, _ctx(), 8, MAX_LEN)
    assert specs["k"][2:4] == ("model", "model")
    assert placement.local_cache_shape(tiny, _ctx(), "k", (2, 8, MAX_LEN, 2, 64),
                                       specs["k"]) == (2, 8, MAX_LEN // 2, 1, 64)
    qwen = _pair("qwen2-7b")[2]
    qplan = placement.plan_params(qwen, _ctx())
    assert qplan.segments[a + "wq.weight"] == placement.PaddedHeads(2, 3, 4, 64)
    assert qplan.segments[a + "bq"] == qplan.segments[a + "wo.weight"]
    whole = tmodel.init_params(qwen, 3, "cpu")
    w = dict(whole.named_parameters())
    for rank in range(M):
        got = dict(convert.shard_params(whole, _ctx(), rank=rank).named_parameters())
        g, j = divmod(rank, 2)
        real = w[a + "wq.weight"][(3 * g + 2 * j) * 64:(3 * g + min(3, 2 * j + 2)) * 64]
        assert got[a + "wq.weight"].shape == (128, qwen.d_model)
        assert torch.equal(got[a + "wq.weight"][:real.shape[0]], real)
        assert not got[a + "wq.weight"][real.shape[0]:].any()
        assert not got[a + "wo.weight"][:, real.shape[0]:].any()
        assert torch.equal(got[a + "wk.weight"], w[a + "wk.weight"][g * 64:(g + 1) * 64])
        drawn = dict(tmodel.init_params(qwen, 3, "cpu", ctx=_ctx(), rank=rank).named_parameters())
        assert all(torch.equal(drawn[n], got[n]) for n in got), rank
    kimi = _pair("kimi-k2-1t-a32b")[2]
    kplan = placement.plan_params(kimi, _ctx())
    experts = [n for n in kplan.dims if n.endswith(("mlp.w_gate", "mlp.w_up", "mlp.w_down"))]
    assert experts and all(kplan.dims[n] is None for n in experts)
    assert kplan.dims["layers.0.attn.wo.weight"] == 1 and kplan.dims["embedding"] == 0


def test_a_padded_head_adds_nothing_to_the_output():
    """Rank 1 of reduced qwen2 (6 on 2 heads) at M = 4 holds one real and
    one zero head: the zero head's query is 0, and whatever its attention
    output, the rank's wo partial is the same."""
    cfg = _pair("qwen2-7b")[2]
    whole = convert.params_from_numpy(_pair("qwen2-7b")[3], cfg, "cpu")
    with torch.no_grad():
        whole.layers[0].attn.bq.normal_()  # a bias that would move a head with no padding
    p = convert.shard_params(whole, _ctx(), rank=1).layers[0].attn
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    q, k, v = att._project_qkv(p, x, cfg, torch.arange(5).expand(2, 5))
    assert q.shape[2] == 2 and k.shape[2] == 1 and not q[:, :, 1].any() and q[:, :, 0].any()
    o = att.attend(q, k, v, causal=True, impl="plain")
    noisy = o.clone()
    noisy[:, :, 1] = torch.randn_like(noisy[:, :, 1])
    torch.testing.assert_close(torch.nn.functional.linear(noisy.reshape(2, 5, -1), p.wo.weight),
                               torch.nn.functional.linear(o.reshape(2, 5, -1), p.wo.weight),
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch", list(CASES))
def test_train_mode_takes_these_layouts_and_draws_their_plan(arch):
    """Train mode at M = 4 takes what serving places: kv heads fewer than M
    (each whole on M / Hkv ranks), padded query heads and experts that M
    does not divide pass train mode's mesh check (``check_train_mesh``,
    which asks only for this rank's shard) and ``make_train_step`` draws
    their plan (their gradients: tests/test_torch_sharded_train_families.py)."""
    from types import SimpleNamespace

    from repro_torch.training.train_loop import make_train_step
    cfg = _pair(arch)[2]
    plan = placement.plan_params(cfg, _ctx())
    assert plan.shape == (1, M)
    tmodel.check_train_mesh(SimpleNamespace(shard=(M, 0)), _ctx())
    make_train_step(cfg, _ctx())
    if cfg.num_experts:
        assert plan.dims["layers.0.mlp.w_gate"] is None
    else:
        assert plan.ways["layers.0.attn.wk.weight"] == cfg.num_kv_heads
        padded = isinstance(plan.segments.get("layers.0.attn.wq.weight"), placement.PaddedHeads)
        assert padded == (arch == "qwen2-7b")
