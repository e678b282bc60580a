"""GQA and MLA serving at the shipped head ratios on a model axis of 8, in
the port, on eight gloo CPU ranks (a (1, 8) mesh), against the JAX package.

tinyllama-1.1b's 32 query heads on 4 kv heads (each kv head whole on 2
ranks, which hold half its K/V sequence each, 4 query heads per rank) and
qwen2-7b's 28 on 4 (each group of 7 padded with a zero head to 8, 4 per
rank), at the reduced configs' width but a head dim of 8, and
deepseek-v2-lite-16b's 16 MLA heads (2 per rank, the latent cut on its
sequence in 8 pieces, each rank's absorbed decode running all 16 heads
over its piece; its reduced experts whole on every rank), at the reduced
config's widths, fp32,
weights from the JAX package's ``init_params``.
One spawn of eight ranks runs ``ModelWorker.generate`` and the continuous
FIFO engine: every rank's greedy tokens equal the port's unsharded run's
and its prefill logits lie within 1e-5 of each row's largest |logit|; the
port's unsharded run gives the JAX package's unsharded ``generate`` tokens
and prefill logits within 1e-4 of each row's largest |logit|. The same
spawn trains qwen2's padded layout one step, with and without the plan
knob ``attn_seq_shard``: its vocabulary-parallel loss and gradients
against the port's unsharded step and the JAX package's ``loss_fn``. The
(1, 4) cases are in ``test_torch_mesh_wide.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import base as jax_configs  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.launch.dryrun import rank_bytes  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.sharded import (engine_rank, generate_rank, run_ranks,  # noqa: E402
                                        serve_job, train_rank)
from repro_torch.training.optimizer import OptConfig  # noqa: E402
from repro_torch.training.train_loop import batch_to_device, loss_and_grads  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402
from repro_torch.sharding import placement  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402

M = 8
HEADS = {"tinyllama-1.1b": dict(num_heads=32, num_kv_heads=4, head_dim=8),
         "qwen2-7b": dict(num_heads=28, num_kv_heads=4, head_dim=8),
         "deepseek-v2-lite-16b": dict(num_heads=16, num_kv_heads=16)}
MAX_LEN, SLOTS = 24, 4
REQS = [(8, 4), (11, 3), (5, 4), (9, 2)]  # (prompt, max_new)
GEN_B, GEN_S, GEN_NEW = 2, 7, 4
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


@functools.cache
def _pair(arch):
    """(JAX config, JAX params, the port's config, the numpy tree)."""
    jcfg = dataclasses.replace(jax_configs.reduced(jax_configs.get_config(arch)), **HEADS[arch])
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), **HEADS[arch])
    return jcfg, jp, cfg, jax.tree.map(np.asarray, jp)


def _jobs(arch):
    """(generate's job, the engine's job) of ``arch``."""
    cfg, tree = _pair(arch)[2:]
    r = np.random.default_rng(5)
    gen = dict(cfg=cfg, tree=tree, max_new=GEN_NEW, max_len=MAX_LEN,
               prompts=r.integers(1, cfg.vocab_size, (GEN_B, GEN_S), dtype=np.int32))
    reqs = [(i, r.integers(1, cfg.vocab_size, n, dtype=np.int32), new)
            for i, (n, new) in enumerate(REQS)]
    eng = dict(cfg=cfg, tree=tree, requests=reqs, max_slots=SLOTS, max_len=MAX_LEN,
               logit_prompts=r.integers(1, cfg.vocab_size, (2, 7), dtype=np.int32))
    return gen, eng


# train steps on (1, 8): qwen2's padded heads, with and without the plan knob
# attn_seq_shard, at a sequence that 8 does not divide (pieces of 2: the
# last two ranks' are all padding)
TRAIN_B, TRAIN_S = 2, 12
TRAIN_PLANS = (None, {"attn_seq_shard": True})
OC = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_TOL, TRAIN_JAX_TOL = 1e-5, 2e-5  # tests/test_torch_sharded_train.py's


def _train_jobs():
    cfg, tree = _pair("qwen2-7b")[2:]
    return [dict(cfg=cfg, tree=tree, batch=TRAIN_B, seq=TRAIN_S, steps=1, oc=OC, plan=plan,
                 grads=True) for plan in TRAIN_PLANS]


def _rank(rank, gen_jobs, eng_jobs, train_jobs):
    torch.set_num_threads(1)
    return (generate_rank(rank, gen_jobs, M, "cpu"), engine_rank(rank, eng_jobs, (1, M), "cpu"),
            train_rank(rank, train_jobs, (1, M), "cpu"))


@pytest.fixture(scope="module")
def ranks():
    """The eight ranks, spawned once for every config."""
    jobs = [_jobs(a) for a in HEADS]
    return run_ranks(_rank, M, ([g for g, _ in jobs], [e for _, e in jobs], _train_jobs()),
                     timeout=RANK_LIMIT_S, device_type="cpu")


@functools.cache
def _unsharded(arch):
    gen, eng = _jobs(arch)
    cfg = gen["cfg"]
    w = ModelWorker("u", cfg, convert.params_from_numpy(gen["tree"], cfg, "cpu"), MAX_LEN)
    return w.generate(gen["prompts"], GEN_NEW), serve_job(eng, ExecContext(), "cpu")


@pytest.mark.parametrize("arch", list(HEADS))
def test_unsharded_port_matches_jax(arch):
    """The port's unsharded run at the shipped head ratio: the JAX worker's
    greedy tokens, prefill logits within ``JAX_TOL`` of each row's largest
    |logit|."""
    jcfg, jp = _pair(arch)[:2]
    gen, eng = _jobs(arch)
    jw = JaxWorker("u", jcfg, jp, max_len=MAX_LEN)
    np.testing.assert_array_equal(_unsharded(arch)[0],
                                  np.asarray(jw.generate(gen["prompts"], GEN_NEW)))
    want = np.asarray(jw.prefill_batch(eng["logit_prompts"])[0], np.float32)
    got = _unsharded(arch)[1]["logits"]
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= JAX_TOL * scale).all(), float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("arch", list(HEADS))
def test_eight_ranks_match_unsharded(ranks, arch):
    """Every rank of the (1, 8) mesh: ``generate``'s and the FIFO engine's
    greedy tokens equal the port's unsharded run's, as many passes, the
    prefill logits within ``LOGIT_TOL`` of each row's largest |logit| and
    equal on every rank."""
    i = list(HEADS).index(arch)
    toks, want = _unsharded(arch)
    scale = np.abs(want["logits"]).max(axis=-1, keepdims=True)
    for rank, (gen, eng, _) in enumerate(ranks):
        np.testing.assert_array_equal(gen[i]["tokens"], toks, err_msg=f"rank {rank}")
        got = eng[i]
        assert got["errors"] == [] and got["tokens"] == want["tokens"], rank
        assert (got["prefill_calls"], got["decode_calls"]) == (want["prefill_calls"],
                                                               want["decode_calls"])
        assert got["shard"] == gen[i]["shard"] == (M, rank) and got["all_reduces"] > 0
        np.testing.assert_array_equal(got["logits"], ranks[0][1][i]["logits"])
        err = np.abs(got["logits"] - want["logits"])
        assert (err <= LOGIT_TOL * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("arch", list(HEADS))
def test_rank_bytes_equal_the_dry_run_count(ranks, arch):
    """Every rank's parameters and slot pool hold exactly the bytes that the
    dry run counts for its shard on the meta device
    (``launch.dryrun.rank_bytes``): qwen2's padded heads, the kv heads
    whole on 2 ranks with half the K/V sequence each, deepseek's latent in 8
    pieces of its sequence."""
    i = list(HEADS).index(arch)
    cfg = _pair(arch)[2]
    whole = sum(int(np.prod(s)) * 4 for s in placement.cache_shapes(cfg, SLOTS, MAX_LEN).values())
    for rank, (_, eng, _) in enumerate(ranks):
        assert eng[i]["rank_bytes"] == rank_bytes(cfg, {"data": 1, "model": M}, rank, SLOTS,
                                                  MAX_LEN), rank
        assert eng[i]["rank_bytes"]["cache"] * M == whole, rank  # 1/M of the cache a rank


@functools.cache
def _train_refs():
    """qwen2's step-0 loss and gradients, unsharded: the port's
    (``loss_and_grads``) and the JAX package's (``jax.value_and_grad`` of
    its ``loss_fn``), on the same weights and batch."""
    jcfg, jp, cfg, tree = _pair("qwen2-7b")
    params = convert.params_from_numpy(tree, cfg, "cpu")
    tmodel.train_params(params)
    batch = SyntheticLM(cfg, DataConfig(batch=TRAIN_B, seq_len=TRAIN_S)).batch(0)
    loss, _, grads = loss_and_grads(params, cfg, batch_to_device(batch, "cpu"))
    port = (float(loss), {k: v.numpy() for k, v in grads.items()})
    jb = jax_data.SyntheticLM(jcfg, jax_data.DataConfig(batch=TRAIN_B, seq_len=TRAIN_S)).batch(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jax_model.loss_fn(p, jcfg, jb),
                                             has_aux=True))(jp)
    return port, (float(jl), convert.named_arrays(jax.tree.map(np.asarray, jg), cfg))


@pytest.mark.parametrize("j", range(len(TRAIN_PLANS)), ids=["plain", "attn_seq_shard"])
def test_padded_train_step_on_eight_ranks_matches_unsharded_and_jax(ranks, j):
    """A train step of qwen2's padded heads on (1, 8), without and with the
    plan knob ``attn_seq_shard`` (S = 12: pieces of 2, the last two ranks'
    all padding): every rank's loss and every gradient leaf, gathered
    whole, against the port's unsharded step and the JAX package's
    ``loss_fn`` at ``tests/test_torch_sharded_train.py``'s tolerances; the
    loss is the vocabulary-parallel cross-entropy (no ``all_gather_last``)."""
    (loss, grads), (jloss, jgrads) = _train_refs()
    for rank, (_, _, train) in enumerate(ranks):
        res = train[j]
        got = res["history"][0]["loss"]
        assert abs(got - loss) <= TRAIN_TOL * abs(loss), (rank, got, loss)
        assert abs(got - jloss) <= TRAIN_TOL * abs(jloss), (rank, got, jloss)
        steps = res["collectives"][0]
        assert "all_gather_last" not in steps and steps["all_reduce_max"] == 1, steps
        assert (steps.get("all_to_all", 0) > 0) == (TRAIN_PLANS[j] is not None), steps
        if rank:
            continue
        for leaf, ref in grads.items():
            np.testing.assert_allclose(res["grads"][leaf], ref, rtol=0,
                                       atol=TRAIN_TOL * np.abs(ref).max(), err_msg=leaf)
            np.testing.assert_allclose(res["grads"][leaf], jgrads[leaf], rtol=0,
                                       atol=TRAIN_JAX_TOL * np.abs(jgrads[leaf]).max(),
                                       err_msg=leaf)
