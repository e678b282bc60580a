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
and prefill logits within 1e-4 of each row's largest |logit|. The (1, 4)
cases are in ``test_torch_mesh_wide.py``.
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
from repro_torch.launch.dryrun import rank_bytes  # noqa: E402
from repro_torch.launch.sharded import engine_rank, generate_rank, run_ranks, serve_job  # noqa: E402
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


def _rank(rank, gen_jobs, eng_jobs):
    torch.set_num_threads(1)
    return (generate_rank(rank, gen_jobs, M, "cpu"), engine_rank(rank, eng_jobs, (1, M), "cpu"))


@pytest.fixture(scope="module")
def ranks():
    """The eight ranks, spawned once for both configs."""
    jobs = [_jobs(a) for a in HEADS]
    return run_ranks(_rank, M, ([g for g, _ in jobs], [e for _, e in jobs]),
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
    for rank, (gen, eng) in enumerate(ranks):
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
    for rank, (_, eng) in enumerate(ranks):
        assert eng[i]["rank_bytes"] == rank_bytes(cfg, {"data": 1, "model": M}, rank, SLOTS,
                                                  MAX_LEN), rank
        assert eng[i]["rank_bytes"]["cache"] * M == whole, rank  # 1/M of the cache a rank
