"""kimi-k2-1t-a32b in the port against the JAX package on the same
weights (carried across by ``convert.params_from_numpy``): the config, the
reduced kimi (4 experts, top-2, capacity factor 2, so drop-free) through
prefill and ragged decode, and a narrow config with kimi's head dim 112
(4 q heads on 1 kv head, d_model 448) whose attention goes through the
port's plain versions against the JAX Pallas flash and decode kernels in
interpret mode (the JAX wrappers take one scalar position per call, so
the ragged decode is compared row by row). fp32 tolerance 1e-4 for the
models (the frameworks sum in different orders), 3e-5 for one attention
call, as ``tests/test_torch_archs.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as jax_att  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402

KIMI = "kimi-k2-1t-a32b"
TOL = 1e-4
KERNEL_TOL = 3e-5
NARROW = dict(d_model=448, num_heads=4, num_kv_heads=1, head_dim=112)


@functools.cache
def _pair(narrow: bool):
    """(JAX config, JAX params, port config, port params) of the reduced
    kimi, or of the narrow head-dim-112 config."""
    jcfg = jax_configs.reduced(jax_configs.get_config(KIMI))
    tcfg = configs.reduced(configs.get_config(KIMI))
    if narrow:
        jcfg, tcfg = (dataclasses.replace(c, **NARROW) for c in (jcfg, tcfg))
    tree = jax.tree.map(np.asarray, jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def test_kimi_config_is_a_copy_of_the_jax_config():
    j, t = jax_configs.get_config(KIMI), configs.get_config(KIMI)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(configs.reduced(t)) == dataclasses.asdict(jax_configs.reduced(j))
    assert t.head_dim == 112 and t.num_heads // t.num_kv_heads == 8
    assert KIMI in configs.ARCHS and set(configs.ARCHS) == set(jax_configs.ARCHS)


def test_params_from_numpy_carries_the_kimi_tree():
    """GQA with no bias, MoE on every layer (384 experts at full width, 4
    here), no shared expert, no dense first layer, an untied LM head."""
    jcfg, jp, tcfg, tp = _pair(False)
    full = configs.get_config(KIMI)
    assert (full.num_shared_experts, full.first_dense_layers, full.tie_embeddings,
            full.qkv_bias) == (0, 0, False, False)
    assert tcfg.mlp_kinds() == ("moe",) * tcfg.num_layers
    np.testing.assert_array_equal(tp.lm_head.weight.numpy(), np.asarray(jp["embed"]["lm_head"]).T)
    for layer, (st, r) in zip(tp.layers, ((0, 0), (0, 1))):
        jl = jp["stages"][st]["l0"]
        assert layer.mlp.shared is None and not hasattr(layer.attn, "bq")
        for leaf in ("w_gate", "w_up", "w_down", "router"):
            np.testing.assert_array_equal(getattr(layer.mlp, leaf).numpy(),
                                          np.asarray(jl["mlp"][leaf][r]))
        np.testing.assert_array_equal(layer.attn.wk.weight.numpy(),
                                      np.asarray(jl["attn"]["wk"][r]).T)


@pytest.mark.parametrize("narrow", [False, True], ids=["reduced", "head_dim_112"])
def test_prefill_and_ragged_decode_match_jax(narrow):
    """Prefill logits at every position, then 4 ragged decode steps over a
    slot pool (prompts of 5, 17 and 12, a slot parked at max_len), logits
    within 1e-4 and the same greedy tokens."""
    jcfg, jp, tcfg, tp = _pair(narrow)
    B, S, max_len = 2, 20, 32
    prompts = np.random.default_rng(1).integers(1, jcfg.vocab_size, (B, S), dtype=np.int32)
    jl, _ = jax_model.prefill(jp, jcfg, jnp.asarray(prompts), jax_model.init_cache(jcfg, B, max_len))
    tl, _ = tmodel.prefill(tp, tcfg, torch.from_numpy(prompts).long(),
                           tmodel.init_cache(tcfg, B, max_len, device="cpu"))
    _close(tl, jl)
    jw, tw = JaxWorker("m", jcfg, jp, max_len=max_len), ModelWorker("m", tcfg, tp, max_len)
    jpool, tpool = jw.init_pool(4), tw.init_pool(4)
    r = np.random.default_rng(2)
    lens = (5, 17, 12)
    for slot, n in enumerate(lens):
        p = r.integers(1, jcfg.vocab_size, n, dtype=np.int32)
        jpool = jw.write_slots(jpool, jw.prefill_one(p)[1], np.array([slot], np.int32))
        tpool = tw.write_slots(tpool, tw.prefill_one(p)[1], np.array([slot], np.int32))
    pos = np.array(list(lens) + [max_len], np.int32)
    toks = r.integers(1, jcfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(4):
        jn, jlog, jpool = jw.decode_pool(jpool, toks, pos)
        tn, tlog, tpool = tw.decode_pool(tpool, toks, pos)
        _close(tlog[:3], np.asarray(jlog)[:3])
        np.testing.assert_array_equal(tn[:3], np.asarray(jn)[:3])
        toks, pos = np.asarray(jn)[:, None].astype(np.int32), np.minimum(pos + 1, max_len)


def test_head_dim_112_attention_matches_the_pallas_kernels():
    """Layer 0's attention at head dim 112 through the port's plain versions
    (the CPU route of the flash and decode wrappers) against the JAX layer
    through its Pallas kernels in interpret mode: the causal prefill, then
    a ragged decode row by row (slots at 0, 9, 30 and one parked at Smax,
    whose write drops), outputs and caches."""
    jcfg, jp, tcfg, tp = _pair(True)
    jl = jax.tree.map(lambda a: a[0], jp["stages"][0]["l0"]["attn"])
    tl = tp.layers[0].attn
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    out, (k, v) = tatt.gqa_forward(tl, torch.from_numpy(x), tcfg)
    jo, (jk, jv) = jax_att.gqa_forward(jl, jnp.asarray(x), jcfg, impl="pallas")
    for t, j in ((out, jo), (k, jk), (v, jv)):
        _close(t, j)
    B, Smax = 4, 32
    ck, cv = (r.standard_normal((B, Smax, 1, 112)).astype(np.float32) for _ in range(2))
    x = r.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([0, 9, 30, Smax], np.int32)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, _ = tatt.gqa_decode(tl, torch.from_numpy(x), tcfg, tk, tv, torch.from_numpy(pos))
    for b in range(B - 1):  # the parked slot attends its whole (stale) cache in both
        jo, (jk, jv) = jax_att.gqa_decode(jl, jnp.asarray(x[b:b + 1]), jcfg,
                                          jnp.asarray(ck[b:b + 1]), jnp.asarray(cv[b:b + 1]),
                                          int(pos[b]), impl="pallas")
        _close(out[b:b + 1], jo)
        _close(tk[b:b + 1], jk)
        _close(tv[b:b + 1], jv)
    np.testing.assert_array_equal(tk[B - 1].numpy(), ck[B - 1])


@pytest.mark.parametrize("H,Hkv", [(64, 8), (32, 4)], ids=["kimi", "kimi_rank_of_2"])
def test_plain_kernels_at_kimi_heads_match_pallas(H, Hkv):
    """The plain flash (causal, S 40 across the Pallas 32-row blocks) and
    the plain decode and its split-and-merge twin (per-row positions, one
    row keeping no key) at kimi's heads, 64 on 8 and one rank's 32 on 4 at a
    model axis of 2, D 112, against the Pallas kernels in interpret mode."""
    r = np.random.default_rng(H)
    B, S = 1, 40
    q, k, v = (r.standard_normal((B, S, n, 112)).astype(np.float32) for n in (H, Hkv, Hkv))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, block_q=32,
                    block_k=32, interpret=True)
    _close(fmod.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=True), ref, KERNEL_TOL)
    Smax, pos = 96, np.array([0, 33, 95], np.int32)
    B = len(pos)
    q = r.standard_normal((B, 1, H, 112)).astype(np.float32)
    k, v = (r.standard_normal((B, Smax, Hkv, 112)).astype(np.float32) for _ in range(2))
    kv_len = np.array([0, 34, 96], np.int32)
    rows = [np.asarray(jax_decode(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                                  jnp.asarray(v[b:b + 1]), q_offset=int(pos[b]),
                                  kv_len=int(kv_len[b]), block_k=32), np.float32)
            for b in range(1, B)]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(q_offset=torch.from_numpy(pos), kv_len=torch.from_numpy(kv_len))
    for fn in (dmod.decode_attention_plain, dmod.decode_attention_split_plain):
        got = fn(tq, tk, tv, **kw)
        _close(got[1:], np.concatenate(rows), KERNEL_TOL)
        assert float(got[0].abs().max()) == 0.0  # a row that keeps no key writes 0
    assert dmod.decode_route(H // Hkv, 112, 112) == "decode_attention_fwd"
    assert 112 in fmod.FLASH_DV and 112 in dmod.DECODE_DV
