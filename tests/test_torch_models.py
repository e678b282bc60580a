"""Models of the PyTorch port against the JAX package on the same weights:
JAX ``init_params`` -> numpy -> ``params_from_numpy``, then prefill and
decode logits and greedy tokens for reduced tinyllama-1.1b and gemma2-2b.
fp32 tolerance 1e-4: the frameworks sum their matmuls in different orders.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402

ARCHS = ["tinyllama-1.1b", "gemma2-2b"]
TOL = 1e-4


@functools.cache
def _pair(arch, num_layers=2):
    """JAX config + params and their port counterparts (shared; tests must
    not modify them)."""
    jcfg = dataclasses.replace(jax_configs.reduced(jax_configs.get_config(arch)),
                               num_layers=num_layers)
    tcfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), num_layers=num_layers)
    jparams = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS + ["mamba2-2.7b"])
def test_configs_are_copies_of_the_jax_configs(arch):
    j, t = jax_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(configs.reduced(t)) == dataclasses.asdict(jax_configs.reduced(j))


def test_unported_arch_names_the_roadmap():
    with pytest.raises(ValueError, match="ROADMAP.md"):
        configs.get_config("llama-9-1t")


def test_layer_primitives_match_jax():
    """Hazards the JAX code hides: tanh GELU for gemma2, plain-scale RMSNorm,
    split-half RoPE, sqrt(d_model) embedding scale, fp32 logit softcap."""
    jcfg, jp, tcfg, tp = _pair("gemma2-2b")
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    jl, tl = jp["stages"][0]["l0"], tp.layers[0]
    jmlp = jax.tree.map(lambda a: a[0], jl["mlp"])
    scale = r.standard_normal(tcfg.d_model).astype(np.float32)
    xh = r.standard_normal((2, 5, 4, 64)).astype(np.float32)
    pos = np.array([[0, 3, 9, 100, 1000]] * 2, np.int32)
    ids = np.array([[1, 7, 300]], np.int32)
    h = r.standard_normal((1, 3, tcfg.d_model)).astype(np.float32) * 30

    @jax.jit
    def jax_side(x, scale, xh, pos, ids, h):
        return (jax_layers.apply_mlp(jmlp, x, jcfg),
                jax_layers.apply_norm({"scale": scale}, x, jcfg),
                jax_layers.apply_rope(xh, pos, 10_000.0),
                jax_layers.embed_tokens(jp["embed"], ids, jcfg),
                jax_layers.lm_logits(jp["embed"], h, jcfg))

    want = jax_side(x, scale, xh, pos, ids, h)
    norm = layers.RMSNorm(tcfg.d_model).requires_grad_(False)
    norm.scale.copy_(torch.from_numpy(scale))
    got = (layers.apply_mlp(tl.mlp, torch.from_numpy(x), tcfg),
           layers.apply_norm(norm, torch.from_numpy(x)),
           layers.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos), 10_000.0),
           layers.embed_tokens(tp.embedding, torch.from_numpy(ids).long(), tcfg),
           layers.lm_logits(tp.embedding, tp.lm_head, torch.from_numpy(h), tcfg))
    for t, j in zip(got, want):
        _close(t, j)


def test_prefill_and_greedy_decode_match_jax(pair):
    """Prefill logits at every position, then 8 greedy decode steps: logits
    within 1e-4 and identical tokens. The prompt (40) is longer than the
    reduced gemma2 window (32), so its local layers mask."""
    jcfg, jp, tcfg, tp = pair
    B, S, max_len = 2, 40, 64
    prompts = np.random.default_rng(1).integers(1, jcfg.vocab_size, (B, S), dtype=np.int32)
    jprefill = jax.jit(lambda p, t, c: jax_model.prefill(p, jcfg, t, c))
    jdecode = jax.jit(lambda p, t, c, i: jax_model.decode_step(p, jcfg, t, c, i))
    jl, jc = jprefill(jp, jnp.asarray(prompts), jax_model.init_cache(jcfg, B, max_len))
    tc = tmodel.init_cache(tcfg, B, max_len, device="cpu")
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(prompts).long(), tc)
    _close(tl, jl)
    jtok = np.argmax(np.asarray(jl)[:, -1], -1)
    ttok = tl[:, -1].argmax(-1).numpy()
    for i in range(8):
        np.testing.assert_array_equal(ttok, jtok)
        jl, jc = jdecode(jp, jnp.asarray(jtok[:, None], jnp.int32), jc, jnp.int32(S + i))
        tl, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(ttok[:, None]).long(), tc, S + i)
        _close(tl, jl)
        jtok, ttok = np.argmax(np.asarray(jl)[:, -1], -1), tl[:, -1].argmax(-1).numpy()


def test_ragged_decode_pool_matches_jax(pair):
    """The continuous engine's primitive: prompts of different lengths
    prefilled into slot rows, then ragged decode steps with per-slot
    positions. Slot 3 is parked at pos == max_len (a retired slot): its
    write is dropped in both frameworks."""
    jcfg, jp, tcfg, tp = pair
    max_len, lens = 48, (5, 33, 12)
    jw, tw = JaxWorker("m", jcfg, jp, max_len=max_len), ModelWorker("m", tcfg, tp, max_len=max_len)
    jpool, tpool = jw.init_pool(4), tw.init_pool(4)
    r = np.random.default_rng(2)
    for slot, n in enumerate(lens):
        p = r.integers(1, jcfg.vocab_size, n, dtype=np.int32)
        _, jc = jw.prefill_one(p)
        jpool = jw.write_slots(jpool, jc, np.array([slot], np.int32))
        _, tc = tw.prefill_one(p)
        tpool = tw.write_slots(tpool, tc, np.array([slot], np.int32))
    pos = np.array(list(lens) + [max_len], np.int32)
    toks = r.integers(1, jcfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(4):
        jn, jl, jpool = jw.decode_pool(jpool, toks, pos)
        tn, tl, tpool = tw.decode_pool(tpool, toks, pos)
        _close(tl, jl)
        np.testing.assert_array_equal(tn, jn)
        toks = jn[:, None].astype(np.int32)
        pos = np.minimum(pos + 1, max_len)
    for t, j in ((tpool["k"], jpool[0]["l0"]["k"]), (tpool["v"], jpool[0]["l0"]["v"])):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j)[0], atol=TOL, rtol=TOL)


def test_convert_pins_gemma2_local_global_order():
    """JAX stacks a stage's layers on a repeats axis: layer j of repeat r is
    absolute layer r * period + j. With 4 gemma2 layers the port's order
    must alternate local, global and carry the matching weights."""
    jcfg, jp, tcfg, tp = _pair("gemma2-2b", num_layers=4)
    assert [lyr.kind for lyr in tp.layers] == ["local", "global", "local", "global"]
    assert [lyr.window for lyr in tp.layers] == [32, None, 32, None]
    for i, lyr in enumerate(tp.layers):
        src = jp["stages"][0][f"l{i % 2}"]
        np.testing.assert_array_equal(lyr.attn.wq.weight.numpy(),
                                      np.asarray(src["attn"]["wq"][i // 2]).T)
        np.testing.assert_array_equal(lyr.mlp_post_norm.scale.numpy(),
                                      np.asarray(src["mlp_post_norm"]["scale"][i // 2]))


def test_init_params_distributions_and_seed():
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    a = tmodel.init_params(cfg, seed=0, device="cpu")
    b = tmodel.init_params(cfg, seed=0, device="cpu")
    c = tmodel.init_params(cfg, seed=1, device="cpu")
    assert torch.equal(a.layers[0].attn.wq.weight, b.layers[0].attn.wq.weight)
    assert not torch.equal(a.layers[0].attn.wq.weight, c.layers[0].attn.wq.weight)
    assert abs(float(a.embedding.std()) - 0.02) < 0.002
    assert abs(float(a.lm_head.weight.std()) - 0.02) < 0.002
    assert abs(float(a.layers[0].mlp.w_down.weight.std()) - cfg.d_ff ** -0.5) < 0.003
    assert float(a.layers[1].pre_norm.scale.min()) == 1.0
    assert not any(p.requires_grad for p in a.parameters())


def test_write_cache_slots_drops_padding_rows():
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    pool = tmodel.init_cache(cfg, 3, 8, device="cpu")
    group = tmodel.init_cache(cfg, 4, 8, device="cpu")
    for i in range(4):
        group["k"][:, i] = i + 1.0
        group["v"][:, i] = -(i + 1.0)
    tmodel.write_cache_slots(pool, group, np.array([2, 0, 3, 3], np.int32))  # 3 == n_slots
    assert [float(pool["k"][0, s].max()) for s in range(3)] == [2.0, 0.0, 1.0]
    assert [float(pool["v"][0, s].min()) for s in range(3)] == [-2.0, 0.0, -1.0]
    tmodel.write_cache_slot(pool, {n: t[:, 3:] for n, t in group.items()}, 1)
    assert [float(pool["k"][1, s].max()) for s in range(3)] == [2.0, 4.0, 1.0]


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_cache(cfg, 1, 8)


def test_speculative_verify_branch_is_not_ported():
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    p = tmodel.init_params(cfg, device="cpu")
    c = tmodel.init_cache(cfg, 2, 16, device="cpu")
    x = torch.zeros(2, 3, cfg.d_model)
    # the (B,) branch is ported (tests/test_torch_speculative.py holds it
    # against JAX); a single shared position for T > 1 stays refused
    out, _ = tatt.gqa_decode(p.layers[0].attn, x, cfg, c["k"][0], c["v"][0],
                             torch.tensor([1, 2]))
    assert out.shape == (2, 3, cfg.d_model)
    with pytest.raises(ValueError, match="per-row positions"):
        tatt.gqa_decode(p.layers[0].attn, x, cfg, c["k"][0], c["v"][0], 1)
