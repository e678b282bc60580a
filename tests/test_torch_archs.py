"""The archs of the seventh port slice against the JAX package on the same
weights: granite-3-8b (dense GQA), qwen2-7b (qkv bias, G = 7 at full
width), chameleon-34b (qk-norm) and deepseek-v2-lite-16b (MLA with its
latent cache, capacity-factor MoE with shared experts, a dense first
layer). The trees' qkv biases and norm scales are set to random values on
both sides, since the inits' zeros and ones would hide the features.
fp32 tolerance 1e-4 (the frameworks sum in different orders); the plain
decode at the new kernel shapes (G = 7, the absorbed-MLA G = 16 Dk 576
Dv 512) is held against the Pallas decode kernel in interpret mode, row by
row (it takes one scalar position), at 3e-5.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.models import attention as jax_att  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro.sharding.context import ExecContext as JaxCtx  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import _load, params_from_numpy  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import mla_attention as mmod  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402

TOL = 1e-4
KERNEL_TOL = 3e-5  # fp32, as tests/test_torch_decode_split.py
NEW = ["granite-3-8b", "qwen2-7b", "chameleon-34b", "deepseek-v2-lite-16b"]
_SCALES = ("scale", "q_norm", "k_norm", "kv_norm")


def randomise(tree, seed):
    """A numpy copy of a JAX param tree whose qkv biases are N(0, 0.5) and
    whose norm scales (layer norms, qk-norm, MLA's kv_norm) are
    1 + N(0, 0.3)."""
    r = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (r.standard_normal(np.shape(v)).astype(np.float32) * 0.5
                        if k in ("bq", "bk", "bv") else
                        (1.0 + 0.3 * r.standard_normal(np.shape(v))).astype(np.float32)
                        if k in _SCALES and not isinstance(v, dict) else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return np.asarray(node)
    return walk(tree)


@functools.cache
def _pair(arch, num_layers=2, cf=None):
    """Reduced JAX config and randomised params, and their port
    counterparts; ``cf`` sets ``moe_capacity_factor``."""
    jcfg = dataclasses.replace(jax_configs.reduced(jax_configs.get_config(arch)),
                               num_layers=num_layers)
    tcfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), num_layers=num_layers)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    tree = randomise(jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg),
                     seed=1)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", NEW)
def test_configs_are_copies_of_the_jax_configs(arch):
    j, t = jax_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(configs.reduced(t)) == dataclasses.asdict(jax_configs.reduced(j))


# ---------------------------------------------------------------------------
# GQA with qkv bias (qwen2) and qk-norm (chameleon)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-7b", "chameleon-34b"])
def test_gqa_bias_and_qk_norm_match_jax(arch):
    """Prefill, ragged decode (a slot parked at Smax) and the T = 4 verify
    (rows at 0, 7, Smax - T, Smax - 2 and Smax) of layer 0, outputs and
    caches, with random biases and norm scales in both trees."""
    jcfg, jp, tcfg, tp = _pair(arch)
    jl = jax.tree.map(lambda a: a[0], jp["stages"][0]["l0"]["attn"])
    tl = tp.layers[0].attn
    if tcfg.qkv_bias:
        assert float(tl.bq.abs().min()) > 0
    if tcfg.qk_norm:
        assert float((tl.q_norm.scale - 1).abs().max()) > 0.1
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    out, (k, v) = tatt.gqa_forward(tl, torch.from_numpy(x), tcfg)
    jo, (jk, jv) = jax_att.gqa_forward(jl, jnp.asarray(x), jcfg)
    for t, j in ((out, jo), (k, jk), (v, jv)):
        _close(t, j)
    B, Smax = 5, 40
    ck, cv = (r.standard_normal((B, Smax, tcfg.num_kv_heads, tcfg.head_dim)).astype(np.float32)
              for _ in range(2))
    for T, pos in ((1, [5, 17, 31, Smax - 1, Smax]), (4, [0, 7, Smax - 4, Smax - 2, Smax])):
        x = r.standard_normal((B, T, tcfg.d_model)).astype(np.float32)
        pos = np.asarray(pos, np.int32)
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        out, _ = tatt.gqa_decode(tl, torch.from_numpy(x), tcfg, tk, tv, torch.from_numpy(pos))
        jo, (jk, jv) = jax_att.gqa_decode(jl, jnp.asarray(x), jcfg, jnp.asarray(ck),
                                          jnp.asarray(cv), jnp.asarray(pos))
        for t, j in ((out, jo), (tk, jk), (tv, jv)):
            _close(t, j)
        np.testing.assert_array_equal(tk[4].numpy(), ck[4])  # the parked row wrote nothing


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_pair():
    jcfg, jp, tcfg, tp = _pair("deepseek-v2-lite-16b")
    return jcfg, jax.tree.map(lambda a: a[0], jp["stages"][0]["l0"]["attn"]), tcfg, \
        tp.layers[0].attn


def test_mla_forward_matches_jax():
    """The naive-form prefill: output and the latent cache's two parts,
    with a random ``kv_norm``."""
    jcfg, jl, tcfg, tl = _mla_pair()
    assert float((tl.kv_norm.scale - 1).abs().max()) > 0.1
    x = np.random.default_rng(3).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    out, (c_kv, k_rope) = tatt.mla_forward(tl, torch.from_numpy(x), tcfg)
    jo, (jc, jr) = jax_att.mla_forward(jl, jnp.asarray(x), jcfg)
    for t, j in ((out, jo), (c_kv, jc), (k_rope, jr)):
        _close(t, j)


@pytest.mark.parametrize("branch", ["scalar", "ragged", "verify"])
def test_mla_decode_matches_jax(branch):
    """The absorbed decode in its three branches against a latent cache of
    random (stale) rows: a scalar position; per-slot positions with a slot
    parked at Smax; T = 3 positions per row at 0, 7, Smax - 3, Smax - 2 and
    Smax. The port's one latent tensor holds the JAX package's c_kv and
    k_rope caches side by side."""
    jcfg, jl, tcfg, tl = _mla_pair()
    lr, B, Smax = tcfg.kv_lora_rank, 5, 40
    r = np.random.default_rng(4)
    ckv = r.standard_normal((B, Smax, lr)).astype(np.float32)
    krope = r.standard_normal((B, Smax, tcfg.qk_rope_dim)).astype(np.float32)
    T, pos = {"scalar": (1, 11), "ragged": (1, np.array([3, 20, 31, Smax - 1, Smax], np.int32)),
              "verify": (3, np.array([0, 7, Smax - 3, Smax - 2, Smax], np.int32))}[branch]
    x = r.standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    latent = torch.from_numpy(np.concatenate([ckv, krope], -1))
    out, _ = tatt.mla_decode(tl, torch.from_numpy(x), tcfg, latent, torch.as_tensor(pos))
    jo, (jc, jr) = jax_att.mla_decode(jl, jnp.asarray(x), jcfg, jnp.asarray(ckv),
                                      jnp.asarray(krope), jnp.asarray(pos))
    _close(out, jo)
    _close(latent[..., :lr], jc)
    _close(latent[..., lr:], jr)
    if branch != "scalar":  # the parked row wrote nothing
        np.testing.assert_array_equal(latent[4, :, :lr].numpy(), ckv[4])


# ---------------------------------------------------------------------------
# the plain decode at the new kernel shapes, against the Pallas kernel
# ---------------------------------------------------------------------------


def _pallas_rows(q, k, v, pos, **kw):
    """The Pallas decode kernel (interpret mode) row by row."""
    rows = [jax_decode(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]), jnp.asarray(v[b:b + 1]),
                       q_offset=int(pos[b]), kv_len=int(min(pos[b] + 1, k.shape[1])), block_k=32,
                       **kw) for b in range(len(pos))]
    return np.concatenate([np.asarray(o, np.float32) for o in rows])


@pytest.mark.parametrize("G,Hkv,Dk,Dv,Smax,pos", [
    (7, 4, 128, 128, 200, [0, 31, 32, 150, 199]),       # qwen2-7b's 28/4 heads
    (16, 1, 576, 512, 96, [0, 40, 63, 64, 95]),         # the absorbed MLA decode
])
def test_decode_plain_and_split_at_new_shapes_match_pallas(G, Hkv, Dk, Dv, Smax, pos):
    """``decode_attention_plain`` and the kernels' split-and-merge arithmetic
    (``decode_attention_split_plain``, the planned split and one of 32
    keys) at G = 7 and at the MLA shape, whose values are the latent rows'
    first 512 columns."""
    r = np.random.default_rng(G)
    B = len(pos)
    q = r.standard_normal((B, 1, G * Hkv, Dk)).astype(np.float32)
    k = r.standard_normal((B, Smax, Hkv, Dk)).astype(np.float32)
    v = k[..., :Dv].copy() if Dk > Dv else r.standard_normal((B, Smax, Hkv, Dv)).astype(np.float32)
    scale = 192 ** -0.5 if Dk == 576 else None
    pos = np.asarray(pos, np.int32)
    ref = _pallas_rows(q, k, v, pos, scale=scale)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    tv = tk[..., :Dv] if Dk > Dv else torch.from_numpy(v)
    kw = dict(q_offset=torch.from_numpy(pos), kv_len=torch.from_numpy(pos + 1), scale=scale)
    if Dk == 576:  # the MLA kernels' shape, which no decode kernel takes
        assert mmod.is_mla_shape(tq, tk, tv)
        with pytest.raises(ValueError):
            dmod.decode_route(G, Dk, Dv)
    else:
        assert dmod.decode_route(G, Dk, Dv) == "decode_attention_fwd"
    _close(dmod.decode_attention_plain(tq, tk, tv, **kw), ref, KERNEL_TOL)
    _close(dmod.decode_attention_split_plain(tq, tk, tv, **kw), ref, KERNEL_TOL)
    _close(dmod.decode_attention_split_plain(tq, tk, tv, split_len=32, **kw), ref, KERNEL_TOL)
    # on the CPU the wrappers run the plain versions and count no launch
    before = (dmod.decode_attention.launches, mmod.mla_attention.launches)
    _close(dmod.decode_attention(tq, tk, tv, **kw), ref, KERNEL_TOL)
    _close(mmod.mla_attention(tq, tk, tv, causal=False, **kw), ref, KERNEL_TOL)
    assert (dmod.decode_attention.launches, mmod.mla_attention.launches) == before


def test_decode_route_refuses_shapes_no_kernel_takes():
    for G, Dk, Dv in ((16, 128, 128), (7, 96, 96), (3, 64, 64), (16, 576, 256),
                      (16, 576, 512)):
        with pytest.raises(ValueError):
            dmod.decode_route(G, Dk, Dv)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_pair(E, k, cf, shared=1, seed=0):
    cfg = dataclasses.replace(jax_configs.reduced(jax_configs.get_config("deepseek-v2-lite-16b")),
                              num_experts=E, top_k=k, moe_capacity_factor=cf,
                              num_shared_experts=shared)
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), cfg)
    tcfg = dataclasses.replace(configs.reduced(configs.get_config("deepseek-v2-lite-16b")),
                               num_experts=E, top_k=k, moe_capacity_factor=cf,
                               num_shared_experts=shared)
    mod = tmoe.MoE(tcfg).requires_grad_(False)
    with torch.no_grad():
        _load(mod, jax.tree.map(lambda a: np.asarray(a)[None], jp), 0)
    return cfg, jp, tcfg, mod


def test_route_orders_ties_as_lax_top_k():
    """Equal probabilities: the lower expert id first, as ``lax.top_k``."""
    D, E = 8, 6
    xt = np.eye(4, D, dtype=np.float32)
    router = np.zeros((D, E), np.float32)
    router[1] = [0.0, 1.0, 0.0, 1.0, 1.0, 0.5]  # token 1: experts 1, 3, 4 tie
    router[2] = [2.0, 0.0, 2.0, 0.0, 0.0, 2.0]  # token 2: experts 0, 2, 5 tie
    _, jg, ji = jax_moe._route(jnp.asarray(xt), jnp.asarray(router), 3)
    _, tg, ti = tmoe.route(torch.from_numpy(xt), torch.from_numpy(router), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[:3], [[0, 1, 2], [1, 3, 4], [0, 2, 5]])
    _close(tg, jg, 1e-6)


@pytest.mark.parametrize("B,S,E,k,cf,drops", [
    (2, 12, 4, 2, 2.0, False),    # the reduced config: capacity E / k, drop-free
    (2, 12, 8, 2, 1.25, True),    # the published capacity factor, a prefill
    (8, 1, 16, 6, 1.25, True),    # a decode step over 8 slots: capacity 4 per expert
])
def test_moe_apply_matches_jax(B, S, E, k, cf, drops):
    """Routing ids and gates identical, output and aux loss within 1e-4;
    at capacity factor 1.25 assignments are dropped (asserted)."""
    cfg, jp, tcfg, mod = _moe_pair(E, k, cf)
    x = np.random.default_rng(E).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jo, jaux = jax_moe.moe_apply(jp, jnp.asarray(x), cfg, JaxCtx())
    out, aux = tmoe.moe_apply(mod, torch.from_numpy(x), tcfg)
    xt = torch.from_numpy(x).reshape(B * S, -1)
    _, tg, ti = tmoe.route(xt, mod.router, k)
    _, jg, ji = jax_moe._route(jnp.asarray(x).reshape(B * S, -1), jp["router"], k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, 1e-6)
    _close(out, jo)
    _close(aux, jaux)
    C = tmoe._capacity(B * S, k, E, cf)
    assert C == jax_moe._capacity(B * S, k, E, cf)
    _, _, valid = tmoe.dispatch(ti, E, C)
    assert bool((~valid).any()) == drops


def test_moe_combine_sums_each_tokens_choices_in_order():
    """The combine adds a token's k contributions in choice order, so a
    permutation of the batch permutes the output exactly."""
    _, _, tcfg, mod = _moe_pair(8, 2, 4.0, shared=0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 16, tcfg.d_model))
                         .astype(np.float32))
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(0))
    a, _ = tmoe.moe_apply(mod, x, tcfg)
    b, _ = tmoe.moe_apply(mod, x[:, perm], tcfg)
    assert torch.equal(a[:, perm], b)


# ---------------------------------------------------------------------------
# whole models: prefill and the ragged slot-pool decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,cf", [(a, None) for a in NEW] + [("deepseek-v2-lite-16b", 1.25)])
def test_reduced_model_prefill_and_ragged_decode_match_jax(arch, cf):
    """Prompts of different lengths prefilled into slot rows, then ragged
    decode steps with a slot parked at max_len; logits each step within
    1e-4, greedy tokens identical, and the caches (deepseek: layer 0 dense,
    layer 1 MoE; the latent cache against c_kv and k_rope)."""
    jcfg, jp, tcfg, tp = _pair(arch, cf=cf)
    max_len, lens = 40, (5, 27, 12)
    jw, tw = JaxWorker("m", jcfg, jp, max_len=max_len), ModelWorker("m", tcfg, tp, max_len=max_len)
    jpool, tpool = jw.init_pool(4), tw.init_pool(4)
    r = np.random.default_rng(6)
    for slot, n in enumerate(lens):
        p = r.integers(1, jcfg.vocab_size, n, dtype=np.int32)
        jl, jc = jw.prefill_one(p)
        tl, tc = tw.prefill_one(p)
        _close(tl, jl)
        jpool = jw.write_slots(jpool, jc, np.array([slot], np.int32))
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
    stage0 = jpool[0]["l0"]
    if tcfg.use_mla:
        lr = tcfg.kv_lora_rank
        _close(tpool["latent"][0, ..., :lr], stage0["c_kv"][0])
        _close(tpool["latent"][0, ..., lr:], stage0["k_rope"][0])
        assert [lyr.mlp_kind for lyr in tp.layers] == ["dense", "moe"]
    else:
        _close(tpool["k"][0], stage0["k"][0])
        _close(tpool["v"][0], stage0["v"][0])


def test_init_params_draws_the_new_leaves_as_the_jax_init():
    """Router N(0,1)/sqrt(D) in fp32, experts N(0,1)/sqrt(d_in), w_ukv
    N(0,1)/sqrt(lr), kv_norm and qk-norm scales 1, qkv biases 0."""
    from repro_torch.models.model import init_params
    ds = configs.reduced(configs.get_config("deepseek-v2-lite-16b"))
    p = init_params(ds, seed=0, device="cpu")
    attn, moe = p.layers[1].attn, p.layers[1].mlp
    assert moe.router.dtype == torch.float32
    for t, std in ((moe.router, ds.d_model ** -0.5), (moe.w_gate, ds.d_model ** -0.5),
                   (moe.w_down, ds.moe_d_ff ** -0.5), (attn.w_ukv, ds.kv_lora_rank ** -0.5),
                   (moe.shared.w_down.weight, (ds.num_shared_experts * ds.moe_d_ff) ** -0.5)):
        assert abs(float(t.std()) / std - 1) < 0.1
    assert float(attn.kv_norm.scale.min()) == float(attn.kv_norm.scale.max()) == 1.0
    qw = init_params(configs.reduced(configs.get_config("qwen2-7b")), seed=0, device="cpu")
    assert not qw.layers[0].attn.bq.any() and not qw.layers[0].attn.bv.any()
    ch = init_params(configs.reduced(configs.get_config("chameleon-34b")), seed=0, device="cpu")
    assert float(ch.layers[0].attn.k_norm.scale.min()) == 1.0
