"""Mamba1 and the Jamba hybrid (Mamba1 + attention + MoE) of the port
against the JAX package on the same weights: ``mamba1_forward`` (with and
without a left-pad mask, across chunk edges) and ``mamba1_decode``, the
chunk scan at Jamba's decay magnitudes against the sequential recurrence,
and two reduced Jamba stacks through prefill, ragged decode and the
continuous engine (FIFO and AdaOper-scheduled): the default reduced config
(layer 0 Mamba1 with a dense MLP, layer 1 attention with MoE) and a
3-layer ``("mamba", "mamba", "attn")`` stack whose Mamba1 layer 1 carries
the MoE.

Mamba1's constant leaves (``A_log``, ``D``, ``dt_proj_b``, ``conv_b``, the
inner dt/B/C norm scales) and the layer norm scales are set to random
values on both sides, since the init's constants would hide a swapped
leaf. fp32 tolerance 1e-4 (the frameworks sum in different orders, and
the port's chunk scan pairs its products in another tree than
``jax.lax.associative_scan``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import DeviceSim as JaxSim  # noqa: E402
from repro.core import RuntimeEnergyProfiler as JaxProfiler  # noqa: E402
from repro.core import build_transformer_graph as jax_graph  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.serving.engine import AdaOperScheduler as JaxScheduler  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import _load, params_from_numpy  # noqa: E402
from repro_torch.core.opgraph import build_transformer_graph  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import AdaOperScheduler  # noqa: E402
from repro_torch.serving.slots import Request  # noqa: E402
from repro_torch.serving.speculative import validate_draft  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402

ARCH = "jamba-v0.1-52b"
TOL = 1e-4
MAX_LEN, CALIB = 48, 400
# the two reduced stacks: the default (mamba, attn) pair and a 3-layer one
# whose second Mamba1 layer carries the MoE
STACKS = {"reduced": None, "mamba-moe": ("mamba", "mamba", "attn")}
MIXED = [(12, 4), (20, 6), (7, 3), (16, 5), (20, 2), (9, 6)]


def _cfgs(stack):
    j = jax_configs.reduced(jax_configs.get_config(ARCH))
    t = configs.reduced(configs.get_config(ARCH))
    pat = STACKS[stack]
    if pat is not None:
        j = dataclasses.replace(j, num_layers=len(pat), layer_pattern=pat)
        t = dataclasses.replace(t, num_layers=len(pat), layer_pattern=pat)
    return j, t


def randomise(tree, seed):
    """A numpy copy of a JAX param tree whose norm scales are 1 + N(0, 0.3)
    and whose Mamba1 constants are moved off the init's values."""
    r = np.random.default_rng(seed)

    def noise(v, s):
        return (s * r.standard_normal(np.shape(v))).astype(np.float32)

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if isinstance(v, (dict, list, tuple)):
                    out[k] = walk(v)
                elif k in ("scale", "dt_norm", "b_norm", "c_norm", "D"):
                    out[k] = 1.0 + noise(v, 0.3)
                elif k in ("conv_b", "A_log"):
                    out[k] = np.asarray(v) + noise(v, 0.1)
                elif k == "dt_proj_b":
                    out[k] = np.asarray(v) + noise(v, 1.0)
                else:
                    out[k] = np.asarray(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return np.asarray(node)
    return walk(tree)


@functools.cache
def _pair(stack):
    jcfg, tcfg = _cfgs(stack)
    tree = randomise(jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg),
                     seed=1)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu"), tree


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _mixer(stack="reduced", layer=0):
    jcfg, jp, tcfg, tp, _ = _pair(stack)
    return jcfg, jax.tree.map(lambda a: a[0], jp["stages"][0][f"l{layer}"]["mixer"]), tcfg, \
        tp.layers[layer].mixer


def test_config_is_a_copy_of_the_jax_config():
    j, t = jax_configs.get_config(ARCH), configs.get_config(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(configs.reduced(t)) == dataclasses.asdict(jax_configs.reduced(j))
    # the card's cut: full width, one whole period of 8 layers, MoE on 1, 3, 5, 7
    cut = dataclasses.replace(t, num_layers=8)
    assert cut.layer_kinds() == ("mamba",) * 4 + ("attn",) + ("mamba",) * 3
    assert [i for i, m in enumerate(cut.mlp_kinds()) if m == "moe"] == [1, 3, 5, 7]
    assert cut.param_count() == dataclasses.replace(j, num_layers=8).param_count()
    assert 13.2e9 < cut.param_count() < 13.4e9


@pytest.mark.parametrize("S,chunk,masked", [(40, 32, False), (40, 32, True), (20, 8, True),
                                            (3, 32, False)])
def test_mamba1_forward_matches_jax(S, chunk, masked):
    """Output, conv state and scan state at S across one or several chunk
    edges (and S below the conv width), with two rows LEFT-padded by
    different widths under a mask."""
    jcfg, jl, tcfg, tl = _mixer()
    jcfg, tcfg = (dataclasses.replace(c, ssm_chunk=chunk) for c in (jcfg, tcfg))
    r = np.random.default_rng(S)
    x = r.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, S), bool)
        mask[0, :S // 3] = False
        mask[1, :S // 2] = False
    out, (conv, h) = tssm.mamba1_forward(tl, torch.from_numpy(x), tcfg,
                                         None if mask is None else torch.from_numpy(mask))
    jo, (jconv, jh) = jax_ssm.mamba1_forward(jl, jnp.asarray(x), jcfg,
                                             None if mask is None else jnp.asarray(mask))
    for t, j in ((out, jo), (conv, jconv), (h, jh)):
        _close(t, j)


def test_mamba1_decode_matches_jax_and_continues_a_prefill():
    """One decode step against random states matches JAX; and prefill of S
    tokens then decode of token S gives a longer prefill's last output and
    states."""
    jcfg, jl, tcfg, tl = _mixer()
    r = np.random.default_rng(1)
    x = r.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    conv = r.standard_normal((3, tcfg.ssm_d_conv - 1, tcfg.d_inner)).astype(np.float32)
    h = r.standard_normal((3, tcfg.d_inner, tcfg.ssm_d_state)).astype(np.float32)
    out, (c2, h2) = tssm.mamba1_decode(tl, torch.from_numpy(x), tcfg, torch.from_numpy(conv),
                                       torch.from_numpy(h))
    jo, (jc2, jh2) = jax_ssm.mamba1_decode(jl, jnp.asarray(x), jcfg, jnp.asarray(conv),
                                           jnp.asarray(h))
    for t, j in ((out, jo), (c2, jc2), (h2, jh2)):
        _close(t, j)
    seq = torch.from_numpy(r.standard_normal((2, 37, tcfg.d_model)).astype(np.float32))
    _, (conv, h) = tssm.mamba1_forward(tl, seq[:, :36], tcfg)
    step, (conv, h) = tssm.mamba1_decode(tl, seq[:, 36:], tcfg, conv, h)
    full, (fconv, fh) = tssm.mamba1_forward(tl, seq, tcfg)
    _close(step[:, 0], full[:, -1].numpy())
    _close(conv, fconv.numpy())
    _close(h, fh.numpy())


def test_chunk_scan_holds_at_jamba_decays():
    """dt ~ 1 against A = -(1..16) over 256-position chunks: the running
    product of decays underflows to 0 in fp32 (a scan that divides by it
    would give inf or nan); the log-depth scan stays finite and matches the
    sequential recurrence in fp64."""
    r = np.random.default_rng(0)
    B, S, di, N = 2, 300, 8, 16
    u = r.standard_normal((B, S, di))
    dt = np.log1p(np.exp(r.standard_normal((B, S, di)) + 0.5))  # softplus, ~1
    Bm, Cm = r.standard_normal((B, S, N)), r.standard_normal((B, S, N))
    A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float64), (di, N))
    assert np.exp(np.cumsum(dt[0, :256, 0]) * A[0, -1]).min() == 0.0
    y, h = tssm.selective_scan(*(torch.from_numpy(a).float() for a in (u, dt, Bm, Cm, A)),
                               chunk=256)
    hs, ys = np.zeros((B, di, N)), []
    for t in range(S):
        hs = np.exp(dt[:, t, :, None] * A) * hs + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None]
        ys.append(np.einsum("bdn,bn->bd", hs, Cm[:, t]))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    _close(y, np.stack(ys, 1))
    _close(h, hs)


def test_params_from_numpy_round_trips_every_leaf():
    """Every leaf of both reduced Jamba trees (Mamba1's projections and
    constants, attention, MoE experts and router, norms) lands in the port
    unchanged, dense weights transposed."""
    for stack in STACKS:
        _, _, tcfg, tp, tree = _pair(stack)

        def walk(node, mod):
            for k, v in node.items():
                dst = getattr(mod, k)
                if isinstance(v, dict):
                    walk(v, dst)
                    continue
                got = dst.weight.T if isinstance(dst, torch.nn.Linear) else dst
                np.testing.assert_array_equal(got.numpy(), np.asarray(v)[0])
        (stage,) = tree["stages"]
        for j, layer in enumerate(tp.layers):
            walk(stage[f"l{j}"], layer)
        kinds = [(lp.kind, lp.mlp_kind) for lp in tp.layers]
        assert kinds == list(zip(tcfg.layer_kinds(), tcfg.mlp_kinds()))
    assert kinds == [("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")]


def test_hybrid_cache_stacks_each_leaf_over_its_own_layers():
    """K/V over the attention layers only, the Mamba1 conv (activation
    dtype) and ssm (fp32) states over the Mamba1 layers only; a write of
    one slot moves every leaf; hybrids take no draft."""
    _, _, tcfg, tp, _ = _pair("mamba-moe")
    cache = ttfm.init_stack_cache(tcfg, 3, 16, torch.bfloat16, enc_len=0)
    assert {n: tuple(c.shape) for n, c in cache.items()} == {
        "k": (1, 3, 16, tcfg.num_kv_heads, tcfg.head_dim),
        "v": (1, 3, 16, tcfg.num_kv_heads, tcfg.head_dim),
        "conv": (2, 3, tcfg.ssm_d_conv - 1, tcfg.d_inner),
        "ssm": (2, 3, tcfg.d_inner, tcfg.ssm_d_state)}
    assert cache["conv"].dtype == torch.bfloat16 and cache["ssm"].dtype == torch.float32
    views = ttfm.layer_caches(tp.layers, cache)
    assert [sorted(v) for v in views] == [["conv", "ssm"], ["conv", "ssm"], ["k", "v"]]
    assert views[1]["ssm"].data_ptr() == cache["ssm"][1].data_ptr()
    w = ModelWorker("m", tcfg, tp, max_len=16)
    pool = w.init_pool(3)
    _, one = w.prefill_one(np.arange(1, 6, dtype=np.int32))
    pool = w.write_slot(pool, one, 2)
    for n in pool:
        assert torch.equal(pool[n][:, 2], one[n][:, 0]) and not pool[n][:, 0].any()
    with pytest.raises(ValueError, match="non-attention"):
        validate_draft(w, tcfg)


@pytest.mark.parametrize("stack", list(STACKS))
def test_prefill_and_ragged_decode_match_jax(stack):
    """Prompts of 5, 27 and 12 tokens prefilled into slot rows, a fourth
    slot parked at max_len; 6 ragged decode steps: logits within 1e-4 each
    step, greedy tokens identical, and every cache leaf of the live slots."""
    jcfg, jp, tcfg, tp, _ = _pair(stack)
    jw, tw = JaxWorker("m", jcfg, jp, max_len=MAX_LEN), ModelWorker("m", tcfg, tp, max_len=MAX_LEN)
    jpool, tpool = jw.init_pool(4), tw.init_pool(4)
    r = np.random.default_rng(6)
    lens = (5, 27, 12)
    for slot, n in enumerate(lens):
        p = r.integers(1, jcfg.vocab_size, n, dtype=np.int32)
        jl, jc = jw.prefill_one(p)
        tl, tc = tw.prefill_one(p)
        _close(tl, jl)
        jpool = jw.write_slots(jpool, jc, np.array([slot], np.int32))
        tpool = tw.write_slots(tpool, tc, np.array([slot], np.int32))
    pos = np.array(list(lens) + [MAX_LEN], np.int32)
    toks = r.integers(1, jcfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(6):
        jn, jl, jpool = jw.decode_pool(jpool, toks, pos)
        tn, tl, tpool = tw.decode_pool(tpool, toks, pos)
        _close(tl[:3], np.asarray(jl)[:3])
        np.testing.assert_array_equal(tn[:3], jn[:3])
        toks = jn[:, None].astype(np.int32)
        pos = np.minimum(pos + 1, MAX_LEN)
    idx = {"attn": 0, "ssm": 0}
    for j, kind in enumerate(tcfg.layer_kinds()):
        fam = "attn" if kind == "attn" else "ssm"
        for n in (("k", "v") if fam == "attn" else ("conv", "ssm")):
            _close(tpool[n][idx[fam], :3], np.asarray(jpool[0][f"l{j}"][n])[0, :3])
        idx[fam] += 1


def _scheduler(cfg, port):
    graph, prof, sim, sched = ((build_transformer_graph, RuntimeEnergyProfiler, DeviceSim,
                                AdaOperScheduler) if port else
                               (jax_graph, JaxProfiler, JaxSim, JaxScheduler))
    p = prof(seed=0)
    p.offline_calibrate([graph(cfg, 4, MAX_LEN)], n_samples=CALIB)
    return sched(p, sim("moderate", seed=0))


@pytest.mark.parametrize("scheduled", [False, True], ids=["fifo", "scheduled"])
@pytest.mark.parametrize("stack", list(STACKS))
def test_engine_matches_jax_engine(stack, scheduled):
    """Mixed prompt lengths and budgets through 4 slots (exact-length
    prefill groups: the stack attends): tokens per uid identical to the JAX
    engine's, and under the scheduler the same admission log and ledger."""
    jcfg, jp, tcfg, tp, _ = _pair(stack)
    sched = (lambda cfg, port: _scheduler(cfg, port)) if scheduled else (lambda *a: None)
    res = []
    for port, cfg, params in ((False, jcfg, jp), (True, tcfg, tp)):
        eng = (ServingEngine(scheduler=sched(cfg, True), max_slots=4) if port else
               JaxEngine(mode="continuous", scheduler=sched(cfg, False), max_slots=4))
        eng.add_model("m", cfg, params, max_len=MAX_LEN)
        r = np.random.default_rng(9)
        make = Request if port else JaxRequest
        for i, (plen, mn) in enumerate(MIXED):
            eng.submit("m", make(i, r.integers(1, cfg.vocab_size, plen, dtype=np.int32), mn))
        res.append(({x.uid: x for x in eng.run_all()}, eng))
    (jres, jeng), (tres, teng) = res
    assert sorted(tres) == sorted(jres) == list(range(len(MIXED)))
    for uid, x in jres.items():
        assert x.error is None and tres[uid].error is None
        np.testing.assert_array_equal(tres[uid].tokens, x.tokens)
    assert teng.prefill_batches == jeng.prefill_batches
    if scheduled:
        assert teng.admission.log == jeng.admission.log
        assert [(e.kind, e.n_active) for e in teng.ledger.events] == \
            [(e.kind, e.n_active) for e in jeng.ledger.events]
        for te, je in zip(teng.ledger.events, jeng.ledger.events):
            np.testing.assert_allclose(te.energy.total_j, je.energy.total_j, rtol=1e-9)


def test_mamba1_load_takes_the_jax_leaf_layout():
    """``convert._load`` fills a lone Mamba1 from ``init_mamba1``'s dict:
    ``conv_w`` and ``A_log`` keep their (d_inner, W) and (d_inner, N)
    layout, ``x_proj`` and ``dt_proj`` are transposed."""
    _, tcfg = _cfgs("reduced")
    jp = jax_ssm.init_mamba1(jax.random.PRNGKey(3), _cfgs("reduced")[0])
    mod = tssm.Mamba1(tcfg).requires_grad_(False)
    with torch.no_grad():
        _load(mod, jax.tree.map(lambda a: np.asarray(a)[None], jp), 0)
    np.testing.assert_array_equal(mod.A_log.numpy(), np.asarray(jp["A_log"]))
    np.testing.assert_array_equal(mod.x_proj.weight.T.numpy(), np.asarray(jp["x_proj"]))
    assert tuple(mod.conv_w.shape) == (tcfg.d_inner, tcfg.ssm_d_conv)
    assert tuple(mod.dt_proj.weight.shape) == (tcfg.d_inner, tssm.dt_rank(tcfg))
