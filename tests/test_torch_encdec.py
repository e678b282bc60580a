"""The encoder-decoder path of the port (seamless-m4t-medium) against the
JAX package on the same weights: layernorm and the GELU FFN, the encoder,
prefill with encoder inputs and ragged decode with per-row encoder lengths
on the reduced config, the cross-attention's plain decode against the
Pallas decode kernel (interpret mode), and the continuous engine (FIFO and
AdaOper-scheduled) against the JAX engine and the port's own ``generate``.

Layernorm scales and biases are set to random values on both sides, since
the init's ones and zeros would hide a wrong variance or a missing bias.
fp32 tolerance 1e-4 (the frameworks sum in different orders); the plain
decode against the Pallas kernel 3e-5, as
``tests/test_torch_decode_split.py``. Only live slots are compared: for a
row that keeps no key (a slot never admitted, ``enc_len`` 0) the port
gives 0, as the Pallas kernels do, and the JAX package's
``full_attention`` the mean of v.
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
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.engine import AdaOperScheduler as JaxScheduler  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.opgraph import build_transformer_graph  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import AdaOperScheduler  # noqa: E402
from repro_torch.serving.slots import Request  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402

ARCH = "seamless-m4t-medium"
TOL = 1e-4
KERNEL_TOL = 3e-5
MAX_LEN, MAX_ENC, CALIB = 32, 16, 400


def randomise(tree, seed):
    """A numpy copy of a JAX param tree whose norm scales are 1 + N(0, 0.3)
    and norm biases N(0, 0.3)."""
    r = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias"}:
                return {"scale": (1.0 + 0.3 * r.standard_normal(np.shape(node["scale"])))
                        .astype(np.float32),
                        "bias": (0.3 * r.standard_normal(np.shape(node["bias"])))
                        .astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return np.asarray(node)
    return walk(tree)


@functools.cache
def _pair():
    jcfg = jax_configs.reduced(jax_configs.get_config(ARCH))
    tcfg = configs.reduced(configs.get_config(ARCH))
    tree = randomise(jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg),
                     seed=1)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu"), tree


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _frames(r, n, d):
    return (r.standard_normal((n, d)) * 0.5).astype(np.float32)


def test_config_is_a_copy_of_the_jax_config():
    j, t = jax_configs.get_config(ARCH), configs.get_config(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(configs.reduced(t)) == dataclasses.asdict(jax_configs.reduced(j))
    # the full published config: 12 + 12 layers, d 1024, MHA 16 x 64, 0.98 B params
    assert (t.num_encoder_layers, t.num_layers, t.d_model, t.num_heads, t.num_kv_heads,
            t.head_dim, t.d_ff, t.norm) == (12, 12, 1024, 16, 16, 64, 4096, "layernorm")
    assert t.param_count() == j.param_count()
    assert 0.97e9 < t.param_count() < 0.99e9


def test_layernorm_and_gelu_ffn_match_jax():
    """Population variance with eps 1e-6 in fp32 (torch's default eps is
    1e-5), random scale and bias; the tanh-approximated GELU between ``wi``
    and ``wo``; a bf16 input rounds at the same place."""
    jcfg, jp, tcfg, tp, _ = _pair()
    jl, tl = jax.tree.map(lambda a: a[0], jp["stages"][0]["l0"]), tp.layers[0]
    assert isinstance(tl.pre_norm, tlayers.LayerNorm) and isinstance(tl.mlp, tlayers.FFN)
    assert float(tl.pre_norm.bias.abs().min()) > 0
    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 5, tcfg.d_model)) * 3 + 1).astype(np.float32)
    _close(tlayers.apply_norm(tl.pre_norm, torch.from_numpy(x)),
           jax_layers.apply_norm(jl["pre_norm"], jnp.asarray(x), jcfg))
    xb = torch.from_numpy(x).bfloat16()
    _close(tlayers.apply_norm(tl.pre_norm, xb),
           jax_layers.apply_norm(jl["pre_norm"], jnp.asarray(x).astype(jnp.bfloat16), jcfg), 0)
    _close(tlayers.apply_mlp(tl.mlp, torch.from_numpy(x), tcfg),
           jax_layers.apply_mlp(jl["mlp"], jnp.asarray(x), jcfg))


def test_params_from_numpy_round_trips_every_leaf():
    """Every leaf of the JAX tree (encoder stages and final norm, the
    decoder's cross_norm / cross, layernorm biases, ``wi``/``wo``) lands in
    the port unchanged, dense weights transposed."""
    _, _, tcfg, tp, tree = _pair()

    def walk(node, mod, r):
        for k, v in node.items():
            dst = getattr(mod, k)
            if isinstance(v, dict):
                walk(v, dst, r)
                continue
            got = dst.weight.T if isinstance(dst, torch.nn.Linear) else dst
            np.testing.assert_array_equal(got.numpy(), np.asarray(v)[r])
    for layers, stages in ((tp.layers, tree["stages"]), (tp.encoder.layers,
                                                          tree["encoder"]["stages"])):
        assert len(stages) == 1 and len(layers) == 2
        for r in range(2):
            walk(stages[0]["l0"], layers[r], r)
    for norm, src in ((tp.final_norm, tree["final_norm"]),
                      (tp.encoder.final_norm, tree["encoder"]["final_norm"])):
        for k, v in src.items():
            np.testing.assert_array_equal(getattr(norm, k).numpy(), v)
    assert tp.layers[0].cross is not None and tp.encoder.layers[0].cross is None


def test_encode_and_prefill_match_jax():
    """The encoder over frame embeddings, then prefill with the cross cache
    written at [0, T) of a region preallocated wider; logits at every
    position and every cache leaf."""
    jcfg, jp, tcfg, tp, _ = _pair()
    r = np.random.default_rng(2)
    enc = np.stack([_frames(r, 9, tcfg.d_model) for _ in range(2)])
    toks = r.integers(1, tcfg.vocab_size, (2, 7), dtype=np.int32)
    _close(tmodel.encode(tp, tcfg, torch.from_numpy(enc)),
           jax_model.encode(jp, jcfg, jnp.asarray(enc), jax_model.ExecContext()))
    tc = tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu", enc_len=MAX_ENC)
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks).long(), tc,
                            enc_inputs=torch.from_numpy(enc))
    jl, jc = jax_model.prefill(jp, jcfg, jnp.asarray(toks), jax_model.init_cache(
        jcfg, 2, MAX_LEN, enc_len=MAX_ENC), enc_inputs=jnp.asarray(enc))
    _close(tl, jl)
    for name in ("k", "v", "xk", "xv"):
        _close(tc[name], jc[0]["l0"][name])
    assert not tc["xk"][:, :, 9:].any()  # the region past the frames stays untouched


def test_ragged_decode_with_per_row_enc_len_matches_jax():
    """Three requests of 5, 9 and 16 frames prefilled into slots of a pool
    whose cross region is 16 long, a fourth slot free (parked at max_len,
    enc_len 0); 8 ragged decode steps with per-row ``enc_len``: live rows'
    logits within 1e-4 each step, greedy tokens identical."""
    jcfg, jp, tcfg, tp, _ = _pair()
    jw = JaxWorker("m", jcfg, jp, max_len=MAX_LEN, max_enc_len=MAX_ENC)
    tw = ModelWorker("m", tcfg, tp, max_len=MAX_LEN, max_enc_len=MAX_ENC)
    jpool, tpool = jw.init_pool(4), tw.init_pool(4)
    r = np.random.default_rng(3)
    plens, flens = (6, 10, 3), (5, 9, 16)
    for slot, (n, t) in enumerate(zip(plens, flens)):
        p, e = r.integers(1, tcfg.vocab_size, n, dtype=np.int32), _frames(r, t, tcfg.d_model)
        jl, jc = jw.prefill_one(p, e)
        tl, tc = tw.prefill_one(p, e)
        _close(tl, jl)
        jpool = jw.write_slots(jpool, jc, np.array([slot], np.int32))
        tpool = tw.write_slots(tpool, tc, np.array([slot], np.int32))
    pos = np.array(list(plens) + [MAX_LEN], np.int32)
    enc_len = np.array(list(flens) + [0], np.int32)
    toks = r.integers(1, tcfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(8):
        jn, jl, jpool = jw.decode_pool(jpool, toks, pos, enc_len=enc_len)
        tn, tl, tpool = tw.decode_pool(tpool, toks, pos, enc_len=enc_len)
        _close(tl[:3], np.asarray(jl)[:3])
        np.testing.assert_array_equal(tn[:3], jn[:3])
        toks = jn[:, None].astype(np.int32)
        pos = np.minimum(pos + 1, MAX_LEN)
    for name in ("k", "v", "xk", "xv"):
        _close(tpool[name][:, :3], np.asarray(jpool[0]["l0"][name])[:, :3])


def test_generate_takes_enc_inputs_and_refuses_a_pad_mask():
    """The reference path (an exact-length cross cache, no mask) against
    the JAX worker's, and the refusals of a pad mask and of missing
    frames."""
    jcfg, jp, tcfg, tp, _ = _pair()
    r = np.random.default_rng(4)
    p = r.integers(1, tcfg.vocab_size, (2, 5), dtype=np.int32)
    e = np.stack([_frames(r, 7, tcfg.d_model) for _ in range(2)])
    want = JaxWorker("m", jcfg, jp, max_len=MAX_LEN).generate(p, 6, enc_inputs=e)
    tw = ModelWorker("m", tcfg, tp, max_len=MAX_LEN)
    np.testing.assert_array_equal(tw.generate(p, 6, enc_inputs=e), want)
    with pytest.raises(ValueError, match="pad_mask"):
        tw.prefill_batch(p, e, pad_mask=np.ones_like(p, bool))
    with pytest.raises(ValueError, match="enc_inputs"):
        tw.prefill_batch(p)
    assert tw.max_enc_len == MAX_LEN  # the default region is max_len long


# ---------------------------------------------------------------------------
# the cross-attention's decode against the Pallas decode kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G,Hkv", [(1, 16), (2, 2)])  # the full config's MHA, reduced G = 2
def test_cross_decode_plain_matches_pallas_row_by_row(G, Hkv):
    """One query per slot against a 96-frame cross region, per-row kv_len
    0, 1, 31, 32, 33, 95 and 96 (q_offset 0, no window): the plain decode
    and the kernels' split-and-merge arithmetic against the Pallas kernel
    one row at a time; a row that keeps no key is 0 in both."""
    Smax, D = 96, 64
    enc_len = np.array([0, 1, 31, 32, 33, 95, 96], np.int32)
    B = len(enc_len)
    r = np.random.default_rng(G)
    q = r.standard_normal((B, 1, G * Hkv, D)).astype(np.float32)
    k, v = (r.standard_normal((B, Smax, Hkv, D)).astype(np.float32) for _ in range(2))
    ref = np.concatenate([np.asarray(jax_decode(
        jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]), jnp.asarray(v[b:b + 1]), q_offset=0,
        kv_len=int(enc_len[b]), block_k=32), np.float32) for b in range(B)])
    assert not ref[0].any()
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    kw = dict(q_offset=0, kv_len=torch.from_numpy(enc_len))
    _close(dmod.decode_attention_plain(tq, tk, tv, **kw), ref, KERNEL_TOL)
    _close(dmod.decode_attention_split_plain(tq, tk, tv, **kw), ref, KERNEL_TOL)
    _close(dmod.decode_attention_split_plain(tq, tk, tv, split_len=32, **kw), ref, KERNEL_TOL)
    assert dmod.decode_route(G, D, D) == "decode_attention_fwd"


def test_pallas_decode_refuses_per_row_kv_len():
    """The reference fault the row-by-row comparison works around: the
    Pallas decode kernel reshapes ``kv_len`` to a scalar, so a (B,) encoder
    length with B > 1 raises there (ROADMAP.md, Queue 3)."""
    r = np.random.default_rng(0)
    q = jnp.asarray(r.standard_normal((2, 1, 4, 64)).astype(np.float32))
    k = jnp.asarray(r.standard_normal((2, 32, 2, 64)).astype(np.float32))
    with pytest.raises(TypeError):
        jax_decode(q, k, k, q_offset=0, kv_len=jnp.asarray([5, 9]), block_k=32)


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------


SHAPES = [(6, 9, 4), (10, 5, 3), (6, 9, 2), (8, 7, 5)]  # (prompt, frames, max_new)


def _requests(cfg, port, seed=3):
    """``tests/test_continuous_serving.py``'s ``_encdec_requests``."""
    r = np.random.default_rng(seed)
    make = Request if port else JaxRequest
    return [make(i, r.integers(1, cfg.vocab_size, plen, dtype=np.int32), mn,
                 enc_inputs=r.normal(size=(tlen, cfg.d_model)).astype(np.float32))
            for i, (plen, tlen, mn) in enumerate(SHAPES)]


def _scheduler(cfg, port):
    graph, prof, sim, sched = ((build_transformer_graph, RuntimeEnergyProfiler, DeviceSim,
                                AdaOperScheduler) if port else
                               (jax_graph, JaxProfiler, JaxSim, JaxScheduler))
    p = prof(seed=0)
    p.offline_calibrate([graph(cfg, 4, MAX_LEN)], n_samples=CALIB)
    return sched(p, sim("moderate", seed=0))


@pytest.mark.parametrize("scheduled", [False, True], ids=["fifo", "scheduled"])
def test_engine_matches_jax_engine_and_generate(scheduled):
    """max_slots 3 and max_enc_len 16: tokens per uid identical to the JAX
    engine's (with the same admission log and ledger kinds under the
    scheduler), and to the port's own ``generate`` of each request."""
    jcfg, jp, tcfg, tp, _ = _pair()
    sched = (lambda cfg, port: _scheduler(cfg, port)) if scheduled else (lambda *a: None)
    jeng = JaxEngine(mode="continuous", scheduler=sched(jcfg, False), max_slots=3)
    teng = ServingEngine(scheduler=sched(tcfg, True), max_slots=3)
    jeng.add_model("m", jcfg, jp, max_len=MAX_LEN, max_enc_len=MAX_ENC)
    teng.add_model("m", tcfg, tp, max_len=MAX_LEN, max_enc_len=MAX_ENC)
    treqs = _requests(tcfg, True)
    for req in _requests(jcfg, False):
        jeng.submit("m", req)
    for req in treqs:
        teng.submit("m", req)
    jres = {x.uid: x for x in jeng.run_all()}
    tres = {x.uid: x for x in teng.run_all()}
    assert sorted(tres) == sorted(jres) == list(range(len(SHAPES)))
    assert teng.pools["m"].alloc.n_slots == 3
    ref = ModelWorker("ref", tcfg, tp, max_len=MAX_LEN)
    for req in treqs:
        assert tres[req.uid].error is None and jres[req.uid].error is None
        np.testing.assert_array_equal(tres[req.uid].tokens, jres[req.uid].tokens)
        np.testing.assert_array_equal(
            tres[req.uid].tokens,
            ref.generate(req.prompt[None], req.max_new_tokens, enc_inputs=req.enc_inputs[None])[0])
    if scheduled:
        assert teng.admission.log == jeng.admission.log
        assert [(e.kind, e.n_active) for e in teng.ledger.events] == \
            [(e.kind, e.n_active) for e in jeng.ledger.events]
        for te, je in zip(teng.ledger.events, jeng.ledger.events):
            np.testing.assert_allclose(te.energy.total_j, je.energy.total_j, rtol=1e-9)
        assert teng.prefill_batches == jeng.prefill_batches


@pytest.mark.parametrize("case", ["no enc_inputs", "frames past max_enc_len"])
def test_engine_rejects_what_jax_rejects(case):
    """A request without frames, or with more frames than the cross region
    holds, is rejected with the JAX engine's wording; the next request is
    still served."""
    jcfg, jp, tcfg, tp, _ = _pair()
    errs = []
    for port, (cfg, params) in ((False, (jcfg, jp)), (True, (tcfg, tp))):
        eng = (ServingEngine(max_slots=2) if port else
               JaxEngine(mode="continuous", max_slots=2))
        eng.add_model("m", cfg, params, max_len=MAX_LEN, max_enc_len=8)
        make = Request if port else JaxRequest
        enc = None if case == "no enc_inputs" else np.zeros((9, cfg.d_model), np.float32)
        eng.submit("m", make(0, np.ones(4, np.int32), max_new_tokens=2, enc_inputs=enc))
        eng.submit("m", make(1, np.ones(4, np.int32), max_new_tokens=2,
                             enc_inputs=np.zeros((8, cfg.d_model), np.float32)))
        res = {x.uid: x for x in eng.run_all()}
        assert res[1].error is None and len(res[1].tokens) == 2
        errs.append(res[0].error)
    assert errs[0] == errs[1]
    assert ("without enc_inputs" if case == "no enc_inputs" else "exceeds max_enc_len") in errs[1]


def test_serve_entry_point_gives_encdec_requests_frames():
    """``launch.serve`` on the CPU: every seamless request carries seeded
    (frames, d_model) embeddings drawn from ``enc_lens`` and completes."""
    eng = serve_cli.build_engine(["seamless-m4t-medium"], requests=3, prompt_lens=(4, 6),
                                 max_new=3, max_slots=2, max_len=16, device="cpu",
                                 enc_lens=(5, 11), max_enc_len=12)
    reqs = eng.queues["seamless-m4t-medium"]
    assert {r.enc_inputs.shape for r in reqs} <= {(5, 256), (11, 256)}
    assert eng.workers["seamless-m4t-medium"].max_enc_len == 12
    res = eng.run_all()
    assert len(res) == 3 and all(r.error is None and len(r.tokens) == 3 for r in res)
