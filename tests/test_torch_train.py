"""The port's training path against the JAX package on the CPU: the
synthetic data, the optimizer, the loss and its gradients for six reduced
configs, the differentiable attention and scans, the train loop, remat,
checkpoints, the entry point and the refusals.

Reduced fp32 configs with JAX's weights carried over by ``convert``; inputs
from numpy seeds. fp32 tolerances: loss 1e-5 relative, each gradient leaf
1e-4 of its largest magnitude (the frameworks sum their matmuls in
different orders).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.models import attention as jax_att  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.train_loop import train_loop as jax_train_loop  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import named_arrays, params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import mla_attention as mmod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as smod  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.training.train_loop import batch_to_device, make_train_step, train_loop  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REMAT_POLICIES = ["full", "dots", "none"]
ARCHS = ["tinyllama-1.1b", "gemma2-2b", "deepseek-v2-lite-16b", "mamba2-2.7b",
         "jamba-v0.1-52b", "seamless-m4t-medium"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# batches cross the reduced configs' 32-position SSM chunk and sliding window
DATA = dict(batch=2, seq_len=40, seed=1, enc_frames=12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the test files run in parallel
    worker processes, where torch's default of a thread per core
    oversubscribes the CPU (a reduced train step then runs ten times
    slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _jax_pair(arch):
    """The reduced JAX config and params, and the port's config (shared;
    tests build their own port models)."""
    jcfg = jax_configs.reduced(jax_configs.get_config(arch))
    tcfg = configs.reduced(configs.get_config(arch))
    jparams = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg


def _port_params(arch):
    jcfg, jparams, tcfg = _jax_pair(arch)
    return params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (11, 2)])
def test_synthetic_batches_equal_jax(seed, step):
    jcfg, _, tcfg = _jax_pair("tinyllama-1.1b")
    j = jax_data.SyntheticLM(jcfg, jax_data.DataConfig(batch=3, seq_len=17, seed=seed)).batch(step)
    t = SyntheticLM(tcfg, DataConfig(batch=3, seq_len=17, seed=seed)).batch(step)
    assert sorted(t) == sorted(j) == ["labels", "tokens"]
    for k in j:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])


def test_synthetic_enc_dec_batches_equal_jax():
    jcfg, _, tcfg = _jax_pair("seamless-m4t-medium")
    j = jax_data.SyntheticLM(jcfg, jax_data.DataConfig(**DATA)).batches(2)
    t = SyntheticLM(tcfg, DataConfig(**DATA)).batches(2)
    for jb, tb in zip(j, t):
        assert tb["enc_inputs"].shape == (2, 12, tcfg.d_model)
        for k in ("tokens", "labels", "enc_inputs"):
            np.testing.assert_array_equal(tb[k], jb[k])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_jax():
    for oc in (topt.OptConfig(lr=1e-3, warmup_steps=8, total_steps=40),
               topt.OptConfig(lr=3e-4, warmup_steps=0, total_steps=10),
               topt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)):
        joc = jax_opt.OptConfig(**dataclasses.asdict(oc))
        for step in (0, 1, 5, oc.warmup_steps, oc.warmup_steps + 3, oc.total_steps - 1,
                     oc.total_steps + 5):
            assert _rel(topt.schedule(oc, step), jax_opt.schedule(joc, step)) <= 1e-6


def _tree(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


def _opt_inputs(dtype, steps, grad_scale, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 48), "b": (300,), "c": (7, 5, 9), "d": (1000, 8)}
    return shapes, _tree(rng, shapes), [_tree(rng, shapes, grad_scale) for _ in range(steps)]


@pytest.mark.parametrize("dtype,grad_scale", [("float32", 1.0), ("float32", 1e-3),
                                              ("bfloat16", 1e-3), ("bfloat16", 1.0)])
def test_adamw_update_matches_jax(dtype, grad_scale):
    """Three steps on a random tree, the gradients clipped (grad_scale 1)
    or not. fp32: params and moments within 1e-6 of the leaf's scale.
    bf16 storage: within one bf16 ulp per step taken (or 1e-6 of the
    leaf's scale), and fewer than 1% of the values apart. XLA on the CPU
    contracts ``b1 * m + (1 - b1) * g`` into a fused multiply-add, which
    the port (one rounding per operation, as the reference's formula
    reads) does not; with bf16 inputs that sum often lands exactly on a
    bf16 rounding tie, which the fused result misses by an fp32 ulp, so
    the two round it to neighbouring bf16 values, and the moment carries
    that difference into the next step.
    ``test_adamw_update_rounds_as_the_formula`` holds the port to the
    formula bit for bit."""
    shapes, p0, grads = _opt_inputs(dtype, 3, grad_scale)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    # a copy: the update is in place, and JAX's CPU arrays may share p0's memory
    tp = {k: torch.from_numpy(v).to(tdt, copy=True) for k, v in p0.items()}
    oc = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    joc = jax_opt.OptConfig(**dataclasses.asdict(oc))
    js, ts = jax_opt.init_opt_state(jp), topt.init_opt_state(tp)
    upd = jax.jit(lambda p, g, s: jax_opt.adamw_update(p, g, s, joc))
    for step, g in enumerate(grads):
        jp, js, jm = upd(jp, {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}, js)
        tm = topt.adamw_update(tp, {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, ts, oc)
        assert ts["step"] == int(js["step"]) == step + 1
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert (float(tm["grad_norm"]) > oc.clip_norm) == (grad_scale == 1.0)
        for name, (jt, tt) in {"p": (jp, tp), "m": (js["m"], ts["m"]),
                               "v": (js["v"], ts["v"])}.items():
            for k in shapes:
                assert tt[k].dtype == tdt
                want = np.asarray(jt[k].astype(jnp.float32))
                got = tt[k].float().numpy()
                if dtype == "float32":
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-6 * np.abs(want).max(), err_msg=name)
                else:  # (atol: a moment that cancels to near 0 is off by an fp32 ulp)
                    np.testing.assert_allclose(got, want, rtol=(step + 1) * 2.0 ** -7,
                                               atol=1e-6 * np.abs(want).max(), err_msg=name)
                    assert np.mean(got != want) < 0.01, (name, k)


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])
def test_adamw_update_rounds_as_the_formula(grad_scale):
    """bf16 params and moments bit for bit equal to the reference's update
    formula evaluated in numpy fp32, one rounding per operation in its
    order (numpy fuses nothing), at the port's global norm."""
    shapes, p0, grads = _opt_inputs("bfloat16", 3, grad_scale, seed=5)
    oc = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    ts = topt.init_opt_state(tp)
    f32 = np.float32

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    ref = {k: (bf16(v), np.zeros_like(v), np.zeros_like(v)) for k, v in p0.items()}
    for step, g in enumerate(grads, start=1):
        g = {k: bf16(v) for k, v in g.items()}
        tm = topt.adamw_update(tp, {k: torch.from_numpy(v).to(torch.bfloat16)
                                    for k, v in g.items()}, ts, oc)
        gn = f32(float(tm["grad_norm"]))
        scale = min(f32(1.0), f32(oc.clip_norm) / max(gn, f32(1e-9)))
        lr = f32(topt.schedule(oc, step))
        bc1, bc2 = f32(1) - f32(oc.b1) ** f32(step), f32(1) - f32(oc.b2) ** f32(step)
        for k, (p, m, v) in ref.items():
            gk = g[k] * scale
            m_new = f32(oc.b1) * m + f32(1 - oc.b1) * gk
            v_new = f32(oc.b2) * v + f32(1 - oc.b2) * gk * gk
            delta = lr * ((m_new / bc1) / (np.sqrt(v_new / bc2) + f32(oc.eps))
                          + f32(oc.weight_decay) * p)
            ref[k] = (bf16(p - delta), bf16(m_new), bf16(v_new))
            for got, want in zip((tp[k], ts["m"][k], ts["v"][k]), ref[k]):
                np.testing.assert_array_equal(got.float().numpy(), want, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_in_pieces_is_the_whole_update(monkeypatch, dtype):
    """Every leaf is updated ``optimizer.PIECE`` elements at a time (its
    fp32 temporaries stay small); the arithmetic is elementwise, so three
    steps in pieces of 100 elements give the params and moments of three
    steps in one piece a leaf bit for bit, each piece boundary falling
    inside a row of the (1000, 8) and (64, 48) leaves."""
    shapes, p0, grads = _opt_inputs(dtype, 3, 1.0, seed=3)
    oc = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tdt = getattr(torch, dtype)
    runs = []
    for piece in (topt.PIECE, 100):
        monkeypatch.setattr(topt, "PIECE", piece)
        tp = {k: torch.from_numpy(v).to(tdt, copy=True) for k, v in p0.items()}
        ts = topt.init_opt_state(tp)
        for g in grads:
            topt.adamw_update(tp, {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, ts, oc)
        runs.append((tp, ts))
    (wp, ws), (gp, gs) = runs
    for k in shapes:
        for want, got in ((wp[k], gp[k]), (ws["m"][k], gs["m"][k]), (ws["v"][k], gs["v"][k])):
            assert torch.equal(got, want), k


def test_grad_clip_reports_the_raw_norm():
    params = {"w": torch.ones(4, 4)}
    st = topt.init_opt_state(params)
    m = topt.adamw_update(params, {"w": torch.full((4, 4), 100.0)}, st,
                          topt.OptConfig(clip_norm=1.0, lr=1.0, weight_decay=0.0))
    assert float(m["grad_norm"]) == pytest.approx(400.0)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


def _jax_batch(arch):
    jcfg = _jax_pair(arch)[0]
    return jax_data.SyntheticLM(jcfg, jax_data.DataConfig(**DATA)).batch(0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch):
    """Reduced tinyllama, gemma2 (softcap, sliding window), deepseek-v2-lite
    (MLA, MoE aux loss, drop-free), mamba2 (``ssd_chunked``), jamba (Mamba1
    with attention and an MoE) and seamless-m4t-medium (encoder-decoder)."""
    jcfg, jparams, tcfg = _jax_pair(arch)
    b = _jax_batch(arch)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jax_model.loss_fn(p, jcfg, bb), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, b))
    params = _port_params(arch)
    named = tmodel.train_params(params)
    loss, met = tmodel.loss_fn(params, tcfg, batch_to_device(b, "cpu"))
    loss.backward()
    assert _rel(loss.detach(), jl) <= LOSS_RTOL
    assert _rel(met["nll"].detach(), jmet["nll"]) <= LOSS_RTOL
    if tcfg.num_experts:
        assert float(met["aux"].detach()) > 0
        assert _rel(met["aux"].detach(), jmet["aux"]) <= LOSS_RTOL
    else:
        assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    want = named_arrays(jax.tree.map(np.asarray, jg), tcfg)
    assert set(want) == set(named)
    for name, p in named.items():
        ref = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(), err_msg=name)


def test_train_mode_launches_no_kernel(monkeypatch):
    """Train mode takes the differentiable route whatever ``ctx.attn_impl``
    says: neither the attention dispatch nor the SSD scan wrapper is
    reached, on any config family."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was reached in train mode")

    monkeypatch.setattr(ops, "flash_attention", boom)
    monkeypatch.setattr(tssm, "ssd_scan", boom)
    monkeypatch.setattr(tssm, "ssd_scan_plain", boom)
    for arch in ("deepseek-v2-lite-16b", "mamba2-2.7b", "seamless-m4t-medium"):
        tcfg = _jax_pair(arch)[2]
        params = _port_params(arch)
        b = batch_to_device(_jax_batch(arch), "cpu")
        for impl in (None, "plain"):
            loss, _ = tmodel.loss_fn(params, tcfg, b, ExecContext(attn_impl=impl))
            assert torch.isfinite(loss)


def test_exec_context_refuses_the_train_route():
    """The train route is chosen by mode: ``attn_impl`` takes the serving
    routes only."""
    with pytest.raises(ValueError, match="attn_impl 'xla'"):
        ExecContext(attn_impl=tatt.TRAIN_IMPL)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=9, softcap=20.0),
                                dict(causal=False, kv_len=np.array([40, 17])),
                                dict(causal=True, q_offset=np.array([3, 30]),
                                     kv_len=np.array([37, 40]))])
def test_chunked_attention_matches_jax(kw):
    """Values and gradients at block 16 (40 keys: two whole blocks and a
    padded one), GQA of 4 query heads on 2 kv heads."""
    rng = np.random.default_rng(0)
    q, k, v, ct = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16), (2, 40, 4, 16)))

    def jfn(q, k, v):
        return jax_att.chunked_attention(q, k, v, block=16, **kw)

    jo, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    to = tatt.chunked_attention(tq, tk, tv, block=16, **tkw)
    to.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)


def test_train_route_switches_to_chunked_past_the_key_limit(monkeypatch):
    """``attend(impl=TRAIN_IMPL)`` is JAX's ``impl="xla"``: full attention
    up to ``_FULL_KV_LIMIT`` keys, chunked above (the limit lowered here on
    both sides, so that 40 keys are past it)."""
    calls = []
    monkeypatch.setattr(tatt, "_FULL_KV_LIMIT", 32)
    monkeypatch.setattr(jax_att, "_FULL_KV_LIMIT", 32)
    real = tatt.chunked_attention
    monkeypatch.setattr(tatt, "chunked_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)))
    jo = jax_att.attend(*map(jnp.asarray, (q, k, v)), causal=True, impl="xla")
    to = tatt.attend(*map(torch.from_numpy, (q, k, v)), causal=True, impl=tatt.TRAIN_IMPL)
    assert calls == [1]
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)


@functools.cache
def _jax_loss_and_grads(arch):
    """JAX's loss and gradients of reduced ``arch`` on the first batch, as
    numpy (traced under whatever the calling test patched)."""
    jcfg, jparams, tcfg = _jax_pair(arch)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jax_model.loss_fn(p, jcfg, bb), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, _jax_batch(arch)))
    return float(jl), named_arrays(jax.tree.map(np.asarray, jg), tcfg)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_loss_fn_past_the_key_limit_matches_jax(monkeypatch, policy):
    """Past ``_FULL_KV_LIMIT`` (lowered to 32 on both sides, so that the 40
    positions are past it) train mode runs ``chunked_attention`` (key
    blocks of 16 on both sides), its checkpointed block body nested in the
    layer's remat under each policy: reduced tinyllama's loss and every
    gradient leaf match JAX's."""
    calls = []
    real = tatt.chunked_attention
    monkeypatch.setattr(tatt, "_FULL_KV_LIMIT", 32)
    monkeypatch.setattr(jax_att, "_FULL_KV_LIMIT", 32)
    monkeypatch.setattr(jax_att, "chunked_attention",
                        functools.partial(jax_att.chunked_attention, block=16))
    monkeypatch.setattr(tatt, "chunked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, block=16, **k))
    arch = "tinyllama-1.1b"
    tcfg = _jax_pair(arch)[2]
    jl, want = _jax_loss_and_grads(arch)
    params = _port_params(arch)
    named = tmodel.train_params(params)
    loss, _ = tmodel.loss_fn(params, tcfg, batch_to_device(_jax_batch(arch), "cpu"),
                             ExecContext(plan={"remat_policy": policy}))
    loss.backward()
    assert calls, "the train route did not reach chunked_attention"
    assert _rel(loss.detach(), jl) <= LOSS_RTOL
    for name, p in named.items():
        ref = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(), err_msg=name)


def _ssd_inputs(rng, dt_shift, B=2, S=40, H=3, P=8, N=4):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) + dt_shift)).astype(np.float32)
    dA = (dt * -np.linspace(1.0, 16.0, H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    cy, ch = (rng.standard_normal(s).astype(np.float32) for s in ((B, S, H, P), (B, H, P, N)))
    return (x, dA, dt, Bm, Cm), (cy, ch)


def _ssd_port_grads(args, cts):
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ty, th = tssm.ssd_chunked(*targs, chunk=16)
    torch.autograd.backward((ty, th), tuple(map(torch.from_numpy, cts)))
    return ty, th, [t.grad for t in targs]


def test_ssd_chunked_matches_jax():
    """Values, final state and gradients of the SSD dual form over 40
    positions in chunks of 16 (a padded tail), at the model's dt (~0.02:
    softplus of the dt bias softplus^-1(0.01) plus a projection)."""
    args, cts = _ssd_inputs(np.random.default_rng(2), -4.0)
    (jy, jh), vjp = jax.vjp(lambda *a: jax_ssm.ssd_chunked(*a, 16), *map(jnp.asarray, args))
    jgrads = vjp(tuple(map(jnp.asarray, cts)))
    ty, th, tgrads = _ssd_port_grads(args, cts)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(j)).max())


def test_ssd_chunked_gradient_stays_finite_at_large_dt():
    """At dt ~ 0.5, exp(cum_i - cum_j) overflows in the decay matrix's
    masked upper triangle; the reference exponentiates those entries and
    its gradient turns NaN, the port exponentiates only the lower triangle
    and its gradient stays finite, its values the reference's."""
    args, cts = _ssd_inputs(np.random.default_rng(2), 0.0)
    (jy, _), vjp = jax.vjp(lambda *a: jax_ssm.ssd_chunked(*a, 16), *map(jnp.asarray, args))
    assert np.isnan(np.asarray(vjp(tuple(map(jnp.asarray, cts)))[1])).any()
    ty, _, tgrads = _ssd_port_grads(args, cts)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    assert all(torch.isfinite(g).all() for g in tgrads)


def test_mamba1_selective_scan_differentiates_as_jax():
    """Autograd runs through the port's Mamba1 scan (a Hillis-Steele scan
    within each chunk, new tensors per level) and gives the gradients of
    JAX's ``_selective_scan_chunked``."""
    rng = np.random.default_rng(3)
    B, S, di, N = 2, 40, 6, 4
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1))
    cy, ch = (rng.standard_normal(s).astype(np.float32) for s in ((B, S, di), (B, di, N)))
    args = (u, dt, Bm, Cm)
    (jy, jh), vjp = jax.vjp(lambda *a: jax_ssm._selective_scan_chunked(*a, jnp.asarray(A), 16),
                            *map(jnp.asarray, args))
    jgrads = vjp((jnp.asarray(cy), jnp.asarray(ch)))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ty, th = tssm.selective_scan(*targs, torch.from_numpy(A), 16)
    torch.autograd.backward((ty, th), (torch.from_numpy(cy), torch.from_numpy(ch)))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    for t, j in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(j)).max())


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------


def test_train_loop_matches_jax():
    """Three steps of reduced tinyllama at lr 1e-3: the history within 1e-5
    relative, the params within 1e-4."""
    jcfg, jparams, tcfg = _jax_pair("tinyllama-1.1b")
    oc = topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    data = dict(batch=2, seq_len=24, seed=4)
    batches = list(jax_data.SyntheticLM(jcfg, jax_data.DataConfig(**data)).batches(3))
    jp, _, jhist = jax_train_loop(jcfg, jax.tree.map(jnp.copy, jparams), batches,
                                  oc=jax_opt.OptConfig(**dataclasses.asdict(oc)), log_every=0)
    params, state, hist = train_loop(tcfg, _port_params("tinyllama-1.1b"),
                                     SyntheticLM(tcfg, DataConfig(**data)).batches(3), oc=oc,
                                     log_every=0)
    assert state["step"] == 3 and len(hist) == 3
    for t, j in zip(hist, jhist):
        assert set(j) <= set(t)
        for k in j:
            assert _rel(t[k], j[k]) <= 1e-5 or abs(t[k] - j[k]) <= 1e-9, k
    want = named_arrays(jax.tree.map(np.asarray, jp), tcfg)
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_loss_decreases_tinyllama():
    """The port's mirror of ``tests/test_training.py``'s."""
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    data = SyntheticLM(cfg, DataConfig(batch=4, seq_len=64, seed=0))
    _, _, hist = train_loop(cfg, tmodel.init_params(cfg, 0, "cpu"), data.batches(40),
                            oc=topt.OptConfig(lr=1e-3, warmup_steps=5, total_steps=40),
                            log_every=0)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.5, (first, last)


def test_loss_decreases_moe():
    cfg = configs.reduced(configs.get_config("deepseek-v2-lite-16b"))
    data = SyntheticLM(cfg, DataConfig(batch=4, seq_len=32, seed=0))
    _, _, hist = train_loop(cfg, tmodel.init_params(cfg, 0, "cpu"), data.batches(30),
                            oc=topt.OptConfig(lr=1e-3, warmup_steps=5, total_steps=30),
                            log_every=0)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3
    assert all(h["aux"] > 0 for h in hist)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b", "gemma2-2b"])
def test_remat_policies_give_the_same_gradients(arch):
    """"full", "dots" and "none" recompute or keep the same activations:
    the loss, the aux loss and every gradient are equal."""
    tcfg = dataclasses.replace(_jax_pair(arch)[2], num_layers=4)
    b = batch_to_device(SyntheticLM(tcfg, DataConfig(batch=2, seq_len=24, seed=0)).batch(0),
                        "cpu")
    out = {}
    for policy in REMAT_POLICIES:
        params = tmodel.init_params(tcfg, 0, "cpu")
        named = tmodel.train_params(params)
        loss, met = tmodel.loss_fn(params, tcfg, b, ExecContext(plan={"remat_policy": policy}))
        loss.backward()
        out[policy] = (float(loss.detach()), float(met["aux"].detach()),
                       {n: p.grad for n, p in named.items()})
    for policy in ("dots", "none"):
        assert out[policy][:2] == out["full"][:2]
        for name, g in out["full"][2].items():
            torch.testing.assert_close(out[policy][2][name], g, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat policy"):
        tmodel.loss_fn(tmodel.init_params(tcfg, 0, "cpu"), tcfg, b,
                       ExecContext(plan={"remat_policy": "some"}))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b"])
def test_remat_dots_saves_no_batched_products(monkeypatch, arch):
    """"dots" saves what the reference's ``dots_with_no_batch_dims_saveable``
    saves: the outputs of the projections, which fold their batch into
    ``aten.mm``/``addmm``, and no batched product, so neither the
    (B, H, S, S) attention scores nor (deepseek) the MoE experts' products
    are kept."""
    decisions, saved = [], []
    real = ttfm._save_dots
    aten = torch.ops.aten
    mm = (aten.mm.default, aten.addmm.default)

    def record(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        if policy == CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        if op in mm + (aten.bmm.default,):  # (..., a, b): the product's operands
            a, b = args[-2].shape, args[-1].shape
            decisions.append((op, a[:-1].numel() * b[-1], policy == CheckpointPolicy.MUST_SAVE))
        return policy

    monkeypatch.setattr(ttfm, "_save_dots", record)
    tcfg = _jax_pair(arch)[2]
    S = 24
    b = batch_to_device(SyntheticLM(tcfg, DataConfig(batch=2, seq_len=S, seed=0)).batch(0),
                        "cpu")
    params = tmodel.init_params(tcfg, 0, "cpu")
    tmodel.train_params(params)
    loss, _ = tmodel.loss_fn(params, tcfg, b, ExecContext(plan={"remat_policy": "dots"}))
    loss.backward()
    bmm = [d for d in decisions if d[0] == aten.bmm.default]
    assert bmm and not any(d[2] for d in bmm)
    assert any(d[1] == 2 * tcfg.num_heads * S * S for d in bmm)  # the scores' product
    assert saved and all(op in mm for op in saved)
    assert all(d[2] for d in decisions if d[0] in mm)


# ---------------------------------------------------------------------------
# checkpoints, the entry point, the refusals
# ---------------------------------------------------------------------------


def _bits(t):
    return t.detach().view(torch.int16) if t.dtype == torch.bfloat16 else t.detach()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, dtype):
    cfg = dataclasses.replace(configs.reduced(configs.get_config("gemma2-2b")), dtype=dtype,
                              param_dtype=dtype)
    params = tmodel.init_params(cfg, 1, "cpu")
    named = tmodel.train_params(params)
    state = topt.init_opt_state(named)
    step = make_train_step(cfg, oc=topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    b = batch_to_device(SyntheticLM(cfg, DataConfig(batch=2, seq_len=16)).batch(0), "cpu")
    step(params, state, b)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params, state, step=state["step"])
    fresh = tmodel.init_params(cfg, 2, "cpu")
    fresh_state = topt.init_opt_state(dict(fresh.named_parameters()))
    assert restore_checkpoint(path, fresh, fresh_state) == 1 == fresh_state["step"]
    got = dict(fresh.named_parameters())
    for name, p in named.items():
        assert got[name].dtype == p.dtype
        assert torch.equal(_bits(got[name]), _bits(p)), name
        for k in ("m", "v"):
            assert torch.equal(_bits(fresh_state[k][name]), _bits(state[k][name])), (k, name)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(path, fresh)  # the checkpoint holds moments too


def test_launch_train_runs_on_cpu_and_writes_its_checkpoint(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt", str(ckpt)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert "loss " in out.stdout and "tokens/s" in out.stdout
    assert sorted(os.listdir(ckpt)) == ["arrays-shard-0.npz", "meta.json"]


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


def test_train_mode_refused_on_a_model_axis():
    """Train mode on a model axis of 2 is ported for every family: the GQA,
    MLA, Mamba2, encoder-decoder and Jamba hybrid stacks
    (tests/test_torch_sharded_train.py,
    tests/test_torch_sharded_train_families.py). Their loss_fn passes the
    mesh check and refuses only params that are not this rank's shard,
    naming ``shard_params``: reduced jamba (Mamba1 layers) too, which
    nothing refuses any more on the mesh."""
    ctx = ExecContext(mesh=_FakeMesh(data=1, model=2), model_axis="model")
    jamba = configs.reduced(configs.get_config("jamba-v0.1-52b"))
    b = batch_to_device(SyntheticLM(jamba, DataConfig(batch=2, seq_len=8)).batch(0), "cpu")
    with pytest.raises(ValueError, match="shard_params"):
        tmodel.loss_fn(tmodel.init_params(jamba, 0, "cpu"), jamba, b, ctx)
    tmodel.check_train_mesh(SimpleNamespace(shard=(2, 0)), ctx)
    for arch in ("tinyllama-1.1b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                 "seamless-m4t-medium"):
        cfg = _jax_pair(arch)[2]
        data = DataConfig(batch=2, seq_len=8, enc_frames=4)
        b = batch_to_device(SyntheticLM(cfg, data).batch(0), "cpu")
        with pytest.raises(ValueError, match="shard_params"):
            tmodel.loss_fn(tmodel.init_params(cfg, 0, "cpu"), cfg, b, ctx)


@pytest.mark.parametrize("wrapper", ["flash", "decode", "mla", "ssd"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(wrapper):
    """Off the CPU, a wrapper refuses inputs that require grad before it
    looks at the device or launches (meta tensors stand in for the card's
    here; ``tests/test_torch_gpu.py`` checks the same on the card), and
    takes them under ``torch.no_grad()``: on meta tensors through its meta
    route (the dry run's), which returns a meta output and counts no
    launch."""
    def t(*shape):
        return torch.zeros(shape, device="meta", requires_grad=True)

    calls = {"flash": lambda: fmod.flash_attention(t(1, 8, 4, 64), t(1, 8, 2, 64),
                                                   t(1, 8, 2, 64)),
             "decode": lambda: dmod.decode_attention(t(1, 1, 4, 64), t(1, 8, 2, 64),
                                                     t(1, 8, 2, 64)),
             "mla": lambda: mmod.mla_attention(t(1, 1, 16, 576), t(1, 8, 1, 576),
                                               t(1, 8, 1, 512)),
             "ssd": lambda: smod.ssd_scan(t(1, 8, 2, 4), t(1, 8, 2), t(1, 8, 2), t(1, 8, 4),
                                          t(1, 8, 4))}
    with pytest.raises(RuntimeError, match="no backward"):
        calls[wrapper]()
    fn = {"flash": fmod.flash_attention, "decode": dmod.decode_attention,
          "mla": mmod.mla_attention, "ssd": smod.ssd_scan}[wrapper]
    before = fn.launches
    with torch.no_grad():
        out = calls[wrapper]()
    assert (out[0] if isinstance(out, tuple) else out).is_meta
    assert fn.launches == before
