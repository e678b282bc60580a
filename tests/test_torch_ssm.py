"""Mamba2 in the PyTorch port against the JAX package: the SSD scan's plain
version against the Pallas kernel (interpret mode on the CPU, as
tests/test_ssm_padding.py runs it), ``ssd_chunked`` and ``ssd_ref``; then
reduced mamba2-2.7b on converted weights (prefill logits and state, masked
bucketed prefill against exact length, 8 decode steps). The CUDA kernel
against its plain version on the card: tests/test_torch_gpu.py.

Tolerances: fp32 2e-3 against the sequential recurrence and the chunked
forms, as tests/test_kernels.py holds the Pallas kernel (the chunked forms
sum in another order); bf16 3e-2 (inputs rounded to bf16 on both sides,
outputs rounded once more); model logits 1e-4 as the attention models."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.kernels.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ssd_scan as smod  # noqa: E402
from repro_torch.kernels.ref import ssd_ref  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 3e-2}
MODEL_TOL = 1e-4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, S, H, P, N):
    """Scan inputs as the model makes them: dt = softplus(.) > 0, per-head
    A < 0, dA = dt * A (numpy, shared by both frameworks)."""
    r = np.random.default_rng(seed)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)) - 2.0)).astype(np.float32)
    A = -np.exp(np.linspace(0.0, np.log(16.0), H)).astype(np.float32)
    return dict(x=r.standard_normal((B, S, H, P)).astype(np.float32),
                dA=(dt * A).astype(np.float32), dt=dt,
                Bm=r.standard_normal((B, S, N)).astype(np.float32),
                Cm=r.standard_normal((B, S, N)).astype(np.float32))


def _pair(arrs, dtype):
    """(jax args, torch args): x, Bm, Cm in ``dtype``; dA, dt fp32."""
    cast = ("x", "Bm", "Cm")
    j = [jnp.asarray(arrs[k], JDT[dtype] if k in cast else jnp.float32)
         for k in ("x", "dA", "dt", "Bm", "Cm")]
    t = [torch.from_numpy(arrs[k]).to(TDT[dtype] if k in cast else torch.float32)
         for k in ("x", "dA", "dt", "Bm", "Cm")]
    return j, t


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 2, 16, 128, 32),   # N = 128 (mamba2-2.7b's state), two full chunks
    (1, 40, 3, 32, 16, 16),    # tail chunk (40 = 2 x 16 + 8)
    (2, 11, 2, 8, 16, 32),     # S < chunk: one chunk of S
])
def test_ssd_plain_matches_pallas_kernel(dtype, B, S, H, P, N, chunk):
    arrs = _inputs(0, B, S, H, P, N)
    j, t = _pair(arrs, dtype)
    jy, jh = jax_ssd_scan(*j, chunk=chunk, interpret=True)
    ty, th = smod.ssd_scan_plain(*t, chunk=chunk)
    assert ty.dtype == TDT[dtype] and th.dtype == torch.float32
    _close(ty, jy, TOL[dtype])
    _close(th, jh, TOL[dtype])


@pytest.mark.parametrize("S,chunk", [(40, 16), (24, 32)])
def test_ssd_plain_masked_matches_pallas_kernel(S, chunk):
    """``mask=``: left pads of different widths per row; masked positions
    neither write into nor decay the state."""
    arrs = _inputs(1, 2, S, 2, 16, 32)
    mask = np.ones((2, S), bool)
    mask[0, :S // 3] = False
    mask[1, :5] = False
    j, t = _pair(arrs, "float32")
    jy, jh = jax_ssd_scan(*j, mask=jnp.asarray(mask), chunk=chunk, interpret=True)
    ty, th = smod.ssd_scan_plain(*t, mask=torch.from_numpy(mask), chunk=chunk)
    _close(ty, jy, TOL["float32"])
    _close(th, jh, TOL["float32"])
    # the final state equals the scan over the valid suffix alone
    for b, pad in ((0, S // 3), (1, 5)):
        _, hb = smod.ssd_scan_plain(*(a[b:b + 1, pad:] for a in t), chunk=chunk)
        _close(th[b:b + 1], hb.numpy(), TOL["float32"])


@pytest.mark.parametrize("S,chunk", [(64, 32), (40, 16)])
def test_ssd_plain_matches_chunked_and_ref(S, chunk):
    arrs = _inputs(2, 2, S, 3, 16, 128)
    j, t = _pair(arrs, "float32")
    ty, th = smod.ssd_scan_plain(*t, chunk=chunk)
    cy, ch = jax_ssd_chunked(*j, chunk)
    ry, rh = jax_ssd_ref(*j)
    _close(ty, cy, TOL["float32"])
    _close(th, ch, TOL["float32"])
    _close(ty, ry, TOL["float32"])
    _close(th, rh, TOL["float32"])
    py, ph = ssd_ref(*t)  # the port's own sequential definition
    _close(py, ry, TOL["float32"])
    _close(ph, rh, TOL["float32"])


def test_ssd_wrapper_runs_plain_on_cpu_and_checks_cuda_inputs():
    arrs = _inputs(3, 1, 20, 2, 16, 16)
    _, t = _pair(arrs, "float32")
    before = smod.ssd_scan.launches
    y, h = smod.ssd_scan(*t, chunk=8)
    py, ph = smod.ssd_scan_plain(*t, chunk=8)
    assert torch.equal(y, py) and torch.equal(h, ph)
    assert smod.ssd_scan.launches == before  # the CPU path launches nothing
    x, dA, dt, Bm, Cm = t
    with pytest.raises(ValueError, match="contiguous"):  # a (B,N,S) buffer viewed as (B,S,N)
        smod.check_cuda_inputs(x, dA, dt, Bm, Cm.transpose(1, 2).contiguous().transpose(1, 2), 8)
    with pytest.raises(ValueError, match="float32"):
        smod.check_cuda_inputs(x, dA.double(), dt, Bm, Cm, 8)
    with pytest.raises(ValueError, match="dtype"):
        smod.check_cuda_inputs(x, dA, dt, Bm.bfloat16(), Cm, 8)
    with pytest.raises(ValueError, match="the kernel takes"):  # P 80 > 64
        smod.check_cuda_inputs(x.repeat(1, 1, 1, 5), dA, dt, Bm, Cm, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        smod.check_cuda_inputs(x, dA[:, :5], dt, Bm, Cm, 8)


# ---------------------------------------------------------------------------
# reduced mamba2-2.7b on converted weights
# ---------------------------------------------------------------------------


@functools.cache
def _model():
    jcfg = jax_configs.reduced(jax_configs.get_config("mamba2-2.7b"))
    tcfg = configs.reduced(configs.get_config("mamba2-2.7b"))
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def test_mamba2_config_and_layout():
    jcfg, jp, tcfg, tp = _model()
    assert (tcfg.d_inner, tcfg.ssm_num_heads) == (jcfg.d_inner, jcfg.ssm_num_heads)
    full = configs.get_config("mamba2-2.7b")
    assert (full.num_layers, full.d_model, full.d_inner, full.ssm_num_heads,
            full.ssm_head_dim, full.ssm_d_state, full.ssm_d_conv, full.ssm_chunk,
            full.vocab_size, full.tie_embeddings) == (64, 2560, 5120, 80, 64, 128, 4, 256,
                                                      50280, True)
    assert [lyr.kind for lyr in tp.layers] == ["ssd"] * tcfg.num_layers
    assert tp.lm_head is None
    cache = tmodel.init_cache(tcfg, 3, 32, device="cpu")
    W1, conv_dim = tcfg.ssm_d_conv - 1, tcfg.d_inner + 2 * tcfg.ssm_d_state
    assert cache["conv"].shape == (tcfg.num_layers, 3, W1, conv_dim)
    assert cache["conv"].dtype == torch.float32  # the reduced config's activation dtype
    assert cache["ssm"].shape == (tcfg.num_layers, 3, tcfg.ssm_num_heads, tcfg.ssm_head_dim,
                                  tcfg.ssm_d_state)
    jmix = jax.tree.map(lambda a: np.asarray(a)[1], jp["stages"][0]["l0"]["mixer"])
    np.testing.assert_array_equal(tp.layers[1].mixer.in_proj.weight.numpy(), jmix["in_proj"].T)
    np.testing.assert_array_equal(tp.layers[1].mixer.A_log.numpy(), jmix["A_log"])


def test_mamba2_prefill_and_greedy_decode_match_jax():
    """Prefill logits at every position and the (conv, ssm) state, then 8
    greedy decode steps: logits within 1e-4 and identical tokens. S = 40
    spans a tail chunk of the reduced chunk (32)."""
    jcfg, jp, tcfg, tp = _model()
    B, S, max_len = 2, 40, 64
    prompts = np.random.default_rng(1).integers(1, jcfg.vocab_size, (B, S), dtype=np.int32)
    jprefill = jax.jit(lambda p, t, c: jax_model.prefill(p, jcfg, t, c))
    jdecode = jax.jit(lambda p, t, c, i: jax_model.decode_step(p, jcfg, t, c, i))
    jl, jc = jprefill(jp, jnp.asarray(prompts), jax_model.init_cache(jcfg, B, max_len))
    tc = tmodel.init_cache(tcfg, B, max_len, device="cpu")
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(prompts).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[0]["l0"][name]),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
    jtok = np.argmax(np.asarray(jl)[:, -1], -1)
    ttok = tl[:, -1].argmax(-1).numpy()
    for i in range(8):
        np.testing.assert_array_equal(ttok, jtok)
        jl, jc = jdecode(jp, jnp.asarray(jtok[:, None], jnp.int32), jc, jnp.int32(S + i))
        tl, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(ttok[:, None]).long(), tc, S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)
        jtok, ttok = np.argmax(np.asarray(jl)[:, -1], -1), tl[:, -1].argmax(-1).numpy()


def test_mamba2_masked_bucket_prefill_matches_exact_and_jax():
    """A 13- and a 16-token prompt LEFT-padded into one 16-long masked
    prefill: each row's last logits and state equal its exact-length
    prefill, and the batch equals the JAX worker's masked prefill."""
    jcfg, jp, tcfg, tp = _model()
    r = np.random.default_rng(4)
    lens = (13, 16)
    prompts = [r.integers(1, jcfg.vocab_size, n, dtype=np.int32) for n in lens]
    padded = np.zeros((2, 16), np.int32)
    mask = np.zeros((2, 16), bool)
    for i, p in enumerate(prompts):
        padded[i, 16 - len(p):] = p
        mask[i, 16 - len(p):] = True
    tw, jw = ModelWorker("m", tcfg, tp, max_len=32), JaxWorker("m", jcfg, jp, max_len=32)
    tl, tc = tw.prefill_batch(padded, pad_mask=mask)
    jl, jc = jw.prefill_batch(padded, pad_mask=mask)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc[0]["l0"]["ssm"]),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for i, p in enumerate(prompts):
        el, ec = tw.prefill_one(p)
        np.testing.assert_allclose(tl[i:i + 1].numpy(), el.numpy(), atol=1e-5, rtol=1e-5)
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(tc[name][:, i:i + 1].numpy(), ec[name].numpy(),
                                       atol=1e-5, rtol=1e-5)


def test_ragged_decode_pool_matches_jax_for_mamba2():
    jcfg, jp, tcfg, tp = _model()
    max_len, lens = 48, (5, 33, 12)
    jw, tw = JaxWorker("m", jcfg, jp, max_len=max_len), ModelWorker("m", tcfg, tp, max_len=max_len)
    jpool, tpool = jw.init_pool(4), tw.init_pool(4)
    r = np.random.default_rng(2)
    for slot, n in enumerate(lens):
        p = r.integers(1, jcfg.vocab_size, n, dtype=np.int32)
        jpool = jw.write_slots(jpool, jw.prefill_one(p)[1], np.array([slot], np.int32))
        tpool = tw.write_slots(tpool, tw.prefill_one(p)[1], np.array([slot], np.int32))
    pos = np.array(list(lens) + [max_len], np.int32)
    toks = r.integers(1, jcfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(4):
        jn, jl, jpool = jw.decode_pool(jpool, toks, pos)
        tn, tl, tpool = tw.decode_pool(tpool, toks, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)
        np.testing.assert_array_equal(tn, jn)
        toks = jn[:, None].astype(np.int32)
        pos = np.minimum(pos + 1, max_len)


def test_mamba2_plain_impl_and_attention_reject_pad_mask():
    """``impl="plain"`` takes the scan's plain version on any device (the
    card's parity phase compares it with the kernel); attention stacks
    refuse a pad mask."""
    jcfg, jp, tcfg, tp = _model()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 20, tcfg.d_model))
                         .astype(np.float32))
    mix = tp.layers[0].mixer
    a = ssm.mamba2_forward(mix, x, tcfg)
    b = ssm.mamba2_forward(mix, x, tcfg, impl="plain")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][1], b[1][1])
    cfg = dataclasses.replace(configs.reduced(configs.get_config("tinyllama-1.1b")),
                              num_layers=1)
    p = tmodel.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="pure-SSM"):
        tmodel.prefill(p, cfg, torch.ones(1, 8, dtype=torch.long),
                       tmodel.init_cache(cfg, 1, 16, device="cpu"),
                       pad_mask=torch.ones(1, 8, dtype=torch.bool))


def test_init_params_for_mamba2():
    cfg = configs.reduced(configs.get_config("mamba2-2.7b"))
    a = tmodel.init_params(cfg, seed=0, device="cpu")
    mix = a.layers[0].mixer
    H = cfg.ssm_num_heads
    np.testing.assert_allclose((-torch.exp(mix.A_log)).numpy(), -np.linspace(1, 16, H),
                               rtol=1e-6)
    assert float(mix.conv_b.abs().max()) == 0.0 and float(mix.D.min()) == 1.0
    np.testing.assert_allclose(torch.nn.functional.softplus(mix.dt_bias).numpy(), 0.01,
                               rtol=1e-5)
    assert abs(float(mix.conv_w.std()) - 0.1) < 0.01
    assert abs(float(mix.in_proj.weight.std()) - cfg.d_model ** -0.5) < 0.003
    assert float(mix.norm.min()) == 1.0 and a.lm_head is None
