"""The absorbed-MLA attention of the port (``kernels/mla_attention.py``)
against the JAX package on the CPU: the plain version at the kernels' shape
(16 query heads on one latent head, Dk 576, Dv 512) at T = 1, 2 and 5 query
positions per row against the Pallas flash kernel in interpret mode, row by
row (the Pallas wrapper takes one scalar ``q_offset``), and at a model
rank's 2 and 1 heads (M = 8, 16) against the Pallas decode and flash
kernels; the dispatch that
sends every MLA shape to ``mla_attention``; ``mla_route``; and the verify
and decode branches of ``mla_decode`` at the kernels' shape against the
JAX package's. fp32 throughout, tolerance 3e-5 for attention alone (the
frameworks sum in different orders), 1e-4 through the layer. The CUDA
kernels against this plain version: tests/test_torch_gpu.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as jax_att  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import _load  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import mla_attention as mmod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402

KERNEL_TOL = 3e-5  # fp32 attention, as tests/test_torch_archs.py
TOL = 1e-4         # through the layer's projections
SCALE = 192 ** -0.5  # deepseek-v2-lite's (qk_nope + qk_rope)^-0.5


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _mla_inputs(seed, B, T, Smax, shared=True):
    """q (B,T,16,576) and a latent cache (B,Smax,1,576) of random rows,
    values its first 512 columns (or a tensor of their own), in numpy."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, T, 16, 576)).astype(np.float32)
    k = r.standard_normal((B, Smax, 1, 576)).astype(np.float32)
    v = k[..., :512].copy() if shared else r.standard_normal((B, Smax, 1, 512)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("T,window,softcap", [(1, None, None), (2, None, None), (5, None, None),
                                              (2, 24, 30.0)])
def test_mla_plain_matches_pallas_flash_row_by_row(T, window, softcap):
    """The verify's shape: T causal query positions per row at per-row
    offsets (the first position, mid-cache, the last T that fit, and one
    whose later positions lie past the cache), against a cache of random
    (stale) latent rows, each row through the Pallas flash kernel alone."""
    B, Smax = 4, 96
    q, k, v = _mla_inputs(T, B, T, Smax)
    offs = np.asarray([0, 40, Smax - T, Smax - 1], np.int32)
    kw = dict(causal=True, window=window, softcap=softcap, scale=SCALE)
    ref = np.concatenate([np.asarray(jax_flash(
        jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]), jnp.asarray(v[b:b + 1]),
        q_offset=int(offs[b]), **kw), np.float32) for b in range(B)])
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    for tv in (tk[..., :512], torch.from_numpy(v)):  # the latent rows' columns, or a copy
        out = mmod.mla_attention_plain(tq, tk, tv, q_offset=torch.from_numpy(offs), **kw)
        _close(out, ref, KERNEL_TOL)
        # on CPU tensors the wrapper runs the plain version and counts no launch
        before = mmod.mla_attention.launches
        _close(mmod.mla_attention(tq, tk, tv, q_offset=torch.from_numpy(offs), **kw), ref,
               KERNEL_TOL)
        assert mmod.mla_attention.launches == before


@pytest.mark.parametrize("Sq", [1, 3])
def test_ops_sends_every_mla_shape_to_mla_attention(Sq, monkeypatch):
    """The MLA shape reaches ``mla_attention`` at one query position (the
    decode step) and at several (the verify); ``plain=True`` its plain
    version; other shapes keep their routes (decode at Sq = 1, flash
    above)."""
    calls = []

    def recorder(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped
    for name in ("mla_attention", "mla_attention_plain", "decode_attention",
                 "decode_attention_plain", "_flash", "flash_attention_plain"):
        monkeypatch.setattr(ops, name, recorder(name, getattr(ops, name)))
    q, k, v = (torch.from_numpy(a) for a in _mla_inputs(0, 2, Sq, 40))
    kw = dict(causal=Sq > 1, q_offset=torch.tensor([3, 30], dtype=torch.int32), scale=SCALE)
    if Sq == 1:
        kw["kv_len"] = kw["q_offset"] + 1
    out = ops.flash_attention(q, k, k[..., :512], **kw)
    assert out.shape == (2, Sq, 16, 512)
    _close(out, mmod.mla_attention_plain(q, k, v, **kw), KERNEL_TOL)
    ops.flash_attention(q, k, v, plain=True, **kw)
    assert calls == ["mla_attention", "mla_attention_plain"]
    calls.clear()
    for Dk, Dv in ((576, 256), (192, 128)):  # not the MLA shape
        q2, k2 = q[..., :Dk].contiguous(), k[..., :Dk].contiguous()
        ops.flash_attention(q2, k2, k2[..., :Dv].contiguous(), **kw)
    assert calls == ["decode_attention" if Sq == 1 else "_flash"] * 2
    # a model rank's 8 or 4 heads on the latent head are MLA shapes too; 6 is not
    assert mmod.is_mla_shape(q, k, v) and not mmod.is_mla_shape(q[:, :, :6], k, v)
    assert all(mmod.is_mla_shape(q[:, :, :g], k, v) for g in mmod.MLA_GROUPS)


@pytest.mark.parametrize("G", [2, 1])
@pytest.mark.parametrize("T", [1, 3])
def test_mla_at_a_ranks_two_and_one_heads_matches_pallas(G, T):
    """A model rank's 2 (M = 8) or 1 (M = 16) of deepseek-v2-lite's 16 heads
    on the latent head: an MLA shape, which ``ops.flash_attention`` sends to
    ``mla_attention`` (the plain version on the CPU, no launch counted); at
    T = 1 (the decode step, per-row positions, the values the latent rows'
    first 512 columns) against the Pallas decode kernel and at T = 3 (the
    verify, causal) against the Pallas flash kernel, both in interpret
    mode, row by row."""
    B, Smax = 4, 80
    r = np.random.default_rng(10 * G + T)
    q = r.standard_normal((B, T, G, 576)).astype(np.float32)
    k = r.standard_normal((B, Smax, 1, 576)).astype(np.float32)
    offs = np.asarray([0, 33, 64, Smax - T], np.int32)
    if T == 1:
        ref = np.concatenate([np.asarray(jax_decode(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]), jnp.asarray(k[b:b + 1, ..., :512]),
            q_offset=int(offs[b]), kv_len=int(offs[b]) + 1, scale=SCALE, block_k=32),
            np.float32) for b in range(B)])
        kw = dict(causal=False, q_offset=torch.from_numpy(offs),
                  kv_len=torch.from_numpy(offs + 1), scale=SCALE)
    else:
        ref = np.concatenate([np.asarray(jax_flash(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]), jnp.asarray(k[b:b + 1, ..., :512]),
            causal=True, q_offset=int(offs[b]), scale=SCALE), np.float32) for b in range(B)])
        kw = dict(causal=True, q_offset=torch.from_numpy(offs), scale=SCALE)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    assert G in mmod.MLA_GROUPS and mmod.is_mla_shape(tq, tk, tk[..., :512])
    _close(mmod.mla_attention_plain(tq, tk, tk[..., :512], **kw), ref, KERNEL_TOL)
    before = mmod.mla_attention.launches
    _close(ops.flash_attention(tq, tk, tk[..., :512], **kw), ref, KERNEL_TOL)
    assert mmod.mla_attention.launches == before
    assert mmod.mla_checks(tq, tk, tk[..., :512]) == ("mla_attention_fwd_fp32", True)


def test_mla_route_by_dtype():
    """bf16 goes to the tensor-core kernel and fp32 to the exact CUDA-core
    kernel, by dtype alone; any other dtype has no kernel."""
    assert mmod.mla_route(torch.bfloat16) == "mla_attention_fwd_bf16"
    assert mmod.mla_route(torch.float32) == "mla_attention_fwd_fp32"
    with pytest.raises(ValueError, match="no kernel"):
        mmod.mla_route(torch.float16)
    q, k, v = (torch.from_numpy(a) for a in _mla_inputs(1, 2, 2, 32, shared=False))
    for dtype, route in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        tq, tk, tv = (t.to(dtype) for t in (q, k, v))
        assert mmod.mla_checks(tq, tk, tk[..., :512]) == (f"mla_attention_fwd_{route}", True)
        assert mmod.mla_checks(tq, tk, tv) == (f"mla_attention_fwd_{route}", False)


def test_mla_checks_refuse_what_the_kernels_do_not_take():
    """Checked before any launch: group sizes outside ``MLA_GROUPS`` (6
    here) and other widths, mixed or other dtypes, non-contiguous q, a
    value tensor that is neither contiguous nor the latent rows' leading
    columns, mismatched batches."""
    q, k, v = (torch.from_numpy(a) for a in _mla_inputs(2, 2, 3, 32, shared=False))
    bad = [(q[:, :, :6].contiguous(), k, v, "take"),
           (q[..., :512].contiguous(), k[..., :512].contiguous(), v, "take"),
           (q, k, v[..., :256].contiguous(), "take"),
           (q.half(), k.half(), v.half(), "no kernel"),
           (q, k, v.bfloat16(), "dtype"),
           (q.transpose(1, 2).contiguous().transpose(1, 2), k, v, "contiguous"),
           (q, k, k[..., 64:], "contiguous"),
           (q[:1], k, v, "mismatch")]
    for tq, tk, tv, match in bad:
        with pytest.raises(ValueError, match=match):
            mmod.mla_checks(tq, tk, tv)


def _mla_layer_at_kernel_shape(seed=0):
    """One MLA layer of deepseek-v2-lite at the kernels' attention shape
    (16 heads, kv_lora_rank 512, qk_rope 64; narrow nope, value and model
    widths), its JAX config and params and the port's, a random kv_norm."""
    widths = dict(num_heads=16, num_kv_heads=16, kv_lora_rank=512, qk_rope_dim=64,
                  qk_nope_dim=16, v_head_dim=16, head_dim=80, d_model=128)
    jcfg = dataclasses.replace(jax_configs.reduced(jax_configs.get_config("deepseek-v2-lite-16b")),
                               **widths)
    tcfg = dataclasses.replace(configs.reduced(configs.get_config("deepseek-v2-lite-16b")),
                               **widths)
    jl = jax.tree.map(np.asarray, jax_att.init_mla(jax.random.PRNGKey(seed), jcfg))
    jl["kv_norm"] = (1.0 + 0.3 * np.random.default_rng(seed).standard_normal(
        jl["kv_norm"].shape)).astype(np.float32)
    tl = tatt.MLA(tcfg).requires_grad_(False)
    _load(tl, jax.tree.map(lambda a: a[None], jl), 0)
    return jcfg, jax.tree.map(jnp.asarray, jl), tcfg, tl


@pytest.mark.parametrize("branch", ["verify", "ragged"])
def test_mla_decode_at_kernel_shape_matches_jax(branch, monkeypatch):
    """``mla_decode``'s T = 3 verify (rows at 0, 7, Smax - 3, Smax - 2 and
    Smax: positions past the cache drop their writes and keep the whole
    cache) and its ragged T = 1 step (a slot parked at Smax) at the kernels'
    shape, where the port's dispatch reaches ``mla_attention`` once per
    call, against the JAX package's ``mla_decode`` on the same latent cache
    of random (stale) rows."""
    jcfg, jl, tcfg, tl = _mla_layer_at_kernel_shape()
    lr, B, Smax = tcfg.kv_lora_rank, 5, 40
    r = np.random.default_rng(5)
    ckv = r.standard_normal((B, Smax, lr)).astype(np.float32)
    krope = r.standard_normal((B, Smax, tcfg.qk_rope_dim)).astype(np.float32)
    T, pos = {"verify": (3, [0, 7, Smax - 3, Smax - 2, Smax]),
              "ragged": (1, [3, 20, 31, Smax - 1, Smax])}[branch]
    pos = np.asarray(pos, np.int32)
    x = r.standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    calls = []
    mla = ops.mla_attention
    monkeypatch.setattr(ops, "mla_attention", lambda *a, **kw: calls.append(a[0].shape) or
                        mla(*a, **kw))
    latent = torch.from_numpy(np.concatenate([ckv, krope], -1))
    out, _ = tatt.mla_decode(tl, torch.from_numpy(x), tcfg, latent, torch.from_numpy(pos))
    assert calls == [(B, T, 16, 576)]
    jo, (jc, jr) = jax_att.mla_decode(jl, jnp.asarray(x), jcfg, jnp.asarray(ckv),
                                      jnp.asarray(krope), jnp.asarray(pos))
    _close(out, jo, TOL)
    _close(latent[..., :lr], jc, TOL)
    _close(latent[..., lr:], jr, TOL)
    np.testing.assert_array_equal(latent[4, :, :lr].numpy(), ckv[4])  # the parked row
    # the decode and split routes at this shape: none (the MLA kernels take it)
    with pytest.raises(ValueError):
        dmod.decode_route(16, 576, 512)
    with pytest.raises(ValueError):
        fmod.flash_checks(torch.zeros(1, 2, 16, 576), torch.zeros(1, 8, 1, 576),
                          torch.zeros(1, 8, 1, 512))
