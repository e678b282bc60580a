"""Attention kernels of the PyTorch port: the plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them) over that file's shape sweep, per-row
positions against the JAX ``full_attention``. The CUDA kernels against
their plain versions on the card: tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as jax_att  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402

# fp32: summation order differs between the frameworks; bf16: the
# tolerance tests/test_kernels.py uses for the Pallas kernels
ATOL = {"float32": 3e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, Sq, Sk, H, Hkv, Dk, Dv, dtype="float32"):
    """The same inputs for both frameworks, made with numpy."""
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, Dk), (B, Sk, Hkv, Dk), (B, Sk, Hkv, Dv))]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,Dk,Dv", [
    (2, 128, 128, 4, 2, 64, 64),
    (1, 256, 256, 8, 8, 128, 128),
    (2, 96, 96, 4, 1, 64, 32),    # ragged seq, MQA, Dv != Dk
    (1, 64, 192, 6, 2, 32, 32),   # cross-len
])
def test_flash_plain_matches_pallas_kernel(dtype, B, Sq, Sk, H, Hkv, Dk, Dv):
    (jq, jk, jv), (q, k, v) = _qkv(0, B, Sq, Sk, H, Hkv, Dk, Dv, dtype)
    ref = jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64)
    _close(fmod.flash_attention_plain(q, k, v, causal=True), ref, ATOL[dtype])


@pytest.mark.parametrize("window,softcap", [(None, None), (32, None), (None, 30.0), (48, 50.0)])
def test_flash_plain_window_softcap(window, softcap):
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 128, 128, 4, 2, 64, 64)
    ref = jax_flash(jq, jk, jv, causal=True, window=window, softcap=softcap,
                    block_q=32, block_k=32)
    out = fmod.flash_attention_plain(q, k, v, causal=True, window=window, softcap=softcap)
    _close(out, ref, 3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sk,H,Hkv,D,pos", [
    (2, 512, 8, 2, 64, 400),
    (1, 1024, 16, 8, 128, 1023),
    (2, 300, 4, 4, 64, 128),
])
def test_decode_plain_matches_pallas_kernel(dtype, B, Sk, H, Hkv, D, pos):
    (jq, jk, jv), (q, k, v) = _qkv(2, B, 1, Sk, H, Hkv, D, D, dtype)
    ref = jax_decode(jq, jk, jv, q_offset=pos, kv_len=pos + 1, block_k=128)
    out = dmod.decode_attention_plain(q, k, v, q_offset=pos, kv_len=pos + 1)
    _close(out, ref, ATOL[dtype])


def test_ops_dispatch_decode_and_cpu_wrappers_run_plain():
    """q_len == 1 routes to decode; on CPU tensors the wrappers run the
    plain versions and launch (and count) no kernel."""
    (jq, jk, jv), (q, k, v) = _qkv(3, 1, 1, 256, 4, 2, 64, 64)
    before = (fmod.flash_attention.launches, dmod.decode_attention.launches)
    out = ops.flash_attention(q, k, v, causal=False, q_offset=100, kv_len=101)
    ref = jax.jit(lambda q, k, v: jax_ref.attention_ref(q, k, v, causal=False, q_offset=100,
                                                        kv_len=101))(jq, jk, jv)
    _close(out, ref, 3e-5)
    (jq, jk, jv), (q, k, v) = _qkv(3, 1, 16, 16, 4, 2, 64, 64)
    _close(fmod.flash_attention(q, k, v), jax.jit(jax_ref.attention_ref)(jq, jk, jv), 3e-5)
    assert (fmod.flash_attention.launches, dmod.decode_attention.launches) == before


def test_per_row_positions_match_full_attention():
    """The ragged slot pool's per-row (B,) q_offset / kv_len, held against
    the JAX package's full_attention with the same vectors."""
    pos = np.array([0, 5, 31, 63], np.int32)
    (jq, jk, jv), (q, k, v) = _qkv(4, 4, 1, 64, 8, 2, 64, 64)
    full = jax.jit(jax_att.full_attention, static_argnames=("causal", "window", "softcap"))
    ref = full(jq, jk, jv, causal=False, q_offset=jnp.asarray(pos), kv_len=jnp.asarray(pos + 1),
               softcap=50.0, window=16)
    tpos = torch.from_numpy(pos)
    out = dmod.decode_attention_plain(q, k, v, q_offset=tpos, kv_len=tpos + 1, softcap=50.0,
                                      window=16)
    _close(out, ref, 3e-5)
    # multi-row queries with per-row offsets: causal, every row keeps a key
    off = np.array([0, 7, 20], np.int32)
    (jq, jk, jv), (q, k, v) = _qkv(5, 3, 8, 40, 4, 2, 64, 64)
    ref = full(jq, jk, jv, causal=True, q_offset=jnp.asarray(off), kv_len=jnp.asarray(off + 8))
    out = fmod.flash_attention_plain(q, k, v, causal=True, q_offset=torch.from_numpy(off),
                                     kv_len=torch.from_numpy(off + 8))
    _close(out, ref, 3e-5)


@pytest.mark.parametrize("causal,q_offset,kv_len,window", [
    (True, 0, 0, None),       # no key at all
    (False, 100, 50, 8),      # the window starts past kv_len
])
def test_fully_masked_rows_give_zero_like_the_pallas_kernel(causal, q_offset, kv_len, window):
    (jq, jk, jv), (q, k, v) = _qkv(6, 1, 16, 64, 4, 2, 64, 64)
    ref = jax_flash(jq, jk, jv, causal=causal, q_offset=q_offset, kv_len=kv_len,
                    window=window, block_q=16, block_k=32)
    out = fmod.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                     kv_len=kv_len, window=window)
    _close(out, ref, 3e-5)
    assert float(out.abs().max()) == 0.0


def test_ref_and_full_attention_match_jax():
    (jq, jk, jv), (q, k, v) = _qkv(7, 2, 24, 24, 4, 2, 32, 32)
    kw = dict(causal=True, window=8, softcap=20.0, q_offset=3, kv_len=20)
    want = jax.jit(lambda q, k, v: (jax_ref.attention_ref(q, k, v, **kw),
                                    jax_att.full_attention(q, k, v, **kw)))(jq, jk, jv)
    _close(attention_ref(q, k, v, **kw), want[0], 3e-5)
    _close(tatt.full_attention(q, k, v, **kw), want[1], 3e-5)


def test_cuda_input_checks():
    """What the CUDA wrappers refuse, checked before any launch."""
    _, (q, k, v) = _qkv(8, 1, 4, 4, 4, 2, 64, 64)
    fmod.check_cuda_inputs(q, k, v, fmod.FLASH_DV)
    with pytest.raises(ValueError, match="contiguous"):
        fmod.check_cuda_inputs(q.transpose(1, 2), k, v, fmod.FLASH_DV)
    with pytest.raises(ValueError, match="dtype"):
        fmod.check_cuda_inputs(q.half(), k, v, fmod.FLASH_DV)
    with pytest.raises(ValueError, match="value head dim"):
        fmod.check_cuda_inputs(q, k, v[..., :48].contiguous(), fmod.FLASH_DV)
    with pytest.raises(ValueError, match="kv heads"):
        fmod.check_cuda_inputs(q[:, :, :3].contiguous(), k, v, fmod.FLASH_DV)


def test_flash_route_by_dtype():
    """bf16 goes to the tensor-core kernel and fp32 to the exact CUDA-core
    kernel, by dtype alone; any other dtype has no kernel."""
    assert fmod.flash_route(torch.bfloat16) == "flash_attention_fwd_bf16"
    assert fmod.flash_route(torch.float32) == "flash_attention_fwd_fp32"
    with pytest.raises(ValueError, match="no kernel"):
        fmod.flash_route(torch.float16)
    for dtype, route in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        q, k, v = (t.to(dtype) for t in _qkv(9, 1, 4, 4, 4, 2, 64, 32)[1])
        assert fmod.flash_checks(q, k, v).endswith(route)


@pytest.mark.parametrize("Dk", [8, 72, 100, 272])
def test_bf16_flash_refuses_head_dims_it_does_not_take(Dk):
    """The tensor-core kernel takes Dk a multiple of 16 up to 256; any other
    bf16 Dk raises before a launch (it never goes to the fp32 kernel)."""
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(10, 1, 4, 4, 4, 2, Dk, 64)[1])
    with pytest.raises(ValueError, match="bf16 flash kernel"):
        fmod.flash_checks(q, k, v)
    fmod.flash_checks(q.float(), k.float(), v.float())  # the fp32 route takes them


def test_c_entry_points_match_their_ctypes_signatures():
    """Every C entry point of csrc/*.cu takes as many arguments as
    ``build.ARGTYPES`` passes it (nothing compiles them here)."""
    import re

    from repro_torch.kernels import build
    sigs = {}
    for cu in build.CSRC.glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', cu.read_text()):
            sigs[name] = len(args.split(","))
    assert sigs == {name: len(types) for name, types in build.ARGTYPES.items()}
