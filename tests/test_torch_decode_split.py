"""The split-KV arithmetic of the port's decode kernel, on the CPU.

``decode_attention_split_plain`` computes what ``csrc/decode_attention.cu``
computes: per split of the KV axis an fp32 softmax state (m, l, acc), then
the merge of the splits. It is held here against the JAX package's Pallas
decode kernel (interpret mode, as tests/test_kernels.py runs it, one row at
a time since that kernel takes scalar positions) and against the port's
``decode_attention_plain``, at the split edges the kernel has to get
right. ``plan_splits`` is the host-side planner that sizes the kernel's
grid from the shapes alone.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402

# fp32: summation order differs between the frameworks and between the
# split and unsplit sums (the tolerance of tests/test_torch_kernels.py)
ATOL = 3e-5
SMAX, SPLIT = 200, 32  # 7 splits, the last one cut to 8 keys


def _inputs(seed, B, H, Hkv, D, Smax=SMAX):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((B, 1, H, D), (B, Smax, Hkv, D), (B, Smax, Hkv, D))]


def _jax_rows(q, k, v, pos, kv_len, **kw):
    """The Pallas decode kernel row by row (it takes scalar positions)."""
    rows = [jax_decode(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                       jnp.asarray(v[b:b + 1]), q_offset=int(pos[b]), kv_len=int(kv_len[b]),
                       block_k=64, **kw)
            for b in range(len(pos))]
    return np.concatenate([np.asarray(r, np.float32) for r in rows])


# (name, positions, kv_len - positions - 1, window, softcap)
CASES = [
    ("kv_len 1", [0, 0], 0, None, None),
    ("kv_len on a split boundary and one past it",
     [SPLIT - 1, SPLIT, 2 * SPLIT - 1, 2 * SPLIT], 0, None, None),
    ("kv_len = Smax, Smax not a multiple of the split", [SMAX - 1, SMAX - 2], 0, None, None),
    ("window starting inside a split", [100, 150], 0, 20, None),
    ("window spanning splits", [100, 199], 0, 70, None),
    ("softcap", [5, 63, 64, 199], 0, None, 50.0),
    ("keys leave whole splits empty", [199, 150], 0, 9, 30.0),
    ("kv_len past the query (window keeps later keys)", [40, 90], 30, 16, None),
]


@pytest.mark.parametrize("name,pos,extra,window,softcap", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("H,Hkv,D", [(8, 2, 64), (4, 4, 32)])
def test_split_plain_matches_pallas_and_plain(name, pos, extra, window, softcap, H, Hkv, D):
    pos = np.asarray(pos, np.int32)
    kv_len = np.minimum(pos + 1 + extra, SMAX).astype(np.int32)
    q, k, v = _inputs(len(name), len(pos), H, Hkv, D)
    ref = _jax_rows(q, k, v, pos, kv_len, window=window, softcap=softcap)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(q_offset=torch.from_numpy(pos), kv_len=torch.from_numpy(kv_len), window=window,
              softcap=softcap)
    out = dmod.decode_attention_split_plain(tq, tk, tv, split_len=SPLIT, **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=ATOL)
    plain = dmod.decode_attention_plain(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL, rtol=ATOL)
    # the planner's own split of the same cache gives the same answer
    planned = dmod.decode_attention_split_plain(tq, tk, tv, **kw)
    np.testing.assert_allclose(planned.numpy(), plain.numpy(), atol=ATOL, rtol=ATOL)


def test_split_plain_rows_with_no_key_write_zero():
    """kv_len 0, and a window that ends before kv_len starts: every split
    of the row is empty (m = -1e30, l = 0), the merge writes 0, never NaN."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(9, 2, 4, 2, 32))
    pos = torch.tensor([0, 150], dtype=torch.int32)
    out = dmod.decode_attention_split_plain(q, k, v, q_offset=pos, kv_len=torch.tensor([0, 0]),
                                            window=8, split_len=SPLIT)
    assert torch.isfinite(out).all() and float(out.abs().max()) == 0.0


@pytest.mark.parametrize("Smax,B,Hkv", [(1, 1, 1), (200, 2, 2), (1000, 8, 2), (1024, 8, 4),
                                        (2048, 8, 4), (2048, 1, 1), (4096, 16, 8), (300, 1, 32)])
def test_plan_splits_covers_the_cache_once(Smax, B, Hkv):
    n, L = dmod.plan_splits(Smax, B, Hkv)
    assert isinstance(n, int) and isinstance(L, int) and n >= 1 and L >= 1
    covered = np.zeros(Smax, np.int32)
    for s in range(n):
        covered[s * L:min((s + 1) * L, Smax)] += 1
    assert (covered == 1).all()
    assert (n - 1) * L < Smax <= n * L  # no split lies wholly past Smax
    # enough blocks for two waves of 132 SMs, unless splits would drop
    # under 64 keys
    assert n * B * Hkv >= 2 * 132 or L <= 64


@pytest.mark.parametrize("bad", [np.int64(512), torch.tensor(512), 512.0, True, 0])
def test_plan_splits_takes_only_python_ints(bad):
    """The planner reads shapes, never device values: anything but a
    positive Python int (a tensor, a numpy scalar) is refused."""
    with pytest.raises(TypeError):
        dmod.plan_splits(bad, 8, 4)
    with pytest.raises(TypeError):
        dmod.plan_splits(1024, bad, 4)
