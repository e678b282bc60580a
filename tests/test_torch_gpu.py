"""The hand-written CUDA kernels (attention, SSD scan) against their plain
versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py``. This file
imports no JAX (the GPU machine has none): inputs come from numpy.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import ssd_scan as smod

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(seed, shape, dtype, dev):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=dev, dtype=getattr(torch, dtype))


def _close(out, ref, dtype):
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D,softcap,window", [
    (32, 4, 64, None, None),    # tinyllama-1.1b
    (8, 4, 256, 50.0, 96),      # gemma2-2b local layer, window < S
])
def test_flash_kernel_matches_plain_on_card(dtype, H, Hkv, D, softcap, window):
    dev = _card()
    B, S = 2, 200
    q = _randn(0, (B, S, H, D), dtype, dev)
    k, v = (_randn(s, (B, S, Hkv, D), dtype, dev) for s in (1, 2))
    for kw in (dict(causal=True, window=window, softcap=softcap),
               dict(causal=True, q_offset=torch.tensor([0, 30], device=dev),
                    kv_len=torch.tensor([200, 120], device=dev))):
        before = fmod.flash_attention.launches
        out = fmod.flash_attention(q, k, v, **kw)
        assert fmod.flash_attention.launches == before + 1
        _close(out, fmod.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D,softcap,window", [
    (32, 4, 64, None, None),
    (8, 4, 256, 50.0, 256),
])
def test_decode_kernel_matches_plain_on_card(dtype, H, Hkv, D, softcap, window):
    dev = _card()
    pos = torch.tensor([0, 1, 63, 64, 500, 1023, 2046, 2047], dtype=torch.int32, device=dev)
    q = _randn(3, (8, 1, H, D), dtype, dev)
    k, v = (_randn(s, (8, 2048, Hkv, D), dtype, dev) for s in (4, 5))
    kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=softcap)
    before = dmod.decode_attention.launches
    out = dmod.decode_attention(q, k, v, **kw)
    assert dmod.decode_attention.launches == before + 1
    _close(out, dmod.decode_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 17, 64, 65, 128, 129, 200, 1024])
@pytest.mark.parametrize("H,Hkv,D,softcap", [(32, 4, 64, None), (8, 4, 256, 50.0)])
def test_flash_kernel_at_tile_edges(dtype, S, H, Hkv, D, softcap):
    """Lengths on and beside the 128-row q tiles and 64-key K/V tiles, with
    a window that crosses tiles."""
    dev = _card()
    q = _randn(10, (1, S, H, D), dtype, dev)
    k, v = (_randn(s, (1, S, Hkv, D), dtype, dev) for s in (11, 12))
    for window in (None, S // 3 + 1):
        kw = dict(causal=True, window=window, softcap=softcap)
        _close(fmod.flash_attention(q, k, v, **kw), fmod.flash_attention_plain(q, k, v, **kw),
               dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,Dk,Dv", [(1, 64, 64), (2, 64, 32), (4, 128, 128), (8, 64, 64),
                                     (2, 256, 256)])
def test_flash_kernel_groups_head_dims_and_per_row_positions(dtype, G, Dk, Dv):
    """Every GQA group, Dv != Dk, and per-row q_offset / kv_len with
    kv_len < q_offset + S (one row keeps no key and must write 0)."""
    dev = _card()
    Hkv, Sq, Sk = 2, 65, 300
    q = _randn(13, (4, Sq, G * Hkv, Dk), dtype, dev)
    k = _randn(14, (4, Sk, Hkv, Dk), dtype, dev)
    v = _randn(15, (4, Sk, Hkv, Dv), dtype, dev)
    kw = dict(causal=True, q_offset=torch.tensor([0, 100, 230, 5], device=dev),
              kv_len=torch.tensor([40, 120, 260, 0], device=dev))
    for window in (None, 100):
        out = fmod.flash_attention(q, k, v, window=window, **kw)
        _close(out, fmod.flash_attention_plain(q, k, v, window=window, **kw), dtype)
        assert float(out[3].float().abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_at_split_edges(dtype, G, D):
    """kv_len on a split boundary, one before and one past it, Smax 1000
    (not a multiple of the split), windows inside one split and across
    splits, with and without softcap."""
    dev = _card()
    B, Smax, Hkv = 8, 1000, 2
    L = dmod.plan_splits(Smax, B, Hkv)[1]
    pos = torch.tensor([0, L - 2, L - 1, L, 2 * L - 1, 2 * L, Smax - 2, Smax - 1],
                       dtype=torch.int32, device=dev)
    q = _randn(16, (B, 1, G * Hkv, D), dtype, dev)
    k, v = (_randn(s, (B, Smax, Hkv, D), dtype, dev) for s in (17, 18))
    for window, softcap in ((None, None), (L // 2 + 3, None), (2 * L + 5, 50.0)):
        kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=softcap)
        before = dmod.decode_attention.launches
        out = dmod.decode_attention(q, k, v, **kw)
        assert dmod.decode_attention.launches == before + 1
        _close(out, dmod.decode_attention_plain(q, k, v, **kw), dtype)


# sums of up to 256 x 128 fp32 products in another order than the plain
# version's; bf16: y is rounded to bf16 on both sides
SSD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,masked", [(1, 64, False), (2, 200, True), (1, 1024, False)])
def test_ssd_scan_kernel_matches_plain_on_card(dtype, B, S, masked):
    """mamba2-2.7b heads (H 80, P 64, N 128, chunk 256): one chunk shorter
    than 256, a tail chunk with left-padded rows, four full chunks."""
    dev = _card()
    H, P, N = 80, 64, 128
    r = np.random.default_rng(6)
    dt = torch.from_numpy(np.log1p(np.exp(r.standard_normal((B, S, H)) - 4.0))
                          .astype(np.float32)).to(dev)
    A = -torch.exp(torch.linspace(0.0, float(np.log(16.0)), H, device=dev))
    x = _randn(7, (B, S, H, P), dtype, dev)
    Bm, Cm = (_randn(s, (B, S, N), dtype, dev) for s in (8, 9))
    mask = None
    if masked:
        mask = torch.ones(B, S, dtype=torch.bool, device=dev)
        mask[0, :57] = False
    before = smod.ssd_scan.launches
    y, h = smod.ssd_scan(x, dt * A, dt, Bm, Cm, mask=mask, chunk=256)
    assert smod.ssd_scan.launches == before + 1
    ry, rh = smod.ssd_scan_plain(x, dt * A, dt, Bm, Cm, mask=mask, chunk=256)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), ry.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, rh, atol=SSD_TOL["float32"], rtol=SSD_TOL["float32"])
