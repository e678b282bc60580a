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
