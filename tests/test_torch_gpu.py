"""The hand-written CUDA kernels against their plain versions, on the card.

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
