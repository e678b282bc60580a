"""The bf16 SSD kernels' arithmetic, on the CPU.

``ssd_scan_split_plain`` computes what ``csrc/ssd_scan_bf16.cu`` computes:
chunk states from ``w_j x_j`` split into bf16 hi + lo parts, the fp32
state pass handing each chunk its entering state as hi + lo, then chunk
outputs with ``C . B^T`` in fp32 and the masked decay matrix as hi + lo.
It is held here against the JAX package's Pallas kernel (interpret mode, as
tests/test_torch_ssm.py runs it) and against ``ssd_chunked``, at small
sizes with a tail chunk, masked and unmasked, and against the port's fp32
``ssd_scan_plain`` at mamba2-2.7b's full widths.

Tolerances, each with its reason:
- y 3e-2 (absolute and relative): x, B and C are bf16 on both sides, y is
  rounded to bf16 on both sides (one ulp is 0.4-0.8% of a value) and the
  hi + lo operands leave ~2^-17 of relative error per product; the bf16
  kernel check of chip_smoke.py (SSD_TOL) is the same.
- state 1e-3 (absolute and relative): the state is fp32 on both sides and
  the hi + lo split keeps ~16 bits of each ``w_j x_j``; the card's check
  holds the kernel's state at the same 1e-3.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels import ssd_scan as smod  # noqa: E402

Y_TOL = 3e-2
STATE_TOL = 1e-3


def _inputs(seed, B, S, H, P, N, dt_shift=4.0):
    """Scan inputs as the model makes them (dt = softplus(. - dt_shift) > 0,
    per-head A = -(1..16), dA = dt * A in fp32); x, B, C rounded to bf16
    so both frameworks see the same values."""
    r = np.random.default_rng(seed)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)) - dt_shift)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return (bf(r.standard_normal((B, S, H, P))), torch.from_numpy(dt * A),
            torch.from_numpy(dt), bf(r.standard_normal((B, S, N))),
            bf(r.standard_normal((B, S, N))))


def _jax(t):
    return [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == torch.bfloat16
                        else jnp.float32) for a in t]


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _mask(B, S):
    """Left pads of different widths per row, as a pow2 prefill bucket."""
    m = np.ones((B, S), bool)
    m[0, :S // 3] = False
    m[B - 1, :5] = False
    return m


# (B, S, H, P, N, chunk): tail chunks, S below one chunk, a chunk cut into
# several 64-row tiles with a ragged last tile, an odd head count
CASES = [
    (2, 40, 3, 16, 16, 16),
    (1, 11, 2, 16, 32, 32),
    (2, 150, 2, 32, 64, 128),
    (1, 65, 5, 16, 16, 64),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
def test_split_plain_matches_pallas_and_chunked(B, S, H, P, N, chunk, masked):
    t = _inputs(S + H, B, S, H, P, N)
    mask = _mask(B, S) if masked else None
    y, h = smod.ssd_scan_split_plain(*t, mask=None if mask is None else torch.from_numpy(mask),
                                     chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jy, jh = jax_ssd_scan(*_jax(t), mask=None if mask is None else jnp.asarray(mask),
                          chunk=chunk, interpret=True)
    _close(y, jy, Y_TOL)
    _close(h, jh, STATE_TOL)
    if mask is None:  # ssd_chunked takes no mask
        cy, ch = jax_ssd_chunked(*_jax(t), chunk)
        _close(y, cy, Y_TOL)
        _close(h, ch, STATE_TOL)


def test_split_plain_masked_state_equals_valid_suffix():
    """A left-padded row's final state equals the scan over its valid
    suffix alone: pads neither write into nor decay the state."""
    t = _inputs(3, 2, 70, 2, 16, 32)
    mask = _mask(2, 70)
    _, h = smod.ssd_scan_split_plain(*t, mask=torch.from_numpy(mask), chunk=32)
    for b, pad in ((0, 70 // 3), (1, 5)):
        _, hb = smod.ssd_scan_split_plain(*(a[b:b + 1, pad:] for a in t), chunk=32)
        _close(h[b:b + 1], hb.numpy(), STATE_TOL)


@pytest.mark.parametrize("dt_shift", [4.0, 0.0])
def test_split_plain_at_full_mamba2_widths(dt_shift):
    """mamba2-2.7b's heads (H 80, P 64, N 128, chunk 256) at S 512: the
    state stays within 1e-3 of the fp32 plain version and y within 3e-2,
    at the card check's dt (softplus(. - 4), ~0.02) and at dt ~0.7, where
    rounding the decay matrix or the carried state to a single bf16 (as
    the public Mamba2 kernels do) puts y past 3e-2."""
    t = _inputs(11, 1, 512, 80, 64, 128, dt_shift)
    y, h = smod.ssd_scan_split_plain(*t, chunk=256)
    ry, rh = smod.ssd_scan_plain(*t, chunk=256)
    torch.testing.assert_close(h, rh, atol=STATE_TOL, rtol=STATE_TOL)
    torch.testing.assert_close(y.float(), ry.float(), atol=Y_TOL, rtol=Y_TOL)


def test_ssd_route_by_dtype():
    """bf16 goes to the tensor-core kernels and fp32 to the exact CUDA-core
    kernel, by dtype alone; any other dtype has no kernel."""
    assert smod.ssd_route(torch.bfloat16) == "ssd_scan_fwd_bf16"
    assert smod.ssd_route(torch.float32) == "ssd_scan_fwd_fp32"
    with pytest.raises(ValueError, match="no kernel"):
        smod.ssd_route(torch.float16)
    t = _inputs(5, 1, 20, 2, 16, 32)
    assert smod.ssd_checks(*t, 8) == "ssd_scan_fwd_bf16"
    x, dA, dt, Bm, Cm = t
    assert smod.ssd_checks(x.float(), dA, dt, Bm.float(), Cm.float(), 8) == "ssd_scan_fwd_fp32"


@pytest.mark.parametrize("P,N", [(24, 32), (16, 40), (8, 16)])
def test_bf16_ssd_refuses_widths_it_does_not_take(P, N):
    """The tensor-core kernels take P and N that are multiples of 16; any
    other bf16 shape raises before a launch (it never goes to the fp32
    kernel or the plain version)."""
    t = _inputs(6, 1, 20, 2, P, N)
    with pytest.raises(ValueError, match="bf16 SSD kernel"):
        smod.ssd_checks(*t, 8)
    x, dA, dt, Bm, Cm = t
    smod.ssd_checks(x.float(), dA, dt, Bm.float(), Cm.float(), 8)  # the fp32 route takes them
