"""The yolo-v2-tiny convnet of the port (``repro_torch.models.convnet``)
against the JAX package's ``apply_yolo`` on the same weights, carried over
by ``convert.yolo_params_from_numpy`` (HWIO to OIHW): within 1e-4 of the
largest |y| at the paper's 416x416 input (B=1) and at 64x64 (B=2), fp32;
the init's distributions; and the refusals: bf16 (the reference's bf16
path fails, ROADMAP.md Queue 3) and ``CausalLM``'s image input mode, which
names the convnet."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import convnet as jax_convnet  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.configs.yolo_v2_tiny import YOLO_STAGES  # noqa: E402
from repro_torch.convert import yolo_params_from_numpy  # noqa: E402
from repro_torch.models import convnet  # noqa: E402
from repro_torch.models.model import CausalLM  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """A few intra-op threads: the test files run in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_params(seed=0):
    return jax.tree.map(np.asarray, jax_convnet.init_yolo(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("B,H", [(1, 416), (2, 64)], ids=["416x416_B1", "64x64_B2"])
def test_yolo_matches_apply_yolo(B, H):
    jp = _jax_params()
    x = np.random.default_rng(H).standard_normal((B, H, H, 3)).astype(np.float32)
    want = np.asarray(jax_convnet.apply_yolo(jax.tree.map(jnp.asarray, jp), jnp.asarray(x)))
    model = yolo_params_from_numpy(jp, convnet.YOLO(device="cpu"))
    got = convnet.apply_yolo(model, torch.from_numpy(x))
    assert got.shape == (B, H // 32, H // 32, 125) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


def test_weights_cross_from_hwio_to_oihw():
    """Each stage's kernel is JAX's (kh, kw, in, out) transposed to
    (out, in, kh, kw), its bias as it is; a 1x1 last stage to 125."""
    jp = _jax_params(1)
    jp[2]["b"] = np.arange(jp[2]["b"].shape[0], dtype=np.float32)
    model = yolo_params_from_numpy(jp, convnet.YOLO(device="cpu"))
    assert len(model.convs) == len(YOLO_STAGES) == 9
    for conv, st, (out_ch, _) in zip(model.convs, jp, YOLO_STAGES):
        kh, kw, cin, cout = st["w"].shape
        assert tuple(conv.weight.shape) == (cout, cin, kh, kw) and cout == out_ch
        for o, i, a, b in ((0, 0, 0, kw - 1), (cout - 1, cin - 1, kh - 1, 0)):
            assert conv.weight[o, i, a, b].item() == st["w"][a, b, i, o]
        assert np.array_equal(conv.bias.numpy(), st["b"])
    assert tuple(model.convs[-1].weight.shape) == (125, 1024, 1, 1)


def test_init_matches_the_reference_distributions():
    """He-normal kernels N(0, 2 / (k*k*in)) and zero biases, fp32, from a
    seed; the same seed gives the same weights."""
    a, b = convnet.init_yolo(0, "cpu"), convnet.init_yolo(0, "cpu")
    n_params = sum(p.numel() for p in a.parameters())
    assert n_params == sum(st["w"].size + st["b"].size for st in _jax_params())
    for ca, cb in zip(a.convs, b.convs):
        assert torch.equal(ca.weight, cb.weight) and not ca.bias.any()
        o, i, kh, kw = ca.weight.shape
        std = float(ca.weight.std())
        assert abs(std / (2.0 / (kh * kw * i)) ** 0.5 - 1) < 0.1
        assert ca.weight.dtype == torch.float32


def test_bf16_and_the_image_mode_are_refused_naming_the_roadmap():
    """The port runs the convnet in fp32 only: the reference's bf16 weights
    meet fp32 biases and its second conv raises (pinned here); the
    language model's image input mode names the convnet module."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        convnet.YOLO(device="cpu", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        convnet.init_yolo(0, "cpu", dtype=torch.bfloat16)
    model = convnet.init_yolo(0, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        convnet.apply_yolo(model, torch.zeros(1, 64, 64, 3, dtype=torch.bfloat16))
    jp = jax_convnet.init_yolo(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    with pytest.raises(TypeError, match="same dtypes"):
        jax_convnet.apply_yolo(jp, jnp.zeros((1, 64, 64, 3), jnp.bfloat16))
    with pytest.raises(NotImplementedError, match=r"repro_torch\.models\.convnet.*ROADMAP.md"):
        CausalLM(configs.get_config("yolo-v2-tiny"), device="meta")
