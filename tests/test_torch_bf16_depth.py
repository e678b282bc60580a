"""bf16 at depth, layer by layer: the port's bf16 plain route against the
JAX package's own bf16 XLA route on a reduced-width mamba2-2.7b stack at
its full depth of 64 layers.

The same bf16 weights (the JAX package's ``init_params`` in bf16, carried
over by ``convert``) and the same bf16 input rows go through each
package's layers one at a time: the port's ``transformer.apply_layer``
with the plain SSD scan (``attn_impl="plain"``, the route the port takes
on the CPU), the JAX package's ``apply_layer`` with its XLA
``ssd_chunked``, and, as the yardstick, the JAX package's layers in fp32
on the same weights. Each layer's distance from the yardstick is its
largest |difference| relative to each row's largest |value| of the fp32
output. The port's bf16 route may be at most ``FACTOR`` times as far from
fp32 as the JAX package's bf16 route at every layer (two routes of one
precision that round at other points; a route that rounded more often,
e.g. the residual stream twice per layer, would be ~2x as far). The port's
own fp32 route stays within ``FP32_TOL`` of the yardstick at every layer.
At this width both bf16 routes drift to ~12-14% of a row's largest |value|
from fp32 by layer 64 (PERF.md)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.sharding.context import ExecContext as JaxCtx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402

ARCH, LAYERS, B, S = "mamba2-2.7b", 64, 2, 64
FACTOR = 1.5  # the port's bf16 distance from fp32 over the JAX package's, per layer
FP32_TOL = 1e-4  # the two fp32 routes apart, of each row's largest |value| (64 layers)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, ref):
    """The largest |a - ref| relative to each row's largest |ref|."""
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float((np.abs(a - ref) / np.abs(ref).max(axis=-1, keepdims=True)).max())


def _jax_layers(params, cfg, x):
    """Each layer's output of the JAX package's stack, one layer at a time
    (each layer kind's ``apply_layer`` jitted once)."""
    out, fns = [], {}
    for si, st in enumerate(jax_tfm.compute_stages(cfg)):
        for r in range(st.repeats):
            lp = jax.tree.map(lambda a: a[r], params["stages"][si])
            for j, (kind, mlp) in enumerate(st.pattern):
                if (kind, mlp) not in fns:
                    fns[kind, mlp] = jax.jit(lambda p, h, kind=kind, mlp=mlp: jax_tfm.apply_layer(
                        p, h, cfg, kind, mlp, JaxCtx(), "train", None, 0)[0])
                x = fns[kind, mlp](lp[f"l{j}"], x)
                out.append(np.asarray(x.astype(jnp.float32)))
    return out


@pytest.fixture(scope="module")
def routes():
    """Per layer: the port's bf16 plain and fp32 outputs, the JAX package's
    bf16 and fp32 outputs, on the same weights and input."""
    over = dict(num_layers=LAYERS, dtype="bfloat16", param_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_configs.reduced(jax_configs.get_config(ARCH)), **over)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(ARCH)), **over)
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    ids = np.random.default_rng(0).integers(1, cfg.vocab_size, (B, S))
    x0 = np.asarray(jp["embed"]["embedding"])[ids]  # bf16 rows, the same in both
    j16 = _jax_layers(jp, jcfg, jnp.asarray(x0))
    f32 = dataclasses.replace(jcfg, dtype="float32", param_dtype="float32")
    j32 = _jax_layers(jax.tree.map(lambda a: a.astype(jnp.float32), jp), f32,
                      jnp.asarray(x0).astype(jnp.float32))
    tree = jax.tree.map(np.asarray, jp)
    out = []
    for c in (cfg, dataclasses.replace(cfg, dtype="float32", param_dtype="float32")):
        model = convert.params_from_numpy(tree, c, "cpu")
        x = torch.from_numpy(np.asarray(x0.astype(np.float32))).to(getattr(torch, c.dtype))
        out.append([])
        with torch.no_grad():
            for lp in model.layers:
                x = tfm.apply_layer(lp, x, c, ExecContext(attn_impl="plain"), "prefill", None,
                                    0)[0]
                out[-1].append(x.float().numpy())
    return out[0], j16, j32, out[1]


def test_port_bf16_is_no_farther_from_fp32_than_jax_bf16_per_layer(routes):
    """At each of the 64 layers the port's bf16 plain route is at most
    ``FACTOR`` times as far from the fp32 yardstick as the JAX package's
    bf16 route (plus one bf16 ulp of the row's scale, 2^-8), and both are
    finite."""
    t16, j16, j32, _ = routes
    port = [_rel(a, f) for a, f in zip(t16, j32)]
    ref = [_rel(a, f) for a, f in zip(j16, j32)]
    assert len(port) == LAYERS and all(np.isfinite(port)) and all(np.isfinite(ref))
    worst = max(range(LAYERS), key=lambda i: port[i] - FACTOR * ref[i])
    assert all(p <= FACTOR * r + 2.0 ** -8 for p, r in zip(port, ref)), (
        worst, port[worst], ref[worst])


def test_the_fp32_yardstick_is_the_ports_own_fp32_route(routes):
    """The port's fp32 plain route on the same (bf16-valued) weights lies
    within ``FP32_TOL`` of each row's largest |value| of the JAX package's
    fp32 route at every layer, so the yardstick is not the JAX package's
    alone."""
    t32, j32 = routes[3], routes[2]
    pair = [_rel(a, b) for a, b in zip(t32, j32)]
    assert max(pair) <= FP32_TOL, (int(np.argmax(pair)), max(pair))
