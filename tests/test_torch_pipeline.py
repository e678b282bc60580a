"""The port's circular pipeline (``repro_torch.sharding.pipeline`` and the
train-mode hook of ``apply_stack``) against the sequential order and the
JAX package: the mirrors of ``tests/test_pipeline.py``, and the stages
that each package pipelines."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

import repro.sharding.pipeline as jax_pipeline  # noqa: E402
from repro.configs import base as jax_configs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.sharding.context import ExecContext as JaxContext  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402
from repro_torch.sharding.pipeline import circular_pipeline, pipeline_ticks, split_stages  # noqa: E402

PLAN = {"pipeline": {"stages": 2, "microbatches": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the test files run in parallel
    worker processes, where torch's default of a thread per core
    oversubscribes the CPU (a reduced train step then runs ten times
    slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_stage_fn(group, x):
    """One stage: its layers in order; a layer's params are a (scale,
    shift) row, so the composition is order-sensitive; aux sums outputs."""
    aux = torch.zeros((), dtype=x.dtype)
    for w in group:
        x = x * w[0] + w[1]
        aux = aux + x.sum()
    return x, aux


def _jax_toy_stage_fn(group, x):
    def layer(carry, w):
        y = carry * w[0] + w[1]
        return y, jnp.sum(y)
    y, auxs = jax.lax.scan(layer, x, group)
    return y, auxs.sum()


def test_split_stages_shapes_and_indivisibility():
    p = torch.arange(24.0).reshape(6, 4)
    g = split_stages(p, 3)
    assert len(g) == 3 and g[1].shape == (2, 4)
    assert torch.equal(g[1], p[2:4])
    assert split_stages(list(range(6)), 2) == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError, match="do not divide"):
        split_stages(p, 4)


def test_pipeline_ticks():
    assert pipeline_ticks(1, 4) == 4  # no bubbles at one stage
    assert pipeline_ticks(4, 2) == 5  # M + S - 1
    for s, m in ((1, 1), (2, 3), (4, 2)):
        assert pipeline_ticks(s, m) == jax_pipeline.pipeline_ticks(s, m)


@pytest.mark.parametrize("stages,microbatches", [(1, 1), (2, 2), (2, 4), (4, 2)])
def test_circular_pipeline_matches_sequential_and_jax(stages, microbatches):
    rng = np.random.default_rng(0)
    L, B, D = 8, 8, 5
    scale = 1.0 + 0.3 * rng.normal(size=(L, D))
    shift = 0.3 * rng.normal(size=(L, D))
    params = np.stack([scale, shift], axis=1).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    y_ref, aux_ref = _toy_stage_fn(torch.from_numpy(params), torch.from_numpy(x))
    y, aux = circular_pipeline(_toy_stage_fn, torch.from_numpy(params), torch.from_numpy(x),
                               stages, microbatches)
    # the rotation is the same arithmetic reordered: each microbatch's
    # result is exact, only the order of the aux sum differs
    torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=0)
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-5)
    jy, jaux = jax_pipeline.circular_pipeline(_jax_toy_stage_fn, jnp.asarray(params),
                                              jnp.asarray(x), stages, microbatches)
    # (against JAX to an fp32 ulp: XLA fuses each layer's multiply-add)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


def test_circular_pipeline_bubble_ticks_do_not_pollute_aux():
    # shift-only layers (scale 1, shift 1): a zero-fed bubble would still
    # give nonzero outputs, so a bubble tick must not count
    L, B, D = 4, 4, 3
    params = torch.stack([torch.ones(L, D), torch.ones(L, D)], dim=1)
    x = torch.zeros(B, D)
    _, aux_ref = _toy_stage_fn(params, x)
    _, aux = circular_pipeline(_toy_stage_fn, params, x, 2, 2)
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-6)


def test_circular_pipeline_rejects_indivisible_batch():
    with pytest.raises(ValueError, match="microbatches"):
        circular_pipeline(_toy_stage_fn, torch.ones(4, 2, 3), torch.ones(5, 3), 2, 2)


def _pair(arch, num_layers):
    jcfg = dataclasses.replace(jax_configs.reduced(jax_configs.get_config(arch)),
                               num_layers=num_layers)
    tcfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), num_layers=num_layers)
    jparams = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                                  device="cpu")


def test_train_logits_equivalent_under_pipeline_plan():
    """The hook: a train forward under the pipeline plan equals the one
    without it, and both equal the JAX package's reference."""
    jcfg, jparams, tcfg, params = _pair("tinyllama-1.1b", 2)
    toks = np.random.default_rng(1).integers(1, tcfg.vocab_size, (4, 12)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks).long()}
    ref, aux_ref = tmodel.train_logits(params, tcfg, batch, ExecContext())
    out, aux = tmodel.train_logits(params, tcfg, batch, ExecContext(plan=PLAN))
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-4, abs=1e-6)
    jref, _ = jax_model.train_logits(jparams, jcfg, {"tokens": jnp.asarray(toks)}, JaxContext())
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), rtol=2e-4, atol=2e-5)


def test_decode_ignores_pipeline_plan():
    """The hook is train-only: prefill and a decode step under the pipeline
    plan are bit-identical to the plain context's."""
    _, _, tcfg, params = _pair("tinyllama-1.1b", 2)
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, tcfg.vocab_size, (2, 8)))
    out = []
    for ctx in (ExecContext(), ExecContext(plan=PLAN)):
        cache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
        logits, cache = tmodel.prefill(params, tcfg, toks, cache, ctx)
        step, _ = tmodel.decode_step(params, tcfg, toks[:, -1:], cache, 8, ctx)
        out.append((logits, step))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("arch,num_layers,pipelined", [
    ("tinyllama-1.1b", 4, [4]), ("gemma2-2b", 4, [2]), ("gemma2-2b", 6, []),
    ("deepseek-v2-lite-16b", 4, [])])
def test_the_same_stages_are_pipelined_as_in_jax(arch, num_layers, pipelined, monkeypatch):
    """Each package pipelines a stage whose repeats divide into the plan's 2
    stages: tinyllama's 4 repeats of one layer and gemma2's 2 repeats of
    (local, global), not gemma2's 3, and not deepseek-v2-lite's stack, whose
    dense first layer makes ``compute_stages`` return one stage of one
    repeat. The packages pipeline the same stages (counted by their
    repeats) and give the same train logits."""
    jcfg, jparams, tcfg, params = _pair(arch, num_layers)
    seen = {"jax": [], "port": []}
    real_jax, real_port = jax_pipeline.circular_pipeline, tfm.circular_pipeline

    def jax_spy(stage_fn, stage_params, x, S, M):
        seen["jax"].append(jax.tree.leaves(stage_params)[0].shape[0])
        return real_jax(stage_fn, stage_params, x, S, M)

    def port_spy(stage_fn, steps, x, S, M):
        seen["port"].append(len(steps))
        return real_port(stage_fn, steps, x, S, M)

    monkeypatch.setattr(jax_pipeline, "circular_pipeline", jax_spy)
    monkeypatch.setattr(tfm, "circular_pipeline", port_spy)
    toks = np.random.default_rng(3).integers(1, tcfg.vocab_size, (4, 10)).astype(np.int32)
    jout, _ = jax_model.train_logits(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                     JaxContext(plan=PLAN))
    out, _ = tmodel.train_logits(params, tcfg, {"tokens": torch.from_numpy(toks).long()},
                                 ExecContext(plan=PLAN))
    assert seen["port"] == seen["jax"] == pipelined
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-4, atol=2e-5)
