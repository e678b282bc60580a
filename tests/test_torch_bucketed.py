"""The bucketed (position-synchronous) serving mode of the PyTorch port
against the JAX engine's ``mode="bucketed"``: reduced tinyllama-1.1b,
gemma2-2b and mamba2-2.7b on converted weights and the same requests, FIFO
and under ``AdaOperScheduler``; greedy tokens per uid identical, the
scheduler's batches and the ledger's charges equal. Then the port's own
invariants: bucketed equals continuous, greedy and sampled (the same
per-request streams); a draft is ignored; ``generate``'s ``pad_mask`` for
pure-SSM stacks; the engine's uncertainty keywords and their defaults."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import DeviceSim as JaxSim  # noqa: E402
from repro.core import RuntimeEnergyProfiler as JaxProfiler  # noqa: E402
from repro.core import build_transformer_graph as jax_graph  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.engine import AdaOperScheduler as JaxScheduler  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.opgraph import build_transformer_graph  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.serving import speculative  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import AdaOperScheduler  # noqa: E402
from repro_torch.serving.slots import Request  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402

ARCHS = ["tinyllama-1.1b", "gemma2-2b", "mamba2-2.7b"]
# (prompt length, max_new_tokens): two equal-length buckets per model, a
# bucket longer than one batch's worth under the scheduler's choice
MIXED = [(12, 4), (20, 6), (12, 3), (20, 5), (12, 6), (20, 2), (12, 5)]
MAX_LEN = 40
CALIB = 300


@pytest.fixture(scope="module")
def models():
    out = {}
    for k, arch in enumerate(ARCHS):
        jcfg = jax_configs.reduced(jax_configs.get_config(arch))
        tcfg = configs.reduced(configs.get_config(arch))
        jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(k), jcfg)
        out[arch] = (jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return out


def _scheduler(models, port):
    graph, prof, sim, sched = ((build_transformer_graph, RuntimeEnergyProfiler, DeviceSim,
                                AdaOperScheduler) if port else
                               (jax_graph, JaxProfiler, JaxSim, JaxScheduler))
    p = prof(seed=0)
    p.offline_calibrate([graph(models[a][2 if port else 0], 4, 32) for a in ARCHS],
                        n_samples=CALIB)
    return sched(p, sim("moderate", seed=0))


def _submit(eng, models, port, archs=ARCHS):
    for k, arch in enumerate(archs):
        jcfg, jp, tcfg, tp = models[arch]
        cfg, params = (tcfg, tp) if port else (jcfg, jp)
        eng.add_model(arch, cfg, params, max_len=MAX_LEN)
        rng = np.random.default_rng(k)
        make = Request if port else JaxRequest
        for i, (plen, mn) in enumerate(MIXED):
            eng.submit(arch, make(100 * k + i,
                                  rng.integers(1, cfg.vocab_size, plen, dtype=np.int32), mn))


def _serve(eng, models, port, archs=ARCHS, temperature=0.0):
    _submit(eng, models, port, archs)
    return {r.uid: r for r in eng.run_all(temperature=temperature)}


def _tokens(res):
    return {uid: [int(t) for t in r.tokens] for uid, r in res.items()}


@pytest.mark.parametrize("scheduled", [False, True], ids=["fifo", "scheduled"])
def test_bucketed_engine_matches_jax_engine(models, scheduled):
    """Greedy tokens per uid identical to the JAX engine's bucketed mode;
    the batches chosen (the scheduler's EDP choice, or up to 8 under FIFO)
    and the ledger's per-request charges equal."""
    jeng = JaxEngine(scheduler=_scheduler(models, False) if scheduled else None,
                     mode="bucketed")
    teng = ServingEngine(scheduler=_scheduler(models, True) if scheduled else None,
                         mode="bucketed")
    jres, tres = _serve(jeng, models, False), _serve(teng, models, True)
    assert sorted(tres) == sorted(jres) and len(tres) == len(ARCHS) * len(MIXED)
    assert _tokens(tres) == _tokens(jres)
    for uid, r in jres.items():
        assert len(tres[uid].tokens) == MIXED[uid % 100][1]
        if scheduled:
            np.testing.assert_allclose(tres[uid].energy_j_pred, r.energy_j_pred, rtol=1e-12)
    for arch in ARCHS:
        assert [s["batch"] for s in teng.stats[arch]] == [s["batch"] for s in jeng.stats[arch]]
    assert [(e.kind, e.model, e.uid) for e in teng.ledger.events] == [
        (e.kind, e.model, e.uid) for e in jeng.ledger.events]
    if scheduled:
        assert {s["batch"] for a in ARCHS for s in teng.stats[a]} - {4, 8}, \
            "the scheduler must split a bucket somewhere"
        for te, je in zip(teng.ledger.events, jeng.ledger.events):
            np.testing.assert_allclose([te.energy.total_j, te.energy.cpu_j, te.energy.gpu_j,
                                        te.energy.bus_j],
                                       [je.energy.total_j, je.energy.cpu_j, je.energy.gpu_j,
                                        je.energy.bus_j], rtol=1e-12)
        assert (teng.scheduler.plan_cache_hits, teng.scheduler.plan_cache_misses) == (
            jeng.scheduler.plan_cache_hits, jeng.scheduler.plan_cache_misses)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_bucketed_one_batch_matches_jax(models, arch):
    """One ``step`` serves the first request's equal-length bucket (up to 8)
    and leaves the rest queued, as the JAX engine does."""
    jcfg, jp, tcfg, tp = models[arch]
    outs = {}
    for port in (False, True):
        eng = (ServingEngine if port else JaxEngine)(mode="bucketed")
        _submit(eng, models, port, [arch])
        first = eng.step(arch)
        outs[port] = ({r.uid: [int(t) for t in r.tokens] for r in first},
                      [r.uid for r in eng.queues[arch]])
    assert outs[True] == outs[False]
    assert sorted(outs[True][0]) == [i for i, (p, _) in enumerate(MIXED) if p == MIXED[0][0]]


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_bucketed_equals_continuous_in_the_port(models, temperature):
    """Within the port the two modes serve the same tokens per uid, greedy
    and sampled: token i of a request is drawn from its own stream in both."""
    out = {}
    for mode in ("bucketed", "continuous"):
        eng = ServingEngine(mode=mode, max_slots=4)
        out[mode] = _tokens(_serve(eng, models, True, temperature=temperature))
    assert out["bucketed"] == out["continuous"]
    if temperature:
        greedy = _tokens(_serve(ServingEngine(mode="bucketed"), models, True))
        assert greedy != out["bucketed"]


def test_bucketed_mode_ignores_draft(models):
    """The position-synchronous path never speculates: a draft registered
    on a bucketed engine changes nothing."""
    arch = "tinyllama-1.1b"
    _, _, tcfg, tp = models[arch]
    base = ServingEngine(mode="bucketed")
    base_tok = _tokens(_serve(base, models, True, [arch]))
    dcfg, dp, _ = speculative.truncated_draft(tcfg, tp)
    eng = ServingEngine(mode="bucketed")
    eng.add_model(arch, tcfg, tp, max_len=MAX_LEN, draft=(dcfg, dp))
    rng = np.random.default_rng(0)
    for i, (plen, mn) in enumerate(MIXED):
        eng.submit(arch, Request(i, rng.integers(1, tcfg.vocab_size, plen, dtype=np.int32), mn))
    assert _tokens({r.uid: r for r in eng.run_all()}) == base_tok
    assert not any(k.startswith("spec") for k in eng.ledger.counters)
    assert eng.spec[arch].worker.decode_calls == 0


def test_generate_pad_mask_for_pure_ssm_and_refused_for_encdec(models):
    """``generate`` with LEFT-padded prompts and a mask equals the
    exact-length ``generate`` for mamba2 (greedy), as the JAX worker's; an
    encoder-decoder worker refuses a pad mask."""
    jcfg, jp, tcfg, tp = models["mamba2-2.7b"]
    from repro.serving.workers import ModelWorker as JaxWorker
    rng = np.random.default_rng(3)
    exact = rng.integers(1, tcfg.vocab_size, (2, 9), dtype=np.int32)
    padded = np.concatenate([np.zeros((2, 7), np.int32), exact], axis=1)
    mask = np.concatenate([np.zeros((2, 7), bool), np.ones((2, 9), bool)], axis=1)
    tw = ModelWorker("m", tcfg, tp, max_len=MAX_LEN)
    jw = JaxWorker("m", jcfg, jp, max_len=MAX_LEN)
    want = tw.generate(exact, 5)
    np.testing.assert_array_equal(jw.generate(exact, 5), want)
    # the masked prefill leaves the state of the exact prompt; the decode
    # positions move by the pad, which a pure-SSM stack does not read
    np.testing.assert_array_equal(tw.generate(padded, 5, pad_mask=mask), want)
    np.testing.assert_array_equal(jw.generate(padded, 5, pad_mask=mask), want)
    ecfg = configs.reduced(configs.get_config("seamless-m4t-medium"))
    from repro_torch.models.model import init_params
    ew = ModelWorker("s", ecfg, init_params(ecfg, 0, "cpu"), max_len=MAX_LEN)
    frames = np.zeros((1, 4, ecfg.d_model), np.float32)
    with pytest.raises(ValueError, match="pure-SSM"):
        ew.generate(exact[:1], 2, enc_inputs=frames, pad_mask=mask[:1])


def test_engine_keywords_and_modes(models):
    """The reference's signature: ``risk_level``, ``legacy_drift`` and
    ``ssm_prompt_buckets`` are taken with their inert defaults and kept
    where admission and planning read them; an unknown mode and a trace
    replay in bucketed mode are refused as the JAX engine refuses them."""
    eng = ServingEngine()
    assert (eng.admission.risk_level, eng.legacy_drift, eng.ssm_prompt_buckets) == (
        None, False, True)
    eng = ServingEngine(mode="bucketed", risk_level=0.9, legacy_drift=True,
                        ssm_prompt_buckets=False)
    assert (eng.mode, eng.admission.risk_level, eng.legacy_drift, eng.ssm_prompt_buckets) == (
        "bucketed", 0.9, True, False)
    for make in (ServingEngine, JaxEngine):
        with pytest.raises(ValueError, match=r"\('continuous', 'bucketed'\)"):
            make(mode="nope")
        with pytest.raises(ValueError, match="mode='continuous'"):
            make(scheduler=_scheduler(models, make is ServingEngine),
                 mode="bucketed").run_trace([])


@pytest.mark.parametrize("buckets", [True, False], ids=["ssm-buckets", "exact-lengths"])
def test_ssm_prompt_buckets_flag_matches_jax(models, buckets):
    """``ssm_prompt_buckets=False`` makes mamba2's admission group by exact
    prompt length, as the JAX engine's flag does: prompts of 12 and 14
    tokens share one masked 16-long prefill, or take one each; the same
    prefill batches and tokens on both sides."""
    arch, reqs = "mamba2-2.7b", [(12, 3), (14, 4), (12, 2), (14, 5)]
    res = {}
    for port in (False, True):
        jcfg, jp, tcfg, tp = models[arch]
        cfg = tcfg if port else jcfg
        eng = (ServingEngine if port else JaxEngine)(ssm_prompt_buckets=buckets, max_slots=8)
        eng.add_model(arch, cfg, tp if port else jp, max_len=MAX_LEN)
        rng = np.random.default_rng(5)
        for i, (plen, mn) in enumerate(reqs):
            eng.submit(arch, (Request if port else JaxRequest)(
                i, rng.integers(1, cfg.vocab_size, plen, dtype=np.int32), mn))
        toks = _tokens({r.uid: r for r in eng.run_all()})
        res[port] = (toks, eng.prefill_batches, eng.prefill_batch_requests)
    assert res[True] == res[False]
    assert res[True][1] == (1 if buckets else 2)
