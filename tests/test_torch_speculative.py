"""Speculative decoding and trace-driven serving of the PyTorch port against
the JAX package, on converted weights and the same requests.

The verify primitive (``gqa_decode`` with T > 1 positions per row, then
``ModelWorker.decode_verify``) is held against JAX's: its XLA path on the
whole batch and its Pallas flash kernel in interpret mode row by row (the
Pallas wrapper takes one q_offset per call), with rows whose pos + T runs
past the cache, at 1e-4 (fp32; the frameworks sum their matmuls in
different orders). Within the port, the verify's logits agree with T
sequential single-token steps at 1e-4 (the flash and decode plain versions
reduce in different orders).

The scheduled ``run_trace`` of a 6-layer reduced tinyllama with a truncated
and with a random 1-layer draft must match the JAX engine exactly in what
the port copies (greedy tokens per uid, the spec counters, ``spec_log``,
the ledger's kinds) and to 1e-9 in the simulated joules and the virtual
latencies. Speculative output is token-identical to the port's own plain
decode, greedy and sampled."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import DeviceSim as JaxSim  # noqa: E402
from repro.core import RuntimeEnergyProfiler as JaxProfiler  # noqa: E402
from repro.core import build_transformer_graph as jax_graph  # noqa: E402
from repro.models import attention as jax_att  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import speculative as jax_spec  # noqa: E402
from repro.serving.admission import AdmissionPolicy as JaxPolicy  # noqa: E402
from repro.serving.engine import AdaOperScheduler as JaxScheduler  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.opgraph import build_transformer_graph  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.core.telemetry import fold_energy  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.admission import AdmissionPolicy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import AdaOperScheduler  # noqa: E402
from repro_torch.serving.slots import Request  # noqa: E402
from repro_torch.serving.speculative import SpecConfig, truncated_draft  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402

TOL = 1e-4
MAX_LEN = 96
# 6 layers, as tests/test_speculative.py's `deep`: the 1-layer draft's priced
# step is then cheap enough against the target's for the EDP rule to approve
DEEP = 6


@functools.cache
def _pair(arch, num_layers=2, seed=0, name=None):
    """JAX config + params and their port counterparts (shared; tests must
    not modify them)."""
    def cut(c):
        c = dataclasses.replace(c, num_layers=num_layers)
        return dataclasses.replace(c, name=name) if name else c
    jcfg = cut(jax_configs.reduced(jax_configs.get_config(arch)))
    tcfg = cut(configs.reduced(configs.get_config(arch)))
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _draft(kind, num_layers=2):
    """(JAX target params, JAX draft, port target params, port draft) for
    the reduced tinyllama target of ``num_layers``: the truncated self-draft,
    or a separately seeded 1-layer draft (``random``, as the reference's
    ``tiny_draft``; ``losing``, as its ``test_spec_decision_declines_losing_draft``)."""
    jcfg, jp, tcfg, tp = _pair("tinyllama-1.1b", num_layers)
    if kind == "truncated":
        jd, jdp, jtp = jax_spec.truncated_draft(jcfg, jp)
        td, tdp, ttp = truncated_draft(tcfg, tp)
        return jtp, (jd, jdp), ttp, (td, tdp)
    seed, suffix = {"random": (7, "-draft"), "losing": (9, "-rd")}[kind]
    djcfg, djp, dtcfg, dtp = _pair("tinyllama-1.1b", 1, seed, name=f"{jcfg.name}{suffix}")
    return jp, (djcfg, djp), tp, (dtcfg, dtp)


def _requests(cfg, port, n=6, seed=0):
    r = np.random.RandomState(seed)
    make = Request if port else JaxRequest
    return [make(i, r.randint(1, cfg.vocab_size, size=r.randint(4, 12)).astype(np.int32),
                 int(r.randint(3, 14))) for i in range(n)]


def _scheduler(cfgs, port):
    graph, prof, sim, sched = ((build_transformer_graph, RuntimeEnergyProfiler, DeviceSim,
                                AdaOperScheduler) if port else
                               (jax_graph, JaxProfiler, JaxSim, JaxScheduler))
    p = prof(use_gru=False)
    p.offline_calibrate([graph(c, 2, 32) for c in cfgs], n_samples=600, seed=0)
    return sched(p, sim("moderate", seed=0))


def _serve(port, cfg, params, draft=None, temperature=0.0, scheduled=False, seed=0,
           spec=None):
    """One engine over model "m" (max_slots 4): a ``run_trace`` with every
    arrival at t = 0 under a scheduler calibrated on the target's and the
    draft's graphs, or FIFO ``run_all``. Returns ({uid: tokens}, engine,
    responses)."""
    Engine = ServingEngine if port else JaxEngine
    sched = (_scheduler([cfg] + ([draft[0]] if draft else []), port) if scheduled else None)
    eng = Engine(scheduler=sched, max_slots=4)
    eng.add_model("m", cfg, params, max_len=MAX_LEN, draft=draft, spec=spec)
    reqs = _requests(cfg, port, seed=seed)
    if scheduled:
        out = eng.run_trace([(0.0, "m", r) for r in reqs], temperature=temperature)
    else:
        for r in reqs:
            eng.submit("m", r)
        out = eng.run_all(temperature=temperature)
    return {r.uid: r.tokens.tolist() for r in out}, eng, out


def _same_engine_run(teng, tout, jeng, jout):
    """The port's run equals the JAX engine's: tokens, logs, counters, and
    every ledger event's joules and (virtual) latency to 1e-9."""
    assert {r.uid: r.tokens.tolist() for r in tout} == {r.uid: r.tokens.tolist() for r in jout}
    tres, jres = {r.uid: r for r in tout}, {r.uid: r for r in jout}
    for uid, r in jres.items():
        np.testing.assert_allclose([tres[uid].latency_s, tres[uid].energy_j_pred],
                                   [r.latency_s, r.energy_j_pred], rtol=1e-9)
    assert teng.admission.log == jeng.admission.log
    assert teng.admission.spec_log == jeng.admission.spec_log
    assert teng.ledger.counters == jeng.ledger.counters
    assert ([(e.kind, e.model, e.n_active, e.uid) for e in teng.ledger.events]
            == [(e.kind, e.model, e.n_active, e.uid) for e in jeng.ledger.events])
    for te, je in zip(teng.ledger.events, jeng.ledger.events):
        np.testing.assert_allclose(
            [te.energy.total_j, te.energy.cpu_j, te.energy.gpu_j, te.energy.bus_j,
             te.latency_s, te.t_s],
            [je.energy.total_j, je.energy.cpu_j, je.energy.gpu_j, je.energy.bus_j,
             je.latency_s, je.t_s], rtol=1e-9, atol=0)
    assert teng.drift_events == jeng.drift_events
    assert teng.prefill_batches == jeng.prefill_batches


# ---------------------------------------------------------------------------
# the verify primitive
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b"])
def test_gqa_verify_matches_jax(arch, impl):
    """T = 4 positions per row against a cache of 40 holding random (stale)
    K/V everywhere: rows at 0, 7, Smax - T (the last position that fits),
    Smax - 2 (two writes dropped) and Smax (all dropped). gemma2's first
    layer is local (window 32 in the reduced config) with softcap 50."""
    jcfg, jp, tcfg, tp = _pair(arch)
    B, T, Smax = 5, 4, 40
    jl = jax.tree.map(lambda a: a[0], jp["stages"][0]["l0"]["attn"])
    tl = tp.layers[0].attn
    window = tcfg.sliding_window if tcfg.layer_kinds()[0] == "local" else None
    r = np.random.default_rng(3)
    x = r.standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    ck, cv = (r.standard_normal((B, Smax, tcfg.num_kv_heads, tcfg.head_dim)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 7, Smax - T, Smax - 2, Smax], np.int32)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, _ = tatt.gqa_decode(tl, torch.from_numpy(x), tcfg, tk, tv, torch.from_numpy(pos),
                             window=window)
    if impl == "xla":
        jo, (jk, jv) = jax_att.gqa_decode(jl, jnp.asarray(x), jcfg, jnp.asarray(ck),
                                          jnp.asarray(cv), jnp.asarray(pos), window=window)
    else:  # the Pallas flash kernel takes one q_offset per call: row by row
        rows = [jax_att.gqa_decode(jl, jnp.asarray(x[b:b + 1]), jcfg, jnp.asarray(ck[b:b + 1]),
                                   jnp.asarray(cv[b:b + 1]), jnp.asarray(pos[b:b + 1]),
                                   window=window, impl="pallas") for b in range(B)]
        jo = jnp.concatenate([o for o, _ in rows])
        jk = jnp.concatenate([kv[0] for _, kv in rows])
        jv = jnp.concatenate([kv[1] for _, kv in rows])
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
    # the parked row and the dropped tail kept their stale entries
    np.testing.assert_array_equal(tk[4].numpy(), ck[4])
    np.testing.assert_array_equal(tk[3, :Smax - 2].numpy(), ck[3, :Smax - 2])


def _pools(port_worker, jax_worker, prompts):
    _, g = port_worker.prefill_batch(prompts)
    tpool = port_worker.write_slots(port_worker.init_pool(len(prompts)), g,
                                    np.arange(len(prompts)))
    _, jg = jax_worker.prefill_batch(prompts)
    jpool = jax_worker.write_slots(jax_worker.init_pool(len(prompts)), jg,
                                   np.arange(len(prompts)))
    return tpool, jpool


def test_decode_verify_matches_jax_and_sequential_steps():
    """``decode_verify``'s (B, T, V) logits against JAX's on the same cache,
    and against T sequential ``decode_pool`` steps of the port."""
    jcfg, jp, tcfg, tp = _pair("tinyllama-1.1b")
    tw, jw = ModelWorker("m", tcfg, tp, max_len=48), JaxWorker("m", jcfg, jp, max_len=48)
    r = np.random.RandomState(1)
    prompts = r.randint(1, tcfg.vocab_size, size=(4, 12)).astype(np.int32)
    tpool, jpool = _pools(tw, jw, prompts)
    seq_pool = {n: c.clone() for n, c in tpool.items()}
    toks = r.randint(1, tcfg.vocab_size, size=(4, 3)).astype(np.int32)
    pos = np.array([12, 12, 12, 46], np.int32)  # the last row runs past max_len 48
    greedy, logits, tpool = tw.decode_verify(tpool, toks, pos)
    jgreedy, jlogits, _ = jw.decode_verify(jpool, toks, pos)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(greedy, np.asarray(jgreedy))
    assert tw.verify_calls == 1 and tw.decode_calls == 0
    for t in range(3):
        _, lg, seq_pool = tw.decode_pool(seq_pool, toks[:, t: t + 1], np.minimum(pos + t, 48))
        np.testing.assert_allclose(logits[:3, t].numpy(), lg[:3].numpy(), atol=TOL, rtol=TOL)
    for name in tpool:  # the caches agree where the writes landed
        np.testing.assert_allclose(tpool[name][:, :3].numpy(), seq_pool[name][:, :3].numpy(),
                                   atol=TOL, rtol=TOL)


def test_ssm_decode_rejects_multi_position():
    _, _, tcfg, tp = _pair("mamba2-2.7b")
    w = ModelWorker("m", tcfg, tp, max_len=48)
    _, g = w.prefill_batch(np.ones((2, 8), np.int32))
    pool = w.write_slots(w.init_pool(2), g, np.arange(2))
    with pytest.raises(ValueError, match="single-token"):
        w.decode_verify(pool, np.ones((2, 3), np.int32), np.full(2, 8, np.int32))


def test_sample_grid_matches_sequential_sample_one():
    """The verify grid's draw for token index i equals the scalar
    ``sample_one`` plain decode would have made, per slot and position."""
    class Seq:
        def __init__(self, uid, n):
            self.rng = sampling.stream_key(0, "m", uid)
            self.tokens = [0] * n  # only len() feeds the stream index

    r = np.random.RandomState(3)
    seqs = [Seq(uid, int(r.randint(0, 9))) for uid in range(5)]
    logits = torch.from_numpy(r.randn(5, 4, 512).astype(np.float32))
    grid = sampling.sample_grid(seqs, logits, temperature=0.7)
    assert grid.shape == (5, 4)
    for b, seq in enumerate(seqs):
        n0 = len(seq.tokens)
        for t in range(4):
            seq.tokens = [0] * (n0 + t)
            assert grid[b, t] == sampling.sample_one(seq, logits[b, t], 0.7)


# ---------------------------------------------------------------------------
# the scheduled trace replay against the JAX engine
# ---------------------------------------------------------------------------


@functools.cache
def _scheduled_runs(kind, seed=1):
    """(port run, JAX run) of the scheduled trace replay on the 6-layer
    target, with draft ``kind`` (None: no draft)."""
    jcfg, jp, tcfg, tp = _pair("tinyllama-1.1b", DEEP)
    jd = td = None
    if kind is not None:
        jp, jd, tp, td = _draft(kind, DEEP)
    return (_serve(True, tcfg, tp, td, scheduled=True, seed=seed),
            _serve(False, jcfg, jp, jd, scheduled=True, seed=seed))


@pytest.mark.parametrize("kind", ["truncated", "losing"])
def test_scheduled_spec_trace_matches_jax_engine(kind):
    (_, teng, tout), (_, jeng, jout) = _scheduled_runs(kind)
    assert len(tout) == 6 and all(r.error is None for r in tout)
    _same_engine_run(teng, tout, jeng, jout)
    c = teng.ledger.counters
    assert c["spec_rounds"] > 0 and teng.ledger.select(kind="spec_verify")
    assert teng.workers["m"].verify_calls == c["spec_rounds"]
    if kind == "truncated":
        assert c["spec_accepted"] == c["spec_drafted"] > 0
    # every joule a round charges lands on the ledger and in the requests
    charged = fold_energy(e for e in teng.ledger.events
                          if e.kind in ("prefill", "decode", "spec_draft", "spec_verify"))
    assert charged.total_j == pytest.approx(sum(r.energy_j_pred for r in tout), rel=1e-9)


def test_trace_without_draft_matches_jax_engine():
    (_, teng, tout), (_, jeng, jout) = _scheduled_runs(None)
    _same_engine_run(teng, tout, jeng, jout)
    assert teng.spec == {} and teng.admission.spec_log == []
    # virtual latencies: arrival at t = 0, so each is its completion time
    assert max(r.latency_s for r in tout) < 1e3


def test_spec_decision_declines_losing_draft():
    """A draft whose proposals never match collapses the acceptance
    estimate until the EDP rule declines rounds (spec_fallbacks); the
    engine falls back to plain steps and the tokens stay those of the
    draft-less trace."""
    (base, _, _), _ = _scheduled_runs(None)
    (spec, eng, _), _ = _scheduled_runs("losing")
    assert spec == base
    assert eng.ledger.counters["spec_fallbacks"] > 0
    assert any(d["reason"] == "spec-edp-loses" for d in eng.admission.spec_log)


@pytest.mark.parametrize("k,alpha,draft_scale", [(3, 1.0, 0.01), (3, 1.0, 1.0), (1, 0.3, 0.1),
                                                 (4, 0.9, 0.2)])
def test_spec_decision_arithmetic_matches_jax(k, alpha, draft_scale):
    base = {"step_latency": 1.0, "step_energy": 1.0, "batch": 4}
    draft = {"step_latency": draft_scale, "step_energy": draft_scale, "batch": 4}
    got = AdmissionPolicy(scheduler=object()).spec_decision(base, draft, k, alpha)
    assert got == JaxPolicy(scheduler=object()).spec_decision(base, draft, k, alpha)
    assert AdmissionPolicy().spec_decision(base, draft, k, alpha) == (True, "no-scheduler")


# ---------------------------------------------------------------------------
# token identity with the port's own plain decode, and draft=None
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("kind", ["truncated", "random"])
def test_spec_token_identical_to_plain_decode(kind, temperature):
    """FIFO serving (a scheduler-less engine always speculates): rejected
    suffixes roll back, and sampled draws depend only on (stream, token
    index), so the served tokens are the plain decode's."""
    _, _, tcfg, _ = _pair("tinyllama-1.1b")
    _, _, tp, td = _draft(kind)
    base, _, _ = _serve(True, tcfg, tp, temperature=temperature)
    spec, eng, _ = _serve(True, tcfg, tp, td, temperature=temperature)
    assert spec == base
    c = eng.ledger.counters
    assert c["spec_rounds"] > 0
    if kind == "truncated":
        assert c["spec_accepted"] == c["spec_drafted"] > 0
    elif temperature == 0.0:
        assert c["spec_accepted"] < c["spec_drafted"]  # rejected drafts rolled back


def test_adaptive_k_window_bounded():
    _, _, tcfg, _ = _pair("tinyllama-1.1b")
    _, _, tp, td = _draft("random")
    _, eng, _ = _serve(True, tcfg, tp, td, spec=SpecConfig(window=3), seed=2)
    assert eng.ledger.counters["spec_rounds"] > 0
    for pool in eng.pools.values():
        for seq in pool.active.values():
            assert len(seq.spec_hist) <= 3


def test_draft_none_is_inert():
    """No draft: no spec state, counters, events or launches of the verify."""
    _, _, tcfg, tp = _pair("tinyllama-1.1b")
    _, eng, _ = _serve(True, tcfg, tp)
    assert eng.spec == {} and eng.admission.spec_log == []
    assert not any(k.startswith("spec") for k in eng.ledger.counters)
    assert not any(e.kind.startswith("spec") for e in eng.ledger.events)
    assert eng.workers["m"].verify_calls == 0


def test_truncated_draft_shares_weights_and_leaves_the_model_alone():
    _, _, tcfg, tp = _pair("tinyllama-1.1b")
    before = {n: p.clone() for n, p in tp.named_parameters()}
    dcfg, draft, target = truncated_draft(tcfg, tp)
    assert dcfg.num_layers == 1 and len(draft.layers) == 1
    for n, p in tp.named_parameters():
        assert torch.equal(p, before[n])

    def shared(a, b):
        return a.data_ptr() == b.data_ptr()
    assert shared(draft.embedding, tp.embedding)
    assert shared(draft.layers[0].attn.wq.weight, tp.layers[0].attn.wq.weight)
    assert shared(target.layers[0].attn.wo.weight, tp.layers[0].attn.wo.weight)
    assert shared(target.layers[1].attn.wq.weight, tp.layers[1].attn.wq.weight)
    assert not target.layers[1].attn.wo.weight.any()
    assert not target.layers[1].mlp.w_down.weight.any()


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_draft_validation_rejects_ssm():
    _, _, tcfg, tp = _pair("tinyllama-1.1b")
    _, _, mcfg, mp = _pair("mamba2-2.7b")
    with pytest.raises(ValueError, match="non-attention"):
        ServingEngine(max_slots=2).add_model("m", tcfg, tp, draft=(mcfg, mp))
    with pytest.raises(ValueError, match="non-attention"):
        ServingEngine(max_slots=2).add_model("m", mcfg, mp, draft=(tcfg, tp))


def test_draft_validation_rejects_vocab_mismatch():
    _, _, tcfg, tp = _pair("tinyllama-1.1b")
    bad = dataclasses.replace(tcfg, name="bad-vocab", vocab_size=tcfg.vocab_size * 2,
                              num_layers=1)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(max_slots=2).add_model("m", tcfg, tp,
                                             draft=(bad, init_params(bad, 0, "cpu")))


def test_run_trace_refuses_unknown_models_and_no_scheduler():
    _, _, tcfg, tp = _pair("tinyllama-1.1b")
    with pytest.raises(ValueError, match="scheduler"):
        ServingEngine().run_trace([])
    eng = ServingEngine(scheduler=_scheduler([tcfg], port=True))
    eng.add_model("m", tcfg, tp, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="no registered worker"):
        eng.run_trace([(0.0, "other", Request(0, np.ones(4, np.int32), 2))])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b", "mamba2-2.7b"])
def test_param_counts_match_jax(arch):
    j, t = jax_configs.get_config(arch), configs.get_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (configs.reduced(t).active_param_count()
            == jax_configs.reduced(j).active_param_count())
