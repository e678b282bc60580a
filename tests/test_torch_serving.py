"""Serving engine of the PyTorch port against the JAX engine, both with
``scheduler=None`` in continuous mode, on converted weights and the same
requests; and the port's own invariants (batched admission prefill equals
serial, error responses, sampling streams)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the GPU machine has no JAX

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.coexec import CoexecPlanner  # noqa: E402
from repro_torch.core.profiler import RuntimeEnergyProfiler  # noqa: E402
from repro_torch.core.simulator import DeviceSim  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import AdaOperScheduler  # noqa: E402
from repro_torch.serving.slots import Request, _ActiveSeq  # noqa: E402

ARCHS = ["tinyllama-1.1b", "gemma2-2b"]
# (prompt length, max_new_tokens): three same-length pairs, mixed budgets,
# and one request that can never fit max_len
MIXED = [(12, 4), (20, 6), (12, 2), (16, 5), (20, 1), (16, 6), (40, 16)]
MAX_LEN = 48


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = jax_configs.reduced(jax_configs.get_config(arch))
        tcfg = configs.reduced(configs.get_config(arch))
        jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
        out[arch] = (jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return out


def _requests(make, cfg, base_uid, seed):
    r = np.random.default_rng(seed)
    return [make(base_uid + i, r.integers(1, cfg.vocab_size, plen, dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(MIXED)]


def _serve(eng, models, port, temperature=0.0, reverse=False):
    for k, arch in enumerate(ARCHS):
        jcfg, jp, tcfg, tp = models[arch]
        cfg, params = (tcfg, tp) if port else (jcfg, jp)
        eng.add_model(arch, cfg, params, max_len=MAX_LEN)
        reqs = _requests(Request if port else JaxRequest, cfg, 100 * k, seed=k)
        for r in reversed(reqs) if reverse else reqs:
            eng.submit(arch, r)
    return {r.uid: r for r in eng.run_all(temperature=temperature)}


def test_port_engine_matches_jax_engine(models):
    """Same tokens per uid, same admission log, same prefill batches and
    the same ledger events, with two models sharing 4 slots each."""
    jeng, teng = JaxEngine(max_slots=4), ServingEngine(max_slots=4)
    jres, tres = _serve(jeng, models, port=False), _serve(teng, models, port=True)
    assert sorted(tres) == sorted(jres) == sorted(
        100 * k + i for k in range(len(ARCHS)) for i in range(len(MIXED)))
    for uid, r in jres.items():
        assert (tres[uid].error is None) == (r.error is None)
        np.testing.assert_array_equal(tres[uid].tokens, r.tokens)
    assert teng.admission.log == jeng.admission.log
    assert teng.prefill_batches == jeng.prefill_batches
    assert teng.prefill_batch_requests == jeng.prefill_batch_requests
    for kind in ("request", "rejected"):
        assert ([(e.model, e.uid) for e in teng.ledger.select(kind)]
                == [(e.model, e.uid) for e in jeng.ledger.select(kind)])
    assert teng.ledger.counters == jeng.ledger.counters
    assert all(not p.active and p.alloc.n_free == 4 for p in teng.pools.values())


def test_engine_tokens_equal_worker_generate(models):
    """Each request served in the slot pool (ragged decode, batched
    admission) decodes the same greedy tokens as the worker's own
    batch-of-one ``generate``."""
    eng = ServingEngine(max_slots=4)
    res = _serve(eng, models, port=True)
    for k, arch in enumerate(ARCHS):
        w = eng.workers[arch]
        for req in _requests(Request, w.cfg, 100 * k, seed=k)[:-1]:
            ref = w.generate(req.prompt[None], req.max_new_tokens)[0]
            np.testing.assert_array_equal(res[req.uid].tokens, ref)


def test_batched_admission_prefill_equals_serial(models):
    batched, serial = ServingEngine(max_slots=8), ServingEngine(max_slots=8, batch_prefill=False)
    rb, rs = _serve(batched, models, port=True), _serve(serial, models, port=True)
    for uid in rb:
        np.testing.assert_array_equal(rb[uid].tokens, rs[uid].tokens)
    assert batched.prefill_batches < serial.prefill_batches
    assert batched.prefill_batch_requests == serial.prefill_batch_requests


def test_oversized_request_gets_an_error_response(models):
    eng = ServingEngine(max_slots=2)
    res = _serve(eng, models, port=True)
    bad = res[len(MIXED) - 1]
    assert "exceeds max_len" in bad.error and bad.tokens.shape == (0,)
    good = [r for r in res.values() if r.error is None]
    assert len(good) == 2 * (len(MIXED) - 1)
    assert all(len(r.tokens) == MIXED[r.uid % 100][1] for r in good)
    assert eng.ledger.counters["rejected"] == 2


def test_sampling_streams_keep_the_contract(models):
    """Batched draw == scalar draws; the tokens of a uid do not depend on
    admission order or slot placement; another seed draws other tokens."""
    r = np.random.default_rng(0)
    logits = torch.from_numpy(r.standard_normal((3, 50)).astype(np.float32))
    seqs = [_ActiveSeq(Request(i, np.ones(2, np.int32)), i, 2) for i in range(3)]
    for i, s in enumerate(seqs):
        s.rng = sampling.stream_key(5, "m", i)
        s.tokens = [0] * i
    assert sampling.sample_batch(seqs, logits, 0.8) == [
        sampling.sample_one(s, logits[i], 0.8) for i, s in enumerate(seqs)]
    fwd = _serve(ServingEngine(max_slots=3, sampling_seed=5), models, True, temperature=0.8)
    rev = _serve(ServingEngine(max_slots=3, sampling_seed=5), models, True, temperature=0.8,
                 reverse=True)
    other = _serve(ServingEngine(max_slots=3, sampling_seed=6), models, True, temperature=0.8)
    for uid in fwd:
        np.testing.assert_array_equal(fwd[uid].tokens, rev[uid].tokens)
    assert any(not np.array_equal(fwd[u].tokens, other[u].tokens) for u in fwd)


def test_deadline_miss_ends_in_an_error_response(models):
    jcfg, jp, tcfg, tp = models["tinyllama-1.1b"]
    eng = ServingEngine(max_slots=2)
    eng.add_model("m", tcfg, tp, max_len=MAX_LEN)
    eng.submit("m", Request(0, np.ones(8, np.int32), 4, deadline_s=0.0))
    eng.submit("m", Request(1, np.ones(8, np.int32), 4))
    res = {r.uid: r for r in eng.run_all()}
    assert "deadline exceeded" in res[0].error and res[1].error is None
    assert eng.ledger.counters["deadline_requeues"] == 1
    assert eng.ledger.counters["deadline_misses"] == 1


def test_unported_paths_raise_naming_the_roadmap():
    # the bucketed mode is ported (tests/test_torch_bucketed.py); an unknown
    # mode is refused as the reference refuses it
    assert ServingEngine(mode="bucketed").mode == "bucketed"
    with pytest.raises(ValueError, match="unknown serving mode"):
        ServingEngine(mode="pipelined")
    # sharded serving is not: a fleet replay given a mesh context says so
    from repro_torch.fleet import DeviceReplay, sample_population

    class MeshCtx:
        mesh = object()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DeviceReplay(sample_population(1)[0], {}, backend="serving", serving_ctx=MeshCtx())
    # joint planning is ported (tests/test_torch_coexec.py): coexec= is accepted
    planner = CoexecPlanner()
    assert AdaOperScheduler(RuntimeEnergyProfiler(), DeviceSim(), coexec=planner).coexec is planner
    # speculative drafts and run_trace are ported (tests/test_torch_speculative.py);
    # a trace replay still needs a scheduler to advance its virtual clock
    with pytest.raises(ValueError, match="scheduler"):
        ServingEngine().run_trace([])


def test_serve_entry_point_on_cpu(capsys):
    report = serve_cli.main(["--device", "cpu", "--requests", "3", "--prompt-lens", "8,12",
                             "--max-new", "3", "--max-slots", "2", "--no-scheduler"])
    assert report["scheduler"] == "fifo"
    assert report["requests"] == 6 and report["errors"] == 0 and report["tokens"] == 18
    for m in report["models"].values():
        assert m["prefill_calls"] >= 1 and m["decode_calls"] >= 2
    assert '"requests": 6' in capsys.readouterr().out
