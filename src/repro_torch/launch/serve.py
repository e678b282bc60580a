"""Serving driver of the port: several models served concurrently by one
continuous engine under AdaOper energy-aware scheduling (the default, as in
``repro.launch.serve``), or FIFO admission with ``--no-scheduler``.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --models tinyllama-1.1b,gemma2-2b,mamba2-2.7b --requests 8 --full

runs the full published configs on the card (bf16, seeded random
weights); ``--layers chameleon-34b=8`` cuts a model to its first layers
where the full depth does not fit the card; an encoder-decoder model
(seamless-m4t-medium) gets seeded frame embeddings of ``--enc-lens``
frames per request, as ``repro.launch.serve`` gives it its stub
frontend's frames, in a cross-attention region of ``--max-enc-len``; the
default ``--reduced`` runs the CPU-sized variants, and ``--device cpu``
runs on the CPU with the kernels' plain versions. The scheduler prices
every step against ``DeviceSim(--workload)`` with a runtime energy
profiler calibrated offline on the models' op graphs; the
joules in the report are that simulator's predictions for a mobile SoC's
CPU, GPU and bus rails, not energy drawn by the device that serves.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.base import reduced as make_reduced
from repro_torch.core.coexec import CoexecPlanner
from repro_torch.core.opgraph import build_transformer_graph
from repro_torch.core.profiler import RuntimeEnergyProfiler
from repro_torch.core.simulator import PRESETS, DeviceSim
from repro_torch.models.model import init_params, resolve_device
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import AdaOperScheduler
from repro_torch.serving.slots import Request
from repro_torch.sharding.context import ExecContext


CALIB_SAMPLES = 1200  # the offline calibration pass of repro.launch.serve


def make_scheduler(cfgs, prompt_len: int, max_new: int, workload: str = "moderate",
                   seed: int = 0, coexec: bool = False) -> AdaOperScheduler:
    """``AdaOperScheduler`` over ``DeviceSim(workload)`` with a profiler
    calibrated offline (the GBDT pass) on each config's batch-4 op graph at
    ``prompt_len + max_new``, as ``repro.launch.serve`` calibrates; with
    ``coexec`` it plans the busy models jointly through a ``CoexecPlanner``."""
    graphs = [build_transformer_graph(c, 4, prompt_len + max_new) for c in cfgs]
    profiler = RuntimeEnergyProfiler(seed=seed)
    profiler.offline_calibrate(graphs, n_samples=CALIB_SAMPLES)
    return AdaOperScheduler(profiler, DeviceSim(workload, seed=seed),
                            coexec=CoexecPlanner() if coexec else None)


def model_configs(names: Sequence[str], full: bool, layers: Optional[Dict[str, int]] = None):
    """Each model's config, full or reduced, cut to ``layers[name]`` layers
    where given."""
    cfgs = {n: get_config(n) if full else make_reduced(get_config(n)) for n in names}
    for n, depth in (layers or {}).items():
        cfgs[n] = dataclasses.replace(cfgs[n], num_layers=min(depth, cfgs[n].num_layers))
    return cfgs


def build_engine(names: Sequence[str], requests: int = 8, prompt_lens: Sequence[int] = (32,),
                 max_new: int = 8, max_slots: int = 8, max_len: int = 64, seed: int = 0,
                 device="cuda", full: bool = False,
                 scheduler: Optional[AdaOperScheduler] = None,
                 layers: Optional[Dict[str, int]] = None, enc_lens: Sequence[int] = (16,),
                 max_enc_len: Optional[int] = None, ctx: ExecContext = ExecContext(),
                 mode: str = "continuous") -> ServingEngine:
    """One engine serving ``names`` (seed-initialised weights on ``device``)
    with ``requests`` per model queued, prompt lengths drawn from
    ``prompt_lens``, uids ``k * requests + i`` for the k-th model (so that a
    response's uid names its model); FIFO admission unless a ``scheduler``
    is given; ``layers`` cuts models as ``model_configs`` does. An
    encoder-decoder model's requests carry N(0, 0.1) frame embeddings
    (frames, d_model), ``frames`` drawn from ``enc_lens``, in a slot pool
    whose cross-attention region is ``max_enc_len`` (``max_len`` if None).
    ``ctx`` is every worker's context: with a mesh, each model is drawn as
    this process's shard (``init_params(ctx=...)``: its model axis, and
    its data axis with FSDP) and served sharded, data-parallel on a data
    axis above one (continuous mode); ``mode`` is the engine's serving
    mode."""
    dev = resolve_device(device)
    eng = ServingEngine(scheduler=scheduler, max_slots=max_slots, mode=mode)
    rng = np.random.default_rng(seed)
    for k, (n, cfg) in enumerate(model_configs(names, full, layers).items()):
        eng.add_model(n, cfg, init_params(cfg, seed, dev, ctx=ctx), max_len=max_len,
                      max_enc_len=max_enc_len, ctx=ctx)
        for i in range(requests):
            plen = int(rng.choice(prompt_lens))
            enc = None
            if cfg.is_encoder_decoder:
                frames = int(rng.choice(enc_lens))
                enc = (rng.standard_normal((frames, cfg.d_model)) * 0.1).astype(np.float32)
            eng.submit(n, Request(uid=k * requests + i, max_new_tokens=max_new,
                                  prompt=rng.integers(1, cfg.vocab_size, plen, dtype=np.int32),
                                  enc_inputs=enc))
    return eng


def scheduler_report(eng: ServingEngine, workload: str) -> dict:
    """What the scheduler decided and what the simulated device was charged."""
    sch = eng.scheduler
    label = f"simulated (DeviceSim {workload})"
    return {
        "plan_cache": {"hits": sch.plan_cache_hits, "misses": sch.plan_cache_misses},
        "admission_reasons": dict(Counter(r["reason"] for r in eng.admission.log)),
        "drift_events": eng.drift_events,
        "preemptions": dict(eng.preemptions),
        "energy_j": {
            "label": label,
            "per_model": {m: e.total_j for m, e in eng.ledger.energy_by_model("request").items()},
            "per_rail": eng.ledger.total_energy("request").rails_dict(),
            "events": dict(Counter(e.kind for e in eng.ledger.events)),
        },
    }


def serve(names: Sequence[str], requests: int = 8, prompt_lens: Sequence[int] = (32,),
          max_new: int = 8, max_slots: int = 8, max_len: int = 64, seed: int = 0,
          device="cuda", full: bool = False, scheduler: bool = True,
          workload: str = "moderate", layers: Optional[Dict[str, int]] = None,
          enc_lens: Sequence[int] = (16,), max_enc_len: Optional[int] = None,
          ctx: ExecContext = ExecContext(), mode: str = "continuous"):
    """Build the engine and serve every queued request. Returns (engine,
    responses, report dict). ``ctx`` and ``mode`` as ``build_engine``'s: a
    mesh in ``ctx`` serves sharded, each rank of the mesh calling
    ``serve`` in a process of its own (``launch.sharded.run_ranks``)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    sched = (make_scheduler(model_configs(names, full, layers).values(), max(prompt_lens),
                            max_new, workload, seed) if scheduler else None)
    calibration_s = time.perf_counter() - t0
    eng = build_engine(names, requests, prompt_lens, max_new, max_slots, max_len, seed, dev,
                       full, sched, layers, enc_lens, max_enc_len, ctx, mode)
    init_s = time.perf_counter() - t0 - calibration_s
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    responses = eng.run_all()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    per_model: Dict[str, dict] = {}
    for n, w in eng.workers.items():
        per_model[n] = {"layers": w.cfg.num_layers, "prefill_calls": w.prefill_calls,
                        "decode_calls": w.decode_calls, "rounds": len(eng.stats[n])}
    report = {
        "device": str(dev), "full": full,
        "scheduler": "adaoper" if eng.scheduler is not None else "fifo",
        "requests": len(responses),
        "errors": sum(r.error is not None for r in responses),
        "tokens": int(sum(len(r.tokens) for r in responses)),
        "calibration_s": calibration_s, "init_s": init_s, "wall_s": wall,
        "prefill_batches": eng.prefill_batches,
        "models": per_model,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
    }
    if eng.scheduler is not None:
        report.update(scheduler_report(eng, workload))
    return eng, responses, report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="tinyllama-1.1b,gemma2-2b")
    ap.add_argument("--requests", type=int, default=8, help="requests per model")
    ap.add_argument("--prompt-lens", default="32",
                    help="comma-separated prompt lengths, drawn per request")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workload", default="moderate", choices=sorted(PRESETS),
                    help="DeviceSim preset the scheduler prices against")
    ap.add_argument("--no-scheduler", action="store_true",
                    help="FIFO admission, no energy accounting")
    ap.add_argument("--layers", default="",
                    help="comma-separated NAME=N: serve model NAME cut to its first N layers")
    ap.add_argument("--enc-lens", default="16",
                    help="comma-separated encoder frame counts, drawn per encoder-decoder "
                         "request")
    ap.add_argument("--max-enc-len", type=int, default=None,
                    help="encoder-decoder cross-attention region per slot (default max-len)")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--full", dest="full", action="store_true",
                      help="full published configs (bf16)")
    size.add_argument("--reduced", dest="full", action="store_false",
                      help="CPU-sized variants (fp32, the default)")
    args = ap.parse_args(argv)
    layers = {n: int(d) for n, d in (x.split("=") for x in args.layers.split(",") if x)}
    _, _, report = serve(args.models.split(","), args.requests,
                         [int(x) for x in args.prompt_lens.split(",")], args.max_new,
                         args.max_slots, args.max_len, args.seed, args.device, args.full,
                         not args.no_scheduler, args.workload, layers,
                         [int(x) for x in args.enc_lens.split(",")], args.max_enc_len)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
