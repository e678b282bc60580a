"""Serving driver of the port: several models served concurrently by one
continuous engine, FIFO admission (no scheduler yet).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --models tinyllama-1.1b,gemma2-2b --requests 8 --full

runs the full published configs on the card (bf16, seeded random
weights); the default ``--reduced`` runs the CPU-sized variants, and
``--device cpu`` runs on the CPU with the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.base import reduced as make_reduced
from repro_torch.models.model import init_params, resolve_device
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.slots import Request


def build_engine(names: Sequence[str], requests: int = 8, prompt_lens: Sequence[int] = (32,),
                 max_new: int = 8, max_slots: int = 8, max_len: int = 64, seed: int = 0,
                 device="cuda", full: bool = False) -> ServingEngine:
    """One engine serving ``names`` (seed-initialised weights on ``device``)
    with ``requests`` per model queued, prompt lengths drawn from
    ``prompt_lens``."""
    dev = resolve_device(device)
    eng = ServingEngine(max_slots=max_slots)
    rng = np.random.default_rng(seed)
    for n in names:
        cfg = get_config(n) if full else make_reduced(get_config(n))
        eng.add_model(n, cfg, init_params(cfg, seed, dev), max_len=max_len)
        for i in range(requests):
            plen = int(rng.choice(prompt_lens))
            eng.submit(n, Request(uid=i, max_new_tokens=max_new,
                                  prompt=rng.integers(1, cfg.vocab_size, plen, dtype=np.int32)))
    return eng


def serve(names: Sequence[str], requests: int = 8, prompt_lens: Sequence[int] = (32,),
          max_new: int = 8, max_slots: int = 8, max_len: int = 64, seed: int = 0,
          device="cuda", full: bool = False):
    """Build the engine and serve every queued request. Returns (engine,
    responses, report dict)."""
    dev = resolve_device(device)
    eng = build_engine(names, requests, prompt_lens, max_new, max_slots, max_len, seed, dev,
                       full)
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
        per_model[n] = {"prefill_calls": w.prefill_calls, "decode_calls": w.decode_calls,
                        "rounds": len(eng.stats[n])}
    report = {
        "device": str(dev), "full": full, "requests": len(responses),
        "errors": sum(r.error is not None for r in responses),
        "tokens": int(sum(len(r.tokens) for r in responses)),
        "wall_s": wall, "prefill_batches": eng.prefill_batches, "models": per_model,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
    }
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
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--full", dest="full", action="store_true",
                      help="full published configs (bf16)")
    size.add_argument("--reduced", dest="full", action="store_false",
                      help="CPU-sized variants (fp32, the default)")
    args = ap.parse_args(argv)
    _, _, report = serve(args.models.split(","), args.requests,
                         [int(x) for x in args.prompt_lens.split(",")], args.max_new,
                         args.max_slots, args.max_len, args.seed, args.device, args.full)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
