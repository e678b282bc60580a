"""Sharded serving over a model axis of N ranks, started from one parent
process: ``run_ranks`` spawns the ranks (the ``spawn`` start method), joins
them to one process group (``launch.mesh.init_ranks``, a ``FileStore`` in
a temporary directory, no network), runs ``fn(rank, *args)`` in each and
returns the ranks' results. A rank that raises, exits nonzero or outlives
the time limit fails the whole call: every rank's exit code is read, and
a rank still running at the limit is killed.

``generate_rank`` is one such ``fn``: for each job, a ``ModelWorker`` on a
(1, N) debug mesh that runs ``generate`` on the rank's shard of a model
whose weights come from a tree of numpy arrays in the JAX package's layout
(``convert.params_from_numpy``). Both run on the card unless the caller
asks for the CPU (``device_type="cpu"``, gloo).
"""
from __future__ import annotations

import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch.multiprocessing as mp


def _rank_main(fn, rank, world, device_type, store_dir, args, results):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks
    try:
        init_ranks(world, rank, device_type, store_dir)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), timeout: float = 600.0,
              device_type: str = "cuda") -> List[Any]:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each run in a rank
    process of one process group. ``fn`` and ``args`` must pickle (``fn``
    importable by name); each result comes back pickled. ``device_type``
    "cuda" gives each rank a card (rank modulo the cards there are; NCCL
    when there are enough, else gloo), "cpu" runs the ranks on the CPU
    over gloo."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as store_dir:
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(fn, r, world, device_type, store_dir, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            while len(got) + len(errors) < world:  # drain before joining
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 5.0))
                except queue_mod.Empty:
                    if not any(p.is_alive() for p in procs):
                        break
                    continue
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()) + 5.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10.0)
        codes = [p.exitcode for p in procs]
    if errors or len(got) < world or any(c != 0 for c in codes):
        raise RuntimeError(f"sharded run failed (exit codes {codes}, {len(got)} of {world} "
                           f"results within {timeout} s)" + "".join("\n" + e for e in errors))
    return [got[r] for r in range(world)]


def generate_rank(rank: int, jobs: Sequence[dict], world: int,
                  device: str = "cuda") -> List[dict]:
    """One rank of sharded ``ModelWorker.generate`` runs on ``device``, one
    per job: ``cfg``, a numpy ``tree`` in the JAX package's layout,
    ``prompts`` (B, S), ``max_new`` and ``max_len``. The model is cut to
    this rank's shard on a (1, ``world``) mesh. Returns per job the tokens
    and the worker's sharding report's counts."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serving.workers import ModelWorker
    from repro_torch.sharding.context import ExecContext
    ctx = ExecContext(mesh=make_debug_mesh(1, world, device), batch_axes=("data",),
                      model_axis="model")
    out = []
    for job in jobs:
        cfg = job["cfg"]
        worker = ModelWorker(f"{cfg.name} rank {rank}", cfg,
                             params_from_numpy(job["tree"], cfg, device), job["max_len"], ctx)
        out.append({"tokens": worker.generate(job["prompts"], job["max_new"]),
                    "sharded": worker.shard_report.sharded,
                    "replicated": worker.shard_report.replicated,
                    "shard": worker.params.shard})
    return out
