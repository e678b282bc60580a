"""Sharded serving and training over a (data, model) mesh of N ranks,
started from one parent process: ``run_ranks`` spawns the ranks (the ``spawn`` start method), joins
them to one process group (``launch.mesh.init_ranks``, a ``FileStore`` in
a temporary directory, no network), runs ``fn(rank, *args)`` in each and
returns the ranks' results. A rank that raises, exits nonzero or outlives
the time limit fails the whole call: every rank's exit code is read, and
a rank still running at the limit is killed, as are the others at once
when one raises (they may be waiting on it in a collective).

``generate_rank`` is one such ``fn``: for each job, a ``ModelWorker`` on a
(1, N) debug mesh, or a (D, M) or (P, D, M) one, that runs ``generate``
(the bucketed mode: encoder frames and a pad mask where the job has them)
on the rank's shard of a model whose weights come from a tree of numpy
arrays in the JAX package's layout (``convert.params_from_numpy``).
``engine_rank`` runs the serving engine on such a mesh, continuous or
bucketed, FIFO or scheduled, with a speculative draft where the job asks
for one (``serve_job``), or a fleet replay with the serving backend
(``fleet_job``). Every family the port serves takes a model axis of M > 1
in both. ``train_rank`` is another: for each job,
a few AdamW steps of the rank's shard on a (D, M) mesh (``train_loop``),
with the step-0 gradients and the final weights gathered whole on request
and a checkpoint saved or restored. Both run on the card unless the
caller asks for the CPU (``device_type="cpu"``, gloo).
"""
from __future__ import annotations

import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch.multiprocessing as mp


def _rank_main(fn, rank, world, device_type, store_dir, args_path, results):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
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
    over gloo. ``args`` reach the ranks through a file: a process's start
    would otherwise wait, for arguments larger than a pipe holds, until the
    rank has read them, so the ranks would start one after another."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as store_dir:
        args_path = os.path.join(store_dir, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(fn, r, world, device_type, store_dir, args_path, results))
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
                else:  # the others may wait on it in a collective: stop them
                    errors.append(f"rank {rank}:\n{out}")
                    break
            end = time.monotonic() + 2.0 if errors else deadline + 5.0
            for p in procs:  # an infinite timeout (a training run's) joins without one
                left = end - time.monotonic()
                p.join(None if math.isinf(left) else max(0.0, left))
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


def generate_rank(rank: int, jobs: Sequence[dict], world, device: str = "cuda") -> List[dict]:
    """One rank of sharded ``ModelWorker.generate`` runs on ``device``, one
    per job: ``cfg``, a numpy ``tree`` in the JAX package's layout,
    ``prompts`` (B, S), ``max_new`` and ``max_len``, and optionally
    ``enc_inputs`` (B, T, d_model) of an encoder-decoder model and
    ``pad_mask`` (B, S) of LEFT-padded SSM prompts. The model is cut to
    this rank's shard on a (1, ``world``) mesh, or on the mesh of shape
    ``world`` where it is a tuple ((D, M) or (P, D, M)). Returns per job
    the tokens and the worker's sharding report's counts."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import batch_axes_for, mesh_of
    from repro_torch.serving.workers import ModelWorker
    from repro_torch.sharding.context import ExecContext
    dm = mesh_of(world if isinstance(world, tuple) else (1, world), device)
    ctx = ExecContext(mesh=dm, batch_axes=batch_axes_for(dm), model_axis="model")
    out = []
    for job in jobs:
        cfg = job["cfg"]
        worker = ModelWorker(f"{cfg.name} rank {rank}", cfg,
                             params_from_numpy(job["tree"], cfg, device), job["max_len"], ctx)
        out.append({"tokens": worker.generate(job["prompts"], job["max_new"],
                                              enc_inputs=job.get("enc_inputs"),
                                              pad_mask=job.get("pad_mask")),
                    "sharded": worker.shard_report.sharded,
                    "replicated": worker.shard_report.replicated,
                    "shard": worker.params.shard})
    return out


def train_rank(rank: int, jobs: Sequence[dict], mesh: tuple, device: str = "cuda") -> List[dict]:
    """One rank of sharded training on a (D, M) or (P, D, M) = ``mesh``
    debug mesh (the batch cut over every batch axis), one
    run per job, each from a fresh optimizer state. A job holds ``cfg``,
    ``seed`` (weights drawn as this rank's shard by ``init_params(ctx=)``,
    or ``tree``, a numpy tree in the JAX package's layout, cut by
    ``convert.shard_params``), ``batch`` and ``seq`` (the global batch of
    ``SyntheticLM`` with ``data_seed``, 0 by default, and an
    encoder-decoder model's ``enc_frames`` frames per row, whose
    ``enc_inputs`` split over the data ranks with the tokens), ``steps``,
    ``oc`` (an ``OptConfig``), and optionally ``fsdp``, ``plan``
    (``ExecContext.plan``), ``grads`` (return the step-0 gradients
    gathered whole, numpy fp32), ``pieces`` (return this rank's pieces of
    them, tensors on the device, for a caller in the rank's process),
    ``weights`` (return the final weights gathered whole), ``save`` /
    ``restore`` (a checkpoint directory, written after / read before the
    steps) and ``digest`` (return ``piece_digests`` of this rank's piece
    of every param and moment after the steps). Returns per job the
    history rows, the collectives per step (``collectives.counts``; those
    of the step-0 gradient pass too, where it runs), the hand-written
    kernels' launches, the shard, the bytes of this rank's weights, the
    largest |value| in the rows and columns of its params and moments that
    hold pad heads after the steps (``ParamPlan.pad_rows``; 0.0 where it
    holds none) and how many leaves have such rows, and the device bytes
    held when the steps (or the gradient pass before them) begin and at
    their peak (0 on the CPU)."""
    import torch

    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import batch_axes_for, mesh_of
    from repro_torch.models.model import init_params, mesh_rank, train_params
    from repro_torch.sharding import collectives
    from repro_torch.sharding.context import ExecContext
    from repro_torch.sharding.placement import plan_params
    from repro_torch.training.checkpoint import (leaves, restore_checkpoint, save_checkpoint,
                                                 whole)
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import (batch_to_device, loss_and_grads,
                                                 make_train_step, shard_batch)
    dm = mesh_of(mesh, device)
    out = []
    for job in jobs:
        cfg = job["cfg"]
        ctx = ExecContext(mesh=dm, batch_axes=batch_axes_for(dm), model_axis="model",
                          fsdp=job.get("fsdp"), plan=dict(job.get("plan") or {}))
        if "tree" in job:
            params = shard_params(params_from_numpy(job["tree"], cfg, device), ctx)
        else:
            params = init_params(cfg, job["seed"], device, ctx=ctx)
        named = train_params(params)
        state = init_opt_state(named)
        plan = plan_params(cfg, ctx)
        res = {"shard": params.shard, "data_shard": params.data_shard,
               "param_bytes": sum(p.numel() * p.element_size() for p in named.values()),
               "base_mem_bytes": 0}
        if job.get("restore"):
            res["restored_step"] = restore_checkpoint(job["restore"], params, state, ctx)
        data = SyntheticLM(cfg, DataConfig(batch=job["batch"], seq_len=job["seq"],
                                           seed=job.get("data_seed", 0),
                                           enc_frames=job.get("enc_frames",
                                                              DataConfig.enc_frames)))
        dev = next(iter(named.values())).device
        if dev.type == "cuda":  # the peak spans the gradient pass, where it runs, and the steps
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            res["base_mem_bytes"] = torch.cuda.memory_allocated(dev)
        if job.get("grads") or job.get("pieces"):
            before = dict(collectives.counts)
            b = batch_to_device(shard_batch(data.batch(0), cfg, ctx), dev)
            loss, _, grads = loss_and_grads(params, cfg, b, ctx, plan)
            res["grad_collectives"] = {k: v - before.get(k, 0)
                                       for k, v in collectives.counts.items()
                                       if v != before.get(k, 0)}
            if job.get("grads"):
                res["grads"] = {n: whole(g, n, plan, ctx).float().cpu().numpy()
                                for n, g in grads.items()}
            if job.get("pieces"):
                res["pieces"] = grads
            res["local_loss"] = float(loss.detach())
            del grads  # not held into the next job (``pieces`` keeps its own reference)
            for p in named.values():
                p.grad = None
        step_fn = make_train_step(cfg, ctx, job["oc"])
        wrappers = _kernel_wrappers()
        before_launches = {n: w.launches for n, w in wrappers.items()}
        hist, per_step = [], []
        for i in range(job["steps"]):
            before = dict(collectives.counts)
            b = batch_to_device(shard_batch(data.batch(i), cfg, ctx), dev)
            t0 = time.perf_counter()
            row = {k: float(v) for k, v in step_fn(params, state, b).items()}  # waits
            hist.append(dict(row, step_s=time.perf_counter() - t0))
            per_step.append({k: v - before.get(k, 0) for k, v in collectives.counts.items()
                             if v != before.get(k, 0)})
        pads = pad_maxima(leaves(params, state), plan, mesh_rank(ctx))
        res.update(history=hist, collectives=per_step,
                   launches={n: w.launches - before_launches[n] for n, w in wrappers.items()},
                   pad_max=max(pads.values(), default=0.0), pad_leaves=len(pads),
                   peak_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else 0))
        if job.get("digest"):
            res["digest"] = piece_digests(leaves(params, state))
        if job.get("weights"):
            res["weights"] = {n: whole(p.detach(), n, plan, ctx).float().cpu().numpy()
                              for n, p in named.items()}
        if job.get("save"):
            save_checkpoint(job["save"], params, state, step=job["steps"], ctx=ctx)
        out.append(res)
        del params, named, state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def pad_maxima(tensors: dict, plan, rank: int) -> dict:
    """Leaf -> the largest |value| in the rows and columns that hold pad
    heads (``ParamPlan.pad_rows``) of mesh rank ``rank``'s piece, for each
    of ``tensors`` (named as ``training.checkpoint.leaves`` names them)
    that has such rows."""
    from repro_torch.training.checkpoint import param_name
    out = {}
    for leaf, t in tensors.items():
        name = param_name(leaf)
        for lo, hi in plan.pad_rows(name, rank):
            rows = t.detach().narrow(plan.dims[name], lo, hi - lo)
            out[leaf] = max(out.get(leaf, 0.0), float(rows.abs().max()))
    return out


def _kernel_wrappers() -> dict:
    from repro_torch.kernels import decode_attention, flash_attention, mla_attention, ssd_scan
    return {"flash_attention": flash_attention.flash_attention,
            "decode_attention": decode_attention.decode_attention,
            "decode_attention_piece": decode_attention.decode_attention_piece,
            "mla_attention": mla_attention.mla_attention,
            "mla_attention_piece": mla_attention.mla_attention_piece, "ssd_scan": ssd_scan.ssd_scan}


def piece_digests(leaves: dict) -> dict:
    """A SHA-1 of the bytes of each tensor of ``leaves`` (name -> tensor,
    as ``training.checkpoint.leaves`` names a model's params and moments),
    to hold a rank's pieces against those cut from a whole model."""
    import hashlib

    import torch
    out = {}
    for name, t in leaves.items():
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[name] = hashlib.sha1(t.numpy().tobytes()).hexdigest()
    return out


def engine_rank(rank: int, jobs: Sequence[dict], mesh: tuple, device: str = "cuda") -> List[dict]:
    """One rank of the serving engine on a (D, M) or (P, D, M) = ``mesh``
    debug mesh, one engine per job (``serve_job``), or one fleet replay
    for a job that names ``replay`` (``fleet_job``)."""
    from repro_torch.launch.mesh import batch_axes_for, mesh_of
    from repro_torch.sharding.context import ExecContext
    dm = mesh_of(mesh, device)
    out = []
    for job in jobs:
        ctx = ExecContext(mesh=dm, batch_axes=batch_axes_for(dm), model_axis="model",
                          fsdp=job.get("fsdp"), plan=dict(job.get("plan") or {}))
        out.append((fleet_job if "replay" in job else serve_job)(job, ctx, device))
    return out


def _job_params(job, ctx, device):
    """A job's weights: ``params`` (a model, for a caller in this
    process), from its numpy ``tree``, or drawn from its ``seed`` (as this
    rank's shard, but whole where the job takes a truncated draft, which
    is cut from the whole model)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import init_params
    cfg = job["cfg"]
    if "params" in job:
        return job["params"]
    if "tree" in job:
        return params_from_numpy(job["tree"], cfg, device)
    return init_params(cfg, job["seed"], device, ctx=None if job.get("draft") else ctx)


def _launch_counts():
    """The kernels' launches and the merges of sequence-cut decodes: over
    the data group (``merge_attention``) and over a kv group
    (``merge_kv_group``)."""
    from repro_torch.sharding import collectives
    return ({n: w.launches for n, w in _kernel_wrappers().items()},
            (collectives.counts["merge_attention"], collectives.counts["merge_kv_group"]))


def _pool_rows(pool) -> int:
    """The rows of a slot pool's cache on this rank: its share of the
    slots where the data axis splits them, every slot where the cache is
    cut on its sequence."""
    return int(next(iter(pool.cache.values())).shape[1])


def fleet_job(job, ctx, device: str = "cuda") -> dict:
    """One ``FleetReplay`` with the serving backend on ``ctx``: ``cfg`` and
    ``seed`` or ``tree`` the assistant model, ``replay`` the replay's
    keywords (``devices``, the population's size and ``population_seed``,
    beside ``FleetReplay``'s own). Returns the report's ``to_dict()``, each
    device engine's tokens per uid and its worker's (prefill, decode,
    verify) passes, the rows of each device engine's slot pool, the kernels'
    launches and the merges of sequence-cut decodes over the data group
    (``merges``) and over kv groups (``kv_merges``), the wall seconds and
    the peak device bytes (0 on the CPU)."""
    import torch

    from repro_torch import fleet
    from repro_torch.fleet.workloads import ASSISTANT
    kw = dict(job["replay"])
    pop = fleet.sample_population(kw.pop("devices"), seed=kw.pop("population_seed", 0))
    params = _job_params(job, ctx, device)
    dev = params.embedding.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before, merges = _launch_counts()
    t0 = time.perf_counter()
    rep = fleet.FleetReplay(pop, backend="serving", serving_models={ASSISTANT: (job["cfg"], params)},
                            serving_ctx=ctx, **kw)
    report = rep.run().to_dict()
    after, merges_after = _launch_counts()
    out = {"report": report, "wall_s": time.perf_counter() - t0,
            "tokens": [{r.uid: [int(t) for t in r.tokens] for r in dr.responses}
                       for dr in rep.device_replays],
            "calls": [(w.prefill_calls, w.decode_calls, w.verify_calls)
                      for dr in rep.device_replays for w in dr.engine.workers.values()],
            "pool_rows": [_pool_rows(pool) for dr in rep.device_replays
                          for pool in dr.engine.pools.values()],
            "launches": {n: after[n] - before[n] for n in after},
            "merges": merges_after[0] - merges[0], "kv_merges": merges_after[1] - merges[1],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}
    del rep, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def serve_job(job: dict, ctx, device: str = "cuda") -> dict:
    """One continuous engine on ``ctx`` (no mesh: the unsharded run). A job
    holds ``cfg``, ``seed`` (weights drawn as this rank's shard) or
    ``tree`` (a numpy tree in the JAX package's layout), ``requests``
    ((uid, prompt, max_new) triples, or with a fourth entry an
    encoder-decoder request's frames (T, d_model)), ``max_slots``,
    ``max_len``, and optionally ``max_enc_len`` (the cross region per
    slot), ``temperature``, ``fsdp`` and ``plan`` (read by
    ``engine_rank``), ``scheduled`` (the AdaOper scheduler of
    ``launch.serve.make_scheduler`` under ``run_trace``'s virtual clock,
    arrivals 10 ms apart; FIFO ``run_all`` without) and ``logit_prompts``
    (G, S) (with ``logit_frames`` for an encoder-decoder model), whose
    last-position prefill logits it returns after the serve; ``mode``
    ("continuous" by default, or "bucketed": a scheduled bucketed engine
    serves ``run_all`` under the scheduler) and ``draft`` ("truncated":
    ``speculative.truncated_draft`` of the weights, drawn whole). Returns
    the tokens by uid, the worker's pass counts (with the draft's), the
    kernels' launches, the merges of sequence-cut decodes over the data
    group (``merges``) and over kv groups (``kv_merges``), the scheduler's
    bucketed batches, the spec counters, the model axis's collectives (the
    plan knob attn_seq_shard's all-to-alls among them), the wall seconds
    and the peak device bytes (0 on the CPU)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import make_scheduler
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.slots import Request
    from repro_torch.serving.speculative import truncated_draft
    from repro_torch.sharding import collectives
    cfg = job["cfg"]
    params = _job_params(job, ctx, device)
    draft = None
    if job.get("draft") == "truncated":
        dcfg, dparams, params = truncated_draft(cfg, params)
        draft = (dcfg, dparams)
    reqs = [Request(r[0], np.asarray(r[1], np.int32), r[2],
                    enc_inputs=None if len(r) < 4 else np.asarray(r[3], np.float32))
            for r in job["requests"]]
    sched = None
    if job.get("scheduled"):
        sched = make_scheduler([cfg], max(len(r.prompt) for r in reqs),
                               max(r.max_new_tokens for r in reqs))
    mode = job.get("mode", "continuous")
    eng = ServingEngine(scheduler=sched, max_slots=job["max_slots"], mode=mode)
    eng.add_model(cfg.name, cfg, params, max_len=job["max_len"], ctx=ctx,
                  max_enc_len=job.get("max_enc_len"), draft=draft)
    w = eng.workers[cfg.name]
    dev = w.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before, merges = _launch_counts()
    calls = collectives.all_reduce.calls, collectives.all_gather_last.calls
    swaps = collectives.counts["all_to_all"]
    t0 = time.perf_counter()
    temp = job.get("temperature", 0.0)
    if sched is not None and mode == "continuous":
        resp = eng.run_trace([(0.01 * i, cfg.name, r) for i, r in enumerate(reqs)],
                             temperature=temp)
    else:
        for r in reqs:
            eng.submit(cfg.name, r)
        resp = eng.run_all(temperature=temp)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    after, merges_after = _launch_counts()
    spec = eng.spec.get(cfg.name)
    out = {"tokens": {r.uid: [int(t) for t in r.tokens] for r in resp},
           "errors": [r.error for r in resp if r.error],
           "prefill_calls": w.prefill_calls, "decode_calls": w.decode_calls,
           "verify_calls": w.verify_calls,
           "draft_calls": None if spec is None else (spec.worker.prefill_calls,
                                                     spec.worker.decode_calls,
                                                     spec.worker.verify_calls),
           "launches": {n: after[n] - before[n] for n in after},
           "merges": merges_after[0] - merges[0], "kv_merges": merges_after[1] - merges[1],
           "batches": [st["batch"] for st in eng.stats[cfg.name] if "batch" in st],
           "spec": {k: v for k, v in eng.ledger.counters.items() if k.startswith("spec_")},
           "all_reduces": collectives.all_reduce.calls - calls[0],
           "all_gathers": collectives.all_gather_last.calls - calls[1],
           "all_to_alls": collectives.counts["all_to_all"] - swaps,
           "wall_s": time.perf_counter() - t0, "shard": w.params.shard,
           "data_shard": w.params.data_shard,
           "pool_rows": _pool_rows(eng.pools[cfg.name]) if cfg.name in eng.pools else None,
           # the bytes of the rank's parameters and slot pool (``launch.dryrun.rank_bytes``
           # counts them on the meta device)
           "rank_bytes": {"params": sum(p.numel() * p.element_size()
                                        for p in w.params.parameters()),
                          "cache": (sum(t.numel() * t.element_size()
                                        for t in eng.pools[cfg.name].cache.values())
                                    if cfg.name in eng.pools else None)},
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0)}
    if job.get("logit_prompts") is not None:
        logits, _ = w.prefill_batch(np.asarray(job["logit_prompts"], np.int32),
                                    enc_inputs=job.get("logit_frames"))
        out["logits"] = logits.float().cpu().numpy()
    del eng, w, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out
