"""The production mesh's dry run: the counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

For every (arch x shape) of ``ARCHS x SHAPES`` on the production meshes,
(16, 16) = 256 devices over ("data", "model") and with ``--multi-pod``
(2, 16, 16) = 512 over ("pod", "data", "model"), it builds mesh rank 0's
shard of the model, of the optimizer state, of the cache and of the
inputs on the **meta device** (shapes only: nothing is allocated and no
card is needed, ``models.model.init_params`` on ``device="meta"``,
``sharding.placement.init_placed_cache``), on a ``MeshStandIn`` that
places the rank as ``launch.mesh`` would, and runs the shape's step for
that rank under an op counter (``utils.op_cost``):

* ``train_4k``: the forward, the backward and the AdamW step of
  ``training.train_loop.make_train_step`` under the plan's remat policy;
* ``prefill_32k``: ``models.model.prefill`` (the last position's logits);
* ``decode_32k`` / ``long_500k``: one ``decode_step`` at a full cache,
  every row at position S - 1, which is what the reference's scalar
  ``pos`` attends over. A K/V cache whose kv heads are fewer than M, and
  the MLA latent, are cut on their sequence over the model ranks that
  share them (``sharding.placement.plan_cache``); where the data axes do
  not divide the batch (B = 1 at ``long_500k``), every K/V cache and
  latent over the data group too (``ExecContext.kv_seq``). Their decode
  runs the kernels' piece modes and merges the pieces
  (``collectives.merge_kv_group``, ``merge_attention``).

The kernels take their meta route (the card's shape checks, so a shape the
kernels refuse raises here too) and the collectives their meta transport.
The record keeps the reference's keys with the same meanings, per device:
``flops`` and ``bytes_accessed`` (the op counter's), ``collectives`` by
kind and ``collective_bytes`` (result bytes), ``argument_size_in_bytes``
(the rank's parameters, optimizer state, cache and inputs: the scalar
decode position counted as the reference's int32), ``output_size_in_bytes``
(what the step returns: logits and cache, or parameters, optimizer state
and metrics, updated in place: ``alias_size_in_bytes``),
``temp_size_in_bytes`` (the peak of the step's own live storages),
``n_devices``, ``status`` and ``note``; and adds ``kernels`` (per kernel
its calls, FLOPs and bytes by its bound's formula, ``kernels.cost``),
``hbm_fits`` (argument + temp bytes against an H100's 80 GB) and
``ranks_differ`` (whether the argument bytes of the mesh's last model rank,
last data rank or last rank differ from rank 0's). These are counts of the
port's eager step, not measurements: eager runs no fusion, so its bytes
bound a fused step's from above, and the reference's XLA route multiplies
scores the causal mask drops (PERF.md says how the two compare).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import PRODUCTION_DEVICES, batch_axes_for
from repro_torch.models import model as model_lib
from repro_torch.sharding import placement
from repro_torch.sharding.context import ExecContext, MeshStandIn
from repro_torch.utils.op_cost import OpCost

ENC_FRAMES = 512  # audio frontend stub: precomputed frames fed to the encoder
HBM_BYTES = 80 * 10 ** 9  # an H100's device memory
PLANS = ("moe_2d", "remat_policy")  # the reference's plan knobs the port takes
META = torch.device("meta")


def config_for_shape(cfg, shape_name):
    """Returns (cfg', note) — cfg'=None means the pair is skipped (DESIGN.md)."""
    if shape_name != "long_500k":
        return cfg, ""
    if cfg.family == "audio":
        return None, "SKIP: enc-dec speech decoder has no sub-quadratic variant (DESIGN.md)"
    if cfg.family in ("ssm", "hybrid"):
        return cfg, "native sub-quadratic (SSM/hybrid)"
    if cfg.name.startswith("gemma2"):
        pat = tuple("local" for _ in cfg.layer_pattern)
        return dataclasses.replace(cfg, layer_pattern=pat), "swa-variant: global layers windowed at 500k"
    pat = tuple("local" if k in ("attn", "global") else k for k in cfg.layer_pattern)
    return (dataclasses.replace(cfg, layer_pattern=pat,
                                sliding_window=cfg.sliding_window or 8192),
            "swa-variant(window=8192) per brief for dense archs at 500k")


def production_shape(multi_pod: bool) -> dict:
    """The production mesh's axes and sizes."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def check_plan(plan) -> dict:
    """The plan knobs the port takes; ``attn_seq_shard`` (the reference's
    sequence-sharded attention) is not ported."""
    plan = dict(plan or {})
    if plan.get("attn_seq_shard"):
        raise NotImplementedError("the plan knob attn_seq_shard (sequence-sharded attention) is "
                                  "not ported (see ROADMAP.md)")
    unknown = sorted(set(plan) - set(PLANS))
    if unknown:
        raise ValueError(f"unknown plan knobs {unknown}; the port takes {PLANS}")
    return plan


def _rows(B: int, D: int) -> tuple:
    """(rows this rank runs, whether the rows split over the data group)."""
    return (B // D, True) if B % D == 0 else (B, False)


@dataclasses.dataclass
class Step:
    """One rank's step, built on the meta device: ``run()`` runs it and
    returns its outputs; ``args`` are its inputs (parameters, optimizer
    state, cache, inputs); ``scalar_bytes`` the reference's scalar
    arguments (the decode position)."""
    run: object
    args: tuple
    scalar_bytes: int = 0


def rank_context(mesh_shape: dict, rank: int, plan=None, fsdp=None) -> ExecContext:
    """Mesh rank ``rank``'s context on a ``MeshStandIn`` of ``mesh_shape``."""
    mesh = MeshStandIn(mesh_shape, rank)
    return ExecContext(mesh=mesh, batch_axes=batch_axes_for(mesh), model_axis="model",
                       fsdp=fsdp, plan=dict(plan or {}))


def rank_cache(cfg, ctx, batch: int, max_len: int, enc_len: int = 0) -> dict:
    """The rank's piece of a (batch, max_len) cache on the meta device, placed
    as a serving worker places it (``placement.plan_cache``): its rows where
    the data group divides ``batch``, else every row with the K/V and latent
    sequence cut over the data group; at M > 1 the pieces of the kv
    group's sequence."""
    specs = placement.plan_cache(cfg, ctx, batch, max_len, enc_len)
    return placement.init_placed_cache(cfg, ctx, specs, batch, max_len, META, enc_len=enc_len)


def rank_bytes(cfg, mesh_shape: dict, rank: int, batch: int, max_len: int, enc_len: int = 0,
               fsdp=None) -> dict:
    """The bytes of mesh rank ``rank``'s parameters and of its piece of a
    (batch, max_len) cache, counted on the meta device as ``build`` places
    them: what a rank of that mesh allocates for them on the card."""
    ctx = rank_context(mesh_shape, rank, fsdp=fsdp)
    params = model_lib.init_params(cfg, device=META, ctx=ctx, rank=rank)
    return {"params": OpCost().arguments(params),
            "cache": OpCost().arguments(rank_cache(cfg, ctx, batch, max_len, enc_len))}


def build(arch: str, shape_name: str, mesh_shape: dict, plan=None, fsdp=None, rank: int = 0,
          step: bool = True):
    """Returns (Step, note) for mesh rank ``rank`` of ``mesh_shape`` (axis
    name -> size) at (arch, shape): its shard of everything on the meta
    device; ``step=False`` builds the arguments only. (None, note) for a
    pair the reference skips."""
    plan = check_plan(plan)
    cfg, note = config_for_shape(get_config(arch), shape_name)
    if cfg is None:
        return None, note
    shape = SHAPES[shape_name]
    ctx = rank_context(mesh_shape, rank, plan, fsdp)
    D = ctx.batch_parallel
    B, S = shape.global_batch, shape.seq_len
    dt = model_lib.dtype_of(cfg.dtype)
    params = model_lib.init_params(cfg, device=META, ctx=ctx, rank=rank)
    enc = cfg.is_encoder_decoder

    if shape.kind == "train":
        from repro_torch.training.optimizer import init_opt_state
        from repro_torch.training.train_loop import make_train_step
        Bl, split = _rows(B, D)
        if not split:
            raise ValueError(f"a train batch of {B} rows does not split over {D} data ranks")
        named = model_lib.train_params(params)
        state = init_opt_state(named)
        batch = {"tokens": torch.empty((Bl, S), dtype=torch.int32, device=META),
                 "labels": torch.empty((Bl, S), dtype=torch.int32, device=META)}
        if enc:
            batch["enc_inputs"] = torch.empty((Bl, ENC_FRAMES, cfg.d_model), dtype=dt,
                                              device=META)
        if not step:
            return Step(None, (named, state, batch)), note
        train_step = make_train_step(cfg, ctx)

        def run():
            metrics = train_step(params, state, batch)
            return named, state, metrics
        return Step(run, (named, state, batch)), note

    rows, split = _rows(B, D)
    if not split:  # the K/V caches cut on their sequence over the data group
        ctx = dataclasses.replace(ctx, batch_split=False, kv_seq=S)
    cache = rank_cache(cfg, ctx, B, S, ENC_FRAMES if enc else 0)
    frames = (torch.empty((rows, ENC_FRAMES, cfg.d_model), dtype=dt, device=META) if enc
              else None)
    if shape.kind == "prefill":
        tokens = torch.empty((rows, S), dtype=torch.int32, device=META)
        if not step:
            return Step(None, (params, cache, tokens, frames)), note

        def run():
            return model_lib.prefill(params, cfg, tokens, cache, ctx, last_only=True,
                                     enc_inputs=frames)
        return Step(run, (params, cache, tokens, frames)), note
    token = torch.empty((rows, 1), dtype=torch.int32, device=META)
    if not step:
        return Step(None, (params, cache, token), scalar_bytes=4), note

    def run():
        return model_lib.decode_step(params, cfg, token, cache, S - 1, ctx)
    return Step(run, (params, cache, token), scalar_bytes=4), note


def argument_bytes(step: Step) -> int:
    """The bytes of a step's arguments, each storage once, plus its scalars."""
    return OpCost().arguments(step.args) + step.scalar_bytes


def analyse(counter: OpCost, step: Step, outputs, n_devices: int) -> dict:
    """The record's counts from a step run under ``counter``."""
    s = counter.summary()
    args = argument_bytes(step)
    out = OpCost()
    out_bytes = out.arguments(outputs)
    alias = sum(out.args[k] for k in out.args.keys() & counter.args.keys())
    return {"flops": s["flops"], "bytes_accessed": s["bytes_accessed"],
            "collectives": s["collectives"], "collective_bytes": s["collective_bytes"],
            "n_devices": n_devices, "argument_size_in_bytes": args,
            "output_size_in_bytes": out_bytes, "alias_size_in_bytes": alias,
            "temp_size_in_bytes": s["peak_bytes"], "kernels": s["kernels"],
            "hbm_fits": args + s["peak_bytes"] <= HBM_BYTES}


def other_ranks(mesh_shape: dict) -> list:
    """The ranks whose shards ``run_one`` holds against rank 0's: the last
    model rank of data row 0, the first rank of the last data row, and the
    last rank."""
    n = 1
    for v in mesh_shape.values():
        n *= v
    M = mesh_shape["model"]
    return sorted({M - 1, n - M, n - 1} - {0})


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str, fsdp=None,
            tag: str = "", plan=None, mesh_shape=None) -> dict:
    """Build and count rank 0's step at (arch, shape) on the production mesh
    (or ``mesh_shape``), write its record to ``out_dir`` as JSON and
    return it."""
    mesh_shape = dict(mesh_shape or production_shape(multi_pod))
    mesh_name = ("pod2x16x16" if multi_pod else "pod16x16") if mesh_shape == production_shape(
        multi_pod) else "x".join(str(v) for v in mesh_shape.values())
    name = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    n_devices = 1
    for v in mesh_shape.values():
        n_devices *= v
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
           "plan": dict(plan or {})}
    try:
        step, note = build(arch, shape_name, mesh_shape, plan, fsdp)
        rec["note"] = note
        if step is None:
            rec["status"] = "skipped"
        else:
            t1 = time.time()
            counter = OpCost()
            counter.arguments(step.args)
            with counter:
                outputs = step.run()
            rec.update(analyse(counter, step, outputs, n_devices))
            others = {r: argument_bytes(build(arch, shape_name, mesh_shape, plan, fsdp, rank=r,
                                              step=False)[0])
                      for r in other_ranks(mesh_shape)}
            rec["ranks_differ"] = {str(r): b for r, b in others.items()
                                   if b != rec["argument_size_in_bytes"]}
            rec["status"] = "ok"
            rec["build_s"] = round(t1 - t0, 1)
            rec["step_s"] = round(time.time() - t1, 1)
    except Exception as e:  # a failure here is a fault of the port
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    gib = 2 ** 30
    print(f"[{rec['status']:7s}] {name} ({rec['total_s']}s) "
          f"flops={rec.get('flops', 0):.3e} coll={rec.get('collective_bytes', 0):.3e} "
          f"arg={rec.get('argument_size_in_bytes', 0) / gib:.2f}GiB "
          f"temp={rec.get('temp_size_in_bytes', 0) / gib:.2f}GiB "
          f"{rec.get('note', '')}{rec.get('error', '')}", flush=True)
    return rec


def table(records) -> str:
    """The records as one markdown table, a row per arch and a column per
    shape; each cell holds, per mesh in run order (joined by "‖"), the
    rank's argument / temp GiB (in bold where they do not fit an H100's
    80 GB), TFLOPs, HBM GB and collective GB, or the pair's status."""
    shapes = list(dict.fromkeys(r["shape"] for r in records))
    meshes = list(dict.fromkeys(r["mesh"] for r in records))
    cells = {(r["arch"], r["shape"], r["mesh"]): r for r in records}

    def cell(r):
        if r["status"] != "ok":
            return r["status"]
        gib = (f"{r['argument_size_in_bytes'] / 2 ** 30:.2f} / "
               f"{r['temp_size_in_bytes'] / 2 ** 30:.2f}")
        return (f"{gib if r['hbm_fits'] else f'**{gib}**'} · {r['flops'] / 1e12:.3g} · "
                f"{r['bytes_accessed'] / 1e9:.3g} · {r['collective_bytes'] / 1e9:.3g}")
    out = [f"{' ‖ '.join(meshes)}: argument / temp GiB · TFLOP · HBM GB · collective GB", "",
           "| arch | " + " | ".join(shapes) + " |", "|---" * (len(shapes) + 1) + "|"]
    for arch in dict.fromkeys(r["arch"] for r in records):
        out.append(f"| {arch} | " + " | ".join(
            " ‖ ".join(cell(cells[(arch, sh, m)]) for m in meshes if (arch, sh, m) in cells)
            for sh in shapes) + " |")
    return "\n".join(out)


def parse_plan(text: str) -> dict:
    """``--plan``'s comma list: ``moe_2d,remat_policy=dots``."""
    plan = {}
    for item in filter(None, text.split(",")):
        if "=" in item:
            k, v = item.split("=", 1)
            plan[k] = v
        else:
            plan[item] = True
    return plan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--plan", default="",
                    help="comma list: moe_2d,remat_policy=dots (attn_seq_shard is not ported)")
    args = ap.parse_args(argv)
    plan = check_plan(parse_plan(args.plan))

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    t0 = time.time()
    records = [run_one(arch, shape, mp, args.out, fsdp=False if args.no_fsdp else None,
                       tag=args.tag, plan=plan)
               for arch in archs for shape in shapes for mp in meshes]
    n_fail = sum(r["status"] == "FAIL" for r in records)
    print(table(records))
    print(f"done, failures: {n_fail} ({len(records)} runs on "
          f"{', '.join(str(PRODUCTION_DEVICES[m]) for m in meshes)} devices, "
          f"{time.time() - t0:.1f} s)")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
