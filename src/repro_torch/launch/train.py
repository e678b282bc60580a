"""Training driver of the port: the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 40 --batch 8 --seq 512 --full

trains the full published config on the card (bf16 params and moments,
seeded random weights) on the synthetic pipeline (``data.pipeline``); the
default ``--reduced`` trains the CPU-sized variant, and ``--device cpu``
runs on the CPU. It prints the first loss and the mean of the last ten, as
the reference's driver does, then the warm median step time, tokens/s and,
on the card, the peak memory; ``--ckpt DIR`` saves the final params and
optimizer state there (``training.checkpoint``).

    PYTHONPATH=src python -m repro_torch.launch.train --mesh 2,2 --fsdp

trains on a (data, model) mesh of D x M ranks (``--mesh P,D,M``: a
(pod, data, model) mesh whose pod and data axes both cut the batch),
spawned from this process
(``launch.sharded.run_ranks`` / ``train_rank``: each rank one process,
gloo on the CPU and for ranks that share a card), each rank on its shard
and its rows of the global ``--batch``; ``--fsdp`` cuts the weights over
the data axis too (by default only where ``fsdp_default`` says), and
``--plan attn_seq_shard`` (the reference's plan knobs, as the dry run's
``--plan`` takes them) cuts GQA attention on its query sequence over the
model axis. The peak memory is each rank's.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.base import reduced as make_reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.dryrun import check_plan, parse_plan
from repro_torch.launch.sharded import run_ranks, train_rank
from repro_torch.models.model import init_params, resolve_device
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, help="D,M: a (data, model) mesh of D*M ranks; P,D,M "
                    "a (pod, data, model) mesh")
    ap.add_argument("--fsdp", action="store_true", help="cut the weights over the data axis")
    ap.add_argument("--plan", default="", help="with --mesh: plan knobs, e.g. attn_seq_shard")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    print(f"training {cfg.name} ({'reduced' if args.reduced else 'FULL'}) on {dev}: "
          f"{cfg.num_layers}L d={cfg.d_model} N={cfg.param_count()/1e6:.1f}M")
    oc = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5), total_steps=args.steps)
    mesh = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else (1, 1)
    if math.prod(mesh) > 1:
        job = dict(cfg=cfg, seed=args.seed, data_seed=args.seed, batch=args.batch,
                   seq=args.seq, steps=args.steps, oc=oc, fsdp=True if args.fsdp else None,
                   save=args.ckpt, plan=check_plan(parse_plan(args.plan)))
        # a training run has no time limit of its own, sharded or not
        ranks = run_ranks(train_rank, math.prod(mesh), ([job], mesh, dev.type),
                          timeout=float("inf"), device_type=dev.type)
        hist = ranks[0][0]["history"]
        report(args, hist, dev, [r[0]["peak_mem_bytes"] for r in ranks], mesh)
        return
    params = init_params(cfg, args.seed, dev)
    data = SyntheticLM(cfg, DataConfig(batch=args.batch, seq_len=args.seq, seed=args.seed))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params, opt_state, hist = train_loop(cfg, params, data.batches(args.steps), oc=oc)
    report(args, hist, dev, [torch.cuda.max_memory_allocated(dev)] if dev.type == "cuda"
           else [], mesh)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt_state, step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")


def report(args, hist, dev, peaks, mesh):
    """The loss and the warm step time; each rank's peak on the card."""
    first, last = hist[0]["loss"], np.mean([h["loss"] for h in hist[-10:]])
    print(f"loss {first:.4f} -> {last:.4f} over {args.steps} steps")
    warm = [h["step_s"] for h in hist[1:]] or [hist[0]["step_s"]]
    step_s = float(np.median(warm))
    line = (f"warm step {step_s * 1e3:.1f} ms (median of {len(warm)}), "
            f"{args.batch * args.seq / step_s:.0f} tokens/s")
    if math.prod(mesh) > 1:
        axes = "(pod, data, model)" if len(mesh) == 3 else "(data, model)"
        line += f" on a {'x'.join(map(str, mesh))} {axes} mesh"
    if dev.type == "cuda":
        line += (f", peak memory {', '.join(f'{p / 2**30:.2f}' for p in peaks)} GiB (per rank) "
                 f"on {torch.cuda.get_device_name(dev)}")
    print(line)
    if args.ckpt and math.prod(mesh) > 1:
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
