#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                   # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels  # build + kernel-vs-plain only
    python3 chip_smoke.py --phases profile  # a profiled, warm serve (not in the default run)

Phases:
  1. device   the card's name and count, its power limit from nvidia-smi,
              and the kernels' build from ``src/repro_torch/kernels/csrc``
  2. kernels  every kernel against its plain PyTorch version on the card at
              the serving path's shapes, bf16 and fp32
  3. times    CUDA-event times of each kernel, its plain version and one
              PyTorch library call (a yardstick only), beside the bound
  4. parity   both models at full width, cut to 2 layers, fp32: prefill and
              8 ragged decode steps through the kernels and through the
              plain versions agree
  5. serve    the port's main path: tinyllama-1.1b and gemma2-2b at their
              full configs served concurrently by one continuous engine;
              every attention kernel must have launched there
  profile     (only when asked for) the serve phase's run again, warm:
              its untraced wall time, then under torch.profiler the device
              time by kernel and the device's idle share of the wall time

It prints a ``kernels`` JSON line, the nvidia-smi line and, last, the
``{"ok": true, "device": ...}`` line. Any failure exits nonzero with no
result line. It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("device", "kernels", "times", "parity", "serve")
SERVE = dict(names=("tinyllama-1.1b", "gemma2-2b"), requests=8, prompt_lens=(64, 128, 256, 512),
             max_new=16, max_slots=8, max_len=1024, seed=0, device="cuda", full=True)
# NVIDIA H100 SXM data sheet: HBM rate and dense peaks (bf16 on the tensor
# cores, fp32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
MODEL_TOL = 1e-3
TINY = dict(H=32, Hkv=4, D=64, softcap=None)   # tinyllama-1.1b attention
GEMMA = dict(H=8, Hkv=4, D=256, softcap=50.0)  # gemma2-2b attention
DECODE_POS = (0, 1, 63, 64, 500, 1023, 2046, 2047)
SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:106"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:87"),
}


class SmokeFailure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# inputs, masks, bounds
# ---------------------------------------------------------------------------


def qkv(torch, gen, B, Sq, Sk, H, Hkv, D, dtype):
    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return r(B, Sq, H, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, D)


def kept_keys(qpos, kv_len, Sk, causal, window):
    """Keys one query row keeps."""
    hi = min(kv_len, Sk, qpos + 1) if causal else min(kv_len, Sk)
    lo = max(0, qpos - window + 1) if window else 0
    return max(0, hi - lo)


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def flash_bound(B, S, H, Hkv, D, window, dtype_name, elem):
    pairs = B * sum(kept_keys(i, S, S, True, window) for i in range(S))
    nbytes = elem * (2 * B * S * H * D + 2 * B * S * Hkv * D)
    return bound(4 * H * D * pairs, nbytes, dtype_name)


def decode_bound(pos, Smax, H, Hkv, D, window, dtype_name, elem):
    kept = sum(kept_keys(p, p + 1, Smax, False, window) for p in pos)
    nbytes = elem * (kept * Hkv * 2 * D + 2 * len(pos) * H * D)
    return bound(4 * H * D * kept, nbytes, dtype_name)


def time_ms(torch, fn, flush, iters=20, warmup=3):
    """Median CUDA-event time of one call; the L2 cache is flushed before
    each call, as the serving path finds it cold (each layer reads its own
    weights and KV)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch, report):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    report["smi"] = smi.stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {report['smi']}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({build.library_path().name})")
    build_log = build.BUILD_DIR / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line.lower() or line.startswith("=="):
                log("  ptxas:", line.strip())


def phase_kernels(torch, report):
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_attention": {}, "decode_attention": {}}
    misses = []

    def compare(kernel, case, dtype, out, ref):
        tol = TOL[str(dtype).split(".")[-1]]
        a, b = out.float(), ref.float()
        err = (a - b).abs()
        ok = bool(torch.isfinite(a).all()) and bool((err <= tol + tol * b.abs()).all())
        e = float(err.max())
        key = str(dtype).split(".")[-1]
        errs[kernel][key] = max(errs[kernel].get(key, 0.0), e)
        if not ok:
            misses.append(f"{kernel} {case}: max abs err {e:.3g} over tolerance {tol}")

    for dtype in (torch.bfloat16, torch.float32):
        for name, hd in (("tinyllama", TINY), ("gemma2", GEMMA)):
            for B in (1, 4, 8):
                for S in (64, 256, 1024):
                    for window in ((None, S // 4) if name == "gemma2" else (None,)):
                        q, k, v = qkv(torch, gen, B, S, S, hd["H"], hd["Hkv"], hd["D"], dtype)
                        kw = dict(causal=True, window=window, softcap=hd["softcap"])
                        out = fmod.flash_attention(q, k, v, **kw)
                        ref = fmod.flash_attention_plain(q, k, v, **kw)
                        compare("flash_attention", f"{name} B={B} S={S} w={window} {dtype}",
                                dtype, out, ref)
            Smax, B = 2048, len(DECODE_POS)
            pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
            for window in ((None, 256) if name == "gemma2" else (None,)):
                q, _, _ = qkv(torch, gen, B, 1, 1, hd["H"], hd["Hkv"], hd["D"], dtype)
                _, k, v = qkv(torch, gen, B, 1, Smax, hd["H"], hd["Hkv"], hd["D"], dtype)
                kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=hd["softcap"])
                out = dmod.decode_attention(q, k, v, **kw)
                ref = dmod.decode_attention_plain(q, k, v, **kw)
                compare("decode_attention", f"{name} Smax={Smax} w={window} {dtype}",
                        dtype, out, ref)
    torch.cuda.synchronize()
    report["errors"] = errs
    log("kernel vs plain, max abs err:", json.dumps(errs))
    if misses:
        raise SmokeFailure("kernel disagrees with its plain version:\n  " + "\n  ".join(misses))


def phase_times(torch, report):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    rows = []

    def sdpa(q, k, v, **kw):
        # the library yardstick, (B, heads, S, D) views of the same tensors
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), enable_gqa=True, **kw)

    bf16 = torch.bfloat16
    for name, hd in (("tinyllama", TINY), ("gemma2", GEMMA)):
        for B, S in ((1, 64), (8, 256), (8, 512), (8, 1024)):
            q, k, v = qkv(torch, gen, B, S, S, hd["H"], hd["Hkv"], hd["D"], bf16)
            kw = dict(causal=True, softcap=hd["softcap"])
            ms = time_ms(torch, lambda: fmod.flash_attention(q, k, v, **kw), flush)
            plain = time_ms(torch, lambda: fmod.flash_attention_plain(q, k, v, **kw), flush)
            lib = (None if hd["softcap"] else
                   time_ms(torch, lambda: sdpa(q, k, v, is_causal=True), flush))
            b_ms, b_by = flash_bound(B, S, hd["H"], hd["Hkv"], hd["D"], None, "bfloat16", 2)
            rows.append(dict(kernel="flash_attention", model=name, B=B, S=S, dtype="bfloat16",
                             ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                             bound_by=b_by))
        for Smax in (1024, 2048):
            pos_list = [min(p, Smax - 1) for p in DECODE_POS]
            B = len(pos_list)
            pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
            q, _, _ = qkv(torch, gen, B, 1, 1, hd["H"], hd["Hkv"], hd["D"], bf16)
            _, k, v = qkv(torch, gen, B, 1, Smax, hd["H"], hd["Hkv"], hd["D"], bf16)
            kw = dict(q_offset=pos, kv_len=pos + 1, softcap=hd["softcap"])
            mask = (torch.arange(Smax, device="cuda")[None, :] <= pos[:, None])[:, None, None]
            ms = time_ms(torch, lambda: dmod.decode_attention(q, k, v, **kw), flush)
            plain = time_ms(torch, lambda: dmod.decode_attention_plain(q, k, v, **kw), flush)
            lib = (None if hd["softcap"] else
                   time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask), flush))
            b_ms, b_by = decode_bound(pos_list, Smax, hd["H"], hd["Hkv"], hd["D"], None,
                                      "bfloat16", 2)
            rows.append(dict(kernel="decode_attention", model=name, B=B, S=Smax,
                             dtype="bfloat16", ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=b_ms, bound_by=b_by))
    report["timings"] = rows
    log("timings:", json.dumps({"smi": report.get("smi"), "timings": rows}))


def phase_parity(torch, report):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.workers import ModelWorker
    from repro_torch.sharding.context import ExecContext
    prompt_lens = (37, 64, 100)
    for arch in ("tinyllama-1.1b", "gemma2-2b"):
        cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32",
                                  param_dtype="float32")
        params = init_params(cfg, seed=0, device="cuda")
        rng = torch.Generator().manual_seed(7)
        prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).numpy()
                   for n in prompt_lens]
        runs = {}
        for impl in (None, "plain"):
            w = ModelWorker(arch, cfg, params, max_len=256, ctx=ExecContext(attn_impl=impl))
            pool = w.init_pool(len(prompts))
            logits, toks = [], []
            first = []
            for slot, p in enumerate(prompts):
                lg, c = w.prefill_one(p)
                pool = w.write_slots(pool, c, [slot])
                first.append(lg[0])
            lg = torch.stack(first)
            pos = torch.tensor(prompt_lens, dtype=torch.int32).numpy()
            for _ in range(9):  # prefill logits + 8 ragged decode steps
                logits.append(lg)
                tok = lg.argmax(dim=-1).to(torch.int32).cpu().numpy()
                toks.append(tok)
                _, lg, pool = w.decode_pool(pool, tok[:, None], pos)
                pos = pos + 1
            runs[impl] = (torch.stack(logits), toks)
        a, b = runs[None][0], runs["plain"][0]
        err = float((a - b).abs().max())
        ok = bool(torch.isfinite(a).all()) and bool(
            ((a - b).abs() <= MODEL_TOL + MODEL_TOL * b.abs()).all())
        same = all((x == y).all() for x, y in zip(runs[None][1], runs["plain"][1]))
        log(f"parity {arch} (2 layers, full width, fp32): logits max abs err {err:.3g}, "
            f"greedy tokens identical: {same}")
        if not ok or not same:
            raise SmokeFailure(f"{arch}: kernel path disagrees with the plain path "
                               f"(max abs err {err:.3g}, tokens identical {same})")
        report.setdefault("parity", {})[arch] = err
        del params


def phase_serve(torch, report):
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.launch.serve import serve
    names, max_new = SERVE["names"], SERVE["max_new"]
    fmod.flash_attention.launches = 0
    dmod.decode_attention.launches = 0
    eng, responses, rep = serve(**SERVE)
    launches = {"flash_attention": fmod.flash_attention.launches,
                "decode_attention": dmod.decode_attention.launches}
    report["launches"] = launches
    log(f"serve: {rep['requests']} requests, {rep['tokens']} tokens, "
        f"{rep['wall_s']:.3f} s wall, peak memory {rep['peak_mem_bytes'] / 2**30:.2f} GiB, "
        f"{rep['prefill_batches']} prefill batches; {json.dumps(rep['models'])}")
    log(f"serve launches: {json.dumps(launches)}")
    report["serve"] = rep
    bad = [r for r in responses if r.error is not None or len(r.tokens) != max_new]
    if len(responses) != 8 * len(names) or bad:
        raise SmokeFailure(f"serve: {len(responses)} responses, {len(bad)} bad")
    vocab = max(w.cfg.padded_vocab for w in eng.workers.values())
    if any(((r.tokens < 0) | (r.tokens >= vocab)).any() for r in responses):
        raise SmokeFailure("serve: a token id lies outside the vocabulary")
    want = {"flash_attention": sum(w.cfg.num_layers * w.prefill_calls
                                   for w in eng.workers.values()),
            "decode_attention": sum(w.cfg.num_layers * w.decode_calls
                                    for w in eng.workers.values())}
    if launches != want or min(launches.values()) == 0:
        raise SmokeFailure(f"serve: kernel launches {launches}, expected {want}")


def phase_profile(torch, report):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import build_engine, serve
    serve(**SERVE)  # warm-up: cuBLAS handles, the allocator's pools
    warm = serve(**SERVE)[2]["wall_s"]  # the same run, warm and untraced
    eng = build_engine(**SERVE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_all()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        kernels.append((evt.key, evt.count, us))
    if not kernels:
        raise SmokeFailure("the profiler recorded no device time")
    kernels.sort(key=lambda k: -k[2])
    busy_s = sum(k[2] for k in kernels) * 1e-6

    def group(name):
        if "flash_fwd_kernel" in name:
            return "flash_attention"
        if "decode_kernel" in name:
            return "decode_attention"
        low = name.lower()
        if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            return "matmul"
        return "other"

    groups = {}
    for name, count, us in kernels:
        g = group(name)
        n, t = groups.get(g, (0, 0.0))
        groups[g] = (n + count, t + us * 1e-3)
    out = {"warm_untraced_wall_s": warm, "traced_wall_s": wall, "device_busy_s": busy_s,
           "idle_share_traced": 1.0 - busy_s / wall, "idle_share_untraced": 1.0 - busy_s / warm,
           "groups_ms": {g: {"launches": n, "ms": t} for g, (n, t) in groups.items()},
           "top": [{"kernel": k[:90], "launches": c, "ms": us * 1e-3}
                   for k, c, us in kernels[:15]]}
    report["profile"] = out
    log("profile:", json.dumps(out))


def kernels_line(report):
    rows = {r["kernel"]: r for r in report.get("timings", [])
            if r["model"] == "tinyllama" and r["B"] == 8 and r["S"] in (512, 2048)}
    out = []
    for name, (src, replaces) in SOURCES.items():
        t = rows.get(name, {})
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": report.get("launches", {}).get(name),
                    "max_abs_err": max(report.get("errors", {}).get(name, {}).values(),
                                       default=None),
                    "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
                    "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
                    "library_ms": t.get("library_ms")})
    return {"kernels": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + ('profile',)}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke test runs only on the GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    fns = {"device": phase_device, "kernels": phase_kernels, "times": phase_times,
           "parity": phase_parity, "serve": phase_serve, "profile": phase_profile}
    t_start = time.perf_counter()
    try:
        for ph in ("device",) + tuple(p for p in PHASES + ("profile",)
                                      if p in phases and p != "device"):
            t0 = time.perf_counter()
            log(f"== phase {ph}")
            fns[ph](torch, report)
            torch.cuda.synchronize()
            log(f"== phase {ph} done in {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line(report)))
    print(report["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
