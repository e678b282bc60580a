#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                   # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels  # build + kernel-vs-plain only
    python3 chip_smoke.py --phases kernels,scheduled  # + the scheduled serve
    python3 chip_smoke.py --phases profile  # a profiled, warm serve (not in the default run)
    python3 chip_smoke.py --phases profile_scheduled  # the same for the scheduled serve

Phases:
  1. device     the card's name and count, its power limit from nvidia-smi,
                and the kernels' build from ``src/repro_torch/kernels/csrc``
  2. kernels    every kernel against its plain PyTorch version on the card
                at the serving paths' shapes, bf16 and fp32
  3. times      CUDA-event device times of each kernel, its plain version
                and one PyTorch library call (a yardstick only), beside the
                bound; for the attention kernels and the library call also
                the wall time per call back to back (host enqueue included)
  4. parity     each model at full width, cut to 2 layers, fp32 and (the
                attention models) bf16: prefill (mamba2: a masked pow2
                bucket) and 8 ragged decode steps through the kernels and
                through the plain versions agree
  5. serve      the FIFO path: tinyllama-1.1b and gemma2-2b at their full
                configs served concurrently by one continuous engine; every
                attention kernel must have launched there
  6. scheduled  the AdaOper-scheduled path (``repro_torch.launch.serve``'s
                default): tinyllama-1.1b, gemma2-2b and mamba2-2.7b at their
                full configs in one engine under ``AdaOperScheduler``; all
                three kernels must have launched there. Its joules are the
                device simulator's mobile-SoC predictions, not the card's.
  profile       (only when asked for) the serve phase's run again, warm:
                its untraced wall time, then under torch.profiler the device
                time by kernel and the device's idle share of the wall time
  profile_scheduled  (only when asked for) the same for the scheduled phase

Each serving phase sets every kernel's launch count to 0 just before it
drives its path and reads the counts just after.

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

PHASES = ("device", "kernels", "times", "parity", "serve", "scheduled")
EXTRA = ("profile", "profile_scheduled")  # run only when asked for
SERVE = dict(names=("tinyllama-1.1b", "gemma2-2b"), requests=8, prompt_lens=(64, 128, 256, 512),
             max_new=16, max_slots=8, max_len=1024, seed=0, device="cuda", full=True,
             scheduler=False)
# prompt lengths off the pow2 grid, so mamba2 admits masked, left-padded groups
SCHEDULED = dict(SERVE, names=("tinyllama-1.1b", "gemma2-2b", "mamba2-2.7b"),
                 prompt_lens=(64, 96, 200, 512), scheduler=True, workload="moderate")
# NVIDIA H100 SXM data sheet: HBM rate and dense peaks (bf16 on the tensor
# cores, fp32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# the SSD scan sums up to 256 x 128 fp32 products per output in another
# order than its plain version; its final state is fp32 in both dtypes
SSD_TOL = {"bfloat16": 3e-2, "float32": 1e-3}
MODEL_TOL = 1e-3
SPIN_CYCLES = 2_000_000  # ~1 ms of device clock, longer than the host takes to enqueue a call
# bf16 model parity: the two paths round at different places (the
# tensor-core kernel rounds P to bf16 before P.V, the plain path keeps it in
# fp32), and bf16 keeps 8 significant bits (an ulp is 0.4-0.8% of a value),
# so after 2 layers the logits may differ by a few ulps of their own scale:
# 3e-2 of the step's largest logit, the bf16 kernel tolerance at that scale
MODEL_TOL_BF16 = 3e-2
TINY = dict(H=32, Hkv=4, D=64, softcap=None)   # tinyllama-1.1b attention
GEMMA = dict(H=8, Hkv=4, D=256, softcap=50.0)  # gemma2-2b attention
MAMBA = dict(H=80, P=64, N=128, chunk=256)     # mamba2-2.7b SSD heads
DECODE_POS = (0, 1, 63, 64, 500, 1023, 2046, 2047)
# the kernels line's source is the bf16 route's, whose times it carries;
# flash's fp32 route (exact fp32 for the parity checks) is
# csrc/flash_attention.cu
SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
                        "src/repro/kernels/flash_attention.py:106"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:87"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:92"),
}


# the device kernels' names (csrc/*.cu) by the wrapper that launches them,
# for the profile's device time by group
KERNEL_GROUPS = {"flash_fwd_bf16_kernel": "flash_attention",
                 "flash_fwd_fp32_kernel": "flash_attention",
                 "decode_split_kernel": "decode_attention",
                 "ssd_scan_kernel": "ssd_scan"}


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


def ssd_inputs(torch, gen, B, S, dtype):
    """Scan inputs as the model makes them: dt = softplus(.) > 0, per-head
    A = -(1..16), dA = dt * A in fp32; x, B, C in ``dtype``."""
    H, P, N = MAMBA["H"], MAMBA["P"], MAMBA["N"]

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(r(B, S, H) - 4.0)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    return r(B, S, H, P).to(dtype), dt * A, dt, r(B, S, N).to(dtype), r(B, S, N).to(dtype)


def ssd_bound(B, S, dtype_name, elem):
    """Operations: per (row, chunk) C.B^T over the causal lower triangle
    once (B and C are shared by all heads), per head the masked decay
    matrix times x, C.h and the state update. Bytes: x, dA, dt, B, C read
    once, y and the fp32 final state written once."""
    H, P, N, Qmax = MAMBA["H"], MAMBA["P"], MAMBA["N"], MAMBA["chunk"]
    Q = min(Qmax, S)
    flops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        tri = q * (q + 1) // 2
        flops += B * (2 * tri * N + H * (2 * tri * P + 4 * q * P * N))
    nbytes = (2 * elem * B * S * H * P + 2 * 4 * B * S * H + 2 * elem * B * S * N
              + 4 * B * H * P * N)
    return bound(flops, nbytes, dtype_name)


def time_ms(torch, fn, flush, iters=20, warmup=3):
    """Median CUDA-event device time of one call. The L2 cache is flushed
    before each call, as the serving path finds it cold (each layer reads its
    own weights and KV), and a spin kernel then holds the device while the
    host enqueues the call, so the events bracket the call's device work and
    not the host's time to enqueue it (``call_ms`` sees that)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def call_ms(torch, fn, n=200):
    """Wall time per call of n calls back to back, then one synchronize:
    the larger of the host's time to enqueue a call and the device's time to
    run it (L2 warm), what a host-bound serve pays per launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


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
    from repro_torch.kernels import ssd_scan as smod
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_attention": {}, "decode_attention": {}, "ssd_scan": {}}
    misses = []

    def compare(kernel, case, dtype, out, ref, tols=TOL):
        tol = tols[str(dtype).split(".")[-1]]
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
        for case, out, ref in flash_edge_cases(torch, gen, fmod, dtype):
            compare("flash_attention", f"edge {case} {dtype}", dtype, out, ref)
        for case, out, ref in decode_edge_cases(torch, gen, dmod, dtype):
            compare("decode_attention", f"edge {case} {dtype}", dtype, out, ref)
        for B in (1, 8):
            for S in (64, 200, 512, 1024):  # one short chunk, a tail chunk, 2 and 4 chunks
                args = ssd_inputs(torch, gen, B, S, dtype)
                masks = [None]
                if S == 200:  # left-padded rows, as a mamba2 pow2 prefill bucket has
                    m = torch.ones(B, S, dtype=torch.bool, device="cuda")
                    m[0, :104] = False
                    m[B - 1, :37] = False
                    masks.append(m)
                for mask in masks:
                    y, h = smod.ssd_scan(*args, mask=mask, chunk=MAMBA["chunk"])
                    ry, rh = smod.ssd_scan_plain(*args, mask=mask, chunk=MAMBA["chunk"])
                    case = f"B={B} S={S} masked={mask is not None} {dtype}"
                    compare("ssd_scan", case + " y", dtype, y, ry, SSD_TOL)
                    compare("ssd_scan", case + " state", torch.float32, h, rh, SSD_TOL)
    torch.cuda.synchronize()
    report["errors"] = errs
    log("kernel vs plain, max abs err:", json.dumps(errs))
    if misses:
        raise SmokeFailure("kernel disagrees with its plain version:\n  " + "\n  ".join(misses))


def flash_edge_cases(torch, gen, fmod, dtype):
    """(case, kernel output, plain output) at the tensor-core kernel's tile
    edges (128-row q tiles, 64-key K/V tiles): lengths on and beside them,
    per-row q_offset / kv_len with kv_len < q_offset + S (and a row that
    keeps no key), a window crossing tiles, every GQA group and Dv 32."""
    def run(case, B, Sq, Sk, H, Hkv, Dk, Dv=None, **kw):
        q, k, _ = qkv(torch, gen, B, Sq, Sk, H, Hkv, Dk, dtype)
        v = qkv(torch, gen, B, 1, Sk, 1, Hkv, Dv or Dk, dtype)[2]
        return case, fmod.flash_attention(q, k, v, **kw), fmod.flash_attention_plain(q, k, v, **kw)

    for S in (1, 17, 64, 65, 128, 129, 200, 1024):
        yield run(f"tinyllama S={S}", 2, S, S, TINY["H"], TINY["Hkv"], TINY["D"])
        yield run(f"gemma2 S={S} w={S // 3 + 1}", 1, S, S, GEMMA["H"], GEMMA["Hkv"], GEMMA["D"],
                  window=S // 3 + 1, softcap=GEMMA["softcap"])
    dev = "cuda"
    yield run("per-row kv_len < q_offset + S", 4, 65, 300, 8, 2, 64,
              q_offset=torch.tensor([0, 100, 230, 5], device=dev),
              kv_len=torch.tensor([40, 120, 260, 0], device=dev))
    yield run("window 100 across tiles", 2, 300, 300, 8, 4, 64, window=100)
    for G in (1, 2, 4, 8):
        yield run(f"G={G}", 2, 130, 130, 2 * G, 2, 128)
    yield run("Dk 64 Dv 32", 2, 130, 130, 4, 2, 64, Dv=32)


def decode_edge_cases(torch, gen, dmod, dtype):
    """(case, kernel output, plain output) at the split-KV kernel's split
    edges: Smax 1000 (not a multiple of the planned split), kv_len on a
    split boundary, one before and one past it, a window that starts inside
    a split and one that spans splits, every GQA group and Dv."""
    B, Smax, Hkv = 8, 1000, 2
    L = dmod.plan_splits(Smax, B, Hkv)[1]
    pos = torch.tensor([0, L - 2, L - 1, L, 2 * L - 1, 2 * L, Smax - 2, Smax - 1],
                       dtype=torch.int32, device="cuda")
    for G in (1, 2, 4, 8):
        for D in (64, 128, 256):
            q, _, _ = qkv(torch, gen, B, 1, 1, G * Hkv, Hkv, D, dtype)
            _, k, v = qkv(torch, gen, B, 1, Smax, G * Hkv, Hkv, D, dtype)
            for window, softcap in ((None, None), (L // 2 + 3, None), (2 * L + 5, 50.0)):
                kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=softcap)
                yield (f"G={G} D={D} Smax={Smax} split={L} w={window} cap={softcap}",
                       dmod.decode_attention(q, k, v, **kw), dmod.decode_attention_plain(q, k, v, **kw))


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
                             bound_by=b_by,
                             call_ms=call_ms(torch, lambda: fmod.flash_attention(q, k, v, **kw)),
                             library_call_ms=None if lib is None else call_ms(
                                 torch, lambda: sdpa(q, k, v, is_causal=True))))
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
                             bound_ms=b_ms, bound_by=b_by,
                             call_ms=call_ms(torch, lambda: dmod.decode_attention(q, k, v, **kw)),
                             library_call_ms=None if lib is None else call_ms(
                                 torch, lambda: sdpa(q, k, v, attn_mask=mask))))
    from repro_torch.kernels import ssd_scan as smod
    for B, S in ((8, 512), (1, 512)):
        args = ssd_inputs(torch, gen, B, S, bf16)
        ms = time_ms(torch, lambda: smod.ssd_scan(*args, chunk=MAMBA["chunk"]), flush)
        plain = time_ms(torch, lambda: smod.ssd_scan_plain(*args, chunk=MAMBA["chunk"]), flush)
        b_ms, b_by = ssd_bound(B, S, "bfloat16", 2)
        rows.append(dict(kernel="ssd_scan", model="mamba2", B=B, S=S, dtype="bfloat16",
                         ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by))
    report["timings"] = rows
    log("timings:", json.dumps({"smi": report.get("smi"), "timings": rows}))


def phase_parity(torch, report):
    """tinyllama and gemma2 at full width, cut to 2 layers: prefill and 8
    ragged decode steps through the kernels against the same run through
    the plain versions, in fp32 (the fp32 kernel routes) and in bf16 (the
    tensor-core flash kernel and the bf16 decode kernel). Both runs are fed
    the plain run's greedy tokens, so a near-tie that rounds the other way
    in bf16 cannot send the two runs down different sequences."""
    for dtype in ("float32", "bfloat16"):
        for arch in ("tinyllama-1.1b", "gemma2-2b"):
            model_parity(torch, report, arch, dtype)
    phase_parity_mamba2(torch, report)


def model_parity(torch, report, arch, dtype):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.workers import ModelWorker
    from repro_torch.sharding.context import ExecContext
    prompt_lens = (37, 64, 100)
    cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype=dtype, param_dtype=dtype)
    params = init_params(cfg, seed=0, device="cuda")
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).numpy()
               for n in prompt_lens]
    runs, toks = {}, None
    for impl in ("plain", None):
        w = ModelWorker(arch, cfg, params, max_len=256, ctx=ExecContext(attn_impl=impl))
        pool = w.init_pool(len(prompts))
        first = []
        for slot, p in enumerate(prompts):
            lg, c = w.prefill_one(p)
            pool = w.write_slots(pool, c, [slot])
            first.append(lg[0])
        lg = torch.stack(first)
        pos = torch.tensor(prompt_lens, dtype=torch.int32).numpy()
        logits, greedy = [], []
        for i in range(9):  # prefill logits + 8 ragged decode steps
            logits.append(lg.float())
            greedy.append(lg.argmax(dim=-1).to(torch.int32).cpu().numpy())
            tok = greedy[-1] if toks is None else toks[i]
            _, lg, pool = w.decode_pool(pool, tok[:, None], pos)
            pos = pos + 1
        runs[impl] = (torch.stack(logits), greedy)
        toks = greedy if toks is None else toks
    a, b = runs[None][0], runs["plain"][0]
    err = float((a - b).abs().max())
    same = sum(int((x == y).sum()) for x, y in zip(runs[None][1], runs["plain"][1]))
    n = sum(x.size for x in runs["plain"][1])
    if dtype == "float32":
        ok = bool(((a - b).abs() <= MODEL_TOL + MODEL_TOL * b.abs()).all()) and same == n
    else:  # per step, against the largest logit of the step
        scale = b.abs().amax(dim=-1, keepdim=True)
        ok = bool(((a - b).abs() <= MODEL_TOL_BF16 * scale).all())
    ok = ok and bool(torch.isfinite(a).all())
    log(f"parity {arch} (2 layers, full width, {dtype}): logits max abs err {err:.3g} "
        f"(largest logit {float(b.abs().max()):.3g}), greedy tokens agreeing {same}/{n}")
    if not ok:
        raise SmokeFailure(f"{arch} {dtype}: kernel path disagrees with the plain path "
                           f"(max abs err {err:.3g}, greedy tokens agreeing {same}/{n})")
    report.setdefault("parity", {})[f"{arch} {dtype}"] = err


def phase_parity_mamba2(torch, report):
    """mamba2 at full width, 2 layers, fp32: a 96- and a 128-token prompt
    LEFT-padded into one masked 128 bucket (the SSD kernel on the scan), then
    8 ragged decode steps, against the same run on the plain scan."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.workers import ModelWorker
    from repro_torch.sharding.context import ExecContext
    arch, lens, bucket = "mamba2-2.7b", (96, 128), 128
    cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32",
                              param_dtype="float32")
    params = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(7)
    prompts = np.zeros((len(lens), bucket), np.int32)
    mask = np.zeros((len(lens), bucket), bool)
    for i, n in enumerate(lens):
        prompts[i, bucket - n:] = rng.integers(1, cfg.vocab_size, n)
        mask[i, bucket - n:] = True
    runs = {}
    for impl in (None, "plain"):
        w = ModelWorker(arch, cfg, params, max_len=256, ctx=ExecContext(attn_impl=impl))
        pool = w.init_pool(len(lens))
        lg, c = w.prefill_batch(prompts, pad_mask=mask)
        pool = w.write_slots(pool, c, list(range(len(lens))))
        pos = np.asarray(lens, np.int32)
        logits, toks = [], []
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
    log(f"parity {arch} (2 layers, full width, fp32, masked 128 bucket of {lens}): "
        f"logits max abs err {err:.3g}, greedy tokens identical: {same}")
    if not ok or not same:
        raise SmokeFailure(f"{arch}: kernel path disagrees with the plain path "
                           f"(max abs err {err:.3g}, tokens identical {same})")
    report.setdefault("parity", {})[arch] = err


def kernel_wrappers():
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ssd_scan as smod
    return {"flash_attention": fmod.flash_attention, "decode_attention": dmod.decode_attention,
            "ssd_scan": smod.ssd_scan}


def drive(fn, **kw):
    """Run one serving path with every kernel's launch count set to 0 just
    before it; returns (fn's result, the counts read just after)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn(**kw)
    return out, {name: w.launches for name, w in wrappers.items()}


def attention_launches_expected(eng):
    attn = [w for w in eng.workers.values() if "ssd" not in w.cfg.layer_kinds()]
    return {"flash_attention": sum(w.cfg.num_layers * w.prefill_calls for w in attn),
            "decode_attention": sum(w.cfg.num_layers * w.decode_calls for w in attn)}


def check_responses(phase, eng, responses, n_expected, max_new):
    bad = [r for r in responses if r.error is not None or len(r.tokens) != max_new]
    if len(responses) != n_expected or bad:
        raise SmokeFailure(f"{phase}: {len(responses)} responses of {n_expected}, {len(bad)} bad")
    vocab = max(w.cfg.padded_vocab for w in eng.workers.values())
    if any(((r.tokens < 0) | (r.tokens >= vocab)).any() for r in responses):
        raise SmokeFailure(f"{phase}: a token id lies outside the vocabulary")


def phase_serve(torch, report):
    from repro_torch.launch.serve import serve
    names, max_new = SERVE["names"], SERVE["max_new"]
    (eng, responses, rep), launches = drive(serve, **SERVE)
    report["launches"] = launches
    log(f"serve: {rep['requests']} requests, {rep['tokens']} tokens, "
        f"{rep['wall_s']:.3f} s wall, peak memory {rep['peak_mem_bytes'] / 2**30:.2f} GiB, "
        f"{rep['prefill_batches']} prefill batches; {json.dumps(rep['models'])}")
    log(f"serve launches: {json.dumps(launches)}")
    report["serve"] = rep
    check_responses("serve", eng, responses, SERVE["requests"] * len(names), max_new)
    want = dict(attention_launches_expected(eng), ssd_scan=0)
    if launches != want or min(launches["flash_attention"], launches["decode_attention"]) == 0:
        raise SmokeFailure(f"serve: kernel launches {launches}, expected {want}")


def phase_scheduled(torch, report):
    """The AdaOper-scheduled main path through ``repro_torch.launch.serve``."""
    from repro_torch.launch.serve import serve
    names, max_new = SCHEDULED["names"], SCHEDULED["max_new"]
    (eng, responses, rep), launches = drive(serve, **SCHEDULED)
    report["launches_scheduled"] = launches
    report["scheduled"] = rep
    log(f"scheduled: {rep['requests']} requests, {rep['tokens']} tokens, calibration "
        f"{rep['calibration_s']:.3f} s, weights {rep['init_s']:.3f} s, {rep['wall_s']:.3f} s "
        f"wall, peak memory {rep['peak_mem_bytes'] / 2**30:.2f} GiB, "
        f"{rep['prefill_batches']} prefill batches; {json.dumps(rep['models'])}")
    log(f"scheduled plan cache {json.dumps(rep['plan_cache'])}, admission reasons "
        f"{json.dumps(rep['admission_reasons'])}, drift events {rep['drift_events']}, "
        f"preemptions {json.dumps(rep['preemptions'])}")
    log(f"scheduled joules, {rep['energy_j']['label']} (not the card's): "
        f"{json.dumps(rep['energy_j'])}")
    log(f"scheduled launches: {json.dumps(launches)}")
    check_responses("scheduled", eng, responses, SCHEDULED["requests"] * len(names), max_new)
    mamba = eng.workers["mamba2-2.7b"]
    want = dict(attention_launches_expected(eng),
                ssd_scan=mamba.cfg.num_layers * mamba.prefill_calls)
    if launches != want or min(launches.values()) == 0 or launches["ssd_scan"] < 64:
        raise SmokeFailure(f"scheduled: kernel launches {launches}, expected {want}")
    reasons = set(rep["admission_reasons"])
    if not reasons - {"idle-pool"}:
        raise SmokeFailure(f"scheduled: admission never priced a decision ({reasons})")
    seen = {(e.kind, e.model) for e in eng.ledger.events}
    missing = [(k, m) for k in ("prefill", "decode", "request") for m in names
               if (k, m) not in seen]
    if missing:
        raise SmokeFailure(f"scheduled: the ledger lacks events {missing}")


def engine_for(kw):
    """The engine ``serve(**kw)`` would build, not yet run."""
    from repro_torch.launch.serve import build_engine, make_scheduler, model_configs
    kw = dict(kw)
    scheduled, workload = kw.pop("scheduler"), kw.pop("workload", "moderate")
    sched = (make_scheduler(model_configs(kw["names"], kw["full"]).values(),
                            max(kw["prompt_lens"]), kw["max_new"], workload, kw["seed"])
             if scheduled else None)
    return build_engine(**kw, scheduler=sched)


def phase_profile(torch, report):
    profile_workload(torch, report, "profile", SERVE)


def phase_profile_scheduled(torch, report):
    profile_workload(torch, report, "profile_scheduled", SCHEDULED)


def profile_workload(torch, report, key, kw):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve
    serve(**kw)  # warm-up: cuBLAS handles, the allocator's pools
    warm = serve(**kw)[2]["wall_s"]  # the same run, warm and untraced
    eng = engine_for(kw)
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
        for kernel, g in KERNEL_GROUPS.items():
            if kernel in name:
                return g
        low = name.lower()
        if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            return "matmul"
        return "other"

    groups = {}
    for name, count, us in kernels:
        g = group(name)
        n, t = groups.get(g, (0, 0.0))
        groups[g] = (n + count, t + us * 1e-3)
    # every launch of an attention kernel must land in its own group
    for g, n in attention_launches_expected(eng).items():
        if groups.get(g, (0, 0.0))[0] != n:
            raise SmokeFailure(f"{key}: the profile counts {groups.get(g)} for {g}, "
                               f"the engine launched it {n} times")
    out = {"warm_untraced_wall_s": warm, "traced_wall_s": wall, "device_busy_s": busy_s,
           "idle_share_traced": 1.0 - busy_s / wall, "idle_share_untraced": 1.0 - busy_s / warm,
           "groups_ms": {g: {"launches": n, "ms": t} for g, (n, t) in groups.items()},
           "top": [{"kernel": k[:90], "launches": c, "ms": us * 1e-3}
                   for k, c, us in kernels[:15]]}
    report[key] = out
    log(f"{key}:", json.dumps(out))


def kernels_line(report):
    rows = {r["kernel"]: r for r in report.get("timings", [])
            if r["model"] in ("tinyllama", "mamba2") and r["B"] == 8 and r["S"] in (512, 2048)}
    paths = {"serve": report.get("launches", {}),
             "scheduled": report.get("launches_scheduled", {})}
    out = []
    for name, (src, replaces) in SOURCES.items():
        t = rows.get(name, {})
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        # each kernel's count on the path of its own slice: attention on the
        # FIFO serve path, the SSD scan on the scheduled path
        main = "scheduled" if name == "ssd_scan" else "serve"
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": by_path.get(main), "launches_by_path": by_path,
                    "max_abs_err": max(report.get("errors", {}).get(name, {}).values(),
                                       default=None),
                    "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
                    "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
                    "library_ms": t.get("library_ms")})
    return {"kernels": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA}")
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
           "parity": phase_parity, "serve": phase_serve, "scheduled": phase_scheduled,
           "profile": phase_profile, "profile_scheduled": phase_profile_scheduled}
    t_start = time.perf_counter()
    try:
        for ph in ("device",) + tuple(p for p in PHASES + EXTRA
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
