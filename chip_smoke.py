#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                   # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels  # build + kernel-vs-plain only
    python3 chip_smoke.py --phases kernels,scheduled  # + the scheduled serve
    python3 chip_smoke.py --phases profile  # a profiled, warm serve (not in the default run)
    python3 chip_smoke.py --phases profile_scheduled  # the same for the scheduled serve
    python3 chip_smoke.py --phases kernels,spec  # the kernels and the speculative serves
    python3 chip_smoke.py --phases kernels,joint  # the kernels and the joint-planned serve
    python3 chip_smoke.py --phases kernels,archs  # the kernels and the serves of the new archs
    python3 chip_smoke.py --phases kernels,encdec_hybrid  # + seamless-m4t and jamba in one engine
    python3 chip_smoke.py --phases kernels,bucketed,fleet  # + the bucketed mode and the fleet replay

Phases:
  1. device     the card's name and count, its power limit from nvidia-smi,
                and the kernels' build from ``src/repro_torch/kernels/csrc``
  2. kernels    every kernel against its plain PyTorch version on the card
                at the serving paths' shapes, bf16 and fp32: flash, decode
                (GQA groups 1-8, qwen2's 7), the absorbed-MLA attention
                (deepseek-v2-lite's 16 heads, Dk 576, Dv 512) at T = 1, 2, 5
                and 8 query rows per slot, its verify rows bit for bit equal
                to decode steps at the same positions, the SSD scan, and the
                encoder-decoder shapes: flash without a causal mask at Sq = Sk
                (the encoder) and Sq != Sk (the cross-attention's prefill),
                decode against a 512-frame region with per-row kv_len down
                to 0 (its decode), and jamba's 32/8 heads at D 128; then the
                bucketed and fleet phases' shapes: the fleet's decode at 4
                slots x 64 positions (one split) with free slots, the
                bucketed decode at one shared position per batch and the
                continuous pool's, flash at the fleet's short prompts and at
                the buckets, the SSD scan at the buckets' exact lengths
  3. parity     each model at full width, cut to 2 layers, fp32 and bf16:
                prefill (mamba2: a masked pow2 bucket) and 8 ragged decode
                steps through the kernels and through the plain versions
                agree; for deepseek-v2-lite (layer 0 dense, layer 1 MoE) the
                kernel run replays the plain run's expert choices and each
                router disagreement must sit at a printed near-tie; also
                seamless-m4t-medium (2 encoder + 2 decoder layers, per-row
                encoder lengths) and jamba-v0.1-52b cut to (mamba, mamba,
                attn), its second Mamba1 layer carrying the MoE
  4. serve      the FIFO path: tinyllama-1.1b and gemma2-2b at their full
                configs served concurrently by one continuous engine; every
                attention kernel must have launched there
  5. scheduled  the AdaOper-scheduled path (``repro_torch.launch.serve``'s
                default): tinyllama-1.1b, gemma2-2b and mamba2-2.7b at their
                full configs in one engine under ``AdaOperScheduler``; all
                three kernels must have launched there. Its joules are the
                device simulator's mobile-SoC predictions, not the card's.
                It records the (B, S) of every SSD scan call.
  6. joint      contention-aware joint planning on the scheduled path: the
                scheduled workload under ``AdaOperScheduler(coexec=
                CoexecPlanner())`` and, on fresh weights, without it; each
                arm warms up once and is measured once. All three kernels
                must have launched in the joint arm, at SSD shapes the
                kernels phase checked, and some plan must have been solved
                under a joint key; tokens per uid identical to the
                independent arm's, or apart only from a near-tie of its
                logits (printed). It prints each arm's plan-cache counters,
                DP solves, warm wall, launches and simulated joules.
  7. spec       speculative decoding through the port's engine API: a
                2-layer fp32 spec-vs-plain run per model (token-identical),
                then full depth in bf16: tinyllama-1.1b with its truncated
                self-draft under the AdaOper scheduler (``run_trace`` and
                ``run_all``, greedy and at temperature 0.8) and gemma2-2b
                with a random 1-layer draft under FIFO, and tinyllama-1.1b
                with a differently seeded 1-layer draft under FIFO (most
                drafts rolled back), each beside the same engine without a
                draft; tokens identical to it, or apart only from a near-tie
                of its logits (printed). Then deepseek-v2-lite-16b, whose
                verify runs through the MLA kernel and never flash: 2 layers
                fp32 drop-free with a random 1-layer draft (token-identical),
                the full config bf16 at capacity 1.25 with its truncated
                draft, scheduled, ``run_trace`` (acceptance and committed
                tokens per target step reported; spec and plain tokens may
                differ at that capacity), and the same drop-free (tokens
                identical but for printed near-ties)
  8. archs      the archs of the seventh slice through
                ``repro_torch.launch.serve``: deepseek-v2-lite-16b (MLA,
                MoE) and qwen2-7b (qkv bias, G = 7) at their full configs
                under the AdaOper scheduler, then granite-3-8b at its full
                config and chameleon-34b at full width cut to 8 of its 48
                layers (qk-norm) under FIFO; flash, decode and the MLA
                attention kernel must have launched as the workers' passes
                imply
  9. encdec_hybrid  seamless-m4t-medium at its full config (12 + 12 layers)
                beside jamba-v0.1-52b at full width cut to 8 of its 32 layers
                (one whole period: 4 Mamba1, attention, 3 Mamba1; MoE on 1,
                3, 5, 7) in one engine under ``AdaOperScheduler``: a speech
                translator next to a chat LLM. Every request completes and
                flash and decode launched as the workers' passes imply
                (per seamless prefill 12 encoder + 12 self + 12 cross flash
                launches, per decode step 12 + 12 decode launches; jamba's
                one attention layer per pass); it prints the peak memory,
                the wall time and the admission reasons
 10. bucketed   the position-synchronous path (``ServingEngine(mode=
                "bucketed")``, ``ModelWorker.generate``): tinyllama-1.1b,
                gemma2-2b and mamba2-2.7b at their full configs in bf16 under
                ``AdaOperScheduler``, 8 requests each in two prompt-length
                buckets, 8 new tokens, greedy; then the same requests in
                continuous mode on the same weights: tokens per uid identical,
                or apart only from a near-tie of the continuous run's logits
                (printed; an untimed rerun of the continuous engine records
                them, so that no mode's wall time includes the recorder); flash, decode and the SSD scan launched as the
                ``generate`` calls imply; then tinyllama-1.1b FIFO at
                temperature 0.8 in both modes, one bucket of 4 at a time:
                tokens identical (the same per-request streams). It prints
                each run's wall time, the batches the scheduler chose and the
                peak memory
 11. fleet      the fleet replay (``repro_torch.fleet.FleetReplay``, backend
                ``serving``): 3 simulated phones (``sample_population(3)``),
                10 s of chaos_mixed traffic each (voice assistant, video and
                AR frames under an injected fault schedule), the uncertainty
                layer on every device's profiler and risk-aware admission at
                0.9; the assistant is full tinyllama-1.1b in bf16 on the card,
                the frames run through the operator-graph path on the same
                virtual timeline. Run twice: the reports must be equal; every
                arrival is a record or a rejection; faults, recoveries and
                interval coverage are reported; flash and decode launched as
                the devices' engines' passes imply. Then the same population
                under mixed traffic with point estimates. It prints per arm
                the simulated energy per request (DeviceSim's phone rails, not
                the card's), SLO attainment, virtual latency percentiles,
                interval coverage and width, the fault, shed and deadline
                counters, the wall time and the launches
 12. times      CUDA-event device times of each kernel, its plain version
                and one PyTorch library call (a yardstick only), beside the
                bound; for the attention kernels and the library call also
                the wall time per call back to back (host enqueue included);
                flash also at the verify's shapes (T query rows per slot
                against the cache), the MLA kernel at T = 1 and T = 5; the
                SSD scan also at the scheduled
                serve's (B, S) (``SSD_SERVE``, and any other this run's
                scheduled phase gave it); flash and decode at the
                encdec_hybrid serve's seamless and jamba shapes
  profile       (only when asked for) the serve phase's run again, warm:
                its untraced wall time, then under torch.profiler the device
                time by kernel and the device's idle share of the wall time
  profile_scheduled  (only when asked for) the same for the scheduled phase
  profile_spec  (only when asked for) the same for the spec phase's
                scheduled tinyllama-1.1b engine with its draft (``run_all``)
  profile_archs (only when asked for) the same for the archs phase's
                scheduled serve of deepseek-v2-lite-16b and qwen2-7b
  profile_encdec_hybrid (only when asked for) the same for the
                encdec_hybrid serve, with the device time under each model's
                passes and under jamba's Mamba1 mixers
  profile_spec_deepseek (only when asked for) the same for the spec
                phase's full deepseek-v2-lite-16b engine with its truncated
                draft, capacity 1.25 (``run_all``)
  profile_bucketed (only when asked for) the same for the bucketed
                phase's bucketed-mode serve of the three models
  profile_fleet (only when asked for) the same for the fleet phase's
                chaos replay, with the device and host time under the
                assistant's model passes
  mla_parts     (only when asked for) the MLA kernel's device time taken
                apart: the timing floor, slots that keep one latent row or
                one tile, rows over 2, 4 and 16 splits (the merge), the
                serve's T = 1 and the verify's T = 2 and 5, at the planned
                split and at 128 and 256 keys

Each serving phase sets every kernel's launch count to 0 just before it
drives its path and reads the counts just after.

It prints a ``kernels`` JSON line, the nvidia-smi line and, last, the
``{"ok": true, "device": ...}`` line. Any failure exits nonzero with no
result line. It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("device", "kernels", "parity", "serve", "scheduled", "joint", "spec", "archs",
          "encdec_hybrid", "bucketed", "fleet", "times")
EXTRA = ("profile", "profile_scheduled", "profile_spec", "profile_archs",
         "profile_spec_deepseek", "mla_parts", "profile_encdec_hybrid", "profile_bucketed",
         "profile_fleet")  # only when asked for
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
# the scheduled serve's SSD scan calls: (B, S, every row's left padding), the
# 96- and 200-token prompts in their pow2 buckets of 128 and 256
SSD_SERVE = ((1, 64, 0), (2, 256, 56), (2, 512, 0), (4, 128, 32))
DECODE_POS = (0, 1, 63, 64, 500, 1023, 2046, 2047)
QWEN2 = dict(H=28, Hkv=4, D=128, softcap=None)  # qwen2-7b attention, G = 7
# deepseek-v2-lite-16b: the naive-form MLA prefill (16 heads, Dk = nope +
# rope = 192, Dv 128) and the absorbed attention of the decode and the
# verify (16 heads on one latent head of 512 + 64, values its first 512
# columns), scale 192^-0.5 in both; the MLA kernel's T per slot
MLA_PREFILL = dict(H=16, Hkv=16, Dk=192, Dv=128)
MLA_DECODE = dict(H=16, Hkv=1, Dk=576, Dv=512)
MLA_SCALE = 192 ** -0.5
MLA_T = (1, 2, 5, 8)
# seamless-m4t-medium's attention (MHA, G = 1) and jamba-v0.1-52b's (G = 4)
SEAMLESS = dict(H=16, Hkv=16, D=64)
JAMBA = dict(H=32, Hkv=8, D=128)
# the encdec_hybrid serve: seamless's requests (decoder prompts, encoder
# frames in a 512-frame cross region) and jamba's, cut to one period
ENCDEC = dict(name="seamless-m4t-medium", requests=8, prompt_lens=(4, 8, 16, 32),
              enc_lens=(100, 200, 300, 500), max_enc_len=512, max_new=32)
HYBRID = dict(name="jamba-v0.1-52b", requests=8, prompt_lens=(64, 128, 256, 512), max_new=16,
              layers=8)
ENCDEC_HYBRID = dict(max_slots=8, max_len=1024, seed=0, workload="moderate")
# the bucketed phase: three models, two prompt-length buckets of 4 requests
# each; 200 is off the pow2 grid, so the continuous mamba2 admits a masked
# 256-long bucket where the bucketed step prefills the exact length; the
# sampled pair runs one model FIFO at this temperature
BUCKETED = dict(names=("tinyllama-1.1b", "gemma2-2b", "mamba2-2.7b"), requests=8,
                prompt_lens=(64, 200), max_new=8, max_slots=8, max_len=1024, seed=0,
                workload="moderate", sampled="tinyllama-1.1b", temperature=0.8)
# the fleet phase: a population of simulated phones replaying chaos_mixed
# traffic for duration_s of virtual time, the assistant full tinyllama-1.1b
# (FleetReplay's max_slots and its engines' max_len: the decode's shape)
FLEET = dict(devices=3, population_seed=0, scenario="chaos_mixed", baseline="mixed",
             duration_s=10.0, seed=5, calib_samples=120, risk_level=0.9,
             assistant="tinyllama-1.1b", max_slots=4, max_len=64)
# jamba in the parity phase: the 3-layer stack whose Mamba1 layer 1 has MoE
JAMBA_PARITY = ("mamba", "mamba", "attn")
# the archs phase: (a) the two archs that need the new kernels, under the
# scheduler at the scheduled phase's parameters; (b) the other two FIFO,
# chameleon-34b cut to 8 of its 48 layers (63.9 GiB in bf16 at full depth)
ARCHS_SCHEDULED = dict(SCHEDULED, names=("deepseek-v2-lite-16b", "qwen2-7b"))
ARCHS_FIFO = dict(SCHEDULED, names=("granite-3-8b", "chameleon-34b"), scheduler=False,
                  layers={"chameleon-34b": 8})
# a router top-k flip between the kernel and plain runs of the bf16 parity
# (the MoE layer's input differs by the attention kernels' rounding) is
# allowed only where the plain run's k-th and (k+1)-th router logits lie
# within this of each other
ROUTER_TIE = 0.05
# the speculative serves: 8 requests per engine at the serve's shapes; the
# target verifies T = k + 1 <= 5 positions per slot (SpecConfig.k_max 4)
SPEC = dict(requests=8, prompt_lens=(64, 128, 256, 512), max_new=16, max_slots=8,
            max_len=1024, seed=0)
VERIFY_T = (2, 3, 5, 16)
# the verify's q_offset per slot in the times phase: the serve's prompt
# lengths 8 tokens into their generation
VERIFY_POS = (72, 136, 264, 520, 136, 264, 520, 72)
# the kernels line's source is the bf16 route's, whose times it carries;
# the fp32 routes (exact fp32 for the parity checks) are
# csrc/flash_attention.cu, csrc/ssd_scan.cu and csrc/decode_attention_mla.cu.
# The MLA kernel also takes flash's place (flash_attention.py:106) at the
# MLA verify's shape
SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
                        "src/repro/kernels/flash_attention.py:106"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:87"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan_bf16.cu",
                 "src/repro/kernels/ssd_scan.py:92"),
    "mla_attention": ("src/repro_torch/kernels/csrc/mla_attention_bf16.cu",
                      "src/repro/kernels/decode_attention.py:87"),
}


# the device kernels' names (csrc/*.cu) by the wrapper that launches them,
# for the profile's device time by group
KERNEL_GROUPS = {"flash_fwd_bf16_kernel": "flash_attention",
                 "flash_fwd_fp32_kernel": "flash_attention",
                 "decode_split_kernel": "decode_attention",
                 "mla_attention_bf16_kernel": "mla_attention",
                 "mla_attention_fp32_kernel": "mla_attention",
                 "ssd_state_bf16_kernel": "ssd_scan",
                 "ssd_out_bf16_kernel": "ssd_scan",
                 "ssd_scan_fp32_kernel": "ssd_scan"}


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


def flash_bound(B, S, H, Hkv, D, window, dtype_name, elem, Dv=None):
    """2·H·(Dk + Dv) FLOPs per kept (query, key) pair; q, k, v, o once."""
    Dv = D if Dv is None else Dv
    pairs = B * sum(kept_keys(i, S, S, True, window) for i in range(S))
    nbytes = elem * (B * S * H * (D + Dv) + B * S * Hkv * (D + Dv))
    return bound(2 * H * (D + Dv) * pairs, nbytes, dtype_name)


def flash_bound_full(B, Sq, Sk, H, Hkv, D, dtype_name, elem):
    """Flash without a mask (the encoder, the cross-attention's prefill):
    every (query, key) pair kept; q, k, v, o once."""
    nbytes = elem * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D)
    return bound(4 * H * D * B * Sq * Sk, nbytes, dtype_name)


def decode_bound_kept(kept, B, H, Hkv, D, dtype_name, elem):
    """Decode over ``kept`` K/V entries in all: each read once, q and o
    once, 4·H·D FLOPs per entry."""
    nbytes = elem * (kept * Hkv * 2 * D + 2 * B * H * D)
    return bound(4 * H * D * kept, nbytes, dtype_name)


def decode_bound(pos, Smax, H, Hkv, D, window, dtype_name, elem):
    kept = sum(kept_keys(p, p + 1, Smax, False, window) for p in pos)
    return decode_bound_kept(kept, len(pos), H, Hkv, D, dtype_name, elem)


def mla_bound(offs, T, Smax, dtype_name, elem):
    """The absorbed-MLA attention of T causal rows per slot at ``offs``
    (T = 1: the decode step, kv_len = offs + 1): each latent row that some
    row keeps (those of the last row) read once, its first 512 columns
    being the values, q and o once; 2·H·(Dk + Dv) FLOPs per kept (row,
    key) pair."""
    H, Hkv, Dk, Dv = (MLA_DECODE[x] for x in ("H", "Hkv", "Dk", "Dv"))
    pairs = sum(kept_keys(o + t, Smax, Smax, True, None) for o in offs for t in range(T))
    rows = sum(kept_keys(o + T - 1, Smax, Smax, True, None) for o in offs)
    nbytes = elem * (rows * Hkv * Dk + len(offs) * T * H * (Dk + Dv))
    return bound(2 * H * (Dk + Dv) * pairs, nbytes, dtype_name)


def verify_offsets(Smax, T):
    """Per-row q_offset of a speculative verify over 8 slots: 0, 63, 64,
    500, Smax - T (the last position that fits) and Smax - 2 (q_offset + T
    past the cache), and two more inside it."""
    return [0, 63, 64, 500, Smax - T, Smax - 2, 127, Smax // 2 + 1]


def verify_bound(offs, T, Smax, H, Hkv, D, window, dtype_name, elem):
    """Flash at a verify's shape: the (query, key) pairs the causal mask
    keeps; q and o once, and K and V of the keys some query of the row
    keeps (the rest of the cache is never needed)."""
    pairs = sum(kept_keys(o + t, Smax, Smax, True, window) for o in offs for t in range(T))
    keys = sum(min(Smax, o + T) - (max(0, o - window + 1) if window else 0) for o in offs)
    nbytes = elem * (2 * len(offs) * T * H * D + 2 * keys * Hkv * D)
    return bound(4 * H * D * pairs, nbytes, dtype_name)


def ssd_inputs(torch, gen, B, S, dtype, H=MAMBA["H"], P=MAMBA["P"], N=MAMBA["N"],
               dt_shift=-4.0):
    """Scan inputs as the model makes them: dt = softplus(randn + dt_shift)
    > 0 (~0.02 at -4, ~0.7 at 0), per-head A = -(1..16), dA = dt * A in
    fp32; x, B, C in ``dtype``."""

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(r(B, S, H) + dt_shift)
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
            if ("registers" in line or "spill" in line.lower() or "entry function" in line
                    or line.startswith("==")):
                log("  ptxas:", line.strip())


def phase_kernels(torch, report):
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import mla_attention as mmod
    from repro_torch.kernels import ssd_scan as smod
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_attention": {}, "decode_attention": {}, "ssd_scan": {}, "mla_attention": {}}
    verify_errs = {}
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
        for case, out, ref in flash_verify_cases(torch, gen, fmod, dtype):
            compare("flash_attention", f"verify {case} {dtype}", dtype, out, ref)
            key = str(dtype).split(".")[-1]
            verify_errs[key] = max(verify_errs.get(key, 0.0),
                                   float((out.float() - ref.float()).abs().max()))
        for case, out, ref in decode_edge_cases(torch, gen, dmod, dtype):
            compare("decode_attention", f"edge {case} {dtype}", dtype, out, ref)
        for case, out, ref in arch_decode_cases(torch, gen, dmod, dtype):
            compare("decode_attention", f"{case} {dtype}", dtype, out, ref)
        for case, out, ref in mla_cases(torch, gen, mmod, dtype):
            compare("mla_attention", f"{case} {dtype}", dtype, out, ref)
        if not mla_rows_match_decode_steps(torch, gen, mmod, dtype):
            misses.append(f"mla_attention {dtype}: a verify row differs from the decode step "
                          f"at its position")
        for case, out, ref in arch_flash_cases(torch, gen, fmod, dtype):
            compare("flash_attention", f"{case} {dtype}", dtype, out, ref)
        for kernel, case, out, ref in encdec_hybrid_cases(torch, gen, fmod, dmod, dtype):
            compare(kernel, f"{case} {dtype}", dtype, out, ref)
        for kernel, case, out, ref in bucketed_fleet_cases(torch, gen, fmod, dmod, smod, dtype):
            if kernel == "ssd_scan":  # (y, final state), the state fp32 in both dtypes
                compare(kernel, f"{case} {dtype} y", dtype, out[0], ref[0], SSD_TOL)
                compare(kernel, f"{case} {dtype} state", torch.float32, out[1], ref[1], SSD_TOL)
            else:
                compare(kernel, f"{case} {dtype}", dtype, out, ref)
        for case, (y, h), (ry, rh) in ssd_edge_cases(torch, gen, smod, dtype):
            compare("ssd_scan", f"{case} {dtype} y", dtype, y, ry, SSD_TOL)
            compare("ssd_scan", f"{case} {dtype} state", torch.float32, h, rh, SSD_TOL)
    torch.cuda.synchronize()
    report["errors"] = errs
    log("kernel vs plain, max abs err:", json.dumps(errs))
    log("flash at verify shapes, max abs err:", json.dumps(verify_errs))
    log("MLA verify rows bit for bit equal to decode steps at the same positions: "
        f"{not any('verify row' in m for m in misses)}")
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
    for G in (1, 2, 4, 7, 8):
        yield run(f"G={G}", 2, 130, 130, 2 * G, 2, 128)
    yield run("Dk 64 Dv 32", 2, 130, 130, 4, 2, 64, Dv=32)


def flash_verify_cases(torch, gen, fmod, dtype):
    """(case, kernel output, plain output) at the speculative verify's
    shapes: 8 slots of T query rows against the whole cache (Smax 1024 and
    1000) at per-row offsets (``verify_offsets``), kv_len None and causal,
    random K/V in every cache row (the stale entries of rejected drafts);
    tinyllama's heads, and gemma2's with softcap 50 and window 4096."""
    for name, hd, window in (("tinyllama", TINY, None), ("gemma2", GEMMA, 4096)):
        for Smax in (1024, 1000):
            for T in VERIFY_T:
                q, _, _ = qkv(torch, gen, 8, T, 1, hd["H"], hd["Hkv"], hd["D"], dtype)
                _, k, v = qkv(torch, gen, 8, 1, Smax, hd["H"], hd["Hkv"], hd["D"], dtype)
                offs = torch.tensor(verify_offsets(Smax, T), dtype=torch.int32, device="cuda")
                kw = dict(causal=True, window=window, softcap=hd["softcap"], q_offset=offs)
                yield (f"{name} T={T} Smax={Smax}", fmod.flash_attention(q, k, v, **kw),
                       fmod.flash_attention_plain(q, k, v, **kw))


def decode_edge_cases(torch, gen, dmod, dtype):
    """(case, kernel output, plain output) at the split-KV kernel's split
    edges: Smax 1000 (not a multiple of the planned split), kv_len on a
    split boundary, one before and one past it, a window that starts inside
    a split and one that spans splits, every GQA group and Dv."""
    B, Smax, Hkv = 8, 1000, 2
    L = dmod.plan_splits(Smax, B, Hkv)[1]
    pos = torch.tensor([0, L - 2, L - 1, L, 2 * L - 1, 2 * L, Smax - 2, Smax - 1],
                       dtype=torch.int32, device="cuda")
    for G in (1, 2, 4, 7, 8):
        for D in (64, 128, 256):
            q, _, _ = qkv(torch, gen, B, 1, 1, G * Hkv, Hkv, D, dtype)
            _, k, v = qkv(torch, gen, B, 1, Smax, G * Hkv, Hkv, D, dtype)
            for window, softcap in ((None, None), (L // 2 + 3, None), (2 * L + 5, 50.0)):
                kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=softcap)
                yield (f"G={G} D={D} Smax={Smax} split={L} w={window} cap={softcap}",
                       dmod.decode_attention(q, k, v, **kw), dmod.decode_attention_plain(q, k, v, **kw))


def mla_inputs(torch, gen, B, T, Smax, dtype, shared=True):
    """q (B,T,16,576) and a latent cache (B,Smax,1,576) whose first 512
    columns are the values, as ``models.attention.mla_decode`` passes them,
    or values of their own (``shared=False``)."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    H, Hkv, Dk, Dv = (MLA_DECODE[x] for x in ("H", "Hkv", "Dk", "Dv"))
    q, k = r(B, T, H, Dk), r(B, Smax, Hkv, Dk)
    return q, k, (k[..., :Dv] if shared else r(B, Smax, Hkv, Dv))


def arch_decode_cases(torch, gen, dmod, dtype):
    """(case, kernel output, plain output): decode at qwen2-7b's heads (28
    on 4, D 128, G = 7), 8 slots at DECODE_POS (clipped to the cache) with
    Smax 2048 and 1024 (the serve's max_len), and with the last slot parked
    at Smax (a retired slot)."""
    B = len(DECODE_POS)
    for Smax in (2048, 1024):
        for parked in (False, True):
            pos_list = [min(p, Smax - 1) for p in DECODE_POS]
            if parked:
                pos_list[-1] = Smax
            pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
            kw = dict(q_offset=pos, kv_len=pos + 1)
            q, _, _ = qkv(torch, gen, B, 1, 1, QWEN2["H"], QWEN2["Hkv"], QWEN2["D"], dtype)
            _, k, v = qkv(torch, gen, B, 1, Smax, QWEN2["H"], QWEN2["Hkv"], QWEN2["D"], dtype)
            yield (f"qwen2 G=7 Smax={Smax} parked={parked}",
                   dmod.decode_attention(q, k, v, **kw), dmod.decode_attention_plain(q, k, v, **kw))


def mla_cases(torch, gen, mmod, dtype):
    """(case, kernel output, plain output) of the MLA attention kernel at
    T = 1, 2, 5 and 8 query rows per slot, values the latent rows' first
    512 columns or a tensor of their own: 8 slots against Smax 1024 (the
    serve's max_len) and 2048, the decode step at DECODE_POS (clipped to the
    cache) with the last slot parked at Smax, the verify causal at
    ``verify_offsets`` (rows past the cache included); then the split edges
    at Smax 1000, with a window and a softcap (which DeepSeek does not use)
    and with kv_len at the offsets (the first slot keeps no key)."""
    from repro_torch.kernels.decode_attention import plan_splits
    B = len(DECODE_POS)

    def run(case, q, k, v, **kw):
        kw["scale"] = MLA_SCALE
        return case, mmod.mla_attention(q, k, v, **kw), mmod.mla_attention_plain(q, k, v, **kw)

    for Smax in (1024, 2048):
        for shared in (True, False):
            for T in MLA_T:
                q, k, v = mla_inputs(torch, gen, B, T, Smax, dtype, shared)
                if T == 1:
                    pos_list = [min(p, Smax - 1) for p in DECODE_POS]
                    pos_list[-1] = Smax
                    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
                    kw = dict(causal=False, q_offset=pos, kv_len=pos + 1)
                else:
                    kw = dict(causal=True, q_offset=torch.tensor(
                        verify_offsets(Smax, T), dtype=torch.int32, device="cuda"))
                yield run(f"MLA T={T} Smax={Smax} shared={shared}", q, k, v, **kw)
    Smax = 1000
    L = plan_splits(Smax, B, 1)[1]
    edge = torch.tensor([0, L - 2, L - 1, L, 2 * L - 1, 2 * L, Smax - 2, Smax - 1],
                        dtype=torch.int32, device="cuda")
    for T in MLA_T:
        q, k, v = mla_inputs(torch, gen, B, T, Smax, dtype)
        for window, softcap in ((None, None), (L // 2 + 3, None), (2 * L + 5, 50.0)):
            yield run(f"MLA edge T={T} Smax={Smax} split={L} w={window} cap={softcap}", q, k, v,
                      causal=True, q_offset=edge, window=window, softcap=softcap)
        yield run(f"MLA edge T={T} Smax={Smax} kv_len=q_offset", q, k, v, causal=True,
                  q_offset=edge, kv_len=edge)


def mla_rows_match_decode_steps(torch, gen, mmod, dtype):
    """Whether T = 5 verify rows at VERIFY_POS equal, bit for bit, five
    decode steps at those positions on the same q rows (the kernel's rows
    reduce alike whatever T is)."""
    q, k, v = mla_inputs(torch, gen, len(VERIFY_POS), 5, 1024, dtype)
    offs = torch.tensor(VERIFY_POS, dtype=torch.int32, device="cuda")
    ver = mmod.mla_attention(q, k, v, causal=True, q_offset=offs, scale=MLA_SCALE)
    for t in range(q.shape[1]):
        p = offs + t
        dec = mmod.mla_attention(q[:, t:t + 1].contiguous(), k, v, causal=False, q_offset=p,
                                 kv_len=p + 1, scale=MLA_SCALE)
        if not torch.equal(dec[:, 0], ver[:, t]):
            return False
    return True


def arch_flash_cases(torch, gen, fmod, dtype):
    """(case, kernel output, plain output): flash at deepseek-v2-lite's
    naive-form MLA prefill (16 heads, Dk 192, Dv 128, scale 192^-0.5) and
    at qwen2-7b's G = 7 (28 on 4, D 128), causal, at the archs serve's
    prefill shapes and beside the kernel's tile edges."""
    for B, S in ((1, 64), (2, 96), (2, 200), (8, 512), (1, 17), (2, 129), (4, 65)):
        q, k, _ = qkv(torch, gen, B, S, S, MLA_PREFILL["H"], MLA_PREFILL["Hkv"],
                      MLA_PREFILL["Dk"], dtype)
        v = qkv(torch, gen, B, 1, S, 1, MLA_PREFILL["Hkv"], MLA_PREFILL["Dv"], dtype)[2]
        kw = dict(causal=True, scale=MLA_SCALE)
        yield (f"MLA prefill B={B} S={S}", fmod.flash_attention(q, k, v, **kw),
               fmod.flash_attention_plain(q, k, v, **kw))
        q, k, v = qkv(torch, gen, B, S, S, QWEN2["H"], QWEN2["Hkv"], QWEN2["D"], dtype)
        yield (f"qwen2 G=7 B={B} S={S}", fmod.flash_attention(q, k, v, causal=True),
               fmod.flash_attention_plain(q, k, v, causal=True))


ENC_SQ_SK = (1, 17, 100, 255, 500, 512)  # the encoder's frames, around the tiles
CROSS_SQ, CROSS_SK = (2, 4, 17, 32), (100, 257, 500)  # prompt rows against frames
ENC_KV_LEN = (0, 1, 63, 64, 100, 257, 511, 512)  # per-slot encoder lengths, 0 a slot never admitted


def encdec_hybrid_cases(torch, gen, fmod, dmod, dtype):
    """(kernel, case, kernel output, plain output) at the encdec_hybrid
    serve's shapes: flash without a causal mask at seamless's heads (16 on
    16, D 64), the encoder's Sq = Sk (ENC_SQ_SK) and the cross-attention's
    prefill, Sq prompt rows against Sk frames; decode at G 1, D 64, one
    query per slot at q_offset 0 against a 512-frame region with per-slot
    kv_len ENC_KV_LEN, no window; jamba's attention (32 on 8, D 128):
    flash causal at its prompt lengths, decode at DECODE_POS in a
    1024-entry cache with a parked slot."""
    sm, jb = SEAMLESS, JAMBA
    for S in ENC_SQ_SK:
        q, k, v = qkv(torch, gen, 2, S, S, sm["H"], sm["Hkv"], sm["D"], dtype)
        yield ("flash_attention", f"seamless encoder S={S}",
               fmod.flash_attention(q, k, v, causal=False),
               fmod.flash_attention_plain(q, k, v, causal=False))
    for Sq in CROSS_SQ:
        for Sk in CROSS_SK:
            q, k, v = qkv(torch, gen, 4, Sq, Sk, sm["H"], sm["Hkv"], sm["D"], dtype)
            yield ("flash_attention", f"seamless cross Sq={Sq} Sk={Sk}",
                   fmod.flash_attention(q, k, v, causal=False),
                   fmod.flash_attention_plain(q, k, v, causal=False))
    kl = torch.tensor(ENC_KV_LEN, dtype=torch.int32, device="cuda")
    q, _, _ = qkv(torch, gen, len(ENC_KV_LEN), 1, 1, sm["H"], sm["Hkv"], sm["D"], dtype)
    _, k, v = qkv(torch, gen, len(ENC_KV_LEN), 1, 512, sm["H"], sm["Hkv"], sm["D"], dtype)
    out = dmod.decode_attention(q, k, v, q_offset=0, kv_len=kl)
    if out[0].any():
        raise SmokeFailure(f"decode {dtype}: a slot with kv_len 0 wrote a nonzero row")
    yield ("decode_attention", "seamless cross G=1 Smax=512 per-row kv_len", out,
           dmod.decode_attention_plain(q, k, v, q_offset=0, kv_len=kl))
    for B, S in ((1, 64), (2, 200), (8, 512), (1, 17)):
        q, k, v = qkv(torch, gen, B, S, S, jb["H"], jb["Hkv"], jb["D"], dtype)
        yield ("flash_attention", f"jamba B={B} S={S}", fmod.flash_attention(q, k, v, causal=True),
               fmod.flash_attention_plain(q, k, v, causal=True))
    pos_list = [min(p, 1023) for p in DECODE_POS]
    pos_list[-1] = 1024
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    q, _, _ = qkv(torch, gen, len(pos_list), 1, 1, jb["H"], jb["Hkv"], jb["D"], dtype)
    _, k, v = qkv(torch, gen, len(pos_list), 1, 1024, jb["H"], jb["Hkv"], jb["D"], dtype)
    kw = dict(q_offset=pos, kv_len=pos + 1)
    yield ("decode_attention", "jamba G=4 Smax=1024 parked", dmod.decode_attention(q, k, v, **kw),
           dmod.decode_attention_plain(q, k, v, **kw))


# the fleet's device engines: 4 slots of 64 positions (one split of the
# decode kernel); per-slot positions, a slot at 64 parked (free)
FLEET_DECODE_POS = ((0, 8, 23, 63), (5, 17, 40, 64), (64, 64, 12, 64), (30, 31, 62, 63))


def bucketed_fleet_cases(torch, gen, fmod, dmod, smod, dtype):
    """(kernel, case, kernel output, plain output; for the SSD scan (y,
    state) pairs) at the bucketed and fleet phases' shapes: the fleet's
    decode at tinyllama's heads, 4 slots x Smax 64 (``plan_splits`` gives
    one split) at FLEET_DECODE_POS; the bucketed decode, B rows at one
    shared position (a bucket's prompt length, then 7 steps on) and the
    continuous pool's 8 slots at per-slot positions with one parked, in a
    1024-entry cache at tinyllama's and gemma2's heads; flash causal at
    the fleet's prompts (B 1-4, S 8-48) and at the buckets (64 and 200
    tokens, B 2 and 4); the SSD scan at the bucketed prefills' exact
    lengths (B 2 and 4, S 64 and 200, unmasked)."""
    if dmod.plan_splits(FLEET["max_len"], FLEET["max_slots"], TINY["Hkv"])[0] != 1:
        raise SmokeFailure("the fleet's decode shape no longer plans one split")

    def decode(case, hd, pos_list, Smax, window=None):
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=hd["softcap"])
        q, _, _ = qkv(torch, gen, len(pos_list), 1, 1, hd["H"], hd["Hkv"], hd["D"], dtype)
        _, k, v = qkv(torch, gen, len(pos_list), 1, Smax, hd["H"], hd["Hkv"], hd["D"], dtype)
        return ("decode_attention", f"{case} Smax={Smax} pos={pos_list} w={window}",
                dmod.decode_attention(q, k, v, **kw), dmod.decode_attention_plain(q, k, v, **kw))

    def flash(case, hd, B, S, window=None):
        q, k, v = qkv(torch, gen, B, S, S, hd["H"], hd["Hkv"], hd["D"], dtype)
        kw = dict(causal=True, window=window, softcap=hd["softcap"])
        return ("flash_attention", f"{case} B={B} S={S} w={window}",
                fmod.flash_attention(q, k, v, **kw), fmod.flash_attention_plain(q, k, v, **kw))

    for pos_list in FLEET_DECODE_POS:
        yield decode("fleet tinyllama", TINY, pos_list, FLEET["max_len"])
    Smax = BUCKETED["max_len"]
    for name, hd, windows in (("tinyllama", TINY, (None,)), ("gemma2", GEMMA, (None, 4096))):
        for window in windows:
            for B in (2, 4):
                for p in BUCKETED["prompt_lens"]:
                    for step in (0, BUCKETED["max_new"] - 2):  # the first and last decode step
                        yield decode(f"bucketed {name}", hd, [p + step] * B, Smax, window)
            pool = [0, 63, 64, 70, 199, 206, 511, Smax]
            yield decode(f"continuous {name}", hd, pool, Smax, window)
            for B in (2, 4):
                for S in BUCKETED["prompt_lens"]:
                    yield flash(f"bucketed {name}", hd, B, S, window)
    for B in (1, 2, 3, 4):
        for S in (8, 23, 48):
            yield flash("fleet tinyllama", TINY, B, S)
    for B in (2, 4):
        for S in BUCKETED["prompt_lens"]:
            args = ssd_inputs(torch, gen, B, S, dtype)
            kw = dict(mask=None, chunk=MAMBA["chunk"])
            yield ("ssd_scan", f"bucketed mamba2 B={B} S={S}", smod.ssd_scan(*args, **kw),
                   smod.ssd_scan_plain(*args, **kw))


def left_padded(torch, B, S):
    """A (B, S) mask whose rows are left-padded by different widths, as a
    mamba2 pow2 prefill bucket is (row 0 by S // 3, the last by S // 2)."""
    m = torch.ones(B, S, dtype=torch.bool, device="cuda")
    m[0, :S // 3] = False
    m[B - 1, :S // 2] = False
    return m


def ssd_edge_cases(torch, gen, smod, dtype):
    """(case, kernel (y, state), plain (y, state)) for the SSD scan at
    mamba2-2.7b's heads: S on and beside the 64-position tiles and the
    256-position chunk (1, 63, 64, 65, 255, 256, 257, 1024 and the serving
    buckets 200, 512), B 1 and 8, unmasked and with left-padded rows; the
    scheduled serve's (B, S) and masks at dt ~0.02 and ~0.7; then head
    counts that are not a multiple of the bf16 kernel's head pair, and P, N
    below the tiles' widths."""
    chunk = MAMBA["chunk"]

    def run(case, B, S, mask=None, **kw):
        args = ssd_inputs(torch, gen, B, S, dtype, **kw)
        return (f"{case} B={B} S={S} masked={mask is not None}",
                smod.ssd_scan(*args, mask=mask, chunk=chunk),
                smod.ssd_scan_plain(*args, mask=mask, chunk=chunk))

    for B in (1, 8):
        for S in (1, 63, 64, 65, 200, 255, 256, 257, 512, 1024):
            yield run("mamba2", B, S)
            if S > 1:
                yield run("mamba2", B, S, left_padded(torch, B, S))
    for dt_shift in (-4.0, 0.0):
        for B, S, pad in SSD_SERVE:
            mask = torch.ones(B, S, dtype=torch.bool, device="cuda")
            mask[:, :pad] = False
            yield run(f"serve pad={pad} dt_shift={dt_shift}", B, S, mask, dt_shift=dt_shift)
    yield run("dt_shift=0", 8, 512, dt_shift=0.0)
    yield run("dt_shift=0", 2, 300, left_padded(torch, 2, 300), dt_shift=0.0)
    for H in (1, 5, 79):
        yield run(f"H={H}", 2, 300, left_padded(torch, 2, 300), H=H)
    yield run("H=3 P=32 N=64", 2, 130, H=3, P=32, N=64)
    yield run("H=4 P=16 N=16", 1, 70, H=4, P=16, N=16)


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
    for name, hd in (("tinyllama", TINY), ("gemma2", GEMMA)):
        for T in (2, 5):
            B, Smax = len(VERIFY_POS), 1024
            pos = torch.tensor(VERIFY_POS, dtype=torch.int32, device="cuda")
            q, _, _ = qkv(torch, gen, B, T, 1, hd["H"], hd["Hkv"], hd["D"], bf16)
            _, k, v = qkv(torch, gen, B, 1, Smax, hd["H"], hd["Hkv"], hd["D"], bf16)
            kw = dict(causal=True, softcap=hd["softcap"], q_offset=pos)
            qpos = pos[:, None] + torch.arange(T, device="cuda")  # (B, T)
            mask = (torch.arange(Smax, device="cuda") <= qpos[..., None])[:, None]  # (B,1,T,Smax)
            ms = time_ms(torch, lambda: fmod.flash_attention(q, k, v, **kw), flush)
            plain = time_ms(torch, lambda: fmod.flash_attention_plain(q, k, v, **kw), flush)
            lib = (None if hd["softcap"] else
                   time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask), flush))
            b_ms, b_by = verify_bound(VERIFY_POS, T, Smax, hd["H"], hd["Hkv"], hd["D"], None,
                                      "bfloat16", 2)
            rows.append(dict(kernel="flash_attention", model=name, B=B, S=Smax, T=T,
                             shape="verify", dtype="bfloat16", ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                             call_ms=call_ms(torch, lambda: fmod.flash_attention(q, k, v, **kw)),
                             library_call_ms=None if lib is None else call_ms(
                                 torch, lambda: sdpa(q, k, v, attn_mask=mask))))
    rows += arch_times(torch, gen, flush, sdpa)
    rows += encdec_hybrid_times(torch, gen, flush, sdpa)
    from repro_torch.kernels import ssd_scan as smod
    serve_shapes = [(B, S) for B, S, _ in SSD_SERVE] + sorted(report.get("ssd_calls", {}))
    for B, S in dict.fromkeys([(8, 512), (1, 512)] + serve_shapes):
        args = ssd_inputs(torch, gen, B, S, bf16)
        ms = time_ms(torch, lambda: smod.ssd_scan(*args, chunk=MAMBA["chunk"]), flush)
        plain = time_ms(torch, lambda: smod.ssd_scan_plain(*args, chunk=MAMBA["chunk"]), flush)
        b_ms, b_by = ssd_bound(B, S, "bfloat16", 2)
        rows.append(dict(kernel="ssd_scan", model="mamba2", B=B, S=S, dtype="bfloat16",
                         ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                         bound_by=b_by, serve_calls=report.get("ssd_calls", {}).get((B, S))))
    report["timings"] = rows
    log("timings:", json.dumps({"smi": report.get("smi"), "timings": rows}))


def phase_mla_parts(torch, report):
    """The MLA kernel's device time taken apart, bf16, 8 slots against a
    1024-entry cache (``time_ms``, L2 flushed): the floor of the timing
    itself (an empty event pair, a one-element add), every slot keeping one
    latent row or one 64-key tile (no merge), every slot's row spanning 2,
    4 or 16 planned splits (the partials and their merge), the serve's
    DECODE_POS at T = 1 and VERIFY_POS at T = 2 and 5; each kernel case at
    the planned split length and, with the wrapper's ``plan_splits``
    swapped for a fixed length, at 128 and 256 keys."""
    from repro_torch.kernels import mla_attention as mmod
    plan_splits = mmod.plan_splits
    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    one = torch.zeros(1, device="cuda")
    out = {"floor_events_ms": time_ms(torch, lambda: None, flush),
           "floor_add_ms": time_ms(torch, lambda: one.add_(1), flush)}
    Smax, B = 1024, 8
    planned = plan_splits(Smax, B, 1)[1]
    cases = {"one_row": (1, [0] * B), "one_tile": (1, [63] * B), "rows_2_splits": (1, [127] * B),
             "rows_4_splits": (1, [255] * B), "rows_16_splits": (1, [Smax - 1] * B),
             "serve_T1": (1, [min(p, Smax - 1) for p in DECODE_POS]),
             "verify_T2": (2, list(VERIFY_POS)), "verify_T5": (5, list(VERIFY_POS))}
    for name, (T, offs) in cases.items():
        q, k, v = mla_inputs(torch, gen, B, T, Smax, torch.bfloat16)
        qo = torch.tensor(offs, dtype=torch.int32, device="cuda")
        kw = (dict(causal=False, q_offset=qo, kv_len=qo + 1) if T == 1 else
              dict(causal=True, q_offset=qo))
        out[name] = {}
        for L in (planned, 128, 256):
            mmod.plan_splits = lambda S, B_, Hkv, L=L: (-(-S // L), L)
            try:
                out[name][f"split {L}"] = time_ms(torch, lambda: mmod.mla_attention(
                    q, k, v, scale=MLA_SCALE, **kw), flush)
            finally:
                mmod.plan_splits = plan_splits
    report["mla_parts"] = out
    log("mla_parts (ms):", json.dumps({"smi": report.get("smi"), **out}))


PARITY_ARCHS = ("tinyllama-1.1b", "gemma2-2b", "qwen2-7b", "chameleon-34b",
                "deepseek-v2-lite-16b", "seamless-m4t-medium", "jamba-v0.1-52b")
# each arch's cut in the parity phase (2 layers unless named here)
PARITY_CUTS = {"seamless-m4t-medium": dict(num_layers=2, num_encoder_layers=2),
               "jamba-v0.1-52b": dict(num_layers=len(JAMBA_PARITY), layer_pattern=JAMBA_PARITY)}
PARITY_FRAMES = (100, 257, 500)  # seamless's encoder lengths in the parity phase


def time_row(torch, flush, kernel, model, B, S, fn, plain, lib, b, **extra):
    """A times-phase row, bf16: the kernel's, its plain version's and the
    library call's device times, the bound (ms, what bounds it) and the
    wall per call back to back of the kernel and the library call."""
    ms = time_ms(torch, fn, flush)
    return dict(kernel=kernel, model=model, B=B, S=S, dtype="bfloat16", ms=ms,
                plain_ms=time_ms(torch, plain, flush), library_ms=time_ms(torch, lib, flush),
                bound_ms=b[0], bound_by=b[1], call_ms=call_ms(torch, fn),
                library_call_ms=call_ms(torch, lib), **extra)


def encdec_hybrid_times(torch, gen, flush, sdpa):
    """The encdec_hybrid serve's kernel shapes, bf16, each beside its plain
    version, its bound and SDPA on the same tensors (no mask where the
    kernel keeps every key, a bool mask for per-row lengths): seamless's
    encoder self-attention (B 1 and 8 at 500 frames) and cross-attention
    prefill (32 prompt rows against 500 frames, 16 against 300 for 8
    slots), its cross-attention decode (8 slots in a 512-frame region at
    the serve's encoder lengths) and self-attention decode (8 slots of a
    1024-entry cache at decoder positions 4-63); jamba's flash (causal, B 1
    and 8 at 512) and decode (8 slots x 1024 at DECODE_POS)."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    bf16, rows, sm, jb = torch.bfloat16, [], SEAMLESS, JAMBA
    for shape, B, Sq, Sk in (("encoder", 1, 500, 500), ("encoder", 8, 500, 500),
                             ("cross prefill", 1, 32, 500), ("cross prefill", 8, 16, 300)):
        q, k, v = qkv(torch, gen, B, Sq, Sk, sm["H"], sm["Hkv"], sm["D"], bf16)
        rows.append(time_row(
            torch, flush, "flash_attention", "seamless", B, Sk,
            lambda: fmod.flash_attention(q, k, v, causal=False),
            lambda: fmod.flash_attention_plain(q, k, v, causal=False), lambda: sdpa(q, k, v),
            flash_bound_full(B, Sq, Sk, sm["H"], sm["Hkv"], sm["D"], "bfloat16", 2),
            shape=shape, Sq=Sq))
    enc = [x for x in ENCDEC["enc_lens"] for _ in range(2)]
    dec_pos = [4, 8, 16, 32, 20, 40, 60, 63]
    for shape, Smax, kv_len, q_off, hd, model in (
            ("cross decode", 512, enc, 0, sm, "seamless"),
            ("self decode", 1024, [p + 1 for p in dec_pos], dec_pos, sm, "seamless"),
            ("decode", 1024, [min(p, 1023) + 1 for p in DECODE_POS],
             [min(p, 1023) for p in DECODE_POS], jb, "jamba")):
        B = len(kv_len)
        kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        qo = torch.tensor(q_off, dtype=torch.int32, device="cuda") if q_off else 0
        q, _, _ = qkv(torch, gen, B, 1, 1, hd["H"], hd["Hkv"], hd["D"], bf16)
        _, k, v = qkv(torch, gen, B, 1, Smax, hd["H"], hd["Hkv"], hd["D"], bf16)
        mask = (torch.arange(Smax, device="cuda")[None, :] < kl[:, None])[:, None, None]
        kw = dict(q_offset=qo, kv_len=kl)
        rows.append(time_row(
            torch, flush, "decode_attention", model, B, Smax,
            lambda: dmod.decode_attention(q, k, v, **kw),
            lambda: dmod.decode_attention_plain(q, k, v, **kw),
            lambda: sdpa(q, k, v, attn_mask=mask),
            decode_bound_kept(sum(kv_len), B, hd["H"], hd["Hkv"], hd["D"], "bfloat16", 2),
            shape=shape))
    for B in (1, 8):
        q, k, v = qkv(torch, gen, B, 512, 512, jb["H"], jb["Hkv"], jb["D"], bf16)
        rows.append(time_row(
            torch, flush, "flash_attention", "jamba", B, 512,
            lambda: fmod.flash_attention(q, k, v, causal=True),
            lambda: fmod.flash_attention_plain(q, k, v, causal=True),
            lambda: sdpa(q, k, v, is_causal=True),
            flash_bound(B, 512, jb["H"], jb["Hkv"], jb["D"], None, "bfloat16", 2),
            shape="prefill"))
    return rows


def arch_times(torch, gen, flush, sdpa):
    """The seventh and eighth slices' kernel shapes, bf16: decode at
    qwen2-7b's G = 7 (8 slots x 2048 at DECODE_POS), the MLA attention
    kernel at T = 1 (8 slots x 1024, DECODE_POS clipped to the cache) and
    at the verify's T = 5 (8 slots at VERIFY_POS against a 1024-entry
    cache), values the latent rows' first 512 columns, and flash at the MLA
    prefill (B 8, S 512; Dk 192, Dv 128); each beside its plain version, its
    bound and SDPA (+ bool mask) on the same tensors."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import mla_attention as mmod
    bf16, rows = torch.bfloat16, []

    def row(*args, **extra):
        rows.append(time_row(torch, flush, *args, **extra))

    Smax = 2048
    pos_list = [min(p, Smax - 1) for p in DECODE_POS]
    B = len(pos_list)
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    mask = (torch.arange(Smax, device="cuda")[None, :] <= pos[:, None])[:, None, None]
    q, _, _ = qkv(torch, gen, B, 1, 1, QWEN2["H"], QWEN2["Hkv"], QWEN2["D"], bf16)
    _, k, v = qkv(torch, gen, B, 1, Smax, QWEN2["H"], QWEN2["Hkv"], QWEN2["D"], bf16)
    kw = dict(q_offset=pos, kv_len=pos + 1)
    row("decode_attention", "qwen2", B, Smax, lambda: dmod.decode_attention(q, k, v, **kw),
        lambda: dmod.decode_attention_plain(q, k, v, **kw),
        lambda: sdpa(q, k, v, attn_mask=mask),
        decode_bound(pos_list, Smax, QWEN2["H"], QWEN2["Hkv"], QWEN2["D"], None, "bfloat16", 2))
    Smax = 1024
    for T, offs in ((1, [min(p, Smax - 1) for p in DECODE_POS]), (5, list(VERIFY_POS))):
        B = len(offs)
        qo = torch.tensor(offs, dtype=torch.int32, device="cuda")
        q, k, v = mla_inputs(torch, gen, B, T, Smax, bf16)
        qpos = qo[:, None] + torch.arange(T, device="cuda")  # (B, T)
        mask = (torch.arange(Smax, device="cuda") <= qpos[..., None])[:, None]  # (B,1,T,Smax)
        kw = (dict(causal=False, q_offset=qo, kv_len=qo + 1) if T == 1 else
              dict(causal=True, q_offset=qo))
        kw["scale"] = MLA_SCALE
        extra = {} if T == 1 else dict(T=T, shape="verify")
        row("mla_attention", "mla", B, Smax, lambda: mmod.mla_attention(q, k, v, **kw),
            lambda: mmod.mla_attention_plain(q, k, v, **kw),
            lambda: sdpa(q, k, v, attn_mask=mask, scale=MLA_SCALE),
            mla_bound(offs, T, Smax, "bfloat16", 2), **extra)
    B, S, hd = 8, 512, MLA_PREFILL
    q, k, _ = qkv(torch, gen, B, S, S, hd["H"], hd["Hkv"], hd["Dk"], bf16)
    v = qkv(torch, gen, B, 1, S, 1, hd["Hkv"], hd["Dv"], bf16)[2]
    kw = dict(causal=True, scale=MLA_SCALE)
    row("flash_attention", "mla", B, S, lambda: fmod.flash_attention(q, k, v, **kw),
        lambda: fmod.flash_attention_plain(q, k, v, **kw),
        lambda: sdpa(q, k, v, is_causal=True, scale=MLA_SCALE),
        flash_bound(B, S, hd["H"], hd["Hkv"], hd["Dk"], None, "bfloat16", 2, Dv=hd["Dv"]),
        shape="mla prefill")
    return rows


def phase_parity(torch, report):
    """The attention and MLA archs at full width, cut to 2 layers
    (deepseek-v2-lite: layer 0 dense, layer 1 MoE; seamless-m4t: 2 encoder
    and 2 decoder layers; jamba: JAMBA_PARITY, layer 1 a Mamba1 layer with
    MoE): prefill and 8 ragged decode steps through the kernels against the
    same run through the plain versions, in fp32 (the fp32 kernel routes)
    and in bf16 (the tensor-core flash kernel and the bf16 decode kernels).
    Both runs are fed the plain run's greedy tokens, so a near-tie that
    rounds the other way in bf16 cannot send the two runs down different
    sequences."""
    for dtype in ("float32", "bfloat16"):
        for arch in PARITY_ARCHS:
            model_parity(torch, report, arch, dtype)
    phase_parity_mamba2(torch, report)


class RouterReplay:
    """Wraps ``models.moe.route`` for a parity pair: the plain run's calls
    are recorded; each call of the kernel run (in the same order) computes
    its own routing, counts where its top-k expert set differs from the
    plain run's, and goes on with the plain run's experts (gated by its own
    probabilities), as both runs are fed the plain run's tokens. A flip is
    allowed only where the plain run's router logits of the experts
    swapped lie within ROUTER_TIE of each other (printed)."""

    def __init__(self, moe):
        self.moe, self.route = moe, moe.route
        self.plain, self.mode, self.step, self.i = [], "plain", None, 0
        self.agree, self.flips = {}, []

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def __call__(self, xt, router, k):
        probs, gates, ids = self.route(xt, router, k)
        if self.mode == "plain":
            self.plain.append((probs, ids))
            return probs, gates, ids
        pprobs, pids = self.plain[self.i]
        self.i += 1
        mine = ids.sort(dim=-1).values
        theirs = pids.sort(dim=-1).values
        rows = (mine != theirs).any(dim=-1).nonzero().flatten().tolist()
        n, ok = self.agree.get(self.step, (0, 0))
        self.agree[self.step] = (n + ids.shape[0], ok + ids.shape[0] - len(rows))
        logit = pprobs.double().log()
        for r in rows:
            took = sorted(set(ids[r].tolist()) - set(pids[r].tolist()))
            left = sorted(set(pids[r].tolist()) - set(ids[r].tolist()))
            margin = float(logit[r, left].max() - logit[r, took].min())
            self.flips.append((self.step, r, left, took, margin))
        gates = probs.gather(1, pids)
        return probs, gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9), pids


def model_parity(torch, report, arch, dtype):
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.serving.workers import ModelWorker
    from repro_torch.sharding.context import ExecContext
    prompt_lens = (37, 64, 100)
    cut = PARITY_CUTS.get(arch, dict(num_layers=2))
    cfg = dataclasses.replace(get_config(arch), **cut, dtype=dtype, param_dtype=dtype)
    params = init_params(cfg, seed=0, device="cuda")
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).numpy()
               for n in prompt_lens]
    frames = [None] * len(prompts)
    enc_len = None
    if cfg.is_encoder_decoder:  # per-slot encoder lengths in a 512-frame region
        frames = [(torch.randn(n, cfg.d_model, generator=rng) * 0.1).numpy()
                  for n in PARITY_FRAMES]
        enc_len = torch.tensor(PARITY_FRAMES, dtype=torch.int32).numpy()
    runs, toks = {}, None
    with RouterReplay(moe) as replay:
        for impl in ("plain", None):
            replay.mode = impl or "kernel"
            w = ModelWorker(arch, cfg, params, max_len=256, ctx=ExecContext(attn_impl=impl),
                            max_enc_len=ENCDEC["max_enc_len"] if cfg.is_encoder_decoder else None)
            pool = w.init_pool(len(prompts))
            first = []
            for slot, (p, e) in enumerate(zip(prompts, frames)):
                replay.step = "prefill"
                lg, c = w.prefill_one(p, e)
                pool = w.write_slots(pool, c, [slot])
                first.append(lg[0])
            lg = torch.stack(first)
            pos = torch.tensor(prompt_lens, dtype=torch.int32).numpy()
            logits, greedy = [], []
            for i in range(9):  # prefill logits + 8 ragged decode steps
                logits.append(lg.float())
                greedy.append(lg.argmax(dim=-1).to(torch.int32).cpu().numpy())
                tok = greedy[-1] if toks is None else toks[i]
                replay.step = f"decode {i}"
                _, lg, pool = w.decode_pool(pool, tok[:, None], pos, enc_len=enc_len)
                pos = pos + 1
            runs[impl] = (torch.stack(logits), greedy)
            toks = greedy if toks is None else toks
    if replay.plain:
        log(f"parity {arch} {dtype}: router top-{cfg.top_k} sets agreeing, rows per step: "
            + json.dumps({st: f"{ok}/{n}" for st, (n, ok) in replay.agree.items()}))
        for st, r, left, took, margin in replay.flips:
            log(f"  router flip at {st}, row {r}: plain {left} -> kernel {took}, plain logit "
                f"gap {margin:.4g} (near-tie bound {ROUTER_TIE})")
        far = [f for f in replay.flips if f[-1] > ROUTER_TIE]
        if far:
            raise SmokeFailure(f"{arch} {dtype}: router flips away from a near-tie: {far}")
        report.setdefault("router_flips", {})[f"{arch} {dtype}"] = len(replay.flips)
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
    log(f"parity {arch} ({json.dumps(cut)}, full width, {dtype}): logits max abs err {err:.3g} "
        f"(largest logit {float(b.abs().max()):.3g}), greedy tokens agreeing {same}/{n}")
    if not ok:
        raise SmokeFailure(f"{arch} {dtype}: kernel path disagrees with the plain path "
                           f"(max abs err {err:.3g}, greedy tokens agreeing {same}/{n})")
    report.setdefault("parity", {})[f"{arch} {dtype}"] = err


def phase_parity_mamba2(torch, report):
    """mamba2 at full width, 2 layers, fp32 (the exact route) and bf16 (the
    tensor-core route): a 96- and a 128-token prompt LEFT-padded into one
    masked 128 bucket (the SSD kernel on the scan), then 8 ragged decode
    steps, against the same run on the plain scan. Both runs are fed the
    plain run's greedy tokens; fp32 must also pick the same ones. The
    kernel run must launch the SSD kernel once per layer, the plain run
    never."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.models.model import init_params
    from repro_torch.serving.workers import ModelWorker
    from repro_torch.sharding.context import ExecContext
    arch, lens, bucket = "mamba2-2.7b", (96, 128), 128
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype=dtype,
                                  param_dtype=dtype)
        params = init_params(cfg, seed=0, device="cuda")
        rng = np.random.default_rng(7)
        prompts = np.zeros((len(lens), bucket), np.int32)
        mask = np.zeros((len(lens), bucket), bool)
        for i, n in enumerate(lens):
            prompts[i, bucket - n:] = rng.integers(1, cfg.vocab_size, n)
            mask[i, bucket - n:] = True
        runs, fed, launches = {}, None, {}
        for impl in ("plain", None):
            smod.ssd_scan.launches = 0
            w = ModelWorker(arch, cfg, params, max_len=256, ctx=ExecContext(attn_impl=impl))
            pool = w.init_pool(len(lens))
            lg, c = w.prefill_batch(prompts, pad_mask=mask)
            pool = w.write_slots(pool, c, list(range(len(lens))))
            pos = np.asarray(lens, np.int32)
            logits, toks = [], []
            for i in range(9):  # prefill logits + 8 ragged decode steps
                logits.append(lg.float())
                toks.append(lg.argmax(dim=-1).to(torch.int32).cpu().numpy())
                tok = toks[-1] if fed is None else fed[i]
                _, lg, pool = w.decode_pool(pool, tok[:, None], pos)
                pos = pos + 1
            runs[impl] = (torch.stack(logits), toks)
            fed = toks if fed is None else fed
            launches[impl or "kernel"] = smod.ssd_scan.launches
        a, b = runs[None][0], runs["plain"][0]
        err = float((a - b).abs().max())
        same = all((x == y).all() for x, y in zip(runs[None][1], runs["plain"][1]))
        if dtype == "float32":
            ok = bool(((a - b).abs() <= MODEL_TOL + MODEL_TOL * b.abs()).all()) and same
        else:  # per step, against the largest logit of the step
            scale = b.abs().amax(dim=-1, keepdim=True)
            ok = bool(((a - b).abs() <= MODEL_TOL_BF16 * scale).all())
        ok = ok and bool(torch.isfinite(a).all())
        log(f"parity {arch} (2 layers, full width, {dtype}, masked 128 bucket of {lens}): "
            f"logits max abs err {err:.3g} (largest logit {float(b.abs().max()):.3g}), "
            f"greedy tokens identical: {same}; SSD kernel launches {launches}")
        if not ok:
            raise SmokeFailure(f"{arch} {dtype}: kernel path disagrees with the plain path "
                               f"(max abs err {err:.3g}, tokens identical {same})")
        if launches != {"plain": 0, "kernel": cfg.num_layers}:
            raise SmokeFailure(f"{arch} {dtype}: SSD kernel launches {launches}, expected "
                               f"{cfg.num_layers} on the kernel run and 0 on the plain run")
        report.setdefault("parity", {})[f"{arch} {dtype}"] = err


def kernel_wrappers():
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import mla_attention as mmod
    from repro_torch.kernels import ssd_scan as smod
    return {"flash_attention": fmod.flash_attention, "decode_attention": dmod.decode_attention,
            "ssd_scan": smod.ssd_scan, "mla_attention": mmod.mla_attention}


def drive(fn, **kw):
    """Run one serving path with every kernel's launch count set to 0 just
    before it; returns (fn's result, the counts read just after)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn(**kw)
    return out, {name: w.launches for name, w in wrappers.items()}


def attention_layers(cfg):
    return sum(k in ("attn", "local", "global") for k in cfg.layer_kinds())


def attention_launches_expected(eng):
    """Per attention layer (a hybrid's attention layers only): flash once
    for each prefill; for a GQA stack flash once for each multi-position
    pass (the verify, a draft's catch-up of Tc > 1 tokens) and decode once
    for each single-token pass; for an MLA stack the MLA kernel once for
    each decode and multi-position pass (an MLA verify launches no flash);
    an encoder-decoder model adds flash once per encoder layer and once per
    cross-attention per prefill, and decode once per cross-attention per
    step. Draft workers included. Prompts and encoder inputs are longer
    than one position here (a single query row goes to the decode kernel)."""
    workers = list(eng.workers.values()) + [s.worker for s in eng.spec.values()]
    gqa = [w for w in workers if not w.cfg.use_mla]
    mla = [w for w in workers if w.cfg.use_mla]

    def per_pass(w):  # attention launches of one decoder pass, cross-attention included
        return attention_layers(w.cfg) * (2 if w.cfg.is_encoder_decoder else 1)

    def per_prefill(w):  # flash launches of one prefill, the encoder's included
        return per_pass(w) + (w.cfg.num_encoder_layers if w.cfg.is_encoder_decoder else 0)
    return {"flash_attention": sum(per_prefill(w) * w.prefill_calls for w in workers)
            + sum(attention_layers(w.cfg) * w.verify_calls for w in gqa),
            "decode_attention": sum(per_pass(w) * w.decode_calls for w in gqa),
            "mla_attention": sum(attention_layers(w.cfg) * (w.decode_calls + w.verify_calls)
                                 for w in mla)}


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
    from repro_torch.models import ssm
    names, max_new = SCHEDULED["names"], SCHEDULED["max_new"]
    shapes, scan = [], ssm.ssd_scan

    def recorded_scan(x, *args, **kw):  # the (B, S) of each call, then the wrapper itself
        shapes.append(tuple(x.shape[:2]))
        return scan(x, *args, **kw)
    ssm.ssd_scan = recorded_scan
    try:
        (eng, responses, rep), launches = drive(serve, **SCHEDULED)
    finally:
        ssm.ssd_scan = scan
    if len(shapes) != launches["ssd_scan"]:
        raise SmokeFailure(f"scheduled: {len(shapes)} SSD calls recorded, "
                           f"{launches['ssd_scan']} launches counted")
    report["ssd_calls"] = calls = collections.Counter(shapes)
    log("scheduled SSD scan calls by (B, S):",
        json.dumps({f"{B}:{S}": n for (B, S), n in sorted(calls.items())}))
    unchecked = set(calls) - {(B, S) for B, S, _ in SSD_SERVE}
    if unchecked:  # the kernels phase checks the kernel at SSD_SERVE's shapes only
        raise SmokeFailure(f"scheduled: SSD calls at (B, S) {sorted(unchecked)}, "
                           f"not in SSD_SERVE")
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
    if (launches != want or launches["ssd_scan"] < 64
            or min(launches[k] for k in ("flash_attention", "decode_attention")) == 0):
        raise SmokeFailure(f"scheduled: kernel launches {launches}, expected {want}")
    reasons = set(rep["admission_reasons"])
    if not reasons - {"idle-pool"}:
        raise SmokeFailure(f"scheduled: admission never priced a decision ({reasons})")
    seen = {(e.kind, e.model) for e in eng.ledger.events}
    missing = [(k, m) for k in ("prefill", "decode", "request") for m in names
               if (k, m) not in seen]
    if missing:
        raise SmokeFailure(f"scheduled: the ledger lacks events {missing}")


def joint_run(torch, coexec, gaps=None):
    """One serve of the SCHEDULED workload on a fresh engine (``engine_for``:
    seeded weights, uids k·requests + i for the k-th model) under a fresh
    scheduler calibrated as the scheduled phase's, joint planning or not;
    ``gaps`` (a dict) gets each model's recorded decision gaps. Returns
    (engine, responses, launches, wall s, {"solves", "solve_s"}, SSD calls'
    (B, S))."""
    from repro_torch.models import ssm
    from repro_torch.serving import scheduler as sched_mod
    eng = engine_for(SCHEDULED, coexec)
    solves, shapes = {"solves": 0, "solve_s": 0.0}, []
    dp, scan = sched_mod.dp_partition, ssm.ssd_scan

    def timed_dp(*a, **k):  # every DP solve of the scheduler, and its host time
        t0 = time.perf_counter()
        out = dp(*a, **k)
        solves["solves"] += 1
        solves["solve_s"] += time.perf_counter() - t0
        return out

    def recorded_scan(x, *a, **k):  # the (B, S) of each call, then the wrapper itself
        shapes.append(tuple(x.shape[:2]))
        return scan(x, *a, **k)

    def go():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run_all()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    sched_mod.dp_partition, ssm.ssd_scan = timed_dp, recorded_scan
    try:
        with contextlib.ExitStack() as recording:
            if gaps is not None:
                for name in eng.workers:
                    reqs = [(r.uid, r.prompt, r.max_new_tokens) for r in eng.queues[name]]
                    gaps[name] = recording.enter_context(record_gaps(torch, eng, reqs, 0.0, name))
            (out, wall), launches = drive(go)
    finally:
        sched_mod.dp_partition, ssm.ssd_scan = dp, scan
    return eng, out, launches, wall, solves, shapes


def joint_summary(eng, out, launches, wall, solves):
    """What one arm's scheduler decided, what it cost the host, and the
    simulated device's charges."""
    sch = eng.scheduler
    keys = [k for k in sch._plan_cache if "coex" in k]
    per_model = {m: e.total_j for m, e in eng.ledger.energy_by_model("request").items()}
    return {
        "requests": len(out), "tokens": int(sum(len(r.tokens) for r in out)),
        "warm_wall_s": wall, "launches": launches,
        "plan_cache": {"hits": sch.plan_cache_hits, "misses": sch.plan_cache_misses,
                       "entries": len(sch._plan_cache)},
        "joint_keys": len(keys),
        "joint_resident_sets": sorted({"+".join(k[-3]) for k in keys}),
        "dp_solves": solves["solves"], "dp_solve_s": solves["solve_s"],
        "prefill_batches": eng.prefill_batches,
        "calls": {n: {"prefill": w.prefill_calls, "decode": w.decode_calls}
                  for n, w in eng.workers.items()},
        "admission_reasons": dict(collections.Counter(r["reason"] for r in eng.admission.log)),
        "drift_events": eng.drift_events, "preemptions": dict(eng.preemptions),
        "simulated_joules": {
            "label": f"DeviceSim {SCHEDULED['workload']} (a mobile SoC's rails), not the card's",
            "per_request": sum(per_model.values()) / max(len(out), 1),
            "per_model": per_model,
            "per_rail": eng.ledger.total_energy("request").rails_dict()}}


def phase_joint(torch, report):
    """Contention-aware joint planning on the scheduled path: the SCHEDULED
    workload under ``AdaOperScheduler(coexec=CoexecPlanner())`` (joint arm)
    and without ``coexec`` (independent arm), built through the API; each
    arm serves once to warm up and once measured, on fresh engines,
    schedulers and weights, and its weights are freed before the next arm."""
    n, names, max_new = SCHEDULED["requests"], SCHEDULED["names"], SCHEDULED["max_new"]
    arms, tokens, gaps = {}, {}, {}
    for arm in ("joint", "independent"):
        label = f"joint {arm}"
        # the independent arm's warm-up records the decision gaps that the
        # token check reads
        warm_eng, warm_out = joint_run(torch, arm == "joint",
                                       gaps if arm == "independent" else None)[:2]
        check_responses(f"{label} warm-up", warm_eng, warm_out, n * len(names), max_new)
        del warm_eng
        eng, out, launches, wall, solves, shapes = joint_run(torch, arm == "joint")
        check_responses(label, eng, out, n * len(names), max_new)
        mamba = eng.workers["mamba2-2.7b"]
        want = dict(attention_launches_expected(eng),
                    ssd_scan=mamba.cfg.num_layers * mamba.prefill_calls)
        if launches != want or min(launches[k] for k in ("flash_attention", "decode_attention",
                                                         "ssd_scan")) == 0:
            raise SmokeFailure(f"{label}: kernel launches {launches}, expected {want}")
        calls = collections.Counter(shapes)
        if len(shapes) != launches["ssd_scan"]:
            raise SmokeFailure(f"{label}: {len(shapes)} SSD calls recorded, "
                               f"{launches['ssd_scan']} launches counted")
        unchecked = set(calls) - {(B, S) for B, S, _ in SSD_SERVE}
        if unchecked:  # the kernels phase checks the kernel at SSD_SERVE's shapes only
            raise SmokeFailure(f"{label}: SSD calls at (B, S) {sorted(unchecked)}, "
                               f"not in SSD_SERVE")
        seen = {(e.kind, e.model) for e in eng.ledger.events}
        missing = [(k, m) for k in ("prefill", "decode", "request") for m in names
                   if (k, m) not in seen]
        if missing:
            raise SmokeFailure(f"{label}: the ledger lacks events {missing}")
        res = joint_summary(eng, out, launches, wall, solves)
        res["ssd_calls"] = {f"{B}:{S}": c for (B, S), c in sorted(calls.items())}
        if (res["joint_keys"] > 0) != (arm == "joint"):
            raise SmokeFailure(f"{label}: {res['joint_keys']} plans solved under a joint key")
        log(f"{label}: {json.dumps(res)}")
        arms[arm] = res
        tokens[arm] = {"measured": out, "warm-up": warm_out}
        if arm == "joint":
            report["launches_joint"] = launches
        del eng, out, warm_out
        torch.cuda.empty_cache()
    # greedy tokens per uid against the independent arm's warm-up run (its
    # decision gaps recorded): identical, or apart only from a near-tie
    ref = tokens["independent"]["warm-up"]
    diverged = {}
    for k, name in enumerate(names):
        mine = [r for r in ref if r.uid // n == k]
        for arm, run in (("joint", "measured"), ("independent", "measured"),
                         ("joint", "warm-up")):
            theirs = [r for r in tokens[arm][run] if r.uid // n == k]
            diverged[f"{name} {arm} {run}"] = token_check(
                f"joint {name}: {arm} {run} vs independent warm-up", theirs, mine, gaps[name],
                exact=False)
    j, i = arms["joint"], arms["independent"]
    summary = {
        "warm_wall_s": [j["warm_wall_s"], i["warm_wall_s"]],
        "wall_ratio": j["warm_wall_s"] / i["warm_wall_s"],
        "plan_cache_misses": [j["plan_cache"]["misses"], i["plan_cache"]["misses"]],
        "dp_solves": [j["dp_solves"], i["dp_solves"]],
        "dp_solve_s": [j["dp_solve_s"], i["dp_solve_s"]],
        "launches": [j["launches"], i["launches"]],
        "simulated_joules_per_request (DeviceSim, not the card's)": [
            j["simulated_joules"]["per_request"], i["simulated_joules"]["per_request"]],
        "uids_diverged": diverged}
    report["joint"] = dict(summary, arms=arms)
    log("joint vs independent: " + json.dumps(summary))


def spec_requests(cfg, n, prompt_lens, max_new, seed):
    """(uid, prompt, max_new) of ``n`` requests, prompt lengths drawn from
    ``prompt_lens``; each run makes its own ``Request`` objects of them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, cfg.vocab_size, int(rng.choice(prompt_lens)), dtype=np.int32),
             max_new) for i in range(n)]


def spec_engine(cfg, params, draft, calib_cfgs, max_slots, max_len):
    """One engine serving ``cfg`` (with ``draft`` or without), under the
    AdaOper scheduler calibrated on ``calib_cfgs`` (the target's and the
    draft's graphs for both arms, so both price the target alike) or FIFO
    when ``calib_cfgs`` is None."""
    from repro_torch.launch.serve import make_scheduler
    from repro_torch.serving.engine import ServingEngine
    sched = (None if calib_cfgs is None else
             make_scheduler(calib_cfgs, max(SPEC["prompt_lens"]), SPEC["max_new"], "moderate",
                            SPEC["seed"]))
    eng = ServingEngine(scheduler=sched, max_slots=max_slots)
    eng.add_model(cfg.name, cfg, params, max_len=max_len, draft=draft)
    return eng


def spec_run(torch, eng, reqs, trace, temperature):
    """Serve ``reqs`` on ``eng``: a ``run_trace`` with every arrival at t = 0
    or ``run_all``, with the kernels' launch counts set to 0 just before.
    Returns (responses, launches, wall s, peak device bytes)."""
    from repro_torch.serving.slots import Request
    name = next(iter(eng.workers))
    items = [Request(uid, p, n) for uid, p, n in reqs]

    def go():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if trace:
            out = eng.run_trace([(0.0, name, r) for r in items], temperature=temperature)
        else:
            for r in items:
                eng.submit(name, r)
            out = eng.run_all(temperature=temperature)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    (out, wall, peak), launches = drive(go)
    return out, launches, wall, peak


def decision_gaps(torch, rows, keys, idx, temperature):
    """Per row of ``rows`` (n, V) logits: the top-2 gap of the scores a
    token is decided on (the logits; at temperature > 0 the logits over the
    temperature plus the Gumbel noise of token ``idx`` of stream ``key``)
    and the largest |logit| (over the temperature)."""
    from repro_torch.serving import sampling
    rows = rows.double()
    scores = rows
    if temperature > 0.0:
        rows = rows / temperature
        noise = torch.stack([sampling._noise(k, i, rows.shape[-1]) for k, i in zip(keys, idx)])
        scores = rows + noise.to(rows.device)
    top = scores.topk(2, dim=-1).values
    return list(zip((top[:, 0] - top[:, 1]).tolist(), rows.abs().amax(dim=-1).tolist()))


class Gaps(dict):
    """(uid, token index) -> ``decision_gaps`` of a continuous engine's plain
    decode steps, filled by ``record_gaps``; a first token (decided on the
    prefill's logits) is recomputed from a prefill of its prompt when asked
    for, a later one that was not recorded is (None, None)."""

    def __init__(self, torch, eng, name, prompts, temperature):
        super().__init__()
        self.torch, self.eng, self.name = torch, eng, name
        self.prompts, self.temperature = prompts, temperature

    def __missing__(self, key):
        uid, i = key
        if i != 0:
            return None, None
        lg, _ = self.eng.workers[self.name].prefill_one(self.prompts[uid])
        return decision_gaps(self.torch, lg, [self.eng._stream_key(self.name, uid)], [0],
                             self.temperature)[0]


@contextlib.contextmanager
def record_gaps(torch, eng, reqs, temperature, name=None):
    """Yields the ``Gaps`` of the engine's worker ``name`` (its first by
    default), recorded from its decode steps while the block runs; the
    worker's own ``decode_pool`` is back in place after it."""
    name = next(iter(eng.workers)) if name is None else name
    w = eng.workers[name]
    plain_pool = w.decode_pool
    gaps = Gaps(torch, eng, name, {uid: p for uid, p, _ in reqs}, temperature)

    def recorded(cache, tokens, pos, enc_len=None):
        nt, logits, cache = plain_pool(cache, tokens, pos, enc_len=enc_len)
        active = list(eng.pools[name].active.values())
        for s, g in zip(active, decision_gaps(torch, logits[[s.slot for s in active]],
                                              [s.rng for s in active],
                                              [len(s.tokens) for s in active], temperature)):
            gaps[(s.req.uid, len(s.tokens))] = g
        return nt, logits, cache

    w.decode_pool = recorded
    try:
        yield gaps
    finally:
        del w.decode_pool  # the method of the worker's class again


def token_check(label, spec_out, plain_out, gaps, exact, report_only=False,
                names=("spec", "plain")):
    """Spec tokens against the plain run's per uid: identical, or (unless
    ``exact``) apart only from the first divergence on, where the plain
    run's decision had a top-2 gap within MODEL_TOL_BF16 of its largest
    |logit| (a near-tie that the verify's and the step's rounding may
    split); ``report_only`` prints each divergence and its gap without
    failing (where spec and plain tokens may rightly differ); ``names``
    are the two runs' names in the printout. Returns the number of uids
    that diverged."""
    spec = {r.uid: [int(t) for t in r.tokens] for r in spec_out}
    plain = {r.uid: [int(t) for t in r.tokens] for r in plain_out}
    if sorted(spec) != sorted(plain):
        raise SmokeFailure(f"{label}: spec and plain runs served other uids")
    diverged = 0
    for uid in sorted(plain):
        a, b = spec[uid], plain[uid]
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        diverged += 1
        gap, scale = gaps[(uid, i)]
        log(f"{label}: uid {uid} diverges at token {i} ({b[i]} {names[1]}, {a[i]} "
            f"{names[0]}); {names[1]} top-2 gap {gap} at largest |logit| {scale}")
        if not report_only and (exact or gap is None or gap > MODEL_TOL_BF16 * scale):
            raise SmokeFailure(f"{label}: uid {uid} diverges at token {i} "
                               f"({names[1]} top-2 gap {gap}, largest |logit| {scale})")
    log(f"{label}: tokens identical for {len(plain) - diverged} of {len(plain)} uids")
    return diverged


def spec_summary(eng, out, launches, wall, peak, trace):
    """The run's speculation counters and decisions, committed tokens per
    target pass, virtual makespan (trace runs), wall and memory."""
    c = eng.ledger.counters
    w = eng.workers[next(iter(eng.workers))]
    # decode-phase tokens (the first of each request comes from its
    # prefill) over the target's passes over the pool and, as
    # benchmarks/bench_spec.py counts them from the ledger (scheduled
    # runs), over its per-slot steps: plain decode makes exactly 1 per step
    dec_tokens = sum(len(r.tokens) for r in out) - len(out)
    passes = w.decode_calls + w.verify_calls
    slot_steps = sum(e.n_active for e in eng.ledger.events
                     if e.kind in ("decode", "spec_verify"))
    return {
        "requests": len(out), "tokens": dec_tokens + len(out),
        "counters": {k: c.get(k, 0) for k in ("spec_rounds", "spec_drafted", "spec_accepted",
                                              "spec_fallbacks")},
        "spec_log": dict(collections.Counter(d["reason"] for d in eng.admission.spec_log)),
        "tokens_per_pool_pass": dec_tokens / passes if passes else None,
        "tokens_per_target_step": dec_tokens / slot_steps if slot_steps else None,
        "target_passes": {"decode": w.decode_calls, "verify": w.verify_calls},
        "makespan_s": max(r.latency_s for r in out) if trace else None,
        "wall_s": wall, "peak_mem_bytes": peak, "launches": launches}


def spec_checks(label, eng, out, launches, n, max_new):
    check_responses(label, eng, out, n, max_new)
    want = dict(attention_launches_expected(eng), ssd_scan=0)
    w = eng.workers[next(iter(eng.workers))]
    if launches != want:
        raise SmokeFailure(f"{label}: kernel launches {launches}, expected {want}")
    verify = "mla_attention" if w.cfg.use_mla else "flash_attention"
    base = w.cfg.num_layers * (w.decode_calls if w.cfg.use_mla else w.prefill_calls)
    if eng.spec and not (w.verify_calls > 0 and launches[verify] > base):
        raise SmokeFailure(f"{label}: the target never verified through {verify}")
    if eng.spec and not eng.ledger.counters.get("spec_rounds"):
        raise SmokeFailure(f"{label}: no speculative round ran")


def spec_pair(torch, report, label, cfg, params, draft, calib, reqs, trace, temperature,
              max_slots, max_len, exact=False, report_only=False):
    """The same requests through the engine without a draft (its decisions'
    gaps recorded) and with it; checks each run and the tokens
    (``token_check``). Returns (spec engine, summaries)."""
    plain = spec_engine(cfg, params, None, calib, max_slots, max_len)
    with record_gaps(torch, plain, reqs, temperature) as gaps:
        p_out, p_launch, p_wall, p_peak = spec_run(torch, plain, reqs, trace, temperature)
    spec_checks(f"{label} plain", plain, p_out, p_launch, len(reqs), reqs[0][2])
    eng = spec_engine(cfg, params, draft, calib, max_slots, max_len)
    out, launches, wall, peak = spec_run(torch, eng, reqs, trace, temperature)
    spec_checks(f"{label} spec", eng, out, launches, len(reqs), reqs[0][2])
    diverged = token_check(label, out, p_out, gaps, exact, report_only)
    res = {"spec": spec_summary(eng, out, launches, wall, peak, trace),
           "plain": spec_summary(plain, p_out, p_launch, p_wall, p_peak, trace),
           "uids_diverged": diverged}
    log(f"{label}: {json.dumps(res)}")
    report.setdefault("spec", {})[label] = res
    return eng, res


def phase_spec(torch, report):
    """Speculative decoding through the port's engine API, as
    benchmarks/bench_spec.py builds its engines: the dense GQA arms, their
    weights freed, then the MLA arms."""
    import gc
    spec_dense_arms(torch, report)
    gc.collect()
    torch.cuda.empty_cache()
    spec_mla_arms(torch, report)


def spec_dense_arms(torch, report):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.speculative import truncated_draft
    # 2 layers at full width, fp32, random 1-layer drafts: exact. tinyllama's
    # draft rejects most proposals, so its verifies run over the stale K/V
    # of rolled-back rounds; random-init gemma2 (tied embeddings) and its
    # draft both mostly repeat the last token, so they agree
    for arch in ("tinyllama-1.1b", "gemma2-2b"):
        cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32",
                                  param_dtype="float32")
        params = init_params(cfg, seed=0, device="cuda")
        dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft1", num_layers=1)
        dparams = init_params(dcfg, seed=7, device="cuda")
        reqs = spec_requests(cfg, 4, (37, 64, 100), 12, SPEC["seed"])
        label = f"parity {arch} fp32 2 layers"
        _, res = spec_pair(torch, report, label, cfg, params, (dcfg, dparams), None, reqs, False,
                           0.0, 4, 256, exact=True)
        c = res["spec"]["counters"]
        if arch == "tinyllama-1.1b" and c["spec_accepted"] * 2 > c["spec_drafted"]:
            raise SmokeFailure(f"{label}: the random draft was not mostly rejected ({c})")
    n, lens, max_new, slots, max_len = (SPEC[k] for k in ("requests", "prompt_lens", "max_new",
                                                          "max_slots", "max_len"))
    cfg = get_config("tinyllama-1.1b")
    dcfg, dparams, tparams = truncated_draft(cfg, init_params(cfg, seed=SPEC["seed"],
                                                              device="cuda"))
    reqs = spec_requests(cfg, n, lens, max_new, SPEC["seed"])
    calib = [cfg, dcfg]
    eng, res = spec_pair(torch, report, "tinyllama scheduled trace", cfg, tparams,
                         (dcfg, dparams), calib, reqs, True, 0.0, slots, max_len)
    report["launches_spec"] = res["spec"]["launches"]
    spec_pair(torch, report, "tinyllama scheduled run_all", cfg, tparams, (dcfg, dparams), calib,
              reqs, False, 0.0, slots, max_len)
    spec_pair(torch, report, "tinyllama scheduled trace sampled", cfg, tparams, (dcfg, dparams),
              calib, reqs, True, 0.8, slots, max_len)
    del eng, tparams, dparams
    torch.cuda.empty_cache()
    cfg = get_config("gemma2-2b")
    dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft1", num_layers=1)
    params = init_params(cfg, seed=SPEC["seed"], device="cuda")
    dparams = init_params(dcfg, seed=7, device="cuda")
    _, res = spec_pair(torch, report, "gemma2 fifo random draft", cfg, params, (dcfg, dparams),
                       None, spec_requests(cfg, n, lens, max_new, SPEC["seed"]), False, 0.0,
                       slots, max_len)
    c = res["spec"]["counters"]
    if c["spec_accepted"] >= c["spec_drafted"]:
        raise SmokeFailure(f"gemma2 fifo random draft: no draft was rejected ({c})")
    del params, dparams
    torch.cuda.empty_cache()
    # full-width bf16 rollback in quantity: tinyllama (untied LM head) with a
    # differently seeded 1-layer draft, FIFO, so every round speculates and
    # most drafts are rejected: the verifies run over the stale K/V of
    # rolled-back rounds
    cfg = get_config("tinyllama-1.1b")
    dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft1", num_layers=1)
    params = init_params(cfg, seed=SPEC["seed"], device="cuda")
    dparams = init_params(dcfg, seed=7, device="cuda")
    label = "tinyllama fifo random draft"
    _, res = spec_pair(torch, report, label, cfg, params, (dcfg, dparams), None,
                       spec_requests(cfg, n, lens, max_new, SPEC["seed"]), False, 0.0, slots,
                       max_len)
    c = res["spec"]["counters"]
    rolled = c["spec_drafted"] - c["spec_accepted"]
    log(f"{label}: drafted {c['spec_drafted']}, accepted {c['spec_accepted']}, rolled back "
        f"{rolled} (acceptance {c['spec_accepted'] / max(c['spec_drafted'], 1):.3f})")
    if rolled * 2 < c["spec_drafted"]:
        raise SmokeFailure(f"{label}: most drafts were accepted ({c})")


def spec_mla_arms(torch, report):
    """deepseek-v2-lite-16b, whose verify and draft passes run through the
    MLA attention kernel (never flash): (a) 2 layers at full width, fp32,
    drop-free capacity (``num_experts / top_k``), a random 1-layer draft,
    FIFO, token-identical to the draft-less engine; (b) the full config in
    bf16 at its published capacity 1.25 with ``truncated_draft`` (layer 0:
    dense, MLA), scheduled, ``run_trace``: every request completes, its
    acceptance and committed tokens per target step reported (a verify of
    B·T tokens and a step of B get other capacities, so tokens may differ
    from the draft-less engine's, in both packages alike); (c) as (b)
    drop-free, prompts {64, 128}, 4 requests: tokens identical but for
    printed near-ties."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.speculative import truncated_draft
    full = get_config("deepseek-v2-lite-16b")
    drop_free = full.num_experts / full.top_k
    cfg = dataclasses.replace(full, num_layers=2, dtype="float32", param_dtype="float32",
                              moe_capacity_factor=drop_free)
    params = init_params(cfg, seed=0, device="cuda")
    dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft1", num_layers=1)
    dparams = init_params(dcfg, seed=7, device="cuda")
    reqs = spec_requests(cfg, 4, (37, 64, 100), 12, SPEC["seed"])
    label = "parity deepseek fp32 2 layers drop-free"
    _, res = spec_pair(torch, report, label, cfg, params, (dcfg, dparams), None, reqs, False,
                       0.0, 4, 256, exact=True)
    del params, dparams, res
    gc.collect()
    torch.cuda.empty_cache()
    n, lens, max_new, slots, max_len = (SPEC[k] for k in ("requests", "prompt_lens", "max_new",
                                                          "max_slots", "max_len"))
    base = init_params(full, seed=SPEC["seed"], device="cuda")
    for label, cfg, reqs in (
            ("deepseek scheduled trace capacity 1.25", full,
             spec_requests(full, n, lens, max_new, SPEC["seed"])),
            ("deepseek scheduled trace drop-free",
             dataclasses.replace(full, moe_capacity_factor=drop_free),
             spec_requests(full, 4, (64, 128), max_new, SPEC["seed"]))):
        dcfg, dparams, tparams = truncated_draft(cfg, base)
        eng, res = spec_pair(torch, report, label, cfg, tparams, (dcfg, dparams), [cfg, dcfg],
                             reqs, True, 0.0, slots, max_len,
                             report_only=cfg.moe_capacity_factor < drop_free)
        c = res["spec"]["counters"]
        log(f"{label}: drafted {c['spec_drafted']}, accepted {c['spec_accepted']} (acceptance "
            f"{c['spec_accepted'] / max(c['spec_drafted'], 1):.4f}), committed tokens per "
            f"target step {res['spec']['tokens_per_target_step']}, peak memory "
            f"{res['spec']['peak_mem_bytes'] / 2**30:.2f} GiB")
        if cfg is full:
            report["launches_spec_deepseek"] = res["spec"]["launches"]
        del eng, res, dparams, tparams
        gc.collect()
        torch.cuda.empty_cache()


def phase_archs(torch, report):
    """The seventh slice's archs through ``repro_torch.launch.serve``: (a)
    deepseek-v2-lite-16b and qwen2-7b at their full configs under the
    AdaOper scheduler (the default), at the scheduled phase's parameters;
    (b) granite-3-8b at its full config and chameleon-34b at full width,
    8 of its 48 layers, FIFO. Every request completes and each kernel
    launched as the workers' passes imply; the MoE layers' dropped
    assignments (capacity factor 1.25) are counted on the device, and the
    scheduler's DP solves and their host seconds."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe
    from repro_torch.serving import scheduler as sched_mod
    dispatch, dp = moe.dispatch, sched_mod.dp_partition
    for key, kw in (("archs", ARCHS_SCHEDULED), ("archs_fifo", ARCHS_FIFO)):
        drops, solves = [], [0, 0.0]

        def counted(ids, E, C):  # (dropped, assignments, tokens) per MoE call
            order, slot, valid = dispatch(ids, E, C)
            drops.append(((~valid).sum(), valid.numel(), ids.shape[0]))
            return order, slot, valid

        def timed_dp(*a, **k):  # every DP solve of the scheduler, and its host time
            t0 = time.perf_counter()
            out = dp(*a, **k)
            solves[0] += 1
            solves[1] += time.perf_counter() - t0
            return out
        moe.dispatch, sched_mod.dp_partition = counted, timed_dp
        try:
            (eng, responses, rep), launches = drive(serve, **kw)
        finally:
            moe.dispatch, sched_mod.dp_partition = dispatch, dp
        report[f"launches_{key}"] = launches
        report[key] = rep
        log(f"{key}: {rep['requests']} requests, {rep['tokens']} tokens, {rep['scheduler']}, "
            f"calibration {rep['calibration_s']:.3f} s, weights {rep['init_s']:.3f} s, "
            f"{rep['wall_s']:.3f} s wall, peak memory {rep['peak_mem_bytes'] / 2**30:.2f} GiB, "
            f"{rep['prefill_batches']} prefill batches; {json.dumps(rep['models'])}")
        log(f"{key} launches: {json.dumps(launches)}")
        if drops:
            by = {"prefill": [0, 0], "decode": [0, 0]}
            for d, n, t in drops:  # a decode pass routes one token per slot
                row = by["decode" if t == kw["max_slots"] else "prefill"]
                row[0] += int(d)
                row[1] += n
            log(f"{key} MoE assignments dropped at capacity factor 1.25: "
                + json.dumps({k: f"{d} of {n}" for k, (d, n) in by.items()}))
            report[f"{key}_moe_drops"] = by
        if rep["scheduler"] == "adaoper":
            rep["dp_solves"], rep["dp_solve_s"] = solves
            log(f"{key} DP solves {solves[0]} taking {solves[1]:.3f} s of the "
                f"{rep['wall_s']:.3f} s wall")
            log(f"{key} plan cache {json.dumps(rep['plan_cache'])}, admission reasons "
                f"{json.dumps(rep['admission_reasons'])}, drift events {rep['drift_events']}, "
                f"preemptions {json.dumps(rep['preemptions'])}")
        check_responses(key, eng, responses, kw["requests"] * len(kw["names"]), kw["max_new"])
        want = dict(attention_launches_expected(eng), ssd_scan=0)
        need = ["flash_attention", "decode_attention"]
        if any(w.cfg.use_mla for w in eng.workers.values()):
            need.append("mla_attention")
        if launches != want or min(launches[k] for k in need) == 0:
            raise SmokeFailure(f"{key}: kernel launches {launches}, expected {want}")
        if any(w.cfg.num_layers != kw.get("layers", {}).get(n, get_config(n).num_layers)
               for n, w in eng.workers.items()):
            raise SmokeFailure(f"{key}: a model was not served at its stated depth")
        del eng, responses
        torch.cuda.empty_cache()


def encdec_hybrid_engine():
    """The encdec_hybrid engine, not yet run: ``launch.serve.build_engine``
    queues seamless-m4t-medium's requests (frames drawn from
    ``ENCDEC["enc_lens"]``) under one ``AdaOperScheduler`` calibrated on
    both configs, then jamba-v0.1-52b, cut to ``HYBRID["layers"]``, joins
    the same engine through ``add_model`` with its own requests (uids after
    seamless's)."""
    import numpy as np

    from repro_torch.launch.serve import build_engine, make_scheduler, model_configs
    from repro_torch.models.model import init_params
    from repro_torch.serving.slots import Request
    e, h, kw = ENCDEC, HYBRID, ENCDEC_HYBRID
    cfgs = model_configs([e["name"], h["name"]], True, {h["name"]: h["layers"]})
    sched = make_scheduler(cfgs.values(), max(h["prompt_lens"]), max(e["max_new"], h["max_new"]),
                           kw["workload"], kw["seed"])
    eng = build_engine([e["name"]], e["requests"], e["prompt_lens"], e["max_new"],
                       kw["max_slots"], kw["max_len"], kw["seed"], "cuda", True, sched,
                       enc_lens=e["enc_lens"], max_enc_len=e["max_enc_len"])
    cfg = cfgs[h["name"]]
    eng.add_model(h["name"], cfg, init_params(cfg, kw["seed"], "cuda"), max_len=kw["max_len"])
    rng = np.random.default_rng(kw["seed"] + 1)
    for i in range(h["requests"]):
        n = int(rng.choice(h["prompt_lens"]))
        eng.submit(h["name"], Request(uid=e["requests"] + i, max_new_tokens=h["max_new"],
                                      prompt=rng.integers(1, cfg.vocab_size, n, dtype=np.int32)))
    return eng


def phase_encdec_hybrid(torch, report):
    """seamless-m4t-medium (full config) and jamba-v0.1-52b (full width, 8
    of 32 layers) served concurrently by one engine under
    ``AdaOperScheduler``: every request completes with its model's token
    count, flash and decode launched as the workers' passes imply (no SSD
    or MLA launch: Mamba1 has no kernel), the ledger holds both models'
    events; it prints the parameter counts, the peak memory, the wall time
    and the admission reasons."""
    t0 = time.perf_counter()
    eng = encdec_hybrid_engine()
    init_s = time.perf_counter() - t0
    sizes = {n: {"layers": w.cfg.num_layers, "encoder_layers": w.cfg.num_encoder_layers,
                 "params": w.cfg.param_count(), "bf16_gib": 2 * w.cfg.param_count() / 2**30}
             for n, w in eng.workers.items()}
    log(f"encdec_hybrid models (param_count): {json.dumps(sizes)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    responses, launches = drive(eng.run_all)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    reasons = dict(collections.Counter(r["reason"] for r in eng.admission.log))
    models = {n: {"prefill_calls": w.prefill_calls, "decode_calls": w.decode_calls,
                  "attention_layers": attention_layers(w.cfg)} for n, w in eng.workers.items()}
    rep = {"requests": len(responses), "tokens": int(sum(len(r.tokens) for r in responses)),
           "init_s": init_s, "wall_s": wall, "peak_mem_bytes": peak, "models": models,
           "sizes": sizes, "prefill_batches": eng.prefill_batches,
           "admission_reasons": reasons,
           "plan_cache": {"hits": eng.scheduler.plan_cache_hits,
                          "misses": eng.scheduler.plan_cache_misses}}
    report["encdec_hybrid"] = rep
    report["launches_encdec_hybrid"] = launches
    log(f"encdec_hybrid: {rep['requests']} requests, {rep['tokens']} tokens, weights and "
        f"calibration {init_s:.3f} s, {wall:.3f} s wall, peak memory {peak / 2**30:.2f} GiB, "
        f"{eng.prefill_batches} prefill batches; {json.dumps(models)}")
    log(f"encdec_hybrid admission reasons {json.dumps(reasons)}, plan cache "
        f"{json.dumps(rep['plan_cache'])}")
    log(f"encdec_hybrid launches: {json.dumps(launches)}")
    want_new = {ENCDEC["name"]: ENCDEC["max_new"], HYBRID["name"]: HYBRID["max_new"]}
    n_enc = ENCDEC["requests"]
    bad = [r.uid for r in responses if r.error is not None or len(r.tokens) != want_new[
        ENCDEC["name"] if r.uid < n_enc else HYBRID["name"]]]
    vocab = max(w.cfg.padded_vocab for w in eng.workers.values())
    if (len(responses) != n_enc + HYBRID["requests"] or bad
            or any(((r.tokens < 0) | (r.tokens >= vocab)).any() for r in responses)):
        raise SmokeFailure(f"encdec_hybrid: {len(responses)} responses, bad uids {bad}")
    want = dict(attention_launches_expected(eng), ssd_scan=0)
    if launches != want or min(launches["flash_attention"], launches["decode_attention"]) == 0:
        raise SmokeFailure(f"encdec_hybrid: kernel launches {launches}, expected {want}")
    seen = {(ev.kind, ev.model) for ev in eng.ledger.events}
    missing = [(k, m) for k in ("prefill", "decode", "request") for m in eng.workers
               if (k, m) not in seen]
    if missing:
        raise SmokeFailure(f"encdec_hybrid: the ledger lacks events {missing}")


def timed_on_card(torch, call):
    """(call(), wall s, peak device bytes), the card synchronised around the
    call and its peak reset just before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def bucketed_engine(mode, params, scheduled=True, names=None, max_slots=None):
    """A ``ServingEngine(mode=...)`` over BUCKETED's models (``params``:
    name -> (cfg, weights), shared between engines), under a fresh
    ``AdaOperScheduler`` calibrated as the scheduled phase's or FIFO, with
    BUCKETED's requests queued bucket by bucket: per model, half of them
    at each prompt length, uids k·requests + i for the k-th model."""
    import numpy as np

    from repro_torch.launch.serve import make_scheduler
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.slots import Request
    b = BUCKETED
    names = names or b["names"]
    sched = (make_scheduler([params[n][0] for n in names], max(b["prompt_lens"]), b["max_new"],
                            b["workload"], b["seed"]) if scheduled else None)
    eng = ServingEngine(scheduler=sched, mode=mode, max_slots=max_slots or b["max_slots"])
    for k, name in enumerate(b["names"]):
        if name not in names:
            continue
        cfg, weights = params[name]
        eng.add_model(name, cfg, weights, max_len=b["max_len"])
        rng = np.random.default_rng(b["seed"] + k)
        per = b["requests"] // len(b["prompt_lens"])
        for i in range(b["requests"]):
            plen = b["prompt_lens"][i // per]
            eng.submit(name, Request(uid=k * b["requests"] + i, max_new_tokens=b["max_new"],
                                     prompt=rng.integers(1, cfg.vocab_size, plen,
                                                         dtype=np.int32)))
    return eng


def bucketed_run(torch, eng, temperature=0.0):
    """Serve every queued request (``run_all``) with the launch counts set to
    0 just before. Returns (responses, launches, summary)."""
    (out, wall, peak), launches = drive(timed_on_card, torch=torch,
                                        call=lambda: eng.run_all(temperature=temperature))
    summary = {"mode": eng.mode, "temperature": temperature, "requests": len(out),
               "tokens": int(sum(len(r.tokens) for r in out)), "wall_s": wall,
               "peak_mem_bytes": peak, "launches": launches,
               "calls": {n: {"prefill": w.prefill_calls, "decode": w.decode_calls}
                         for n, w in eng.workers.items()}}
    if eng.mode == "bucketed":  # the batch of each step, chosen by the scheduler (or FIFO)
        summary["batches"] = {n: [s["batch"] for s in eng.stats[n]] for n in eng.workers}
    else:
        summary["prefill_batches"] = eng.prefill_batches
        summary["admission_reasons"] = dict(collections.Counter(
            r["reason"] for r in eng.admission.log))
    return out, launches, summary


def recorded_run(torch, eng, temperature=0.0):
    """Serve every queued request of a continuous engine, untimed, with each
    model's decision gaps recorded. Returns (responses, name -> Gaps)."""
    with contextlib.ExitStack() as recording:
        gaps = {name: recording.enter_context(record_gaps(
                    torch, eng, [(r.uid, r.prompt, r.max_new_tokens) for r in eng.queues[name]],
                    temperature, name))
                for name in eng.workers}
        out = eng.run_all(temperature=temperature)
    return out, gaps


def bucketed_checks(label, eng, out, launches):
    """Every request answered with its token count; flash, decode and the SSD
    scan launched as the workers' passes imply, each at least once."""
    check_responses(label, eng, out, BUCKETED["requests"] * len(eng.workers), BUCKETED["max_new"])
    ssm = [w for w in eng.workers.values() if "ssd" in w.cfg.layer_kinds()]
    want = dict(attention_launches_expected(eng),
                ssd_scan=sum(w.cfg.num_layers * w.prefill_calls for w in ssm))
    need = ("flash_attention", "decode_attention") + (("ssd_scan",) if ssm else ())
    if launches != want or min(launches[k] for k in need) == 0:
        raise SmokeFailure(f"{label}: kernel launches {launches}, expected {want}")


def phase_bucketed(torch, report):
    """The position-synchronous path (``ServingEngine(mode="bucketed")``):
    BUCKETED's three models at their full configs in bf16 under the AdaOper
    scheduler, then the same requests in continuous mode on the same
    weights (tokens identical per uid, or apart only from a printed
    near-tie of the continuous run's logits, whose gaps an untimed rerun of
    the continuous engine records); then one model FIFO at temperature 0.8
    in both modes, whose tokens must be identical (the same per-request
    streams, the same batches: one bucket of 4 at a time)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    b = BUCKETED
    params = {n: (get_config(n), init_params(get_config(n), b["seed"], "cuda"))
              for n in b["names"]}
    res, outs = {}, {}
    for mode in ("bucketed", "continuous"):
        eng = bucketed_engine(mode, params)
        out, launches, summary = bucketed_run(torch, eng, 0.0)
        bucketed_checks(f"bucketed {mode}", eng, out, launches)
        log(f"bucketed {mode}: {json.dumps(summary)}")
        res[mode], outs[mode] = summary, out
        if mode == "bucketed":
            report["launches_bucketed"] = launches
        del eng
    recorded, gaps = recorded_run(torch, bucketed_engine("continuous", params))

    def of(run, k):  # the k-th model's responses
        return [r for r in run if r.uid // b["requests"] == k]
    diverged = {}
    for k, name in enumerate(b["names"]):
        token_check(f"bucketed {name} continuous rerun", of(outs["continuous"], k),
                    of(recorded, k), gaps[name], exact=False, names=("continuous", "rerun"))
        diverged[name] = token_check(f"bucketed {name} greedy", of(outs["bucketed"], k),
                                     of(recorded, k), gaps[name], exact=False,
                                     names=("bucketed", "continuous"))
    del recorded, gaps
    # sampled: one model FIFO, a continuous pool of 4 slots so that each
    # admission takes one whole bucket, as the bucketed step does; no gaps
    # are recorded, since any divergence fails
    name = b["sampled"]
    sampled = {}
    for mode in ("bucketed", "continuous"):
        eng = bucketed_engine(mode, params, scheduled=False, names=(name,), max_slots=4)
        out, launches, summary = bucketed_run(torch, eng, b["temperature"])
        bucketed_checks(f"bucketed {name} sampled {mode}", eng, out, launches)
        log(f"bucketed {name} sampled {mode}: {json.dumps(summary)}")
        sampled[mode] = (out, summary)
        del eng
    diverged[f"{name} sampled"] = token_check(
        f"bucketed {name} sampled", sampled["bucketed"][0], sampled["continuous"][0],
        collections.defaultdict(lambda: (None, None)), exact=True,
        names=("bucketed", "continuous"))
    report["bucketed"] = {"greedy": res, "sampled": {m: v[1] for m, v in sampled.items()},
                          "uids_diverged": diverged}


def fleet_arm(torch, population, params, scenario, uncertainty):
    """One fleet replay of FLEET's population under ``scenario``, the
    assistant served by the full model in ``params`` on the card, through
    ``FleetReplay(backend="serving")``; with the launch counts set to 0
    just before. Returns (replay, report, launches, wall s, peak bytes);
    the replay's ``device_replays`` hold each device's engine."""
    from repro_torch.fleet import FleetReplay
    from repro_torch.fleet.workloads import ASSISTANT
    f = FLEET
    rep = FleetReplay(population, scenario=scenario, duration_s=f["duration_s"], seed=f["seed"],
                      calib_samples=f["calib_samples"], backend="serving",
                      uncertainty=uncertainty,
                      risk_level=f["risk_level"] if uncertainty else None,
                      serving_models={ASSISTANT: params}, max_slots=f["max_slots"])
    (out, wall, peak), launches = drive(timed_on_card, torch=torch, call=rep.run)
    return rep, out, launches, wall, peak


FLEET_COUNTERS = ("faults", "recoveries", "fault_replans", "op_retries", "aborted", "rejected",
                  "shed", "deadline_requeues", "deadline_misses", "deadline_evictions",
                  "admission_denials", "interval_repartitions", "battery_dead")


def fleet_summary(rep, out, launches, wall, peak):
    """Per arm: simulated energy per request, SLO attainment and virtual
    latency percentiles, interval coverage and width, the fault, shed and
    deadline counters, each device's arrivals, and the card's wall,
    memory and launches."""
    fl = out.fleet
    return {
        "scenario": out.scenario, "devices": fl["n_devices"], "requests": fl["n_requests"],
        "arrivals": [len(rep.device_trace(i)) for i in range(len(out.devices))],
        "simulated_energy_per_request_j (DeviceSim phone rails, not the card's)":
            fl["energy_per_request_j"],
        "slo_attainment": fl["slo_attainment"], "virtual_latency_s": fl["latency_s"],
        "interval_coverage": fl.get("interval_coverage"),
        "interval_width_j_mean": fl.get("interval_width_j_mean"),
        "counters": {k: fl["counters"].get(k, 0) for k in FLEET_COUNTERS},
        "wall_s": wall, "peak_mem_bytes": peak, "launches": launches}


def fleet_launch_check(label, launches, devices):
    """Flash and decode launched, as often as the devices' engines' passes
    imply (no SSD or MLA launch: the assistant is a dense GQA model); each
    engine's pool has the decode shape that the kernels phase checks."""
    want = collections.Counter()
    for dr in devices:
        want.update(attention_launches_expected(dr.engine))
        shapes = {(dr.engine.max_slots, w.max_len) for w in dr.engine.workers.values()}
        if shapes != {(FLEET["max_slots"], FLEET["max_len"])}:
            raise SmokeFailure(f"{label}: device engine pools (slots, max_len) {shapes}")
    want = {k: want.get(k, 0) for k in launches}
    if launches != want or min(launches["flash_attention"], launches["decode_attention"]) == 0:
        raise SmokeFailure(f"{label}: kernel launches {launches}, expected {want}")


def phase_fleet(torch, report):
    """The fleet replay (``repro_torch.fleet``): FLEET's population of
    simulated phones, each running the AdaOper closed loop, under the
    chaos_mixed schedule with the uncertainty layer and risk-aware
    admission, the assistant served token by token by full tinyllama-1.1b
    in bf16 on the card beside vision and AR frames on one virtual
    timeline; twice, and the two reports must be equal (virtual time).
    Every arrival is a record or a rejection, faults and recoveries were
    injected, interval coverage is reported, flash and decode launched.
    Then one arm under mixed traffic with point estimates. The joules are
    DeviceSim's simulated phone rails, not the card's."""
    from repro_torch.configs.base import get_config
    from repro_torch.fleet import sample_population
    from repro_torch.models.model import init_params
    f = FLEET
    cfg = get_config(f["assistant"])
    params = (cfg, init_params(cfg, f["seed"], "cuda"))
    population = sample_population(f["devices"], seed=f["population_seed"])
    runs = []
    for i in range(2):
        rep, out, launches, wall, peak = fleet_arm(torch, population, params, f["scenario"], True)
        summary = fleet_summary(rep, out, launches, wall, peak)
        log(f"fleet {f['scenario']} run {i + 1}: {json.dumps(summary)}")
        fleet_launch_check(f"fleet {f['scenario']} run {i + 1}", launches, rep.device_replays)
        runs.append((rep, out, summary))
    rep, out, summary = runs[0]
    if out.to_dict() != runs[1][1].to_dict():
        raise SmokeFailure("fleet: the two runs of one replay gave different reports")
    for i, d in enumerate(out.devices):
        got = d.n_requests + d.counters.get("rejected", 0) + d.counters.get("aborted", 0)
        if got != summary["arrivals"][i]:
            raise SmokeFailure(f"fleet: device {d.device} accounts for {got} of "
                               f"{summary['arrivals'][i]} arrivals")
    c = out.fleet["counters"]
    if not (c.get("faults") and c.get("recoveries")) or "interval_coverage" not in out.fleet:
        raise SmokeFailure(f"fleet: faults {c.get('faults')}, recoveries "
                           f"{c.get('recoveries')}, interval coverage "
                           f"{out.fleet.get('interval_coverage')}")
    report["launches_fleet"] = summary["launches"]
    rep2, out2, launches2, wall2, peak2 = fleet_arm(torch, population, params, f["baseline"],
                                                    False)
    base = fleet_summary(rep2, out2, launches2, wall2, peak2)
    log(f"fleet {f['baseline']} (point estimates): {json.dumps(base)}")
    fleet_launch_check(f"fleet {f['baseline']}", launches2, rep2.device_replays)
    if "interval_coverage" in out2.fleet:
        raise SmokeFailure("fleet: a point-estimate replay reported interval coverage")
    report["fleet"] = {f["scenario"]: [r[2] for r in runs], f["baseline"]: base}


@contextlib.contextmanager
def model_spans(torch):
    """Profiler ranges over each worker's prefill and decode passes (``pass
    <model>``) and over every Mamba1 mixer call (``mamba1``), for the
    device time under each."""
    from repro_torch.models import ssm
    from repro_torch.serving.workers import ModelWorker
    saved = {(ModelWorker, "_prefill"): ModelWorker._prefill,
             (ModelWorker, "_decode"): ModelWorker._decode,
             (ssm, "mamba1_forward"): ssm.mamba1_forward,
             (ssm, "mamba1_decode"): ssm.mamba1_decode}

    def spanned(fn, name):
        def wrapper(*a, **k):
            with torch.profiler.record_function(name(a)):
                return fn(*a, **k)
        return wrapper
    for (owner, attr), fn in saved.items():
        name = ((lambda a: f"pass {a[0].name}") if owner is ModelWorker
                else (lambda a: "mamba1"))
        setattr(owner, attr, spanned(fn, name))
    try:
        yield
    finally:
        for (owner, attr), fn in saved.items():
            setattr(owner, attr, fn)


def is_span(name):
    """Whether ``name`` is one of ``model_spans``' ranges."""
    return name.startswith("pass ") or name == "mamba1"


def phase_profile_bucketed(torch, report):
    """The bucketed phase's bucketed-mode serve, profiled warm."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    params = {n: (get_config(n), init_params(get_config(n), BUCKETED["seed"], "cuda"))
              for n in BUCKETED["names"]}
    profile_workload(torch, report, "profile_bucketed",
                     lambda: bucketed_engine("bucketed", params), spans=model_spans)


def phase_profile_fleet(torch, report):
    """The fleet phase's chaos replay, profiled warm, with the device and
    host time under the assistant's model passes (``pass assistant-llm``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.fleet import sample_population
    from repro_torch.models.model import init_params
    f = FLEET
    cfg = get_config(f["assistant"])
    params = (cfg, init_params(cfg, f["seed"], "cuda"))
    population = sample_population(f["devices"], seed=f["population_seed"])

    class FleetRun:
        """``profile_workload``'s engine: ``run_all`` replays the chaos arm;
        ``workers`` are then every device engine's workers."""
        spec = {}

        def __init__(self):
            self.workers = {}

        def run_all(self):
            devices = fleet_arm(torch, population, params, f["scenario"], True)[0].device_replays
            self.workers = {(i, n): w for i, dr in enumerate(devices)
                            for n, w in dr.engine.workers.items()}

    profile_workload(torch, report, "profile_fleet", FleetRun, spans=model_spans)


def phase_profile_encdec_hybrid(torch, report):
    profile_workload(torch, report, "profile_encdec_hybrid", encdec_hybrid_engine,
                     spans=model_spans)


def engine_for(kw, coexec=False):
    """The engine ``serve(**kw)`` would build, not yet run; ``coexec``: its
    scheduler plans the busy models jointly."""
    from repro_torch.launch.serve import build_engine, make_scheduler, model_configs
    kw = dict(kw)
    scheduled, workload = kw.pop("scheduler"), kw.pop("workload", "moderate")
    sched = (make_scheduler(model_configs(kw["names"], kw["full"], kw.get("layers")).values(),
                            max(kw["prompt_lens"]), kw["max_new"], workload, kw["seed"], coexec)
             if scheduled else None)
    return build_engine(**kw, scheduler=sched)


def phase_profile(torch, report):
    profile_workload(torch, report, "profile", lambda: engine_for(SERVE))


def phase_profile_scheduled(torch, report):
    profile_workload(torch, report, "profile_scheduled", lambda: engine_for(SCHEDULED))


def phase_profile_archs(torch, report):
    profile_workload(torch, report, "profile_archs", lambda: engine_for(ARCHS_SCHEDULED))


def phase_profile_spec_deepseek(torch, report):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.slots import Request
    from repro_torch.serving.speculative import truncated_draft
    cfg = get_config("deepseek-v2-lite-16b")
    dcfg, dparams, tparams = truncated_draft(cfg, init_params(cfg, seed=SPEC["seed"],
                                                              device="cuda"))
    reqs = spec_requests(cfg, SPEC["requests"], SPEC["prompt_lens"], SPEC["max_new"],
                         SPEC["seed"])

    def build():
        eng = spec_engine(cfg, tparams, (dcfg, dparams), [cfg, dcfg], SPEC["max_slots"],
                          SPEC["max_len"])
        for uid, p, n in reqs:
            eng.submit(cfg.name, Request(uid, p, n))
        return eng
    profile_workload(torch, report, "profile_spec_deepseek", build)


def phase_profile_spec(torch, report):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.slots import Request
    from repro_torch.serving.speculative import truncated_draft
    cfg = get_config("tinyllama-1.1b")
    dcfg, dparams, tparams = truncated_draft(cfg, init_params(cfg, seed=SPEC["seed"],
                                                              device="cuda"))
    reqs = spec_requests(cfg, SPEC["requests"], SPEC["prompt_lens"], SPEC["max_new"],
                         SPEC["seed"])

    def build():
        eng = spec_engine(cfg, tparams, (dcfg, dparams), [cfg, dcfg], SPEC["max_slots"],
                          SPEC["max_len"])
        for uid, p, n in reqs:
            eng.submit(cfg.name, Request(uid, p, n))
        return eng
    profile_workload(torch, report, "profile_spec", build)


def profile_workload(torch, report, key, build, spans=None):
    """``build()`` gives an engine with its requests queued, not yet run;
    ``spans(torch)``, a context manager, opens profiler ranges in the traced
    run whose device time (kernels launched inside them) is reported."""
    from torch.profiler import ProfilerActivity, profile
    build().run_all()  # warm-up: cuBLAS handles, the allocator's pools
    eng = build()  # the same run, warm and untraced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_all()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    del eng  # one engine's weights at a time
    eng = build()
    torch.cuda.synchronize()
    ranges = spans(torch) if spans is not None else contextlib.nullcontext()
    with ranges, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_all()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, span_ms = [], {}
    for evt in prof.key_averages():
        # a range's device-side span (first to last kernel, gaps included)
        # is no kernel; its kernels' own time is summed below
        if evt.device_type != torch.autograd.DeviceType.CUDA or is_span(evt.key):
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
    if spans is not None:  # device time of the kernels launched inside each range
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CPU and is_span(evt.name):
                us = getattr(evt, "device_time_total", None)
                row = span_ms.setdefault(evt.name, {"calls": 0, "device_ms": 0.0,
                                                    "host_ms": 0.0})
                row["calls"] += 1
                row["device_ms"] += (evt.cuda_time_total if us is None else us) * 1e-3
                row["host_ms"] += evt.cpu_time_total * 1e-3
        out["spans"] = span_ms
    report[key] = out
    log(f"{key}:", json.dumps(out))


# each kernel's row of the times phase in the kernels line: (model, B, S)
LINE_ROWS = {"flash_attention": ("tinyllama", 8, 512), "decode_attention": ("tinyllama", 8, 2048),
             "ssd_scan": ("mamba2", 8, 512), "mla_attention": ("mla", 8, 1024)}
# each kernel's count on the path of its own slice: attention on the FIFO
# serve path, the SSD scan on the scheduled path, the MLA attention on the
# scheduled deepseek-v2-lite-16b serve with its draft (the spec phase)
MAIN_PATH = {"flash_attention": "serve", "decode_attention": "serve", "ssd_scan": "scheduled",
             "mla_attention": "spec_deepseek"}


def kernels_line(report):
    rows = {r["kernel"]: r for r in report.get("timings", [])
            if (r["model"], r["B"], r["S"]) == LINE_ROWS[r["kernel"]] and "shape" not in r}
    paths = {p: report.get(f"launches_{p}", {})
             for p in ("scheduled", "joint", "spec", "spec_deepseek", "archs", "archs_fifo",
                       "encdec_hybrid", "bucketed", "fleet")}
    paths = {"serve": report.get("launches", {}), **paths}
    out = []
    for name, (src, replaces) in SOURCES.items():
        t = rows.get(name, {})
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        main = MAIN_PATH[name]
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
           "joint": phase_joint, "spec": phase_spec, "archs": phase_archs,
           "encdec_hybrid": phase_encdec_hybrid, "bucketed": phase_bucketed,
           "fleet": phase_fleet,
           "profile_encdec_hybrid": phase_profile_encdec_hybrid,
           "profile_bucketed": phase_profile_bucketed, "profile_fleet": phase_profile_fleet,
           "profile": phase_profile,
           "profile_scheduled": phase_profile_scheduled, "profile_spec": phase_profile_spec,
           "profile_archs": phase_profile_archs,
           "profile_spec_deepseek": phase_profile_spec_deepseek,
           "mla_parts": phase_mla_parts}
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
