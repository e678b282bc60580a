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
    python3 chip_smoke.py --phases kimi,mesh1,shard2  # kimi-k2, a mesh of one, two ranks
    python3 chip_smoke.py --phases train    # training: tinyllama-1.1b, remat, pipeline, MoE
    python3 chip_smoke.py --phases kernels,mesh_families  # four families at a model axis of 2
    python3 chip_smoke.py --phases mesh_wide  # three GQA models and MLA at a model axis of 8
    python3 chip_smoke.py --phases dryrun  # the production mesh's dry run, on the meta device
    python3 chip_smoke.py --phases train_mesh  # seven arms trained on (2,1), (1,2), (2,2), (1,8)

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
                the buckets, the SSD scan at the buckets' exact lengths;
                then kimi-k2's head dim 112 (64 on 8 heads, and one rank's
                32 on 4): flash bf16 and fp32 at the prefill (B 8, S 512),
                the tile edges (S 1, 17, 100) and the verify (8 slots x T
                5), decode (G = 8) at 8 slots x 2048, 4 x 64 (one split),
                a parked slot and a slot of kv_len 0, with the error of
                output columns 0-63 and 64-111 printed apart; then one
                model rank's shapes of the mesh_families phase: the MLA
                kernels at G = 8, 4, 2 and 1 (a rank's heads at M = 2, 4,
                8 and 16; T = 1 and 5; their verify rows bit for bit
                equal to decode steps), flash at deepseek's
                8-head prefill, seamless's 8 heads and jamba's 16 on 4,
                decode at those heads, the SSD scan on 40 heads; and one
                rank's heads of the mesh_wide phase: flash at 4 on 1 (D 64,
                128) and 1 on 1 (D 256, softcap, window), decode at G 4 and
                1
  3. parity     each model at full width, cut to 2 layers, fp32 and bf16:
                prefill (mamba2: a masked pow2 bucket) and 8 ragged decode
                steps through the kernels and through the plain versions
                agree; for deepseek-v2-lite (layer 0 dense, layer 1 MoE) the
                kernel run replays the plain run's expert choices and each
                router disagreement must sit at a printed near-tie; also
                seamless-m4t-medium (2 encoder + 2 decoder layers, per-row
                encoder lengths) and jamba-v0.1-52b cut to (mamba, mamba,
                attn), its second Mamba1 layer carrying the MoE; and
                kimi-k2-1t-a32b at full width, 1 layer, bf16 only (its
                router's top-8 flips among 384 experts held to ROUTER_TIE);
                then full mamba2-2.7b's 64 layers, each layer's distance
                from the exact-fp32 route through the bf16 kernels and
                through the bf16 plain versions (``bf16_depth_attribution``)
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
                6 s of chaos_mixed traffic each (voice assistant, video and
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
 12. kimi       kimi-k2-1t-a32b at full width cut to 1 of its 61 layers
                (36.1 GiB in bf16) through ``launch.serve``, FIFO: 8
                requests of 64-512 tokens, 16 new tokens, 8 slots of 1024;
                every request completes, flash launched once per prefill
                pass and decode once per pass; then warm on the same
                weights (tokens identical), and once more with the MoE's
                drops counted and each decision's top-2 logit gap and
                deciding row recorded; the prefill logits of a (4, 128)
                batch; and the same recorded run at a drop-free capacity
                (the shard2 phase's witness). It prints the peak memory,
                the warm wall and the MoE drop share
 13. mesh1      a (1, 1) mesh (``launch.mesh.make_debug_mesh``) against no
                mesh: full tinyllama-1.1b scheduled through
                ``launch.serve``, continuous and bucketed, and kimi-k2 (1
                layer, full width) FIFO: tokens, ledger joules and launches
                identical, sharded dims in the shard report
 14. shard2     two ranks on the one card (``launch.sharded.run_ranks``,
                spawned, gloo over CUDA tensors): a probe of the
                collectives, then full tinyllama-1.1b in fp32 (greedy tokens
                equal to the unsharded run's, logits' largest difference
                printed) and kimi-k2 at full width, 1 layer, bf16, each rank
                192 experts and 32 on 4 heads: prefill logits within bf16
                rounding of the kimi phase's (its experts replayed), and
                tokens against its recorded runs, each difference
                explained at its own row (a near-tie gap or router flip)
                or, at the serve's capacity, in its own pass; the
                drop-free witness allows only the former; each rank's peak
                memory and launches
 15. train      training on the card, which launches no kernel (no kernel
                has a backward, in either package): full tinyllama-1.1b (bf16
                params and AdamW moments, B 8, S 512, synthetic data of seed
                0) takes 40 steps at lr 1e-3 (warmup 8, cosine to step 40),
                remat "full"; every loss and grad norm finite, the mean loss
                of the last 5 steps more than 1 nat below the first 5's; the
                step-0 train logits within MODEL_TOL_BF16 of the prefill's
                through the flash kernel; a checkpoint after step 20 restored
                into a fresh model and optimizer state bit for bit, then the
                last 20 steps again from it (the loss gap printed); two steps
                at each remat policy ("full", "dots", "none": first losses and
                grad norms within bf16 rounding, the warm step's time and the
                peak memory of each); tinyllama
                cut to 4 layers under the pipeline plan (2 stages, 2
                microbatches): logits, loss and grad norm against the
                unpipelined run's; deepseek-v2-lite-16b at full width cut to
                4 of its 27 layers (MLA, MoE), B 4, S 512, 20 steps: the loss
                falls, the aux loss positive at every step, the MoE drop
                share; a flash launch on a q that requires grad refuses. It
                prints the warm median step time, tokens/s and peak memory
                beside the card's name and power limit
 16. mesh_families  MLA (deepseek-v2-lite-16b), Mamba2 (mamba2-2.7b), the
                encoder-decoder (seamless-m4t-medium) and the Mamba1 +
                attention + MoE hybrid (jamba-v0.1-52b) on two ranks of the
                one card (a model axis of 2): fp32 at full width cut to 2
                layers (jamba to its attention layer and a Mamba1 MoE
                layer), ``generate`` and the continuous FIFO engine with
                tokens equal to the unsharded run's; bf16 at full width
                (jamba 8 of 32 layers), the FIFO engine on the serve's 8
                requests fed the unsharded run's tokens, its expert choices
                replayed: every decision where a rank's own choice differs
                sits at a near-tie of the unsharded run, no router flip past
                ROUTER_TIE with each layer fed the unsharded run's input,
                the prefill logits at most MESH_FP32_FACTOR times as far
                from the exact-fp32 route (the same weights cast up) as the
                unsharded run's; launches, collectives, wall and peak
                memory per rank
 17. mesh_wide  tinyllama-1.1b, gemma2-2b and qwen2-7b at full width on
                eight ranks of the one card (a model axis of 8 over their 4
                kv heads: each kv head's projections whole on 2 ranks, its
                K/V cache cut on its sequence over them, qwen2's groups of 7
                query heads padded with a zero head), and
                deepseek-v2-lite-16b (2 MLA heads a rank, its latent cut on
                its sequence in 8), fp32 (2 layers) and bf16 (8 layers)
                judged as mesh_families; every decode through the piece
                modes (the decode kernel's at the group's 8, 2 or 8 heads,
                the MLA kernels' at 16), launched and merged over the kv
                group once per attention layer per step on every rank, the
                whole-cache decode kernels never; the ranks holding a
                padded head check that it adds nothing; every rank's
                parameter and slot-pool bytes equal the dry run's count
 18. dryrun     the production mesh's dry run (``repro_torch.launch.dryrun``)
                of deepseek-v2-lite-16b decode_32k (the MLA kernels at G = 1)
                and tinyllama-1.1b long_500k (the piece mode) on (16, 16),
                on the meta device: each rank's bytes, FLOPs, collectives
 19. times      CUDA-event device times of each kernel, its plain version
                and one PyTorch library call (a yardstick only), beside the
                bound; for the attention kernels and the library call also
                the wall time per call back to back (host enqueue included);
                flash also at the verify's shapes (T query rows per slot
                against the cache), the MLA kernel at T = 1 and T = 5 at
                16 heads and at a model rank's 8, 4, 2 and 1 (with the
                mesh_families and mesh_wide phases' launches); flash and
                decode at a
                mesh_wide rank's heads (with that phase's launches); the SSD
                scan on 40 heads
                (a rank's) at B 8 S 512; the MLA piece mode at 16 heads over
                the first piece of 1024 latent rows cut in 8 and in 2 (with
                the mesh_wide phase's launches); the SSD scan at the scheduled
                serve's (B, S) (``SSD_SERVE``, and any other this run's
                scheduled phase gave it); flash and decode at the
                encdec_hybrid serve's seamless and jamba shapes, and at
                kimi-k2's (64 on 8 and 32 on 4 heads, D 112), with the
                launches of the kimi phase's serve
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
  profile_train (only when asked for) three warm steps of the train
                phase's full tinyllama-1.1b: device busy time, idle
                share, device time by kernel group and under the forward
                and the AdamW update (the backward is the rest)
  collectives   (only when asked for) an all-reduce among 2 and 8 ranks on the
                card through gloo and through the card's memory
                (``collectives.SameCard``), at a decode step's and a
                prefill's fp32 partial sums: the wall per call
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
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("device", "kernels", "parity", "serve", "scheduled", "joint", "spec", "archs",
          "encdec_hybrid", "bucketed", "fleet", "kimi", "mesh1", "shard2", "train", "yolo",
          "train_mesh", "serve_mesh", "mesh_families", "mesh_wide", "dryrun", "times")
EXTRA = ("profile", "profile_scheduled", "profile_spec", "profile_archs",
         "profile_spec_deepseek", "mla_parts", "profile_encdec_hybrid", "profile_bucketed",
         "profile_fleet", "profile_train", "parity_mamba2", "collectives")  # only when asked for
SERVE = dict(names=("tinyllama-1.1b", "gemma2-2b"), requests=8, prompt_lens=(64, 128, 256, 512),
             max_new=16, max_slots=8, max_len=1024, seed=0, device="cuda", full=True,
             scheduler=False)
# prompt lengths off the pow2 grid, so mamba2 admits masked, left-padded groups
SCHEDULED = dict(SERVE, names=("tinyllama-1.1b", "gemma2-2b", "mamba2-2.7b"),
                 prompt_lens=(64, 96, 200, 512), scheduler=True, workload="moderate")
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# the decode kernel's piece mode writes fp32 o and lse in both dtypes
PIECE_TOL = {"bfloat16": TOL["float32"], "float32": TOL["float32"]}
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
# a kv group's gathered heads of qwen2-7b at a model axis of 8: its 7 query
# heads padded to 8, on its one kv head (the decode kernel's piece mode)
QWEN2_GROUP = dict(H=8, Hkv=1, D=128, softcap=None)
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
# traffic for duration_s of virtual time (cut from 10 s, then 6 s, to keep the
# whole run inside its time limit; 4 s still injects 15 faults and 12
# recoveries, the same as 6 s), the
# assistant full tinyllama-1.1b (FleetReplay's max_slots and its engines'
# max_len: the decode's shape)
FLEET = dict(devices=3, population_seed=0, scenario="chaos_mixed", baseline="mixed",
             duration_s=4.0, seed=5, calib_samples=120, risk_level=0.9,
             assistant="tinyllama-1.1b", max_slots=4, max_len=64)
# jamba in the parity phase: the 3-layer stack whose Mamba1 layer 1 has MoE
JAMBA_PARITY = ("mamba", "mamba", "attn")
# the archs phase: (a) the two archs that need the new kernels, under the
# scheduler at the scheduled phase's parameters; (b) the other two FIFO,
# chameleon-34b cut to 8 of its 48 layers (63.9 GiB in bf16 at full depth)
ARCHS_SCHEDULED = dict(SCHEDULED, names=("deepseek-v2-lite-16b", "qwen2-7b"))
ARCHS_FIFO = dict(SCHEDULED, names=("granite-3-8b", "chameleon-34b"), scheduler=False,
                  layers={"chameleon-34b": 8})
# kimi-k2-1t-a32b: 64 q heads on 8 kv heads of 112 (G = 8), and one rank's
# 32 on 4 at a model axis of 2; the kimi phase serves it at full width cut
# to 1 of its 61 layers (36.1 GiB in bf16), FIFO, at the serve's shapes
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI = dict(H=64, Hkv=8, D=112, softcap=None)
KIMI_RANK = dict(H=32, Hkv=4, D=112, softcap=None)
KIMI_SERVE = dict(SERVE, names=(KIMI_ARCH,), layers={KIMI_ARCH: 1})
# the mesh1 phase: full tinyllama-1.1b scheduled, on a (1, 1) mesh and on none
MESH1 = dict(SCHEDULED, names=("tinyllama-1.1b",))
# the shard2 phase: two ranks on the one card (gloo over CUDA tensors),
# full tinyllama-1.1b in fp32 at the serve's shapes, then kimi as the
# kimi phase serves it; LOGIT_PROMPTS: the batch whose prefill logits the
# fp32 arm compares; the ranks' time limit
SHARD2 = dict(world=2, tiny="tinyllama-1.1b", logit_prompts=(4, 128), timeout=420.0)
# the batch whose prefill logits the shard2 phase holds against the
# unsharded kimi's, with the unsharded run's experts replayed
KIMI_LOGIT_PROMPTS = (4, 128)
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
    # the decode kernel's piece mode: one data rank's piece of a KV cache cut
    # on its sequence (the serve_mesh phase's odd buckets)
    "decode_attention_piece": ("src/repro_torch/kernels/csrc/decode_attention_piece.cu",
                               "src/repro/kernels/decode_attention.py:87"),
    # the MLA kernels' piece mode: a rank's piece of a latent cut on its
    # sequence over the model ranks (the mesh_wide and serve_mesh deepseek
    # arms); at T > 1 also flash's place (flash_attention.py:106)
    "mla_attention_piece": ("src/repro_torch/kernels/csrc/mla_attention_bf16.cu",
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


# the bounds' formulas live in the package (``repro_torch.kernels.cost``),
# which the kernel wrappers' meta route (the dry run) counts by too; these
# fix this script's shapes


def _cost():
    from repro_torch.kernels import cost
    return cost


def bound(flops, nbytes, dtype_name):
    return _cost().bound(flops, nbytes, dtype_name)


def flash_bound(B, S, H, Hkv, D, window, dtype_name, elem, Dv=None):
    """2·H·(Dk + Dv) FLOPs per kept (query, key) pair; q, k, v, o once."""
    return _cost().flash_bound(B, S, H, Hkv, D, window, dtype_name, elem, Dv=Dv)


def flash_bound_full(B, Sq, Sk, H, Hkv, D, dtype_name, elem):
    """Flash without a mask (the encoder, the cross-attention's prefill):
    every (query, key) pair kept; q, k, v, o once."""
    return _cost().flash_bound_full(B, Sq, Sk, H, Hkv, D, dtype_name, elem)


def decode_bound_kept(kept, B, H, Hkv, D, dtype_name, elem):
    """Decode over ``kept`` K/V entries in all: each read once, q and o
    once, 4·H·D FLOPs per entry."""
    return _cost().decode_bound_kept(kept, B, H, Hkv, D, dtype_name, elem)


def decode_bound(pos, Smax, H, Hkv, D, window, dtype_name, elem):
    return _cost().decode_bound(list(pos), Smax, H, Hkv, D, window, dtype_name, elem)


def mla_bound(offs, T, Smax, dtype_name, elem, H=MLA_DECODE["H"]):
    """The absorbed-MLA attention of T causal rows per slot at ``offs``
    (T = 1: the decode step, kv_len = offs + 1) for H heads on the latent
    head: each latent row that some row keeps (those of the last row) read
    once, its first 512 columns being the values, q and o once; 2·H·(Dk +
    Dv) FLOPs per kept (row, key) pair."""
    Hkv, Dk, Dv = (MLA_DECODE[x] for x in ("Hkv", "Dk", "Dv"))
    return _cost().mla_bound(list(offs), T, Smax, dtype_name, elem, H=H, Hkv=Hkv, Dk=Dk, Dv=Dv)


def verify_offsets(Smax, T):
    """Per-row q_offset of a speculative verify over 8 slots: 0, 63, 64,
    500, Smax - T (the last position that fits) and Smax - 2 (q_offset + T
    past the cache), and two more inside it."""
    return [0, 63, 64, 500, Smax - T, Smax - 2, 127, Smax // 2 + 1]


def verify_bound(offs, T, Smax, H, Hkv, D, window, dtype_name, elem):
    """Flash at a verify's shape: the (query, key) pairs the causal mask
    keeps; q and o once, and K and V of the keys some query of the row
    keeps (the rest of the cache is never needed)."""
    return _cost().verify_bound(list(offs), T, Smax, H, Hkv, D, window, dtype_name, elem)


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


def ssd_bound(B, S, dtype_name, elem, H=MAMBA["H"]):
    """Operations: per (row, chunk) C.B^T over the causal lower triangle
    once (B and C are shared by all heads), per head the masked decay
    matrix times x, C.h and the state update. Bytes: x, dA, dt, B, C read
    once, y and the fp32 final state written once. H heads (mamba2's 80, or
    a model rank's 40)."""
    return _cost().ssd_bound(B, S, dtype_name, elem, H=H, P=MAMBA["P"], N=MAMBA["N"],
                             chunk=MAMBA["chunk"])


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
    errs = {"flash_attention": {}, "decode_attention": {}, "ssd_scan": {}, "mla_attention": {},
            "decode_attention_piece": {}, "mla_attention_piece": {}}
    verify_errs, kimi_errs, rank_errs, piece_errs = {}, {}, {}, {}
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
        for H in (MLA_DECODE["H"],) + MLA_RANK_G:
            if not mla_rows_match_decode_steps(torch, gen, mmod, dtype, H=H):
                misses.append(f"mla_attention {dtype} G={H}: a verify row differs from the "
                              "decode step at its position")
        for kernel, case, out, ref in mesh_rank_cases(torch, gen, fmod, dmod, mmod, smod, dtype):
            if kernel == "ssd_scan":  # (y, final state), the state fp32 in both dtypes
                compare(kernel, f"{case} {dtype} y", dtype, out[0], ref[0], SSD_TOL)
                compare(kernel, f"{case} {dtype} state", torch.float32, out[1], ref[1], SSD_TOL)
                continue
            compare(kernel, f"{case} {dtype}", dtype, out, ref)
            if kernel == "mla_attention":
                key = f"{case.split(' T=')[0]} {str(dtype).split('.')[-1]}"
                rank_errs[key] = max(rank_errs.get(key, 0.0),
                                     float((out.float() - ref.float()).abs().max()))
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
        for case, out, ref in piece_cases(torch, gen, dmod, dtype):
            # a piece's o and lse are fp32 on both sides, from the same
            # inputs: fp32's tolerance whatever the inputs' dtype; the merged
            # halves, cast once, against the whole-cache kernel at the dtype's
            compare("decode_attention_piece", f"{case} {dtype}", dtype, out, ref,
                    TOL if case.endswith("merged vs whole") else PIECE_TOL)
        for case, out, ref in mla_piece_cases(torch, gen, mmod, dtype):
            # as the decode kernel's piece mode: fp32 o and lse against the
            # plain version at fp32's tolerance; the merged pieces against
            # the whole-cache MLA kernel at the dtype's
            compare("mla_attention_piece", f"{case} {dtype}", dtype, out, ref,
                    TOL if case.endswith("merged vs whole") else PIECE_TOL)
            if not case.endswith("merged vs whole"):
                key = f"{case.rsplit(' ', 1)[-1]} {str(dtype).split('.')[-1]}"  # o or lse
                piece_errs[key] = max(piece_errs.get(key, 0.0),
                                      float((out.float() - ref.float()).abs().max()))
        for case, (y, h), (ry, rh) in ssd_edge_cases(torch, gen, smod, dtype):
            compare("ssd_scan", f"{case} {dtype} y", dtype, y, ry, SSD_TOL)
            compare("ssd_scan", f"{case} {dtype} state", torch.float32, h, rh, SSD_TOL)
        for kernel, case, out, ref in kimi_cases(torch, gen, fmod, dmod, dtype):
            compare(kernel, f"{case} {dtype}", dtype, out, ref)
            key = f"{kernel} {str(dtype).split('.')[-1]}"
            for cols, part in (("0-63", slice(0, 64)), ("64-111", slice(64, 112))):
                e = float((out[..., part].float() - ref[..., part].float()).abs().max())
                kimi_errs[f"{key} cols {cols}"] = max(kimi_errs.get(f"{key} cols {cols}", 0.0), e)
    torch.cuda.synchronize()
    report["errors"] = errs
    log("kernel vs plain, max abs err:", json.dumps(errs))
    log("kimi-k2 head dim 112, max abs err by output columns:", json.dumps(kimi_errs))
    log("flash at verify shapes, max abs err:", json.dumps(verify_errs))
    log(f"MLA at a model rank's heads (G = {', '.join(map(str, MLA_RANK_G))}), max abs err:",
        json.dumps(rank_errs))
    log("MLA piece mode (G = 16) vs its plain version, o and lse, max abs err:",
        json.dumps(piece_errs))
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


def kimi_cases(torch, gen, fmod, dmod, dtype):
    """(kernel, case, kernel output, plain output) at kimi-k2's head dim 112,
    for its 64 on 8 heads and for one rank's 32 on 4 at a model axis of 2:
    flash causal at the serve's prefill (B 8, S 512) and at the tile edges
    (S 1, 17, 100), flash at the verify's 8 slots x T 5 against a 1024-entry
    cache (``verify_offsets``); decode (G = 8) at 8 slots x 2048 with
    per-row kv_len (DECODE_POS), at 4 slots x 64 (one split), with a free
    slot parked at Smax, and with a slot that keeps no key (kv_len 0)."""
    for name, hd in (("kimi", KIMI), ("kimi rank", KIMI_RANK)):
        H, Hkv, D = hd["H"], hd["Hkv"], hd["D"]

        def flash(case, B, Sq, Sk, **kw):
            q, k, v = qkv(torch, gen, B, Sq, Sk, H, Hkv, D, dtype)
            return ("flash_attention", f"{name} {case}", fmod.flash_attention(q, k, v, **kw),
                    fmod.flash_attention_plain(q, k, v, **kw))

        def decode(case, pos_list, Smax, kv_len=None):
            B = len(pos_list)
            pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
            kl = pos + 1 if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                             device="cuda")
            q, _, _ = qkv(torch, gen, B, 1, 1, H, Hkv, D, dtype)
            _, k, v = qkv(torch, gen, B, 1, Smax, H, Hkv, D, dtype)
            kw = dict(q_offset=pos, kv_len=kl)
            return ("decode_attention", f"{name} {case} Smax={Smax} pos={pos_list}",
                    dmod.decode_attention(q, k, v, **kw), dmod.decode_attention_plain(q, k, v, **kw))

        yield flash("prefill B=8 S=512", 8, 512, 512, causal=True)
        for S in (1, 17, 100):
            yield flash(f"prefill B=2 S={S}", 2, S, S, causal=True)
        offs = torch.tensor(verify_offsets(1024, 5), dtype=torch.int32, device="cuda")
        yield flash("verify 8 slots T=5", 8, 5, 1024, causal=True, q_offset=offs)
        yield decode("8 slots", list(DECODE_POS), 2048)
        yield decode("4 slots, one split", [0, 17, 40, 63], 64)
        yield decode("4 slots, a free slot parked", [0, 17, 63, 64], 64)
        yield decode("4 slots, kv_len 0", [0, 17, 40, 63], 64, kv_len=[0, 18, 41, 64])


def mla_inputs(torch, gen, B, T, Smax, dtype, shared=True, H=MLA_DECODE["H"]):
    """q (B,T,H,576) (16 heads, or a model rank's 8 or 4) and a latent
    cache (B,Smax,1,576) whose first 512 columns are the values, as
    ``models.attention.mla_decode`` passes them, or values of their own
    (``shared=False``)."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    Hkv, Dk, Dv = (MLA_DECODE[x] for x in ("Hkv", "Dk", "Dv"))
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


def mla_rows_match_decode_steps(torch, gen, mmod, dtype, H=MLA_DECODE["H"]):
    """Whether T = 5 verify rows at VERIFY_POS equal, bit for bit, five
    decode steps at those positions on the same q rows (the kernel's rows
    reduce alike whatever T is), at H heads on the latent head."""
    q, k, v = mla_inputs(torch, gen, len(VERIFY_POS), 5, 1024, dtype, H=H)
    offs = torch.tensor(VERIFY_POS, dtype=torch.int32, device="cuda")
    ver = mmod.mla_attention(q, k, v, causal=True, q_offset=offs, scale=MLA_SCALE)
    for t in range(q.shape[1]):
        p = offs + t
        dec = mmod.mla_attention(q[:, t:t + 1].contiguous(), k, v, causal=False, q_offset=p,
                                 kv_len=p + 1, scale=MLA_SCALE)
        if not torch.equal(dec[:, 0], ver[:, t]):
            return False
    return True


# a model rank's heads at a model axis of 2 (the mesh_families phase): the
# MLA kernels at G = 8 (and 4, a model axis of 4), deepseek's naive-form
# prefill on 8 of 16 heads, seamless's 8 on 8 and jamba's 16 on 4 heads,
# and 40 of mamba2's 80 SSD heads
MLA_RANK_G = (8, 4, 2, 1)  # a rank's MLA heads at a model axis of 2, 4, 8, 16
MLA_PREFILL_RANK = dict(H=8, Hkv=8, Dk=192, Dv=128)
SEAMLESS_RANK = dict(H=8, Hkv=8, D=64)
JAMBA_RANK = dict(H=16, Hkv=4, D=128)
MAMBA_RANK_H = 40
# one rank's attention at a model axis of 8 (the mesh_wide phase): each kv
# head whole on 2 ranks, 4 query heads on it (qwen2: 3 of 7, or 4, real)
WIDE_RANK = {"tinyllama-1.1b": dict(H=4, Hkv=1, D=64, softcap=None),
             "gemma2-2b": dict(H=1, Hkv=1, D=256, softcap=50.0),
             "qwen2-7b": dict(H=4, Hkv=1, D=128, softcap=None)}


def mesh_rank_cases(torch, gen, fmod, dmod, mmod, smod, dtype):
    """(kernel, case, kernel output, plain output) at one rank's shapes of
    the mesh_families phase: the MLA attention at G = 8, 4, 2 and 1, 8 slots x
    1024, the decode step (T = 1 at DECODE_POS clipped, a slot parked at
    Smax) and the verify (T = 5, causal at VERIFY_POS); flash at deepseek's
    naive-form prefill on 8 heads, seamless's encoder and cross prefill on
    8 heads (no causal mask) and jamba's 16 on 4 heads; decode at
    seamless's 8 heads with per-slot kv_len down to 0 and at jamba's 16 on
    4; the SSD scan on 40 heads at dt ~0.02 and ~0.7; and a rank's heads of
    the mesh_wide phase (``WIDE_RANK``): flash causal at B 2 S 256 (gemma2
    1 on 1 at D 256 with its softcap, with and without a window of 64),
    decode at 8 slots x 1024 (DECODE_POS clipped; gemma2 also with a window
    of 256)."""
    Smax, B = 1024, len(DECODE_POS)
    for arch, hd in WIDE_RANK.items():
        gemma = hd["softcap"] is not None
        for window in ((None, 64) if gemma else (None,)):
            q, k, v = qkv(torch, gen, 2, 256, 256, hd["H"], hd["Hkv"], hd["D"], dtype)
            kw = dict(causal=True, window=window, softcap=hd["softcap"])
            yield ("flash_attention", f"{arch} rank {hd['H']} on 1 B=2 S=256 w={window}",
                   fmod.flash_attention(q, k, v, **kw), fmod.flash_attention_plain(q, k, v, **kw))
        pos = torch.tensor([min(p, Smax - 1) for p in DECODE_POS], dtype=torch.int32,
                           device="cuda")
        for window in ((None, 256) if gemma else (None,)):
            q, _, _ = qkv(torch, gen, B, 1, 1, hd["H"], hd["Hkv"], hd["D"], dtype)
            _, k, v = qkv(torch, gen, B, 1, Smax, hd["H"], hd["Hkv"], hd["D"], dtype)
            kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=hd["softcap"])
            yield ("decode_attention", f"{arch} rank G={hd['H']} Smax={Smax} w={window}",
                   dmod.decode_attention(q, k, v, **kw), dmod.decode_attention_plain(q, k, v, **kw))
    for G in MLA_RANK_G:
        for T in (1, 5):
            q, k, v = mla_inputs(torch, gen, B, T, Smax, dtype, H=G)
            if T == 1:
                pos_list = [min(p, Smax - 1) for p in DECODE_POS]
                pos_list[-1] = Smax
                pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
                kw = dict(causal=False, q_offset=pos, kv_len=pos + 1)
            else:
                kw = dict(causal=True, q_offset=torch.tensor(VERIFY_POS, dtype=torch.int32,
                                                             device="cuda"))
            kw["scale"] = MLA_SCALE
            yield ("mla_attention", f"MLA G={G} T={T} Smax={Smax}", mmod.mla_attention(q, k, v, **kw),
                   mmod.mla_attention_plain(q, k, v, **kw))
    hd = MLA_PREFILL_RANK
    q, k, _ = qkv(torch, gen, 2, 256, 256, hd["H"], hd["Hkv"], hd["Dk"], dtype)
    v = qkv(torch, gen, 2, 1, 256, 1, hd["Hkv"], hd["Dv"], dtype)[2]
    kw = dict(causal=True, scale=MLA_SCALE)
    yield ("flash_attention", "MLA prefill rank 8 heads B=2 S=256",
           fmod.flash_attention(q, k, v, **kw), fmod.flash_attention_plain(q, k, v, **kw))
    sm = SEAMLESS_RANK
    for Sq, Sk in ((100, 100), (16, 300)):
        q, k, v = qkv(torch, gen, 2, Sq, Sk, sm["H"], sm["Hkv"], sm["D"], dtype)
        yield ("flash_attention", f"seamless rank Sq={Sq} Sk={Sk}",
               fmod.flash_attention(q, k, v, causal=False),
               fmod.flash_attention_plain(q, k, v, causal=False))
    kl = torch.tensor(ENC_KV_LEN, dtype=torch.int32, device="cuda")
    q, _, _ = qkv(torch, gen, len(ENC_KV_LEN), 1, 1, sm["H"], sm["Hkv"], sm["D"], dtype)
    _, k, v = qkv(torch, gen, len(ENC_KV_LEN), 1, 512, sm["H"], sm["Hkv"], sm["D"], dtype)
    yield ("decode_attention", "seamless rank cross per-row kv_len",
           dmod.decode_attention(q, k, v, q_offset=0, kv_len=kl),
           dmod.decode_attention_plain(q, k, v, q_offset=0, kv_len=kl))
    jb = JAMBA_RANK
    q, k, v = qkv(torch, gen, 2, 200, 200, jb["H"], jb["Hkv"], jb["D"], dtype)
    yield ("flash_attention", "jamba rank 16 on 4 B=2 S=200",
           fmod.flash_attention(q, k, v, causal=True), fmod.flash_attention_plain(q, k, v))
    pos = torch.tensor([min(p, Smax - 1) for p in DECODE_POS], dtype=torch.int32, device="cuda")
    q, _, _ = qkv(torch, gen, B, 1, 1, jb["H"], jb["Hkv"], jb["D"], dtype)
    _, k, v = qkv(torch, gen, B, 1, Smax, jb["H"], jb["Hkv"], jb["D"], dtype)
    kw = dict(q_offset=pos, kv_len=pos + 1)
    yield ("decode_attention", "jamba rank 16 on 4", dmod.decode_attention(q, k, v, **kw),
           dmod.decode_attention_plain(q, k, v, **kw))
    for shift in (-4.0, 0.0):
        args = ssd_inputs(torch, gen, 2, 256, dtype, H=MAMBA_RANK_H, dt_shift=shift)
        yield ("ssd_scan", f"SSD rank 40 heads B=2 S=256 dt_shift={shift}",
               smod.ssd_scan(*args, chunk=MAMBA["chunk"]),
               smod.ssd_scan_plain(*args, chunk=MAMBA["chunk"]))


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


def piece_inputs(torch, gen, hd, pos_list, Smax, D, dtype):
    """q and a (B, Smax) cache at ``hd``'s heads, cut on its sequence in D
    pieces of ceil(Smax / D) (the last zero-padded), with per-row positions
    ``pos_list``: (q, k, v, [(k_start, k piece, v piece)], pos)."""
    B = len(pos_list)
    q, _, _ = qkv(torch, gen, B, 1, 1, hd["H"], hd["Hkv"], hd["D"], dtype)
    _, k, v = qkv(torch, gen, B, 1, Smax, hd["H"], hd["Hkv"], hd["D"], dtype)
    n = -(-Smax // D)
    pieces = []
    for d in range(D):
        m = min(n, Smax - d * n)
        kp = torch.zeros((B, n) + tuple(k.shape[2:]), dtype=dtype, device="cuda")
        vp = torch.zeros_like(kp)
        kp[:, :m], vp[:, :m] = k[:, d * n:d * n + m], v[:, d * n:d * n + m]
        pieces.append((d * n, kp, vp))
    return q, k, v, pieces, torch.tensor(pos_list, dtype=torch.int32, device="cuda")


def piece_cases(torch, gen, dmod, dtype):
    """(case, kernel output, plain output) of the decode kernel's piece mode
    (o, then lse, each fp32) at the serve_mesh phase's shapes, every piece
    of a cache cut in D = 2: tinyllama's and gemma2's heads (softcap 50, and
    a window of 256 that crosses the halves' boundary from rows at 1023 and
    beyond) and qwen2's padded kv group (QWEN2_GROUP: G = 8 at D 128, what
    a rank of the mesh_wide phase gathers), 8 rows at DECODE_POS over 2048; the odd bucket's 3 rows of
    tinyllama over 1024 (PIECE_ODD; the second half keeps no key), at
    per-row and at one shared position; then the merged halves
    (``collectives.merge_states``, cast once) against the whole-cache
    kernel."""
    from repro_torch.sharding.collectives import merge_states
    shapes = [("tinyllama", TINY, DECODE_POS, 2048, None), ("gemma2", GEMMA, DECODE_POS, 2048, None),
              ("gemma2", GEMMA, DECODE_POS, 2048, 256),
              ("qwen2 padded group", QWEN2_GROUP, DECODE_POS, 2048, None),
              ("odd bucket tinyllama", TINY, PIECE_ODD["pos"], PIECE_ODD["Smax"], None),
              ("odd bucket tinyllama shared", TINY, (PIECE_ODD["pos"][-1],) * 3, PIECE_ODD["Smax"],
               None)]
    for name, hd, pos_list, Smax, window in shapes:
        q, k, v, pieces, pos = piece_inputs(torch, gen, hd, list(pos_list), Smax, 2, dtype)
        kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=hd["softcap"])
        states = []
        for d, (start, kp, vp) in enumerate(pieces):
            o, lse = dmod.decode_attention_piece(q, kp, vp, k_start=start, **kw)
            po, plse = dmod.decode_attention_piece_plain(q, kp, vp, k_start=start, **kw)
            case = f"{name} Smax={Smax} w={window} half {d}"
            yield f"{case} o", o, po
            yield f"{case} lse", lse, plse
            states.append(torch.cat([o, lse[..., None]], dim=-1))
        yield (f"{name} Smax={Smax} w={window} merged vs whole",
               merge_states(torch.stack(states))[0].to(dtype), dmod.decode_attention(q, k, v, **kw))


def mla_piece_inputs(torch, gen, T, pos_list, Smax, P, dtype):
    """q (B,T,16,576) and a latent (B,Smax,1,576) (``mla_inputs``), the
    latent cut on its sequence in P pieces of ceil(Smax / P) rows (the last
    zero-padded): (q, k, v, [(k_start, piece)], pos), the values the first
    512 columns of the whole latent and of each piece."""
    B = len(pos_list)
    q, k, v = mla_inputs(torch, gen, B, T, Smax, dtype)
    n = -(-Smax // P)
    pieces = []
    for p in range(P):
        m = max(0, min(n, Smax - p * n))
        kp = torch.zeros((B, n) + tuple(k.shape[2:]), dtype=dtype, device="cuda")
        kp[:, :m] = k[:, p * n:p * n + m]
        pieces.append((p * n, kp))
    return q, k, v, pieces, torch.tensor(pos_list, dtype=torch.int32, device="cuda")


def mla_piece_cases(torch, gen, mmod, dtype):
    """(case, kernel output, plain output) of the MLA kernels' piece mode at
    G = 16 (o, then lse, each fp32): 8 rows over a latent of 1024 rows cut
    in MLA_PIECES pieces, the decode step (T = 1 at DECODE_POS clipped to
    the cache, the last slot parked at 1024, kv_len = position + 1 at most
    the cache) and a T = 5 verify (causal at ``verify_offsets``, rows past
    the cache included, kv_len the cache), where rows 0-3 keep no key of the
    later pieces; then every row at positions below the first of 8 pieces,
    so that the other 7 keep no key of any row (o 0, lse -1e30); each set of
    pieces merged (``collectives.merge_states``, cast once) against the
    whole-cache MLA kernel."""
    from repro_torch.sharding.collectives import merge_states
    Smax, B = 1024, len(DECODE_POS)
    decode = [min(p, Smax - 1) for p in DECODE_POS[:-1]] + [Smax]
    early = (0, 5, 17, 63, 64, 100, 126, 127)
    cases = [(f"decode P={P}", 1, decode, P) for P in MLA_PIECES] + [
        (f"verify T=5 P={P}", 5, verify_offsets(Smax, 5), P) for P in MLA_PIECES] + [
        ("decode empty pieces P=8", 1, early, 8)]
    for name, T, pos_list, P in cases:
        q, k, v, pieces, pos = mla_piece_inputs(torch, gen, T, pos_list, Smax, P, dtype)
        if T == 1:
            kw = dict(causal=False, q_offset=pos, kv_len=torch.clamp(pos + 1, max=Smax))
        else:
            kw = dict(causal=True, q_offset=pos, kv_len=Smax)
        kw["scale"] = MLA_SCALE
        states = []
        for i, (start, kp) in enumerate(pieces):
            vp = kp[..., :MLA_DECODE["Dv"]]
            o, lse = mmod.mla_attention_piece(q, kp, vp, k_start=start, **kw)
            po, plse = mmod.mla_attention_piece_plain(q, kp, vp, k_start=start, **kw)
            yield f"MLA piece {name} piece {i} o", o, po
            yield f"MLA piece {name} piece {i} lse", lse, plse
            states.append(torch.cat([o, lse[..., None]], dim=-1))
        yield (f"MLA piece {name} merged vs whole",
               merge_states(torch.stack(states))[0].to(dtype), mmod.mla_attention(q, k, v, **kw))


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
    rows += kimi_times(torch, gen, flush, sdpa, report.get("launches_kimi", {}))
    rows += mesh_rank_times(torch, gen, flush, sdpa, report.get("mesh_families", {}),
                            report.get("mesh_wide", {}))
    rows += wide_rank_times(torch, gen, flush, sdpa, report.get("mesh_wide", {}))
    rows += piece_times(torch, gen, flush,
                        report.get("launches_serve_mesh", {}).get("decode_attention_piece"))
    rows += mla_piece_times(torch, gen, flush,
                            report.get("launches_mesh_wide", {}).get("mla_attention_piece"))
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
PARITY_CUTS = {KIMI_ARCH: dict(num_layers=1),
               "seamless-m4t-medium": dict(num_layers=2, num_encoder_layers=2),
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


def piece_times(torch, gen, flush, served):
    """The decode kernel's piece mode at the serve_mesh phase's shapes
    (``piece_cases``), bf16, each half of a cache cut in 2: its device time,
    its plain version's, and its bound (the K / V entries that the piece's
    rows keep, q, and the fp32 o and lse, once each). No PyTorch call takes
    this shape: ``_scaled_dot_product_efficient_attention`` (which returns
    the log-sum-exp) needs as many kv heads as query heads, so
    ``library_ms`` is None and ``library_ms_repeated_kv`` times it on K / V
    repeated to the query heads (8x their bytes, made before the timing),
    beside a float mask of the kept keys; none with gemma2's softcap.
    ``served``: the piece launches of the serve_mesh phase's odd bucket
    (on the odd bucket's rows)."""
    from repro_torch.kernels import decode_attention as dmod
    bf16, rows = torch.bfloat16, []
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    shapes = [("tinyllama", TINY, DECODE_POS, 2048), ("gemma2", GEMMA, DECODE_POS, 2048),
              ("tinyllama odd bucket", TINY, PIECE_ODD["pos"], PIECE_ODD["Smax"])]
    for name, hd, pos_list, Smax in shapes:
        q, _, _, pieces, pos = piece_inputs(torch, gen, hd, list(pos_list), Smax, 2, bf16)
        kw = dict(q_offset=pos, kv_len=pos + 1, softcap=hd["softcap"])
        G = hd["H"] // hd["Hkv"]
        for half, (start, kp, vp) in enumerate(pieces):
            n, B = kp.shape[1], len(pos_list)
            kept = sum(max(0, min(p + 1, start + n) - start) for p in pos_list)
            nbytes = 2 * (kept * hd["Hkv"] * 2 * hd["D"] + B * hd["H"] * hd["D"]) + \
                4 * B * hd["H"] * (hd["D"] + 1)
            b_ms, b_by = bound(4 * hd["H"] * hd["D"] * kept, nbytes, "bfloat16")
            lib_rep = None
            if not hd["softcap"]:
                qt = q.transpose(1, 2)
                kr = kp.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
                vr = vp.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
                keep = (start + torch.arange(n, device="cuda"))[None, :] <= pos[:, None]
                bias = torch.zeros((B, hd["H"], 1, n), dtype=bf16, device="cuda")
                bias.masked_fill_(~keep[:, None, None], float("-inf"))
                lib_rep = time_ms(torch, lambda: eff(qt, kr, vr, bias, True, 0.0, False), flush)
            row = dict(kernel="decode_attention_piece", model=name.split(" ")[0], B=B, S=Smax,
                       half=half, kept_keys=kept, dtype="bfloat16",
                       ms=time_ms(torch, lambda: dmod.decode_attention_piece(
                           q, kp, vp, k_start=start, **kw), flush),
                       plain_ms=time_ms(torch, lambda: dmod.decode_attention_piece_plain(
                           q, kp, vp, k_start=start, **kw), flush),
                       library_ms=None, library_ms_repeated_kv=lib_rep, bound_ms=b_ms,
                       bound_by=b_by, launches_per_serve=served if "odd" in name else None)
            if half or "odd" in name:
                row["shape"] = f"{'odd bucket ' if 'odd' in name else ''}half {half}"
            rows.append(row)
    return rows


def mla_piece_times(torch, gen, flush, served):
    """The MLA kernels' piece mode, bf16, G = 16, the decode step of 8 rows
    at DECODE_POS (clipped, the last parked) over the first piece of a
    1024-row latent cut in 8 (128 rows, mesh_wide's model axis of 8) and
    in 2 (512 rows): its device time, its plain version's, and its bound
    (``kernels.cost.mla_piece_bound``: the latent rows the piece's rows
    keep, q, and the fp32 o and lse, once each). ``library_ms`` is None: no
    PyTorch call returns the log-sum-exp of 16 query heads on one 576-wide
    latent head whose values are its first 512 columns (the efficient
    attention that returns it needs as many kv heads as query heads and one
    head dim for q, k and v). ``served``: the piece launches of rank 0's
    bf16 arms of the mesh_wide phase."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import mla_attention as mmod
    bf16, rows, Smax = torch.bfloat16, [], 1024
    pos_list = [min(p, Smax - 1) for p in DECODE_POS[:-1]] + [Smax]
    for P in sorted(MLA_PIECES, reverse=True):
        q, _, _, pieces, pos = mla_piece_inputs(torch, gen, 1, pos_list, Smax, P, bf16)
        start, kp = pieces[0]
        vp = kp[..., :MLA_DECODE["Dv"]]
        kw = dict(k_start=start, causal=False, q_offset=pos, kv_len=torch.clamp(pos + 1, max=Smax),
                  scale=MLA_SCALE)
        kept = sum(max(0, min(p + 1, start + kp.shape[1], Smax) - start) for p in pos_list)
        b_ms, b_by = cost.mla_piece_bound(pos_list, 1, kp.shape[1], start, "bfloat16", 2,
                                          MLA_DECODE["H"])
        row = dict(kernel="mla_attention_piece", model="mla", B=len(pos_list), S=Smax,
                   pieces=P, piece_rows=kp.shape[1], kept_rows=kept, dtype="bfloat16",
                   ms=time_ms(torch, lambda: mmod.mla_attention_piece(q, kp, vp, **kw), flush),
                   plain_ms=time_ms(torch, lambda: mmod.mla_attention_piece_plain(q, kp, vp, **kw),
                                    flush),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   call_ms=call_ms(torch, lambda: mmod.mla_attention_piece(q, kp, vp, **kw)),
                   launches_per_serve=served)
        if P != 8:
            row["shape"] = f"1024 / {P}"
        rows.append(row)
    return rows


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


def kimi_times(torch, gen, flush, sdpa, launches):
    """kimi-k2's kernel shapes at head dim 112, bf16, for its 64 on 8 heads
    and one rank's 32 on 4: flash at the serve's prefill (B 8, S 512) and
    at the verify's 8 slots x T 5 (VERIFY_POS, a 1024-entry cache), decode
    at 8 slots x 2048 (DECODE_POS); each beside its plain version, its
    bound and SDPA (a bool mask for the verify and the decode), with the
    kernel's launches in the kimi phase's serve (``launches``)."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    bf16, rows = torch.bfloat16, []
    for name, hd in (("kimi", KIMI), ("kimi rank", KIMI_RANK)):
        H, Hkv, D = hd["H"], hd["Hkv"], hd["D"]
        per_serve = {k: launches.get(k) for k in ("flash_attention", "decode_attention")}
        if name != "kimi":  # a rank's launches are counted in the shard2 phase
            per_serve = {}
        B, S = 8, 512
        q, k, v = qkv(torch, gen, B, S, S, H, Hkv, D, bf16)
        rows.append(time_row(
            torch, flush, "flash_attention", name, B, S,
            lambda: fmod.flash_attention(q, k, v, causal=True),
            lambda: fmod.flash_attention_plain(q, k, v, causal=True),
            lambda: sdpa(q, k, v, is_causal=True),
            flash_bound(B, S, H, Hkv, D, None, "bfloat16", 2), shape="prefill",
            launches_per_serve=per_serve.get("flash_attention")))
        T, Smax = 5, 1024
        pos = torch.tensor(VERIFY_POS, dtype=torch.int32, device="cuda")
        q, _, _ = qkv(torch, gen, len(VERIFY_POS), T, 1, H, Hkv, D, bf16)
        _, k, v = qkv(torch, gen, len(VERIFY_POS), 1, Smax, H, Hkv, D, bf16)
        qpos = pos[:, None] + torch.arange(T, device="cuda")
        mask = (torch.arange(Smax, device="cuda") <= qpos[..., None])[:, None]
        kw = dict(causal=True, q_offset=pos)
        rows.append(time_row(
            torch, flush, "flash_attention", name, len(VERIFY_POS), Smax,
            lambda: fmod.flash_attention(q, k, v, **kw),
            lambda: fmod.flash_attention_plain(q, k, v, **kw),
            lambda: sdpa(q, k, v, attn_mask=mask),
            verify_bound(VERIFY_POS, T, Smax, H, Hkv, D, None, "bfloat16", 2), T=T,
            shape="verify"))
        Smax = 2048
        pos_list = list(DECODE_POS)
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        q, _, _ = qkv(torch, gen, len(pos_list), 1, 1, H, Hkv, D, bf16)
        _, k, v = qkv(torch, gen, len(pos_list), 1, Smax, H, Hkv, D, bf16)
        mask = (torch.arange(Smax, device="cuda")[None, :] <= pos[:, None])[:, None, None]
        kw = dict(q_offset=pos, kv_len=pos + 1)
        rows.append(time_row(
            torch, flush, "decode_attention", name, len(pos_list), Smax,
            lambda: dmod.decode_attention(q, k, v, **kw),
            lambda: dmod.decode_attention_plain(q, k, v, **kw),
            lambda: sdpa(q, k, v, attn_mask=mask),
            decode_bound(pos_list, Smax, H, Hkv, D, None, "bfloat16", 2), shape="decode",
            launches_per_serve=per_serve.get("decode_attention")))
    return rows


def wide_rank_times(torch, gen, flush, sdpa, wide):
    """A model rank's attention at a model axis of 8 (``WIDE_RANK``), bf16:
    flash causal at B 8 S 512 and decode at 8 slots x 2048 (DECODE_POS),
    each beside SDPA (none with gemma2's softcap) and its bound, with the
    launches per serve on rank 0 of the mesh_wide phase of the same run
    (``wide``)."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    bf16, rows = torch.bfloat16, []
    for arch, hd in WIDE_RANK.items():
        arm = wide.get(f"{arch} bfloat16")
        served = None if arm is None else arm["ranks"]["launches"]
        B, S = 8, 512
        q, k, v = qkv(torch, gen, B, S, S, hd["H"], hd["Hkv"], hd["D"], bf16)
        kw = dict(causal=True, softcap=hd["softcap"])
        lib = None if hd["softcap"] else time_ms(torch, lambda: sdpa(q, k, v, is_causal=True),
                                                 flush)
        b_ms, b_by = flash_bound(B, S, hd["H"], hd["Hkv"], hd["D"], None, "bfloat16", 2)
        rows.append(dict(kernel="flash_attention", model=f"{arch} rank (M 8)", B=B, S=S,
                         dtype="bfloat16", heads=f"{hd['H']} on 1",
                         ms=time_ms(torch, lambda: fmod.flash_attention(q, k, v, **kw), flush),
                         plain_ms=time_ms(torch, lambda: fmod.flash_attention_plain(q, k, v, **kw),
                                          flush),
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                         launches_per_serve=None if served is None else served["flash_attention"]))
        Smax = 2048
        pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
        q, _, _ = qkv(torch, gen, len(DECODE_POS), 1, 1, hd["H"], hd["Hkv"], hd["D"], bf16)
        _, k, v = qkv(torch, gen, len(DECODE_POS), 1, Smax, hd["H"], hd["Hkv"], hd["D"], bf16)
        kw = dict(q_offset=pos, kv_len=pos + 1, softcap=hd["softcap"])
        mask = (torch.arange(Smax, device="cuda")[None, :] <= pos[:, None])[:, None, None]
        lib = None if hd["softcap"] else time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask),
                                                 flush)
        b_ms, b_by = decode_bound(list(DECODE_POS), Smax, hd["H"], hd["Hkv"], hd["D"], None,
                                  "bfloat16", 2)
        rows.append(dict(kernel="decode_attention", model=f"{arch} rank (M 8)",
                         B=len(DECODE_POS), S=Smax, dtype="bfloat16", G=hd["H"],
                         ms=time_ms(torch, lambda: dmod.decode_attention(q, k, v, **kw), flush),
                         plain_ms=time_ms(torch, lambda: dmod.decode_attention_plain(q, k, v, **kw),
                                          flush),
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                         launches_per_serve=None if served is None else served["decode_attention"]))
    return rows


def mesh_rank_times(torch, gen, flush, sdpa, families, wide):
    """A model rank's kernel shapes at a model axis of 2 (4 for MLA's G =
    4, 8 for G = 2, 16 for G = 1), bf16: the MLA attention at G = 8, 4, 2
    and 1 heads on the latent head, 8
    slots x 1024 at T = 1 (DECODE_POS clipped) and T = 5 (VERIFY_POS,
    causal), beside SDPA with a bool mask; the SSD scan on 40 heads at B 8
    S 512 (no single PyTorch call computes it); each with its bound and,
    from the mesh_families and mesh_wide phases of the same run
    (``families``, ``wide``), its launches per serve on rank 0 (deepseek's
    for MLA at G = 8 and, at M = 8, G = 2; mamba2's for the SSD scan; G = 4
    and 1 are not on a served path)."""
    from repro_torch.kernels import mla_attention as mmod
    from repro_torch.kernels import ssd_scan as smod
    bf16, rows, Smax = torch.bfloat16, [], 1024

    def serve_launches(arch, kernel, phase=families):
        row = phase.get(f"{arch} bfloat16")
        return None if row is None else row["ranks"]["launches"][kernel]
    for G in MLA_RANK_G:
        for T, offs in ((1, [min(p, Smax - 1) for p in DECODE_POS]), (5, list(VERIFY_POS))):
            B = len(offs)
            qo = torch.tensor(offs, dtype=torch.int32, device="cuda")
            q, k, v = mla_inputs(torch, gen, B, T, Smax, bf16, H=G)
            qpos = qo[:, None] + torch.arange(T, device="cuda")
            mask = (torch.arange(Smax, device="cuda") <= qpos[..., None])[:, None]
            kw = (dict(causal=False, q_offset=qo, kv_len=qo + 1) if T == 1 else
                  dict(causal=True, q_offset=qo))
            kw["scale"] = MLA_SCALE
            rows.append(time_row(
                torch, flush, "mla_attention", f"mla rank G={G}", B, Smax,
                lambda: mmod.mla_attention(q, k, v, **kw),
                lambda: mmod.mla_attention_plain(q, k, v, **kw),
                lambda: sdpa(q, k, v, attn_mask=mask, scale=MLA_SCALE),
                mla_bound(offs, T, Smax, "bfloat16", 2, H=G), T=T, G=G,
                shape="decode" if T == 1 else "verify",
                launches_per_serve=(None if T > 1 or G not in (8, 2) else serve_launches(
                    "deepseek-v2-lite-16b", "mla_attention", families if G == 8 else wide))))
    B, S = 8, 512
    args = ssd_inputs(torch, gen, B, S, bf16, H=MAMBA_RANK_H)
    b_ms, b_by = ssd_bound(B, S, "bfloat16", 2, H=MAMBA_RANK_H)
    rows.append(dict(kernel="ssd_scan", model="mamba2 rank 40 heads", B=B, S=S, dtype="bfloat16",
                     ms=time_ms(torch, lambda: smod.ssd_scan(*args, chunk=MAMBA["chunk"]), flush),
                     plain_ms=time_ms(torch, lambda: smod.ssd_scan_plain(
                         *args, chunk=MAMBA["chunk"]), flush),
                     library_ms=None, bound_ms=b_ms, bound_by=b_by,
                     launches_per_serve=serve_launches("mamba2-2.7b", "ssd_scan")))
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
    model_parity(torch, report, KIMI_ARCH, "bfloat16")  # 72 GiB in fp32 at full width
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
    bf16_depth_attribution(torch, report)


# A.2-style attribution of bf16 at depth: full-width mamba2-2.7b (64
# layers), one (B, S) prefill through the bf16 kernels, the bf16 plain
# versions and the exact-fp32 route on the same (bf16-valued) weights
DEPTH = dict(arch="mamba2-2.7b", B=2, S=256, seed=0)


@contextlib.contextmanager
def layer_tap(feed=None):
    """Taps ``transformer.apply_layer`` while the block runs: yields the
    list of (input, output) of each call, in call order; with ``feed``, each
    call's input is replaced by ``feed[i]`` first (another run's inputs of
    the same layers, so each layer adds only its own rounding)."""
    from repro_torch.models import transformer as tfm
    apply_layer, taps = tfm.apply_layer, []

    def tap(lp, x, *a, **kw):
        if feed is not None:
            x = feed[len(taps)].to(x.device, x.dtype)
        y = apply_layer(lp, x, *a, **kw)
        taps.append((x, y[0]))
        return y

    tfm.apply_layer = tap
    try:
        yield taps
    finally:
        tfm.apply_layer = apply_layer


def row_dist(a, ref):
    """The largest |a - ref| over each row's largest |ref|, over all rows."""
    a, ref = a.float(), ref.float()
    return float(((a - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max())


def cast_up(params):
    """Every parameter of ``params`` cast to fp32 in place, leaf by leaf,
    so that the card never holds more than one leaf in both dtypes."""
    from repro_torch.models.model import set_param
    for name in [n for n, _ in params.named_parameters()]:
        set_param(params, name, params.get_parameter(name).float())


def layer_outputs(params, cfg, ids, ctx):
    """(each layer's output of a prefill of ``ids`` through ``ctx``'s
    route, fp32; the last position's logits, fp32)."""
    from repro_torch.models.model import prefill
    with layer_tap() as taps:
        logits = prefill(params, cfg, ids, None, ctx, last_only=True)[0]
    return [y.float() for _, y in taps], logits.float()


def bf16_depth_attribution(torch, report):
    """Per layer of full-width mamba2-2.7b, the largest distance of the
    bf16 kernels' and of the bf16 plain versions' output from the
    exact-fp32 route (each row's largest |difference| over its largest
    |fp32 value|), and of the last position's logits; the two bf16 routes
    differ only in the SSD scan (the bf16 kernel splits M and the carried
    state into bf16 hi and lo parts, the plain version keeps fp32)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.models.model import init_params
    from repro_torch.sharding.context import ExecContext
    k = DEPTH
    cfg = dataclasses.replace(get_config(k["arch"]), dtype="bfloat16", param_dtype="bfloat16")
    params = init_params(cfg, seed=k["seed"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(1, cfg.vocab_size, (k["B"], k["S"]), generator=gen, device="cuda")
    runs = {}
    with torch.no_grad():
        for route, impl in (("kernels", None), ("plain", "plain")):
            smod.ssd_scan.launches = 0
            runs[route] = layer_outputs(params, cfg, ids, ExecContext(attn_impl=impl))
            runs[route] += (smod.ssd_scan.launches,)
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        cast_up(params)
        params.cfg = cfg32
        with exact_fp32():
            ref, ref_logits = layer_outputs(params, cfg32, ids, ExecContext())
    out = {"card": report["smi"], "B": k["B"], "S": k["S"]}
    for route, (outs, logits, launches) in runs.items():
        out[route] = {"per_layer": [round(row_dist(a, f), 6) for a, f in zip(outs, ref)],
                      "logits": row_dist(logits, ref_logits), "ssd_launches": launches}
    per = zip(out["kernels"]["per_layer"], out["plain"]["per_layer"])
    out["kernels_over_plain_last"] = out["kernels"]["per_layer"][-1] / out["plain"]["per_layer"][-1]
    out["layers_kernels_farther"] = sum(a > b for a, b in per)
    report["bf16_depth"] = out
    log(f"bf16 at depth, {k['arch']} ({cfg.num_layers} layers, full width, B {k['B']} S "
        f"{k['S']}), each "
        f"layer's largest distance from the exact-fp32 route: {json.dumps(out)}")
    if (runs["kernels"][2], runs["plain"][2]) != (cfg.num_layers, 0) or not all(
            math.isfinite(x) for r in ("kernels", "plain") for x in out[r]["per_layer"]):
        raise SmokeFailure(f"bf16 depth attribution: SSD launches {runs['kernels'][2]} / "
                           f"{runs['plain'][2]} (expected {cfg.num_layers} / 0), or a distance "
                           "is not finite")
    del params, runs, ref


def kernel_wrappers():
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import mla_attention as mmod
    from repro_torch.kernels import ssd_scan as smod
    return {"flash_attention": fmod.flash_attention, "decode_attention": dmod.decode_attention,
            "ssd_scan": smod.ssd_scan, "mla_attention": mmod.mla_attention,
            "decode_attention_piece": dmod.decode_attention_piece,
            "mla_attention_piece": mmod.mla_attention_piece}


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
    step. Draft workers included; no piece mode (one card holds whole
    caches). Prompts and encoder inputs are longer than one position here
    (a single query row goes to the decode kernel)."""
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
                                 for w in mla),
            "decode_attention_piece": 0, "mla_attention_piece": 0}


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


def spec_engine(cfg, params, draft, calib_cfgs, max_slots, max_len, ctx=None):
    """One engine serving ``cfg`` (with ``draft`` or without), under the
    AdaOper scheduler calibrated on ``calib_cfgs`` (the target's and the
    draft's graphs for both arms, so both price the target alike) or FIFO
    when ``calib_cfgs`` is None; on ``ctx`` (no mesh by default)."""
    from repro_torch.launch.serve import make_scheduler
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.sharding.context import ExecContext
    sched = (None if calib_cfgs is None else
             make_scheduler(calib_cfgs, max(SPEC["prompt_lens"]), SPEC["max_new"], "moderate",
                            SPEC["seed"]))
    eng = ServingEngine(scheduler=sched, max_slots=max_slots)
    eng.add_model(cfg.name, cfg, params, max_len=max_len, draft=draft, ctx=ctx or ExecContext())
    return eng


def spec_run(torch, eng, reqs, trace, temperature):
    """Serve ``reqs`` on ``eng``: a ``run_trace`` with every arrival at t = 0
    or ``run_all``, with the kernels' launch counts set to 0 just before.
    Returns (responses, launches, wall s, peak device bytes)."""
    from repro_torch.serving.slots import Request
    name = next(iter(eng.workers))
    items = [Request(r[0], r[1], r[2], enc_inputs=r[3] if len(r) > 3 else None) for r in reqs]

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

    def __init__(self, torch, eng, name, prompts, temperature, frames=None):
        super().__init__()
        self.torch, self.eng, self.name = torch, eng, name
        self.prompts, self.temperature, self.frames = prompts, temperature, frames or {}

    def __missing__(self, key):
        uid, i = key
        if i != 0:
            return None, None
        lg, _ = self.eng.workers[self.name].prefill_one(self.prompts[uid], self.frames.get(uid))
        return decision_gaps(self.torch, lg, [self.eng._stream_key(self.name, uid)], [0],
                             self.temperature)[0]


@contextlib.contextmanager
def record_gaps(torch, eng, reqs, temperature, name=None, prefills=False, served=False):
    """Yields the ``Gaps`` of the engine's worker ``name`` (its first by
    default), recorded from its decode steps while the block runs and, with
    ``prefills``, the first tokens' from the serve's own prefill logits (an
    MoE that drops sizes its capacity by the prefill group, so a prefill of
    the prompt alone may decide otherwise); with ``served`` also from the
    speculative verify's rows (a row's position j decides the slot's token
    len(tokens) + j; a later round rewrites the positions past a rejected
    draft) and from the bucketed mode's ``generate`` steps (rows matched to
    uids by their prompts), so that every decision of a greedy serve in any
    mode is its own; the worker's own methods are back in place after it."""
    import numpy as np
    name = next(iter(eng.workers)) if name is None else name
    w = eng.workers[name]
    plain_pool, plain_group = w.decode_pool, w.group_tokens
    plain_verify, plain_generate = w.decode_verify, w.generate
    gaps = Gaps(torch, eng, name, {r[0]: r[1] for r in reqs}, temperature,
                {r[0]: r[3] for r in reqs if len(r) > 3})

    def record(seqs, rows):
        for s, g in zip(seqs, decision_gaps(torch, rows, [s.rng for s in seqs],
                                            [len(s.tokens) for s in seqs], temperature)):
            gaps[(s.req.uid, len(s.tokens))] = g

    def recorded(cache, tokens, pos, enc_len=None):
        nt, logits, cache = plain_pool(cache, tokens, pos, enc_len=enc_len)
        active = list(eng.pools[name].active.values())
        record(active, logits[[s.slot for s in active]])
        return nt, logits, cache

    def recorded_group(logits, slots, n_slots, pick):
        active = eng.pools[name].active
        record([active[int(s)] for s in slots], logits[:len(slots)])
        return plain_group(logits, slots, n_slots, pick)

    def recorded_verify(cache, tokens, pos):
        greedy, logits, cache = plain_verify(cache, tokens, pos)
        for s in eng.pools[name].active.values():
            g0 = len(s.tokens)
            for j, g in enumerate(decision_gaps(torch, logits[s.slot], [s.rng] * logits.shape[1],
                                                range(g0, g0 + logits.shape[1]), temperature)):
                gaps[(s.req.uid, g0 + j)] = g
        return greedy, logits, cache

    uid_of = {np.asarray(r[1], np.int32).tobytes(): r[0] for r in reqs}

    def recorded_generate(prompts, max_new, **kw):
        uids = [uid_of.get(np.asarray(p, np.int32).tobytes()) for p in prompts]

        def pick(logits, temp, gen, row_keys=None, token_idx=0):
            for u, g in zip(uids, decision_gaps(torch, logits, row_keys or [None] * len(uids),
                                                [token_idx] * len(uids), temp)):
                if u is not None:
                    gaps[(u, token_idx)] = g
            return type(w)._pick(logits, temp, gen, row_keys, token_idx)

        w._pick = pick
        try:
            return plain_generate(prompts, max_new, **kw)
        finally:
            del w._pick

    w.decode_pool = recorded
    if prefills:
        w.group_tokens = recorded_group
    if served:
        w.decode_verify, w.generate = recorded_verify, recorded_generate
    try:
        yield gaps
    finally:
        del w.decode_pool  # the methods of the worker's class again
        if prefills:
            del w.group_tokens
        if served:
            del w.decode_verify, w.generate


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


# ---------------------------------------------------------------------------
# kimi-k2, a mesh of one, two ranks
# ---------------------------------------------------------------------------


class DropCounter:
    """Wraps ``models.moe.dispatch``: the assignments offered and those
    kept within capacity, summed on the device (read once, at the end); a
    rank of a model axis keeps only those of its own experts."""

    def __init__(self, moe):
        self.moe, self.dispatch = moe, moe.dispatch
        self.kept, self.offered = 0, 0

    def __enter__(self):
        self.moe.dispatch = self
        return self

    def __exit__(self, *exc):
        self.moe.dispatch = self.dispatch

    def __call__(self, ids, E, C):
        order, slot, valid = self.dispatch(ids, E, C)
        self.kept = self.kept + valid.sum()
        self.offered += ids.numel()
        return order, slot, valid

    def share(self) -> float:
        return 1.0 - float(self.kept) / self.offered if self.offered else 0.0


class RouteLog:
    """Wraps ``models.moe.route``: each call's top-k expert sets (rows
    sorted) and, with ``logp``, the router's log-probabilities, in call
    order (one call per MoE layer per pass)."""

    def __init__(self, moe, logp=False):
        self.moe, self.route, self.logp = moe, moe.route, logp
        self.calls = []

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def __call__(self, xt, router, k):
        probs, gates, ids = self.route(xt, router, k)
        self.calls.append((ids.sort(dim=-1).values.cpu().numpy(),
                           probs.double().log().float().cpu().numpy() if self.logp else None))
        return probs, gates, ids


def router_flips(plain_calls, other_calls):
    """(call, row, plain log-prob margin) of every row whose top-k expert
    set differs between two runs of the same passes, call by call: the
    margin is the plain run's largest log-probability among the experts it
    kept and the other run left, less the smallest among those the other
    run took instead (a near-tie when small)."""
    flips = []
    for c, ((ids, logp), (mine, _)) in enumerate(zip(plain_calls, other_calls)):
        if ids.shape != mine.shape:
            break
        for r in (ids != mine).any(axis=1).nonzero()[0]:
            left = sorted(set(ids[r]) - set(mine[r]))
            took = sorted(set(mine[r]) - set(ids[r]))
            flips.append((c, int(r), float(logp[r, left].max() - logp[r, took].min())))
    return flips


@contextlib.contextmanager
def deciding_rows(torch, eng, reqs, routes, gaps=None):
    """Yields ({(uid, token index): (route call, row)}, {route calls of the
    prefill passes}), filled while the block runs: the call of
    ``routes`` (a RouteLog) made by the pass that decided each token and
    the row that token's position takes in it (a decode pass's row is the
    request's slot, a prefill's the last prompt token of the request's row
    in its group). With ``gaps`` (``record_gaps``'s) the first tokens'
    top-2 gaps are recorded from the prefills that decided them. The
    worker's own methods are back in place after it."""
    name = next(iter(eng.workers))
    w = eng.workers[name]
    uid_of = {p.tobytes(): uid for uid, p, _ in reqs}
    decided, prefills = {}, set()
    saved = {n: w.__dict__.get(n) for n in ("decode_pool", "prefill_batch")}
    decode, prefill = w.decode_pool, w.prefill_batch

    def decode_pool(cache, tokens, pos, enc_len=None):
        at = len(routes.calls)
        res = decode(cache, tokens, pos, enc_len=enc_len)
        for s in eng.pools[name].active.values():  # the pool is made at the first admission
            decided[(s.req.uid, len(s.tokens))] = (at, s.slot)
        return res

    def prefill_batch(prompts, *a, **kw):
        at = len(routes.calls)
        prefills.add(at)
        logits, cache = prefill(prompts, *a, **kw)
        S = prompts.shape[1]
        rows = []
        for g, p in enumerate(prompts):  # a padding row repeats the group's first prompt
            uid = uid_of[p.tobytes()]
            if (uid, 0) not in decided:
                decided[(uid, 0)] = (at, g * S + S - 1)
                rows.append((uid, g))
        if gaps is not None and rows:
            got = decision_gaps(torch, logits[[g for _, g in rows]], [None] * len(rows),
                                [0] * len(rows), 0.0)
            for (uid, _), gap in zip(rows, got):
                gaps[(uid, 0)] = gap
        return logits, cache
    w.decode_pool, w.prefill_batch = decode_pool, prefill_batch
    try:
        yield decided, prefills
    finally:
        for n, f in saved.items():
            if f is None:
                w.__dict__.pop(n, None)
            else:
                setattr(w, n, f)


def kimi_recorded_run(torch, cfg, params, reqs, ctx=None, gaps=False):
    """The kimi serve's requests on a FIFO engine of ``cfg`` over
    ``params`` (on ``ctx``), with the router's calls logged (with the
    log-probabilities and each decision's top-2 logit gap when ``gaps``),
    each token's deciding (route call, row) and the MoE's drops counted.
    Returns tokens by uid, ``decided``, ``prefills``, ``routes`` (the
    calls), ``drop_share`` (unsharded) or the assignments ``kept`` of the
    ``offered`` (a rank keeps only those of its own experts), ``gaps`` (or
    None) and the peak device memory."""
    from repro_torch.models import moe
    from repro_torch.serving.slots import Request
    eng = fifo_engine(cfg, params, KIMI_SERVE, ctx)
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        gp = stack.enter_context(record_gaps(torch, eng, reqs, 0.0)) if gaps else None
        drops = stack.enter_context(DropCounter(moe))
        routes = stack.enter_context(RouteLog(moe, logp=gaps))
        decided, prefills = stack.enter_context(deciding_rows(torch, eng, reqs, routes, gp))
        for uid, p, n in reqs:
            eng.submit(cfg.name, Request(uid, p, n))
        out = eng.run_all()
        got = None if gp is None else {(uid, i): gp[(uid, i)] for uid, _, n in reqs
                                       for i in range(n)}
    return dict(tokens=tokens_by_uid(out), decided=decided, prefills=sorted(prefills),
                routes=routes.calls, drop_share=drops.share(), kept=int(drops.kept),
                offered=drops.offered, gaps=got,
                peak_mem_bytes=torch.cuda.max_memory_allocated())


def explain_one_layer(label, plain, other, gaps, decided, prefills, flips, own_row_only):
    """Per uid, the first token where ``other`` leaves ``plain``, in a model
    of ONE layer: its K/V cache holds projections of the tokens alone, so a
    pass's logits depend on the tokens and on that pass's routing, nothing
    else. ``decided`` and ``prefills`` are ``deciding_rows``' of the plain
    run, ``flips`` ``router_flips`` of the two runs' route calls.

    Every router flip at a row whose inputs the runs share (any row of a
    prefill; a decode row whose request has not diverged before the token
    it decides) must be a near-tie (ROUTER_TIE). Each divergence must be
    explained by the plain run's top-2 logit gap within bf16 rounding
    (MODEL_TOL_BF16 of its largest |logit|) or by a flip at its own row;
    unless ``own_row_only`` (a drop-free capacity, where a row's output is
    its own experts' alone), also by a flip in the same pass or a row in
    that pass whose request diverged before (a changed expert set moves,
    through the experts' capacity, which of the pass's other assignments
    are dropped). Returns the number of divergences by explanation."""
    first = {}
    for uid in sorted(plain):
        i = next((j for j, (x, y) in enumerate(zip(other[uid], plain[uid])) if x != y), None)
        if i is not None:
            first[uid] = i
    inf = float("inf")
    row_of = {at: key for key, at in decided.items()}

    def shared(c, r):
        if c in prefills:
            return True
        key = row_of.get((c, r))
        return key is not None and first.get(key[0], inf) >= key[1]
    judged = [f for f in flips if shared(f[0], f[1])]
    for c, r, margin in judged:
        if (c, r) in row_of:  # the rows that decide a token; the others are counted
            log(f"{label}: router flip in pass {c} at row {r} (uid {row_of[(c, r)][0]}, token "
                f"{row_of[(c, r)][1]}), plain log-prob margin {margin:.4g} (near-tie bound "
                f"{ROUTER_TIE})")
    log(f"{label}: {len(judged)} router flips at rows of shared inputs, in passes "
        f"{sorted({c for c, _, _ in judged})}, largest plain log-prob margin "
        f"{max((m for _, _, m in judged), default=0.0):.4g} (near-tie bound {ROUTER_TIE}); "
        f"{len(flips) - len(judged)} at rows whose inputs differ")
    far = [f for f in judged if f[2] > ROUTER_TIE]
    if far:
        raise SmokeFailure(f"{label}: router flips away from a near-tie: {far}")
    flipped = {(c, r) for c, r, _ in judged}
    flip_passes = {c for c, _ in flipped}
    moved = {c for (c, _), (uid, j) in row_of.items() if first.get(uid, inf) < j}
    counts = dict(diverged=len(first), by_gap=0, by_own_flip=0, by_pass=0)
    for uid, i in sorted(first.items()):
        c, r = decided[(uid, i)]
        gap, scale = gaps[(uid, i)]
        if gap is not None and gap <= MODEL_TOL_BF16 * scale:
            why = "by_gap"
        elif (c, r) in flipped:
            why = "by_own_flip"
        elif not own_row_only and (c in flip_passes or c in moved):
            why = "by_pass"
        else:
            raise SmokeFailure(f"{label}: uid {uid} diverges at token {i} (pass {c}, row {r}) "
                               f"unexplained: top-2 gap {gap} at largest |logit| {scale}, no "
                               f"flip at its row" + ("" if own_row_only else
                                                     ", no flip or diverged row in its pass"))
        counts[why] += 1
        log(f"{label}: uid {uid} diverges at token {i} (pass {c}, row {r}; {plain[uid][i]} "
            f"unsharded, {other[uid][i]} sharded); unsharded top-2 gap {gap} at largest "
            f"|logit| {scale}; explained {why.replace('_', ' ')}")
    log(f"{label}: tokens identical for {len(plain) - len(first)} of {len(plain)} uids")
    return counts


def serve_requests(cfg, k):
    """The (uid, prompt, max_new) of ``launch.serve.build_engine``'s queue
    for one model served alone with the serve parameters ``k`` (the same
    draws in the same order)."""
    return spec_requests(cfg, k["requests"], k["prompt_lens"], k["max_new"], k["seed"])


def fifo_engine(cfg, params, k, ctx=None):
    """A FIFO engine serving ``cfg`` with ``params`` at ``k``'s pool shape."""
    return spec_engine(cfg, params, None, None, k["max_slots"], k["max_len"], ctx)


def tokens_by_uid(out):
    return {r.uid: [int(t) for t in r.tokens] for r in out}


def phase_kimi(torch, report):
    """kimi-k2-1t-a32b at full width cut to 1 of its 61 layers, bf16, FIFO,
    through ``launch.serve``: every request completes and flash and decode
    launched as the worker's passes imply (one flash per prefill pass, one
    decode per pass). Then, on the same weights, the same requests again,
    warm (timed; tokens identical), and for the shard2 phase's comparison:
    once more untimed, recorded (``kimi_recorded_run``: the MoE's drops,
    the router's calls, each decision's top-2 logit gap and deciding row);
    the prefill logits of KIMI_LOGIT_PROMPTS with the router's calls kept;
    and the drop-free witness, the recorded run at a capacity factor of
    E / k (no assignment dropped)."""
    import numpy as np

    from repro_torch.launch.serve import serve
    from repro_torch.models import moe
    k = KIMI_SERVE
    (eng, out, rep), launches = drive(serve, **k)
    check_responses("kimi", eng, out, k["requests"], k["max_new"])
    want = dict(attention_launches_expected(eng), ssd_scan=0)
    if launches != want or min(launches["flash_attention"], launches["decode_attention"]) == 0:
        raise SmokeFailure(f"kimi: kernel launches {launches}, expected {want}")
    w = eng.workers[KIMI_ARCH]
    cfg, params = w.cfg, w.params
    first = tokens_by_uid(out)
    del eng, w
    reqs = serve_requests(cfg, k)
    warm = fifo_engine(cfg, params, k)
    out2, launches2, wall2, peak2 = spec_run(torch, warm, reqs, False, 0.0)
    if tokens_by_uid(out2) != first:
        raise SmokeFailure("kimi: the warm run's tokens differ from the first run's")
    del warm
    rec = kimi_recorded_run(torch, cfg, params, reqs, gaps=True)
    if rec["tokens"] != first:
        raise SmokeFailure("kimi: the recorded run's tokens differ from the first run's")
    prompts = np.random.default_rng(3).integers(1, cfg.vocab_size, KIMI_LOGIT_PROMPTS,
                                                dtype=np.int32)
    with RouterReplay(moe) as replay:  # plain mode: keeps (probs, ids) of each call
        logits = fifo_engine(cfg, params, k).workers[cfg.name].prefill_batch(prompts)[0]
    logit_routes = [(p.cpu().numpy(), i.cpu().numpy()) for p, i in replay.plain]
    del replay
    free = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts / cfg.top_k)
    wit = kimi_recorded_run(torch, free, params, reqs, gaps=True)
    if wit["drop_share"] != 0.0:
        raise SmokeFailure(f"kimi drop-free witness: drop share {wit['drop_share']}")
    summary = {"layers": cfg.num_layers, "of_layers": 61, "requests": rep["requests"],
               "tokens": rep["tokens"], "cold_wall_s": rep["wall_s"],
               "warm_wall_s": wall2, "peak_mem_bytes": rep["peak_mem_bytes"],
               "route_calls": len(rec["routes"]),
               "warm_peak_mem_bytes": peak2, "prefill_batches": rep["prefill_batches"],
               "calls": rep["models"][KIMI_ARCH], "launches": launches,
               "moe_drop_share": rec["drop_share"],
               "drop_free_witness_uids_differing": sum(
                   wit["tokens"][u] != first[u] for u in first),
               "drop_free_witness_peak_mem_bytes": wit["peak_mem_bytes"]}
    report["launches_kimi"] = launches
    report["kimi"] = summary
    report["kimi_unsharded"] = dict(capacity=rec, witness=wit, prompts=prompts,
                                    logits=logits.float().cpu().numpy(),
                                    logit_routes=logit_routes)
    log(f"kimi ({cfg.num_layers} of 61 layers, full width, bf16, FIFO): {json.dumps(summary)}")
    log(f"kimi: peak memory {rep['peak_mem_bytes'] / 2**30:.2f} GiB, warm wall {wall2:.3f} s, "
        f"MoE drop share {rec['drop_share']:.4f}")


def mesh1_pair(torch, label, run):
    """``run(ctx)`` -> (engine, responses, launches) on no mesh and on a
    (1, 1) mesh; tokens per uid, the ledger's joules and the launches must
    be identical, and the meshed worker must have sharded dims."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.context import ExecContext
    mesh = ExecContext(mesh=make_debug_mesh(1, 1), batch_axes=("data",), model_axis="model")
    res = {}
    for key, ctx in (("none", ExecContext()), ("mesh1", mesh)):
        eng, out, launches = run(ctx)
        res[key] = dict(tokens=tokens_by_uid(out), joules=eng.ledger.total_energy().total_j,
                        launches=launches, report=[w.shard_report for w in eng.workers.values()])
        del eng
    a, b = res["none"], res["mesh1"]
    rep = b["report"][0]
    same = a["tokens"] == b["tokens"] and a["joules"] == b["joules"]
    summary = {"uids": len(a["tokens"]), "tokens_identical": a["tokens"] == b["tokens"],
               "joules": [a["joules"], b["joules"]], "launches": [a["launches"], b["launches"]],
               "shard_report": {"sharded": rep.sharded, "replicated": rep.replicated}}
    log(f"mesh1 {label}: {json.dumps(summary)}")
    if not same or a["launches"] != b["launches"] or rep.sharded == 0:
        raise SmokeFailure(f"mesh1 {label}: a mesh of one differs from no mesh: {summary}")
    return summary


def phase_mesh1(torch, report):
    """A (1, 1) mesh on the card against no mesh: full tinyllama-1.1b through
    ``launch.serve`` under the AdaOper scheduler, continuous and bucketed,
    then kimi-k2 at full width cut to 1 layer (FIFO, one set of weights for
    both): tokens, ledger joules and launches identical, and a shard report
    with sharded dims."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_params
    out = {}
    for mode in ("continuous", "bucketed"):
        def run(ctx, mode=mode):
            (eng, resp, _), launches = drive(serve, **MESH1, ctx=ctx, mode=mode)
            check_responses(f"mesh1 {mode}", eng, resp, MESH1["requests"], MESH1["max_new"])
            return eng, resp, launches
        out[f"tinyllama {mode}"] = mesh1_pair(torch, f"tinyllama-1.1b {mode}", run)
    cfg = dataclasses.replace(get_config(KIMI_ARCH), num_layers=1)
    params = init_params(cfg, KIMI_SERVE["seed"], "cuda")
    reqs = serve_requests(cfg, KIMI_SERVE)

    def run_kimi(ctx):
        eng = fifo_engine(cfg, params, KIMI_SERVE, ctx)
        resp, launches, _, _ = spec_run(torch, eng, reqs, False, 0.0)
        check_responses("mesh1 kimi", eng, resp, KIMI_SERVE["requests"], KIMI_SERVE["max_new"])
        return eng, resp, launches
    out["kimi"] = mesh1_pair(torch, "kimi-k2 (1 layer)", run_kimi)
    report["mesh1"] = out
    import torch.distributed as dist
    dist.destroy_process_group()  # the world of one the mesh started


def shard2_rank(rank, tiny_cfg, tiny_serve, logit_prompts, kimi_serve, logit_prompts_kimi,
                logit_routes, device="cuda"):
    """One of the shard2 phase's two ranks (its own process, gloo over CUDA
    tensors on the one card): the collectives probe, then (a) full
    tinyllama-1.1b in fp32 (exact fp32), FIFO at ``tiny_serve``'s shapes,
    and the prefill logits of ``logit_prompts``, then (b) kimi-k2 through
    ``launch.serve`` at ``kimi_serve``, and on its weights the prefill
    logits of ``logit_prompts_kimi`` with the unsharded run's experts
    (``logit_routes``) replayed, the recorded run at the serve's capacity
    and the drop-free witness (``kimi_recorded_run``); each on a (1, 2)
    mesh, the weights drawn as this rank's shard."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_params
    from repro_torch.sharding import collectives
    from repro_torch.sharding.context import ExecContext
    ctx = ExecContext(mesh=make_debug_mesh(1, 2), batch_axes=("data",), model_axis="model")
    x = torch.full((4, 7168), float(rank + 1), dtype=torch.bfloat16, device=device)
    dist.all_reduce(x, group=ctx.model_group)
    parts = [torch.empty(3, 5, device=device) for _ in range(2)]
    dist.all_gather(parts, torch.full((3, 5), float(rank), device=device), group=ctx.model_group)
    probe = {"backend": dist.get_backend(), "all_reduce": bool((x == 3).all()),
             "all_gather": all(bool((p == i).all()) for i, p in enumerate(parts)),
             "devices": sorted({str(x.device), str(parts[0].device)})}
    out = {"probe": probe}
    if not (probe["all_reduce"] and probe["all_gather"]):
        return out
    with exact_fp32():
        params = init_params(tiny_cfg, tiny_serve["seed"], device, ctx=ctx)
        eng = fifo_engine(tiny_cfg, params, tiny_serve, ctx)
        reqs = serve_requests(tiny_cfg, tiny_serve)
        resp, launches, wall, peak = spec_run(torch, eng, reqs, False, 0.0)
        expected = dict(attention_launches_expected(eng), ssd_scan=0)
        w = eng.workers[tiny_cfg.name]
        prompts = np.random.default_rng(3).integers(1, tiny_cfg.vocab_size, logit_prompts,
                                                    dtype=np.int32)
        logits = w.prefill_batch(prompts)[0].float().cpu().numpy()
        out["tiny"] = {"tokens": tokens_by_uid(resp), "logits": logits, "launches": launches,
                       "expected": expected,
                       "wall_s": wall, "peak_mem_bytes": peak, "shard": w.params.shard,
                       "sharded": w.shard_report.sharded}
    del eng, w, params
    torch.cuda.empty_cache()
    calls = collectives.all_reduce.calls, collectives.all_gather_last.calls
    from repro_torch.models import moe
    (eng, resp, rep), launches = drive(serve, **kimi_serve, ctx=ctx)
    w = eng.workers[KIMI_ARCH]
    cfg, params = w.cfg, w.params
    out["kimi"] = {"tokens": tokens_by_uid(resp), "launches": launches,
                   "expected": dict(attention_launches_expected(eng), ssd_scan=0),
                   "wall_s": rep["wall_s"], "init_s": rep["init_s"],
                   "peak_mem_bytes": rep["peak_mem_bytes"], "shard": w.params.shard,
                   "sharded": w.shard_report.sharded, "replicated": w.shard_report.replicated,
                   "experts": [int(w.params.layers[0].mlp.w_gate.shape[0]), w.cfg.num_experts],
                   "q_heads": [int(w.params.layers[0].attn.wq.weight.shape[0] // w.cfg.head_dim),
                               w.cfg.num_heads],
                   "kv_heads": [int(w.params.layers[0].attn.wk.weight.shape[0]
                                    // w.cfg.head_dim), w.cfg.num_kv_heads],
                   "all_reduces": collectives.all_reduce.calls - calls[0],
                   "all_gathers": collectives.all_gather_last.calls - calls[1],
                   "errors": rep["errors"]}
    del eng, w
    reqs = serve_requests(cfg, kimi_serve)
    # the prefill logits with the unsharded run's experts replayed
    replay = RouterReplay(moe)
    replay.plain = [(torch.as_tensor(p, device=device), torch.as_tensor(i, device=device))
                    for p, i in logit_routes]
    replay.mode, replay.step = "sharded", "prefill"
    with replay:
        logits = fifo_engine(cfg, params, kimi_serve, ctx).workers[cfg.name].prefill_batch(
            logit_prompts_kimi)[0]
    out["kimi"]["logits"] = logits.float().cpu().numpy()
    out["kimi"]["logit_flips"] = replay.flips
    # recorded: at the serve's capacity, then the drop-free witness
    out["kimi"]["capacity"] = kimi_recorded_run(torch, cfg, params, reqs, ctx)
    free = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts / cfg.top_k)
    out["kimi"]["witness"] = kimi_recorded_run(torch, free, params, reqs, ctx)
    out["kimi"]["witness_peak_mem_bytes"] = out["kimi"]["witness"]["peak_mem_bytes"]
    return out


def phase_shard2(torch, report):
    """Two ranks on the one card, spawned (``launch.sharded.run_ranks``:
    gloo over CUDA tensors, as NCCL refuses two ranks on one device; a time
    limit, every rank's exit code read), after the parent has built the
    kernels and freed the earlier phases' memory. First a probe that gloo
    takes CUDA tensors for all_reduce and all_gather (the phase fails if
    not). (a) Full tinyllama-1.1b in fp32, exact fp32: greedy tokens equal
    to the unsharded run's on every request (the parent's run, first), the
    largest difference of the prefill logits printed. (b) kimi-k2 at full
    width, 1 layer, bf16, each rank holding 192 of the 384 experts and 32 of
    the 64 q heads (4 of 8 kv heads): every request completes and the
    ranks' tokens and logits are identical; the prefill logits of
    KIMI_LOGIT_PROMPTS, the unsharded run's experts replayed, lie within
    bf16 rounding of the unsharded logits (MODEL_TOL_BF16 of each row's
    largest |logit|; the ranks' own router flips there near-ties); the
    tokens of the recorded runs against the kimi phase's, by
    ``explain_one_layer``: at the serve's capacity a divergence may also
    follow from a flip or a diverged row in its own pass, in the drop-free
    witness only from its own gap or its own row's flip. Each rank's peak
    memory and launches."""
    import gc

    import numpy as np
    if "kimi_unsharded" not in report:
        raise SmokeFailure("shard2 compares kimi with the kimi phase's run: add the kimi phase")

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.launch.sharded import run_ranks
    from repro_torch.models.model import init_params
    gc.collect()
    torch.cuda.empty_cache()
    build.load_library()  # built once here, before the ranks load it
    tiny = dataclasses.replace(get_config(SHARD2["tiny"]), dtype="float32",
                               param_dtype="float32")
    with exact_fp32():
        params = init_params(tiny, SERVE["seed"], "cuda")
        eng = fifo_engine(tiny, params, SERVE)
        ref_out, _, ref_wall, _ = spec_run(torch, eng, serve_requests(tiny, SERVE), False, 0.0)
        prompts = np.random.default_rng(3).integers(1, tiny.vocab_size, SHARD2["logit_prompts"],
                                                    dtype=np.int32)
        ref_logits = eng.workers[tiny.name].prefill_batch(prompts)[0].float().cpu().numpy()
    ref_tokens = tokens_by_uid(ref_out)
    del eng, params, ref_out
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = report["kimi_unsharded"]
    ranks = run_ranks(shard2_rank, SHARD2["world"],
                      (tiny, SERVE, SHARD2["logit_prompts"], KIMI_SERVE, ref["prompts"],
                       ref["logit_routes"], "cuda"),
                      timeout=SHARD2["timeout"], device_type="cuda")
    wall = time.perf_counter() - t0
    probes = [r["probe"] for r in ranks]
    log(f"shard2 probe (gloo, CUDA tensors): {json.dumps(probes)}")
    if not all(p["all_reduce"] and p["all_gather"] for p in probes):
        raise SmokeFailure(f"shard2: gloo does not take CUDA tensors here: {probes}")
    out = {"spawn_wall_s": wall, "probe": probes, "unsharded_fp32_wall_s": ref_wall}
    for arm in ("tiny", "kimi"):
        for rank, r in enumerate(ranks):
            a = r[arm]
            if a["launches"] != a["expected"] or a["shard"] != (2, rank) or a["sharded"] == 0:
                raise SmokeFailure(f"shard2 {arm} rank {rank}: launches {a['launches']} "
                                   f"(expected {a['expected']}), shard {a['shard']}")
        if ranks[0][arm]["tokens"] != ranks[1][arm]["tokens"]:
            raise SmokeFailure(f"shard2 {arm}: the two ranks' tokens differ")
    err = max(float(np.abs(r["tiny"]["logits"] - ref_logits).max()) for r in ranks)
    scale = float(np.abs(ref_logits).max())
    if ranks[0]["tiny"]["tokens"] != ref_tokens or err > MODEL_TOL * (1 + scale):
        raise SmokeFailure(f"shard2 tinyllama fp32: tokens equal "
                           f"{ranks[0]['tiny']['tokens'] == ref_tokens}, logits max abs err {err}")
    kimi = ranks[0]["kimi"]
    halves = [mine * 2 == of for mine, of in (kimi["experts"], kimi["q_heads"], kimi["kv_heads"])]
    if kimi["errors"] or not all(halves):
        raise SmokeFailure(f"shard2 kimi: {kimi['errors']} errors; rank 0 holds experts, q heads, "
                           f"kv heads {kimi['experts']}, {kimi['q_heads']}, {kimi['kv_heads']}")

    if KIMI_SERVE["layers"][KIMI_ARCH] != 1:
        raise SmokeFailure("shard2 kimi: explain_one_layer holds for a model of one layer")
    if not np.array_equal(ranks[0]["kimi"]["logits"], ranks[1]["kimi"]["logits"]):
        raise SmokeFailure("shard2 kimi: the two ranks' prefill logits differ")
    lscale = np.abs(ref["logits"]).max(axis=-1, keepdims=True)
    lerr = np.abs(kimi["logits"] - ref["logits"])
    for st, r, left, took, margin in kimi["logit_flips"]:
        log(f"shard2 kimi logits: router flip at {st}, row {r}: unsharded {left} -> sharded "
            f"{took} (replayed), margin {margin:.4g} (near-tie bound {ROUTER_TIE})")
    far = [f for f in kimi["logit_flips"] if f[-1] > ROUTER_TIE]
    logit_summary = {"rows": int(lerr.shape[0]), "max_abs_err": float(lerr.max()),
                     "max_rel_err": float((lerr / lscale).max()), "tol_rel": MODEL_TOL_BF16,
                     "largest_logit": float(lscale.max()),
                     "router_flips": len(kimi["logit_flips"])}
    log(f"shard2 kimi prefill logits (2 ranks vs unsharded, experts replayed): "
        f"{json.dumps(logit_summary)}")
    if far or not bool((lerr <= MODEL_TOL_BF16 * lscale).all()):
        raise SmokeFailure(f"shard2 kimi: prefill logits {logit_summary}, flips away from a "
                           f"near-tie {far}")
    arms = {}
    for arm, own_row in (("capacity", False), ("witness", True)):
        mine, theirs = ranks[0]["kimi"][arm], ranks[1]["kimi"][arm]
        want = ref[arm]
        if any(not (x[0] == y[0]).all() for x, y in zip(mine["routes"], theirs["routes"])):
            raise SmokeFailure(f"shard2 kimi {arm}: the two ranks' routers chose other experts")
        if mine["tokens"] != theirs["tokens"]:
            raise SmokeFailure(f"shard2 kimi {arm}: the two ranks' tokens differ")
        if (mine["decided"], mine["prefills"]) != (want["decided"], want["prefills"]):
            raise SmokeFailure(f"shard2 kimi {arm}: the ranks' passes are not the unsharded "
                               "run's")
        kept = mine["kept"] + theirs["kept"]  # each rank keeps its own experts' assignments
        if arm == "witness" and (kept != mine["offered"] or want["drop_share"] != 0.0):
            raise SmokeFailure(f"shard2 kimi witness: the ranks kept {kept} of "
                               f"{mine['offered']} assignments")
        flips = router_flips(want["routes"], mine["routes"])
        label = f"shard2 kimi {arm} (2 ranks vs unsharded)"
        counts = explain_one_layer(label, want["tokens"], mine["tokens"], want["gaps"],
                                   want["decided"], set(want["prefills"]), flips, own_row)
        arms[arm] = dict(counts, router_flips=len(flips), drop_share=want["drop_share"],
                         sharded_drop_share=1.0 - kept / mine["offered"],
                         serve_tokens_equal=(mine["tokens"] == kimi["tokens"]
                                             if arm == "capacity" else None))
    if not arms["capacity"]["serve_tokens_equal"]:
        raise SmokeFailure("shard2 kimi: the recorded run's tokens differ from the serve's")
    out["tiny"] = {"uids": len(ref_tokens), "tokens_equal": True, "logits_max_abs_err": err,
                   "largest_logit": scale,
                   "ranks": [{x: r["tiny"][x] for x in ("wall_s", "peak_mem_bytes", "launches")}
                             for r in ranks]}
    out["kimi"] = {"prefill_logits": logit_summary, **arms,
                   "ranks": [{x: r["kimi"][x] for x in ("wall_s", "init_s", "peak_mem_bytes",
                                                        "witness_peak_mem_bytes",
                                                        "launches", "experts", "q_heads",
                                                        "kv_heads", "sharded", "replicated",
                                                        "all_reduces", "all_gathers")}
                             for r in ranks]}
    report["shard2"] = out
    log(f"shard2: {json.dumps(out)}")
    for rank, r in enumerate(ranks):
        log(f"shard2 rank {rank}: peak memory tinyllama fp32 "
            f"{r['tiny']['peak_mem_bytes'] / 2**30:.2f} GiB, kimi "
            f"{r['kimi']['peak_mem_bytes'] / 2**30:.2f} GiB")


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
    """Whether ``name`` is one of ``model_spans``' or ``train_spans``'
    ranges."""
    return name.startswith(("pass ", "train ")) or name == "mamba1"


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
    out, groups = device_summary(torch, prof, warm, wall, spans is not None)
    # every launch of an attention kernel must land in its own group
    for g, n in attention_launches_expected(eng).items():
        if groups.get(g, (0, 0.0))[0] != n:
            raise SmokeFailure(f"{key}: the profile counts {groups.get(g)} for {g}, "
                               f"the engine launched it {n} times")
    report[key] = out
    log(f"{key}:", json.dumps(out))


def device_summary(torch, prof, warm, wall, with_spans):
    """A profile's device busy time, idle share of the warm untraced and
    the traced wall, device time by kernel group and the top kernels, and
    with ``with_spans`` the device and host time under each ``is_span``
    range. Returns (summary, {group: (launches, ms)})."""
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
    out = {"warm_untraced_wall_s": warm, "traced_wall_s": wall, "device_busy_s": busy_s,
           "idle_share_traced": 1.0 - busy_s / wall, "idle_share_untraced": 1.0 - busy_s / warm,
           "groups_ms": {g: {"launches": n, "ms": t} for g, (n, t) in groups.items()},
           "top": [{"kernel": k[:90], "launches": c, "ms": us * 1e-3}
                   for k, c, us in kernels[:15]]}
    if with_spans:  # device time of the kernels launched inside each range
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CPU and is_span(evt.name):
                us = getattr(evt, "device_time_total", None)
                row = span_ms.setdefault(evt.name, {"calls": 0, "device_ms": 0.0,
                                                    "host_ms": 0.0})
                row["calls"] += 1
                row["device_ms"] += (evt.cuda_time_total if us is None else us) * 1e-3
                row["host_ms"] += evt.cpu_time_total * 1e-3
        out["spans"] = span_ms
    return out, groups


# ---------------------------------------------------------------------------
# the train phase
# ---------------------------------------------------------------------------

# full tinyllama-1.1b: JAX's launch/train.py defaults (lr 1e-3, warmup
# min(20, steps // 5)) at B 8, S 512, 40 steps, a checkpoint after 20
TRAIN = dict(arch="tinyllama-1.1b", batch=8, seq=512, steps=40, lr=1e-3, ckpt_at=20, seed=0)
TRAIN_LOSS_DROP = 1.0  # nats between the means of the first and last 5 steps
TRAIN_PIPE = dict(layers=4, plan={"pipeline": {"stages": 2, "microbatches": 2}})
# deepseek-v2-lite-16b at full width cut to 4 of its 27 layers (1 dense + 3 MoE)
TRAIN_MOE = dict(arch="deepseek-v2-lite-16b", layers=4, batch=4, seq=512, steps=20, lr=1e-3,
                 seed=0)
BF16_ULP = 2.0 ** -8  # relative rounding of one bf16 value
PROFILE_TRAIN_STEPS = 3


def train_run(torch, cfg, params, data, steps, oc, ctx=None, state=None, first=0, save=None):
    """``steps`` AdamW steps of ``params`` on ``data``'s batches from
    ``first``, with every kernel's launch count set to 0 just before (the
    train path launches none). ``save`` (step, fn): call fn(state) before
    that step (untimed). Returns (history rows with each step's wall time,
    state, launches, peak device bytes)."""
    from repro_torch.models.model import train_params
    from repro_torch.sharding.context import ExecContext
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import batch_to_device, make_train_step
    named = train_params(params)
    dev = next(iter(named.values())).device
    state = init_opt_state(named) if state is None else state
    step_fn = make_train_step(cfg, ctx or ExecContext(), oc)

    def go():
        hist = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(first, first + steps):
            if save is not None and i == save[0]:
                save[1](state)
            b = batch_to_device(data.batch(i), dev)
            t0 = time.perf_counter()
            row = {k: float(v) for k, v in step_fn(params, state, b).items()}  # waits
            hist.append(dict(row, step_s=time.perf_counter() - t0))
        return hist, torch.cuda.max_memory_allocated()

    (hist, peak), launches = drive(go)
    return hist, state, launches, peak


def train_summary(cfg, hist, B, S, peak):
    warm = sorted(h["step_s"] for h in hist[1:])
    step_s = warm[len(warm) // 2]
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": B, "seq": S,
            "steps": len(hist), "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
            "loss_first5": sum(h["loss"] for h in hist[:5]) / 5,
            "loss_last5": sum(h["loss"] for h in hist[-5:]) / 5,
            "warm_median_step_s": step_s, "tokens_per_s": B * S / step_s,
            "first_step_s": hist[0]["step_s"], "peak_mem_bytes": peak}


def train_checks(label, hist, launches):
    import math
    bad = [i for i, h in enumerate(hist)
           if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))]
    if bad:
        raise SmokeFailure(f"{label}: loss or grad norm not finite at steps {bad}")
    if any(launches.values()):
        raise SmokeFailure(f"{label}: the train path launched kernels {launches}")


def snapshot(params, state):
    """Host copies of every param and moment, for a bitwise comparison
    (on the host, so that they add nothing to the device's peak)."""
    return ({n: p.detach().cpu() for n, p in params.named_parameters()},
            {k: {n: t.cpu() for n, t in state[k].items()} for k in ("m", "v")},
            state["step"])


def same_bits(torch, a, b):
    """Equal dtypes and bit patterns."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def train_tinyllama(torch, report, tmp):
    """(a) of ``phase_train``: the step-0 logits against the flash prefill,
    40 steps with a checkpoint after 20, the restore and the 20 steps after
    it. Returns the summary."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_cache, init_params, prefill, train_logits
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import batch_to_device
    t = TRAIN
    B, S, n = t["batch"], t["seq"], t["steps"]
    cfg = get_config(t["arch"])
    data = SyntheticLM(cfg, DataConfig(batch=B, seq_len=S, seed=t["seed"]))
    params = init_params(cfg, t["seed"], "cuda")
    dev = next(params.parameters()).device
    b0 = batch_to_device(data.batch(0), dev)
    with torch.no_grad():
        tl = train_logits(params, cfg, b0)[0]
        (pl, _), launches = drive(lambda: prefill(params, cfg, b0["tokens"],
                                                  init_cache(cfg, B, S, dev)))
        err, scale = float((tl - pl).abs().max()), float(pl.abs().max())
    del tl, pl
    want = dict.fromkeys(kernel_wrappers(), 0)
    want["flash_attention"] = attention_layers(cfg)
    if launches != want:
        raise SmokeFailure(f"train: the prefill launched {launches}, expected {want}")
    if not err <= MODEL_TOL_BF16 * scale:
        raise SmokeFailure(f"train: step-0 train logits {err} from the flash prefill's "
                           f"(largest |logit| {scale}, tolerance {MODEL_TOL_BF16} of it)")
    oc = OptConfig(lr=t["lr"], warmup_steps=min(20, n // 5), total_steps=n)
    saved = {}

    def save(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(tmp, params, state, step=state["step"])
        saved["save_s"] = time.perf_counter() - t0
        saved["snap"] = snapshot(params, state)

    hist, state, launches_train, peak = train_run(torch, cfg, params, data, n, oc,
                                                  save=(t["ckpt_at"], save))
    train_checks("train", hist, launches_train)
    del params, state
    torch.cuda.empty_cache()
    fresh = init_params(cfg, t["seed"] + 1, dev)
    fresh_state = init_opt_state(dict(fresh.named_parameters()))
    t0 = time.perf_counter()
    step = restore_checkpoint(tmp, fresh, fresh_state)
    restore_s = time.perf_counter() - t0
    p_snap, m_snap, step_snap = saved.pop("snap")
    diff = [n_ for n_, p in fresh.named_parameters()
            if not same_bits(torch, p.detach().cpu(), p_snap[n_])]
    diff += [f"{k}.{n_}" for k in ("m", "v") for n_, x in fresh_state[k].items()
             if not same_bits(torch, x.cpu(), m_snap[k][n_])]
    if diff or not step == step_snap == t["ckpt_at"]:
        raise SmokeFailure(f"train: the restore differs from the saved state at step {step} "
                           f"({step_snap}): {diff[:5]}")
    del p_snap, m_snap
    resumed, _, launches_resumed, _ = train_run(torch, cfg, fresh, data, n - t["ckpt_at"], oc,
                                                state=fresh_state, first=t["ckpt_at"])
    train_checks("train resumed", resumed, launches_resumed)
    gap = max(abs(a["loss"] - b["loss"]) for a, b in zip(resumed, hist[t["ckpt_at"]:]))
    summary = train_summary(cfg, hist, B, S, peak)
    drop = summary["loss_first5"] - summary["loss_last5"]
    if not drop > TRAIN_LOSS_DROP:
        raise SmokeFailure(f"train: the loss fell {drop} nats over {n} steps, not more than "
                           f"{TRAIN_LOSS_DROP}")
    report["launches_train"] = launches_train
    summary.update(step0_logit_err=err, step0_logit_scale=scale, prefill_launches=launches,
                   ckpt_step=step, ckpt_save_s=saved["save_s"], ckpt_restore_s=restore_s,
                   ckpt_bit_identical=True, resumed_loss_gap_max=gap,
                   losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
                   resumed_losses=[h["loss"] for h in resumed])
    del fresh, fresh_state
    torch.cuda.empty_cache()
    return summary


def train_remat(torch):
    """(b) of ``phase_train``: two steps of full tinyllama-1.1b at each
    remat policy from the same weights and batches: the first step's loss
    and grad norm, the second's (warm) wall time, the peak memory."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params
    from repro_torch.sharding.context import ExecContext
    from repro_torch.training.optimizer import OptConfig
    t = TRAIN
    cfg = get_config(t["arch"])
    data = SyntheticLM(cfg, DataConfig(batch=t["batch"], seq_len=t["seq"], seed=t["seed"]))
    oc = OptConfig(lr=t["lr"], warmup_steps=min(20, t["steps"] // 5), total_steps=t["steps"])
    out = {}
    for policy in ("full", "dots", "none"):
        params = init_params(cfg, t["seed"], "cuda")
        hist, _, launches, peak = train_run(torch, cfg, params, data, 2, oc,
                                            ctx=ExecContext(plan={"remat_policy": policy}))
        train_checks(f"train remat {policy}", hist, launches)
        out[policy] = {"loss": hist[0]["loss"], "grad_norm": hist[0]["grad_norm"],
                       "warm_step_s": hist[1]["step_s"], "peak_mem_bytes": peak}
        del params
        torch.cuda.empty_cache()
    for policy in ("dots", "none"):
        for k in ("loss", "grad_norm"):
            a, b = out[policy][k], out["full"][k]
            if not abs(a - b) <= BF16_ULP * abs(b):
                raise SmokeFailure(f"train remat {policy}: {k} {a} against full's {b}")
    return out


def train_pipeline(torch):
    """(c) of ``phase_train``: tinyllama-1.1b at full width cut to 4 layers,
    B 8, S 512, bf16: the train logits and one loss and its gradient under
    the pipeline plan (2 stages, 2 microbatches) against the unpipelined
    run's, within bf16 rounding."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params, loss_fn, train_logits, train_params
    from repro_torch.sharding.context import ExecContext
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_loop import batch_to_device
    t, tp = TRAIN, TRAIN_PIPE
    cfg = dataclasses.replace(get_config(t["arch"]), num_layers=tp["layers"])
    params = init_params(cfg, t["seed"], "cuda")
    named = train_params(params)
    b = batch_to_device(SyntheticLM(cfg, DataConfig(batch=t["batch"], seq_len=t["seq"],
                                                    seed=t["seed"])).batch(0),
                        next(params.parameters()).device)
    out = {}
    for key, ctx in (("plain", ExecContext()), ("pipelined", ExecContext(plan=tp["plan"]))):
        with torch.no_grad():
            logits = train_logits(params, cfg, b, ctx)[0]
        for p in named.values():
            p.grad = None
        loss, _ = loss_fn(params, cfg, b, ctx)
        loss.backward()
        out[key] = (logits, float(loss.detach()),
                    float(global_norm({n: p.grad for n, p in named.items()})))
    (la, lossa, gna), (lb, lossb, gnb) = out["plain"], out["pipelined"]
    err, scale = float((lb - la).abs().max()), float(la.abs().max())
    res = {"layers": cfg.num_layers, "plan": tp["plan"], "logit_err": err,
           "logit_scale": scale, "loss": [lossa, lossb], "grad_norm": [gna, gnb]}
    if not (err <= MODEL_TOL_BF16 * scale and abs(lossb - lossa) <= BF16_ULP * abs(lossa)
            and abs(gnb - gna) <= BF16_ULP * abs(gna) * 4):
        raise SmokeFailure(f"train pipeline: {res}")
    del params, named, out, la, lb
    torch.cuda.empty_cache()
    return res


def train_moe(torch, report):
    """(d) of ``phase_train``: deepseek-v2-lite-16b at full width cut to 4
    of its 27 layers (layer 0 dense, 1-3 MoE with MLA attention), bf16,
    B 4, S 512, 20 steps: the loss falls, the aux loss is finite and
    positive at every step; the MoE's drop share is counted."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import OptConfig
    t = TRAIN_MOE
    cfg = dataclasses.replace(get_config(t["arch"]), num_layers=t["layers"])
    data = SyntheticLM(cfg, DataConfig(batch=t["batch"], seq_len=t["seq"], seed=t["seed"]))
    params = init_params(cfg, t["seed"], "cuda")
    oc = OptConfig(lr=t["lr"], warmup_steps=min(20, t["steps"] // 5), total_steps=t["steps"])
    with DropCounter(moe) as drops:
        hist, _, launches, peak = train_run(torch, cfg, params, data, t["steps"], oc)
    train_checks("train moe", hist, launches)
    summary = train_summary(cfg, hist, t["batch"], t["seq"], peak)
    summary.update(of_layers=27, moe_drop_share=drops.share(),
                   aux=[h["aux"] for h in hist], losses=[h["loss"] for h in hist])
    if not all(h["aux"] > 0 for h in hist):
        raise SmokeFailure(f"train moe: aux loss {summary['aux']}")
    if not (summary["loss_last5"] < summary["loss_first5"] and hist[-1]["loss"] < hist[0]["loss"]):
        raise SmokeFailure(f"train moe: the loss did not fall: {summary['losses']}")
    report["launches_train_moe"] = launches
    del params
    torch.cuda.empty_cache()
    return summary


def train_refusal(torch):
    """(e) of ``phase_train``: a flash launch on a bf16 q that requires grad
    raises and launches nothing."""
    from repro_torch.kernels import flash_attention as fmod
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = qkv(torch, gen, 1, 64, 64, TINY["H"], TINY["Hkv"], TINY["D"], torch.bfloat16)
    q.requires_grad_(True)
    before = fmod.flash_attention.launches
    try:
        fmod.flash_attention(q, k, v)
    except RuntimeError as e:
        if fmod.flash_attention.launches != before:
            raise SmokeFailure("train refusal: flash launched before it refused") from e
        return str(e)
    raise SmokeFailure("train refusal: flash took a q that requires grad")


def phase_train(torch, report):
    """Training on the card: full tinyllama-1.1b takes 40 AdamW steps
    (bf16 params and moments, remat "full") with a checkpoint after 20
    restored bit for bit into a fresh model; the remat policies side by
    side; the circular pipeline; deepseek-v2-lite-16b (MLA, MoE, aux loss)
    cut to 4 layers; the kernels' refusal of inputs that require grad. The
    train path launches no kernel (none has a backward, in either package):
    the step-0 train logits are held against the prefill through the flash
    kernel instead."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        tiny = train_tinyllama(torch, report, tmp)
    summary = {"tinyllama": tiny, "remat": train_remat(torch),
               "pipeline": train_pipeline(torch), "moe": train_moe(torch, report),
               "refusal": train_refusal(torch), "card": report["smi"]}
    report["train"] = summary
    short = {k: v for k, v in tiny.items() if k not in ("losses", "grad_norms", "resumed_losses")}
    log(f"train ({report['smi']}): {json.dumps(short)}")
    log(f"train losses: {json.dumps(tiny['losses'])}")
    log(f"train remat: {json.dumps(summary['remat'])}")
    log(f"train pipeline: {json.dumps(summary['pipeline'])}")
    log(f"train moe: {json.dumps(summary['moe'])}")
    log(f"train refusal: {summary['refusal']}")
    log(f"train: tinyllama-1.1b warm step {tiny['warm_median_step_s'] * 1e3:.1f} ms, "
        f"{tiny['tokens_per_s']:.0f} tokens/s, peak {tiny['peak_mem_bytes'] / 2**30:.2f} GiB, "
        f"loss {tiny['loss_first5']:.3f} -> {tiny['loss_last5']:.3f} (means of 5), "
        f"on {report['smi']}")


@contextlib.contextmanager
def train_spans(torch):
    """Profiler ranges over the train step's forward (``loss_fn``, "train
    forward") and its AdamW update ("train adamw"); the backward, remat's
    recompute included, is the rest of the step."""
    from repro_torch.training import train_loop
    saved = {"loss_fn": train_loop.loss_fn, "adamw_update": train_loop.adamw_update}

    def spanned(fn, name):
        def wrapper(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return wrapper
    train_loop.loss_fn = spanned(saved["loss_fn"], "train forward")
    train_loop.adamw_update = spanned(saved["adamw_update"], "train adamw")
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(train_loop, attr, fn)


def phase_profile_train(torch, report):
    """(only when asked for) the train phase's full tinyllama-1.1b, warm:
    PROFILE_TRAIN_STEPS steps untimed by the profiler, then as many under
    torch.profiler: device busy time and idle share, device time by kernel
    group and under the forward and the AdamW update."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params, train_params
    from repro_torch.sharding.context import ExecContext
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import batch_to_device, make_train_step
    t, steps = TRAIN, PROFILE_TRAIN_STEPS
    cfg = get_config(t["arch"])
    data = SyntheticLM(cfg, DataConfig(batch=t["batch"], seq_len=t["seq"], seed=t["seed"]))
    params = init_params(cfg, t["seed"], "cuda")
    named = train_params(params)
    state = init_opt_state(named)
    step = make_train_step(cfg, ExecContext(),
                           OptConfig(lr=t["lr"], warmup_steps=min(20, t["steps"] // 5),
                                     total_steps=t["steps"]))
    dev = next(iter(named.values())).device
    batches = [batch_to_device(data.batch(i), dev) for i in range(3 * steps)]

    def run(bs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            float(step(params, state, b)["loss"])  # waits, as the train loop does
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(batches[:steps])  # warm-up
    warm = run(batches[steps:2 * steps])
    with train_spans(torch), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        wall = run(batches[2 * steps:])
    out, _ = device_summary(torch, prof, warm, wall, True)
    out["steps"] = steps
    spans = out["spans"]
    out["backward_device_ms"] = out["device_busy_s"] * 1e3 - sum(r["device_ms"]
                                                                for r in spans.values())
    report["profile_train"] = out
    log("profile_train:", json.dumps(out))
    del params, named, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the yolo, train_mesh and serve_mesh phases
# ---------------------------------------------------------------------------

# yolo-v2-tiny, the paper's evaluation model: 416x416, B 1 and 8, fp32
YOLO = dict(res=416, batches=(1, 8), seed=0, iters=20, tol=1e-4)
# tinyllama-1.1b at full width cut to 4 of its 22 layers (to keep the whole
# run inside its time limit beside the mesh_families phase), B 8, S 512, bf16, remat
# "full", 3 steps on each mesh ((data, model), fsdp), against the unsharded
# run's losses and grad norms
TRAIN_MESH = dict(arch="tinyllama-1.1b", layers=4, batch=8, seq=512, steps=3, lr=1e-3, seed=0,
                  meshes=(((2, 1), True), ((1, 2), None), ((2, 2), True)), timeout=600.0)
# relative tolerances of each step's loss and grad norm against the unsharded
# run in bf16 (PERF.md states them beside its predictions)
TRAIN_MESH_TOL = dict(loss=1e-2, grad_norm=5e-2)
# the families beside tinyllama, at full width, bf16, 3 steps, each against its
# unsharded run on the card (TRAIN_MESH_TOL): deepseek-v2-lite-16b (MLA) cut to 2
# of its 27 layers (a dense layer, then an MoE layer), expert-parallel on (1, 2)
# and the 2-D MoE on (2, 2) with FSDP; mamba2-2.7b cut to 4 of 64 layers on (1, 2)
# and on (2, 2) with FSDP; seamless-m4t-medium cut to 2 encoder + 2 decoder
# layers, 256 target tokens on 100 frames, on (1, 2); jamba-v0.1-52b cut to
# JAMBA_PARITY's 3 layers (Mamba1, Mamba1 with the 16-expert MoE, GQA attention;
# ~4.0 B parameters), B 2 S 256, expert-parallel on (1, 2); tinyllama-1.1b (32 on
# 4 heads: each kv head on 2 ranks) and qwen2-7b (28 on 4: each group padded from
# 7 to 8 heads) cut to 2 layers on eight ranks, (1, 8). Each mesh entry: (mesh,
# fsdp, ExecContext.plan). ``judged``: TRAIN_MESH_TOL judges only the first that
# many steps; each later one is printed beside the noise floor of that step
# (TRAIN_MESH_NOISE). jamba's third loss comes after two AdamW steps from random
# weights, where roundings that only reorder a sum already move it as far as
# the tolerance (PERF.md, PR 28)
TRAIN_MESH_FAMILIES = {
    "deepseek": dict(arch="deepseek-v2-lite-16b", cut=dict(num_layers=2), batch=4, seq=512,
                     meshes=(((1, 2), None, None), ((2, 2), True, {"moe_2d": True}))),
    "mamba2": dict(arch="mamba2-2.7b", cut=dict(num_layers=4), batch=4, seq=512,
                   meshes=(((1, 2), None, None), ((2, 2), True, None))),
    "seamless": dict(arch="seamless-m4t-medium", cut=dict(num_layers=2, num_encoder_layers=2),
                     batch=4, seq=256, frames=100, meshes=(((1, 2), None, None),)),
    "jamba": dict(arch="jamba-v0.1-52b", cut=dict(num_layers=len(JAMBA_PARITY),
                                                  layer_pattern=JAMBA_PARITY),
                  batch=2, seq=256, meshes=(((1, 2), None, None),), judged=2),
    "tinyllama_m8": dict(arch="tinyllama-1.1b", cut=dict(num_layers=2), batch=4, seq=256,
                         meshes=(((1, 8), None, None),)),
    "qwen2_m8": dict(arch="qwen2-7b", cut=dict(num_layers=2), batch=4, seq=256,
                     meshes=(((1, 8), None, None),)),
}
# the bf16 noise floor of an arm with ``judged`` steps: its unsharded run
# again with each row-parallel product (the nn.Linear layers a (1, 2) mesh
# cuts on their input dim) summed from two halves of that dim, each half's
# product in this dtype, the sum in fp32 and rounded once (bf16: the
# rounding of the (1, 2) mesh's train mode; fp32: of its serving partials).
# Both are sound: their drift from the unsharded run is rounding alone
TRAIN_MESH_NOISE = ("bfloat16", "float32")
# the fp32 arms, TF32 off: each family at full width cut to 2 layers (seamless
# 1 + 1; jamba a Mamba1 layer, then attention with the MoE), on (1, 2) but where
# ``meshes`` says, B 2 S 256 and one step but where ``shapes`` gives (B, S,
# steps); each rank's gradient of each leaf against its piece of the unsharded
# gradient, within ``tol`` of that leaf's largest |value|, the pad rows exactly
# 0. jamba takes no step: its fp32 weights, gradients, gradient pieces and AdamW
# moments would take ~35 GiB on each of the two ranks, ~70 of the card's 79 together
TRAIN_MESH_FP32 = dict(cuts={"deepseek": dict(num_layers=2), "mamba2": dict(num_layers=2),
                             "seamless": dict(num_layers=1, num_encoder_layers=1),
                             "jamba": dict(num_layers=2, layer_pattern=("mamba", "attn")),
                             "qwen2_m8": dict(num_layers=2)},
                       meshes={"qwen2_m8": (1, 8)}, shapes={"jamba": (2, 128, 0),
                                                            "qwen2_m8": (2, 128, 1)},
                       batch=2, seq=256, frames=100, tol=1e-4)
# full tinyllama-1.1b, continuous FIFO, 8 requests, fp32 and bf16, on (2, 1)
# and (2, 2) against the unsharded run
# the mesh_families phase: the four families on two ranks of the one card
# (a model axis of 2); fp32 cut as ``families_cfg`` says, bf16 at full width,
# cut in depth to keep the whole run inside its time limit (deepseek 8 of 27
# layers, mamba2 16 of 64, jamba 8 of 32), seamless whole; generate's batch
# (B, S) in fp32, mamba2's odd rows
# LEFT-padded by gen_pad; the (B, S) prefill whose logits are compared;
# seamless's frames for both; the serve's max_new; the ranks' time limit
MESH_FAMILIES = dict(archs=("deepseek-v2-lite-16b", "mamba2-2.7b", "seamless-m4t-medium",
                            "jamba-v0.1-52b"),
                     fp32_cuts={"seamless-m4t-medium": dict(num_layers=2, num_encoder_layers=2),
                                "jamba-v0.1-52b": dict(num_layers=len(JAMBA_PARITY),
                                                       layer_pattern=JAMBA_PARITY)},
                     bf16_layers={"jamba-v0.1-52b": 8, "deepseek-v2-lite-16b": 8,
                                  "mamba2-2.7b": 16}, gen=(4, 64), gen_pad=24, gen_new=8,
                     logit_prompts=(4, 64), frames=100, max_new=16, world=2, timeout=600.0)
# the mesh_wide phase: the GQA stacks with 4 kv heads on eight ranks of the
# one card (a model axis of 8, each kv head whole on 2 ranks, qwen2's query
# groups padded from 7 to 8 heads) and deepseek-v2-lite's 16 MLA heads (2 a
# rank: the MLA kernels at G = 2; 8 of its 64 experts a rank), fp32 cut to
# 2 layers, bf16 at full width cut to 8 layers (to keep the whole run inside
# its time limit; deepseek 8 of 27, as mesh_families cuts it); the rest as
# MESH_FAMILIES
MESH_WIDE = dict(MESH_FAMILIES, archs=("tinyllama-1.1b", "gemma2-2b", "qwen2-7b",
                                      "deepseek-v2-lite-16b"), fp32_cuts={},
                 bf16_layers={"tinyllama-1.1b": 8, "gemma2-2b": 8, "qwen2-7b": 8,
                              "deepseek-v2-lite-16b": 8}, world=8, timeout=600.0)
# A bf16 arm on a mesh against the unsharded bf16 arm, both held against the
# exact-fp32 route at the same weights and inputs (the bf16 weights cast up,
# the unsharded run's expert choices replayed): the sharded run rounds at the
# same points as the unsharded one (one bf16 rounding of each row-parallel
# sum, ``layers.row_linear``), so it should lie as far from fp32; this factor
# leaves room for the spread of a largest relative error between two equally
# noisy runs, and is exceeded by a run that rounds twice where the unsharded
# one rounds once (bf16 partials per rank, ~1.4-2x as far)
MESH_FP32_FACTOR = 1.5
# and, in the same spawns, the data axis's serving modes at full width: on
# (2, 1) the bucketed mode under the scheduler on tinyllama-1.1b and
# mamba2-2.7b (MESH_BUCKETED: buckets of 4 and 3 requests, so some batch is
# odd and its cache cut on its sequence), SPEC's tinyllama with its truncated
# draft (FIFO: a scheduler-less engine always speculates) and FLEET's replay
# of its first phone (the whole population's replays took ~30 s each); the
# bucketed tinyllama on (2, 2); FIFO tinyllama on (pod 2, data 2, model 1),
# the two 4-rank meshes in one spawn; and on (2, 2) deepseek-v2-lite-16b at
# full width cut to 2 layers, fp32, FIFO on an odd pool of 7 slots, so that
# its latent is cut on its sequence over both the model and the data ranks
# (4 pieces) and its decode merges at both levels
SERVE_MESH = dict(SERVE, names=("tinyllama-1.1b",), meshes=((2, 1), (2, 2), (2, 2, 1)),
                  dtypes=("float32", "bfloat16"), timeout=900.0,
                  arms={(2, 1): ("fifo", "bucketed tinyllama-1.1b", "bucketed mamba2-2.7b",
                                 "spec", "fleet"),
                        (2, 2): ("fifo", "bucketed tinyllama-1.1b",
                                 "fifo_odd deepseek-v2-lite-16b"), (2, 2, 1): ("fifo",)},
                  arm_dtypes={"fifo_odd deepseek-v2-lite-16b": ("float32",)},
                  odd=dict(max_slots=7, num_layers=2))
MESH_BUCKETED = dict(requests=7, prompt_lens=(64, 200), max_new=8, max_slots=8, max_len=1024,
                     seed=0)
# the MLA kernels' piece mode (kernels and times phases): a 1024-row latent
# cut in 2 (a model axis of 2) and in 8 (mesh_wide's model axis of 8)
MLA_PIECES = (2, 8)
# the kernels and times phases' piece-mode shapes: tinyllama's and gemma2's
# heads, 8 rows at DECODE_POS over a cache of 2048 cut in 2 halves, and the
# odd bucket's (3 rows of tinyllama at MESH_BUCKETED's positions, 1024 in
# 2 halves: the second half holds no kept key)
PIECE_ODD = dict(pos=(64 + 7, 200 + 3, 200 + 7), Smax=1024)


def phase_yolo(torch, report):
    """yolo-v2-tiny (``models.convnet``) at 416x416, B 1 and 8, fp32 with
    TF32 off: the card's output against the port's CPU run on the same
    weights within 1e-4 of max |y|, finite, (B, 13, 13, 125); the device
    ms per batch (CUDA events, L2 flushed, median of 20) and the share of
    the card's fp32 peak that ``build_yolo_graph``'s FLOPs give."""
    import numpy as np

    from repro_torch.core.opgraph import build_yolo_graph
    from repro_torch.models import convnet
    cpu = convnet.init_yolo(YOLO["seed"], "cpu")
    card = convnet.init_yolo(YOLO["seed"], "cpu").to("cuda")
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for B in YOLO["batches"]:
        x = np.random.default_rng(B).standard_normal((B, YOLO["res"], YOLO["res"], 3)).astype(
            np.float32)
        want = convnet.apply_yolo(cpu, torch.from_numpy(x))
        xd = torch.from_numpy(x).cuda()
        got = convnet.apply_yolo(card, xd)
        torch.cuda.synchronize()
        err, scale = float((got.cpu() - want).abs().max()), float(want.abs().max())
        shape = tuple(got.shape)
        if shape != (B, 13, 13, 125) or not bool(torch.isfinite(got).all()) \
                or err > YOLO["tol"] * scale:
            raise SmokeFailure(f"yolo B={B}: shape {shape}, max abs err {err} of max |y| {scale}")
        ms = time_ms(torch, lambda: convnet.apply_yolo(card, xd), flush, iters=YOLO["iters"])
        flops = sum(n.flops for n in build_yolo_graph(B, YOLO["res"]).nodes)
        rows.append({"B": B, "shape": shape, "max_abs_err": err, "max_abs_y": scale,
                     "device_ms": ms, "gflop": flops / 1e9,
                     "fp32_peak_share": flops / (ms * 1e-3) / _cost().PEAK_FLOPS["float32"],
                     "card": report["smi"]})
        log(f"yolo B={B}: {shape}, {ms:.4f} ms per batch, {flops / 1e9:.2f} GFLOP "
            f"({flops / B / 1e9:.2f} an image), {rows[-1]['fp32_peak_share']:.3f} of the fp32 "
            f"peak, max abs err {err:.3g} of max |y| {scale:.4g}, on {report['smi']}")
    report["yolo"] = rows


def train_mesh_rank(rank, jobs, mesh):
    """One rank of a train_mesh spawn: each job through
    ``launch.sharded.train_rank`` on the card, with the MoE's assignments
    counted (``DropCounter``: this rank's experts' kept, every offered);
    a job that asks for its step-0 gradient ``pieces`` gets them held
    against the unsharded gradient here (``fp32_grad_check``), one rank
    at a time, since each builds the whole model."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.sharded import train_rank
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for job in jobs:
        with DropCounter(moe) as drops:
            res = train_rank(rank, [job], mesh, "cuda")[0]
        res["moe_kept"], res["moe_offered"] = int(drops.kept), drops.offered
        pieces = res.pop("pieces", None)
        if pieces is not None:
            for r in range(mesh[0] * mesh[1]):
                if r == rank:
                    res["fp32_check"] = fp32_grad_check(torch, job, pieces, rank, mesh)
                dist.barrier()
        del pieces
        out.append(res)
    return out


def fp32_grad_check(torch, job, pieces, rank, mesh):
    """The unsharded model of ``job`` (the very weights its shards are cut
    from) on the card: its loss and gradients on the global step-0 batch,
    each leaf cut to this rank's piece and held against the rank's synced
    gradient ``pieces``. Returns the loss, the number of leaves, the leaf
    whose largest |error| over its largest |gradient| is the worst, with
    that ratio, and the largest |value| in the rows and columns of the
    rank's pieces that hold pad heads (``ParamPlan.pad_rows``: 0 exactly)
    with the number of leaves that have them."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.sharded import pad_maxima
    from repro_torch.models.model import cut, cuts, init_params, train_params
    from repro_torch.sharding.context import ExecContext
    from repro_torch.sharding.placement import AxisSizes, plan_params
    from repro_torch.training.train_loop import batch_to_device, loss_and_grads
    cfg = job["cfg"]
    params = init_params(cfg, job["seed"], "cuda")
    train_params(params)
    data = SyntheticLM(cfg, DataConfig(batch=job["batch"], seq_len=job["seq"],
                                       seed=job["data_seed"], enc_frames=job["enc_frames"]))
    dev = next(params.parameters()).device
    loss, _, grads = loss_and_grads(params, cfg, batch_to_device(data.batch(0), dev))
    plan = plan_params(cfg, ExecContext(mesh=AxisSizes(data=mesh[0], model=mesh[1]),
                                        batch_axes=("data",), model_axis="model",
                                        fsdp=job.get("fsdp")))
    errs = {}
    for name, g in grads.items():
        want = cut(g, cuts(plan, name, rank)).float()
        scale = float(g.float().abs().max())
        errs[name] = float((pieces[name].float() - want).abs().max()) / max(scale, 1e-30)
    pads = pad_maxima({f"params.{n}": t for n, t in pieces.items()}, plan, rank)
    worst = max(errs, key=errs.get)
    del params, grads
    torch.cuda.empty_cache()
    return {"loss": float(loss), "worst_leaf": worst, "worst_rel_err": errs[worst],
            "leaves": len(errs), "pad_leaves": len(pads),
            "pad_max": max(pads.values(), default=0.0)}


def mesh_drop_share(ranks, job, M):
    """The drop share of one job's MoE: the assignments the model ranks of
    data rank 0 kept together, of those each of them was offered."""
    kept = sum(ranks[m][job]["moe_kept"] for m in range(M))
    offered = ranks[0][job]["moe_offered"]
    return 1.0 - kept / offered if offered else 0.0


def train_mesh_cfg(arch, cut, dtype="bfloat16"):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch), **cut, dtype=dtype, param_dtype=dtype)


def train_mesh_job(cfg, batch, seq, steps, frames=64, fsdp=None, plan=None, **kw):
    """A train_rank job on TRAIN_MESH's seed and learning-rate schedule."""
    from repro_torch.training.optimizer import OptConfig
    t = TRAIN_MESH
    oc = OptConfig(lr=t["lr"], warmup_steps=min(20, steps // 5), total_steps=steps)
    return dict(cfg=cfg, seed=t["seed"], data_seed=t["seed"], batch=batch, seq=seq,
                enc_frames=frames, steps=steps, oc=oc, fsdp=fsdp, plan=plan, **kw)


def split_row_parallel(params, cfg, dtype):
    """Make each row-parallel ``nn.Linear`` of the unsharded model
    ``params`` (one that a (1, 2) mesh cuts on its input dim) sum two
    products, one per half of its input dim, each in ``dtype``, the sum in
    fp32, rounded once to the activation dtype (TRAIN_MESH_NOISE). Returns
    how many layers were changed."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from repro_torch.sharding.context import ExecContext
    from repro_torch.sharding.placement import AxisSizes, plan_params
    dt = getattr(torch, dtype)
    plan = plan_params(cfg, ExecContext(mesh=AxisSizes(data=1, model=2), batch_axes=("data",),
                                        model_axis="model"))
    n = 0
    for name, mod in params.named_modules():
        if isinstance(mod, nn.Linear) and plan.dims.get(f"{name}.weight") == 1:
            def halves(x, mod=mod):
                k = x.shape[-1] // 2
                w = mod.weight.to(dt)
                y = (F.linear(x[..., :k].to(dt), w[:, :k]).float()
                     + F.linear(x[..., k:].to(dt), w[:, k:]).float()).to(x.dtype)
                return y if mod.bias is None else y + mod.bias
            mod.forward = halves
            n += 1
    return n


def train_mesh_refs(torch, jobs, noise=()):
    """The unsharded run on the card of each bf16 job (name -> job):
    name -> (history rows, its memory: the peak, what was held when the
    steps began (the weights, the AdamW moments, anything left over) and
    the weights' bytes), the train path's launches checked. The moments
    take twice the weights' bytes (the weights' dtype), the gradients
    once. With it, for each name in ``noise``, name -> {dtype: history
    rows} of the same run with each rounding of TRAIN_MESH_NOISE
    (``split_row_parallel``)."""
    import gc

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params, train_params
    from repro_torch.training.optimizer import init_opt_state
    out, floor = {}, {}
    for name, variant in [(n, None) for n in jobs] + [(n, v) for n in noise
                                                        for v in TRAIN_MESH_NOISE]:
        jb = jobs[name]
        cfg = jb["cfg"]
        data = SyntheticLM(cfg, DataConfig(batch=jb["batch"], seq_len=jb["seq"],
                                           seed=jb["data_seed"], enc_frames=jb["enc_frames"]))
        params = init_params(cfg, jb["seed"], "cuda")
        split = variant is not None and split_row_parallel(params, cfg, variant)
        if variant is not None and not split:
            raise SmokeFailure(f"train_mesh {name}: no row-parallel layer to split")
        named = train_params(params)
        state = init_opt_state(named)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        hist, state, launches, peak = train_run(torch, cfg, params, data, jb["steps"],
                                                jb["oc"], state=state)
        if variant is None:
            train_checks(f"train_mesh unsharded {name}", hist, launches)
            out[name] = (hist, {"peak_mem_bytes": peak, "base_mem_bytes": base,
                                "param_bytes": sum(p.numel() * p.element_size()
                                                   for p in named.values())})
        else:
            train_checks(f"train_mesh unsharded {name} ({variant} halves)", hist, launches)
            floor.setdefault(name, {})[variant] = hist
            log(f"train_mesh unsharded {name}, {split} row-parallel layers in {variant} halves: "
                f"losses {[h['loss'] for h in hist]}, grad norms "
                f"{[h['grad_norm'] for h in hist]}")
        del params, named, state
        gc.collect()
        torch.cuda.empty_cache()
    return out, floor


def rel_drift(hist, ref):
    """Each step's relative loss and grad-norm distance of ``hist`` from
    ``ref`` (history rows)."""
    return {"loss": [abs(a["loss"] - h["loss"]) / abs(h["loss"]) for a, h in zip(hist, ref)],
            "grad_norm": [abs(a["grad_norm"] - h["grad_norm"]) / abs(h["grad_norm"])
                          for a, h in zip(hist, ref)]}


def mesh_arm_row(label, ranks, j, job, ref, judged=None, floor=None):
    """One job of a spawn: its checks (finite, no kernel launched, every
    rank the same losses, each step's loss and grad norm within
    TRAIN_MESH_TOL of the unsharded run ``ref``'s history, but only the
    first ``judged`` steps where that is given, the pad heads' rows and
    columns of every param and moment exactly 0 after the steps) and its
    row, with each step's drift and, from ``floor`` (dtype -> history
    rows of the unsharded run with another rounding), the noise floor's,
    which must lie inside TRAIN_MESH_TOL on every judged step. The
    collectives are those of the last step, or of the step-0 gradient
    pass of a job that takes no step."""
    for rank, r in enumerate(ranks):
        train_checks(f"{label} rank {rank}", r[j]["history"], r[j]["launches"])
        if r[j]["pad_max"]:
            raise SmokeFailure(f"{label} rank {rank}: a pad head's row or column is "
                               f"{r[j]['pad_max']} after the steps, not 0")
    if len({tuple(h["loss"] for h in r[j]["history"]) for r in ranks}) != 1:
        raise SmokeFailure(f"{label}: the ranks report other losses")
    hist = ranks[0][j]["history"]
    row = {"losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
           "step_s": [h["step_s"] for h in hist],
           "warm_step_s": min((h["step_s"] for h in hist[1:]), default=None),
           "peak_mem_bytes": [r[j]["peak_mem_bytes"] for r in ranks],
           "base_mem_bytes": [r[j]["base_mem_bytes"] for r in ranks],
           "param_bytes": [r[j]["param_bytes"] for r in ranks],
           "collectives_per_step": (ranks[0][j]["collectives"]
                                    or [ranks[0][j].get("grad_collectives")])[-1],
           "pad_leaves": [r[j]["pad_leaves"] for r in ranks],
           "shards": [(r[j]["shard"], r[j]["data_shard"]) for r in ranks],
           "launches": ranks[0][j]["launches"], "fsdp": job["fsdp"], "plan": job.get("plan")}
    if ref is not None:
        row["drift"] = rel_drift(hist, ref)
        row["noise_floor"] = {dt: rel_drift(h, ref) for dt, h in (floor or {}).items()}
        for i, h in enumerate(ref[:judged]):
            if row["drift"]["loss"][i] > TRAIN_MESH_TOL["loss"] \
                    or row["drift"]["grad_norm"][i] > TRAIN_MESH_TOL["grad_norm"]:
                raise SmokeFailure(f"{label} step {i}: loss {row['losses'][i]} vs {h['loss']}, "
                                   f"grad norm {row['grad_norms'][i]} vs {h['grad_norm']}")
            for dt, d in row["noise_floor"].items():
                if d["loss"][i] > TRAIN_MESH_TOL["loss"] \
                        or d["grad_norm"][i] > TRAIN_MESH_TOL["grad_norm"]:
                    raise SmokeFailure(f"{label} step {i}: the unsharded run with {dt} halves "
                                       f"drifts {d['loss'][i]} / {d['grad_norm'][i]}, so "
                                       "TRAIN_MESH_TOL cannot judge this step")
        row["max_rel_loss_diff"] = max(row["drift"]["loss"])
        row["max_rel_grad_norm_diff"] = max(row["drift"]["grad_norm"])
    return row


def train_mesh_arms():
    """The train_mesh phase's bf16 jobs by name (tinyllama and each of
    TRAIN_MESH_FAMILIES, with the meshes each runs on) and its fp32 jobs
    by name, each with its mesh."""
    from repro_torch.configs.base import get_config
    t = TRAIN_MESH
    tiny = dataclasses.replace(get_config(t["arch"]), num_layers=t["layers"])
    arms = {"tinyllama": (train_mesh_job(tiny, t["batch"], t["seq"], t["steps"]),
                          tuple((mesh, fsdp, None) for mesh, fsdp in t["meshes"]))}
    for name, f in TRAIN_MESH_FAMILIES.items():
        arms[name] = (train_mesh_job(train_mesh_cfg(f["arch"], f["cut"]), f["batch"], f["seq"],
                                     t["steps"], f.get("frames", 64)), f["meshes"])
    p = TRAIN_MESH_FP32
    fp32 = {}
    for name, cut in p["cuts"].items():
        B, S, steps = p["shapes"].get(name, (p["batch"], p["seq"], 1))
        fp32[name] = (train_mesh_job(train_mesh_cfg(TRAIN_MESH_FAMILIES[name]["arch"], cut,
                                                    "float32"), B, S, steps, p["frames"],
                                     pieces=True), p["meshes"].get(name, (1, 2)))
    return arms, fp32


def phase_train_mesh(torch, report):
    """Sharded training on the (data, model) mesh, ranks on the one card
    (spawned by ``run_ranks``, one spawn per mesh), each arm 3 steps, bf16,
    remat "full", each step's loss and grad norm against the arm's
    unsharded run on the card (TRAIN_MESH_TOL; jamba's first two steps,
    each step printed beside the noise floor, TRAIN_MESH_NOISE), each rank's peak memory
    (beside what it held at the first step and its weights' bytes),
    collectives per step and warm step time printed: tinyllama-1.1b at
    full width, 4 of 22 layers (B 8, S 512) on (2, 1) with FSDP, (1, 2)
    and (2, 2) with FSDP; deepseek-v2-lite (MLA, 2 of 27 layers)
    expert-parallel on (1, 2) and with the 2-D MoE on (2, 2), its drop
    share printed; mamba2-2.7b (4 of 64 layers) on (1, 2) and on (2, 2)
    with FSDP; seamless-m4t-medium (2 + 2 layers) on (1, 2); jamba-v0.1-52b
    (JAMBA_PARITY's 3 layers: Mamba1, Mamba1 with the MoE, attention)
    expert-parallel on (1, 2); tinyllama-1.1b and qwen2-7b (2 layers) on
    eight ranks, (1, 8): kv heads on 2 ranks each, qwen2's groups padded
    from 7 to 8 heads, whose pad rows and columns must stay exactly 0 in
    every param and moment. An fp32 arm of each family (2 layers, seamless
    1 + 1, jamba Mamba1 then attention with the MoE; TF32 off) on (1, 2),
    qwen2's on (1, 8) (TRAIN_MESH_FP32): each rank's gradient of each leaf
    within TRAIN_MESH_FP32's tol of the unsharded gradient's largest
    |value|, its pad rows exactly 0, the loss the unsharded model's. The tinyllama checkpoint
    (2, 2) saves is restored on no mesh into the very pieces each rank
    held, bit for bit (SHA-1 of each rank's pieces of every param and
    moment). The train path launches no hand-written kernel."""
    import gc
    import tempfile

    from repro_torch.launch.sharded import piece_digests, run_ranks
    from repro_torch.models.model import cut, cuts, init_params, train_params
    from repro_torch.sharding.context import ExecContext
    from repro_torch.sharding.placement import AxisSizes, plan_params
    from repro_torch.training.checkpoint import leaves, param_name, restore_checkpoint
    from repro_torch.training.optimizer import init_opt_state
    t = TRAIN_MESH
    arms, fp32 = train_mesh_arms()
    judged = {name: f["judged"] for name, f in TRAIN_MESH_FAMILIES.items() if "judged" in f}
    refs, floors = train_mesh_refs(torch, {name: jb for name, (jb, _) in arms.items()},
                                   noise=tuple(judged))
    out = {"unsharded": {name: {"losses": [h["loss"] for h in hist],
                                "grad_norms": [h["grad_norm"] for h in hist],
                                "warm_step_s": min(h["step_s"] for h in hist[1:]),
                                **mem}
                         for name, (hist, mem) in refs.items()},
           "card": report["smi"]}
    for name, row in out["unsharded"].items():
        log(f"train_mesh unsharded {name}: losses {row['losses']}, grad norms "
            f"{row['grad_norms']}, warm step {row['warm_step_s']:.3f} s, peak "
            f"{row['peak_mem_bytes'] / 2**30:.2f} GiB (held at the first step "
            f"{row['base_mem_bytes'] / 2**30:.2f}, weights {row['param_bytes'] / 2**30:.2f}), "
            f"on {report['smi']}")
    meshes = []
    for _, ms in arms.values():
        meshes += [m[0] for m in ms if m[0] not in meshes]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_ckpt_") as tmp:
        for mesh in meshes:
            D, M = mesh
            names, jobs = [], []
            for name, (jb, ms) in arms.items():
                for m, fsdp, plan in ms:
                    if m == mesh:
                        extra = dict(save=tmp, digest=True) if name == "tinyllama" and \
                            mesh == (2, 2) else {}
                        names.append(name)
                        jobs.append(dict(jb, fsdp=fsdp, plan=plan, **extra))
            for n, (jb, m) in fp32.items():
                if m == mesh:
                    names.append(f"{n} fp32")
                    jobs.append(jb)
            t0 = time.perf_counter()
            ranks = run_ranks(train_mesh_rank, D * M, (jobs, mesh), timeout=t["timeout"],
                              device_type="cuda")
            wall = time.perf_counter() - t0
            label = f"train_mesh {D}x{M}"
            rows = {}
            for j, (name, jb) in enumerate(zip(names, jobs)):
                if jb.get("pieces"):
                    rows[name] = row = mesh_arm_row(f"{label} {name}", ranks, j, jb, None)
                    row["fp32_grads"] = [r[j]["fp32_check"] for r in ranks]
                    for rank, c in enumerate(row["fp32_grads"]):
                        got = ranks[rank][j]["local_loss"]  # the global loss at D = 1
                        dl = abs(got - c["loss"]) / abs(c["loss"])
                        if c["worst_rel_err"] > TRAIN_MESH_FP32["tol"] or dl > 1e-5 \
                                or c["pad_max"] != 0.0:
                            raise SmokeFailure(f"{label} {name} rank {rank}: gradient of "
                                               f"{c['worst_leaf']} off by {c['worst_rel_err']} "
                                               f"of its largest, loss {got} vs {c['loss']}, "
                                               f"pad rows up to {c['pad_max']}")
                    continue
                rows[name] = mesh_arm_row(f"{label} {name}", ranks, j, jb, refs[name][0],
                                          judged.get(name), floors.get(name))
                if jb["cfg"].num_experts:
                    rows[name]["drop_share"] = mesh_drop_share(ranks, j, M)
                    if not all(h["aux"] > 0 for h in ranks[0][j]["history"]):
                        raise SmokeFailure(f"{label} {name}: aux loss not positive")
            if mesh == (2, 2):
                # the checkpoint on no mesh, cut into each rank's pieces
                cfg = arms["tinyllama"][0]["cfg"]
                params = init_params(cfg, t["seed"] + 1, "cuda")
                state = init_opt_state(train_params(params))
                if restore_checkpoint(tmp, params, state) != t["steps"]:
                    raise SmokeFailure(f"{label}: the checkpoint's step is not {t['steps']}")
                whole = leaves(params, state)
                plan = plan_params(cfg, ExecContext(mesh=AxisSizes(data=D, model=M),
                                                    batch_axes=("data",), model_axis="model",
                                                    fsdp=True))
                for rank, r in enumerate(ranks):
                    pieces = {n: cut(v, cuts(plan, param_name(n), rank))
                              for n, v in whole.items()}
                    if piece_digests(pieces) != r[names.index("tinyllama")]["digest"]:
                        raise SmokeFailure(f"{label}: rank {rank}'s pieces differ from the "
                                           "checkpoint restored on no mesh")
                rows["tinyllama"]["checkpoint_restored_bit_for_bit"] = True
                del params, state, whole
                gc.collect()
                torch.cuda.empty_cache()
            out[f"{D}x{M}"] = dict(rows, spawn_wall_s=wall)
            log(f"{label}: {json.dumps(rows)} (spawn wall {wall:.1f} s, on {report['smi']})")
            for name, row in rows.items():
                log(f"{label} {name}: warm step {row['warm_step_s']} s, collectives per step "
                    f"{row['collectives_per_step']}, peak per rank "
                    + ", ".join(f"{b / 2**30:.2f}" for b in row["peak_mem_bytes"])
                    + " GiB (held at the first step "
                    + ", ".join(f"{b / 2**30:.2f}" for b in row["base_mem_bytes"])
                    + ", weights "
                    + ", ".join(f"{b / 2**30:.2f}" for b in row["param_bytes"])
                    + f"), max rel loss / grad norm diff {row.get('max_rel_loss_diff')} / "
                    f"{row.get('max_rel_grad_norm_diff')}"
                    + (f", drift per step {row['drift']}, judged steps "
                       f"{judged[name]}, noise floor per step {row['noise_floor']}"
                       if name in judged else "")
                    + (f", leaves with pad rows (all 0) {row['pad_leaves']}"
                       if any(row["pad_leaves"]) else "")
                    + (f", fp32 grads {row['fp32_grads']}" if "fp32_grads" in row else "")
                    + f", on {report['smi']}")
    report["train_mesh"] = out


def mesh_bucketed_requests(cfg):
    """MESH_BUCKETED's (uid, prompt, max_new): 4 prompts of the first
    length, then 3 of the second."""
    import numpy as np
    b = MESH_BUCKETED
    rng = np.random.default_rng(b["seed"])
    per = -(-b["requests"] // len(b["prompt_lens"]))
    return [(i, rng.integers(1, cfg.vocab_size, b["prompt_lens"][i // per], dtype=np.int32),
             b["max_new"]) for i in range(b["requests"])]


def mesh_arm_job(arm, cfg):
    """The ``launch.sharded.serve_job`` / ``fleet_job`` job of a serve_mesh
    arm for ``cfg``'s dtype (weights drawn from the serve's seed)."""
    k = SERVE_MESH
    if arm == "fifo" or arm.startswith("fifo_odd"):
        return dict(cfg=cfg, seed=k["seed"], requests=serve_requests(cfg, k),
                    max_slots=k["odd"]["max_slots"] if arm != "fifo" else k["max_slots"],
                    max_len=k["max_len"])
    if arm.startswith("bucketed"):
        b = MESH_BUCKETED
        return dict(cfg=cfg, seed=k["seed"], requests=mesh_bucketed_requests(cfg),
                    max_slots=b["max_slots"], max_len=b["max_len"], mode="bucketed",
                    scheduled=True)
    if arm == "spec":
        return dict(cfg=cfg, seed=SPEC["seed"], draft="truncated", max_slots=SPEC["max_slots"],
                    max_len=SPEC["max_len"],
                    requests=spec_requests(cfg, SPEC["requests"], SPEC["prompt_lens"],
                                           SPEC["max_new"], SPEC["seed"]))
    f = FLEET
    return dict(cfg=cfg, seed=f["seed"], replay=dict(
        devices=1, population_seed=f["population_seed"], scenario=f["scenario"],
        duration_s=f["duration_s"], seed=f["seed"], calib_samples=f["calib_samples"],
        uncertainty=True, risk_level=f["risk_level"], max_slots=f["max_slots"]))


def mesh_arm_cfg(arm, dtype):
    from repro_torch.configs.base import get_config
    name = arm.split(" ")[1] if " " in arm else SERVE_MESH["names"][0]
    cut = dict(num_layers=SERVE_MESH["odd"]["num_layers"]) if arm.startswith("fifo_odd") else {}
    return dataclasses.replace(get_config(name), dtype=dtype, param_dtype=dtype, **cut)


def mesh_arm_dtypes(arm):
    """The dtypes a serve_mesh arm runs in: SERVE_MESH's, or its own."""
    return SERVE_MESH["arm_dtypes"].get(arm, SERVE_MESH["dtypes"])


@contextlib.contextmanager
def recording_served_gaps(torch, reqs):
    """Yields a dict that fills with the decision gaps (``record_gaps``
    with ``prefills`` and ``served``: first tokens, decode steps, verify
    rows, bucketed steps) of the one model that a ``ServingEngine`` built
    inside the block serves, so that a greedy serve's gaps are its own;
    unrecorded decisions are (None, None). ``ServingEngine.add_model`` is
    its own again after the block, and the dict holds no engine."""
    from repro_torch.serving.engine import ServingEngine
    plain_add = ServingEngine.add_model
    out = collections.defaultdict(lambda: (None, None))
    with contextlib.ExitStack() as stack:
        recorded = []

        def add_model(eng, name, *args, **kw):
            plain_add(eng, name, *args, **kw)
            recorded.append(stack.enter_context(record_gaps(torch, eng, reqs, 0.0, name,
                                                            prefills=True, served=True)))

        ServingEngine.add_model = add_model
        try:
            yield out
        finally:
            ServingEngine.add_model = plain_add
            for g in recorded:
                out.update(g)


def mesh_arm_ref(torch, arm, cfg):
    """The unsharded run of a serve_mesh arm on the card (TF32 off): its
    ``serve_job`` / ``fleet_job`` result and, in bf16, the decision gaps of
    that very run (``recording_served_gaps``; the fleet's bf16 tokens are
    reported, not judged)."""
    import gc

    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.launch.sharded import fleet_job, serve_job
    from repro_torch.models.model import init_params
    from repro_torch.sharding.context import ExecContext
    job = mesh_arm_job(arm, cfg)
    gaps = None
    with exact_fp32():
        params = init_params(cfg, job["seed"], "cuda")
        if "replay" in job:
            ref = fleet_job(dict(job, params=params), ExecContext(), "cuda")
        else:
            with (recording_served_gaps(torch, job["requests"]) if cfg.dtype == "bfloat16"
                  else contextlib.nullcontext()) as gaps:
                ref = serve_job(dict(job, params=params), ExecContext(), "cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ref, gaps


def mesh_launch_check(label, cfg, got, odd, M=1):
    """A rank's launches against its passes: flash once per attention layer
    per prefill and verify (the truncated draft's one layer per draft
    prefill and catch-up), decode or its piece mode once per attention layer
    per single-token pass, the SSD scan once per layer per prefill of an SSD
    stack; the piece mode launched where a cache was cut on its sequence
    (``odd``), and only there. An MLA stack at a model axis of ``M`` > 1
    (its latent cut on its sequence over the model ranks): the MLA piece
    mode once per attention layer per single-token pass, the whole-cache
    MLA and decode kernels never, and one kv-group merge per launch."""
    from repro_torch.sharding.context import kv_group_size
    n, L = attention_layers(cfg), got["launches"]
    if "calls" in got:  # a fleet replay: each device engine's worker
        p, d, v = (sum(c[i] for c in got["calls"]) for i in range(3))
        dp = dd = dv = 0
    else:
        p, d, v = got["prefill_calls"], got["decode_calls"], got["verify_calls"]
        dp, dd, dv = got["draft_calls"] or (0, 0, 0)
    ssd = "ssd" in cfg.layer_kinds()
    want_flash = n * (p + v) + dp + dv
    want_dec = n * d + dd
    mla = cfg.use_mla and M > 1
    kv = want_dec if kv_group_size(cfg, M) > 1 else 0
    ok = (L["flash_attention"] == want_flash and L["mla_attention"] == 0
          and L["decode_attention"] + L["decode_attention_piece"] == (0 if mla else want_dec)
          and L["mla_attention_piece"] == (want_dec if mla else 0)
          and L["ssd_scan"] == (cfg.num_layers * p if ssd else 0)
          and (L["decode_attention_piece"] > 0) == (odd and n > 0 and not mla)
          and got.get("kv_merges", 0) == kv)
    if not ok:
        raise SmokeFailure(f"{label}: launches {L}, kv-group merges {got.get('kv_merges')}; "
                           f"expected flash {want_flash}, "
                           + (f"MLA piece {want_dec}" if mla else
                              f"decode + piece {want_dec}, piece {'> 0' if odd and n else '0'}")
                           + f", ssd {cfg.num_layers * p if ssd else 0}, kv-group merges {kv}")


def mesh_pool_check(label, arm, D, got):
    """A rank's slot pools hold only its own rows, ``max_slots / D``,
    where D divides the slots, and every row (the cache cut on its
    sequence) where it does not; the bucketed mode keeps no pool."""
    slots = (SERVE_MESH["odd"]["max_slots"] if arm.startswith("fifo_odd") else
             {"fifo": SERVE_MESH["max_slots"], "spec": SPEC["max_slots"],
              "fleet": FLEET["max_slots"]}.get(arm))
    if slots is None:
        ok = got["pool_rows"] is None
    else:
        want = slots // D if slots % D == 0 else slots
        rows = got["pool_rows"] if arm == "fleet" else [got["pool_rows"]]
        ok = bool(rows) and all(r == want for r in rows)
    if not ok:
        raise SmokeFailure(f"{label}: pool rows {got['pool_rows']}, expected "
                           + ("none" if slots is None else str(want)))


def mesh_arm_check(label, arm, cfg, mesh, rank, got, ref, gaps):
    """One rank's arm against its unsharded run: no error, the tokens per
    uid equal (fp32) or apart only from a printed near-tie of the unsharded
    decisions (bf16, ``token_check``; a fleet's bf16 tokens are reported,
    its report must equal the unsharded one in both dtypes), the bucketed
    batches equal, the launches as the passes imply, the slot pools the
    rank's rows (``mesh_pool_check``). Returns its row."""
    from types import SimpleNamespace

    import numpy as np
    D = int(np.prod(mesh[:-1]))
    exact = cfg.dtype == "float32"
    if arm == "fleet":
        if got["report"] != ref["report"]:
            raise SmokeFailure(f"{label}: the fleet report differs from the unsharded one")
        diverged = 0
        for dev, (mine, want) in enumerate(zip(got["tokens"], ref["tokens"])):
            diverged += token_check(
                f"{label} device {dev}", [SimpleNamespace(uid=u, tokens=t) for u, t in mine.items()],
                [SimpleNamespace(uid=u, tokens=t) for u, t in want.items()],
                collections.defaultdict(lambda: (None, None)), exact, report_only=not exact,
                names=("meshed", "unsharded"))
        odd = False
    else:
        if got["errors"]:
            raise SmokeFailure(f"{label}: errors {got['errors']}")
        if got["batches"] != ref["batches"]:
            raise SmokeFailure(f"{label}: batches {got['batches']}, unsharded {ref['batches']}")
        diverged = token_check(label, [SimpleNamespace(uid=u, tokens=np.asarray(t))
                                       for u, t in got["tokens"].items()],
                               [SimpleNamespace(uid=u, tokens=np.asarray(t))
                                for u, t in ref["tokens"].items()],
                               gaps or collections.defaultdict(lambda: (None, None)), exact,
                               names=("meshed", "unsharded"))
        odd = any(b % D for b in got["batches"])
        if arm == "spec" and got["spec"] != ref["spec"] and exact:
            raise SmokeFailure(f"{label}: spec counters {got['spec']}, unsharded {ref['spec']}")
    mesh_launch_check(label, cfg, got, odd, mesh[-1])
    mesh_pool_check(label, arm, D, got)
    row = {"launches": got["launches"], "merges": got["merges"],
           "kv_merges": got.get("kv_merges"), "diverged_uids": diverged, "wall_s": got["wall_s"]}
    for key in ("prefill_calls", "decode_calls", "verify_calls", "batches", "spec",
                "peak_mem_bytes", "shard", "pool_rows"):
        if key in got:
            row[key] = got[key]
    return row


def serve_mesh_rank(rank, plan, device="cuda"):
    """One rank of a serve_mesh spawn: for each (mesh shape, jobs) of
    ``plan``, the engines of ``launch.sharded.engine_rank`` on that mesh
    (every mesh of the plan has the spawn's number of ranks)."""
    from repro_torch.launch.sharded import engine_rank
    return [engine_rank(rank, jobs, mesh, device) for mesh, jobs in plan]


def phase_serve_mesh(torch, report):
    """Data-parallel serving on the card, ranks sharing the one card over
    gloo, one spawn per world size (the two 4-rank meshes share one), every
    arm in fp32 then bf16 (SERVE_MESH): full tinyllama-1.1b continuous
    FIFO, 8 requests, on (2, 1), (2, 2) and (pod 2, data 2, model 1), each
    rank holding 8 / D of the slots; on (2, 1) the bucketed mode under the
    scheduler on full tinyllama-1.1b and mamba2-2.7b (MESH_BUCKETED; an
    odd batch's cache cut on its sequence over the data axis, its decode
    through the piece mode and one merge per attention layer per step),
    full tinyllama with its truncated draft and FLEET's replay of its
    first phone; the bucketed tinyllama on (2, 2), and there deepseek-v2-lite
    (2 layers, fp32) FIFO on an odd pool of 7 slots: its latent cut in 4
    pieces over the model and data ranks, decoded by the MLA piece mode and
    merged over the kv group, then the data group. Each arm first runs
    unsharded on the card (``mesh_arm_ref``); every rank's tokens
    equal its tokens in fp32, or each divergence sits at a near-tie of its
    own decision in bf16 (``token_check``); each rank's flash, decode and
    piece launches match its passes (printed). The piece launches of rank
    0's bucketed tinyllama bf16 on (2, 1) are the kernels line's."""
    import gc

    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.launch.sharded import run_ranks
    k = SERVE_MESH
    build.load_library()
    refs = {}
    for arm in dict.fromkeys(a for arms in k["arms"].values() for a in arms):
        for dt in mesh_arm_dtypes(arm):
            cfg = mesh_arm_cfg(arm, dt)
            t0 = time.perf_counter()
            refs[(arm, dt)] = (cfg,) + mesh_arm_ref(torch, arm, cfg)
            log(f"serve_mesh unsharded {arm} {dt}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": report["smi"],
           "unsharded": {f"{a} {dt}": {key: r[1].get(key) for key in
                                       ("launches", "wall_s", "batches", "spec", "merges")}
                         for (a, dt), r in refs.items()}}
    arms = {mesh: [(a, dt) for a in k["arms"][mesh] for dt in mesh_arm_dtypes(a)]
            for mesh in k["meshes"]}
    for world in dict.fromkeys(int(np.prod(m)) for m in k["meshes"]):
        meshes = [m for m in k["meshes"] if int(np.prod(m)) == world]
        plan = [(m, [mesh_arm_job(a, refs[(a, dt)][0]) for a, dt in arms[m]]) for m in meshes]
        t0 = time.perf_counter()
        ranks = run_ranks(serve_mesh_rank, world, (plan, "cuda"), timeout=k["timeout"],
                          device_type="cuda")
        wall = time.perf_counter() - t0
        for i, mesh in enumerate(meshes):
            name = "x".join(map(str, mesh))
            rows = {}
            for j, (arm, dt) in enumerate(arms[mesh]):
                cfg, ref, gaps = refs[(arm, dt)]
                rows[f"{arm} {dt}"] = [
                    mesh_arm_check(f"serve_mesh {name} {arm} {dt} rank {rank}", arm, cfg, mesh,
                                   rank, r[i][j], ref, gaps) for rank, r in enumerate(ranks)]
                if mesh == (2, 1) and arm == "bucketed tinyllama-1.1b" and dt == "bfloat16":
                    report["launches_serve_mesh"] = ranks[0][i][j]["launches"]
            out[name] = dict(rows, spawn_wall_s=wall)
            log(f"serve_mesh {name}: {json.dumps(rows)} (spawn of {world} ranks: wall {wall:.1f} "
                f"s, on {report['smi']})")
    report["serve_mesh"] = out


# ---------------------------------------------------------------------------
# the mesh_families phase: MLA, Mamba2, the encoder-decoder and the hybrid
# on a model axis of 2
# ---------------------------------------------------------------------------


def families_cfg(arch, dtype, spec=MESH_FAMILIES):
    """``arch`` in ``dtype``: fp32 at full width cut to 2 layers (or as
    ``spec["fp32_cuts"]`` says: seamless 2 + 2, jamba to JAMBA_PARITY, its
    attention layer and a Mamba1 layer with MoE), bf16 at full width (cut
    to ``spec["bf16_layers"]`` where named)."""
    from repro_torch.configs.base import get_config
    cut = (spec["fp32_cuts"].get(arch, dict(num_layers=2)) if dtype == "float32" else
           {"num_layers": spec["bf16_layers"][arch]} if arch in spec["bf16_layers"] else {})
    return dataclasses.replace(get_config(arch), **cut, dtype=dtype, param_dtype=dtype)


def families_job(cfg, spec=MESH_FAMILIES):
    """One arm's inputs, the same for the unsharded run and the ranks: the
    serve's requests (seamless's with frames from ``ENCDEC``), the prefill
    whose logits are compared, and in fp32 ``generate``'s batch (mamba2's
    rows 1 and 3 LEFT-padded under a pad mask, seamless with frames)."""
    import numpy as np
    k = spec
    rng = np.random.default_rng(3)
    enc = cfg.is_encoder_decoder

    def frames(n, t):
        return (rng.standard_normal((n, t, cfg.d_model)) * 0.1).astype(np.float32)

    if enc:
        reqs = spec_requests(cfg, ENCDEC["requests"], ENCDEC["prompt_lens"], k["max_new"],
                             SERVE["seed"])
        reqs = [r + (frames(1, int(rng.choice(ENCDEC["enc_lens"])))[0],) for r in reqs]
    else:
        reqs = serve_requests(cfg, dict(SERVE, max_new=k["max_new"]))
    B, S = k["logit_prompts"]
    job = dict(cfg=cfg, seed=SERVE["seed"], requests=reqs, gen_new=k["gen_new"],
               max_new=k["max_new"], max_enc_len=ENCDEC["max_enc_len"] if enc else None,
               logits=(rng.integers(1, cfg.vocab_size, (B, S), dtype=np.int32),
                       frames(B, k["frames"]) if enc else None))
    if cfg.dtype == "float32":
        B, S = k["gen"]
        prompts = rng.integers(1, cfg.vocab_size, (B, S), dtype=np.int32)
        mask = None
        if cfg.family == "ssm":
            mask = np.ones((B, S), bool)
            mask[1::2, :k["gen_pad"]] = False
            prompts[~mask] = 0
        job["gen"] = (prompts, mask, frames(B, k["frames"]) if enc else None)
    return job


def families_launches_expected(cfg, prefills, decodes, cut=False):
    """Each kernel's launches for ``prefills`` prefill and ``decodes``
    single-token passes of ``cfg`` (every prompt and encoder input longer
    than one position): flash per attention layer per prefill, the
    encoder-decoder's encoder and cross-attention included; decode per
    attention (and cross-attention) layer per step, or the MLA kernel for
    an MLA stack, in their piece modes where the rank's caches are cut on
    their sequence over its kv group (``cut``) and the whole-cache kernels
    never; the SSD scan per Mamba2 layer per prefill (Mamba1 runs no
    kernel)."""
    n_attn = attention_layers(cfg)
    per_pass = n_attn * (2 if cfg.is_encoder_decoder else 1)
    enc = cfg.num_encoder_layers if cfg.is_encoder_decoder else 0
    dec = 0 if cfg.use_mla else per_pass * decodes
    mla = n_attn * decodes if cfg.use_mla else 0
    return {"flash_attention": (per_pass + enc) * prefills,
            "decode_attention": 0 if cut else dec, "decode_attention_piece": dec if cut else 0,
            "ssd_scan": sum(k == "ssd" for k in cfg.layer_kinds()) * prefills,
            "mla_attention": 0 if cut else mla, "mla_attention_piece": mla if cut else 0}


@contextlib.contextmanager
def forced_tokens(eng, name, want):
    """Feed the engine's worker ``name`` the tokens ``want`` (uid -> the
    unsharded run's greedy tokens) in place of its own greedy choices, at
    the first token (``group_tokens``) and at every decode step
    (``decode_pool``), so that each pass sees the unsharded run's inputs.
    Yields the list of (uid, token index, own choice, fed token) where its
    own choice differed; the worker's methods are back after the block."""
    w = eng.workers[name]
    decode, group = w.decode_pool, w.group_tokens
    differ = []

    def pick(seq, own):
        ref = int(want[seq.req.uid][len(seq.tokens)])
        if int(own) != ref:
            differ.append((seq.req.uid, len(seq.tokens), int(own), ref))
        return ref

    def forced_decode(cache, tokens, pos, enc_len=None):
        nt, logits, cache = decode(cache, tokens, pos, enc_len=enc_len)
        nt = nt.copy()
        for seq in eng.pools[name].active.values():
            nt[seq.slot] = pick(seq, nt[seq.slot])
        return nt, logits, cache

    def forced_group(logits, slots, n_slots, choose):
        toks = group(logits, slots, n_slots, choose)
        active = eng.pools[name].active
        return [pick(active[int(s)], t) for s, t in zip(slots, toks)]

    w.decode_pool, w.group_tokens = forced_decode, forced_group
    try:
        yield differ
    finally:
        del w.decode_pool, w.group_tokens  # the methods of the worker's class again


def padded_head_check(torch, params, cfg, M, rank):
    """On model rank ``rank`` of M that holds zero heads of a padded kv
    group (``placement.PaddedHeads``): every layer's pad rows of ``wq`` and
    ``bq`` and pad columns of ``wo`` are 0, and through layer 0's attention
    (the kernels) a pad head's query is 0 and its share of the wo output is
    exactly 0. Returns (pad heads held, all of that holds)."""
    import torch.nn.functional as F

    from repro_torch.models import attention as att
    from repro_torch.sharding.placement import query_padding
    pad = query_padding(cfg, M) if cfg.num_kv_heads and not cfg.use_mla else None
    if pad is None:
        return 0, True
    ranges, n = pad.ranges(M, rank)
    lo, hi = ranges[0]
    if not n:
        return 0, True
    real = hi - lo
    ok = True
    for lp in params.layers:
        a = lp.attn
        ok = ok and not a.wq.weight[real:].any() and not a.wo.weight[:, real:].any()
        ok = ok and not (cfg.qkv_bias and a.bq[real:].any())
    a, dev = params.layers[0].attn, params.embedding.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 16, cfg.d_model, generator=gen, device=dev).to(params.embedding.dtype)
    q, k, v = att._project_qkv(a, x, cfg, torch.arange(16, device=dev).expand(2, 16))
    o = att.attend(q, k, v, causal=True)
    h0 = real // cfg.head_dim
    share = F.linear(o[:, :, h0:].reshape(2, 16, -1).float(), a.wo.weight[:, real:].float())
    ok = ok and not q[:, :, h0:].any() and not share.any()
    return n // cfg.head_dim, bool(ok)


def families_arm(torch, job, ctx, device="cuda"):
    """One arm on ``ctx`` (no mesh: the unsharded run): the weights drawn
    as this rank's shard (a rank holding padded query heads checks them,
    ``padded_head_check``); in fp32 ``generate``; the prefill logits of
    ``job["logits"]``; then the continuous FIFO engine on the requests.

    The unsharded run records its router's choices in that prefill and in
    the serve, its decisions' top-2 gaps and, in bf16, that prefill's
    logits through the exact-fp32 route at the same weights (the bf16
    weights cast up after the serve), its choices replayed. A sharded bf16
    run replays the unsharded choices in both (``RouterReplay``: each flip
    of its own router recorded with the unsharded logit gap) and is fed the
    unsharded run's tokens in the serve (``forced_tokens``), so every pass
    sees the unsharded run's inputs and each decision where its own greedy
    choice differs is recorded. Returns tokens, logits, launches against
    their expected counts, the model axis's collectives per serve, the
    wall and the peak memory."""
    from contextlib import nullcontext

    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.workers import ModelWorker
    from repro_torch.sharding import collectives
    cfg = job["cfg"]
    sharded, bf16 = ctx.mesh is not None, cfg.dtype == "bfloat16"
    cut = ctx.kv_group(cfg) > 1  # the rank's caches cut on their sequence
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, job["seed"], device, ctx=ctx)
    res = {"init_s": time.perf_counter() - t0, "shard": params.shard,
           "pad_heads": (padded_head_check(torch, params, cfg, ctx.model_parallel,
                                           ctx.model_rank) if sharded else (0, True))}
    max_enc = job["max_enc_len"]
    if job.get("gen") is not None:
        prompts, mask, frames = job["gen"]
        w = ModelWorker(cfg.name, cfg, params, SERVE["max_len"], ctx)
        toks, launches = drive(w.generate, prompts=prompts, max_new=job["gen_new"],
                               enc_inputs=frames, pad_mask=mask)
        res["gen"] = {"tokens": toks.tolist(), "launches": launches,
                      "expected": families_launches_expected(cfg, w.prefill_calls,
                                                             w.decode_calls, cut)}
        del w

    def replaying(routes, step):
        replay, dev = RouterReplay(moe), params.embedding.device
        if sharded and routes is not None:
            replay.plain = [(torch.as_tensor(p, device=dev), torch.as_tensor(i, device=dev))
                            for p, i in routes]
            replay.mode, replay.step = "sharded", step
        return replay

    replay = replaying(job.get("routes"), "prefill")
    w = ModelWorker(cfg.name, cfg, params, SERVE["max_len"], ctx, max_enc_len=max_enc)
    with replay, layer_tap() as taps:
        logits = w.prefill_batch(*job["logits"])[0]
    res["logits"] = logits.float().cpu().numpy()
    res["logit_flips"] = list(replay.flips)
    routes = replay.plain
    if bf16 and not sharded:  # each layer call's input and output
        res["layer_io"] = [(x.cpu(), y.cpu()) for x, y in taps]
    del taps
    if bf16 and sharded:  # the same prefill, each layer fed the unsharded run's input
        dev = params.embedding.device
        replay = replaying(job.get("routes"), "layer")
        with replay, layer_tap([x for x, _ in job["layer_io"]]) as taps:
            w.prefill_batch(*job["logits"])
        res["layer_flips"] = list(replay.flips)
        res["layer_dist"] = [row_dist(y, ref.to(dev))
                             for (_, y), (_, ref) in zip(taps, job["layer_io"])]
        del taps
    del w, logits
    eng = ServingEngine(max_slots=SERVE["max_slots"])
    eng.add_model(cfg.name, cfg, params, max_len=SERVE["max_len"], ctx=ctx, max_enc_len=max_enc)
    w = eng.workers[cfg.name]
    calls = collectives.all_reduce.calls, collectives.all_gather_last.calls
    kv_merges = collectives.counts["merge_kv_group"]
    serve_replay = replaying(job.get("serve_routes"), "serve")
    force = sharded and bf16
    with (record_gaps(torch, eng, job["requests"], 0.0, prefills=True) if not sharded
          else nullcontext()) as gaps:
        with serve_replay, (forced_tokens(eng, cfg.name, job["ref_tokens"]) if force
                            else nullcontext()) as differ:
            resp, launches, wall, peak = spec_run(torch, eng, job["requests"], False, 0.0)
        passes = w.prefill_calls, w.decode_calls
        if not sharded:
            res["gaps"] = dict(gaps)
            if serve_replay.plain:
                res["serve_routes"] = [(p.cpu().numpy(), i.cpu().numpy())
                                       for p, i in serve_replay.plain]
    res["forced"] = differ if force else None
    res["serve_flips"] = list(serve_replay.flips)
    res["serve"] = {"tokens": tokens_by_uid(resp),
                    "errors": [r.error for r in resp if r.error]
                    + [r.uid for r in resp if len(r.tokens) != job["max_new"]],
                    "launches": launches,
                    "expected": families_launches_expected(cfg, *passes, cut),
                    "prefill_calls": passes[0], "decode_calls": passes[1],
                    "kv_merges": collectives.counts["merge_kv_group"] - kv_merges,
                    "all_reduces": collectives.all_reduce.calls - calls[0],
                    "all_gathers": collectives.all_gather_last.calls - calls[1],
                    "wall_s": wall, "peak_mem_bytes": peak,
                    "sharded": None if w.shard_report is None else w.shard_report.sharded,
                    "pool": {n: list(t.shape) for n, t in eng.pools[cfg.name].cache.items()}}
    if sharded:  # what the rank holds against the dry run's count on the meta device
        from repro_torch.launch.dryrun import rank_bytes
        res["bytes"] = {"params": sum(p.numel() * p.element_size() for p in params.parameters()),
                        "cache": sum(t.numel() * t.element_size()
                                     for t in eng.pools[cfg.name].cache.values())}
        res["dryrun_bytes"] = rank_bytes(cfg, {"data": 1, "model": ctx.model_parallel},
                                         ctx.model_rank, SERVE["max_slots"], SERVE["max_len"],
                                         max_enc or 0)
    del eng, w, serve_replay, gaps  # the recorded gaps hold the engine
    if bf16 and not sharded:  # the exact-fp32 yardstick at the same weights
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        cast_up(params)
        params.cfg = cfg32
        torch.cuda.empty_cache()
        replay = RouterReplay(moe)
        replay.plain, replay.mode, replay.step = routes, "sharded", "fp32"
        w = ModelWorker(cfg.name, cfg32, params, SERVE["max_len"], ctx, max_enc_len=max_enc)
        with exact_fp32(), replay:
            res["logits_fp32"] = w.prefill_batch(*job["logits"])[0].float().cpu().numpy()
        res["fp32_flips"] = [f[-1] for f in replay.flips]
        del w, replay
    if routes and not sharded:
        res["routes"] = [(p.cpu().numpy(), i.cpu().numpy()) for p, i in routes]
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del params, routes
    return res


def mesh_families_rank(rank, jobs, device="cuda", world=MESH_FAMILIES["world"]):
    """One rank of a mesh phase (its own process, gloo over CUDA tensors
    on the one card): ``families_arm`` on a (1, ``world``) mesh for every
    job, in turn, freeing the card between."""
    import gc

    import torch

    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.context import ExecContext
    ctx = ExecContext(mesh=make_debug_mesh(1, world), batch_axes=("data",), model_axis="model")
    out = []
    for job in jobs:
        with exact_fp32():
            out.append(families_arm(torch, job, ctx, device))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def judge_bf16_arm(label, ref, mine):
    """A sharded bf16 arm against the unsharded one: every decision where
    a rank's own greedy choice differed from the token it was fed must sit
    at a near-tie of the unsharded run (top-2 gap within MODEL_TOL_BF16 of
    its largest |logit|); with each layer fed the unsharded run's input and
    its expert choices replayed, no router flip past ROUTER_TIE; and the
    prefill logits at most MESH_FP32_FACTOR times as far from the
    exact-fp32 route as the unsharded run's. The flips of the free-running
    prefill and serve (27 layers of bf16 rounding apart in deepseek) are
    printed beside the unsharded run's own flips against exact fp32 in the
    same prefill. Returns the arm's numbers."""
    import numpy as np
    for uid, i, own, fed in mine["forced"]:
        gap, scale = ref["gaps"][(uid, i)]
        log(f"{label}: uid {uid} token {i}: own choice {own}, unsharded {fed}; unsharded "
            f"top-2 gap {gap} at largest |logit| {scale}")
        if gap is None or gap > MODEL_TOL_BF16 * scale:
            raise SmokeFailure(f"{label}: uid {uid} token {i} differs away from a near-tie "
                               f"(unsharded top-2 gap {gap}, largest |logit| {scale})")
    for st, r, left, took, margin in mine["layer_flips"]:
        log(f"{label}: router flip with the layer's input replayed, call row {r}: unsharded "
            f"{left} -> sharded {took}, unsharded logit gap {margin:.4g} (bound {ROUTER_TIE})")
    far = [f for f in mine["layer_flips"] if f[-1] > ROUTER_TIE]
    free = {"prefill": [f[-1] for f in mine["logit_flips"]],
            "serve": [f[-1] for f in mine["serve_flips"]]}
    own = ref.get("fp32_flips") or []
    f32 = ref["logits_fp32"]
    fscale = np.abs(f32).max(axis=-1, keepdims=True)
    dist = {"sharded": float((np.abs(mine["logits"] - f32) / fscale).max()),
            "unsharded": float((np.abs(ref["logits"] - f32) / fscale).max())}
    row = {"decisions_differing": len(mine["forced"]),
           "uids_differing": len({f[0] for f in mine["forced"]}),
           "layer_flips": len(mine["layer_flips"]), "layer_flips_past_tie": len(far),
           "layer_dist_max": max(mine["layer_dist"]), "layer_dist": [
               round(d, 5) for d in mine["layer_dist"]],
           **{f"free_flips_{k}": len(v) for k, v in free.items()},
           **{f"free_flips_{k}_past_tie": sorted(round(m, 4) for m in v if m > ROUTER_TIE)
              for k, v in free.items()},
           "unsharded_vs_fp32_flips_prefill": len(own),
           "unsharded_vs_fp32_flips_prefill_past_tie": sorted(
               round(m, 4) for m in own if m > ROUTER_TIE),
           "fp32_dist_sharded": dist["sharded"], "fp32_dist_unsharded": dist["unsharded"],
           "fp32_dist_ratio": dist["sharded"] / max(dist["unsharded"], 1e-30)}
    fault = (f"{len(far)} router flips past ROUTER_TIE ({ROUTER_TIE}) with the layers' inputs "
             "replayed" if far else
             f"prefill logits {dist['sharded']:.4g} from the exact-fp32 route, more than "
             f"{MESH_FP32_FACTOR} times the unsharded run's {dist['unsharded']:.4g}"
             if dist["sharded"] > MESH_FP32_FACTOR * dist["unsharded"] else None)
    if fault:
        log(f"{label}: {json.dumps(row)}")
        raise SmokeFailure(f"{label}: {fault}")
    return row


def mesh_phase(torch, report, key, spec):
    """A mesh phase (``phase_mesh_families``, ``phase_mesh_wide``): the
    parent builds the kernels and runs every arm of ``spec`` unsharded
    (``families_arm``), fp32 then bf16, freeing the card between; then one
    spawn of ``spec["world"]`` ranks (``launch.sharded.run_ranks``, gloo
    over CUDA tensors on the one card) runs every arm on a (1, world)
    mesh. fp32: ``generate``'s and the FIFO engine's greedy tokens equal
    the unsharded run's on every rank, prefill logits within MODEL_TOL of
    each row's largest |logit|. bf16: every request completes, the ranks
    agree bit for bit (logits, their own choices, router flips), and each
    arm is judged by ``judge_bf16_arm``. Every rank launches each kernel as
    its passes imply; printed per rank: launches, collectives per serve,
    wall and peak memory."""
    import gc
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.launch.sharded import run_ranks
    from repro_torch.sharding.context import ExecContext
    world = spec["world"]
    gc.collect()
    torch.cuda.empty_cache()
    build.load_library()  # built once here, before the ranks load it
    jobs, refs = [], []
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        for arch in spec["archs"]:
            job = families_job(families_cfg(arch, dtype, spec), spec)
            with exact_fp32():
                ref = families_arm(torch, job, ExecContext())
            refs.append(ref)
            jobs.append(dict(job, routes=ref.get("routes"), serve_routes=ref.get("serve_routes"),
                             ref_tokens=ref["serve"]["tokens"],
                             layer_io=ref.pop("layer_io", None)))
            gc.collect()
            torch.cuda.empty_cache()
    unsharded_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_families_rank, world, (jobs, "cuda", world), timeout=spec["timeout"],
                      device_type="cuda")
    spawn_wall = time.perf_counter() - t0
    out = {"card": report["smi"], "unsharded_wall_s": unsharded_wall, "spawn_wall_s": spawn_wall}
    for j, (job, ref) in enumerate(zip(jobs, refs)):
        cfg = job["cfg"]
        label = f"{key} {cfg.name} {cfg.dtype}"
        fp32 = cfg.dtype == "float32"
        mine = [r[j] for r in ranks]
        for rank, a in enumerate(mine):
            runs = [a["serve"]] + ([a["gen"]] if fp32 else [])
            if a["serve"]["errors"] or any(x["launches"] != x["expected"] for x in runs):
                raise SmokeFailure(f"{label} rank {rank}: errors {a['serve']['errors']}, "
                                   f"launches {[x['launches'] for x in runs]} (expected "
                                   f"{[x['expected'] for x in runs]})")
            if a["shard"] != (world, rank) or not a["pad_heads"][1]:
                raise SmokeFailure(f"{label} rank {rank}: holds the shard {a['shard']}, padded "
                                   f"heads (held, all zero) {a['pad_heads']}")
            if a["bytes"] != a["dryrun_bytes"]:
                raise SmokeFailure(f"{label} rank {rank}: holds {a['bytes']} bytes of "
                                   f"parameters and slot pool, the dry run counts "
                                   f"{a['dryrun_bytes']}")
            if (a["serve"]["tokens"] != mine[0]["serve"]["tokens"]
                    or not np.array_equal(a["logits"], mine[0]["logits"])
                    or a["forced"] != mine[0]["forced"]
                    or a["logit_flips"] != mine[0]["logit_flips"]
                    or a["serve_flips"] != mine[0]["serve_flips"]
                    or a.get("layer_flips") != mine[0].get("layer_flips")):
                raise SmokeFailure(f"{label}: rank {rank}'s tokens, logits, choices or router "
                                   "flips differ from rank 0's")
        if ref["serve"]["errors"] or ref["serve"]["launches"] != ref["serve"]["expected"]:
            raise SmokeFailure(f"{label} unsharded: errors {ref['serve']['errors']}, launches "
                               f"{ref['serve']['launches']}")
        from repro_torch.sharding.context import kv_group_size
        if kv_group_size(cfg, world) > 1:  # the caches cut over the kv group: the piece modes
            kind = "mla_attention" if cfg.use_mla else "decode_attention"
            piece = [a["serve"]["launches"][f"{kind}_piece"] for a in mine]
            per_step = attention_layers(cfg) * (2 if cfg.is_encoder_decoder else 1)
            merges = [(a["serve"]["kv_merges"], per_step * a["serve"]["decode_calls"])
                      for a in mine]
            whole = [a["serve"]["launches"][kind] for a in mine]
            if (min(piece) == 0 or len(set(piece)) != 1 or any(m != w for m, w in merges)
                    or any(whole)):
                raise SmokeFailure(f"{label}: piece launches per rank {piece}, kv-group merges "
                                   f"(got, attention layers x steps) {merges}, whole-cache "
                                   f"{kind} launches {whole}")
        lscale = np.abs(ref["logits"]).max(axis=-1, keepdims=True)
        lerr = float((np.abs(mine[0]["logits"] - ref["logits"]) / lscale).max())
        row = {"uids": len(ref["serve"]["tokens"]), "logits_max_rel_err": lerr,
               "pad_heads": [a["pad_heads"][0] for a in mine],
               "rank_bytes": mine[0]["bytes"], "rank_bytes_equal_dryrun": True}
        if fp32:
            if not all(a["gen"]["tokens"] == ref["gen"]["tokens"] for a in mine):
                raise SmokeFailure(f"{label}: generate's tokens differ from the unsharded run's")
            resp = [SimpleNamespace(uid=u, tokens=np.asarray(t))
                    for u, t in mine[0]["serve"]["tokens"].items()]
            plain = [SimpleNamespace(uid=u, tokens=np.asarray(t))
                     for u, t in ref["serve"]["tokens"].items()]
            row["diverged_uids"] = token_check(label, resp, plain, ref["gaps"], exact=True,
                                               names=("sharded", "unsharded"))
            if lerr > MODEL_TOL:
                raise SmokeFailure(f"{label}: prefill logits max rel err {lerr} (tolerance "
                                   f"{MODEL_TOL})")
        else:
            row.update(judge_bf16_arm(label, ref, mine[0]))
        row.update(unsharded={x: ref["serve"][x] for x in ("wall_s", "peak_mem_bytes",
                                                           "launches", "prefill_calls",
                                                           "decode_calls")},
                   ranks=dict({x: [a["serve"][x] for a in mine] for x in ("wall_s",
                                                                           "peak_mem_bytes")},
                              init_s=[a["init_s"] for a in mine],
                              arm_peak_mem_bytes=[a["peak_mem_bytes"] for a in mine],
                              gen_launches=mine[0].get("gen", {}).get("launches"),
                              **{x: mine[0]["serve"][x] for x in ("launches", "all_reduces",
                                                                  "all_gathers", "sharded",
                                                                  "pool")}))
        out[f"{cfg.name} {cfg.dtype}"] = row
        log(f"{label}: {json.dumps(row)}")
    launches = collections.Counter()
    for j, job in enumerate(jobs):
        if job["cfg"].dtype == "bfloat16":
            launches.update(ranks[0][j]["serve"]["launches"])
    report[f"launches_{key}"] = dict(launches)
    report[key] = out
    log(f"{key}: unsharded arms {unsharded_wall:.1f} s, {world} ranks {spawn_wall:.1f} s "
        f"(spawn included), on {report['smi']}")


def phase_mesh_families(torch, report):
    """MLA (deepseek-v2-lite-16b), Mamba2 (mamba2-2.7b), the encoder-decoder
    (seamless-m4t-medium) and the Mamba1 + attention + MoE hybrid
    (jamba-v0.1-52b) served on a model axis of 2 (``mesh_phase``): two
    ranks on the one card, each holding half the heads, inner channels and
    experts; fp32 exact, 2 layers (``families_cfg``), bf16 at full width
    (jamba cut to 8 layers), judged by ``judge_bf16_arm``: the unsharded
    run's expert choices replayed and its tokens fed, every differing
    decision at a near-tie, no router flip past ROUTER_TIE, the logits at
    most MESH_FP32_FACTOR times as far from exact fp32 as the unsharded
    run's. The MLA kernel runs at G = 8, the SSD scan on 40 heads."""
    mesh_phase(torch, report, "mesh_families", MESH_FAMILIES)


def phase_mesh_wide(torch, report):
    """tinyllama-1.1b (32 on 4 heads, 22 layers), gemma2-2b (8 on 4, D 256,
    softcap, sliding window, 26 layers) and qwen2-7b (28 on 4, D 128, qkv
    bias, 28 layers) served on a model axis of 8 (``mesh_phase``): eight
    ranks on the one card, each kv head whole on 2 ranks (rank m holds kv
    head m // 2), qwen2's groups of 7 query heads padded with a zero head
    to 8 (the ranks that hold one check it adds nothing); and
    deepseek-v2-lite-16b (MLA, 16 heads, 64 experts): 2 heads and 8 experts
    a rank, the latent whole on every rank. fp32 exact, 2 layers; bf16 at
    full width cut to 8 layers, judged as the mesh_families phase's bf16
    arms. Per rank flash runs on 4 on 1 (tinyllama, qwen2) or 1 on 1 heads
    (gemma2), decode at G = 4 or 1, the MLA kernels at G = 2 (launched on
    every rank, as many times on each). Each rank's parameter and slot-pool
    bytes equal the dry run's count for its shard (``launch.dryrun.
    rank_bytes``), here and in the mesh_families phase."""
    mesh_phase(torch, report, "mesh_wide", MESH_WIDE)


# the dryrun phase: the production mesh's dry run (launch.dryrun) of two
# pairs on (16, 16) on the meta device: deepseek's decode (16 MLA heads on a
# model axis of 16, the latent cut in 16: the MLA piece mode's meta route at
# G = 16) and tinyllama's 500k decode (B 1: the K/V cut on its sequence
# over 16 data ranks and each kv group of 4, the piece mode and the merges)
DRYRUN = (("deepseek-v2-lite-16b", "decode_32k"), ("tinyllama-1.1b", "long_500k"))


def phase_dryrun(torch, report):
    """``DRYRUN``'s pairs through ``launch.dryrun.run_one`` on the
    production (16, 16) mesh, on the meta device (no card memory): status
    ok, deepseek's MLA piece mode counted once per layer at G = 16 (the
    latent cut over the 16 model ranks), tinyllama's piece mode once per
    layer; printed per pair: the rank's argument and
    temp GiB, FLOPs, bytes, collective bytes, the kernels' counts and the
    wall."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    out = {}
    for arch, shape in DRYRUN:
        rec = dryrun.run_one(arch, shape, False, None)
        if rec["status"] != "ok":
            raise SmokeFailure(f"dryrun {arch} {shape}: {rec['status']} {rec.get('error')}")
        cfg = dryrun.config_for_shape(get_config(arch), shape)[0]
        kernel = "mla_attention_piece" if cfg.use_mla else "decode_attention_piece"
        if rec["kernels"].get(kernel, {}).get("calls") != cfg.num_layers:
            raise SmokeFailure(f"dryrun {arch} {shape}: kernels {rec['kernels']}, expected "
                               f"{kernel} once per layer ({cfg.num_layers})")
        out[f"{arch} {shape}"] = {k: rec[k] for k in (
            "argument_size_in_bytes", "temp_size_in_bytes", "flops", "bytes_accessed",
            "collective_bytes", "kernels", "hbm_fits", "ranks_differ", "total_s")}
        log(f"dryrun {arch} {shape} on (16, 16): {json.dumps(out[f'{arch} {shape}'])}")
    report["dryrun"] = out


# the collectives phase: an all-reduce among ranks that share the card, through
# gloo (host-staged) and through the card's memory (``collectives.SameCard``):
# (rows, cols) fp32 of a decode step's and of a prefill's partial sums, calls
COLLECTIVES = dict(worlds=(2, 8), sizes={"decode": ((8, 2048), 100),
                                         "prefill": ((4096, 2048), 10)}, timeout=300.0)


def collectives_rank(rank, world):
    """One rank of the collectives phase: the wall per all-reduce through
    gloo and through the same-card transport (each warmed up, between two
    barriers, the stream synchronised), and whether a sum of rank + 1 over
    the ranks came out right both ways."""
    import torch
    import torch.distributed as dist

    from repro_torch.sharding import collectives
    out = {}
    for name, (shape, n) in COLLECTIVES["sizes"].items():
        t = collectives.same_card(torch.empty(1, device="cuda"), None)
        for way, fn in (("gloo", dist.all_reduce), ("same_card", t.all_reduce)):
            x = torch.full(shape, float(rank + 1), device="cuda")
            fn(x)
            out[f"{way} {name} right"] = bool((x == world * (world + 1) / 2).all())
            x.zero_()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(n):
                fn(x)
            torch.cuda.synchronize()
            out[f"{way} {name} ms"] = (time.perf_counter() - t0) / n * 1e3
    return out


def phase_collectives(torch, report):
    """An all-reduce among 2 and 8 ranks on the one card (spawned, gloo
    process group): host-staged through gloo, and through the card's
    memory (``collectives.SameCard``, which the mesh phases take), fp32 at
    a decode step's (8, 2048) and a prefill's (4096, 2048); the wall per
    call on rank 0."""
    from repro_torch.launch.sharded import run_ranks
    out = {"card": report["smi"]}
    for world in COLLECTIVES["worlds"]:
        ranks = run_ranks(collectives_rank, world, (world,), timeout=COLLECTIVES["timeout"],
                          device_type="cuda")
        out[f"{world} ranks"] = ranks[0]
        if not all(v for r in ranks for k, v in r.items() if k.endswith("right")):
            raise SmokeFailure(f"collectives: a sum over {world} ranks came out wrong: {ranks}")
    report["collectives"] = out
    log(f"collectives: {json.dumps(out)}")


# each kernel's row of the times phase in the kernels line: (model, B, S)
LINE_ROWS = {"flash_attention": ("tinyllama", 8, 512), "decode_attention": ("tinyllama", 8, 2048),
             "ssd_scan": ("mamba2", 8, 512), "mla_attention": ("mla", 8, 1024),
             "decode_attention_piece": ("tinyllama", 8, 2048),
             "mla_attention_piece": ("mla", 8, 1024)}
# each kernel's count on the path of its own slice: attention on the FIFO
# serve path, the SSD scan on the scheduled path, the MLA attention on the
# scheduled deepseek-v2-lite-16b serve with its draft (the spec phase), the
# piece mode on rank 0 of the serve_mesh phase's bucketed tinyllama (2, 1),
# the MLA piece mode on rank 0 of the mesh_wide phase's bf16 arms (deepseek)
MAIN_PATH = {"flash_attention": "serve", "decode_attention": "serve", "ssd_scan": "scheduled",
             "mla_attention": "spec_deepseek", "decode_attention_piece": "serve_mesh",
             "mla_attention_piece": "mesh_wide"}


def kernels_line(report):
    rows = {r["kernel"]: r for r in report.get("timings", [])
            if (r["model"], r["B"], r["S"]) == LINE_ROWS[r["kernel"]] and "shape" not in r}
    paths = {p: report.get(f"launches_{p}", {})
             for p in ("scheduled", "joint", "spec", "spec_deepseek", "archs", "archs_fifo",
                       "encdec_hybrid", "bucketed", "fleet", "kimi", "train", "train_moe",
                       "mesh_families", "mesh_wide", "serve_mesh")}
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
           "fleet": phase_fleet, "kimi": phase_kimi, "mesh1": phase_mesh1,
           "shard2": phase_shard2, "train": phase_train, "profile_train": phase_profile_train,
           "yolo": phase_yolo, "train_mesh": phase_train_mesh, "serve_mesh": phase_serve_mesh,
           "mesh_families": phase_mesh_families, "mesh_wide": phase_mesh_wide,
           "dryrun": phase_dryrun,
           "profile_encdec_hybrid": phase_profile_encdec_hybrid,
           "profile_bucketed": phase_profile_bucketed, "profile_fleet": phase_profile_fleet,
           "profile": phase_profile,
           "profile_scheduled": phase_profile_scheduled, "profile_spec": phase_profile_spec,
           "profile_archs": phase_profile_archs,
           "profile_spec_deepseek": phase_profile_spec_deepseek,
           "mla_parts": phase_mla_parts, "parity_mamba2": phase_parity_mamba2,
           "collectives": phase_collectives}
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
