"""The port's dry run (``repro_torch.launch.dryrun``) and its op counter
(``repro_torch.utils.op_cost``) on the meta device, against the JAX
package's dry run.

One subprocess (``tools/dryrun_reference.py --json``) runs the JAX
package's ``build_lowered`` + ``analyse`` on a 2 x 2 host mesh (as
``tests/test_sharding.py``'s subprocess does) for tinyllama-1.1b at
``decode_32k`` and ``prefill_32k``; the port's dry run
of the same pairs on a (2, 2) stand-in mesh gives the same per-device
argument bytes, exactly, and FLOPs:

* decode: within ``DECODE_TOL`` (both attend over the whole cache at
  position S - 1);
* prefill: within ``PREFILL_TOL`` after two corrections by formula. The
  reference's XLA route multiplies the whole S x S score matrix, where the
  flash count keeps the causal pairs only: + B·L·S(S-1)/2·2·H·(Dk + Dv)
  (B the rank's rows, L the layers, H the rank's heads). And it applies
  the LM head at every position before keeping the last, where the port
  applies it at the last: + B·(S - 1)·2·d_model·V (V the rank's vocab).

deepseek-v2-lite-16b at ``decode_32k`` on the same mesh: FLOPs within
``DECODE_TOL``; its parameters' bytes equal the reference's shards'
(``params_shardings``); its cache holds the MLA latent cut on its
sequence over the model axis, all 576 columns (``sharding/placement.py``'s
docstring), at most the reference's shards' bytes (c_kv's columns cut,
k_rope whole), so the argument bytes are the reference's with that one
departure.

With the plan knob ``attn_seq_shard`` (which the JAX dry run lowers on
the same mesh, with the same FLOPs) the port's ``prefill_32k`` gives the
same argument bytes, and FLOPs within ``PREFILL_TOL`` once rank 0's
masked pairs (its half of the queries, every head, against all keys) are
added; outside the flash kernel its count is the count without the knob.

Then every arch at ``decode_32k`` on the (16, 16) production mesh, and
``train_4k`` / ``long_500k`` of several families and the (2, 16, 16)
mesh, run with status ``ok`` (seamless ``long_500k`` skipped with the
reference's note); gemma2's ``train_4k`` fits 80 GB a rank with the
vocabulary-cut loss; the knob's prefill on (16, 16); ``check_plan``; the
counter's units; each kernel wrapper's meta route
(the bound's formula, the card's refusals, no launch counted) and that CPU
tensors never take it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCHS, SHAPES, get_config, reduced
from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import mla_attention as mmod
from repro_torch.kernels import ssd_scan as smod
from repro_torch.launch import dryrun
from repro_torch.models import model as model_lib
from repro_torch.sharding import collectives
from repro_torch.sharding.context import ExecContext, MeshStandIn
from repro_torch.utils.op_cost import OpCost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE_TOL = 0.02
PREFILL_TOL = 0.02
MESH22 = {"data": 2, "model": 2}
META = "meta"

@pytest.fixture(scope="module")
def oracle():
    """The JAX package's numbers (``tools/dryrun_reference.py --json``), in
    a process of its own: its host device count is set before JAX loads."""
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join("tools", "dryrun_reference.py"), "--json",
                          "--plan", "attn_seq_shard"],
                         capture_output=True, env=env, text=True, cwd=REPO, timeout=300)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("ORACLE ")]
    assert lines, out.stderr[-3000:]
    return json.loads(lines[-1][len("ORACLE "):])


def _port(arch, shape, mesh):
    rec = dryrun.run_one(arch, shape, False, None, mesh_shape=mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    return rec


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_tinyllama_decode_matches_jax_dryrun(oracle):
    """Full tinyllama-1.1b ``decode_32k`` on 2 x 2: the same argument bytes
    (parameters, the cache's shards, the rank's tokens and the int32
    position), FLOPs within ``DECODE_TOL``."""
    want = oracle["tinyllama-1.1b decode_32k"]
    got = _port("tinyllama-1.1b", "decode_32k", MESH22)
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert _rel(got["flops"], want["flops"]) <= DECODE_TOL, (got["flops"], want["flops"])
    assert got["kernels"]["decode_attention"]["calls"] == 22


def test_tinyllama_prefill_matches_jax_dryrun_after_masked_pairs(oracle):
    """Full tinyllama-1.1b ``prefill_32k`` on 2 x 2: the same argument
    bytes; FLOPs within ``PREFILL_TOL`` once the masked score pairs and the
    LM head's other positions are added back (module docstring)."""
    want = oracle["tinyllama-1.1b prefill_32k"]
    got = _port("tinyllama-1.1b", "prefill_32k", MESH22)
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    cfg = get_config("tinyllama-1.1b")
    S, B, H = SHAPES["prefill_32k"].seq_len, SHAPES["prefill_32k"].global_batch // 2, 16
    masked = B * cfg.num_layers * S * (S - 1) // 2 * 2 * H * 2 * cfg.head_dim
    head = B * (S - 1) * 2 * cfg.d_model * cfg.padded_vocab // 2
    corrected = got["flops"] + masked + head
    assert _rel(corrected, want["flops"]) <= PREFILL_TOL, (corrected, want["flops"])
    assert _rel(got["flops"], want["flops"]) > PREFILL_TOL  # the correction is what closes it


def test_deepseek_decode_matches_jax_dryrun(oracle):
    """Full deepseek-v2-lite-16b ``decode_32k`` on 2 x 2: FLOPs within
    ``DECODE_TOL`` of the JAX dry run's; the parameters' bytes equal the
    reference's shards'; the cache's are the latent's rows of the rank's
    half of the batch and half of the sequence, all 576 columns (the
    port's layout), at most the reference's shards' (its c_kv cut on its
    columns, k_rope whole); the argument bytes are the reference's with
    that cache."""
    want = oracle["deepseek-v2-lite-16b decode_32k"]
    got = _port("deepseek-v2-lite-16b", "decode_32k", MESH22)
    assert _rel(got["flops"], want["flops"]) <= DECODE_TOL, (got["flops"], want["flops"])
    shards = oracle["deepseek-v2-lite-16b decode_32k shards"]
    cfg, shape = get_config("deepseek-v2-lite-16b"), SHAPES["decode_32k"]
    b = dryrun.rank_bytes(cfg, MESH22, 0, shape.global_batch, shape.seq_len)
    assert b["params"] == shards["params"]
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    assert b["cache"] == cfg.num_layers * shape.global_batch // 2 * shape.seq_len // 2 * width * 2
    assert b["cache"] <= shards["cache"]
    assert got["argument_size_in_bytes"] == (want["argument_size_in_bytes"] - shards["cache"]
                                             + b["cache"])
    tiny = oracle["tinyllama-1.1b decode_32k shards"]  # the oracle's two counts agree
    rows = SHAPES["decode_32k"].global_batch // 2
    assert tiny["params"] + tiny["cache"] + rows * 4 + 4 == \
        oracle["tinyllama-1.1b decode_32k"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_decodes_on_the_production_mesh(arch):
    """``decode_32k`` on (16, 16): status ok, the attention kernels counted
    once per attention layer, every collective result positive."""
    rec = dryrun.run_one(arch, "decode_32k", False, None)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 256 and rec["flops"] > 0 and rec["argument_size_in_bytes"] > 0
    cfg = get_config(arch)
    calls = sum(r["calls"] for k, r in rec["kernels"].items() if k != "ssd_scan")
    attn = sum(k in ("attn", "local", "global") for k in cfg.layer_kinds())
    assert calls == attn * (2 if cfg.is_encoder_decoder else 1)
    assert all(v["bytes"] > 0 for v in rec["collectives"].values())


def test_seamless_long_500k_is_skipped_with_the_reference_note():
    rec = dryrun.run_one("seamless-m4t-medium", "long_500k", False, None)
    assert rec["status"] == "skipped"
    assert rec["note"] == ("SKIP: enc-dec speech decoder has no sub-quadratic variant "
                           "(DESIGN.md)")


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("tinyllama-1.1b", "train_4k", False),
    ("seamless-m4t-medium", "train_4k", False),
    ("mamba2-2.7b", "long_500k", False),
    ("gemma2-2b", "long_500k", False),
    ("deepseek-v2-lite-16b", "long_500k", True),
    ("tinyllama-1.1b", "decode_32k", True),
])
def test_train_and_long_context_on_the_production_meshes(arch, shape, multi_pod):
    """Training (forward, backward, AdamW) and the 500k decode of several
    families, and the (2, 16, 16) mesh: status ok. At ``long_500k`` (B = 1)
    a K/V cache is cut on its sequence over the data group (the piece mode,
    merged over the ranks: one all-gather per attention layer), and over
    the kv group too where it is wider than 1; the MLA latent is cut on its
    sequence over every rank of the mesh (the data ranks times the model
    ranks), decoded through the MLA kernels' piece mode."""
    rec = dryrun.run_one(arch, shape, multi_pod, None)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == (512 if multi_pod else 256)
    cfg = dryrun.config_for_shape(get_config(arch), shape)[0]
    if shape == "train_4k":
        assert rec["kernels"] == {}  # train mode takes its differentiable route
        assert rec["alias_size_in_bytes"] > 0  # parameters and moments updated in place
    if shape == "long_500k" and cfg.family == "dense":
        n = sum(k in ("attn", "local", "global") for k in cfg.layer_kinds())
        assert rec["kernels"]["decode_attention_piece"]["calls"] == n
    if cfg.use_mla and shape == "long_500k":
        S, lr = SHAPES[shape].seq_len, cfg.kv_lora_rank + cfg.qk_rope_dim
        mesh = dryrun.production_shape(multi_pod)
        pieces = int(np.prod(list(mesh.values())))
        b = dryrun.rank_bytes(cfg, mesh, 0, SHAPES[shape].global_batch, S)
        assert b["cache"] == cfg.num_layers * -(-S // pieces) * lr * 2
        assert rec["kernels"]["mla_attention_piece"]["calls"] == cfg.num_layers


# ---- the plan knob attn_seq_shard ----------------------------------------------

SEQ = {"attn_seq_shard": True}


def test_check_plan_takes_attn_seq_shard_and_refuses_unknown_knobs():
    assert dryrun.check_plan(SEQ) == SEQ
    assert dryrun.check_plan(dryrun.parse_plan("attn_seq_shard,remat_policy=dots")) == \
        dict(SEQ, remat_policy="dots")
    with pytest.raises(ValueError, match="unknown plan knobs"):
        dryrun.check_plan({"attn_impl": "pallas"})
    with pytest.raises(ValueError, match="unknown plan knobs"):
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--plan",
                     "attn_seq_shard,seq_shard"])


def _seq_shard_pairs(n, S, H, head_dim):
    """The score pairs that the reference's XLA route multiplies and the
    flash count drops for rank 0 under the knob: its piece of n queries
    against all S keys, every head, keeping the causal n (n + 1) / 2."""
    return (n * S - n * (n + 1) // 2) * 2 * H * 2 * head_dim


def test_attn_seq_shard_prefill_matches_jax_dryrun(oracle):
    """Full tinyllama-1.1b ``prefill_32k`` on 2 x 2 with the plan knob: the
    JAX dry run lowers it, with the FLOPs it has without the knob. The port
    gives its argument bytes; its FLOPs within ``PREFILL_TOL`` once rank
    0's masked score pairs (its piece of S / 2 queries, all 32 heads, all
    S keys) and the LM head's other positions are added; outside the flash
    kernel its count is the count without the knob, exactly; its
    collectives add the all-to-alls (two per layer) and the kv-head
    gathers (two per layer)."""
    want = oracle["tinyllama-1.1b prefill_32k plan"]
    assert want["flops"] == oracle["tinyllama-1.1b prefill_32k"]["flops"]
    assert "all-to-all" in want["collectives"]
    got = dryrun.run_one("tinyllama-1.1b", "prefill_32k", False, None, mesh_shape=MESH22,
                         plan=SEQ)
    plain = _port("tinyllama-1.1b", "prefill_32k", MESH22)
    assert got["status"] == "ok", got.get("traceback")
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    cfg = get_config("tinyllama-1.1b")
    S, B = SHAPES["prefill_32k"].seq_len, SHAPES["prefill_32k"].global_batch // 2
    masked = B * cfg.num_layers * _seq_shard_pairs(S // 2, S, cfg.num_heads, cfg.head_dim)
    head = B * (S - 1) * 2 * cfg.d_model * cfg.padded_vocab // 2
    assert _rel(got["flops"] + masked + head, want["flops"]) <= PREFILL_TOL
    flash = got["kernels"]["flash_attention"]
    assert flash["calls"] == cfg.num_layers
    assert got["flops"] - flash["flops"] == \
        plain["flops"] - plain["kernels"]["flash_attention"]["flops"]
    assert got["collectives"]["all-to-all"]["count"] == 2 * cfg.num_layers
    assert got["collectives"]["all-gather"]["count"] == \
        plain["collectives"]["all-gather"]["count"] + 2 * cfg.num_layers


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-7b"])
def test_attn_seq_shard_prefill_on_the_production_mesh(arch):
    """``prefill_32k`` with the knob on (16, 16), where gemma2's 8 query
    heads and qwen2's 28 are padded to 16 and 32: ok, one flash call per
    layer for all the heads over rank 0's sixteenth of the sequence, the
    non-kernel FLOPs those of the pair without the knob."""
    got = dryrun.run_one(arch, "prefill_32k", False, None, plan=SEQ)
    plain = dryrun.run_one(arch, "prefill_32k", False, None)
    assert got["status"] == plain["status"] == "ok", got.get("traceback")
    cfg = get_config(arch)
    assert got["kernels"]["flash_attention"]["calls"] == cfg.num_layers
    assert got["flops"] - got["kernels"]["flash_attention"]["flops"] == \
        plain["flops"] - plain["kernels"]["flash_attention"]["flops"]
    assert got["collectives"]["all-to-all"]["count"] == 2 * cfg.num_layers
    assert got["argument_size_in_bytes"] == plain["argument_size_in_bytes"]


def test_gemma2_train_4k_fits_a_card_with_the_vocabulary_cut():
    """gemma2-2b ``train_4k`` on (16, 16): the loss keeps the 256k
    vocabulary cut over the model axis (an fp32 copy of a rank's whole
    rows of logits would be 62.5 GiB), so argument + temp bytes fit 80 GB."""
    rec = dryrun.run_one("gemma2-2b", "train_4k", False, None)
    assert rec["status"] == "ok" and rec["hbm_fits"], rec.get("temp_size_in_bytes")


def test_mesh_stand_in_places_ranks_row_major():
    m = MeshStandIn({"pod": 2, "data": 16, "model": 16}, rank=300)
    assert (m.get_local_rank("pod"), m.get_local_rank("data"), m.get_local_rank("model")) == \
        (1, 2, 12)
    ctx = ExecContext(mesh=m, batch_axes=("pod", "data"), model_axis="model")
    assert (ctx.model_rank, ctx.data_rank, ctx.batch_parallel) == (12, 18, 32)
    assert ctx.data_group.size == 32 and ctx.model_group.size == 16
    with pytest.raises(ValueError):
        MeshStandIn({"data": 2, "model": 2}, rank=4)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-7b", "deepseek-v2-lite-16b",
                                  "mamba2-2.7b"])
def test_param_shapes_are_init_params_pieces(arch):
    """``init_params`` on the meta device and a stand-in mesh gives, leaf
    by leaf, the shapes and dtypes of the pieces it draws on the CPU for
    the same rank (reduced widths with the heads of the full config, on a
    (2, 4) mesh with FSDP; qwen2's groups of 7 padded to 8)."""
    full = get_config(arch)
    cfg = dataclasses.replace(reduced(full), num_heads=full.num_heads if arch == "qwen2-7b"
                              else reduced(full).num_heads * 2,
                              num_kv_heads=4 if arch == "qwen2-7b" else reduced(full).num_kv_heads
                              * (2 if full.use_mla else 1))
    for rank in (0, 5):
        ctx = ExecContext(mesh=MeshStandIn({"data": 2, "model": 4}, rank), batch_axes=("data",),
                          model_axis="model", fsdp=True)
        meta = model_lib.init_params(cfg, device=META, ctx=ctx, rank=rank)
        real = model_lib.init_params(cfg, 0, "cpu", ctx=ctx, rank=rank)
        got = {n: (tuple(p.shape), p.dtype, p.device.type) for n, p in meta.named_parameters()}
        want = {n: (tuple(p.shape), p.dtype, META) for n, p in real.named_parameters()}
        assert got == want
        assert (meta.shard, meta.data_shard) == (real.shard, real.data_shard)


# ---- the counter --------------------------------------------------------------


def test_meta_matmul_counts_two_mnk_and_live_bytes():
    M_, K, N = 64, 128, 32
    x = torch.empty(M_, K, dtype=torch.bfloat16, device=META)
    w = torch.empty(K, N, dtype=torch.bfloat16, device=META)
    c = OpCost()
    assert c.arguments(x, w) == 2 * (M_ * K + K * N)
    with c:
        y = x @ w
        z = torch.cat([y, y], dim=-1)
        del y
    s = c.summary()
    assert s["flops"] == 2 * M_ * N * K
    assert s["bytes_accessed"] == 2 * (M_ * K + K * N + M_ * N) + 2 * (2 * M_ * N + 2 * M_ * N)
    assert s["peak_bytes"] == 2 * M_ * N + 4 * M_ * N
    assert z.shape == (M_, 2 * N)


def test_meta_collectives_record_their_result_bytes():
    ctx = ExecContext(mesh=MeshStandIn({"data": 4, "model": 2}, 3), batch_axes=("data",),
                      model_axis="model")
    x = torch.empty(8, 16, device=META)
    c = OpCost()
    with c:
        assert collectives.all_reduce(x, ctx) is x
        g = collectives.all_gather_last(x, ctx)
        r = collectives.scatter_batch(x, ctx)
        o = collectives.merge_attention(torch.empty(1, 1, 4, 8, device=META),
                                        torch.empty(1, 1, 4, device=META), ctx)
    assert g.shape == (8, 32) and r.shape == (2, 16) and o.shape == (1, 1, 4, 8)
    assert c.collectives == {"all-reduce": {"count": 1, "bytes": 512},
                             "all-gather": {"count": 2, "bytes": 1024 + 4 * 4 * 9 * 4},
                             "reduce-scatter": {"count": 1, "bytes": 128}}


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def test_kernel_meta_routes_count_the_bounds_formulas():
    """Each wrapper on meta tensors: an output of the kernel's shape, the
    call's (FLOPs, bytes) by ``kernels.cost`` on the active counter, no
    launch counted; with int positions the count is exact."""
    launches = [w.launches for w in (fmod.flash_attention, dmod.decode_attention,
                                     dmod.decode_attention_piece, mmod.mla_attention,
                                     smod.ssd_scan)]
    c = OpCost()
    with c:
        o = fmod.flash_attention(_meta(2, 64, 8, 64), _meta(2, 64, 2, 64), _meta(2, 64, 2, 64),
                                 causal=True, window=16)
        d = dmod.decode_attention(_meta(4, 1, 8, 128), _meta(4, 512, 1, 128),
                                  _meta(4, 512, 1, 128), q_offset=300, kv_len=301)
        po, pl = dmod.decode_attention_piece(_meta(1, 1, 8, 128), _meta(1, 256, 1, 128),
                                             _meta(1, 256, 1, 128), k_start=256, q_offset=400,
                                             kv_len=401)
        lat = _meta(3, 1024, 1, 576)
        m = mmod.mla_attention(_meta(3, 5, 2, 576), lat, lat[..., :512], causal=True,
                               q_offset=100)
        y, h = smod.ssd_scan(_meta(2, 300, 8, 64), _meta(2, 300, 8, dtype=torch.float32),
                             _meta(2, 300, 8, dtype=torch.float32), _meta(2, 300, 128),
                             _meta(2, 300, 128), chunk=256)
    assert o.shape == (2, 64, 8, 64) and d.shape == (4, 1, 8, 128)
    assert po.shape == (1, 1, 8, 128) and pl.shape == (1, 1, 8) and po.dtype == torch.float32
    assert m.shape == (3, 5, 2, 512) and y.shape == (2, 300, 8, 64) and h.shape == (2, 8, 64, 128)
    want = {"flash_attention": cost.attention_work(2, 64, 64, 8, 2, 64, 64, 2, causal=True,
                                                   window=16),
            "decode_attention": cost.decode_work(4, 512, 8, 1, 128, 128, 2, q_offset=300,
                                                 kv_len=301),
            "decode_attention_piece": cost.decode_work(1, 256, 8, 1, 128, 128, 2, q_offset=400,
                                                       kv_len=401, k_start=256),
            "mla_attention": cost.mla_work(3, 5, 1024, 2, 1, 576, 512, 2, causal=True,
                                           q_offset=100),
            "ssd_scan": cost.ssd_work(2, 300, 8, 64, 128, 256, 2)}
    assert {k: (r["calls"], r["flops"], r["bytes"]) for k, r in c.kernels.items()} == \
        {k: (1,) + w for k, w in want.items()}
    # the decode's 301 kept keys and the piece's 145 (positions 256..400)
    assert want["decode_attention"][0] == 4 * 2 * 8 * 256 * 301
    assert want["decode_attention_piece"][0] == 2 * 8 * 256 * 145
    # the MLA values are the latent's leading columns: read once, with the latent
    assert want["mla_attention"][1] == 2 * (3 * 105 * 576 + 3 * 5 * 2 * 1088)
    assert launches == [w.launches for w in (fmod.flash_attention, dmod.decode_attention,
                                             dmod.decode_attention_piece, mmod.mla_attention,
                                             smod.ssd_scan)]


def test_kernel_meta_routes_refuse_what_the_card_refuses():
    lat = _meta(2, 64, 1, 576)
    bad = [(lambda: mmod.mla_attention(_meta(2, 1, 3, 576), lat, lat[..., :512]),
            "MLA kernels take"),
           (lambda: mmod.mla_attention(_meta(2, 1, 2, 576), lat, lat[..., 64:]), "contiguous"),
           (lambda: dmod.decode_attention(_meta(2, 1, 8, 96), _meta(2, 64, 1, 96),
                                          _meta(2, 64, 1, 96)), "value head dim"),
           (lambda: dmod.decode_attention(_meta(2, 1, 6, 64), _meta(2, 64, 1, 64),
                                          _meta(2, 64, 1, 64)), "GQA group"),
           (lambda: fmod.flash_attention(_meta(2, 8, 4, 72), _meta(2, 8, 4, 72),
                                         _meta(2, 8, 4, 64)), "multiple of 16"),
           (lambda: fmod.flash_attention(_meta(2, 8, 4, 64, dtype=torch.float16),
                                         _meta(2, 8, 4, 64, dtype=torch.float16),
                                         _meta(2, 8, 4, 64, dtype=torch.float16)), "dtype"),
           (lambda: smod.ssd_scan(_meta(2, 30, 8, 40), _meta(2, 30, 8, dtype=torch.float32),
                                  _meta(2, 30, 8, dtype=torch.float32), _meta(2, 30, 128),
                                  _meta(2, 30, 128)), "multiples of 16")]
    c = OpCost()
    with c:
        for call, match in bad:
            with pytest.raises(ValueError, match=match):
                call()
    assert c.kernels == {}


def test_cpu_tensors_never_take_the_meta_route():
    """Under an active counter, CPU tensors run the plain versions (the
    same values as called directly) and record no kernel."""
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 1, 4, 576, generator=g), torch.randn(2, 16, 1, 576, generator=g)
    qd, kd = torch.randn(2, 1, 4, 64, generator=g), torch.randn(2, 16, 2, 64, generator=g)
    c = OpCost()
    with c:
        m = mmod.mla_attention(q, k, k[..., :512], causal=False, kv_len=9)
        d = dmod.decode_attention(qd, kd, kd, kv_len=9)
    assert c.kernels == {} and c.flops > 0  # the plain versions' products, counted as aten ops
    torch.testing.assert_close(m, mmod.mla_attention_plain(q, k, k[..., :512], causal=False,
                                                           kv_len=9), rtol=0, atol=0)
    torch.testing.assert_close(d, dmod.decode_attention_plain(qd, kd, kd, kv_len=9), rtol=0,
                               atol=0)
    assert m.device.type == d.device.type == "cpu"


def test_bounds_match_their_earlier_loop_forms():
    """``kernels.cost``'s closed forms against the per-row loops the kernel
    table used before (a causal prefill with a window, a verify, decode at
    ragged positions)."""
    def kept(qpos, kv_len, Sk, causal, window):
        hi = min(kv_len, Sk, qpos + 1) if causal else min(kv_len, Sk)
        lo = max(0, qpos - window + 1) if window else 0
        return max(0, hi - lo)
    B, S, H, Hkv, D, w = 3, 200, 8, 2, 64, 50
    pairs = B * sum(kept(i, S, S, True, w) for i in range(S))
    assert cost.flash_bound(B, S, H, Hkv, D, w, "bfloat16", 2) == cost.bound(
        4 * H * D * pairs, 2 * (B * S * H * 2 * D + B * S * Hkv * 2 * D), "bfloat16")
    offs, T, Smax = [0, 63, 500, 1019], 5, 1024
    pairs = sum(kept(o + t, Smax, Smax, True, None) for o in offs for t in range(T))
    rows = sum(kept(o + T - 1, Smax, Smax, True, None) for o in offs)
    assert cost.mla_bound(offs, T, Smax, "bfloat16", 2, H=16) == cost.bound(
        2 * 16 * 1088 * pairs, 2 * (rows * 576 + len(offs) * T * 16 * 1088), "bfloat16")
    pos = [0, 1, 63, 64, 500, 1023]
    keptn = sum(kept(p, p + 1, Smax, False, 256) for p in pos)
    assert cost.decode_bound(pos, Smax, H, Hkv, D, 256, "float32", 4) == \
        cost.decode_bound_kept(keptn, len(pos), H, Hkv, D, "float32", 4)
    assert np.isclose(cost.bound(989e9, 0, "bfloat16")[0], 1.0)
