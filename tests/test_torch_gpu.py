"""The hand-written CUDA kernels (attention, SSD scan) against their plain
versions, on the card, and the speculative and joint-planned serves
through them.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py``. This file
imports no JAX (the GPU machine has none): inputs come from numpy.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import ssd_scan as smod

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(seed, shape, dtype, dev):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=dev, dtype=getattr(torch, dtype))


def _close(out, ref, dtype):
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D,softcap,window", [
    (32, 4, 64, None, None),    # tinyllama-1.1b
    (8, 4, 256, 50.0, 96),      # gemma2-2b local layer, window < S
])
def test_flash_kernel_matches_plain_on_card(dtype, H, Hkv, D, softcap, window):
    dev = _card()
    B, S = 2, 200
    q = _randn(0, (B, S, H, D), dtype, dev)
    k, v = (_randn(s, (B, S, Hkv, D), dtype, dev) for s in (1, 2))
    for kw in (dict(causal=True, window=window, softcap=softcap),
               dict(causal=True, q_offset=torch.tensor([0, 30], device=dev),
                    kv_len=torch.tensor([200, 120], device=dev))):
        before = fmod.flash_attention.launches
        out = fmod.flash_attention(q, k, v, **kw)
        assert fmod.flash_attention.launches == before + 1
        _close(out, fmod.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D,softcap,window", [
    (32, 4, 64, None, None),
    (8, 4, 256, 50.0, 256),
])
def test_decode_kernel_matches_plain_on_card(dtype, H, Hkv, D, softcap, window):
    dev = _card()
    pos = torch.tensor([0, 1, 63, 64, 500, 1023, 2046, 2047], dtype=torch.int32, device=dev)
    q = _randn(3, (8, 1, H, D), dtype, dev)
    k, v = (_randn(s, (8, 2048, Hkv, D), dtype, dev) for s in (4, 5))
    kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=softcap)
    before = dmod.decode_attention.launches
    out = dmod.decode_attention(q, k, v, **kw)
    assert dmod.decode_attention.launches == before + 1
    _close(out, dmod.decode_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 17, 64, 65, 128, 129, 200, 1024])
@pytest.mark.parametrize("H,Hkv,D,softcap", [(32, 4, 64, None), (8, 4, 256, 50.0)])
def test_flash_kernel_at_tile_edges(dtype, S, H, Hkv, D, softcap):
    """Lengths on and beside the 128-row q tiles and 64-key K/V tiles, with
    a window that crosses tiles."""
    dev = _card()
    q = _randn(10, (1, S, H, D), dtype, dev)
    k, v = (_randn(s, (1, S, Hkv, D), dtype, dev) for s in (11, 12))
    for window in (None, S // 3 + 1):
        kw = dict(causal=True, window=window, softcap=softcap)
        _close(fmod.flash_attention(q, k, v, **kw), fmod.flash_attention_plain(q, k, v, **kw),
               dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,Dk,Dv", [(1, 64, 64), (2, 64, 32), (4, 128, 128), (8, 64, 64),
                                     (2, 256, 256)])
def test_flash_kernel_groups_head_dims_and_per_row_positions(dtype, G, Dk, Dv):
    """Every GQA group, Dv != Dk, and per-row q_offset / kv_len with
    kv_len < q_offset + S (one row keeps no key and must write 0)."""
    dev = _card()
    Hkv, Sq, Sk = 2, 65, 300
    q = _randn(13, (4, Sq, G * Hkv, Dk), dtype, dev)
    k = _randn(14, (4, Sk, Hkv, Dk), dtype, dev)
    v = _randn(15, (4, Sk, Hkv, Dv), dtype, dev)
    kw = dict(causal=True, q_offset=torch.tensor([0, 100, 230, 5], device=dev),
              kv_len=torch.tensor([40, 120, 260, 0], device=dev))
    for window in (None, 100):
        out = fmod.flash_attention(q, k, v, window=window, **kw)
        _close(out, fmod.flash_attention_plain(q, k, v, window=window, **kw), dtype)
        assert float(out[3].float().abs().max()) == 0.0


def verify_offsets(Smax, T):
    """Per-row q_offset of a speculative verify over 8 slots: 0, 63, 64,
    500, Smax - T (the last position that fits) and Smax - 2 (q_offset + T
    past the cache), and two more inside it."""
    return [0, 63, 64, 500, Smax - T, Smax - 2, 127, Smax // 2 + 1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [2, 3, 5, 16])
@pytest.mark.parametrize("Smax", [1024, 1000])
@pytest.mark.parametrize("H,Hkv,D,softcap,window", [
    (32, 4, 64, None, None),     # tinyllama-1.1b
    (8, 4, 256, 50.0, 4096),     # gemma2-2b local layer
])
def test_flash_kernel_at_verify_shapes(dtype, T, Smax, H, Hkv, D, softcap, window):
    """The speculative verify's call: T query rows per slot against the
    whole cache at per-row offsets, kv_len None and causal, random K/V in
    every cache row (the stale entries a rejected draft leaves)."""
    dev = _card()
    q = _randn(20, (8, T, H, D), dtype, dev)
    k, v = (_randn(s, (8, Smax, Hkv, D), dtype, dev) for s in (21, 22))
    kw = dict(causal=True, window=window, softcap=softcap,
              q_offset=torch.tensor(verify_offsets(Smax, T), dtype=torch.int32, device=dev))
    before = fmod.flash_attention.launches
    out = fmod.flash_attention(q, k, v, **kw)
    assert fmod.flash_attention.launches == before + 1
    _close(out, fmod.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("kind", ["truncated", "random"])
def test_speculative_serve_on_card(kind, temperature):
    """Reduced tinyllama (fp32) with its truncated self-draft (every
    proposal accepted) or a random 1-layer draft (most rolled back), FIFO on
    the card: the tokens are the plain decode's, and the flash kernel ran
    once per attention layer for every prefill and verify pass."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.slots import Request
    from repro_torch.serving.speculative import truncated_draft
    dev = _card()
    cfg = reduced(get_config("tinyllama-1.1b"))
    dcfg, dparams, tparams = truncated_draft(cfg, init_params(cfg, 0, dev))
    if kind == "random":
        dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft", num_layers=1)
        dparams, tparams = init_params(dcfg, 7, dev), init_params(cfg, 0, dev)
    r = np.random.default_rng(0)
    reqs = [(i, r.integers(1, cfg.vocab_size, int(r.integers(4, 40)), dtype=np.int32),
             int(r.integers(3, 14))) for i in range(6)]

    def serve(draft):
        eng = ServingEngine(max_slots=4)
        eng.add_model("m", cfg, tparams, max_len=64, draft=draft)
        for uid, prompt, n in reqs:
            eng.submit("m", Request(uid, prompt, n))
        before = fmod.flash_attention.launches
        out = {x.uid: x.tokens.tolist() for x in eng.run_all(temperature=temperature)}
        return out, eng, fmod.flash_attention.launches - before

    base, _, _ = serve(None)
    spec, eng, flash = serve((dcfg, dparams))
    assert spec == base
    workers = [eng.workers["m"], eng.spec["m"].worker]
    assert eng.workers["m"].verify_calls > 0
    assert flash == sum(w.cfg.num_layers * (w.prefill_calls + w.verify_calls) for w in workers)
    c = eng.ledger.counters
    if kind == "truncated":
        assert c["spec_accepted"] == c["spec_drafted"] > 0
    elif temperature == 0.0:
        assert c["spec_accepted"] < c["spec_drafted"]  # rolled back over stale K/V


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_at_split_edges(dtype, G, D):
    """kv_len on a split boundary, one before and one past it, Smax 1000
    (not a multiple of the split), windows inside one split and across
    splits, with and without softcap."""
    dev = _card()
    B, Smax, Hkv = 8, 1000, 2
    L = dmod.plan_splits(Smax, B, Hkv)[1]
    pos = torch.tensor([0, L - 2, L - 1, L, 2 * L - 1, 2 * L, Smax - 2, Smax - 1],
                       dtype=torch.int32, device=dev)
    q = _randn(16, (B, 1, G * Hkv, D), dtype, dev)
    k, v = (_randn(s, (B, Smax, Hkv, D), dtype, dev) for s in (17, 18))
    for window, softcap in ((None, None), (L // 2 + 3, None), (2 * L + 5, 50.0)):
        kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=softcap)
        before = dmod.decode_attention.launches
        out = dmod.decode_attention(q, k, v, **kw)
        assert dmod.decode_attention.launches == before + 1
        _close(out, dmod.decode_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pieces", [2, 3])
@pytest.mark.parametrize("G,D", [(8, 64), (2, 256), (7, 128), (8, 128)])
def test_decode_piece_mode_matches_plain_and_merges_to_the_whole_cache(dtype, pieces, G, D):
    """The decode kernel's piece mode on each piece of a (8, 1000) cache cut
    in 2 or 3 (the last zero-padded): o and lse (fp32 for either input
    dtype) against its plain version at fp32's tolerance, rows that keep
    no key of a piece (0 and -1e30), a window and softcap across the
    pieces' boundaries; the pieces' states merged
    (``collectives.merge_states``) and cast once against the whole-cache
    kernel."""
    from repro_torch.sharding.collectives import merge_states
    dev = _card()
    B, Smax, Hkv = 8, 1000, 2
    pos = torch.tensor([0, 1, 332, 333, 334, 500, 667, 999], dtype=torch.int32, device=dev)
    q = _randn(20, (B, 1, G * Hkv, D), dtype, dev)
    k, v = (_randn(s, (B, Smax, Hkv, D), dtype, dev) for s in (21, 22))
    n = -(-Smax // pieces)
    for window, softcap in ((None, None), (40, 50.0)):
        kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=softcap)
        states = []
        for d in range(pieces):
            m = min(n, Smax - d * n)
            kp = torch.zeros((B, n, Hkv, D), dtype=k.dtype, device=dev)
            vp = torch.zeros_like(kp)
            kp[:, :m], vp[:, :m] = k[:, d * n:d * n + m], v[:, d * n:d * n + m]
            before = dmod.decode_attention_piece.launches
            o, lse = dmod.decode_attention_piece(q, kp, vp, k_start=d * n, **kw)
            assert dmod.decode_attention_piece.launches == before + 1
            po, plse = dmod.decode_attention_piece_plain(q, kp, vp, k_start=d * n, **kw)
            assert o.dtype == lse.dtype == torch.float32
            # both sides fp32 from the same inputs: fp32's tolerance in both dtypes
            _close(o, po, "float32")
            _close(lse, plse, "float32")
            states.append(torch.cat([o, lse[..., None]], dim=-1))
        merged = merge_states(torch.stack(states))[0].to(q.dtype)
        _close(merged, dmod.decode_attention(q, k, v, **kw), dtype)


# sums of up to 256 x 128 fp32 products in another order than the plain
# version's; bf16: y is rounded to bf16 on both sides, and the tensor-core
# kernels feed their fp32 operands as bf16 hi + lo (~2^-17 per product)
SSD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}


def _ssd_check(dtype, B, S, H=80, P=64, N=128, pad=None, dt_shift=-4.0):
    """The SSD wrapper on the card against its plain version; ``pad``: each
    row's width of left padding (a prefill bucket's mask); dt =
    softplus(randn + dt_shift): ~0.02 at -4, ~0.7 at 0."""
    dev = _card()
    r = np.random.default_rng(6)
    dt = torch.from_numpy(np.log1p(np.exp(r.standard_normal((B, S, H)) + dt_shift))
                          .astype(np.float32)).to(dev)
    A = -torch.exp(torch.linspace(0.0, float(np.log(16.0)), H, device=dev))
    x = _randn(7, (B, S, H, P), dtype, dev)
    Bm, Cm = (_randn(s, (B, S, N), dtype, dev) for s in (8, 9))
    mask = None
    if pad is not None:
        mask = torch.ones(B, S, dtype=torch.bool, device=dev)
        for row, width in enumerate(pad):
            mask[row, :width] = False
    before = smod.ssd_scan.launches
    y, h = smod.ssd_scan(x, dt * A, dt, Bm, Cm, mask=mask, chunk=256)
    assert smod.ssd_scan.launches == before + 1  # one per call, whatever the route launches
    ry, rh = smod.ssd_scan_plain(x, dt * A, dt, Bm, Cm, mask=mask, chunk=256)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), ry.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, rh, atol=SSD_TOL["float32"], rtol=SSD_TOL["float32"])


def _edge_pad(B, S):
    """Row 0 left-padded by S // 3 and the last row by S // 2."""
    return tuple(S // 2 if row == B - 1 else S // 3 if row == 0 else 0 for row in range(B))


# the scheduled serve's SSD calls: (B, S, every row's left padding), the
# 96- and 200-token prompts in their pow2 buckets of 128 and 256
SSD_SERVE = ((1, 64, 0), (2, 256, 56), (2, 512, 0), (4, 128, 32))
SSD_CASES = (
    # one chunk shorter than 256, a tail chunk with row 0 left-padded, four full chunks
    [(1, 64, None, -4.0), (2, 200, (57, 0), -4.0), (1, 1024, None, -4.0)]
    # S on and beside the 64-position tiles and the 256-position chunk
    + [(B, S, pad, -4.0) for B in (1, 8) for S in (1, 63, 64, 65, 200, 255, 256, 257, 1024)
       for pad in ((None, _edge_pad(B, S)) if S > 1 else (None,))]
    # the serve's own shapes and masks, at dt ~0.02 and ~0.7
    + [(B, S, (p,) * B, shift) for B, S, p in SSD_SERVE for shift in (-4.0, 0.0)]
    + [(8, 512, None, 0.0), (2, 300, (100, 7), 0.0)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,pad,dt_shift", SSD_CASES)
def test_ssd_scan_kernel_matches_plain_on_card(dtype, B, S, pad, dt_shift):
    """mamba2-2.7b heads (H 80, P 64, N 128, chunk 256) at S on and beside
    the 64-position tiles and the 256-position chunk, with and without
    left-padded rows, and at the scheduled serve's (B, S) and masks."""
    _ssd_check(dtype, B, S, pad=pad, dt_shift=dt_shift)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,P,N,S", [(1, 64, 128, 300), (5, 64, 128, 300), (79, 64, 128, 257),
                                     (3, 32, 64, 130), (4, 16, 16, 70)])
def test_ssd_scan_kernel_head_counts_and_widths_on_card(dtype, H, P, N, S):
    """Head counts that are not a multiple of the bf16 kernel's head pair,
    and P, N below the tiles' widths (zero-filled columns)."""
    _ssd_check(dtype, 2, S, H=H, P=P, N=N, pad=(S // 3, 7))


@pytest.mark.gpu
def test_joint_planned_serve_on_card():
    """The contention-aware joint-planned serve (``AdaOperScheduler(coexec=
    CoexecPlanner())``) on the card: tinyllama-1.1b, gemma2-2b and
    mamba2-2.7b at full width cut to 2 layers, bf16, served together; every
    kernel's launches are counted as the passes require, and plans were
    solved under a joint key (all three models resident)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import make_scheduler
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.slots import Request
    dev = _card()
    names = ("tinyllama-1.1b", "gemma2-2b", "mamba2-2.7b")
    cfgs = {n: dataclasses.replace(get_config(n), num_layers=2) for n in names}
    sched = make_scheduler(cfgs.values(), 64, 6, "moderate", 0, coexec=True)
    eng = ServingEngine(scheduler=sched, max_slots=4)
    r = np.random.default_rng(0)
    for k, (n, cfg) in enumerate(cfgs.items()):
        eng.add_model(n, cfg, init_params(cfg, 0, dev), max_len=128)
        for i in range(5):
            eng.submit(n, Request(100 * k + i, r.integers(1, cfg.vocab_size, int(r.choice(
                (16, 24, 48, 64))), dtype=np.int32), 6))
    wrappers = (fmod.flash_attention, dmod.decode_attention, smod.ssd_scan)
    before = [w.launches for w in wrappers]
    out = eng.run_all()
    flash, decode, ssd = (w.launches - b for w, b in zip(wrappers, before))
    assert len(out) == 15 and all(x.error is None and len(x.tokens) == 6 for x in out)
    attn = [w for w in eng.workers.values() if "ssd" not in w.cfg.layer_kinds()]
    mamba = eng.workers["mamba2-2.7b"]
    assert flash == sum(w.cfg.num_layers * w.prefill_calls for w in attn) > 0
    assert decode == sum(w.cfg.num_layers * w.decode_calls for w in attn) > 0
    assert ssd == mamba.cfg.num_layers * mamba.prefill_calls > 0
    joint = [k for k in sched._plan_cache if "coex" in k]
    assert joint and all(len(k[-3]) >= 2 for k in joint)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_at_group_7(dtype, D):
    """G = 7 (qwen2-7b's 28 q heads on 4 kv heads): a lane group of 16, not
    14, so no group straddles two warps; the split edges, windows and a
    retired slot parked at Smax (kv_len clamped to the cache)."""
    dev = _card()
    B, Smax, Hkv = 8, 1000, 4
    L = dmod.plan_splits(Smax, B, Hkv)[1]
    pos = torch.tensor([0, L - 1, L, 2 * L - 1, 2 * L + 1, Smax - 2, Smax - 1, Smax],
                       dtype=torch.int32, device=dev)
    q = _randn(40, (B, 1, 7 * Hkv, D), dtype, dev)
    k, v = (_randn(s, (B, Smax, Hkv, D), dtype, dev) for s in (41, 42))
    for window, softcap in ((None, None), (L // 2 + 3, None), (2 * L + 5, 50.0)):
        kw = dict(q_offset=pos, kv_len=pos + 1, window=window, softcap=softcap)
        before = dmod.decode_attention.launches
        out = dmod.decode_attention(q, k, v, **kw)
        assert dmod.decode_attention.launches == before + 1
        _close(out, dmod.decode_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Smax", [1024, 1000])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("T", [1, 2, 5, 8])
def test_mla_decode_kernel_matches_plain_on_card(dtype, Smax, shared, T):
    """The absorbed-MLA shape (16 heads on one latent head, Dk 576, Dv 512)
    through ``ops.flash_attention``, which sends it to ``mla_attention`` at
    every T (bf16 on the tensor cores, fp32 on the CUDA cores): the decode
    step (T = 1, a retired slot parked at Smax) and the verify (T > 1,
    causal, per-row offsets at the split edges); values as the latent rows'
    first 512 columns (shared) or a tensor of their own; then a window and
    a softcap, which the kernels take though DeepSeek uses neither."""
    from repro_torch.kernels import mla_attention as mmod
    from repro_torch.kernels import ops
    dev = _card()
    B = 8
    L = dmod.plan_splits(Smax, B, 1)[1]
    pos = torch.tensor([0, 1, L - 1, L, 2 * L + 3, 500, Smax - 1, Smax], dtype=torch.int32,
                       device=dev)
    q = _randn(43, (B, T, 16, 576), dtype, dev)
    k = _randn(44, (B, Smax, 1, 576), dtype, dev)
    v = k[..., :512] if shared else _randn(45, (B, Smax, 1, 512), dtype, dev)
    kw = (dict(causal=False, q_offset=pos, kv_len=pos + 1) if T == 1 else
          dict(causal=True, q_offset=torch.clamp(pos, max=Smax - 2)))
    kw["scale"] = 192 ** -0.5
    wrappers = (fmod.flash_attention, dmod.decode_attention, mmod.mla_attention)
    before = [w.launches for w in wrappers]
    out = ops.flash_attention(q, k, v, **kw)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [0, 0, 1]
    _close(out, mmod.mla_attention_plain(q, k, v, **kw), dtype)
    kw.update(window=L + 7, softcap=30.0)
    _close(mmod.mla_attention(q, k, v, **kw), mmod.mla_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [8, 4, 2, 1])
@pytest.mark.parametrize("T", [1, 5])
def test_mla_kernels_at_a_ranks_heads_on_card(dtype, G, T):
    """A model rank's heads of deepseek-v2-lite on one latent head (G = 8
    at a model axis of 2, 4 at 4, 2 at 8, 1 at 16): 8 slots against a 1024-entry cache, the
    decode step (T = 1, a slot parked at Smax) and the verify (T = 5, causal
    at per-row offsets), through ``ops.flash_attention``, which sends them
    to ``mla_attention`` and never flash or decode; then two latent heads
    (Hkv 2) with a window and a softcap, and a verify row bit for bit equal
    to the decode step at its position."""
    from repro_torch.kernels import mla_attention as mmod
    from repro_torch.kernels import ops
    dev = _card()
    B, Smax = 8, 1024
    pos = torch.tensor([0, 1, 63, 64, 500, 1000, 1023, 1024], dtype=torch.int32, device=dev)
    q = _randn(48, (B, T, G, 576), dtype, dev)
    k = _randn(49, (B, Smax, 1, 576), dtype, dev)
    kw = (dict(causal=False, q_offset=pos, kv_len=pos + 1) if T == 1 else
          dict(causal=True, q_offset=torch.clamp(pos, max=Smax - 2)))
    kw["scale"] = 192 ** -0.5
    wrappers = (fmod.flash_attention, dmod.decode_attention, mmod.mla_attention)
    before = [w.launches for w in wrappers]
    out = ops.flash_attention(q, k, k[..., :512], **kw)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [0, 0, 1]
    assert out.shape == (B, T, G, 512)
    _close(out, mmod.mla_attention_plain(q, k, k[..., :512], **kw), dtype)
    q2 = _randn(50, (B, T, 2 * G, 576), dtype, dev)
    k2 = _randn(51, (B, Smax, 2, 576), dtype, dev)
    v2 = _randn(52, (B, Smax, 2, 512), dtype, dev)
    kw2 = dict(kw, window=300, softcap=30.0)
    _close(mmod.mla_attention(q2, k2, v2, **kw2), mmod.mla_attention_plain(q2, k2, v2, **kw2),
           dtype)
    if T > 1:
        offs = kw["q_offset"]
        for t in range(T):
            dec = mmod.mla_attention(q[:, t:t + 1].contiguous(), k, k[..., :512], causal=False,
                                     q_offset=offs + t, kv_len=offs + t + 1, scale=kw["scale"])
            live = (offs + t) < Smax
            assert torch.equal(dec[live, 0], out[live, t])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pieces", [2, 8])
@pytest.mark.parametrize("T", [1, 5])
def test_mla_piece_mode_matches_plain_and_merges_to_the_whole_cache(dtype, pieces, T):
    """The MLA kernels' piece mode at G = 16 on each piece of a (8, 1024)
    latent cut in 2 or 8, through ``ops.decode_attention_piece`` (one MLA
    piece launch each, no other kernel): o and lse, fp32 for either input
    dtype, against ``mla_attention_piece_plain`` at fp32's tolerance, the
    decode step (T = 1, a slot parked at Smax) and the verify (T = 5,
    causal), rows that keep no key of a piece (0 and -1e30); the pieces'
    states merged (``collectives.merge_states``) and cast once against the
    whole-cache kernel at the dtype's tolerance."""
    from repro_torch.kernels import mla_attention as mmod
    from repro_torch.kernels import ops
    from repro_torch.sharding.collectives import merge_states
    dev = _card()
    B, Smax = 8, 1024
    pos = torch.tensor([0, 1, 63, 64, 500, 1000, 1023, 1024], dtype=torch.int32, device=dev)
    q = _randn(55, (B, T, 16, 576), dtype, dev)
    k = _randn(56, (B, Smax, 1, 576), dtype, dev)
    kw = (dict(causal=False, q_offset=pos, kv_len=torch.clamp(pos + 1, max=Smax)) if T == 1
          else dict(causal=True, q_offset=torch.clamp(pos, max=Smax - 2), kv_len=Smax))
    kw["scale"] = 192 ** -0.5
    n = Smax // pieces
    wrappers = (dmod.decode_attention_piece, mmod.mla_attention, mmod.mla_attention_piece)
    states = []
    for p in range(pieces):
        kp = k[:, p * n:(p + 1) * n].contiguous()
        before = [w.launches for w in wrappers]
        o, lse = ops.decode_attention_piece(q, kp, kp[..., :512], k_start=p * n, **kw)
        assert [w.launches - b for w, b in zip(wrappers, before)] == [0, 0, 1]
        po, plse = mmod.mla_attention_piece_plain(q, kp, kp[..., :512], k_start=p * n, **kw)
        assert o.dtype == lse.dtype == torch.float32
        assert o.shape == (B, T, 16, 512) and lse.shape == (B, T, 16)
        _close(o, po, "float32")
        _close(lse, plse, "float32")
        empty = plse <= -1e29
        assert torch.equal(lse[empty], plse[empty]) and not o[empty].any()
        states.append(torch.cat([o, lse[..., None]], dim=-1))
    merged = merge_states(torch.stack(states))[0].to(q.dtype)
    _close(merged, mmod.mla_attention(q, k, k[..., :512], **kw), dtype)


@pytest.mark.gpu
def test_mla_kernels_refuse_other_groups_on_card():
    """A G outside ``MLA_GROUPS`` at the latent widths raises before any
    launch, in both routes; it never runs the plain version on the card."""
    from repro_torch.kernels import mla_attention as mmod
    dev = _card()
    for dtype in ("float32", "bfloat16"):
        for G in (3, 6, 32):
            q = _randn(53, (2, 1, G, 576), dtype, dev)
            k = _randn(54, (2, 64, 1, 576), dtype, dev)
            before = mmod.mla_attention.launches
            with pytest.raises(ValueError, match="MLA kernels take"):
                mmod.mla_attention(q, k, k[..., :512], causal=False, kv_len=32)
            assert mmod.mla_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_rows_do_not_depend_on_T_on_card(dtype):
    """A verify row and a decode step at the same position run the same
    arithmetic: T = 5 causal rows at per-row offsets give, bit for bit, the
    outputs of five T = 1 steps at those positions on the same q rows."""
    from repro_torch.kernels import mla_attention as mmod
    dev = _card()
    q = _randn(46, (8, 5, 16, 576), dtype, dev)
    k = _randn(47, (8, 1024, 1, 576), dtype, dev)
    offs = torch.tensor([72, 136, 264, 520, 0, 63, 1019, 1022], dtype=torch.int32, device=dev)
    ver = mmod.mla_attention(q, k, k[..., :512], causal=True, q_offset=offs)
    for t in range(5):
        p = offs + t
        dec = mmod.mla_attention(q[:, t:t + 1].contiguous(), k, k[..., :512], causal=False,
                                 q_offset=p, kv_len=p + 1)
        assert torch.equal(dec[:, 0], ver[:, t])


@pytest.mark.gpu
def test_mla_speculative_serve_on_card():
    """deepseek-v2-lite-16b at its attention widths (16 heads, the 512 + 64
    latent) cut to 2 layers and narrow experts, bf16, drop-free capacity,
    with its truncated self-draft (layer 0: dense, MLA), FIFO on the card:
    every request completes, the verify and every decode pass launch
    ``mla_attention`` once per layer (draft included), and flash runs only
    for the prefills."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import mla_attention as mmod
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.slots import Request
    from repro_torch.serving.speculative import truncated_draft
    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), num_layers=2, vocab_size=1024,
                              num_experts=8, top_k=2, moe_d_ff=256, d_ff=1024,
                              moe_capacity_factor=4.0)
    dcfg, dparams, tparams = truncated_draft(cfg, init_params(cfg, 0, dev))
    r = np.random.default_rng(0)
    reqs = [(i, r.integers(1, cfg.vocab_size, int(r.integers(4, 40)), dtype=np.int32),
             int(r.integers(3, 14))) for i in range(6)]
    eng = ServingEngine(max_slots=4)
    eng.add_model("m", cfg, tparams, max_len=64, draft=(dcfg, dparams))
    for uid, prompt, n in reqs:
        eng.submit("m", Request(uid, prompt, n))
    wrappers = (fmod.flash_attention, dmod.decode_attention, mmod.mla_attention)
    before = [w.launches for w in wrappers]
    out = eng.run_all()
    flash, decode, mla = (w.launches - b for w, b in zip(wrappers, before))
    assert sorted(x.uid for x in out) == list(range(6))
    assert all(x.error is None and len(x.tokens) == n for x, (_, _, n) in
               zip(sorted(out, key=lambda x: x.uid), reqs))
    workers = [eng.workers["m"], eng.spec["m"].worker]
    assert eng.workers["m"].verify_calls > 0 and eng.ledger.counters["spec_rounds"] > 0
    assert flash == sum(w.cfg.num_layers * w.prefill_calls for w in workers) > 0
    assert mla == sum(w.cfg.num_layers * (w.decode_calls + w.verify_calls) for w in workers)
    assert decode == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,Dk,Dv", [(16, 16, 192, 128), (28, 4, 128, 128)])
def test_flash_kernel_at_mla_prefill_and_group_7(dtype, H, Hkv, Dk, Dv):
    """DeepSeek's naive-form MLA prefill (Dk 192 != Dv 128, 16 heads) and
    qwen2-7b's G = 7, causal, at tile edges and per-row positions."""
    dev = _card()
    for S in (1, 65, 129, 512):
        q = _randn(46, (2, S, H, Dk), dtype, dev)
        k = _randn(47, (2, S, Hkv, Dk), dtype, dev)
        v = _randn(48, (2, S, Hkv, Dv), dtype, dev)
        kw = dict(causal=True, scale=Dk ** -0.5)
        _close(fmod.flash_attention(q, k, v, **kw), fmod.flash_attention_plain(q, k, v, **kw),
               dtype)
    kw = dict(causal=True, q_offset=torch.tensor([0, 40], device=dev),
              kv_len=torch.tensor([512, 300], device=dev))
    _close(fmod.flash_attention(q, k, v, **kw), fmod.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (17, 17), (255, 255), (512, 512), (2, 100),
                                   (4, 257), (17, 500), (32, 100), (130, 63)])
def test_flash_kernel_non_causal_at_encoder_and_cross_shapes(dtype, Sq, Sk):
    """seamless-m4t's attention (16 heads, G = 1, D 64) without a causal
    mask: the encoder's self-attention (Sq = Sk, frames not a multiple of
    the 64-key tile) and the cross-attention at prefill (a few prompt rows
    against hundreds of frames); then per-row kv_len, 0 for one row."""
    dev = _card()
    q = _randn(60, (2, Sq, 16, 64), dtype, dev)
    k, v = (_randn(s, (2, Sk, 16, 64), dtype, dev) for s in (61, 62))
    before = fmod.flash_attention.launches
    out = fmod.flash_attention(q, k, v, causal=False)
    assert fmod.flash_attention.launches == before + 1
    _close(out, fmod.flash_attention_plain(q, k, v, causal=False), dtype)
    kw = dict(causal=False, kv_len=torch.tensor([0, Sk // 2 + 1], device=dev))
    out = fmod.flash_attention(q, k, v, **kw)
    assert not out[0].any()
    _close(out, fmod.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,Hkv", [(1, 16), (4, 8)])  # seamless's MHA; jamba's 32/8 (D 128)
def test_decode_kernel_with_per_row_enc_len(dtype, G, Hkv):
    """The cross-attention's decode: one query per slot at q_offset 0
    against a 512-frame region, per-row kv_len 0 (a slot never admitted), 1, 63, 64,
    100, 257, 511 and 512, no window; a row that keeps no key writes 0."""
    dev = _card()
    D = 64 if G == 1 else 128
    kl = torch.tensor([0, 1, 63, 64, 100, 257, 511, 512], dtype=torch.int32, device=dev)
    q = _randn(63, (8, 1, G * Hkv, D), dtype, dev)
    k, v = (_randn(s, (8, 512, Hkv, D), dtype, dev) for s in (64, 65))
    kw = dict(q_offset=0, kv_len=kl)
    before = dmod.decode_attention.launches
    out = dmod.decode_attention(q, k, v, **kw)
    assert dmod.decode_attention.launches == before + 1
    assert not out[0].any()
    _close(out, dmod.decode_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.gpu
def test_mamba1_prefill_and_decode_on_card_match_the_cpu():
    """A reduced Jamba Mamba1 mixer in fp32 with seeded weights: prefill of
    a left-padded pair across a chunk edge, then one decode step, on the
    card and on the CPU (full fp32 products on both)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.models import ssm
    dev = _card()
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")), ssm_chunk=32)
    cpu = ssm.Mamba1(cfg).requires_grad_(False)
    gen = np.random.default_rng(66)
    with torch.no_grad():
        cpu.init_constants()
        for name, p in cpu.named_parameters():
            if p.dim() == 2 and name != "A_log":
                p.copy_(torch.from_numpy(gen.standard_normal(p.shape).astype(np.float32))
                        * p.shape[-1] ** -0.5)
    card = ssm.Mamba1(cfg, device=dev).requires_grad_(False)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(gen.standard_normal((2, 41, cfg.d_model)).astype(np.float32))
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, :13] = False
    outs = []
    with exact_fp32():
        for mod, d in ((cpu, "cpu"), (card, dev)):
            y, (conv, h) = ssm.mamba1_forward(mod, x[:, :40].to(d), cfg, mask.to(d))
            step, (conv, h) = ssm.mamba1_decode(mod, x[:, 40:].to(d), cfg, conv, h)
            outs.append([t.cpu() for t in (y, step, conv, h)])
    for a, b in zip(*outs):
        _close(b, a, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b", "mamba2-2.7b"])
def test_generate_on_card_equals_plain_kernels(arch):
    """``ModelWorker.generate`` (the bucketed path) at full width cut to 2
    layers, fp32: through the kernels and through their plain versions on
    the card, greedy and sampled with per-request streams, the same tokens;
    the kernels launched once per attention (or SSD) layer per pass."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.models.model import init_params
    from repro_torch.serving import sampling
    from repro_torch.serving.workers import ModelWorker
    from repro_torch.sharding.context import ExecContext
    dev = _card()
    cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32",
                              param_dtype="float32")
    params = init_params(cfg, 0, dev)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (4, 37), dtype=np.int32)
    keys = [sampling.stream_key(0, arch, uid) for uid in range(4)]
    wrappers = (fmod.flash_attention, dmod.decode_attention, smod.ssd_scan)
    for temperature, row_keys in ((0.0, None), (0.8, keys)):
        out = {}
        with exact_fp32():
            for impl in ("plain", None):
                w = ModelWorker(arch, cfg, params, max_len=64, ctx=ExecContext(attn_impl=impl))
                before = [x.launches for x in wrappers]
                out[impl] = w.generate(prompts, 6, temperature=temperature, row_keys=row_keys)
                launched = [x.launches - b for x, b in zip(wrappers, before)]
        np.testing.assert_array_equal(out[None], out["plain"])
        if "ssd" in cfg.layer_kinds():
            assert launched == [0, 0, 2 * w.prefill_calls]
        else:
            assert launched == [2 * w.prefill_calls, 2 * w.decode_calls, 0]
            assert w.decode_calls == 5


@pytest.mark.gpu
def test_fleet_serving_replay_on_card_equals_plain_kernels_and_cpu():
    """A one-device ``FleetReplay(backend="serving")`` with tinyllama-1.1b at
    full width cut to 2 layers, fp32, as the assistant: on the card through
    the kernels, on the card through their plain versions
    (``ExecContext(attn_impl="plain")``) and on the CPU. Exact fp32: the
    assistant's tokens per uid are equal between the two card runs, and all
    three reports are equal (virtual time); the kernels launched only in
    the kernel run."""
    import copy

    from repro_torch.configs.base import get_config
    from repro_torch.fleet import FleetReplay, sample_population
    from repro_torch.fleet.workloads import ASSISTANT
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.models.model import init_params
    from repro_torch.sharding.context import ExecContext
    dev = _card()
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2, dtype="float32",
                              param_dtype="float32")
    cpu = init_params(cfg, 0, "cpu")
    card = copy.deepcopy(cpu).to(dev)
    reports, tokens = {}, {}
    with exact_fp32():
        for run, params, ctx in (("kernels", card, None), ("plain", card, ExecContext(attn_impl="plain")),
                                 ("cpu", cpu, None)):
            before = (fmod.flash_attention.launches, dmod.decode_attention.launches)
            rep = FleetReplay(
                sample_population(1, seed=0), scenario="chaos_mixed", duration_s=3.0, seed=5,
                calib_samples=60, backend="serving", uncertainty=True, risk_level=0.9,
                serving_models={ASSISTANT: (cfg, params)}, serving_ctx=ctx)
            reports[run] = rep.run().to_dict()
            launched = (fmod.flash_attention.launches - before[0],
                        dmod.decode_attention.launches - before[1])
            assert (min(launched) > 0) == (run == "kernels")
            tokens[run] = {r.uid: r.tokens.tolist() for r in rep.device_replays[0].responses
                           if r.error is None}
    assert tokens["kernels"] and sum(map(len, tokens["kernels"].values())) > len(tokens["kernels"])
    assert tokens["kernels"] == tokens["plain"]
    assert reports["kernels"] == reports["plain"] == reports["cpu"]
    assert reports["kernels"]["fleet"]["counters"]["faults"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv", [(64, 8), (32, 4)])  # kimi-k2; one rank of 2
def test_flash_kernel_at_head_dim_112(dtype, H, Hkv):
    """kimi-k2's head dim 112 (the bf16 kernel's 128-wide Q/K tile with its
    last 16 columns zero, a 112-wide V tile; the fp32 kernel's last column
    slot live on half the lanes): causal prefill across the tile edges and
    the verify's per-row offsets, every output column, 64-111 included."""
    dev = _card()
    for B, Sq, Sk, kw in ((2, 200, 200, dict(causal=True)), (1, 17, 17, dict(causal=True)),
                          (4, 5, 300, dict(causal=True, q_offset=torch.tensor(
                              [0, 63, 200, 295], device=dev)))):
        q = _randn(3, (B, Sq, H, 112), dtype, dev)
        k, v = (_randn(s, (B, Sk, Hkv, 112), dtype, dev) for s in (4, 5))
        before = fmod.flash_attention.launches
        out = fmod.flash_attention(q, k, v, **kw)
        assert fmod.flash_attention.launches == before + 1
        ref = fmod.flash_attention_plain(q, k, v, **kw)
        _close(out[..., 64:], ref[..., 64:], dtype)
        _close(out, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv", [(64, 8), (32, 4)])
@pytest.mark.parametrize("Smax", [2048, 64])
def test_decode_kernel_at_head_dim_112(dtype, H, Hkv, Smax):
    """Decode at G = 8, D 112: per-row positions (many splits at 2048, one
    at 64), a parked slot and a slot that keeps no key. Columns 64-111 are
    the ones a 64-of-112 lane layout (16 lanes x one 4-float vector in
    fp32) would leave unwritten: held to the plain version apart."""
    dev = _card()
    pos = [0, 1, 63, Smax - 1, Smax, 17, 40, Smax // 2]
    kv_len = [p + 1 for p in pos]
    kv_len[1] = 0
    B = len(pos)
    q = _randn(6, (B, 1, H, 112), dtype, dev)
    k, v = (_randn(s, (B, Smax, Hkv, 112), dtype, dev) for s in (7, 8))
    kw = dict(q_offset=torch.tensor(pos, device=dev), kv_len=torch.tensor(kv_len, device=dev))
    before = dmod.decode_attention.launches
    out = dmod.decode_attention(q, k, v, **kw)
    assert dmod.decode_attention.launches == before + 1
    ref = dmod.decode_attention_plain(q, k, v, **kw)
    _close(out[..., 64:], ref[..., 64:], dtype)
    _close(out, ref, dtype)
    assert float(out[1].abs().max()) == 0.0  # the row that keeps no key


@pytest.mark.gpu
def test_mesh_of_one_serve_on_card_equals_no_mesh():
    """tinyllama-1.1b at full width cut to 2 layers in fp32, and kimi-k2 at
    full width cut to 1 layer in bf16 (36.1 GiB; 72 in fp32), on the card:
    a continuous engine on a (1, 1) mesh serves the same tokens as one with
    no mesh, launches as many kernels, and reports sharded dims."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.slots import Request
    from repro_torch.sharding.context import ExecContext
    dev = _card()
    mesh = ExecContext(mesh=make_debug_mesh(1, 1), batch_axes=("data",), model_axis="model")
    for arch, layers, dtype in (("tinyllama-1.1b", 2, "float32"),
                                ("kimi-k2-1t-a32b", 1, "bfloat16")):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype,
                                  param_dtype=dtype)
        params = init_params(cfg, 0, dev)
        rng = np.random.default_rng(2)
        reqs = [(i, rng.integers(1, cfg.vocab_size, n, dtype=np.int32)) for i, n in
                enumerate((9, 40, 17, 64))]
        out = {}
        with exact_fp32():
            for key, ctx in (("none", ExecContext()), ("mesh1", mesh)):
                eng = ServingEngine(scheduler=None, max_slots=4)
                eng.add_model(arch, cfg, params, max_len=96, ctx=ctx)
                for uid, p in reqs:
                    eng.submit(arch, Request(uid, p, 5))
                before = (fmod.flash_attention.launches, dmod.decode_attention.launches)
                tokens = {r.uid: r.tokens.tolist() for r in eng.run_all()}
                launched = (fmod.flash_attention.launches - before[0],
                            dmod.decode_attention.launches - before[1])
                out[key] = (tokens, launched)
                if ctx.mesh is not None:
                    assert eng.workers[arch].shard_report.sharded > 0
                    assert eng.workers[arch].params is params
        assert out["none"] == out["mesh1"] and min(out["none"][1]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper", ["flash", "decode", "mla", "ssd"])
def test_kernel_wrappers_refuse_inputs_that_require_grad_on_card(wrapper):
    """A launch would hand autograd an output with no ``grad_fn``: each
    wrapper raises instead, and launches nothing."""
    from repro_torch.kernels import mla_attention as mmod
    dev = _card()

    def t(seed, *shape):
        return _randn(seed, shape, "bfloat16", dev).requires_grad_(True)

    calls = {"flash": (fmod.flash_attention, lambda: fmod.flash_attention(
                 t(0, 1, 64, 32, 64), t(1, 1, 64, 4, 64), t(2, 1, 64, 4, 64))),
             "decode": (dmod.decode_attention, lambda: dmod.decode_attention(
                 t(0, 1, 1, 32, 64), t(1, 1, 64, 4, 64), t(2, 1, 64, 4, 64))),
             "mla": (mmod.mla_attention, lambda: mmod.mla_attention(
                 t(0, 1, 1, 16, 576), t(1, 1, 64, 1, 576), t(2, 1, 64, 1, 512))),
             "ssd": (smod.ssd_scan, lambda: smod.ssd_scan(
                 t(0, 1, 64, 2, 64), t(1, 1, 64, 2).float(), t(2, 1, 64, 2).float(),
                 t(3, 1, 64, 128), t(4, 1, 64, 128)))}
    fn, call = calls[wrapper]
    before = fn.launches
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert fn.launches == before


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu():
    """One train step of reduced tinyllama (fp32, TF32 off) on the card and
    on the CPU from the same weights and batch, in its two halves: the
    loss and every gradient leaf (to fp32 summation order), then the AdamW
    update from the CPU's gradients (to an fp32 rounding)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.models.model import init_params, loss_fn, train_params
    from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state
    from repro_torch.training.train_loop import batch_to_device
    dev = _card()
    cfg = reduced(get_config("tinyllama-1.1b"))
    batch = SyntheticLM(cfg, DataConfig(batch=4, seq_len=64, seed=0)).batch(0)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    out = {}
    with exact_fp32():
        for d in ("cpu", dev):
            params = init_params(cfg, 0, "cpu").to(d)
            named = train_params(params)
            loss, _ = loss_fn(params, cfg, batch_to_device(batch, d))
            loss.backward()
            out[str(d)] = (params, named, float(loss.detach()),
                           {n: p.grad.detach().cpu() for n, p in named.items()})
        (pc, nc, lc, gc), (pg, ng, lg, gg) = out["cpu"], out[str(dev)]
        assert lg == pytest.approx(lc, rel=1e-5)
        for name, g in gc.items():
            torch.testing.assert_close(gg[name], g, rtol=0, atol=1e-4 * float(g.abs().max()))
        metrics = []
        for named, d in ((nc, "cpu"), (ng, dev)):
            with torch.no_grad():
                metrics.append(adamw_update(named, {n: g.to(d) for n, g in gc.items()},
                                            init_opt_state(named), oc))
    assert float(metrics[1]["grad_norm"]) == pytest.approx(float(metrics[0]["grad_norm"]),
                                                           rel=1e-6)
    for name, p in nc.items():
        torch.testing.assert_close(ng[name].detach().cpu(), p.detach(), rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
def test_bf16_checkpoint_round_trip_on_card(tmp_path):
    """Params and AdamW moments of a bf16 model on the card, saved after a
    step and restored into a fresh model: bit for bit, and the step."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params, train_params
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import batch_to_device, make_train_step
    dev = _card()
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = init_params(cfg, 1, dev)
    named = train_params(params)
    state = init_opt_state(named)
    make_train_step(cfg, oc=OptConfig(warmup_steps=1, total_steps=4))(
        params, state, batch_to_device(SyntheticLM(cfg, DataConfig(batch=2)).batch(0), dev))
    save_checkpoint(str(tmp_path), params, state, step=state["step"])
    fresh = init_params(cfg, 2, dev)
    fresh_state = init_opt_state(dict(fresh.named_parameters()))
    assert restore_checkpoint(str(tmp_path), fresh, fresh_state) == 1
    got = dict(fresh.named_parameters())
    for name, p in named.items():
        assert torch.equal(got[name].view(torch.int16), p.detach().view(torch.int16)), name
        for k in ("m", "v"):
            assert torch.equal(fresh_state[k][name].view(torch.int16),
                               state[k][name].view(torch.int16)), (k, name)


@pytest.mark.gpu
def test_yolo_on_card_matches_cpu():
    """yolo-v2-tiny at 416x416, B 2, fp32 (TF32 off): the card's output
    against the CPU's on the same weights, within 1e-4 of max |y|."""
    from repro_torch.models import convnet
    dev = _card()
    model = convnet.init_yolo(0, "cpu")
    x = np.random.default_rng(0).standard_normal((2, 416, 416, 3)).astype(np.float32)
    want = convnet.apply_yolo(model, torch.from_numpy(x))
    got = convnet.apply_yolo(model.to(dev), torch.from_numpy(x).to(dev)).cpu()
    assert got.shape == (2, 13, 13, 125)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def _dp_reference(cfg, batch, dev, D):
    """The unsharded step on ``dev``: the loss and gradients averaged over
    D data shards of ``batch``."""
    from repro_torch.models.model import init_params, train_params
    from repro_torch.training.train_loop import batch_to_device, loss_and_grads
    params = init_params(cfg, 0, dev)
    train_params(params)
    n = batch["tokens"].shape[0] // D
    losses, acc = [], None
    for d in range(D):
        sh = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
        loss, _, g = loss_and_grads(params, cfg, batch_to_device(sh, dev))
        losses.append(float(loss.detach()))
        g = {k: v.detach().cpu().clone() for k, v in g.items()}
        acc = g if acc is None else {k: acc[k] + g[k] for k in g}
    return sum(losses) / D, {k: v / D for k, v in acc.items()}


@pytest.mark.gpu
def test_data_parallel_train_step_on_card_matches_no_mesh():
    """Two ranks on the one card (gloo over CUDA tensors) on a (2, 1) mesh
    with FSDP: reduced tinyllama's fp32 loss and every gradient leaf,
    gathered whole, against the unsharded step on the card averaged over
    the two data shards (to fp32 summation order)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.launch.sharded import run_ranks, train_rank
    from repro_torch.training.optimizer import OptConfig
    dev = _card()
    cfg = reduced(get_config("tinyllama-1.1b"))
    batch = SyntheticLM(cfg, DataConfig(batch=4, seq_len=64, seed=0)).batch(0)
    job = dict(cfg=cfg, seed=0, batch=4, seq=64, steps=1, fsdp=True, grads=True,
               oc=OptConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    ranks = run_ranks(train_rank, 2, ([job], (2, 1), "cuda"), timeout=300, device_type="cuda")
    with exact_fp32():
        loss, grads = _dp_reference(cfg, batch, dev, 2)
    for r in ranks:
        res = r[0]
        assert res["data_shard"] is not None
        assert res["history"][0]["loss"] == pytest.approx(loss, rel=1e-5)
        for name, g in grads.items():
            torch.testing.assert_close(torch.from_numpy(res["grads"][name]), g, rtol=0,
                                       atol=1e-4 * float(g.abs().max()))


@pytest.mark.gpu
def test_data_parallel_serve_on_card_matches_no_mesh():
    """Continuous FIFO serving of tinyllama-1.1b at full width cut to 2
    layers, fp32, on a (2, 1) mesh of two ranks on the one card: each rank's
    tokens equal the unsharded engine's on the card, each rank holds half
    the pool and launches the flash and decode kernels."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import exact_fp32
    from repro_torch.launch.sharded import engine_rank, run_ranks, serve_job
    from repro_torch.sharding.context import ExecContext
    _card()
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2, dtype="float32",
                              param_dtype="float32")
    rng = np.random.default_rng(2)
    reqs = [(i, rng.integers(1, cfg.vocab_size, n, dtype=np.int32), 5)
            for i, n in enumerate((9, 40, 17, 64, 33, 12))]
    job = dict(cfg=cfg, seed=0, requests=reqs, max_slots=4, max_len=96)
    with exact_fp32():
        want = serve_job(job, ExecContext(), "cuda")
    ranks = run_ranks(engine_rank, 2, ([job], (2, 1), "cuda"), timeout=300, device_type="cuda")
    for r in ranks:
        got = r[0]
        assert got["tokens"] == want["tokens"] and got["pool_rows"] == 2
        assert got["launches"]["flash_attention"] > 0 and got["launches"]["decode_attention"] > 0


def _same_card_rank(rank):
    """One rank of a (2, 2) mesh on the card: the model and data groups'
    all-reduces and all-gathers through ``collectives`` against gloo's own,
    small tensors first, then one that grows the buffers."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import collectives
    from repro_torch.sharding.context import ExecContext
    ctx = ExecContext(mesh=make_debug_mesh(2, 2, "cuda"), batch_axes=("data",),
                      model_axis="model")
    out = []
    for shape in ((8, 64), (3, 5), (4096, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator().manual_seed(rank * 7 + len(out))
            x = torch.randint(-8, 8, shape, generator=gen).to(dtype).cuda()
            got = collectives.all_reduce(x.clone(), ctx)
            want = x.cpu().float()
            dist.all_reduce(want, group=ctx.model_group)
            parts = collectives.all_gather(x, 0, 2, ctx.data_group)
            ref = [torch.empty_like(x).cpu() for _ in range(2)]
            dist.all_gather(ref, x.cpu(), group=ctx.data_group)
            out.append((torch.equal(got.cpu().float(), want),
                        torch.equal(parts.cpu(), torch.cat(ref)),
                        collectives.same_card(x, ctx.model_group) is not None))
    return out


@pytest.mark.gpu
def test_same_card_collectives_match_gloo():
    """Four ranks of a (2, 2) mesh on the one card: the all-reduce over the
    model group and the all-gather over the data group go through the
    card's memory (``collectives.SameCard``) and give gloo's results bit
    for bit (integer-valued sums), fp32 and bf16, across a buffer growth."""
    from repro_torch.launch.sharded import run_ranks
    _card()
    for r in run_ranks(_same_card_rank, 4, (), timeout=300, device_type="cuda"):
        assert r and all(all(case) for case in r), r
