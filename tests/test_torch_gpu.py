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
