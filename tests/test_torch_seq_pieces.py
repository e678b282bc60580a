"""K/V caches and MLA latents cut on their sequence over the model ranks
that share them, in the port, on gloo CPU ranks, against the port's
unsharded run and the JAX package.

At a model axis of M > 1 a GQA kv head whole on M / Hkv ranks (its kv
group) has its K/V sequence cut over them, and MLA's one latent head over
all M model ranks; where the data ranks do not divide the batch, over the
data group too (``sharding.placement.plan_cache``). Without ranks: reduced
tinyllama-1.1b (2 kv heads) at M = 4, where rank m holds kv head m // 2
and sequence half m % 2; reduced deepseek-v2-lite-16b at M = 2 and 4 and
on (2, 2) with an odd slot pool, S / (D M) latent rows a rank, equal to
``launch.dryrun.rank_bytes``. The MLA piece mode's plain version on 2 and
4 pieces, at T = 1 and T = 5, with rows that keep no key of a piece:
merged by ``collectives.merge_states`` it equals the JAX package's
``full_attention`` over the whole latent, and its merged log-sum-exp the
whole latent's, in one merge or two levels of merges.

One spawn of four ranks runs, on (1, 4), reduced tinyllama's
``ModelWorker.generate`` (the JAX package's unsharded tokens) and its
continuous FIFO engine, reduced deepseek's FIFO engine, and a speculative
verify of T = 3 positions per slot (``decode_verify``) of both, and on
(2, 2) reduced deepseek's FIFO engine on an odd pool of 3 slots (the
latent cut over the data and the model ranks, merged at both levels); a
spawn of two ranks runs reduced deepseek's engine on (1, 2), and reduced
tinyllama's and gemma2's with the plan knob ``attn_seq_shard``. fp32: every
rank's tokens equal the port's unsharded run's, the verify's logits lie
within 1e-5 of each row's largest |logit|, and each decode launched the
piece mode and merged over its kv group once per attention layer.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import attention as jax_att  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.mla_attention import mla_attention_piece_plain  # noqa: E402
from repro_torch.launch.dryrun import rank_bytes  # noqa: E402
from repro_torch.launch.mesh import batch_axes_for, mesh_of  # noqa: E402
from repro_torch.launch.sharded import engine_rank, generate_rank, run_ranks, serve_job  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving.workers import ModelWorker  # noqa: E402
from repro_torch.sharding import collectives, placement  # noqa: E402
from repro_torch.sharding.context import ExecContext, MeshStandIn  # noqa: E402

RANK_LIMIT_S = 240.0
MAX_LEN, SLOTS, ODD = 32, 4, 3
REQS = [(8, 4), (11, 3), (5, 4), (9, 2)]  # (prompt, max_new)
GEN_B, GEN_S, GEN_NEW = 2, 7, 4
VERIFY_T = 3
LOGIT_TOL = 1e-5  # of each row's largest |logit|: fp32, sums split over the ranks
PIECE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process too (the ranks pin their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx(shape, rank, **kw):
    mesh = MeshStandIn(shape, rank)
    return ExecContext(mesh=mesh, batch_axes=batch_axes_for(mesh), model_axis="model", **kw)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(4))
def test_a_tinyllama_rank_holds_its_kv_head_and_half_its_sequence(rank):
    """Reduced tinyllama (4 query heads on 2 kv heads) at M = 4: rank m
    projects kv head m // 2, its kv group is the 2 ranks of that head, it
    holds piece m % 2, positions [16 (m % 2), 16 (m % 2) + 16) of 32, of
    that one head, and its slot pool is a quarter of the whole cache's
    bytes, the dry run's count."""
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    ctx = _ctx({"data": 1, "model": 4}, rank)
    assert (ctx.kv_group(cfg), ctx.kv_group_rank(cfg), ctx.piece_index(cfg)) == (2, rank % 2,
                                                                                 rank % 2)
    plan = placement.plan_params(cfg, ctx)
    assert tmodel.cuts(plan, "layers.0.attn.wk.weight", rank)[0][1:3] == (2, rank // 2)
    specs = placement.plan_cache(cfg, ctx, SLOTS, MAX_LEN)
    assert specs["k"][2:4] == specs["v"][2:4] == ("model", "model")
    cache = placement.init_placed_cache(cfg, ctx, specs, SLOTS, MAX_LEN, "meta")
    L = cfg.num_layers
    assert tuple(cache["k"].shape) == (L, SLOTS, MAX_LEN // 2, 1, cfg.head_dim)
    whole = sum(int(np.prod(s)) * 4 for s in placement.cache_shapes(cfg, SLOTS, MAX_LEN).values())
    got = rank_bytes(cfg, {"data": 1, "model": 4}, rank, SLOTS, MAX_LEN)["cache"]
    assert got * 4 == whole


@pytest.mark.parametrize("shape,slots", [((1, 2), SLOTS), ((1, 4), SLOTS), ((2, 2), ODD)],
                         ids=["1x2", "1x4", "2x2-odd"])
def test_the_mla_latent_holds_s_over_d_m_rows_a_rank(shape, slots):
    """Reduced deepseek's latent on (D, M): cut on its sequence over the M
    model ranks, and over the D data ranks where they do not divide the
    pool (3 slots on (2, 2)), every rank holding MAX_LEN / (D M) rows of
    all its columns (the rows of its slots where D divides them); the
    ranks' pieces are the P pieces of the sequence, once each; the bytes
    are the dry run's count."""
    cfg = configs.reduced(configs.get_config("deepseek-v2-lite-16b"))
    D, M = shape
    cut_d = D if slots % D else 1
    P, width = cut_d * M, cfg.kv_lora_rank + cfg.qk_rope_dim
    rows = slots if slots % D else slots // D
    pieces = []
    for rank in range(D * M):
        ctx = _ctx({"data": D, "model": M}, rank)
        specs = placement.plan_cache(cfg, ctx, slots, MAX_LEN)
        assert specs["latent"][2:] == ((("data", "model") if cut_d > 1 else "model"), None)
        want = cfg.num_layers * rows * (MAX_LEN // P) * width * 4
        assert rank_bytes(cfg, {"data": D, "model": M}, rank, slots, MAX_LEN)["cache"] == want
        seq = dataclasses.replace(ctx, batch_split=False, kv_seq=MAX_LEN) if cut_d > 1 else ctx
        assert seq.seq_pieces(cfg) == P
        pieces.append(seq.piece_index(cfg))
    assert sorted(pieces) == list(range(P))


# ---------------------------------------------------------------------------
# the MLA piece mode's plain version, merged, against the JAX package
# ---------------------------------------------------------------------------


def _mla_inputs(T):
    """q (B,T,16,24) and a latent (B,37,1,24) whose first 16 columns are
    the values; row 0 at position 0 (T = 1) keeps one key."""
    r = np.random.default_rng(11)
    B, S = 4, 37
    q = r.standard_normal((B, T, 16, 24)).astype(np.float32)
    k = r.standard_normal((B, S, 1, 24)).astype(np.float32)
    pos = np.array([0, 14, 20, 36 - (T - 1)], np.int32)
    return q, k, pos


def _pieces(q, k, pos, T, P):
    """The P pieces' (o, lse) states, each a (B,T,16,17) fp32 tensor."""
    B, S = k.shape[:2]
    n = -(-S // P)
    kw = (dict(causal=False, q_offset=torch.from_numpy(pos), kv_len=torch.from_numpy(pos + 1))
          if T == 1 else dict(causal=True, q_offset=torch.from_numpy(pos), kv_len=S))
    states = []
    for p in range(P):
        kp = np.zeros((B, n, 1, 24), np.float32)
        m = min(n, S - p * n)
        kp[:, :m] = k[:, p * n:p * n + m]
        kp = torch.from_numpy(kp)
        o, lse = mla_attention_piece_plain(torch.from_numpy(q), kp, kp[..., :16], k_start=p * n,
                                           scale=0.2, **kw)
        states.append(torch.cat([o, lse[..., None]], dim=-1))
    return states, kw


@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("T", [1, 5])
def test_mla_piece_plain_merged_matches_jax_full_attention(T, pieces):
    """16 heads on one latent head (24 wide, values its first 16 columns),
    a latent of 37 rows cut in 2 (19, 18) or 4 (10, 10, 10, 7) pieces, the
    last padded: each piece's plain piece mode at global positions, the
    decode step (T = 1, kv_len = position + 1) and a verify (T = 5,
    causal); a piece that keeps no key of a row gives o 0 and lse -1e30;
    the states merged in fp32 equal the JAX package's ``full_attention``
    over the whole latent, and the merged log-sum-exp the whole latent's
    (one piece of 37 rows). At 4 pieces, merging the pairs first and then
    the two pairs' states (the kv group, then the data group) gives the
    same attention."""
    q, k, pos = _mla_inputs(T)
    states, kw = _pieces(q, k, pos, T, pieces)
    empty = 0
    for s in states:
        none = s[..., -1] <= -1e29
        empty += int(none.sum())
        assert not s[..., :-1][none].any() and bool((s[..., -1][none] == -1e30).all())
    assert empty > 0  # row 0 keeps no key of the later pieces
    o, lse = collectives.merge_states(torch.stack(states))
    v = k[..., :16]
    want = np.asarray(jax_att.full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=T > 1, scale=0.2,
        q_offset=jnp.asarray(pos), kv_len=jnp.asarray(pos + 1) if T == 1 else None))
    np.testing.assert_allclose(o.numpy(), want, rtol=0, atol=PIECE_TOL)
    whole = _pieces(q, k, pos, T, 1)[0][0][..., -1]
    np.testing.assert_allclose(lse.numpy(), whole.numpy(), rtol=0, atol=PIECE_TOL)
    if pieces == 4:
        pairs = []
        for i in (0, 2):
            po, plse = collectives.merge_states(torch.stack(states[i:i + 2]))
            pairs.append(torch.cat([po, plse[..., None]], dim=-1))
        o2, lse2 = collectives.merge_states(torch.stack(pairs))
        np.testing.assert_allclose(o2.numpy(), o.numpy(), rtol=0, atol=PIECE_TOL)
        np.testing.assert_allclose(lse2.numpy(), lse.numpy(), rtol=0, atol=PIECE_TOL)


def test_mla_piece_meta_route_counts_the_piece_work():
    """On meta tensors (the dry run) ``mla_attention_piece`` returns fp32
    (o, lse) of the kernel's shapes, adds ``kernels.cost.mla_work``'s work
    of the piece (the rows from ``k_start`` that the rows keep: 256..304,
    49 of 128, for positions 300..304; fp32 o and
    lse) to the active counter and counts no launch; a G other than 16
    raises before it."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import mla_attention as mmod
    from repro_torch.utils.op_cost import OpCost
    lat = torch.empty((3, 128, 1, 576), dtype=torch.bfloat16, device="meta")
    q = torch.empty((3, 5, 16, 576), dtype=torch.bfloat16, device="meta")
    before, c = mmod.mla_attention_piece.launches, OpCost()
    with c:
        o, lse = mmod.mla_attention_piece(q, lat, lat[..., :512], k_start=256, causal=True,
                                          q_offset=300, kv_len=1024)
    assert (o.shape, o.dtype, lse.shape, lse.dtype) == ((3, 5, 16, 512), torch.float32,
                                                        (3, 5, 16), torch.float32)
    flops, nbytes = cost.mla_work(3, 5, 128, 16, 1, 576, 512, 2, causal=True, q_offset=300,
                                  kv_len=1024, k_start=256)
    assert c.summary()["kernels"]["mla_attention_piece"] == {"calls": 1, "flops": flops,
                                                            "bytes": nbytes}
    assert nbytes == 2 * (3 * 49 * 576 + 3 * 5 * 16 * 576) + 4 * 3 * 5 * 16 * 513
    assert mmod.mla_attention_piece.launches == before
    with pytest.raises(ValueError, match="piece mode takes G"):
        mmod.mla_attention_piece(torch.empty((3, 5, 8, 576), dtype=torch.bfloat16,
                                             device="meta"), lat, lat[..., :512], k_start=0)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


@functools.cache
def _pair(arch):
    """(JAX config, JAX params, the port's config, the numpy tree)."""
    jcfg = jax_configs.reduced(jax_configs.get_config(arch))
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, configs.reduced(configs.get_config(arch)), jax.tree.map(np.asarray, jp)


def _requests(cfg):
    r = np.random.default_rng(5)
    return [(i, r.integers(1, cfg.vocab_size, n, dtype=np.int32), new)
            for i, (n, new) in enumerate(REQS)]


def _serve(arch, slots=SLOTS, plan=None):
    cfg, tree = _pair(arch)[2:]
    return dict(cfg=cfg, tree=tree, requests=_requests(cfg), max_slots=slots, max_len=MAX_LEN,
                plan=plan)


def _gen(arch):
    cfg, tree = _pair(arch)[2:]
    r = np.random.default_rng(6)
    return dict(cfg=cfg, tree=tree, max_new=GEN_NEW, max_len=MAX_LEN,
                prompts=r.integers(1, cfg.vocab_size, (GEN_B, GEN_S), dtype=np.int32))


def _verify_job(arch):
    """Prompts of 9, 6, 12 and 4 tokens in four slots, then T = 3 tokens
    per slot from each slot's next position."""
    cfg, tree = _pair(arch)[2:]
    r = np.random.default_rng(8)
    lens = (9, 6, 12, 4)
    return dict(cfg=cfg, tree=tree, lens=lens,
                prompts=[r.integers(1, cfg.vocab_size, n, dtype=np.int32) for n in lens],
                tokens=r.integers(1, cfg.vocab_size, (SLOTS, VERIFY_T), dtype=np.int32))


def verify_run(job, ctx, device="cpu"):
    """A slot pool of SLOTS on ``ctx``: each prompt prefilled into its slot,
    then one ``decode_verify`` of T tokens per slot at its next position;
    returns the verify's logits and the kv-group merges it made."""
    cfg = job["cfg"]
    w = ModelWorker(cfg.name, cfg, params_from_numpy(job["tree"], cfg, device), MAX_LEN, ctx)
    pool = w.init_pool(SLOTS)
    for slot, prompt in enumerate(job["prompts"]):
        _, one = w.prefill_batch(prompt[None], slots=[slot], n_slots=SLOTS)
        pool = w.write_slots(pool, one, np.array([slot]))
    before = collectives.counts["merge_kv_group"]
    _, logits, _ = w.decode_verify(pool, job["tokens"], np.array(job["lens"], np.int32))
    return {"logits": logits.float().numpy(), "kv_merges": collectives.counts["merge_kv_group"]
            - before}


def _verify_rank(rank, jobs, mesh):
    dm = mesh_of(mesh, "cpu")
    ctx = ExecContext(mesh=dm, batch_axes=batch_axes_for(dm), model_axis="model")
    return [verify_run(job, ctx) for job in jobs]


SERVE14 = ("tinyllama-1.1b", "deepseek-v2-lite-16b")
VERIFY14 = ("tinyllama-1.1b", "deepseek-v2-lite-16b")


def _rank4(rank, serve14, gen14, verify14, serve22):
    torch.set_num_threads(1)
    return (engine_rank(rank, serve14, (1, 4), "cpu"), generate_rank(rank, gen14, 4, "cpu"),
            _verify_rank(rank, verify14, (1, 4)), engine_rank(rank, serve22, (2, 2), "cpu"))


def _rank2(rank, serve12):
    torch.set_num_threads(1)
    return engine_rank(rank, serve12, (1, 2), "cpu")


@pytest.fixture(scope="module")
def ranks4():
    """Four ranks, spawned once: (1, 4), then (2, 2)."""
    return run_ranks(_rank4, 4, ([_serve(a) for a in SERVE14], [_gen("tinyllama-1.1b")],
                                 [_verify_job(a) for a in VERIFY14],
                                 [_serve("deepseek-v2-lite-16b", ODD)]),
                     timeout=RANK_LIMIT_S, device_type="cpu")


# served on (1, 2) with the plan knob attn_seq_shard too (prompts of 11, 5
# and 9 tokens: 2 does not divide them)
SEQ12 = ("tinyllama-1.1b", "gemma2-2b")


@pytest.fixture(scope="module")
def ranks2():
    return run_ranks(_rank2, 2, ([_serve("deepseek-v2-lite-16b")]
                                 + [_serve(a, plan={"attn_seq_shard": True}) for a in SEQ12],),
                     timeout=RANK_LIMIT_S, device_type="cpu")


@functools.cache
def _unsharded(arch, slots=SLOTS):
    return serve_job(_serve(arch, slots), ExecContext(), "cpu")


def _check_serve(label, got, want, cfg):
    """A rank's serve against the unsharded one: the same tokens and
    passes; the piece mode launched (on the CPU: counted by the merges)
    once per attention layer per decode pass and merged over the kv group
    as often; no launch of a whole-cache kernel is possible on the CPU."""
    assert got["errors"] == [] and got["tokens"] == want["tokens"], label
    assert (got["prefill_calls"], got["decode_calls"]) == (want["prefill_calls"],
                                                           want["decode_calls"]), label
    layers = sum(k in ("attn", "local", "global") for k in cfg.layer_kinds())
    assert got["kv_merges"] == layers * got["decode_calls"] > 0, label


@pytest.mark.parametrize("arch", SERVE14)
def test_fifo_engine_on_1x4_matches_unsharded(ranks4, arch):
    """(1, 4): tinyllama's K/V cut in 2 pieces over each kv group,
    deepseek's latent in 4 over the model ranks."""
    i = SERVE14.index(arch)
    want = _unsharded(arch)
    for rank, r in enumerate(ranks4):
        _check_serve(f"{arch} rank {rank}", r[0][i], want, _pair(arch)[2])
        assert r[0][i]["shard"] == (4, rank)


def test_generate_on_1x4_matches_jax(ranks4):
    """``generate`` (the position-synchronous decode over a cut cache) of
    reduced tinyllama on (1, 4): every rank's tokens are the JAX package's
    unsharded worker's."""
    job = _gen("tinyllama-1.1b")
    jcfg, jp = _pair("tinyllama-1.1b")[:2]
    want = np.asarray(JaxWorker("u", jcfg, jp, max_len=MAX_LEN).generate(job["prompts"],
                                                                          GEN_NEW))
    for rank, r in enumerate(ranks4):
        np.testing.assert_array_equal(r[1][0]["tokens"], want, err_msg=f"rank {rank}")


@pytest.mark.parametrize("arch", VERIFY14)
def test_verify_on_1x4_matches_unsharded(ranks4, arch):
    """A verify of 3 positions per slot on (1, 4): tinyllama's as 3 piece
    decodes and one merge per layer, deepseek's as one causal MLA piece
    launch and one merge; the logits within LOGIT_TOL of the unsharded
    verify's, bit for bit equal on every rank."""
    i = VERIFY14.index(arch)
    want = verify_run(_verify_job(arch), ExecContext())["logits"]
    scale = np.abs(want).max(axis=-1, keepdims=True)
    layers = sum(k in ("attn", "local", "global") for k in _pair(arch)[2].layer_kinds())
    for rank, r in enumerate(ranks4):
        got = r[2][i]
        assert got["kv_merges"] == layers, rank
        np.testing.assert_array_equal(got["logits"], ranks4[0][2][i]["logits"])
        assert (np.abs(got["logits"] - want) <= LOGIT_TOL * scale).all(), rank
        np.testing.assert_array_equal(got["logits"].argmax(-1), want.argmax(-1))


def test_deepseek_on_2x2_with_an_odd_pool_matches_unsharded(ranks4):
    """(2, 2), 3 slots: the pool cut on its sequence over the data ranks,
    every row on every rank, the latent in 4 pieces over the data and model
    ranks; every decode merges over the kv group, then the data group."""
    want = _unsharded("deepseek-v2-lite-16b", ODD)
    for rank, r in enumerate(ranks4):
        got = r[3][0]
        _check_serve(f"rank {rank}", got, want, _pair("deepseek-v2-lite-16b")[2])
        assert got["merges"] == got["kv_merges"] and got["pool_rows"] == ODD


def test_deepseek_on_1x2_matches_unsharded(ranks2):
    """(1, 2): the latent in 2 pieces, one a model rank."""
    want = _unsharded("deepseek-v2-lite-16b")
    for rank, got in enumerate(ranks2):
        _check_serve(f"rank {rank}", got[0], want, _pair("deepseek-v2-lite-16b")[2])


@pytest.mark.parametrize("arch", SEQ12)
def test_attn_seq_shard_on_1x2_matches_unsharded(ranks2, arch):
    """(1, 2) with the plan knob ``attn_seq_shard``: each rank's prefill
    attends for both ranks' heads over its half of the prompt against the
    whole K/V (two all-to-alls per layer per prefill); the serve's tokens
    and passes are the unsharded run's."""
    want = _unsharded(arch)
    for rank, got in enumerate(ranks2):
        got = got[1 + SEQ12.index(arch)]
        assert got["errors"] == [] and got["tokens"] == want["tokens"], rank
        assert (got["prefill_calls"], got["decode_calls"]) == (want["prefill_calls"],
                                                               want["decode_calls"]), rank
        assert got["all_to_alls"] == 2 * _pair(arch)[2].num_layers * got["prefill_calls"] > 0
