"""Every serving mode of the port on a data axis of D > 1, on gloo CPU ranks,
against the JAX package's unsharded worker and engine.

The decode over a K/V cache cut on its sequence (the rule table's
placement of a cache whose batch the data ranks do not divide): the
piece mode's plain version on 2 and 3 pieces, merged in fp32
(``collectives.merge_states``), against the JAX package's
``full_attention`` on the whole cache, with rows whose kv_len falls inside
a piece, pieces a row keeps no key of, and a window and softcap that
cross a piece boundary.

Two ranks on a (2, 1) mesh, one spawn: ``ModelWorker.generate`` of
reduced tinyllama-1.1b and mamba2-2.7b at a batch of 4 (rows split) and
of 3 (tinyllama's cache cut on its sequence, mamba2's rows whole; its
first row LEFT-padded under a pad mask); the bucketed engine under
``AdaOperScheduler`` (odd buckets among its batches); the continuous
engine with a truncated draft on a row-split pool of 4 slots and a
sequence-cut pool of 3; the fleet replay with the serving backend. Four
ranks, one spawn: the bucketed engine on (2, 2) at a batch of 3, and on
the multi-pod mesh (pod 2, data 2, model 1) the continuous FIFO engine
and one FSDP train step over both batch axes. fp32 throughout: tokens
equal the JAX package's unsharded run's, the fleet report and the
train step's loss and gradients the port's unsharded run's. The JAX
package's own mesh path raises ``ShardingTypeError`` here (ROADMAP.md,
Queue 3).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import attention as jax_att  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import speculative as jax_spec  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.workers import ModelWorker as JaxWorker  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_piece_plain  # noqa: E402
from repro_torch.launch.sharded import (engine_rank, fleet_job, generate_rank,  # noqa: E402
                                        run_ranks, serve_job, train_rank)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.sharding.collectives import merge_states  # noqa: E402
from repro_torch.sharding.context import ExecContext  # noqa: E402
from repro_torch.training.optimizer import OptConfig, global_norm  # noqa: E402
from repro_torch.training.train_loop import batch_to_device, loss_and_grads  # noqa: E402

RANK_LIMIT_S = 240.0
MAX_LEN = 32
GEN_S, GEN_NEW, GEN_FRAMES = 9, 4, 7
# (prompt length, max_new): buckets of 4 (12), 3 (8) and 1 (10) requests
REQS = [(12, 4), (8, 3), (12, 2), (8, 4), (10, 3), (12, 5), (8, 2), (12, 3)]
FLEET = dict(devices=1, population_seed=4, scenario="chaos_voice", duration_s=2.5, seed=3,
             calib_samples=60)
TRAIN = dict(batch=4, seq=16, oc=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
PIECE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process too (the ranks pin their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the piece mode's plain version, merged, against the JAX package
# ---------------------------------------------------------------------------

# (softcap, window): tinyllama's plain heads, gemma2's softcap and window
PIECE_CASES = {"tinyllama": (None, None), "gemma2": (50.0, 8)}


@pytest.mark.parametrize("pieces", [2, 3])
@pytest.mark.parametrize("case", sorted(PIECE_CASES))
def test_piece_decode_merged_matches_jax_full_attention(case, pieces):
    """A (4, 37) cache cut in 2 (19, 18) or 3 (13, 13, 11) pieces, the
    last one padded to the piece length: each piece's plain decode at
    global positions, the fp32 states merged, against the JAX package's
    ``full_attention`` over the whole cache at ``kv_len = pos + 1``. Row 0
    keeps one key (its other pieces keep none), row 1's and row 2's kv_len
    fall inside a piece, and the window of 8 crosses a piece boundary at
    positions 14 and 20."""
    softcap, window = PIECE_CASES[case]
    r = np.random.default_rng(7)
    B, S, H, Hkv, D = 4, 37, 4, 2, 16
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    pos = np.array([0, 14, 20, 36], np.int32)
    want = np.asarray(jax_att.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=False, window=window, softcap=softcap,
                                             q_offset=jnp.asarray(pos),
                                             kv_len=jnp.asarray(pos + 1)))
    n = -(-S // pieces)
    states, empty = [], 0
    for d in range(pieces):
        kp, vp = np.zeros((B, n, Hkv, D), np.float32), np.zeros((B, n, Hkv, D), np.float32)
        m = min(n, S - d * n)
        kp[:, :m], vp[:, :m] = k[:, d * n:d * n + m], v[:, d * n:d * n + m]
        o, lse = decode_attention_piece_plain(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), k_start=d * n,
            q_offset=torch.from_numpy(pos), kv_len=torch.from_numpy(pos + 1), window=window,
            softcap=softcap)
        empty += int((lse <= -1e29).all(dim=-1).sum())
        states.append(torch.cat([o, lse[..., None]], dim=-1))
    got = merge_states(torch.stack(states))[0].numpy()
    assert empty >= pieces - 1  # row 0 keeps no key of the later pieces
    np.testing.assert_allclose(got, want, rtol=0, atol=PIECE_TOL)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


@functools.cache
def _pair(arch):
    jcfg = jax_configs.reduced(jax_configs.get_config(arch))
    jp = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, configs.reduced(configs.get_config(arch)), jax.tree.map(np.asarray, jp)


def _requests(cfg):
    r = np.random.default_rng(3)
    return [(i, r.integers(1, cfg.vocab_size, plen, dtype=np.int32), new)
            for i, (plen, new) in enumerate(REQS)]


def _gen_job(arch, B):
    """``generate``'s inputs at a batch of B; mamba2's first row 3 pad
    tokens, then valid ones, under a pad mask; seamless with GEN_FRAMES
    encoder frames per row."""
    cfg, tree = _pair(arch)[2:]
    r = np.random.default_rng(4)
    job = dict(cfg=cfg, tree=tree, max_new=GEN_NEW, max_len=MAX_LEN,
               prompts=r.integers(1, cfg.vocab_size, (B, GEN_S), dtype=np.int32))
    if cfg.family == "ssm":
        mask = np.ones((B, GEN_S), bool)
        mask[0, :3] = False
        job["prompts"][0, :3] = 0
        job["pad_mask"] = mask
    if cfg.is_encoder_decoder:
        job["enc_inputs"] = r.standard_normal((B, GEN_FRAMES, cfg.d_model)).astype(np.float32)
    return job


# at a batch of 3 seamless's self- and cross-attention caches are cut on
# their sequence (7 frames: pieces of 4 and 3)
GEN_JOBS = [("tinyllama-1.1b", 4), ("tinyllama-1.1b", 3), ("mamba2-2.7b", 4), ("mamba2-2.7b", 3),
            ("seamless-m4t-medium", 3)]


def _eng_jobs():
    """(2, 1)'s engine jobs: the scheduled bucketed engine, the truncated
    draft on 4 and on 3 slots, the fleet replay."""
    cfg, tree = _pair("tinyllama-1.1b")[2:]
    base = dict(cfg=cfg, tree=tree, requests=_requests(cfg), max_len=MAX_LEN)
    return [dict(base, max_slots=8, mode="bucketed", scheduled=True),
            dict(base, max_slots=4, draft="truncated"),
            dict(base, max_slots=3, draft="truncated"),
            dict(cfg=cfg, tree=tree, replay=FLEET)]


def _four_jobs():
    """The four ranks' jobs: the (2, 2) bucketed FIFO engine, the
    (2, 2, 1) continuous FIFO engine and FSDP train step."""
    cfg, tree = _pair("tinyllama-1.1b")[2:]
    base = dict(cfg=cfg, tree=tree, requests=_requests(cfg), max_len=MAX_LEN)
    return ([dict(base, max_slots=8, mode="bucketed")], [dict(base, max_slots=4)],
            [dict(cfg=cfg, tree=tree, steps=1, fsdp=True, grads=True, **TRAIN)])


def _rank2(rank, gen_jobs, eng_jobs):
    torch.set_num_threads(1)
    return generate_rank(rank, gen_jobs, (2, 1), "cpu"), engine_rank(rank, eng_jobs, (2, 1), "cpu")


def _rank4(rank, bucketed, fifo, train):
    torch.set_num_threads(1)
    return (engine_rank(rank, bucketed, (2, 2), "cpu"), engine_rank(rank, fifo, (2, 2, 1), "cpu"),
            train_rank(rank, train, (2, 2, 1), "cpu"))


@pytest.fixture(scope="module")
def ranks2():
    """The (2, 1) mesh's two ranks, spawned once for every job."""
    return run_ranks(_rank2, 2, ([_gen_job(*g) for g in GEN_JOBS], _eng_jobs()),
                     timeout=RANK_LIMIT_S, device_type="cpu")


@pytest.fixture(scope="module")
def ranks4():
    """Four ranks, spawned once: (2, 2), then (pod 2, data 2, model 1)."""
    return run_ranks(_rank4, 4, _four_jobs(), timeout=RANK_LIMIT_S, device_type="cpu")


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


@functools.cache
def _jax_tokens(params_key, mode="continuous", max_slots=4):
    """The JAX package's unsharded FIFO engine on reduced tinyllama (its
    weights, or the truncated draft's target), uid -> tokens."""
    jcfg, jp = _pair("tinyllama-1.1b")[:2]
    if params_key == "truncated":
        jp = jax_spec.truncated_draft(jcfg, jp)[2]
    eng = JaxEngine(mode=mode, max_slots=max_slots)
    eng.add_model("m", jcfg, jp, max_len=MAX_LEN)
    for uid, prompt, new in _requests(jcfg):
        eng.submit("m", JaxRequest(uid, prompt, new))
    out = {r.uid: r for r in eng.run_all()}
    assert all(r.error is None for r in out.values())
    return {uid: [int(t) for t in r.tokens] for uid, r in out.items()}


@pytest.mark.parametrize("i", range(len(GEN_JOBS)),
                         ids=[f"{a}-B{b}" for a, b in GEN_JOBS])
def test_generate_on_a_data_axis_matches_jax(ranks2, i):
    """``generate`` on (2, 1): every rank returns every row's tokens, the
    JAX package's unsharded worker's. At a batch of 4 each rank ran its 2
    rows; at 3 tinyllama's cache was cut on its sequence (every rank ran
    every row and merged its decode over the data group), mamba2's state
    held every row whole, and seamless's cross cache was cut too (its
    decode masked to the frames' global length)."""
    arch, B = GEN_JOBS[i]
    job = _gen_job(arch, B)
    jcfg, jp = _pair(arch)[:2]
    want = JaxWorker("u", jcfg, jp, max_len=MAX_LEN).generate(
        job["prompts"], GEN_NEW, enc_inputs=job.get("enc_inputs"), pad_mask=job.get("pad_mask"))
    for rank, r in enumerate(ranks2):
        np.testing.assert_array_equal(r[0][i]["tokens"], np.asarray(want), err_msg=f"rank {rank}")


class _Mesh:
    """A stand-in mesh with a process's coordinates on each axis."""

    def __init__(self, coords, **shape):
        self.shape, self.coords = shape, coords

    def get_local_rank(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("pod,data", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_data_rank_is_row_major_over_the_batch_axes(pod, data):
    """On (pod 2, data 2, model 2) a rank's data rank is pod * 2 + data,
    the batch is cut 4 ways, and its mesh rank (what ``init_params`` and
    ``convert.shard_params`` cut by) is its global rank; a batch axis of
    one adds nothing to either."""
    ctx = ExecContext(mesh=_Mesh(dict(pod=pod, data=data, model=1), pod=2, data=2, model=2),
                      batch_axes=("pod", "data"), model_axis="model")
    assert (ctx.batch_parallel, ctx.data_rank) == (4, 2 * pod + data)
    assert tmodel.mesh_rank(ctx) == (2 * pod + data) * 2 + 1
    one = ExecContext(mesh=_Mesh(dict(pod=0, data=data, model=0), pod=1, data=2, model=2),
                      batch_axes=("pod", "data"), model_axis="model")
    assert (one.batch_parallel, one.data_rank) == (2, data)


def test_bucketed_scheduled_engine_on_a_data_axis(ranks2):
    """The bucketed engine under ``AdaOperScheduler`` on (2, 1): the same
    batches as the unsharded port's, some of them odd (their caches cut on
    their sequence), and on every rank the JAX package's unsharded tokens
    per uid."""
    job = _eng_jobs()[0]
    want = serve_job(job, ExecContext(), "cpu")
    assert any(b % 2 for b in want["batches"]), want["batches"]
    jax_tokens = _jax_tokens("plain", "bucketed", 8)
    assert want["tokens"] == jax_tokens
    for rank, r in enumerate(ranks2):
        got = r[1][0]
        assert got["errors"] == [] and got["batches"] == want["batches"], rank
        assert got["tokens"] == jax_tokens, rank
        assert got["merges"] > 0  # the odd buckets' decodes
        assert got["pool_rows"] is None  # generate's caches, no slot pool


@pytest.mark.parametrize("j,slots", [(1, 4), (2, 3)], ids=["rows-split", "sequence-cut"])
def test_speculative_engine_on_a_data_axis(ranks2, j, slots):
    """The continuous engine with a truncated draft on (2, 1): a pool of
    4 slots split on its rows (each rank drafts and verifies its slots,
    the accepted counts and tokens all-gathered), a pool of 3 cut on its
    sequence (the verify as T merged decodes). Every rank's tokens are the
    JAX package's unsharded greedy tokens of the target; the spec counters
    and the passes equal the unsharded port's, so both ranks took every k
    alike."""
    job = _eng_jobs()[j]
    want = serve_job(job, ExecContext(), "cpu")
    jax_tokens = _jax_tokens("truncated")
    assert want["tokens"] == jax_tokens and want["spec"]["spec_rounds"] > 0
    for rank, r in enumerate(ranks2):
        got = r[1][j]
        assert got["errors"] == [] and got["tokens"] == jax_tokens, rank
        assert got["spec"] == want["spec"], rank
        assert (got["verify_calls"], got["draft_calls"]) == (want["verify_calls"],
                                                             want["draft_calls"])
        assert got["pool_rows"] == (slots // 2 if slots % 2 == 0 else slots)
        assert (got["merges"] > 0) == (slots % 2 == 1)


def test_fleet_replay_on_a_data_axis_matches_unsharded(ranks2):
    """The fleet replay's serving backend on (2, 1): every rank replays
    the whole population, and its report (``to_dict()``) and its engines'
    tokens equal the port's unsharded replay's."""
    job = _eng_jobs()[3]
    want = fleet_job(job, ExecContext(), "cpu")
    assert want["report"]["fleet"]["n_requests"] > 0 and want["pool_rows"]
    for rank, r in enumerate(ranks2):
        got = r[1][3]
        assert got["report"] == want["report"], rank
        assert got["tokens"] == want["tokens"], rank
        assert got["pool_rows"] == [n // 2 if n % 2 == 0 else n for n in want["pool_rows"]]


def test_bucketed_engine_on_a_2x2_mesh_at_a_batch_of_3(ranks4):
    """The bucketed FIFO engine on (2, 2): its buckets of 4, 3 and 1
    requests served whole (3 and 1 on caches cut on their sequence over
    the data axis, their kv heads over the model axis), every rank's
    tokens the JAX package's unsharded bucketed engine's."""
    want = _jax_tokens("plain", "bucketed", 8)
    for rank, r in enumerate(ranks4):
        got = r[0][0]
        assert got["errors"] == [] and got["tokens"] == want, rank
        assert sorted(got["batches"]) == [1, 3, 4] and got["merges"] > 0
        assert got["pool_rows"] is None
        assert got["shard"] == (2, rank % 2)


def test_fifo_engine_on_the_multi_pod_mesh(ranks4):
    """The continuous FIFO engine on (pod 2, data 2, model 1): a data
    group of 4 over both batch axes, one pool row per rank, every rank's
    tokens the JAX package's unsharded engine's."""
    want = _jax_tokens("plain")
    for rank, r in enumerate(ranks4):
        got = r[1][0]
        assert got["errors"] == [] and got["tokens"] == want, rank
        assert got["pool_rows"] == 1


@functools.cache
def _port_train_ref(D):
    """The port's unsharded loss and gradients, the mean over D shards."""
    cfg, tree = _pair("tinyllama-1.1b")[2:]
    params = params_from_numpy(tree, cfg, "cpu")
    tmodel.train_params(params)
    batch = SyntheticLM(cfg, DataConfig(batch=TRAIN["batch"], seq_len=TRAIN["seq"])).batch(0)
    k = TRAIN["batch"] // D
    losses, acc = [], None
    for i in range(D):
        sh = {key: v[i * k:(i + 1) * k] for key, v in batch.items()}
        loss, _, g = loss_and_grads(params, cfg, batch_to_device(sh, "cpu"))
        losses.append(float(loss))
        g = {n: t.clone() for n, t in g.items()}
        acc = g if acc is None else {n: acc[n] + g[n] for n in g}
    grads = {n: t / D for n, t in acc.items()}
    return float(np.mean(losses)), float(global_norm(grads)), {n: t.numpy()
                                                              for n, t in grads.items()}


def test_fsdp_train_step_on_the_multi_pod_mesh(ranks4):
    """One FSDP train step on (pod 2, data 2, model 1): the weights cut
    4 ways over both batch axes, each rank on its row of the batch; every
    rank's global mean loss, its clipping norm and every gradient leaf
    (gathered whole over the data group) against the port's unsharded
    step, the mean over the 4 data shards, fp32."""
    loss, gn, grads = _port_train_ref(4)
    for rank, r in enumerate(ranks4):
        res = r[2][0]
        assert res["data_shard"] == (4, rank)
        assert abs(res["history"][0]["loss"] - loss) <= LOSS_RTOL * abs(loss), rank
        assert abs(res["history"][0]["grad_norm"] - gn) <= LOSS_RTOL * gn, rank
        assert set(res["grads"]) == set(grads)
        for leaf, ref in grads.items():
            np.testing.assert_allclose(res["grads"][leaf], ref, rtol=0,
                                       atol=GRAD_TOL * np.abs(ref).max(), err_msg=leaf)
