"""The collectives of explicit SPMD over the (data, model) mesh.

Model axis. Column-parallel layers (q/k/v, gate/up, the LM head's vocab
columns) leave each rank a slice of the output; row-parallel layers (the
attention output and MLP down projections, the vocab-sharded embedding,
the expert-parallel MoE) leave each rank a partial sum of the whole output.
``reduce_from_model`` sums the partials and ``all_gather_last``
concatenates the slices over the model axis's process group, in place of
the ``psum`` / ``all_gather`` that GSPMD inserts for the JAX package.

Without gradients (serving) each is one in-place call on the activations,
counted on ``all_reduce.calls`` / ``all_gather_last.calls``. On a tensor
that requires grad (train mode) each is a ``torch.autograd.Function`` of
Megatron's pair: ``copy_to_model`` (identity forward, all-reduce backward)
goes before a column-parallel input and ``reduce_from_model`` (all-reduce
forward, identity backward) after a row-parallel output, so a loss that
every model rank computes alike gets each weight's gradient once, not M
times; ``all_gather_last``'s backward takes the rank's own slice.
``sum_over_model`` (all-reduce forward and backward) sums a statistic
that every rank applies to its own channels, so its gradient is the sum of
the ranks' gradients.
``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces the gradient too, which gives M times the gradient here.

Data axes. ``fsdp_gather`` all-gathers a weight that this rank holds 1/D
of (FSDP; ``gathered`` swaps the whole weights into a module for the span
of one layer, ZeRO-3 style, so remat recomputes the gather), and its
backward reduce-scatters the gradient: each data rank gets the sum over
the data group of its slice. ``gather_batch`` / ``scatter_batch`` move
activation rows over the data group the same two ways (the 2-D MoE).
Gloo has no reduce-scatter: there it is an all-reduce followed by the
rank's slice (NCCL's ``reduce_scatter_tensor`` elsewhere).

A decode over a cache cut on its sequence (``ExecContext``'s kv group and
``kv_seq``) attends over the rank's piece and merges the pieces' partial
softmax states: ``gather_kv_group`` hands every rank of a kv group the
group's queries (each rank then attends for all of them), and
``merge_kv_group`` merges the group's fp32 (output, log-sum-exp) states, a
model-axis all-gather each with the group's slices kept (no process group
per kv group); ``merge_attention`` then merges the data ranks' states
over the data group where ``kv_seq`` cuts the sequence there too. The
merge is the same fp32 arithmetic on every rank (``merge_states``), so
every rank gets the same bits, and it returns the merged log-sum-exp, so
the two levels compose.

The plan knob ``attn_seq_shard`` (``models.attention.gqa_forward``) moves
a GQA layer's queries and outputs between head-cut and sequence-cut
layouts over the model axis (``seq_to_heads`` / ``heads_to_seq``: one
all-to-all each, each the other's backward) and gathers every kv head
whole (``gather_kv_heads``, whose backward reduce-scatters).

Every differentiable call is counted on ``counts`` by kind, forward and
backward alike. All return their input untouched on an axis of one (a
mesh of one runs no collective, so it computes exactly what the
single-device path computes).

The tensors stay where the model runs: CUDA tensors on the card. NCCL
refuses two ranks on one device, so ranks that share one card meet over
``gloo``, whose CUDA collectives stage every tensor through host memory.
Their all-reduces and all-gathers go through the card's own memory
instead (``SameCard``); gloo keeps only a barrier. Among 8 ranks on one
H100 an all-reduce of a decode step's 64 KB takes 35 ms through gloo and
8 ms this way, of a prefill's 32 MB 169 and 12 ms (``chip_smoke.py
--phases collectives``). Every rank gets the same bits
from a collective, so ranks that start from the same inputs take the same
decisions (``serving.workers``).

Meta tensors (the dry run, ``launch.dryrun``, on a
``context.MeshStandIn``) take a meta transport: no process group is
reached, each collective returns a meta result of the right shape and adds
its kind and result bytes to the active op counter
(``utils.op_cost.record_collective``), as the reference's
``hlo_stats.collective_stats`` counts an HLO collective's result.
"""
from __future__ import annotations

import collections
import contextlib

import torch
import torch.distributed as dist

from repro_torch.utils import op_cost

counts: collections.Counter = collections.Counter()


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class SameCard:
    """The all-reduce and all-gather of a gloo group whose ranks all run on
    one card, through the card's memory: each rank copies its tensor into a
    buffer of its own that every rank of the group has mapped (CUDA IPC
    handles, exchanged once over gloo), waits for the copy, meets the others
    at a gloo barrier, and reads every rank's buffer in rank order. Two
    buffers alternate, so one barrier per call keeps a rank from
    overwriting a buffer that another may still read: a rank passes the
    next call's barrier only after its stream has finished the reads of
    this one. An all-reduce sums the ranks' tensors in rank order (bf16 and
    fp16 in fp32, rounded once), so every rank gets the same bits. The
    buffers grow, on every rank at once, to the largest tensor seen."""

    def __init__(self, group):
        self.group = group
        self.rank, self.n = dist.get_rank(group), dist.get_world_size(group)
        self.cap, self.step = 0, 0
        self.bufs: list = []
        self.peers: list = []

    def _grow(self, nbytes: int, device) -> None:
        from torch.multiprocessing.reductions import reduce_tensor
        if self.bufs:  # every rank is done with the old buffers before they go
            torch.cuda.current_stream(device).synchronize()
            dist.barrier(group=self.group)
        self.cap = max(nbytes, 2 * self.cap, 1 << 20)
        self.bufs = [torch.empty(self.cap, dtype=torch.uint8, device=device) for _ in range(2)]
        handles = [None] * self.n
        dist.all_gather_object(handles, [reduce_tensor(b) for b in self.bufs], group=self.group)
        self.peers = [self.bufs if r == self.rank else [fn(*args) for fn, args in h]
                      for r, h in enumerate(handles)]

    def _exchange(self, x: torch.Tensor) -> list:
        """Every rank's ``x``, in rank order: views of the buffers, valid
        until the call after the next."""
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        if nbytes > self.cap:
            self._grow(nbytes, x.device)
        k = self.step % 2
        self.step += 1
        self.bufs[k][:nbytes].copy_(x.reshape(-1).view(torch.uint8))
        torch.cuda.current_stream(x.device).synchronize()
        dist.barrier(group=self.group)
        return [p[k][:nbytes].view(x.dtype).view(x.shape) for p in self.peers]

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the group, in place."""
        parts = self._exchange(x)
        wide = x.dtype in (torch.bfloat16, torch.float16)
        acc = parts[0].float() if wide else parts[0].clone()
        for p in parts[1:]:
            acc += p
        return x.copy_(acc)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise largest ``x`` over the group, in place."""
        parts = self._exchange(x)
        acc = parts[0].clone()
        for p in parts[1:]:
            torch.maximum(acc, p, out=acc)
        return x.copy_(acc)

    def all_gather(self, x: torch.Tensor) -> list:
        return [p.clone() for p in self._exchange(x)]


_same_card: dict = {}


def same_card(x: torch.Tensor, group):
    """The ``SameCard`` transport of ``group`` for ``x``, or None where gloo
    (or NCCL) carries it: a CPU tensor, a backend other than gloo, or ranks
    on more than one card. Decided at the group's first CUDA collective,
    which every rank of the group reaches at the same point."""
    if not x.is_cuda or dist.get_backend(group) != "gloo":
        return None
    t = _same_card.get(group)
    if t is None:
        cards = [None] * dist.get_world_size(group)
        dist.all_gather_object(cards, str(torch.cuda.get_device_properties(x.device).uuid),
                               group=group)
        t = _same_card[group] = SameCard(group) if len(set(cards)) == 1 else False
    return t or None


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place."""
    if x.is_meta:
        op_cost.record_collective("all-reduce", op_cost.tensor_bytes(x))
        return x
    t = same_card(x, group)
    if t is not None:
        return t.all_reduce(x)
    dist.all_reduce(x, group=group)
    return x


def _reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise largest ``x`` over ``group``, in place."""
    if x.is_meta:
        op_cost.record_collective("all-reduce", op_cost.tensor_bytes(x))
        return x
    t = same_card(x, group)
    if t is not None:
        return t.all_reduce_max(x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def _gather(x: torch.Tensor, n: int, group) -> list:
    """The ``n`` ranks' ``x`` of ``group``, in rank order."""
    x = x.contiguous()
    if x.is_meta:
        op_cost.record_collective("all-gather", n * op_cost.tensor_bytes(x))
        return [torch.empty_like(x) for _ in range(n)]
    t = same_card(x, group)
    if t is not None:
        return t.all_gather(x)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def _all_reduce(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    x = _reduce(x.contiguous().clone(), group)
    counts[kind] += 1
    return x


def all_gather(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The ``n`` ranks' ``x`` of ``group`` concatenated along ``dim``, in
    rank order, without grad."""
    parts = _gather(x, n, group)
    counts["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, n: int, rank: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, cut in ``n`` along ``dim``: piece
    ``rank``."""
    if x.is_meta:
        shape = list(x.shape)
        shape[dim] //= n
        out = x.new_empty(shape)
        op_cost.record_collective("reduce-scatter", op_cost.tensor_bytes(out))
        counts["reduce_scatter"] += 1
        return out
    if dist.get_backend(group) == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        counts["reduce_scatter"] += 1
        return out.movedim(0, dim).contiguous()
    full = _all_reduce(x, group, "reduce_scatter")  # gloo: all-reduce, then the slice
    size = x.shape[dim] // n
    return full.narrow(dim, rank * size, size).contiguous()


# ---- the model axis ---------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g, fctx.ctx.model_group, "all_reduce"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return _all_reduce(x, ctx.model_group, "all_reduce")

    @staticmethod
    def backward(fctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_reduce(x, ctx.model_group, "all_reduce")

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g, fctx.ctx.model_group, "all_reduce"), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx, fctx.n = ctx, x.shape[-1]
        counts["all_gather_last"] += 1
        return all_gather(x, -1, ctx.model_parallel, ctx.model_group)

    @staticmethod
    def backward(fctx, g):
        n = fctx.n
        return g.narrow(-1, fctx.ctx.model_rank * n, n).contiguous(), None


def copy_to_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """The input of a column-parallel region: ``x`` itself, whose gradient
    is summed over the model axis (with grad only; serving passes ``x``)."""
    if ctx.model_parallel == 1 or not _grad_path(x):
        return x
    return _CopyToModel.apply(x, ctx)


def all_reduce(x: torch.Tensor, ctx) -> torch.Tensor:
    """Sum ``x`` over the model axis, in place; ``x`` at one shard."""
    if ctx.model_parallel == 1:
        return x
    _reduce(x, ctx.model_group)
    all_reduce.calls += 1
    return x


def reduce_from_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum over the model axis of a row-parallel output: in place
    without grad (``all_reduce``), else with the identity backward."""
    if ctx.model_parallel == 1:
        return x
    if _grad_path(x):
        return _ReduceFromModel.apply(x, ctx)
    return all_reduce(x, ctx)


def sum_over_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum over the model axis of a statistic that every rank then
    applies to its own part of the output (Mamba2's gated-norm sum of
    squares): in place without grad (``all_reduce``), else with an
    all-reduce backward, since each rank's output depends on every rank's
    input (``reduce_from_model``'s identity backward would keep only the
    rank's own share of the gradient)."""
    if ctx.model_parallel == 1:
        return x
    if _grad_path(x):
        return _SumOverModel.apply(x, ctx)
    return all_reduce(x, ctx)


def all_gather_last(x: torch.Tensor, ctx) -> torch.Tensor:
    """Concatenate the ranks' slices along the last dim, rank order; with
    grad, the backward takes the rank's own slice."""
    n = ctx.model_parallel
    if n == 1:
        return x
    if _grad_path(x):
        return _GatherLast.apply(x, ctx)
    parts = _gather(x, n, ctx.model_group)
    all_gather_last.calls += 1
    return torch.cat(parts, dim=-1)


all_reduce.calls = 0
all_gather_last.calls = 0


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(fctx, logits, labels, ctx):
        n = logits.shape[-1]
        v0 = ctx.model_rank * n
        top = _reduce_max(logits.amax(dim=-1), ctx.model_group)
        counts["all_reduce_max"] += 1
        p = torch.exp(logits - top[..., None])
        mine = (labels >= v0) & (labels < v0 + n)
        idx = (labels - v0).clamp(0, n - 1).long()[..., None]
        gold = torch.where(mine, torch.gather(logits, -1, idx)[..., 0], 0.0)
        sums = _all_reduce(torch.stack([p.sum(dim=-1), gold]), ctx.model_group, "all_reduce")
        p /= sums[0][..., None]
        fctx.save_for_backward(p, idx, mine)
        return top + torch.log(sums[0]) - sums[1]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(fctx, g):
        p, idx, mine = fctx.saved_tensors
        grad = p.mul_(g[..., None])  # the saved softmax, used once
        grad.scatter_add_(-1, idx, -(g * mine)[..., None])
        return grad, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, ctx) -> torch.Tensor:
    """Per position, log-sum-exp minus the gold logit over the whole
    vocabulary, from this model rank's slice of it: ``logits`` (..., V/M)
    fp32, the columns [r V/M, (r + 1) V/M) of model rank r, and ``labels``
    (...) global ids. Megatron's vocabulary-parallel cross-entropy: the
    rows' largest logit by an all-reduce (max) over the model group
    (``counts["all_reduce_max"]``), then one all-reduce (sum) of each row's
    sum of exp and of its gold logit, which only the rank whose columns
    hold the label contributes (``counts["all_reduce"]``). Every model rank
    returns the same values. The backward gives the rank's slice of
    softmax minus one-hot times the incoming gradient, from the softmax
    saved in the forward (no collective: the loss is the same on every
    rank, so is its gradient); no whole row is formed. For M > 1 (at M = 1
    ``models.model.loss_fn`` keeps its whole-row route)."""
    return _VocabNLL.apply(logits, labels, ctx)


# ---- the data axes ----------------------------------------------------------


class _DataGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.dim, fctx.ctx = dim, ctx
        return all_gather(x, dim, ctx.batch_parallel, ctx.data_group)

    @staticmethod
    def backward(fctx, g):
        c = fctx.ctx
        return _reduce_scatter(g, fctx.dim, c.batch_parallel, c.data_rank, c.data_group), None, None


class _DataScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.dim, fctx.ctx = dim, ctx
        return _reduce_scatter(x, dim, ctx.batch_parallel, ctx.data_rank, ctx.data_group)

    @staticmethod
    def backward(fctx, g):
        c = fctx.ctx
        return all_gather(g, fctx.dim, c.batch_parallel, c.data_group), None, None


def fsdp_gather(x: torch.Tensor, dim: int, ctx) -> torch.Tensor:
    """The whole of a tensor this rank holds 1/D of along ``dim``: an
    all-gather over the data group; with grad, the backward reduce-scatters
    (each rank gets the data group's sum of its slice's gradient)."""
    if ctx.batch_parallel == 1:
        return x
    if _grad_path(x):
        return _DataGather.apply(x, dim, ctx)
    return all_gather(x, dim, ctx.batch_parallel, ctx.data_group)


def gather_batch(x: torch.Tensor, ctx) -> torch.Tensor:
    """Every data rank's rows (dim 0) in rank order; the backward sums the
    gradient over the data group and keeps the rank's rows."""
    return fsdp_gather(x, 0, ctx)


def scatter_batch(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum over the data group of ``x`` (every data rank's rows),
    keeping this rank's rows; the backward all-gathers."""
    if ctx.batch_parallel == 1:
        return x
    if _grad_path(x):
        return _DataScatter.apply(x, 0, ctx)
    return _reduce_scatter(x, 0, ctx.batch_parallel, ctx.data_rank, ctx.data_group)


def all_reduce_data(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum over the data group, without grad (the gradients of the
    leaves that every data rank holds whole)."""
    if ctx.batch_parallel == 1:
        return x
    return _all_reduce(x, ctx.data_group, "all_reduce")


def all_reduce_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum over the model axis, without grad and off the serving
    counter (the partial gradients of whole leaves, or of whole segments,
    that a rank applies to its own heads: ``ParamPlan.partial`` and
    ``shared_rows``)."""
    if ctx.model_parallel == 1:
        return x
    return _all_reduce(x, ctx.model_group, "all_reduce")


def all_reduce_model_groups(x: torch.Tensor, groups: int, ctx) -> torch.Tensor:
    """The sum of ``x`` over this rank's group of the model axis, its M
    ranks cut into ``groups`` runs of M / groups (the ranks that hold one
    kv head of a GQA leaf cut Hkv ways: ``ParamPlan.ways``), without grad,
    in place. One all-reduce over the model group of ``groups`` slots of
    ``x``'s shape, in which each rank fills its group's slot, then reads it
    back; counted on ``counts["all_reduce_kv_group"]``. A process group per
    sub-group would need every rank of the world to create each one in the
    same order at the mesh's start, and ``SameCard`` a pair of buffers
    mapped for each; the slots reuse the model group and its transport at
    ``groups`` times the bytes of the kv leaves, the smallest projections."""
    M = ctx.model_parallel
    if M == 1 or groups == M:
        return x
    slot = ctx.model_rank // (M // groups)
    buf = x.new_zeros((groups,) + tuple(x.shape))
    buf[slot] = x
    _reduce(buf, ctx.model_group)
    counts["all_reduce_kv_group"] += 1
    return x.copy_(buf[slot])


def _group_slices(x: torch.Tensor, cfg, ctx, kind: str) -> list:
    """Every rank's ``x`` of this rank's kv group, in group order: one
    all-gather over the model group, the group's g slices kept. (A slot
    all-reduce, ``all_reduce_model_groups``'s pattern, moves 2 M / g times
    the group's bytes; this gather M / g times, and the queries and states
    are small beside the cache.) Counted on ``counts[kind]``."""
    g, M = ctx.kv_group(cfg), ctx.model_parallel
    parts = _gather(x, M, ctx.model_group)
    first = ctx.model_rank // g * g
    counts[kind] += 1
    return parts[first:first + g]


def gather_kv_group(x: torch.Tensor, cfg, ctx, dim: int = 2) -> torch.Tensor:
    """The queries of this rank's kv group, without grad: every rank's
    ``x`` of the group concatenated along ``dim`` (the heads) in group
    order, so each rank holds the G heads of its kv head (MLA's absorbed
    q_eff: all 16). ``x`` itself where the group is one rank. Counted on
    ``counts["gather_kv_group"]``."""
    if ctx.kv_group(cfg) == 1:
        return x
    return torch.cat(_group_slices(x, cfg, ctx, "gather_kv_group"), dim=dim)


def merge_kv_group(o: torch.Tensor, lse: torch.Tensor, cfg, ctx):
    """The attention over the kv group's pieces of the sequence from each
    rank's over its own: ``o`` (..., Dv) fp32 and ``lse`` (...) fp32 of
    the same heads on every rank of the group (``merge_attention`` says
    what they hold). One all-gather of (o, lse) over the model group, the
    group's states merged by ``merge_states``; returns (o, lse) merged,
    as they are where the group is one rank. Counted on
    ``counts["merge_kv_group"]``."""
    if ctx.kv_group(cfg) == 1:
        return o, lse
    packed = torch.cat([o.float(), lse.float()[..., None]], dim=-1)
    return merge_states(torch.stack(_group_slices(packed, cfg, ctx, "merge_kv_group")))


def merge_attention(o: torch.Tensor, lse: torch.Tensor, ctx) -> torch.Tensor:
    """The attention over the whole sequence from each data rank's
    attention over its piece: ``o`` (..., Dv) fp32, normalised over the
    piece's kept keys, and ``lse`` (...) fp32, their log-sum-exp (the
    kernels' ``NEG_INF``, a finite floor, where the piece keeps none).
    One all-gather of (o, lse) over the data group, B H (Dv + 1) floats a
    decode row, then ``merge_states`` in fp32. Returns the merged o.
    Counted on ``counts["merge_attention"]``."""
    D = ctx.batch_parallel
    packed = torch.cat([o.float(), lse.float()[..., None]], dim=-1)
    counts["merge_attention"] += 1
    return merge_states(torch.stack(_gather(packed, D, ctx.data_group)))[0]


def merge_states(parts: torch.Tensor):
    """The merge of pieces' softmax states stacked on dim 0: ``parts``
    (P, ..., Dv + 1) fp32, each piece's o then its lse. Returns (o, lse):
    sum_p e^(lse_p - L) o_p / sum_p e^(lse_p - L) and L + log sum_p
    e^(lse_p - L), L the largest lse: 0 and a log-sum-exp at the floor
    where no piece keeps a key (every weight is then 1 and every o 0),
    never inf - inf. The merge is associative, so pieces merged in groups
    and the groups' states merged again give the same attention."""
    lses = parts[..., -1]
    top = lses.amax(dim=0)
    w = torch.exp(lses - top)
    total = w.sum(dim=0)
    return (parts[..., :-1] * w[..., None]).sum(dim=0) / total[..., None], top + torch.log(total)


# ---- sequence-sharded attention (the plan knob attn_seq_shard) ----------------


def _all_to_all(chunks: list, group, rank: int) -> list:
    """Chunk p of ``chunks`` (one per rank of ``group``, one shape) goes to
    rank p; returns what every rank sent this one, in rank order. NCCL's
    ``all_to_all``; elsewhere (gloo, the same-card transport) an all-gather
    of the stacked chunks, of which each rank keeps its own."""
    n = len(chunks)
    if chunks[0].is_meta:
        op_cost.record_collective("all-to-all", sum(op_cost.tensor_bytes(c) for c in chunks))
        return [torch.empty_like(c) for c in chunks]
    chunks = [c.contiguous() for c in chunks]
    if dist.get_backend(group) == "nccl":
        out = [torch.empty_like(c) for c in chunks]
        dist.all_to_all(out, chunks, group=group)
        return out
    return [p[rank] for p in _gather(torch.stack(chunks), n, group)]


def _seq_to_heads(x: torch.Tensor, ctx) -> torch.Tensor:
    M, r = ctx.model_parallel, ctx.model_rank
    n = x.shape[1] // M
    counts["all_to_all"] += 1
    return torch.cat(_all_to_all(list(x.split(n, dim=1)), ctx.model_group, r), dim=2)


def _heads_to_seq(x: torch.Tensor, ctx) -> torch.Tensor:
    M, r = ctx.model_parallel, ctx.model_rank
    h = x.shape[2] // M
    counts["all_to_all"] += 1
    return torch.cat(_all_to_all(list(x.split(h, dim=2)), ctx.model_group, r), dim=1)


class _Swap(torch.autograd.Function):
    """One of the two all-to-alls, whose backward is the other."""

    @staticmethod
    def forward(fctx, x, ctx, there, back):
        fctx.ctx, fctx.back = ctx, back
        return there(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return fctx.back(g, fctx.ctx), None, None, None


def seq_to_heads(x: torch.Tensor, ctx) -> torch.Tensor:
    """(B, M n, h, D) -> (B, n, M h, D): every model rank's h heads of this
    rank's piece of the sequence (rank r: positions [r n, (r + 1) n)),
    heads in rank order. One all-to-all over the model group; the backward
    is ``heads_to_seq``'s. Counted on ``counts["all_to_all"]``."""
    if _grad_path(x):
        return _Swap.apply(x, ctx, _seq_to_heads, _heads_to_seq)
    return _seq_to_heads(x, ctx)


def heads_to_seq(x: torch.Tensor, ctx) -> torch.Tensor:
    """The inverse of ``seq_to_heads``: (B, n, M h, D), this rank's piece
    of every head, -> (B, M n, h, D), the whole sequence of its own h
    heads. One all-to-all; the backward is ``seq_to_heads``'s."""
    if _grad_path(x):
        return _Swap.apply(x, ctx, _heads_to_seq, _seq_to_heads)
    return _heads_to_seq(x, ctx)


def _kv_heads(x: torch.Tensor, cfg, ctx) -> torch.Tensor:
    g = ctx.kv_group(cfg)
    counts["gather_kv_heads"] += 1
    return torch.cat(_gather(x, ctx.model_parallel, ctx.model_group)[::g], dim=2)


class _GatherKVHeads(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, cfg, ctx):
        fctx.cfg, fctx.ctx = cfg, ctx
        return _kv_heads(x, cfg, ctx)

    @staticmethod
    def backward(fctx, g):
        ctx, M = fctx.ctx, fctx.ctx.model_parallel
        every = fctx.ctx.kv_group(fctx.cfg)
        if every > 1:  # slot r: the gradient of rank r's kv head if r leads its group, else 0
            slots = g.new_zeros(g.shape[:2] + (M,) + g.shape[3:])
            slots[:, :, ::every] = g
            g = slots
        return _reduce_scatter(g, 2, M, ctx.model_rank, ctx.model_group), None, None


def gather_kv_heads(x: torch.Tensor, cfg, ctx) -> torch.Tensor:
    """Every kv head whole, from each model rank's own (B, S, h, D) K or V
    (h = Hkv / M heads, or the one kv head that the M / Hkv ranks of a kv
    group share): one all-gather over the model group, each kv head held
    once, from the first rank of its group, in head order. The backward
    reduce-scatters the gradient over the model group to the ranks it
    came from, so a kv group's other ranks get 0 for their copy and the
    sum over the group (``training.train_loop.sync_grads``) is the head's
    gradient once. Counted on ``counts["gather_kv_heads"]``."""
    if _grad_path(x):
        return _GatherKVHeads.apply(x, cfg, ctx)
    return _kv_heads(x, cfg, ctx)


def all_reduce_world(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum over every rank of the mesh, without grad."""
    if ctx.batch_parallel * ctx.model_parallel == 1:
        return x
    return _all_reduce(x, None, "all_reduce")


@contextlib.contextmanager
def gathered(ctx, *modules, recurse: bool = True, exclude=()):
    """Within the block, every parameter of ``modules`` (their
    submodules too with ``recurse``) that this rank holds 1/D of (a
    ``fsdp_dim`` attribute, set by ``models.model``) reads as the whole
    weight, through ``fsdp_gather``; the rank's slices are put back after.
    The modules in ``exclude`` (not their submodules) keep their pieces.
    A no-op at one data shard."""
    if ctx.batch_parallel == 1:
        yield
        return
    swaps = []
    skip = {id(m) for m in exclude}
    for top in modules:
        if top is None:
            continue
        for mod in (top.modules() if recurse else (top,)):
            if id(mod) in skip:
                continue
            for name, p in mod._parameters.items():
                if p is not None and getattr(p, "fsdp_dim", None) is not None:
                    swaps.append((mod, name, p))
    try:
        for mod, name, p in swaps:
            mod._parameters[name] = fsdp_gather(p, p.fsdp_dim, ctx)
        yield
    finally:
        for mod, name, p in swaps:
            mod._parameters[name] = p
