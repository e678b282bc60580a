"""Where the port's parameters and cache leaves live on a (data, model)
mesh of D x M ranks: the rule table (``partition_specs``) applied to the
port's modules, and the explicit-SPMD layout that follows from it.

The rule table speaks the JAX package's tree (paths like
``stages/0/l0/attn/wq``, (d_in, d_out) matrices, stage leaves stacked on a
repeats dim). ``jax_layout`` maps each of the port's parameters onto its
leaf of that tree (the inverse of ``convert.params_from_numpy``'s walk) and
``jax_shapes`` gives the tree's shapes for a config from a model on the
meta device, so nothing is allocated.

``plan_params`` takes the table's decisions and turns each into the dim of
the port's tensor that a rank holds a 1/M slice of (``dims``) and, with
FSDP (``ctx.fsdp``, or ``fsdp_default(cfg)`` when that is None, as the
reference's ``params_shardings`` decides), the dim it holds a 1/D slice of
(``data_dims``). The layers then run as column-parallel (q/k/v, gate/up,
the LM head's vocab) and row-parallel (wo, w_down, the embedding's vocab,
the experts) shards with collectives (``sharding.collectives``), and each
layer gathers its FSDP weights over the data group for its span
(``collectives.gathered``). The batch rows split over the data axes
(``batch_shardings``: ``P(batch_axes, None)``). That needs whole heads per
rank, so beyond the table's own divisibility it refuses, with a
``NotImplementedError`` that names the leaf, M or D, and ROADMAP.md:

* at M > 1, a leaf the table left whole on the model axis (d_ff or vocab
  not divisible by M), MLA or SSM heads (Mamba1: inner channels) not
  divisible by M, GQA kv heads that neither divide M nor are divided by
  it, and a state cache that the table would leave whole instead of
  cutting its heads or channels (``plan_cache``);
Serving and training share these refusals: train mode takes every layout
that serving places. A mesh of one takes every family, and so does a data
axis at M = 1. A 1-D qkv bias, which the table replicates, is cut to the
rank's heads with its projection (the rank's projection yields only those
heads).

What training adds. The qk-norm scales, MLA's latent projection ``w_dkv``
and its ``kv_norm``, and Mamba1's ``dt_norm``, ``b_norm`` and ``c_norm``
stay whole on every rank but act on the rank's heads or channels only, so
their gradient is a partial sum over the model axis (``partial``); so is
that of the segments a segmented leaf holds whole (Mamba2's B and C,
below: ``ParamPlan.shared_rows``). A kv leaf cut fewer ways than M
(``ParamPlan.ways``) gets from each rank a partial sum over that rank's
query heads, summed over the M / Hkv ranks that hold its kv head; the pad
heads' rows and columns (``PaddedHeads``) get a zero gradient
(``training.train_loop.sync_grads``). Every other Mamba1 leaf's gradient
is the rank's own: ``in_proj``'s ``[x | z]`` segments are column-parallel
from the replicated input, so the rank's rows make exactly its channels;
``conv_w``, ``conv_b``, ``A_log`` and ``D`` act on its channels alone;
``dt_proj`` and ``dt_proj_b`` map the whole dt onto its channels (its rows
of the output); ``x_proj``'s rows read its channels, and the backward of
the all-reduce after it (``collectives.sum_over_model``) hands each rank
the whole gradient of the summed columns; ``out_proj`` reads its channels
and its output is summed with an identity backward. Experts held whole
on every rank run outside the model axis's collectives, so their gradient
and the router's are whole and equal on every rank.

Where the explicit-SPMD layers need another placement than the table's
contiguous 1/M cut, the port departs from it; the sharding report keeps
the table's decisions and counts all the same:

* segmented leaves (``ParamPlan.segments``): Mamba2's ``in_proj`` is
  ``[z | x | B | C | dt]`` on its output dim and its ``conv_w`` / ``conv_b``
  ``[x | B | C]``; a rank holds its 1/M of each of z, x and dt (its heads)
  and B and C whole (one group). Mamba1's ``in_proj`` ``[x | z]``: its 1/M
  of each. The Mamba2 ``conv`` cache holds the rank's x channels and B and
  C whole, di/M + 2N wide (``local_cache_shape``);
* per-channel leaves the table replicates are cut to the rank's heads or
  channels: Mamba2's ``A_log``, ``D``, ``dt_bias`` and gated-norm scale
  ``norm``, Mamba1's ``conv_b``, ``dt_proj_b``, ``A_log`` and ``D``;
* Mamba1's ``x_proj`` (di, dt_rank + 2N), whose columns the table puts on
  the model axis, is cut by its rows: its input is the rank's channels, so
  it runs row-parallel and its partial sums are all-reduced before the
  dt / B / C norms, which act on the whole;
* GQA kv heads fewer than M (M a multiple of Hkv: tinyllama-1.1b,
  gemma2-2b and qwen2-7b, 4 kv heads, at M = 8): rank m holds kv head
  m // (M / Hkv) (``wk``, ``wv``, ``bk`` and ``bv`` cut Hkv ways,
  ``ParamPlan.ways``), where the table cuts the projections' columns
  mid-head. A rank then projects its own kv head's K/V from the replicated
  input, and no K/V is gathered;
* the serving cache (``plan_cache``, ``local_cache_shape``). The K/V leaves
  of kv heads fewer than M hold the rank's kv head and 1/g of the sequence,
  g = M / Hkv the ranks that share the head (its *kv group*,
  ``context.kv_group_size``): ceil(S / g) positions, the rank's piece
  ``ExecContext.piece_index``. That is the table's rule (it cuts the K/V
  sequence over "model" there, the flash-decode partial softmax) on the
  port's heads: S Hkv / M head-positions a rank, the table's bytes. The MLA
  ``latent`` ([c_kv | k_rope], 576 wide) is cut on its sequence over all M
  model ranks, ceil(S / M) rows of all 576 columns, where the table cuts
  c_kv's columns M ways and keeps k_rope whole: S 576 / M against the
  table's S (512 / M + 64), never more. Every model rank writes the same
  latent rows from the replicated ``w_dkv`` and ``kv_norm``, so each keeps
  its piece's rows alone. The cut follows the sequence, not the columns:
  the absorbed decode scores every head against all 576 columns, so a
  column cut would all-reduce B H S fp32 partial scores, then the values,
  in every layer; a sequence cut costs one gather of the group's queries
  (B T H 576 for MLA) and one merge of the pieces' (o, log-sum-exp), B T H
  (Dv + 1) floats (``collectives.gather_kv_group``, ``merge_kv_group``).
  Decode runs every head of the group (G = H / Hkv, padded; 16 for MLA)
  over the rank's piece through the kernels' piece mode
  (``models.attention``). Where the data group cuts the sequence too (a
  batch that D does not divide), the pieces are D g: ceil(S / (D g))
  positions. Training keeps no cache and is untouched;
* query heads of a kv group that the group's M / Hkv ranks do not divide
  (qwen2-7b's 7 per group at M = 8): each group is padded with zero heads
  to a multiple of M / Hkv (``PaddedHeads``: 7 -> 8, 32 heads in all), the
  pad heads with zero ``wq`` rows, ``bq`` entries and ``wo`` columns, so
  their share of the rank's wo output is exactly 0. The padding lives only
  in the rank's pieces (``convert.shard_params``, ``init_params(ctx=...)``),
  never in the config or the unsharded model; it costs padded / per of the
  attention's compute (8/7 for qwen2). The table replicates what does not
  divide and never pads (``partition_specs``);
* MoE experts that M does not divide: every rank holds every expert whole
  and computes them all (``models.moe``), as the reference's MoE does when
  E % M != 0; the shared experts stay cut.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import attention as att
from repro_torch.models.layers import LayerNorm, RMSNorm
from repro_torch.models.model import dtype_of
from repro_torch.models.transformer import compute_stages, init_stack_cache
from repro_torch.sharding import partition_specs as ps
from repro_torch.sharding.context import axis_sizes, kv_group_size

ROADMAP = "see ROADMAP.md"
# the leaves the explicit-SPMD layers cut on the model axis
_CUT_LEAVES = {"embedding", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wi",
               "w_ukv", "in_proj", "x_proj", "dt_proj", "conv_w", "out_proj"}
# MLA's leaves cut by its query heads, which M must divide
_MLA_HEADS = ("wq", "wo", "w_ukv")
# the port's model dim of each SSM mixer leaf at M > 1, by mixer kind: its
# segments (length, cut) along that dim, or None for a contiguous 1/M cut
# (module docstring); leaves not named stay whole on every model rank
_SSM_CUTS = {
    "ssd": lambda di, N, H: {
        "in_proj": (0, ((di, True), (di, True), (N, False), (N, False), (H, True))),
        "conv_w": (0, ((di, True), (N, False), (N, False))),
        "conv_b": (0, ((di, True), (N, False), (N, False))),
        "A_log": (0, None), "D": (0, None), "dt_bias": (0, None), "norm": (0, None),
        "out_proj": (1, None)},
    "mamba": lambda di, N, H: {
        "in_proj": (0, ((di, True), (di, True))), "conv_w": (0, None), "conv_b": (0, None),
        "x_proj": (1, None), "dt_proj": (0, None), "dt_proj_b": (0, None), "A_log": (0, None),
        "D": (0, None), "out_proj": (1, None)},
}
# whole leaves applied to the rank's heads or channels only (their gradient sums
# over the model axis): the qk-norm scales, MLA's latent projection and its norm,
# Mamba1's dt / B / C norm scales
_HEAD_SHARED = ("q_norm", "k_norm", "w_dkv", "kv_norm", "dt_norm", "b_norm", "c_norm")
# the port's dim of each GQA leaf (qkv biases included) that a model rank cuts
# by heads (an nn.Linear weight is (d_out, d_in)), and those on the kv side
_GQA_DIMS = {"wq": 0, "wk": 0, "wv": 0, "wo": 1, "bq": 0, "bk": 0, "bv": 0}
_KV_LEAVES = {"wk", "wv", "bk", "bv"}
_KV_CACHE = ("k", "v", "xk", "xv")


@dataclass(frozen=True)
class PaddedHeads:
    """The segments of a query-side GQA leaf (``wq``, ``bq``, ``wo``'s
    input) at a model axis whose ranks per kv head do not divide the
    group: ``groups`` kv groups of ``per`` heads of ``width`` elements,
    each padded with zero heads to ``padded``, then cut in M contiguous
    pieces (module docstring). A rank's piece is one run of real heads of
    its group, then its pad heads."""
    groups: int
    per: int
    padded: int
    width: int

    def ranges(self, M: int, rank: int):
        """([lo, hi) of the real rows rank ``rank`` holds], the zero rows after them)."""
        local = self.groups * self.padded // M
        g, j = divmod(rank * local, self.padded)
        lo, hi = g * self.per + min(j, self.per), g * self.per + min(j + local, self.per)
        return [(lo * self.width, hi * self.width)], (local - (hi - lo)) * self.width


def kv_ways(cfg, M: int, path: str = "attn/wk") -> int:
    """The ways a GQA stack's kv heads are cut at a model axis of M: M
    where M divides them, else Hkv, each kv head whole on M / Hkv ranks
    (module docstring); kv heads that neither divide M nor are divided by
    it are refused, naming ``path``."""
    Hkv = cfg.num_kv_heads
    if Hkv % M == 0:
        return M
    if M % Hkv:
        _refuse(path, f"{Hkv} kv heads (neither a multiple nor a divisor of M)", M)
    return Hkv


def query_padding(cfg, M: int) -> Optional[PaddedHeads]:
    """The zero-head padding of each kv group's query heads at a model axis
    of M, or None where the group's ranks divide its heads."""
    Hkv = cfg.num_kv_heads
    per, ranks = cfg.num_heads // Hkv, max(1, M // Hkv)
    padded = -(-per // ranks) * ranks
    return None if padded == per else PaddedHeads(Hkv, per, padded, cfg.head_dim)


@dataclass(frozen=True)
class Leaf:
    name: str  # the port's parameter name (``CausalLM.named_parameters``)
    path: str  # the JAX tree path of its leaf
    repeat: Optional[int]  # its index on the stacked repeats dim; None outside the stages
    transpose: bool  # an nn.Linear weight: (d_out, d_in) here, (d_in, d_out) in JAX


def _jax_order(path: str):
    """JAX flattens dicts by sorted key and lists by index."""
    return [(0, int(c)) if c.isdigit() else (1, c) for c in path.split("/")]


def _stage_index(cfg, cross: bool, prefix: str) -> Dict[int, Tuple[str, int]]:
    """Absolute layer index -> (its stage's path, its repeat)."""
    out, offset = {}, 0
    for si, st in enumerate(compute_stages(cfg, cross=cross)):
        period = len(st.pattern)
        for r in range(st.repeats):
            for j in range(period):
                out[offset + r * period + j] = (f"{prefix}stages/{si}/l{j}", r)
        offset += st.repeats * period
    return out


def jax_layout(cfg, model=None) -> List[Leaf]:
    """Each parameter of ``model`` (a ``CausalLM`` of ``cfg``; one on the
    meta device by default) with its leaf of the JAX tree, in the JAX
    tree's order."""
    if model is None:
        from repro_torch.models.model import CausalLM
        model = CausalLM(cfg, device="meta")
    index = {"layers": _stage_index(cfg, False, "")}
    if cfg.is_encoder_decoder:
        index["encoder"] = _stage_index(cfg, True, "encoder/")
    leaves = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        mods = [model]
        for part in parts[:-1]:
            mods.append(getattr(mods[-1], part))
        owner = mods[-1]
        keys = parts
        transpose = isinstance(owner, nn.Linear)
        bare_norm = (isinstance(owner, (RMSNorm, LayerNorm)) and len(mods) > 2
                     and isinstance(mods[-2], (att.GQA, att.MLA)))  # q_norm, k_norm, kv_norm
        if transpose or bare_norm:
            keys = parts[:-1]
        repeat = None
        if keys[0] in ("embedding", "lm_head"):
            path = f"embed/{keys[0]}"
        elif keys[0] == "layers":
            stage, repeat = index["layers"][int(keys[1])]
            path = "/".join([stage] + keys[2:])
        elif keys[:2] == ["encoder", "layers"]:
            stage, repeat = index["encoder"][int(keys[2])]
            path = "/".join([stage] + keys[3:])
        else:
            path = "/".join(keys)
        leaves.append(Leaf(name, path, repeat, transpose))
    return sorted(leaves, key=lambda lf: (_jax_order(lf.path), lf.repeat or 0))


def jax_shapes(cfg, layout: Optional[List[Leaf]] = None, model=None) -> Dict[str, Tuple[int, ...]]:
    """The JAX tree's leaf shapes (path -> shape, stage leaves stacked on
    their repeats), in the tree's order, from the port's modules."""
    if model is None:
        from repro_torch.models.model import CausalLM
        model = CausalLM(cfg, device="meta")
    layout = layout or jax_layout(cfg, model)
    shapes = dict(model.named_parameters())
    out: Dict[str, Tuple[int, ...]] = {}
    repeats: Dict[str, int] = {}
    for lf in layout:
        shape = tuple(shapes[lf.name].shape)
        core = shape[::-1] if lf.transpose else shape
        if lf.repeat is None:
            out[lf.path] = core
        else:
            repeats[lf.path] = max(repeats.get(lf.path, 0), lf.repeat + 1)
            out[lf.path] = (repeats[lf.path],) + core
    return out


def _model_dim(spec, axis) -> Optional[int]:
    for d, a in enumerate(spec):
        if a == axis or (isinstance(a, tuple) and axis in a):
            return d
    return None


def _data_dim(spec, batch_axes) -> Optional[int]:
    for d, a in enumerate(spec):
        names = a if isinstance(a, tuple) else (a,)
        if a is not None and set(names) & set(batch_axes):
            return d
    return None


def _refuse(path: str, what: str, M: int):
    raise NotImplementedError(f"{path}: {what} at a model axis of {M} is not ported "
                              f"to repro_torch's sharded serving or training ({ROADMAP})")


def _axes(ctx):
    return ctx.model_axis or "model", tuple(ctx.batch_axes) or ("data",)


@dataclass(frozen=True)
class ParamPlan:
    specs: Dict[str, ps.Spec]  # JAX path -> the rule table's placement
    dims: Dict[str, Optional[int]]  # port name -> dim of its tensor cut 1/M per rank
    # port name -> dim of its tensor cut 1/D per rank (FSDP; all None without)
    data_dims: Dict[str, Optional[int]]
    # port names of whole leaves whose gradient is a partial sum over the model axis
    partial: frozenset
    shape: Tuple[int, int]  # (D, M)
    # port name -> the segments (length, cut) of its model dim, for the leaves
    # that hold 1/M of some segments and the others whole, or its
    # ``PaddedHeads`` (module docstring)
    segments: Dict[str, object] = field(default_factory=dict)
    # port name -> the ways its model dim is cut where fewer than M (GQA kv
    # leaves: Hkv ways, rank m holding piece m // (M / Hkv))
    ways: Dict[str, int] = field(default_factory=dict)

    def replicas(self, name: str) -> int:
        """How many ranks of the mesh hold the same piece of ``name`` (of
        its own rows, where ``shared_rows`` names others: those are held
        by M times as many)."""
        D, M = self.shape
        return ((M if self.dims[name] is None else M // self.ways.get(name, M))
                * (D if self.data_dims[name] is None else 1))

    def shared_rows(self, name: str) -> Tuple[Tuple[int, int], ...]:
        """The [lo, hi) ranges of the model dim, in a rank's piece of
        ``name``, that every model rank holds whole but applies to its own
        heads (the segments ``segments`` leaves whole: Mamba2's B and C),
        adjacent ones merged: their gradient is a partial sum over the
        model axis, like ``partial``'s."""
        segs, M = self.segments.get(name), self.shape[1]
        if not isinstance(segs, tuple):
            return ()
        out, at = [], 0
        for length, split in segs:
            n = length // M if split else length
            if not split and out and out[-1][1] == at:
                out[-1] = (out[-1][0], at + n)
            elif not split:
                out.append((at, at + n))
            at += n
        return tuple(out)

    def pad_rows(self, name: str, rank: int) -> Tuple[Tuple[int, int], ...]:
        """The [lo, hi) ranges of the model dim, in mesh rank ``rank``'s
        piece of ``name``, that hold pad heads (``PaddedHeads``: zero in
        the weights, and kept zero by a zero gradient), after the rank's
        FSDP cut where that cuts the same dim."""
        segs = self.segments.get(name)
        if not isinstance(segs, PaddedHeads):
            return ()
        D, M = self.shape
        d, m = divmod(rank, M)
        real, pad = segs.ranges(M, m)
        lo = sum(h - l for l, h in real)  # the model piece: real rows, then pad rows
        hi = lo + pad
        if self.data_dims[name] == self.dims[name]:  # FSDP cuts the piece D ways
            n = hi // D
            lo, hi = max(lo - d * n, 0), min(hi - d * n, n)
        return ((lo, hi),) if lo < hi else ()


def plan_params(cfg, ctx, report: Optional[ps.ShardingReport] = None) -> ParamPlan:
    """The rule table's placement of every leaf at ``ctx``'s mesh (FSDP as
    ``ctx.fsdp`` says, ``fsdp_default(cfg)`` when it is None), its
    decisions recorded on ``report``, and the dims of each port parameter
    that a rank holds 1/M and 1/D of (None: every rank holds it whole on
    that axis)."""
    model_axis, batch_axes = _axes(ctx)
    from repro_torch.models.model import CausalLM
    model = CausalLM(cfg, device="meta")
    layout = jax_layout(cfg, model)
    shapes = jax_shapes(cfg, layout, model)
    own = ps.ShardingReport()
    specs = ps.params_shardings(shapes, cfg, ctx.mesh, model_axis, batch_axes, fsdp=ctx.fsdp,
                                report=own)
    if report is not None:
        report.sharded += own.sharded
        report.replicated += own.replicated
        report.events.extend(own.events)
    M = axis_sizes(ctx.mesh)[model_axis]
    gqa = bool(cfg.num_kv_heads) and not cfg.use_mla
    if M > 1:
        for path, dim, size, axis in own.events:
            leaf = path.split("/")[-1]
            # x_proj is cut by its rows, GQA leaves by the port's own head cut,
            # and experts that M does not divide are whole on every rank
            own_cut = (path.endswith("/x_proj")
                       or (gqa and leaf in _GQA_DIMS and ("/attn/" in path or "/cross/" in path))
                       or ("/mlp/" in path and dim == 0 and size == cfg.num_experts
                           and cfg.num_experts % M))
            if model_axis in axis.split("+") and not own_cut:
                _refuse(path, f"dim {dim} of {size}, not divisible by the model axis,", M)
    sizes = axis_sizes(ctx.mesh)
    D = int(np.prod([sizes[a] for a in batch_axes]))
    dims, data_dims, partial, segments, ways = {}, {}, set(), {}, {}
    kinds = cfg.layer_kinds()
    pad = query_padding(cfg, M) if gqa and M > 1 else None
    for lf in layout:
        spec = specs[lf.path]
        core = spec[1:] if lf.repeat is not None else spec
        f = _data_dim(core, batch_axes) if D > 1 else None
        if f is not None and lf.transpose:
            f = len(core) - 1 - f
        data_dims[lf.name] = f
        if M > 1 and lf.path.split("/")[-1] in _HEAD_SHARED:
            partial.add(lf.name)
        d = _model_dim(core, model_axis)
        leaf = lf.path.split("/")[-1]
        attn = "/attn/" in lf.path or "/cross/" in lf.path
        if d is not None and M > 1:
            if leaf not in _CUT_LEAVES:
                _refuse(lf.path, "a leaf the sharded layers do not cut", M)
            if attn and not gqa and leaf in _MLA_HEADS and cfg.num_heads % M:
                _refuse(lf.path, f"{cfg.num_heads} heads (whole heads per rank)", M)
        if d is not None and lf.transpose:
            d = len(core) - 1 - d
        # whole heads per rank; a 1-D qkv bias, which the table replicates, is
        # cut to the rank's heads (module docstring)
        if M > 1 and gqa and attn and leaf in _GQA_DIMS:
            d = _GQA_DIMS[leaf]
            if leaf in _KV_LEAVES:
                n = kv_ways(cfg, M, lf.path)
                if n < M:
                    ways[lf.name] = n
            elif pad is not None:
                segments[lf.name] = pad
        if "/mlp/" in lf.path and len(core) == 3 and M > 1 and cfg.num_experts % M:
            d = None  # every expert whole on every rank (module docstring)
        if "/mixer/" in lf.path and M > 1:  # the SSM mixers' own cuts (module docstring)
            kind = kinds[int(lf.name.split(".")[1])]
            width = cfg.ssm_num_heads if kind == "ssd" else cfg.d_inner
            if width % M:
                _refuse(lf.path, f"{width} {'SSM heads' if kind == 'ssd' else 'inner channels'}"
                                 " (whole heads per rank)", M)
            d, segs = _SSM_CUTS[kind](cfg.d_inner, cfg.ssm_d_state, cfg.ssm_num_heads).get(
                leaf, (None, None))
            if segs is not None:
                segments[lf.name] = segs
        dims[lf.name] = d
    return ParamPlan(specs, dims, data_dims, frozenset(partial), (D, M), segments, ways)


def cache_shapes(cfg, batch: int, max_len: int, enc_len: int = 0) -> Dict[str, Tuple[int, ...]]:
    """The cache's leaf shapes at one shard (``init_stack_cache`` on the
    meta device)."""
    cache = init_stack_cache(cfg, batch, max_len, None, "meta", enc_len=enc_len)
    return {n: tuple(t.shape) for n, t in cache.items()}


def local_cache_shape(cfg, ctx, name: str, shape: Tuple[int, ...],
                      spec: ps.Spec) -> Tuple[int, ...]:
    """The shape of this rank's piece of cache leaf ``name`` (whole
    ``shape``) placed by ``spec``: the table's local shape, but for a
    Mamba2 stack's ``conv`` leaf on the model axis, which holds the rank's
    di/M x channels and B and C whole; a K/V leaf of fewer kv heads than M,
    which holds the rank's one kv head; and a K/V leaf or MLA latent cut on
    its sequence (module docstring), which holds ceil(S / P) positions, P
    the pieces: the data ranks its spec names times the kv group's g where
    it names the model axis (the last piece runs past S where P does not
    divide it)."""
    local = ps.local_shape(shape, spec, ctx.mesh)
    model_axis, _ = _axes(ctx)
    sizes = axis_sizes(ctx.mesh)
    M = sizes[model_axis]
    if name in _KV_CACHE + ("latent",) and spec[2] is not None:  # a sequence piece
        names = spec[2] if isinstance(spec[2], tuple) else (spec[2],)
        pieces = int(np.prod([sizes[a] for a in names if a != model_axis]))
        if model_axis in names:
            pieces *= kv_group_size(cfg, M)
        local = local[:2] + (-(-shape[2] // pieces),) + local[3:]
    if name == "conv" and "ssd" in cfg.layer_kinds() and _model_dim(spec, model_axis) is not None:
        local = local[:-1] + (cfg.d_inner // M + 2 * cfg.ssm_d_state,)
    if name in _KV_CACHE and spec[3] == model_axis and shape[3] % M:
        local = local[:3] + (shape[3] // kv_ways(cfg, M),) + local[4:]
    return local


def init_placed_cache(cfg, ctx, specs: Dict[str, ps.Spec], batch: int, max_len: int, device,
                      enc_len: int = 0) -> Dict[str, torch.Tensor]:
    """A zeroed (batch, max_len) cache of which every leaf holds this
    rank's piece under ``specs`` (``plan_cache``'s placement,
    ``local_cache_shape``): at a model axis of M > 1 the K/V leaves this
    rank's kv heads (and its piece of their sequence where its kv group is
    wider than 1), the SSM state its heads or channels, the MLA latent its
    piece of the sequence."""
    full = init_stack_cache(cfg, batch, max_len, dtype_of(cfg.dtype), "meta", enc_len=enc_len)
    return {n: torch.zeros(local_cache_shape(cfg, ctx, n, tuple(t.shape), specs[n]),
                           dtype=t.dtype, device=device)
            for n, t in full.items()}


class AxisSizes:
    """A stand-in mesh: axis name -> size only (what the rule table reads)."""

    def __init__(self, **shape):
        self.shape = shape


def plan_cache(cfg, ctx, batch: int, max_len: int, enc_len: int = 0,
               report: Optional[ps.ShardingReport] = None,
               rows_split: bool = True, kv_seq: bool = False) -> Dict[str, ps.Spec]:
    """The activation rules' placement of a (batch, max_len) cache, on the
    port's heads (module docstring). At M > 1 every SSM state leaf shards
    on its heads or channels; a K/V leaf of kv heads that M divides shards
    on its heads, one of fewer kv heads than M on its rank's kv head and
    its sequence over the kv group (its seq dim names the model axis); the
    MLA latent on its sequence over the model axis, all its columns whole.
    At D > 1 every leaf shards on its batch where D divides it; where it
    does not, the table's fallback: the K/V leaves (``k``, ``v``, ``xk``,
    ``xv``) and the MLA latent shard their sequence over the data group
    too (the table names the "data" axis, the port the whole data group,
    "pod" included; its seq dim then names the data axes, and the model
    axis after them where the kv group cuts it as well) and every other
    leaf holds every row whole. ``rows_split=False``: a cache whose rows
    every data rank holds whole (a prefill group's), placed on the model
    axis only. ``kv_seq``: the data group's sequence cut whatever D and
    ``batch`` are (a prefill group of a sequence-cut slot pool)."""
    model_axis, batch_axes = _axes(ctx)
    sizes = axis_sizes(ctx.mesh)
    mesh = ctx.mesh
    if not rows_split:
        mesh = AxisSizes(**dict(sizes, **{a: 1 for a in batch_axes}))
    specs = ps.cache_shardings(cache_shapes(cfg, batch, max_len, enc_len), cfg, mesh, batch,
                               model_axis, batch_axes, report=report)
    if not rows_split:
        specs = {n: (sp[0], None) + tuple(sp[2:]) for n, sp in specs.items()}
    D = int(np.prod([sizes[a] for a in batch_axes]))
    seq = D > 1 and rows_split and (batch % D != 0 or kv_seq)
    data = None
    if seq:
        specs = ps.cache_shardings(cache_shapes(cfg, batch, max_len, enc_len), cfg,
                                   AxisSizes(**dict(sizes, **{a: 1 for a in batch_axes})),
                                   batch, model_axis, batch_axes)
        specs = {n: (sp[0], None) + tuple(sp[2:]) for n, sp in specs.items()}
        data = tuple(a for a in batch_axes if sizes[a] > 1)
        data = data[0] if len(data) == 1 else data
        for n, sp in specs.items():
            if n in _KV_CACHE or n == "latent":
                specs[n] = sp[:2] + (data,) + sp[3:]
    M = sizes[model_axis]
    if M > 1:
        over_group = (model_axis if data is None else
                      (data if isinstance(data, tuple) else (data,)) + (model_axis,))
        for name in _KV_CACHE:
            if name in specs:
                cut = kv_ways(cfg, M, name) < M  # one kv head per rank, or refused
                specs[name] = specs[name][:2] + (over_group if cut else data,
                                                 model_axis) + specs[name][4:]
        for name, dim in (("ssm", 2), ("conv", 3)):
            if name in specs and specs[name][dim] != model_axis:
                _refuse(name, "an SSM state cache the rule table leaves whole", M)
        if "latent" in specs:  # its sequence over the model axis (module docstring)
            specs["latent"] = specs["latent"][:2] + (over_group, None)
    return specs
