"""Execution context threaded through the model apply functions: the
counterpart of ``repro.sharding.context.ExecContext``.

Carries the mesh and its axis names, so that the layers that run explicit
SPMD know their shard counts, their ranks and process groups on both axes:

* the model axis (``model_parallel``, ``model_rank``, ``model_group``):
  column- and row-parallel projections with ``torch.distributed``
  collectives (``sharding.collectives``);
* the batch axes (``batch_parallel``, ``data_rank``, ``data_group``): each
  data rank takes its rows of the batch; with FSDP (``fsdp``, or
  ``partition_specs.fsdp_default`` when it is None) it also holds 1/D of
  the weights the rule table cuts on the data axes, gathered per layer.

``ExecContext()`` (no mesh) is the single-device path; a mesh of one takes
the same code path and runs no collective. Where several batch axes span
more than one device (the multi-pod mesh's ("pod", "data")), the data group
is their product: the ranks that hold the same model shard, numbered
row-major over the batch axes (``launch.mesh`` makes that group when it
builds the mesh; a stand-in mesh is read for its sizes only).

A serving cache's K/V leaves and MLA latent are cut on their sequence
(``sharding.placement.plan_cache``) over the ranks that share them:

* the *kv group* (``kv_group``): on a model axis of M > 1, the M / Hkv
  model ranks that hold GQA kv head m // (M / Hkv) (Hkv < M), or all M
  model ranks for MLA's one latent head; of size 1 where Hkv >= M. A rank's
  position in it is ``kv_group_rank``;
* the data group, where it does not divide the batch (the rule table's
  KV-sequence placement, ``kv_seq``): every rank runs every row
  (``batch_split`` False).

``kv_seq`` marks the second: it is the caches' global length. A cache is
cut in P = (D if ``kv_seq`` else 1) x g pieces of n = ceil(S / P)
positions (g the kv group's size, S the global length); the rank's piece
index is (data piece, position in the kv group), ``piece_index``, and it
holds the positions [p n, (p + 1) n). Each rank writes only the positions
it holds, and decode attends over its piece and merges the pieces' partial
softmax states over the kv group, then over the data group
(``collectives.merge_kv_group``, ``merge_attention``).

``plan`` carries the reference's per-model overrides. The port reads
``"remat_policy"`` (``"full"``, the default, ``"dots"`` or ``"none"``) and
``"pipeline"`` (``{"stages": S, "microbatches": M}``, the circular
pipeline of ``sharding.pipeline``) in train mode, ``"moe_2d"`` (the
reference's weight-stationary 2-D MoE, ``models.moe``) in every mode, and
``"attn_seq_shard"`` (the reference's sequence-sharded attention) in GQA's
train and prefill forward at M > 1: each model rank attends for every
head over its piece of the query sequence against the whole K/V
(``models.attention.attend_seq_shard``; MLA, the encoder,
cross-attention and decode do not read it). ``launch.sharded``'s jobs
carry ``plan`` into the context, so a mesh serve or train takes it there.

``MeshStandIn`` is a mesh of any size seen from one of its ranks, with no
process group behind it: the dry run (``launch.dryrun``) builds a rank's
shard of a production mesh with it on the meta device, where the
collectives take their meta transport (``sharding.collectives``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# the attention routes a caller may choose; train mode takes its own
ATTN_IMPLS = (None, "plain")


def axis_sizes(mesh) -> Dict[str, int]:
    """A mesh's axis name -> size: a torch ``DeviceMesh`` (its
    ``mesh_dim_names`` and ``shape``) or any stand-in whose ``shape`` maps
    names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(n) for n in mesh.shape)))
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def kv_group_size(cfg, M: int) -> int:
    """The size g of a kv group at a model axis of M (module docstring):
    M / Hkv for GQA kv heads fewer than M, M for MLA's one latent head,
    else 1."""
    if M == 1:
        return 1
    if cfg.use_mla:
        return M
    Hkv = cfg.num_kv_heads
    return M // Hkv if 0 < Hkv < M else 1


class GroupStandIn:
    """The process group of ``MeshStandIn``'s axes ``axes``, of ``size``
    ranks: what the collectives' meta transport is handed."""

    def __init__(self, axes: Tuple[str, ...], size: int):
        self.axes, self.size = tuple(axes), int(size)

    def __repr__(self):
        return f"GroupStandIn({self.axes}, {self.size})"


class MeshStandIn:
    """A mesh of axis sizes ``shape`` (name -> size, in mesh order) seen
    from rank ``rank``, with no process group: the rank sits at its
    row-major coordinates over the axes, as ``launch.mesh`` places rank r
    (``get_local_rank``); ``get_group`` and ``data_groups`` (the batch
    axes' product group where more than one spans more than one device)
    hand out ``GroupStandIn``s. Only meta tensors run collectives over
    them (``sharding.collectives``)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0):
        self.shape = {str(k): int(v) for k, v in dict(shape).items()}
        n = 1
        for v in self.shape.values():
            n *= v
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} outside a mesh of {n}")
        self.rank, coords, r = rank, {}, rank
        for name in reversed(list(self.shape)):
            r, coords[name] = divmod(r, self.shape[name])
        self.coords = coords
        split = tuple(a for a in self.shape if a in ("pod", "data") and self.shape[a] > 1)
        size = 1
        for a in split:
            size *= self.shape[a]
        self.data_groups = {split: GroupStandIn(split, size)} if len(split) > 1 else {}

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]

    def get_group(self, axis: str) -> GroupStandIn:
        return GroupStandIn((axis,), self.shape[axis])


@dataclass(frozen=True)
class ExecContext:
    mesh: object = None  # torch.distributed.device_mesh.DeviceMesh | None
    batch_axes: Tuple[str, ...] = ()  # mesh axes sharding the batch dim
    model_axis: Optional[str] = None  # mesh axis sharding heads/ffn/experts/vocab
    # None: the tensors' device decides (the CUDA kernels on the card, their
    # plain versions on the CPU); "plain": the plain versions on any device.
    # It selects both the attention kernels and the SSD scan of the serving
    # modes; train mode takes its differentiable route whatever it says.
    attn_impl: Optional[str] = None
    # per-model overrides: "remat_policy" and "pipeline" (train mode), "moe_2d",
    # "attn_seq_shard" (GQA train and prefill at M > 1)
    plan: dict = field(default_factory=dict)
    # FSDP over the batch axes: None follows partition_specs.fsdp_default
    fsdp: Optional[bool] = None
    # whether the data ranks hold other rows (False: a batch every data rank
    # runs whole, as a serving worker's replicated prefill group)
    batch_split: bool = True
    # the global length of K/V caches (and MLA latents) cut on their
    # sequence over the data group as well as the kv group (module
    # docstring); 0: the data ranks hold whole sequences
    kv_seq: int = 0

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r}: choose from {ATTN_IMPLS} (train "
                             "mode takes its differentiable route whatever this says)")

    @property
    def model_parallel(self) -> int:
        """Tensor-parallel shard count: the model axis's size (1 without a
        mesh), read by the layers and by ``sharding.comm``."""
        if self.mesh is None or self.model_axis is None:
            return 1
        return axis_sizes(self.mesh)[self.model_axis]

    @property
    def model_rank(self) -> int:
        """This process's index on the model axis (0 without a mesh or on a
        stand-in mesh that has no process group)."""
        if self.model_parallel == 1 or not hasattr(self.mesh, "get_local_rank"):
            return 0
        return int(self.mesh.get_local_rank(self.model_axis))

    @property
    def model_group(self):
        """The model axis's process group (the collectives' ``group``)."""
        return self.mesh.get_group(self.model_axis)

    @property
    def batch_parallel(self) -> int:
        """How many ways the batch is split: the product of the batch axes'
        sizes (1 without a mesh)."""
        if self.mesh is None:
            return 1
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in self.batch_axes:
            n *= sizes[a]
        return n

    @property
    def data_rank(self) -> int:
        """This process's index in the data group: row-major over the batch
        axes (0 without a mesh, at one data shard, or on a stand-in mesh
        that has no process group)."""
        if self.batch_parallel == 1 or not hasattr(self.mesh, "get_local_rank"):
            return 0
        sizes = axis_sizes(self.mesh)
        r = 0
        for a in self.batch_axes:
            r = r * sizes[a] + (int(self.mesh.get_local_rank(a)) if sizes[a] > 1 else 0)
        return r

    @property
    def data_group(self):
        """The data group's process group: the ranks that hold the same
        model shard and other rows of the batch (or other pieces of a
        ``kv_seq`` cache). One batch axis's own group where only one spans
        more than one device, else the product group that ``launch.mesh``
        made for these axes (``data_groups``)."""
        sizes = axis_sizes(self.mesh)
        split = [a for a in self.batch_axes if sizes[a] > 1]
        if len(split) == 1:
            return self.mesh.get_group(split[0])
        groups = getattr(self.mesh, "data_groups", {})
        if tuple(split) not in groups:
            raise ValueError(f"a mesh whose batch axes {split} each span more than one device "
                             "needs the data group that launch.mesh makes with it")
        return groups[tuple(split)]

    def kv_group(self, cfg) -> int:
        """The size g of this rank's kv group (``kv_group_size``)."""
        return kv_group_size(cfg, self.model_parallel)

    def kv_group_rank(self, cfg) -> int:
        """This rank's position in its kv group."""
        return self.model_rank % self.kv_group(cfg)

    def seq_pieces(self, cfg) -> int:
        """How many pieces a cut cache's sequence is cut in: D x g with
        ``kv_seq``, else g."""
        return (self.batch_parallel if self.kv_seq else 1) * self.kv_group(cfg)

    def piece_index(self, cfg) -> int:
        """The index of this rank's piece of a cut cache: the data piece
        (its data rank with ``kv_seq``, else 0) times g plus its position
        in the kv group."""
        d = self.data_rank if self.kv_seq else 0
        return d * self.kv_group(cfg) + self.kv_group_rank(cfg)
