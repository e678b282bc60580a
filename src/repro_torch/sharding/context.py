"""Execution context threaded through the model apply functions: the
counterpart of ``repro.sharding.context.ExecContext``.

Carries the mesh and its axis names, so that the layers that run explicit
SPMD over the model axis (column- and row-parallel projections with
``torch.distributed`` collectives, ``sharding.collectives``) know their
shard count, their rank on that axis and its process group, plus the
attention route. ``ExecContext()`` (no mesh) is the single-device path; a
mesh of one takes the same code path and runs no collective.

``plan`` carries the reference's per-model overrides; the port reads two
of its keys, both in train mode only (``models.transformer.apply_stack``):
``"remat_policy"`` (``"full"``, the default, ``"dots"`` or ``"none"``) and
``"pipeline"`` (``{"stages": S, "microbatches": M}``, the circular
pipeline of ``sharding.pipeline``). The reference's other keys (such as
``moe_2d``) and ``batch_parallel`` are not read: the port's serving mesh
has one device on its batch axes (``sharding.placement`` refuses more),
where the 2-D MoE computes what the expert-parallel branch computes
(ROADMAP.md).
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
    # per-model overrides: "remat_policy" and "pipeline" (train mode)
    plan: dict = field(default_factory=dict)

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
