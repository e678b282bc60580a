"""Mesh builders over ``torch.distributed``: the counterpart of
``repro.launch.mesh``, with a torch ``DeviceMesh`` over the axes
("data", "model"), or ("pod", "data", "model") for the multi-pod shape.
On a (D, M) mesh rank r sits at (r // M, r % M): its model group is the M
ranks of its row (one data shard, the model cut M ways), its data group
the D ranks of its column (one model shard, the batch cut D ways), both
from ``DeviceMesh.get_group`` (``sharding.context.ExecContext``). On a
(P, D, M) mesh rank r sits at (r // (D M), r // M % D, r % M) and both
batch axes cut the batch: its data group is the P D ranks that hold its
model shard, data rank p D + d, a process group that ``_mesh`` makes beside
the mesh's own (``data_groups``; every rank creates every such group, in
the same order, as ``torch.distributed.new_group`` asks).

Functions, not module constants: importing this module touches no device
and starts no process group. Process-group start-up needs no network
(``init_ranks``): a world of one meets in a ``HashStore``, more ranks in a
``FileStore`` in a directory they share. The backend is NCCL when each rank
has a card of its own, and gloo on the CPU and for ranks that share one
card (NCCL refuses two ranks on one device); there the model's all-reduces
and all-gathers of CUDA tensors go through the card's memory
(``sharding.collectives.SameCard``) and gloo keeps the barriers.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding.context import axis_sizes

PRODUCTION_DEVICES = {False: 256, True: 512}  # (16, 16) and (2, 16, 16)


def pick_backend(device_type: str, world_size: int) -> str:
    """NCCL when each of the ranks has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_ranks(world_size: int, rank: int, device_type: str,
               store_dir: Optional[str] = None) -> str:
    """Join this process to a process group of ``world_size`` ranks as
    ``rank`` on ``device_type`` ("cuda" or "cpu") and return the backend.
    A world of one needs no store
    directory; more ranks meet in a ``FileStore`` under ``store_dir``, a
    directory all of them see. A CUDA rank takes card ``rank`` modulo the
    cards there are."""
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if world_size == 1:
        store = dist.HashStore()
    else:
        if store_dir is None:
            raise ValueError("ranks of a world larger than one need a shared store_dir")
        store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    backend = pick_backend(device_type, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    return backend


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() and n == 1:
        init_ranks(1, 0, device_type)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {n} devices needs a process group of {n} ranks, "
                           f"not {dist.get_world_size()} (launch.sharded.run_ranks starts one)")
    ranks = torch.arange(n).reshape(shape)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=names)
    batch = [i for i, a in enumerate(names) if a in ("pod", "data") and shape[i] > 1]
    mesh.data_groups = {}
    if len(batch) > 1:  # the product group of the batch axes, one per model shard
        other = [i for i in range(len(names)) if i not in batch]
        cols = ranks.permute(*other, *batch).reshape(-1, math.prod(shape[i] for i in batch))
        me = dist.get_rank()
        for col in cols.tolist():
            g = dist.new_group(col)
            if me in col:
                mesh.data_groups[tuple(names[i] for i in batch)] = g
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: 16 x 16 = 256 cards over (data, model), or
    2 x 16 x 16 = 512 over (pod, data, model) with ``multi_pod``; it needs a
    process group of that many ranks, one per card, and raises without
    one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    need = PRODUCTION_DEVICES[multi_pod]
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(f"the production mesh needs {need} devices, one rank each; this "
                           f"process group has {have} ranks")
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh("cuda", shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1, device_type: str = "cuda", pod: int = 1):
    """A small (data, model) mesh over ``device_type``, or with ``pod`` > 1
    a (pod, data, model) one: the card by default, which raises where
    there is none; the CPU only when the caller passes
    ``device_type="cpu"``. A mesh of one starts its own world of one when
    the process has no group; a larger one needs the process group of its
    ``pod * data * model`` ranks (``init_ranks``)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_debug_mesh: no CUDA card here; pass device_type=\"cpu\" for "
                           "a mesh on the CPU")
    if pod > 1:
        return _mesh(device_type, (pod, data, model), ("pod", "data", "model"))
    return _mesh(device_type, (data, model), ("data", "model"))


def mesh_of(shape, device_type: str = "cuda"):
    """``make_debug_mesh`` of a shape: (data, model) or (pod, data, model)."""
    if len(shape) == 3:
        return make_debug_mesh(shape[1], shape[2], device_type, pod=shape[0])
    return make_debug_mesh(shape[0], shape[1], device_type)


def batch_axes_for(mesh):
    """The mesh's axes that cut the batch: ("data",) or ("pod", "data")."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))
