"""Checkpoints of the port's models and optimizer state, in the file
layout of ``repro.training.checkpoint`` on one device:
``arrays-shard-0.npz`` and ``meta.json`` with ``step`` and ``n_leaves``.

The leaves are the port's named parameters (``params.<name>``) and, when
given, the optimizer's moments (``opt.m.<name>``, ``opt.v.<name>``);
``meta.json`` also lists each leaf's name and dtype. numpy has no
bfloat16 without ``ml_dtypes``, so a bf16 leaf is stored as its uint16
bit pattern and restored bit for bit. The archive is not compressed (bf16
weights hardly compress, and zlib over gigabytes takes minutes). A port
checkpoint is not a JAX checkpoint: its leaves are named and laid out as
the port's parameters are (``convert.named_arrays`` maps a JAX tree onto
those names).

On a (data, model) mesh (``ctx``) the leaves are this rank's pieces: a
save gathers every leaf whole over both axes and rank 0 writes it in the
unsharded layout, a restore reads the whole leaves on every rank and
copies in this rank's piece (``models.model.cuts``), so a checkpoint moves
between meshes and to and from no mesh. A leaf whose model rank holds
other rows than its contiguous 1/M slice (the segments of Mamba2's
``in_proj``, ``conv_w`` and ``conv_b``, padded query heads, kv heads cut
fewer ways than M: ``ParamPlan.segments`` and ``ways``) is put back
together by writing each rank's piece into the rows it holds
(``models.model.kept_ranges``).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

ARRAYS = "arrays-shard-0.npz"


def leaves(params, opt_state=None) -> dict:
    """The checkpoint's leaves: ``params.<name>`` for each parameter and,
    with ``opt_state``, ``opt.m.<name>`` and ``opt.v.<name>``."""
    out = {f"params.{n}": p for n, p in params.named_parameters()}
    if opt_state is not None:
        for k in ("m", "v"):
            out.update({f"opt.{k}.{n}": t for n, t in opt_state[k].items()})
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _placement(params, ctx):
    """(plan, mesh rank) of a sharded model on ``ctx``, else None."""
    if ctx is None or ctx.mesh is None:
        return None
    from repro_torch.models.model import is_cut, mesh_rank
    from repro_torch.sharding.placement import plan_params
    plan = plan_params(params.cfg, ctx)
    return (plan, mesh_rank(ctx)) if is_cut(plan) else None


def param_name(leaf: str) -> str:
    """The parameter a leaf of ``leaves`` belongs to (its own name, or the
    one its moment is of)."""
    return leaf.split(".", 2)[-1] if leaf.startswith("opt.") else leaf.split(".", 1)[1]


@torch.no_grad()
def whole(t, name, plan, ctx):
    """Parameter ``name``'s leaf (or a tensor laid out as it is: its
    gradient, a moment) gathered whole from this rank's piece ``t`` under
    ``plan`` (``placement.plan_params``); every rank of the mesh calls it."""
    from repro_torch.models.model import kept_ranges
    from repro_torch.sharding import collectives
    D, M = plan.shape
    d = plan.dims[name]
    # the data group first: a rank's FSDP cut is of its model piece, along the
    # same dim where both cut one (Mamba1's x_proj, by its input channels)
    if plan.data_dims[name] is not None:
        t = collectives.all_gather(t, plan.data_dims[name], D, ctx.data_group)
    if d is not None and M > 1:
        t = collectives.all_gather(t, d, M, ctx.model_group)
        segs, ways = plan.segments.get(name), plan.ways.get(name, M)
        if segs is not None or ways != M:  # each rank's piece into the rows it holds
            pieces = t.chunk(M, dim=d)
            kept = [kept_ranges(pieces[0].shape[d] * ways, ways, r * ways // M, segs)[0]
                    for r in range(M)]
            shape = list(t.shape)
            shape[d] = max(hi for ranges in kept for _, hi in ranges)
            t = t.new_empty(shape)
            for piece, ranges in zip(pieces, kept):
                at = 0
                for lo, hi in ranges:
                    t.narrow(d, lo, hi - lo).copy_(piece.narrow(d, at, hi - lo))
                    at += hi - lo
    return t


def save_checkpoint(path: str, params, opt_state=None, step: int = 0, ctx=None) -> None:
    """Write the model ``params`` (and ``opt_state``'s moments) to ``path``
    at ``step``. On a mesh (``ctx``) every rank calls it with its pieces
    and rank 0 writes the whole leaves."""
    tensors = leaves(params, opt_state)
    placed = _placement(params, ctx)
    if placed is not None:
        tensors = {n: whole(t, param_name(n), placed[0], ctx) for n, t in tensors.items()}
    if placed is None or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, ARRAYS),
                 **{n: _to_numpy(t) for n, t in tensors.items()})
        meta = {"step": int(step), "n_leaves": len(tensors), "names": list(tensors),
                "dtypes": [str(t.dtype).removeprefix("torch.") for t in tensors.values()]}
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    if placed is not None:
        dist.barrier()


@torch.no_grad()
def restore_checkpoint(path: str, params, opt_state=None, ctx=None) -> int:
    """Copy the checkpoint at ``path`` into the model ``params`` (and
    ``opt_state``'s moments and step) in place; returns the step. The
    leaves' names, dtypes and shapes must be those the checkpoint holds; on
    a mesh (``ctx``) each rank copies in its piece of every leaf."""
    placed = _placement(params, ctx)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    tensors = leaves(params, opt_state)
    if list(tensors) != meta["names"] or len(tensors) != meta["n_leaves"]:
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves "
                         f"{meta['names'][:3]}..., the target {len(tensors)}")
    with np.load(os.path.join(path, ARRAYS)) as data:
        for (name, t), dtype in zip(tensors.items(), meta["dtypes"]):
            if str(t.dtype).removeprefix("torch.") != dtype:
                raise ValueError(f"{name}: checkpoint dtype {dtype}, target {t.dtype}")
            a = data[name]
            src = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if dtype == "bfloat16" else torch.from_numpy(a))
            if placed is not None:
                from repro_torch.models.model import cut, cuts
                src = cut(src, cuts(placed[0], param_name(name), placed[1]))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)}, "
                                 f"target {tuple(t.shape)}")
            t.copy_(src)
    if opt_state is not None:
        opt_state["step"] = meta["step"]
    return meta["step"]
