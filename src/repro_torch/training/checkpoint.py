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
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

ARRAYS = "arrays-shard-0.npz"


def _leaves(params, opt_state) -> dict:
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


def save_checkpoint(path: str, params, opt_state=None, step: int = 0) -> None:
    """Write the model ``params`` (and ``opt_state``'s moments) to ``path``
    at ``step``."""
    os.makedirs(path, exist_ok=True)
    leaves = _leaves(params, opt_state)
    np.savez(os.path.join(path, ARRAYS),
             **{n: _to_numpy(t) for n, t in leaves.items()})
    meta = {"step": int(step), "n_leaves": len(leaves), "names": list(leaves),
            "dtypes": [str(t.dtype).removeprefix("torch.") for t in leaves.values()]}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


@torch.no_grad()
def restore_checkpoint(path: str, params, opt_state=None) -> int:
    """Copy the checkpoint at ``path`` into the model ``params`` (and
    ``opt_state``'s moments and step) in place; returns the step. The
    leaves' names, dtypes and shapes must be those the checkpoint holds."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    leaves = _leaves(params, opt_state)
    if list(leaves) != meta["names"] or len(leaves) != meta["n_leaves"]:
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves "
                         f"{meta['names'][:3]}..., the target {len(leaves)}")
    with np.load(os.path.join(path, ARRAYS)) as data:
        for (name, t), dtype in zip(leaves.items(), meta["dtypes"]):
            if str(t.dtype).removeprefix("torch.") != dtype:
                raise ValueError(f"{name}: checkpoint dtype {dtype}, target {t.dtype}")
            a = data[name]
            src = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if dtype == "bfloat16" else torch.from_numpy(a))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)}, "
                                 f"target {tuple(t.shape)}")
            t.copy_(src)
    if opt_state is not None:
        opt_state["step"] = meta["step"]
    return meta["step"]
