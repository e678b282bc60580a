"""Weights from the JAX package's param tree into the port's modules.

``params_from_numpy`` takes the tree ``repro.models.init_params`` returns,
with every leaf turned into a numpy array (the caller converts; this module
imports no JAX). The JAX package stacks each stage's layers on a leading
``repeats`` axis (``repro.models.transformer.init_stack``): layer ``j`` of
repeat ``r`` of a stage is absolute layer ``offset + r * period + j``
(deepseek-v2-lite: a 1-layer dense prefix stage, then a 26-repeat MoE
stage). Each leaf of a layer's dict lands on the port's attribute of the
same name: JAX stores dense weights ``(d_in, d_out)`` and applies
``x @ W``, the port's ``nn.Linear`` stores ``(d_out, d_in)``, so those are
transposed (``wq``, ``w_dkv``, ``wo``, the FFN's ``wi``/``wo``, Mamba1's
``x_proj``/``dt_proj``, the shared experts...); a leaf that is a plain
parameter in the port (MLA's ``w_ukv`` (lr, H, nope+vd), the experts
(E, D, F) / (E, F, D), the router (D, E), the qkv biases, the Mamba2 and
Mamba1 constants) keeps its layout; a norm's scale (``q_norm``,
``kv_norm``, a ``{"scale": ...}`` dict, with its ``bias`` for layernorm)
goes to its norm module. An encoder-decoder model's decoder layers carry
``cross_norm`` and ``cross``, and ``tree["encoder"]`` holds the encoder's
``stages`` (``compute_stages(cfg, cross=True)``) and ``final_norm``.

``named_arrays`` does that mapping for any tree shaped like the params
(gradients and AdamW's moments too): {port parameter name: numpy array in
the port's layout}, so the tests compare them leaf by leaf;
``params_from_numpy`` copies its arrays into a new model.

``gru_params_from_numpy`` carries the JAX ``GRUCorrector``'s parameter dict
(numpy leaves) into the port's corrector.

``shard_params`` cuts a whole model down to one rank's shard on a (data,
model) mesh, the counterpart of ``jax.device_put(params, shardings)``.

``yolo_params_from_numpy`` carries the JAX ``init_yolo`` list of stage
dicts into the port's ``models.convnet.YOLO``: each conv kernel from JAX's
HWIO (kh, kw, in, out) to torch's OIHW (out, in, kh, kw), the biases as
they are.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import RMSNorm
from repro_torch.models.model import (CausalLM, cut, cuts, empty_params, is_cut, mesh_rank,
                                      place, set_param)
from repro_torch.models.transformer import compute_stages
from repro_torch.sharding.placement import ParamPlan, plan_params


def _put(param: torch.Tensor, arr) -> None:
    param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


def _layer_arrays(module: nn.Module, src: dict, r: int, prefix: str, out: dict) -> None:
    """Add to ``out`` repeat ``r`` of every leaf of the JAX layer dict
    ``src``, under the name of the parameter of ``module`` it sets, in that
    parameter's layout."""
    for name, leaf in src.items():
        dst = getattr(module, name)
        if isinstance(leaf, dict):
            _layer_arrays(dst, leaf, r, f"{prefix}{name}.", out)
        elif isinstance(dst, nn.Linear):
            out[f"{prefix}{name}.weight"] = leaf[r].T
        elif isinstance(dst, RMSNorm):  # a bare scale leaf (qk-norm, kv_norm)
            out[f"{prefix}{name}.scale"] = leaf[r]
        elif isinstance(dst, nn.Parameter):
            out[f"{prefix}{name}"] = leaf[r]
        else:
            raise TypeError(f"no rule to load {name!r} into {type(dst).__name__}")


def _load(module: nn.Module, src: dict, r: int) -> None:
    """Set ``module``'s parameters from the JAX layer dict ``src``, taking
    repeat ``r`` of every leaf."""
    arrays = {}
    _layer_arrays(module, src, r, "", arrays)
    for name, arr in arrays.items():
        _put(module.get_parameter(name), arr)


def _stage_arrays(layers: nn.ModuleList, stages, cfg, cross: bool, prefix: str,
                  out: dict) -> None:
    offset = 0
    for si, st in enumerate(compute_stages(cfg, cross=cross)):
        period = len(st.pattern)
        for r in range(st.repeats):
            for j in range(period):
                i = offset + r * period + j
                _layer_arrays(layers[i], stages[si][f"l{j}"], r, f"{prefix}{i}.", out)
        offset += st.repeats * period


def named_arrays(tree, cfg) -> dict:
    """Every leaf of a tree shaped like the JAX package's params (the params
    themselves, their gradients, AdamW's ``m`` or ``v``; numpy leaves),
    keyed by the port's parameter name and laid out as that parameter is
    (dense weights transposed). Returns {name: numpy array}."""
    model = CausalLM(cfg, device="meta")
    out = {"embedding": tree["embed"]["embedding"]}
    if model.lm_head is not None:
        out["lm_head.weight"] = tree["embed"]["lm_head"].T
    for name, leaf in tree["final_norm"].items():
        out[f"final_norm.{name}"] = leaf
    _stage_arrays(model.layers, tree["stages"], cfg, False, "layers.", out)
    if cfg.is_encoder_decoder:
        enc = tree["encoder"]
        _stage_arrays(model.encoder.layers, enc["stages"], cfg, True, "encoder.layers.", out)
        for name, leaf in enc["final_norm"].items():
            out[f"encoder.final_norm.{name}"] = leaf
    return out


@torch.no_grad()
def params_from_numpy(tree, cfg, device="cuda") -> CausalLM:
    model = empty_params(cfg, device)
    arrays = named_arrays(tree, cfg)
    names = {n for n, _ in model.named_parameters()}
    if names != set(arrays):
        raise ValueError(f"the tree sets {sorted(set(arrays) - names)} and misses "
                         f"{sorted(names - set(arrays))}")
    for name, arr in arrays.items():
        _put(model.get_parameter(name), arr)
    return model


@torch.no_grad()
def shard_params(params: CausalLM, ctx, rank=None, plan: ParamPlan = None) -> CausalLM:
    """Mesh rank ``rank``'s shard (``model.mesh_rank(ctx)`` by default:
    data rank * M + model rank) of the whole model ``params`` on ``ctx``'s
    mesh, placed by ``plan`` (``plan_params``'s by default): a new model
    that holds a copy of the rank's piece of each cut leaf (1/M on the
    model axis, 1/D on the data axes with FSDP) and shares every whole leaf
    with ``params``. Leaf by leaf, so the rank's peak is its shard plus one
    cut leaf's piece on top of ``params``; a rank that must never hold the
    whole model draws its shard with ``init_params(ctx=...)`` instead.
    Where nothing is cut it returns ``params`` itself; a model that already
    holds this rank's shard is returned as it is."""
    M, D = ctx.model_parallel, ctx.batch_parallel
    rank = mesh_rank(ctx) if rank is None else rank
    d, m = divmod(rank, M)
    if params.shard is not None or params.data_shard is not None:
        want = (M, m) if M > 1 else None
        if params.shard != want or params.data_shard not in (None, (D, d)):
            raise ValueError(f"params hold the shard {params.shard} {params.data_shard}, not "
                             f"mesh rank {rank}'s (M, rank) = {(M, m)}, (D, rank) = {(D, d)}")
        return params
    plan = plan or plan_params(params.cfg, ctx)
    if not is_cut(plan):
        return params
    out = CausalLM(params.cfg, device="meta")
    for name, p in params.named_parameters():
        lc = cuts(plan, name, rank)
        set_param(out, name, cut(p, lc).clone() if lc else p)
    return place(out, plan, rank)


@torch.no_grad()
def yolo_params_from_numpy(stages, model):
    """Set ``model`` (a ``models.convnet.YOLO``) to the JAX ``init_yolo``
    stages: ``stages[i]`` maps "w" (kh, kw, in, out) HWIO and "b" (out,)
    to numpy arrays. Returns ``model``."""
    for conv, st in zip(model.convs, stages):
        w = np.asarray(st["w"], dtype=np.float32).transpose(3, 2, 0, 1)  # HWIO -> OIHW
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        conv.bias.copy_(torch.from_numpy(np.array(st["b"], dtype=np.float32)))
    return model


@torch.no_grad()
def gru_params_from_numpy(tree, corrector):
    """Set ``corrector`` (a ``repro_torch.core.gru.GRUCorrector``) to the
    JAX corrector's parameters: ``tree`` maps wz/wr/wh (in+hidden, hidden),
    bz/br/bh (hidden,), wo (hidden, 1) and bo (1,) to numpy arrays, in the
    same layout the port keeps. The Adam moments restart at zero."""
    for name, p in corrector.cell.named_parameters():
        _put(p, tree[name])
    corrector.reset_optimizer()
    return corrector
