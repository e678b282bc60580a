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

``gru_params_from_numpy`` carries the JAX ``GRUCorrector``'s parameter dict
(numpy leaves) into the port's corrector.

``shard_params`` cuts a whole model down to one rank's shard on a model
axis, the counterpart of ``jax.device_put(params, shardings)``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import RMSNorm
from repro_torch.models.model import CausalLM, empty_params, set_param, shard_slice
from repro_torch.models.transformer import compute_stages
from repro_torch.sharding.placement import ParamPlan, plan_params


def _put(param: torch.Tensor, arr, transpose: bool = False) -> None:
    a = torch.from_numpy(np.array(arr, dtype=np.float32))
    param.copy_(a.T if transpose else a)


def _load(module: nn.Module, src: dict, r: int) -> None:
    """Set ``module``'s parameters from the JAX layer dict ``src``, taking
    repeat ``r`` of every leaf."""
    for name, leaf in src.items():
        dst = getattr(module, name)
        if isinstance(leaf, dict):
            _load(dst, leaf, r)
        elif isinstance(dst, nn.Linear):
            _put(dst.weight, leaf[r], transpose=True)
        elif isinstance(dst, RMSNorm):  # a bare scale leaf (qk-norm, kv_norm)
            _put(dst.scale, leaf[r])
        elif isinstance(dst, nn.Parameter):
            _put(dst, leaf[r])
        else:
            raise TypeError(f"no rule to load {name!r} into {type(dst).__name__}")


def _load_stages(layers: nn.ModuleList, stages, cfg, cross: bool) -> None:
    offset = 0
    for si, st in enumerate(compute_stages(cfg, cross=cross)):
        period = len(st.pattern)
        for r in range(st.repeats):
            for j in range(period):
                _load(layers[offset + r * period + j], stages[si][f"l{j}"], r)
        offset += st.repeats * period


def _load_norm(norm: nn.Module, src: dict) -> None:
    for name, leaf in src.items():
        _put(getattr(norm, name), leaf)


@torch.no_grad()
def params_from_numpy(tree, cfg, device="cuda") -> CausalLM:
    model = empty_params(cfg, device)
    _put(model.embedding, tree["embed"]["embedding"])
    if model.lm_head is not None:
        _put(model.lm_head.weight, tree["embed"]["lm_head"], transpose=True)
    _load_norm(model.final_norm, tree["final_norm"])
    _load_stages(model.layers, tree["stages"], cfg, cross=False)
    if cfg.is_encoder_decoder:
        _load_stages(model.encoder.layers, tree["encoder"]["stages"], cfg, cross=True)
        _load_norm(model.encoder.final_norm, tree["encoder"]["final_norm"])
    return model


@torch.no_grad()
def shard_params(params: CausalLM, ctx, rank=None, plan: ParamPlan = None) -> CausalLM:
    """Rank ``rank``'s shard (``ctx.model_rank`` by default) of the whole
    model ``params`` on ``ctx``'s model axis, placed by ``plan``
    (``plan_params``'s by default): a new model that holds a copy of the
    rank's 1/M slice of each cut leaf and shares every whole leaf with
    ``params``. Leaf by leaf, so the rank's peak is its shard plus one cut
    leaf's slice on top of ``params``; a rank that must never hold the
    whole model draws its shard with ``init_params(ctx=...)`` instead. At
    one shard it returns ``params`` itself; a model that already holds this
    rank's shard is returned as it is."""
    M = ctx.model_parallel
    rank = ctx.model_rank if rank is None else rank
    if params.shard is not None:
        if params.shard != (M, rank):
            raise ValueError(f"params hold the shard {params.shard}, not (M, rank) = {(M, rank)}")
        return params
    if M == 1:
        return params
    dims = (plan or plan_params(params.cfg, ctx)).dims
    out = CausalLM(params.cfg, device="meta")
    for name, p in params.named_parameters():
        d = dims[name]
        set_param(out, name, p if d is None else shard_slice(p, d, M, rank).clone())
    out.shard = (M, rank)
    return out


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
