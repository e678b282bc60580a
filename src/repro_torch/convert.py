"""Weights from the JAX package's param tree into the port's modules.

``params_from_numpy`` takes the tree ``repro.models.init_params`` returns,
with every leaf turned into a numpy array (the caller converts; this module
imports no JAX). The JAX package stacks each stage's layers on a leading
``repeats`` axis (``repro.models.transformer.init_stack``): layer ``j`` of
repeat ``r`` of a stage is absolute layer ``offset + r * period + j``. JAX
stores dense weights ``(d_in, d_out)`` and applies ``x @ W``; the port's
``nn.Linear`` stores ``(d_out, d_in)``, so they are transposed.

``gru_params_from_numpy`` carries the JAX ``GRUCorrector``'s parameter dict
(numpy leaves) into the port's corrector.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import CausalLM, empty_params
from repro_torch.models.transformer import compute_stages

_LINEARS = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w_gate", "w_up", "w_down"),
            "mixer": ("in_proj", "out_proj")}
_NORMS = ("pre_norm", "post_norm", "mlp_norm", "mlp_post_norm")
_MIXER_LEAVES = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm")  # Mamba2, untransposed


def _put(param: torch.Tensor, arr, transpose: bool = False) -> None:
    a = torch.from_numpy(np.array(arr, dtype=np.float32))
    param.copy_(a.T if transpose else a)


@torch.no_grad()
def params_from_numpy(tree, cfg, device="cuda") -> CausalLM:
    model = empty_params(cfg, device)
    _put(model.embedding, tree["embed"]["embedding"])
    if model.lm_head is not None:
        _put(model.lm_head.weight, tree["embed"]["lm_head"], transpose=True)
    _put(model.final_norm.scale, tree["final_norm"]["scale"])
    offset = 0
    for si, st in enumerate(compute_stages(cfg)):
        period = len(st.pattern)
        for r in range(st.repeats):
            for j in range(period):
                src = tree["stages"][si][f"l{j}"]
                layer = model.layers[offset + r * period + j]
                for norm in _NORMS:
                    if hasattr(layer, norm):
                        _put(getattr(layer, norm).scale, src[norm]["scale"][r])
                for block, names in _LINEARS.items():
                    if block not in src:
                        continue
                    for name in names:
                        _put(getattr(getattr(layer, block), name).weight,
                             src[block][name][r], transpose=True)
                if "mixer" in src:
                    for name in _MIXER_LEAVES:
                        _put(getattr(layer.mixer, name), src["mixer"][name][r])
        offset += st.repeats * period
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
