"""Decoder stack: the counterpart of ``repro.models.transformer``.

The JAX package scans each *stage* (a repeating pattern of layers, e.g.
gemma2's (local, global) pair) over stacked params to keep its compiled
graph small. PyTorch runs eagerly, so the port keeps the layers as one
``nn.ModuleList`` in absolute layer order and loops over it;
``compute_stages`` stays to map the JAX params onto that order
(``repro_torch.convert``).

Modes: ``prefill`` (full causal forward writing K/V into the cache at
positions [0, S)) and ``decode`` (one token per row at ``pos`` against the
cache). The cache is one stacked tensor per K and V, (layers, batch,
max_len, kv heads, head dim), updated in place.

This slice serves dense attention stacks (``attn``/``local``/``global``
mixers, dense MLPs, gemma2's post-block norms); SSM, MoE and
cross-attention layers raise (see ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch import nn

from repro_torch.models import attention as att
from repro_torch.models.layers import MLP, apply_mlp, apply_norm, init_norm

ATTN_KINDS = ("attn", "local", "global")
MODES = ("prefill", "decode")


@dataclass(frozen=True)
class Stage:
    repeats: int
    pattern: Tuple[Tuple[str, str], ...]  # ((mixer_kind, mlp_kind), ...)


def compute_stages(cfg) -> List[Stage]:
    seq = list(zip(cfg.layer_kinds(), cfg.mlp_kinds()))
    for prefix in range(0, len(seq)):
        rest = seq[prefix:]
        if not rest:
            break
        for p in range(1, len(rest) + 1):
            if len(rest) % p:
                continue
            if all(rest[i] == rest[i % p] for i in range(len(rest))):
                stages = []
                if prefix:
                    stages.append(Stage(1, tuple(seq[:prefix])))
                stages.append(Stage(len(rest) // p, tuple(rest[:p])))
                return stages
    return [Stage(1, tuple(seq))]


class Block(nn.Module):
    """One decoder layer (counterpart of ``init_layer``)."""

    def __init__(self, cfg, kind: str, mlp_kind: str, device=None, dtype=None):
        super().__init__()
        if kind not in ATTN_KINDS or mlp_kind != "dense" or cfg.use_mla:
            raise NotImplementedError(
                f"layer ({kind!r}, {mlp_kind!r}, mla={cfg.use_mla}) is not ported "
                "yet: this slice serves dense GQA stacks (see ROADMAP.md)")
        self.kind = kind
        self.window = cfg.sliding_window if kind == "local" else None
        self.pre_norm = init_norm(cfg, device)
        self.attn = att.GQA(cfg, device, dtype)
        self.mlp_norm = init_norm(cfg, device)
        self.mlp = MLP(cfg, device, dtype)
        if cfg.post_block_norm:
            self.post_norm = init_norm(cfg, device)
            self.mlp_post_norm = init_norm(cfg, device)


def init_stack_cache(cfg, batch, max_len, dtype, device=None):
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_layer(lp: Block, x, cfg, ctx, mode, cache_k, cache_v, pos):
    """cache_k/v: this layer's (batch, max_len, Hkv, Dh) views, written in
    place. Returns the layer's output."""
    h = apply_norm(lp.pre_norm, x)
    if mode == "decode":
        mix, _ = att.gqa_decode(lp.attn, h, cfg, cache_k, cache_v, pos,
                                window=lp.window, impl=ctx.attn_impl)
    else:
        mix, (k, v) = att.gqa_forward(lp.attn, h, cfg, window=lp.window, impl=ctx.attn_impl)
        S = k.shape[1]
        cache_k[:, :S] = k.to(cache_k.dtype)
        cache_v[:, :S] = v.to(cache_v.dtype)
    if cfg.post_block_norm:
        mix = apply_norm(lp.post_norm, mix)
    x = x + mix
    y = apply_mlp(lp.mlp, apply_norm(lp.mlp_norm, x), cfg)
    if cfg.post_block_norm:
        y = apply_norm(lp.mlp_post_norm, y)
    return x + y


def apply_stack(layers: nn.ModuleList, cfg, x, ctx, mode, cache, pos=0):
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r}: this slice runs {MODES}")
    for i, lp in enumerate(layers):
        x = apply_layer(lp, x, cfg, ctx, mode, cache["k"][i], cache["v"][i], pos)
    return x
