"""Decoder stack: the counterpart of ``repro.models.transformer``.

The JAX package scans each *stage* (a repeating pattern of layers, e.g.
gemma2's (local, global) pair) over stacked params to keep its compiled
graph small. PyTorch runs eagerly, so the port keeps the layers as one
``nn.ModuleList`` in absolute layer order and loops over it;
``compute_stages`` stays to map the JAX params onto that order
(``repro_torch.convert``).

Modes: ``prefill`` (full causal forward writing mixer state into the cache
at positions [0, S)) and ``decode`` (one token per row at ``pos`` against
the cache, or T > 1 tokens per row at pos..pos+T-1 for the speculative
verify, attention stacks only: an SSM's state cannot roll back a rejected
draft). The cache is a dict of stacked tensors, layer axis first and
batch second, updated in place: ``k``/``v`` (layers, batch, max_len, kv
heads, head dim) for GQA stacks; ``latent`` (layers, batch, max_len,
kv_lora_rank + qk_rope_dim) for MLA stacks, each row ``[c_kv | k_rope]``;
``conv`` (layers, batch, W-1, d_inner + 2N) in the activation dtype and
``ssm`` (layers, batch, heads, head dim, N) in fp32 for Mamba2 stacks.

This slice serves attention stacks (``attn``/``local``/``global`` mixers,
GQA with qkv bias and qk-norm or MLA, dense or MoE MLPs with a dense
prefix of ``first_dense_layers``, gemma2's post-block norms) and pure
Mamba2 (``ssd``) stacks; Mamba1, hybrid and cross-attention layers raise
(see ROADMAP.md). The MoE layers' load-balance loss is dropped: the port
serves and does not train.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch import nn

from repro_torch.models import attention as att
from repro_torch.models import moe, ssm
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
        ported = ((kind in ATTN_KINDS and mlp_kind in ("dense", "moe"))
                  or (kind == "ssd" and mlp_kind == "none"))
        if not ported:
            raise NotImplementedError(
                f"layer ({kind!r}, {mlp_kind!r}) is not ported yet: this slice serves "
                "GQA/MLA stacks with dense or MoE MLPs and Mamba2 stacks (see ROADMAP.md)")
        self.kind = kind
        self.mlp_kind = mlp_kind
        self.window = cfg.sliding_window if kind == "local" else None
        self.pre_norm = init_norm(cfg, device)
        if kind == "ssd":
            self.mixer = ssm.Mamba2(cfg, device, dtype)
            return
        self.attn = att.MLA(cfg, device, dtype) if cfg.use_mla else att.GQA(cfg, device, dtype)
        self.mlp_norm = init_norm(cfg, device)
        self.mlp = moe.MoE(cfg, device, dtype) if mlp_kind == "moe" else MLP(cfg, device, dtype)
        if cfg.post_block_norm:
            self.post_norm = init_norm(cfg, device)
            self.mlp_post_norm = init_norm(cfg, device)


def init_stack_cache(cfg, batch, max_len, dtype, device=None):
    kinds = set(cfg.layer_kinds())
    L = cfg.num_layers
    if kinds == {"ssd"}:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_d_state
        return {"conv": torch.zeros((L, batch, cfg.ssm_d_conv - 1, conv_dim), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((L, batch, cfg.ssm_num_heads, cfg.ssm_head_dim,
                                    cfg.ssm_d_state), dtype=torch.float32, device=device)}
    if not kinds <= set(ATTN_KINDS):
        raise NotImplementedError(f"a cache for layer kinds {sorted(kinds)} is not ported "
                                  "yet (see ROADMAP.md)")
    if cfg.use_mla:
        return {"latent": torch.zeros((L, batch, max_len, att.latent_width(cfg)), dtype=dtype,
                                      device=device)}
    shape = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _apply_mixer(lp: Block, h, cfg, ctx, mode, cache, pos, ssm_mask):
    """The layer's mixer; ``cache`` holds this layer's (batch, ...) views,
    written in place."""
    if lp.kind == "ssd":
        if mode == "decode":
            if h.shape[1] != 1:
                raise ValueError(f"SSM decode is single-token; got {h.shape[1]} positions")
            mix, (conv_s, ssm_s) = ssm.mamba2_decode(lp.mixer, h, cfg, cache["conv"],
                                                     cache["ssm"])
        else:
            mix, (conv_s, ssm_s) = ssm.mamba2_forward(lp.mixer, h, cfg, mask=ssm_mask,
                                                      impl=ctx.attn_impl)
        cache["conv"].copy_(conv_s)
        cache["ssm"].copy_(ssm_s)
        return mix
    if ssm_mask is not None:
        raise ValueError("pad_mask/ssm_mask is only supported for pure-SSM stacks; "
                         f"layer kind {lp.kind!r} attends over absolute positions")
    if cfg.use_mla:
        if mode == "decode":
            return att.mla_decode(lp.attn, h, cfg, cache["latent"], pos, impl=ctx.attn_impl)[0]
        mix, (c_kv, k_rope) = att.mla_forward(lp.attn, h, cfg, impl=ctx.attn_impl)
        S, lr = c_kv.shape[1], cfg.kv_lora_rank
        cache["latent"][:, :S, :lr] = c_kv.to(cache["latent"].dtype)
        cache["latent"][:, :S, lr:] = k_rope.to(cache["latent"].dtype)
        return mix
    if mode == "decode":
        mix, _ = att.gqa_decode(lp.attn, h, cfg, cache["k"], cache["v"], pos,
                                window=lp.window, impl=ctx.attn_impl)
        return mix
    mix, (k, v) = att.gqa_forward(lp.attn, h, cfg, window=lp.window, impl=ctx.attn_impl)
    S = k.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return mix


def apply_layer(lp: Block, x, cfg, ctx, mode, cache, pos, ssm_mask=None):
    """``cache``: this layer's views of the stacked cache. Returns the
    layer's output."""
    mix = _apply_mixer(lp, apply_norm(lp.pre_norm, x), cfg, ctx, mode, cache, pos, ssm_mask)
    if lp.kind == "ssd":  # a pure-SSM layer has no MLP
        return x + mix
    if cfg.post_block_norm:
        mix = apply_norm(lp.post_norm, mix)
    x = x + mix
    h = apply_norm(lp.mlp_norm, x)
    y = moe.moe_apply(lp.mlp, h, cfg)[0] if lp.mlp_kind == "moe" else apply_mlp(lp.mlp, h, cfg)
    if cfg.post_block_norm:
        y = apply_norm(lp.mlp_post_norm, y)
    return x + y


def apply_stack(layers: nn.ModuleList, cfg, x, ctx, mode, cache, pos=0, ssm_mask=None):
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r}: this slice runs {MODES}")
    for i, lp in enumerate(layers):
        x = apply_layer(lp, x, cfg, ctx, mode, {n: c[i] for n, c in cache.items()}, pos,
                        ssm_mask)
    return x
