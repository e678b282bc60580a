"""Decoder and encoder stacks: the counterpart of ``repro.models.transformer``.

The JAX package scans each *stage* (a repeating pattern of layers, e.g.
gemma2's (local, global) pair) over stacked params to keep its compiled
graph small. PyTorch runs eagerly, so the port keeps the layers as one
``nn.ModuleList`` in absolute layer order and loops over it;
``compute_stages`` stays to map the JAX params onto that order
(``repro_torch.convert``) and to find, in train mode, the stage steps that
the reference remats and pipelines.

Modes: ``train`` (full causal forward, no cache; returns the MoE layers'
summed load-balance loss beside the output), ``prefill`` (full causal
forward writing mixer state into the cache at positions [0, S)),
``decode`` (one token per row at ``pos`` against the cache, or T > 1
tokens per row at pos..pos+T-1 for the speculative verify, attention
stacks only: an SSM's state cannot roll back a rejected draft) and
``encode`` (the encoder stack of an encoder-decoder model: non-causal
self-attention, no cache).

Train mode differentiates what the reference's train mode computes: the
attention of ``attention.TRAIN_IMPL`` (``full_attention``, or
``chunked_attention`` past 2048 keys), Mamba2's ``ssd_chunked`` and
Mamba1's ``selective_scan``, whatever ``ctx.attn_impl`` says, since no
kernel has a backward. Each step of a stage (one repeat of its pattern) is
rematerialised per ``ctx.plan["remat_policy"]``: ``"full"`` (the default)
checkpoints it whole, ``"dots"`` saves the outputs of its matmuls without
batch dims (the projections, which fold their batch into ``aten.mm`` or
``addmm``) and recomputes the rest, the batched attention scores and MoE
expert products included (the reference's
``dots_with_no_batch_dims_saveable``), ``"none"`` keeps every activation. ``ctx.plan["pipeline"]``
runs a stage whose repeats divide into its stages through
``sharding.pipeline.circular_pipeline``, under the reference's condition.

The cache is a dict of stacked tensors, batch on axis 1, updated in place.
Each leaf is stacked over the layers of its own kind only, so a hybrid
stack keeps no K/V for its SSM layers and no state for its attention
layers; layer i reads entry j of a leaf when it is the j-th layer of that
leaf's kind (``layer_caches``):

* ``k``/``v`` (attention layers, batch, max_len, kv heads, head dim) for
  GQA layers, or ``latent`` (attention layers, batch, max_len,
  kv_lora_rank + qk_rope_dim) for MLA stacks, each row ``[c_kv | k_rope]``;
* ``xk``/``xv`` (attention layers, batch, enc_len, kv heads, head dim),
  the cross-attention's K/V of an encoder-decoder decoder, written at
  [0, T_frames) by prefill and masked per row to ``enc_len`` at decode;
* ``conv`` (SSM layers, batch, W-1, conv width) in the activation dtype
  and ``ssm`` in fp32: (…, heads, head dim, N) for Mamba2, (…, d_inner, N)
  for Mamba1.

Layers: GQA (qkv bias, qk-norm) or MLA attention, Mamba2 (``ssd``) and
Mamba1 (``mamba``) mixers, dense (SwiGLU/GeGLU, or the layernorm models'
GELU FFN) or MoE MLPs with a dense prefix of ``first_dense_layers``,
gemma2's post-block norms, and the decoder's cross-attention.

On a model axis of M > 1 (``ctx.model_parallel``; ``sharding.placement``)
each rank holds its 1/M of the heads, ``d_ff`` and experts (every expert
where M does not divide them), its K/V and cross caches hold its Hkv/M kv
heads (one kv head and its piece of the sequence where M is a multiple of
Hkv; ``init_stack_cache`` gives the whole cache,
``placement.local_cache_shape`` a rank's piece), MLA's latent cache holds
the rank's piece of the sequence (``models.attention``), and an SSM mixer
holds its 1/M of the heads or inner channels with
its state (``models.ssm``): the normed input of the mixer (attention, MLA,
Mamba2 or Mamba1), of the decoder's cross-attention and of the dense MLP
enters through ``collectives.copy_to_model`` and their row-parallel
outputs (fp32 partial sums when serving, ``layers.row_linear``) are
summed over the ranks (``reduce_from_model``) and cast to the activation
dtype here, before any post-block norm; the MoE layer does its own. The
encoder's layers run the same way. In train mode these are Megatron's
pair, so the gradients are those of the unsharded layer; the leaves
that every rank holds whole but applies to its own heads (MLA's latent
projection and its norm, Mamba2's B and C columns) get partial gradients,
which ``training.train_loop.sync_grads`` sums over the model axis, while
the residual stream's gradient is summed once, by the ``copy_to_model``
before the mixer (train mode refuses Mamba1 and hybrid stacks at M > 1).
With FSDP on a data axis of D > 1 every layer
gathers its cut weights for its own span
(``collectives.gathered``), inside the remat step, so that the backward's
recompute gathers them again instead of keeping them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as att
from repro_torch.models import moe, ssm
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.sharding import collectives
from repro_torch.sharding.pipeline import circular_pipeline

ATTN_KINDS = ("attn", "local", "global")
SSM_KINDS = ("ssd", "mamba")
MODES = ("train", "prefill", "decode", "encode")
REMAT_POLICIES = ("full", "dots", "none")
# the matmuls whose outputs remat policy "dots" saves: those without batch dims
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# the kind of layer each cache leaf is stacked over
LEAF_KINDS = {"k": "attn", "v": "attn", "latent": "attn", "xk": "attn", "xv": "attn",
              "conv": "ssm", "ssm": "ssm"}


@dataclass(frozen=True)
class Stage:
    repeats: int
    pattern: Tuple[Tuple[str, str], ...]  # ((mixer_kind, mlp_kind), ...)


def compute_stages(cfg, cross=False) -> List[Stage]:
    """The JAX package's stage decomposition; ``cross=True`` gives the
    encoder stack's (non-causal attention and a dense MLP per layer)."""
    seq = list(zip(cfg.layer_kinds(), cfg.mlp_kinds()))
    if cross:
        seq = [("attn", "dense")] * cfg.num_encoder_layers
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
    """One layer (counterpart of ``init_layer``); ``decoder_cross`` gives an
    attention layer of an encoder-decoder decoder its cross-attention."""

    def __init__(self, cfg, kind: str, mlp_kind: str, device=None, dtype=None,
                 decoder_cross: bool = False):
        super().__init__()
        if kind not in ATTN_KINDS + SSM_KINDS or mlp_kind not in ("dense", "moe", "none"):
            raise ValueError(f"unknown layer ({kind!r}, {mlp_kind!r})")
        self.kind = kind
        self.mlp_kind = mlp_kind
        self.window = cfg.sliding_window if kind == "local" else None
        self.pre_norm = init_norm(cfg, device)
        if kind == "ssd":
            self.mixer = ssm.Mamba2(cfg, device, dtype)
        elif kind == "mamba":
            self.mixer = ssm.Mamba1(cfg, device, dtype)
        else:
            self.attn = att.MLA(cfg, device, dtype) if cfg.use_mla else att.GQA(cfg, device,
                                                                                   dtype)
        self.cross = None
        if decoder_cross and kind in ATTN_KINDS:
            self.cross_norm = init_norm(cfg, device)
            self.cross = att.GQA(cfg, device, dtype)
        if mlp_kind != "none":
            self.mlp_norm = init_norm(cfg, device)
            self.mlp = moe.MoE(cfg, device, dtype) if mlp_kind == "moe" else init_mlp(
                cfg, device, dtype)
        if cfg.post_block_norm:
            self.post_norm = init_norm(cfg, device)
            if mlp_kind != "none":
                self.mlp_post_norm = init_norm(cfg, device)


def init_stack_cache(cfg, batch, max_len, dtype, device=None, enc_len=0):
    """The stacked cache of ``cfg``'s decoder (see the module docstring);
    an encoder-decoder model's carries ``xk``/``xv`` at ``enc_len``."""
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    ssm_kinds = {k for k in kinds if k in SSM_KINDS}
    if len(ssm_kinds) > 1:
        raise NotImplementedError("a stack of both Mamba1 and Mamba2 layers has no config "
                                  "and no cache layout")
    n_ssm = len(kinds) - n_attn
    cache = {}
    if n_attn:
        if cfg.use_mla:
            cache["latent"] = torch.zeros((n_attn, batch, max_len, att.latent_width(cfg)),
                                          dtype=dtype, device=device)
        else:
            shape = (n_attn, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
            cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
        if cfg.is_encoder_decoder:
            shape = (n_attn, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
            cache["xk"] = torch.zeros(shape, dtype=dtype, device=device)
            cache["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    if "ssd" in ssm_kinds:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_d_state
        cache["conv"] = torch.zeros((n_ssm, batch, cfg.ssm_d_conv - 1, conv_dim), dtype=dtype,
                                    device=device)
        cache["ssm"] = torch.zeros((n_ssm, batch, cfg.ssm_num_heads, cfg.ssm_head_dim,
                                    cfg.ssm_d_state), dtype=torch.float32, device=device)
    elif "mamba" in ssm_kinds:
        cache["conv"] = torch.zeros((n_ssm, batch, cfg.ssm_d_conv - 1, cfg.d_inner),
                                    dtype=dtype, device=device)
        cache["ssm"] = torch.zeros((n_ssm, batch, cfg.d_inner, cfg.ssm_d_state),
                                   dtype=torch.float32, device=device)
    return cache


def layer_caches(layers, cache):
    """Each layer's (batch, ...) views of the stacked cache: its own
    kind's entry of every leaf stacked over that kind (None without a
    cache)."""
    if cache is None:
        return [None] * len(layers)
    seen = {"attn": 0, "ssm": 0}
    out = []
    for lp in layers:
        kind = "attn" if lp.kind in ATTN_KINDS else "ssm"
        i = seen[kind]
        seen[kind] += 1
        out.append({n: c[i] for n, c in cache.items() if LEAF_KINDS[n] == kind})
    return out


def _apply_ssm(lp: Block, h, cfg, ctx, impl, mode, cache, ssm_mask):
    if mode == "decode":
        if h.shape[1] != 1:
            raise ValueError(f"SSM decode is single-token; got {h.shape[1]} positions "
                             f"for layer kind {lp.kind!r}")
        step = ssm.mamba2_decode if lp.kind == "ssd" else ssm.mamba1_decode
        mix, (conv_s, ssm_s) = step(lp.mixer, h, cfg, cache["conv"], cache["ssm"], ctx=ctx)
    elif lp.kind == "ssd":
        mix, (conv_s, ssm_s) = ssm.mamba2_forward(lp.mixer, h, cfg, mask=ssm_mask, impl=impl,
                                                  ctx=ctx)
    else:
        mix, (conv_s, ssm_s) = ssm.mamba1_forward(lp.mixer, h, cfg, mask=ssm_mask, ctx=ctx)
    if cache is not None:
        cache["conv"].copy_(conv_s)
        cache["ssm"].copy_(ssm_s)
    return mix


def _apply_mixer(lp: Block, h, cfg, ctx, impl, mode, cache, pos, ssm_mask):
    """The layer's mixer; ``cache`` holds this layer's (batch, ...) views,
    written in place (None in train and encode mode)."""
    if lp.kind in SSM_KINDS:
        return _apply_ssm(lp, h, cfg, ctx, impl, mode, cache, ssm_mask)
    if ssm_mask is not None:
        raise ValueError("pad_mask/ssm_mask is only supported for pure-SSM stacks; "
                         f"layer kind {lp.kind!r} attends over absolute positions")
    if mode == "encode":
        return att.gqa_encode(lp.attn, h, cfg, impl=impl)
    if cfg.use_mla:
        if mode == "decode":
            return att.mla_decode(lp.attn, h, cfg, cache["latent"], pos, impl=impl, ctx=ctx)[0]
        mix, (c_kv, k_rope) = att.mla_forward(lp.attn, h, cfg, impl=impl)
        if cache is not None:
            dt = cache["latent"].dtype
            att.write_prefix(cache["latent"], torch.cat([c_kv.to(dt), k_rope.to(dt)], -1), cfg,
                             ctx)
        return mix
    if mode == "decode":
        mix, _ = att.gqa_decode(lp.attn, h, cfg, cache["k"], cache["v"], pos,
                                window=lp.window, impl=impl, ctx=ctx)
        return mix
    mix, (k, v) = att.gqa_forward(lp.attn, h, cfg, window=lp.window, impl=impl, ctx=ctx)
    if cache is not None:
        att.write_prefix(cache["k"], k, cfg, ctx)
        att.write_prefix(cache["v"], v, cfg, ctx)
    return mix


def _apply_cross(lp: Block, x, cfg, ctx, impl, mode, cache, enc_out, enc_len):
    """The decoder's cross-attention. Prefill computes the encoder's K/V and
    writes them into the cross cache at [0, T_frames) (the region may be
    preallocated wider, at a slot pool's ``max_enc_len``); decode reads the
    cache, each row masked to its ``enc_len`` (None: all of it); train mode
    attends to the encoder's K/V and keeps no cache. At M > 1 the rank's
    heads: its input through ``copy_to_model`` (the encoder output too,
    whose K/V it projects), its wo output summed over the ranks."""
    hc = collectives.copy_to_model(apply_norm(lp.cross_norm, x), ctx)
    if mode == "decode":
        out = att.gqa_cross(lp.cross, hc, cfg, cache["xk"], cache["xv"], enc_len=enc_len,
                            impl=impl, ctx=ctx)
        return collectives.reduce_from_model(out, ctx).to(x.dtype)
    ek, ev = att.cross_kv(lp.cross, collectives.copy_to_model(enc_out, ctx), cfg)
    if cache is not None:
        att.write_prefix(cache["xk"], ek, cfg, ctx)
        att.write_prefix(cache["xv"], ev, cfg, ctx)
    return collectives.reduce_from_model(att.gqa_cross(lp.cross, hc, cfg, ek, ev, impl=impl),
                                         ctx).to(x.dtype)


def apply_layer(lp: Block, x, cfg, ctx, mode, cache, pos, ssm_mask=None, enc_out=None,
                enc_len=None, train_route=False):
    """``cache``: this layer's views of the stacked cache (None in train and
    encode mode). Train mode, or ``train_route`` (the encoder of a train
    forward), takes the differentiable route, else ``ctx.attn_impl``.
    Returns (the layer's output, its MoE load-balance loss: an fp32 scalar
    tensor, or 0.0 without an MoE)."""
    impl = att.TRAIN_IMPL if mode == "train" or train_route else ctx.attn_impl
    h = collectives.copy_to_model(apply_norm(lp.pre_norm, x), ctx)
    mix = _apply_mixer(lp, h, cfg, ctx, impl, mode, cache, pos, ssm_mask)
    mix = collectives.reduce_from_model(mix, ctx).to(x.dtype)  # the ranks' wo outputs
    if cfg.post_block_norm:
        mix = apply_norm(lp.post_norm, mix)
    x = x + mix
    if lp.cross is not None:
        x = x + _apply_cross(lp, x, cfg, ctx, impl, mode, cache, enc_out, enc_len)
    aux = 0.0
    if lp.mlp_kind == "none":
        return x, aux
    h = apply_norm(lp.mlp_norm, x)
    if lp.mlp_kind == "moe":
        y, aux = moe.moe_apply(lp.mlp, h, cfg, ctx)
    else:
        y = apply_mlp(lp.mlp, collectives.copy_to_model(h, ctx), cfg)
        y = collectives.reduce_from_model(y, ctx).to(x.dtype)  # the ranks' w_down outputs
    if cfg.post_block_norm:
        y = apply_norm(lp.mlp_post_norm, y)
    return x + y, aux


def layer_weights(lp: Block, cfg, ctx):
    """The span over which layer ``lp``'s FSDP weights read whole: the
    2-D MoE keeps its experts' F pieces (``moe.uses_2d``)."""
    keep = (lp.mlp,) if lp.mlp_kind == "moe" and moe.uses_2d(cfg, ctx) else ()
    return collectives.gathered(ctx, lp, exclude=keep)


def stage_steps(layers, cfg) -> list:
    """The decoder's stages (``compute_stages``) over ``layers``: a list of
    (stage, steps), each step the layers of one repeat of its pattern."""
    out, off = [], 0
    for st in compute_stages(cfg):
        p = len(st.pattern)
        out.append((st, [layers[off + r * p:off + (r + 1) * p] for r in range(st.repeats)]))
        off += st.repeats * p
    return out


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, policy: str):
    """``body(step, x) -> (x, aux)`` rematerialised per the plan's policy."""
    if policy == "none":
        return body
    if policy == "full":
        return lambda step, x: checkpoint(body, step, x, use_reentrant=False)
    if policy == "dots":
        return lambda step, x: checkpoint(
            body, step, x, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_save_dots))
    raise ValueError(f"unknown remat policy {policy!r}; choose from {REMAT_POLICIES}")


def _train_stack(layers, cfg, x, ctx, enc_out):
    """Train mode: (x, summed MoE aux loss), each stage step rematerialised
    and, under the pipeline plan, a stage pipelined (see the module
    docstring)."""

    def body(step, xc):
        aux = torch.zeros((), dtype=torch.float32, device=xc.device)
        for lp in step:
            with layer_weights(lp, cfg, ctx):
                xc, a = apply_layer(lp, xc, cfg, ctx, "train", None, 0, enc_out=enc_out)
            aux = aux + a
        return xc, aux

    fn = _remat(body, ctx.plan.get("remat_policy", "full"))

    def stage_fn(group, xmb):
        aux = torch.zeros((), dtype=torch.float32, device=xmb.device)
        for step in group:
            xmb, a = fn(step, xmb)
            aux = aux + a
        return xmb, aux

    pipe = ctx.plan.get("pipeline")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for st, steps in stage_steps(layers, cfg):
        if (pipe and int(pipe.get("stages", 0)) > 1 and st.repeats % int(pipe["stages"]) == 0
                and x.shape[0] % int(pipe.get("microbatches", 1)) == 0):
            x, aux = circular_pipeline(stage_fn, steps, x, int(pipe["stages"]),
                                       int(pipe.get("microbatches", 1)))
        else:
            x, aux = stage_fn(steps, x)
        aux_total = aux_total + aux
    return x, aux_total


def apply_stack(layers: nn.ModuleList, cfg, x, ctx, mode, cache=None, pos=0, ssm_mask=None,
                enc_out=None, enc_len=None, train_route=False):
    """``enc_out`` (B, T, D): the encoder's output, which an encoder-decoder
    decoder's prefill and train forward attend to; ``enc_len`` (an int or
    (B,)): its decode rows' encoder lengths; ``train_route``: the encoder
    of a train forward takes train mode's attention. Returns the stack's
    output, or in train mode (output, summed MoE aux loss)."""
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r}: the port runs {MODES}")
    if mode == "train":
        return _train_stack(layers, cfg, x, ctx, enc_out)
    for lp, c in zip(layers, layer_caches(layers, cache)):
        with layer_weights(lp, cfg, ctx):
            x = apply_layer(lp, x, cfg, ctx, mode, c, pos, ssm_mask, enc_out, enc_len,
                            train_route)[0]
    return x
