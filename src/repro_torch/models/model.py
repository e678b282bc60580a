"""Top-level model API: the counterpart of ``repro.models.model``.

  params         = init_params(cfg, seed, device, ctx=..., rank=...)
  named          = train_params(params)
  logits, aux    = train_logits(params, cfg, batch, ctx)
  loss, metrics  = loss_fn(params, cfg, batch, ctx)
  cache          = init_cache(cfg, B, max_len, device, enc_len=...)
  logits, cache  = prefill(params, cfg, tokens, cache, ctx, enc_inputs=...)
  logits, cache  = decode_step(params, cfg, token, cache, pos, ctx, enc_len=...)

``params`` is a :class:`CausalLM` module: a decoder-only LM, or with an
``encoder`` the decoder of an encoder-decoder model (seamless-m4t), whose
encoder takes precomputed frame embeddings ``enc_inputs`` (B, T_frames,
d_model), the speech frontend being a stub in both packages. Caches are
updated in place, which replaces the JAX package's buffer donation:
``prefill``, ``decode_step`` and ``write_cache_slot(s)`` return the same
tensors they were given.

Parameters carry no gradient by default (serving): ``train_params`` turns
gradients on for a model that is to be trained and returns its named
parameters, the dict the optimizer (``training.optimizer``) takes. A
``batch`` is {"tokens" (B,S), "labels" (B,S)} integer tensors on the
model's device, with "enc_inputs" (B, T_frames, d_model) for an
encoder-decoder model (``training.train_loop.batch_to_device`` moves a
``data.pipeline`` batch there).

On a (D, M) mesh, ``params`` holds one rank's shard: on a model axis of
M > 1 (``ctx.model_parallel``) ``CausalLM.shard`` is (M, model rank) and
the cache holds the rank's kv heads; with FSDP on a data axis of D > 1
``CausalLM.data_shard`` is (D, data rank) and each parameter the rule
table cuts on the data axes carries ``fsdp_dim``, the dim it holds 1/D of
(``sharding.collectives.gathered`` reads it whole for one layer's span).
``convert.shard_params`` cuts a whole model, ``init_params(ctx=...)``
draws a shard directly. In train mode every rank of a mesh runs
``loss_fn`` on its rows of the batch (``training.train_loop``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed_tokens, init_norm, lm_logits
from repro_torch.sharding import collectives
from repro_torch.sharding.context import ExecContext

# a leaf of more elements than this is drawn in pieces of at most _PIECE
# (no config before kimi-k2 has one, so their draws are unchanged)
_WHOLE_DRAW, _PIECE = 1 << 30, 1 << 28


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return dev


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


class Encoder(nn.Module):
    """An encoder-decoder model's encoder (counterpart of
    ``params["encoder"]``): ``num_encoder_layers`` non-causal attention
    layers with dense MLPs and a final norm."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            tfm.Block(cfg, kind, mlp, device, dtype)
            for st in tfm.compute_stages(cfg, cross=True) for _ in range(st.repeats)
            for kind, mlp in st.pattern)
        self.final_norm = init_norm(cfg, device)


class CausalLM(nn.Module):
    """The LM: embedding, decoder layers in absolute order (with
    cross-attention in an encoder-decoder model), final norm, an untied LM
    head where the config has one, and the encoder where it has one."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.shard = None  # (M, model rank) once the parameters are one rank's shard
        self.data_shard = None  # (D, data rank) once FSDP cut them on the data axes
        if cfg.input_mode not in ("tokens", "embeddings"):
            raise NotImplementedError(f"input mode {cfg.input_mode!r} is not a language model: "
                                      "the image model is repro_torch.models.convnet "
                                      "(see ROADMAP.md)")
        dt = dtype_of(cfg.param_dtype)
        self.embedding = nn.Parameter(torch.empty(cfg.padded_vocab, cfg.d_model, dtype=dt,
                                                  device=device))
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.d_model, cfg.padded_vocab, bias=False, device=device,
                                  dtype=dt))
        self.layers = nn.ModuleList(
            tfm.Block(cfg, kind, mlp, device, dt, decoder_cross=cfg.is_encoder_decoder)
            for kind, mlp in zip(cfg.layer_kinds(), cfg.mlp_kinds()))
        self.final_norm = init_norm(cfg, device)
        self.encoder = Encoder(cfg, device, dt) if cfg.is_encoder_decoder else None
        self.requires_grad_(False)


def empty_params(cfg, device) -> CausalLM:
    """A model whose weights are allocated on ``device`` but not set."""
    return CausalLM(cfg, device="meta").to_empty(device=resolve_device(device))


def set_param(model: nn.Module, name: str, tensor: torch.Tensor) -> None:
    """Replace parameter ``name`` of ``model`` with ``tensor``."""
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, leaf,
            nn.Parameter(tensor, requires_grad=False))


def kept_ranges(size: int, M: int, rank: int, segments=None):
    """The [lo, hi) ranges of a dim of ``size`` that rank ``rank`` of M
    holds, in order, and the zero rows its piece holds after them: its 1/M
    slice, or with ``segments`` ((length, cut), ...) its 1/M slice of each
    cut segment and each other segment whole, or with a
    ``placement.PaddedHeads`` its run of real heads, then its zero heads."""
    if hasattr(segments, "ranges"):
        return segments.ranges(M, rank)
    out, off = [], 0
    for length, split in segments or ((size, True),):
        n = length // M if split else length
        lo = off + (rank * n if split else 0)
        out.append((lo, lo + n))
        off += length
    return out, 0


def shard_slice(t: torch.Tensor, dim, M: int, rank: int, segments=None) -> torch.Tensor:
    """Rank ``rank``'s 1/M slice of ``t`` along ``dim`` (``t`` itself when
    ``dim`` is None; its ranges of ``segments`` where given, ``kept_ranges``)."""
    if dim is None:
        return t
    ranges, pad = kept_ranges(t.shape[dim], M, rank, segments)
    parts = [t.narrow(dim, lo, hi - lo) for lo, hi in ranges]
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        parts.append(t.new_zeros(shape))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def mesh_rank(ctx) -> int:
    """This process's rank on ``ctx``'s (D, M) mesh: data rank * M + model
    rank (0 without a mesh)."""
    return ctx.data_rank * ctx.model_parallel + ctx.model_rank


def cuts(plan, name: str, rank: int):
    """The (dim, ways, index, segments) cuts of parameter ``name`` held by
    mesh rank ``rank`` under ``plan`` (a ``placement.ParamPlan``): its model
    dim, with its segments where the plan has them (a GQA kv leaf of fewer
    kv heads than M: Hkv ways, piece m // (M / Hkv)), and its FSDP dim."""
    D, M = plan.shape
    d, m = divmod(rank, M)
    out = []
    if plan.dims[name] is not None and M > 1:
        ways = plan.ways.get(name, M)
        out.append((plan.dims[name], ways, m * ways // M, plan.segments.get(name)))
    if plan.data_dims[name] is not None:
        out.append((plan.data_dims[name], D, d, None))
    return out


def cut(t: torch.Tensor, leaf_cuts) -> torch.Tensor:
    """``t`` cut to one rank's piece by ``leaf_cuts`` (see ``cuts``)."""
    for dim, n, i, segs in leaf_cuts:
        t = shard_slice(t, dim, n, i, segs)
    return t


def place(model: "CausalLM", plan, rank: int) -> "CausalLM":
    """Stamp ``model`` (which holds mesh rank ``rank``'s pieces under
    ``plan``) with its shard, each FSDP leaf's ``fsdp_dim`` and, at M > 1,
    ``partial_fp32`` on each row-parallel ``nn.Linear`` (its weight cut on
    its input dim: ``layers.row_linear``)."""
    D, M = plan.shape
    d, m = divmod(rank, M)
    model.shard = (M, m) if M > 1 else None
    for name, mod in model.named_modules():
        if M > 1 and isinstance(mod, nn.Linear) and plan.dims[f"{name}.weight"] == 1:
            mod.partial_fp32 = True
    fsdp = False
    for name, p in model.named_parameters():
        if plan.data_dims[name] is not None:
            p.fsdp_dim = plan.data_dims[name]
            fsdp = True
    model.data_shard = (D, d) if fsdp else None
    return model


def is_cut(plan) -> bool:
    """Whether ``plan`` cuts any leaf on either axis."""
    return plan.shape[1] > 1 or any(d is not None for d in plan.data_dims.values())


@torch.no_grad()
def init_params(cfg, seed: int = 0, device="cuda", ctx=None, rank=None) -> CausalLM:
    """Seeded random weights with the JAX init's distributions: dense
    weights N(0,1)/sqrt(d_in), the MoE router (fp32) and each expert's
    matrices too, MLA's up-projection ``w_ukv`` N(0,1)/sqrt(kv_lora_rank),
    embedding and LM head N(0,1)*0.02, norm scales (the qk-norm and MLA's
    ``kv_norm`` included) 1, layernorm biases and qkv biases 0, Mamba2 and
    Mamba1 conv weights N(0,1)*0.1 and their constant leaves as their
    ``init_constants`` set them. Drawn in fp32 from a
    ``torch.Generator`` on ``device``, then cast to the param dtype (the
    bits differ from JAX's). A leaf of more than 2^30 elements (kimi-k2's
    experts and embeddings) is drawn in row blocks, so that no fp32 copy
    of it is ever whole.

    With ``ctx`` on a mesh that cuts any leaf (a model axis of M > 1, or
    FSDP on a data axis of D > 1), the model holds only mesh rank
    ``rank``'s pieces (``mesh_rank(ctx)`` by default: data rank * M +
    model rank), placed by ``sharding.placement.plan_params``: every leaf
    is drawn in the same order and pieces as the whole model's and the
    rank keeps its piece of each, so the shards are slices of the very
    weights that ``init_params(cfg, seed)`` gives, and no rank ever holds
    the whole model.

    On ``device="meta"`` (the dry run, ``launch.dryrun``: the counterpart
    of ``jax.eval_shape(init_params)``) the leaves are placed as above and
    nothing is drawn or allocated: a meta generator cannot draw."""
    dev = resolve_device(device)
    shapes = {n: tuple(p.shape) for n, p in CausalLM(cfg, device="meta").named_parameters()}
    plan = None
    if ctx is not None and ctx.mesh is not None:
        from repro_torch.sharding.placement import plan_params
        plan = plan_params(cfg, ctx)
        if not is_cut(plan):
            plan = None
    if plan is None:
        model, leaf_cuts = empty_params(cfg, dev), {}
    else:
        rank = mesh_rank(ctx) if rank is None else rank
        leaf_cuts = {n: cuts(plan, n, rank) for n in shapes}
        model = CausalLM(cfg, device="meta")
        for name, p in list(model.named_parameters()):
            local = cut(p, leaf_cuts[name])  # zero heads of a padded leaf stay 0
            set_param(model, name, torch.zeros(local.shape, dtype=p.dtype, device=dev))
    if dev.type == "meta":
        return model if plan is None else place(model, plan, rank)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(name, t, scale):
        full = shapes[name]
        per_row = 1
        for n in full[1:]:
            per_row *= n
        rows = full[0] if per_row * full[0] <= _WHOLE_DRAW else max(1, _PIECE // per_row)
        lc = leaf_cuts.get(name, [])
        inner = [c for c in lc if c[0] != 0]
        # the rows this rank keeps: (first row, end, where they go in its piece)
        keep, at = [], 0
        for _, n, i, segs in [c for c in lc if c[0] == 0]:
            for lo, hi in kept_ranges(full[0], n, i, segs)[0]:
                keep.append((lo, hi, at))
                at += hi - lo
        for r0 in range(0, full[0], rows):
            r1 = min(full[0], r0 + rows)
            x = cut(torch.randn((r1 - r0, *full[1:]), generator=gen, device=dev,
                                dtype=torch.float32) * scale, inner)
            if not keep:
                t[r0:r1].copy_(x)
            for lo, hi, dst in keep:
                a, b = max(r0, lo), min(r1, hi)
                if a < b:
                    t[dst + a - lo:dst + b - lo].copy_(x[a - r0:b - r0])

    for layer in model.layers:
        if layer.kind == "ssd":  # the rank's heads of A_log's whole ramp
            heads = layer.mixer.A_log.shape[0]
            m = 0 if plan is None else divmod(rank, plan.shape[1])[1]
            layer.mixer.init_constants(cfg.ssm_num_heads, first=m * heads)
        elif layer.kind == "mamba":
            layer.mixer.init_constants()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        full = shapes[name]
        if name.endswith("scale"):
            p.fill_(1.0)
        elif name in ("embedding", "lm_head.weight"):
            normal(name, p, 0.02)
        elif leaf == "conv_w":
            normal(name, p, 0.1)
        elif leaf == "weight":  # nn.Linear weight (d_out, d_in)
            normal(name, p, full[1] ** -0.5)
        elif leaf in ("bq", "bk", "bv", "bias"):
            p.zero_()
        elif leaf in ("router", "w_ukv"):  # (D, E) and (lr, H, nope + vd)
            normal(name, p, full[0] ** -0.5)
        elif leaf in ("w_gate", "w_up", "w_down"):  # MoE experts (E, d_in, d_out)
            normal(name, p, full[1] ** -0.5)
    return model if plan is None else place(model, plan, rank)


def init_cache(cfg, batch, max_len, device="cuda", enc_len=0):
    """The decoder's cache; an encoder-decoder model's cross-attention
    region holds ``enc_len`` frames per row. (One rank's piece of it on a
    model axis: ``sharding.placement.init_placed_cache``.)"""
    return tfm.init_stack_cache(cfg, batch, max_len, dtype_of(cfg.dtype),
                                resolve_device(device), enc_len=enc_len)


def write_cache_slot(pool_cache, one_cache, slot: int):
    """Copy a batch-1 cache into row ``slot`` of a slot-pool cache (every
    leaf: K/V, SSM state, the cross cache)."""
    for name, big in pool_cache.items():
        big[:, slot] = one_cache[name][:, 0].to(big.dtype)
    return pool_cache


def write_cache_slots(pool_cache, group_cache, slots):
    """Scatter the rows of a batched prefill cache into the slot rows named
    by ``slots`` (G,), one indexed copy per cache tensor. Rows whose slot is
    out of range (the pow2 batch padding carries ``n_slots``) are dropped,
    as JAX's ``mode="drop"`` does, so padding never clobbers a live slot."""
    slots = np.asarray(slots, dtype=np.int64)
    leaf = next(iter(pool_cache.values()))
    n_slots = leaf.shape[1]
    rows = np.nonzero((slots >= 0) & (slots < n_slots))[0]
    dev = leaf.device
    dst = torch.as_tensor(slots[rows], device=dev)
    src = torch.as_tensor(rows, device=dev)
    for name, big in pool_cache.items():
        big[:, dst] = group_cache[name][:, src].to(big.dtype)
    return pool_cache


def encode(params: CausalLM, cfg, enc_inputs, ctx=ExecContext(), train_route=False):
    """The encoder over frame embeddings ``enc_inputs`` (B, T_frames,
    d_model): (B, T_frames, d_model) after its final norm. ``train_route``
    (the train forward) takes train mode's differentiable attention."""
    x = enc_inputs.to(dtype_of(cfg.dtype))
    x = tfm.apply_stack(params.encoder.layers, cfg, x, ctx, "encode", train_route=train_route)
    return apply_norm(params.encoder.final_norm, x)


def _embed_inputs(params: CausalLM, cfg, inputs, ctx):
    """Token ids are embedded; an embedding-input model takes a float
    (B, S, d_model) tensor as it is."""
    if cfg.input_mode == "embeddings" and inputs.is_floating_point() and inputs.dim() == 3:
        return inputs.to(dtype_of(cfg.dtype))
    with collectives.gathered(ctx, params, recurse=False):
        return embed_tokens(params.embedding, inputs, cfg, ctx).to(dtype_of(cfg.dtype))


def _logits(params: CausalLM, cfg, x, ctx, gather=True):
    """The final norm and the LM head (FSDP leaves gathered for the call):
    the whole vocabulary's logits, or without ``gather`` the model rank's
    slice (``lm_logits``)."""
    x = apply_norm(params.final_norm, x)
    with collectives.gathered(ctx, params, params.lm_head, recurse=False):
        return lm_logits(params.embedding, params.lm_head, x, cfg, ctx, gather)


def train_params(params: CausalLM) -> dict:
    """Turn gradients on for every parameter of ``params``; returns its
    named parameters."""
    params.requires_grad_(True)
    return dict(params.named_parameters())


def check_train_mesh(params: CausalLM, ctx) -> None:
    """Train mode on a mesh: ``params`` must hold this rank's shard (the
    layouts ``placement`` refuses are refused there, for serving and
    training alike)."""
    if ctx.mesh is None:
        return
    M = ctx.model_parallel
    if M > 1 and params.shard != (M, ctx.model_rank):
        raise ValueError(f"params hold the shard {params.shard}, not this rank's (M, rank) = "
                         f"{(M, ctx.model_rank)}: cut them with convert.shard_params or draw "
                         "them with init_params(ctx=...)")


def _train_hidden(params: CausalLM, cfg, batch, ctx):
    """The train forward up to the final norm: (the stack's output, the MoE
    layers' summed load-balance loss, an fp32 scalar). An encoder-decoder
    model encodes ``batch["enc_inputs"]`` first; the encoder, like the
    decoder, takes the differentiable train route of attention."""
    check_train_mesh(params, ctx)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, batch["enc_inputs"], ctx, train_route=True)
    x = _embed_inputs(params, cfg, batch["tokens"], ctx)
    return tfm.apply_stack(params.layers, cfg, x, ctx, "train", enc_out=enc_out)


def train_logits(params: CausalLM, cfg, batch, ctx=ExecContext()):
    """The train forward: (fp32 logits (B, S, padded vocab), the MoE aux
    loss). Every rank gets whole rows of logits, gathered over the model
    axis at M > 1; ``loss_fn`` takes its own route, which keeps them cut."""
    x, aux = _train_hidden(params, cfg, batch, ctx)
    return _logits(params, cfg, x, ctx), aux


def loss_fn(params: CausalLM, cfg, batch, ctx=ExecContext()):
    """Next-token cross-entropy over the fp32 logits (logsumexp minus the
    gold logit, averaged over every position) plus ``cfg.router_aux_loss``
    times the MoE aux loss. Returns (loss, {"nll", "aux"}). At M = 1 (and
    with no mesh) over ``train_logits``' whole rows; at M > 1 over the
    model rank's slice of the vocabulary, never gathered
    (``collectives.vocab_parallel_nll``): the padded columns stay in the
    log-sum-exp, as in the reference, and every model rank gets the same
    loss."""
    labels = batch["labels"]
    if ctx.model_parallel > 1:
        x, aux = _train_hidden(params, cfg, batch, ctx)
        nll = collectives.vocab_parallel_nll(_logits(params, cfg, x, ctx, gather=False), labels,
                                             ctx).mean()
    else:
        logits, aux = train_logits(params, cfg, batch, ctx)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = (lse - gold).mean()
    loss = nll + cfg.router_aux_loss * aux
    return loss, {"nll": nll, "aux": aux}


def prefill(params: CausalLM, cfg, inputs, cache, ctx=ExecContext(), last_only=False,
            pad_mask=None, enc_inputs=None):
    """Run the prompt (B, S) through the model, writing mixer state into
    ``cache``. Returns (logits, cache): logits at every position, or at the
    last one only with ``last_only`` (the serving path; it spares a
    (B, S, V) fp32 tensor).

    ``pad_mask`` (B, S) bool, True at valid positions, makes LEFT-padded
    (bucketed) prompts safe for pure-SSM stacks: masked positions neither
    update nor decay the scan state (attention layers raise).
    ``enc_inputs`` (B, T_frames, d_model): an encoder-decoder model's
    encoder input; its cross K/V go to the cache at [0, T_frames)."""
    enc_out = encode(params, cfg, enc_inputs, ctx) if cfg.is_encoder_decoder else None
    x = _embed_inputs(params, cfg, inputs, ctx)
    x = tfm.apply_stack(params.layers, cfg, x, ctx, "prefill", cache, ssm_mask=pad_mask,
                        enc_out=enc_out)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x, ctx), cache


def decode_step(params: CausalLM, cfg, token, cache, pos, ctx=ExecContext(), enc_len=None):
    """token (B,1) ids; pos an int (position-synchronous batch) or a (B,)
    tensor of per-row write positions (ragged continuous batching). With
    (B,) positions, token may be (B,T): row b feeds positions
    pos[b]..pos[b]+T-1 (the speculative verify; attention stacks only) and
    the logits are (B,T,V). ``enc_len`` (encoder-decoder models): an int or
    (B,) valid lengths of the cross cache's rows, which a slot pool
    preallocates at ``max_enc_len``; None attends to the whole region (an
    exact-length cache)."""
    with collectives.gathered(ctx, params, recurse=False):
        x = embed_tokens(params.embedding, token, cfg, ctx).to(dtype_of(cfg.dtype))
    x = tfm.apply_stack(params.layers, cfg, x, ctx, "decode", cache, pos=pos, enc_len=enc_len)
    return _logits(params, cfg, x, ctx), cache
