"""Model configs, the registry of ported archs, and reduced variants.

A copy of ``repro.configs.base`` (``ModelConfig`` with its parameter
counts, the input shapes ``SHAPES``, ``get_config``, ``reduced``) kept here
so the port imports nothing of the JAX package.
``get_config`` knows the archs of the JAX registry, every one of which the
port serves, and the paper's own evaluation model.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


# the production shapes of the dry run (launch.dryrun)
SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | conv
    source: str  # citation from the assignment table

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention features
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # window for "local" layers
    # per-layer mixer pattern, repeated over depth. entries:
    #   "attn" | "local" | "global" | "mamba" | "ssd"
    layer_pattern: Tuple[str, ...] = ("attn",)
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    post_block_norm: bool = False  # gemma2-style pre+post norms

    # MLA (deepseek-style multi-head latent attention)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1
    moe_layer_offset: int = 0
    moe_capacity_factor: float = 1.25
    first_dense_layers: int = 0
    router_aux_loss: float = 0.01

    # SSM (mamba / mamba2-SSD)
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # encoder-decoder
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # frontend: "tokens" (ids), "embeddings" (precomputed frames/patches)
    # or "image" (the conv family)
    input_mode: str = "tokens"

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 255) // 256) * 256

    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind for each of num_layers layers."""
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def mlp_kinds(self) -> Tuple[str, ...]:
        """'dense' | 'moe' | 'none' per layer."""
        out = []
        for i in range(self.num_layers):
            if self.layer_kinds()[i] == "ssd" and self.family == "ssm":
                out.append("none")
            elif (
                self.num_experts > 0
                and i >= self.first_dense_layers
                and (i % self.moe_layer_period) == self.moe_layer_offset
            ):
                out.append("moe")
            elif self.d_ff > 0:
                out.append("dense")
            else:
                out.append("none")
        return tuple(out)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), as
        ``repro.configs.base.ModelConfig.param_count`` counts it."""
        n = self.padded_vocab * self.d_model
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model
        kinds, mlps = self.layer_kinds(), self.mlp_kinds()
        for k, m in zip(kinds, mlps):
            if k in ("attn", "local", "global"):
                if self.use_mla:
                    r = self.kv_lora_rank
                    qk = self.qk_nope_dim + self.qk_rope_dim
                    n += self.d_model * (self.num_heads * qk)  # q proj
                    n += self.d_model * (r + self.qk_rope_dim)  # kv down
                    n += r * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                    n += self.num_heads * self.v_head_dim * self.d_model
                else:
                    n += self.d_model * (self.q_dim + 2 * self.kv_dim)
                    n += self.q_dim * self.d_model
            elif k in ("mamba", "ssd"):
                di, ds = self.d_inner, self.ssm_d_state
                if k == "ssd":
                    ng = 1
                    n += self.d_model * (2 * di + 2 * ng * ds + self.ssm_num_heads)
                else:
                    n += self.d_model * 2 * di + di * 2 * ds + di * (di // 16) * 2
                n += di * self.d_model
            if m == "dense":
                n += 3 * self.d_model * self.d_ff
            elif m == "moe":
                n += (self.num_experts + self.num_shared_experts) * 3 * self.d_model * self.moe_d_ff
                n += self.d_model * self.num_experts
            n += 2 * self.d_model  # norms
        if self.is_encoder_decoder:
            # encoder blocks: self-attn + mlp; decoder already counted above,
            # add cross-attention per decoder layer
            enc = self.num_encoder_layers * (
                self.d_model * (self.q_dim + 2 * self.kv_dim)
                + self.q_dim * self.d_model
                + 3 * self.d_model * self.d_ff
            )
            xattn = self.num_layers * (
                self.d_model * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.d_model
            )
            n += enc + xattn
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE top-k instead of all experts); the
        scheduler-less speculative round prices its draft with it."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for m in self.mlp_kinds() if m == "moe")
        all_e = moe_layers * self.num_experts * 3 * self.d_model * self.moe_d_ff
        act_e = moe_layers * self.top_k * 3 * self.d_model * self.moe_d_ff
        return full - all_e + act_e


# the archs the port serves: every arch of the JAX registry
ARCHS = ["tinyllama-1.1b", "gemma2-2b", "mamba2-2.7b", "granite-3-8b", "qwen2-7b",
         "chameleon-34b", "deepseek-v2-lite-16b", "seamless-m4t-medium", "jamba-v0.1-52b",
         "kimi-k2-1t-a32b"]

EXTRA_ARCHS = ["yolo-v2-tiny"]  # the paper's own evaluation model


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if _module_name(arch_id) not in {_module_name(a) for a in ARCHS + EXTRA_ARCHS}:
        raise ValueError(
            f"unknown arch {arch_id!r}: repro_torch has the configs {ARCHS + EXTRA_ARCHS}, "
            "those of the JAX registry (ROADMAP.md lists what the port still lacks)")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family/features, CPU-sized: <=2 layers, d_model<=512, <=4 experts."""
    changes = {}
    changes["num_layers"] = min(cfg.num_layers, 2)
    d_model = min(cfg.d_model, 256)
    changes["d_model"] = d_model
    if cfg.num_heads:
        heads = min(cfg.num_heads, 4)
        kv = max(1, min(cfg.num_kv_heads, heads, 2))
        changes["num_heads"] = heads
        changes["num_kv_heads"] = kv
        changes["head_dim"] = 64
    if cfg.d_ff:
        changes["d_ff"] = 512
    changes["vocab_size"] = min(cfg.vocab_size, 512)
    if cfg.num_experts:
        changes["num_experts"] = min(cfg.num_experts, 4)
        changes["num_shared_experts"] = min(cfg.num_shared_experts, 1)
        changes["top_k"] = min(cfg.top_k, 2)
        changes["moe_d_ff"] = 256
        changes["moe_capacity_factor"] = changes["num_experts"] / changes["top_k"]
    changes["first_dense_layers"] = min(cfg.first_dense_layers, 1 if cfg.num_layers > 1 else 0)
    if cfg.use_mla:
        changes["kv_lora_rank"] = 64
        changes["qk_nope_dim"] = 32
        changes["qk_rope_dim"] = 16
        changes["v_head_dim"] = 32
        changes["head_dim"] = 48
    if cfg.ssm_d_state:
        changes["ssm_d_state"] = min(cfg.ssm_d_state, 16)
        changes["ssm_head_dim"] = 32
        changes["ssm_chunk"] = 32
    if cfg.sliding_window:
        changes["sliding_window"] = 32
    if cfg.is_encoder_decoder:
        changes["num_encoder_layers"] = min(cfg.num_encoder_layers, 2)
    pat = cfg.layer_pattern
    if len(pat) > changes["num_layers"]:
        kinds = list(dict.fromkeys(pat))[: changes["num_layers"]]
        changes["layer_pattern"] = tuple(kinds) or ("attn",)
    changes["dtype"] = "float32"
    changes["param_dtype"] = "float32"
    return dataclasses.replace(cfg, **changes)
