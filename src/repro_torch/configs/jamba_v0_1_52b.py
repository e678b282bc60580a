"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887].

Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Structure per paper: 4 blocks x 8 layers, attention at in-block index 4
(ratio 1:7), MoE replaces the MLP every other layer (offset 1). Mamba1-style
mixer: d_state=16, conv=4, expand=2.
"""
from repro_torch.configs.base import ModelConfig

# period-8 mixer pattern: mamba x4, attn, mamba x3
_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    layer_pattern=_PATTERN,
    num_experts=16,
    top_k=2,
    moe_d_ff=14_336,
    moe_layer_period=2,
    moe_layer_offset=1,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
)
