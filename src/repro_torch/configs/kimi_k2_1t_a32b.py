"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2] (assigned spec).

Assigned: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8.
We follow the assigned GQA spec exactly (head_dim = 7168/64 = 112); the released
K2 additionally uses MLA and 1 shared expert — not part of the assigned line, so
omitted here, as in the JAX package's config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,  # expert FFN width (assigned d_ff applies to experts)
    vocab_size=163_840,
    num_experts=384,
    top_k=8,
    moe_d_ff=2048,
    moe_layer_period=1,
    rope_theta=50_000.0,
)
