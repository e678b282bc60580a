"""Gemma 2 2B — local+global alternating attention, logit softcap [arXiv:2408.00118].

Assigned: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
head_dim=256; sliding window 4096 on local layers; attn softcap 50, final
logit softcap 30; pre+post block RMSNorm; tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=("local", "global"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_block_norm=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
