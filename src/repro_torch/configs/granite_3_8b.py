"""IBM Granite 3.0 8B — dense GQA [hf:ibm-granite/granite-3.0-8b-base].

Assigned: 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-8b-base",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12_800,
    vocab_size=49_155,
    tie_embeddings=True,  # granite-3 ties embeddings
    rope_theta=10_000.0,
)
