"""Mamba2-2.7B — SSD (state-space duality) [arXiv:2405.21060].

Assigned: 64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
Mamba2 block params: expand=2 (d_inner=5120), headdim=64 (80 ssm heads),
ngroups=1, conv width 4, SSD chunk 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=("ssd",),
    ssm_d_state=128,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)
