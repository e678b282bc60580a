"""Chameleon 34B — early-fusion mixed-modal, VQ image tokens [arXiv:2405.09818].

Assigned: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion: image patches are VQ-quantized into discrete tokens sharing the
65536 vocab, so the frontend STUB is simply token ids (the VQ-GAN tokenizer is
out of scope per the brief). Uses qk-norm as in the paper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=65_536,
    qk_norm=True,
    norm="rmsnorm",
)
