"""SeamlessM4T-medium backbone — encoder-decoder, multimodal [arXiv:2308.11596].

Assigned: 12L d_model=1024 16H (GQA kv=16 = MHA) d_ff=4096 vocab=256206.
Backbone only: 12 encoder + 12 decoder layers with cross-attention. The speech
frontend (mel-spectrogram + conv feature extractor) is a STUB per the brief —
``input_specs()`` supplies precomputed frame embeddings (B, T_frames, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=12,  # decoder layers
    num_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    norm="layernorm",
    input_mode="embeddings",  # encoder consumes precomputed audio frames
)
