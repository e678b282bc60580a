"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE [arXiv:2405.04434].

Assigned: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
"MoE 64e top-6 — MLA kv_lora=512, 2 shared+160 routed top-6".
NOTE: the assigned line lists both "64e" and "160 routed"; the released
V2-Lite has 64 routed experts (V2-full has 160). We follow 64 routed +
2 shared, top-6, expert d_ff=1408, MLA kv_lora_rank=512 (qk_nope=128,
qk_rope=64, v=128), first layer dense (d_ff=10944, per model card).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: per-head latent, kv heads == q heads post-expansion
    head_dim=192,  # qk_nope (128) + qk_rope (64)
    d_ff=10_944,  # dense layers (layer 0)
    vocab_size=102_400,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    moe_layer_period=1,
    first_dense_layers=1,
)
