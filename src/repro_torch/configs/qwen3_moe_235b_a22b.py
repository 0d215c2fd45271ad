"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf].

94L, d_model 4096, 64 heads (GQA kv=4, head_dim 128), per-expert d_ff 1536,
vocab 151936, 128 experts top-8 (22B active of 235B total).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
