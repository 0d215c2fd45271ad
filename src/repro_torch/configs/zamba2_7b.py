"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 backbone + shared
attention blocks.

81 Mamba2 layers (d_model 3584, ssm_state 64, expand 2), with a single
SHARED full-attention block (32H MHA) applied before every 6th layer.
vocab 32000. head_dim 3584 / 32 = 112 is not a power of two, so at full
width the shared attention serves on the fp cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    norm="rmsnorm",
    activation="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    attn_every=6,
    tie_embeddings=True,
)
