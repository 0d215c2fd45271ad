"""RWKV6 "Finch" 3B [arXiv:2404.05892; hf] — attention-free, data-dependent
decay. 32L, d_model 2560 (40 heads of 64), channel-mix d_ff 8960, vocab 65536.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,       # d_model / 64
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    norm="layernorm",
    activation="relu2",  # rwkv channel-mix uses relu^2
    tie_embeddings=False,
)
