"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b family; unverified].

32L, d_model 2560, 32H MHA, d_ff 6912, vocab 50304, LayerNorm,
partial rotary (25%).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    activation="swiglu",
    rotary_pct=0.25,
    tie_embeddings=False,
)
