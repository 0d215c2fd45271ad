"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf].

phi3-mini backbone (32L, d_model 3072, 32H MHA, d_ff 8192, vocab 32064)
+ CLIP vision frontend, stubbed: the model takes precomputed patch
embeddings (frontend_len x frontend_dim), projected into the token stream
by a learned linear. head_dim 96 is not a power of two, so it serves on
the fp cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    norm="rmsnorm",
    activation="swiglu",
    frontend="vision",
    frontend_dim=1024,   # CLIP-L/14 patch embedding width
    frontend_len=576,    # 24x24 patches
    tie_embeddings=False,
)
