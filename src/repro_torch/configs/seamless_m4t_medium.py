"""SeamlessM4T-medium [arXiv:2308.11596; hf]: encoder-decoder, multimodal.

12L encoder + 12L decoder, d_model 1024, 16H MHA, d_ff 4096, vocab 256206.
Audio frontend stubbed: the model takes precomputed speech frame
embeddings, which the encoder reads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    activation="gelu",
    encoder_layers=12,
    is_encoder_decoder=True,
    frontend="audio",
    frontend_dim=160,   # fbank-ish frame features
    frontend_len=1024,  # speech frames per utterance (stub)
    tie_embeddings=True,
)
