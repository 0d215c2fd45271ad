"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small.

30L, d_model 576, 9H (GQA kv=3), d_ff 1536, vocab 49152. d_model 576 is
not a multiple of 256, so every projection reading the residual stream
runs the ITQ3_S pad-to-block path.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    norm="rmsnorm",
    activation="swiglu",
    tie_embeddings=True,
)
