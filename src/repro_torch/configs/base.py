"""Model configuration for the port (copy of ``repro/configs/base.py``).

Every model of the reference is registered, in its six families: the
dense ``smollm-135m``, ``qwen1.5-0.5b`` (RMSNorm, swiglu, tied),
``nemotron-4-15b`` (LayerNorm, relu2, untied) and ``stablelm-3b``
(LayerNorm, partial rotary, untied), the MoE ``olmoe-1b-7b`` and
``qwen3-moe-235b-a22b``, the attention-free RWKV6 ``rwkv6-3b`` (family
``ssm``), the Mamba2 + shared-attention ``zamba2-7b`` (``hybrid``), the
vision-language ``phi-3-vision-4.2b`` (``vlm``: projected patch
embeddings prefixed to the tokens) and the encoder-decoder
``seamless-m4t-medium`` (``audio``: a non-causal encoder over projected
frames, cross-attended by every decoder layer).
``reduced()`` gives the same topology at CPU-test size, exactly as the
reference does, so a reduced config built here equals the reference's
field for field.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ModelConfig", "get_config", "reduced", "ARCH_IDS",
           "kv_cache_bytes_per_token", "mixed_precision_recipe"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | gelu | relu2
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: shared attention block period (zamba2)
    # --- enc-dec ---
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # --- modality frontend (precomputed features, projected) ---
    frontend: Optional[str] = None  # "vision" | "audio"
    frontend_dim: int = 0  # patch / frame embedding width
    frontend_len: int = 0  # patches / frames per input
    tie_embeddings: bool = True
    eos_token_id: Optional[int] = None  # engine finishes a request on this

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.attn_every == 0


ARCH_IDS = ["qwen3-moe-235b-a22b", "olmoe-1b-7b", "rwkv6-3b",
            "phi-3-vision-4.2b", "seamless-m4t-medium", "qwen1.5-0.5b",
            "nemotron-4-15b", "smollm-135m", "stablelm-3b", "zamba2-7b"]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; the port serves {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def mixed_precision_recipe(cfg: ModelConfig, *, head_fmt: str = "q8_0",
                           mlp_fmt: str = "itq3_s_sub",
                           rest_fmt: str = "itq3_s") -> dict:
    """Default mixed-precision serving recipe for ``cfg``, as a
    :class:`~repro_torch.serve.quantized.QuantPolicy` dict (JSON-safe):

      * the LM head at 8-bit; tied-embedding models project through
        ``embed.T``, so the head rule targets the table there instead,
      * MLP and expert projections at the sub-block-scale ternary variant,
      * every other matmul projection at plain ITQ3_S,
      * the MoE router, norms and biases fp via the policy's no-match
        default.
    """
    from repro_torch.serve.quantized import MATMUL_LEAVES  # leaf vocabulary

    head_pattern = r"(^|\.)embed$" if cfg.tie_embeddings else r"(^|\.)lm_head$"
    return {"rules": [
        {"pattern": head_pattern, "fmt": head_fmt},
        {"pattern": r"(^|\.)(gate|up|down)$", "fmt": mlp_fmt},
        {"pattern": MATMUL_LEAVES, "fmt": rest_fmt},
    ]}


def kv_cache_bytes_per_token(cfg: ModelConfig, *, kv_quant: bool = False,
                             fp_bytes: int = 2) -> int:
    """Attention KV-cache bytes per cached token position across all
    attention layers: 2 planes (K, V) x num_kv_heads x per-vector bytes,
    where the rotated-int8 layout stores head_dim int8 codes plus one fp16
    scale. SSM families cache O(1) state, not per-token KV: 0; the hybrid
    has ``ceil(L / attn_every)`` attention layers."""
    if cfg.family == "ssm":
        return 0
    n_attn = cfg.num_layers
    if cfg.family == "hybrid":
        n_attn = -(-cfg.num_layers // cfg.attn_every)
    hd = cfg.resolved_head_dim
    per_vector = (hd + 2) if kv_quant else hd * fp_bytes
    return 2 * n_attn * cfg.num_kv_heads * per_vector


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-topology config for CPU tests: 4 layers (7 for a hybrid,
    so a tail follows its macroblocks), d_model 128, 4 heads at head_dim
    32, the GQA ratio preserved; at most 8 experts and top-2 routing; an
    SSM state of at most 16 and a shared-attention period of at most 3;
    at most 2 encoder layers, and a frontend of 8 features of width 64."""
    kv_ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    heads = 4
    return dataclasses.replace(
        cfg,
        num_layers=min(cfg.num_layers, 4 if cfg.attn_every == 0 else 7),
        d_model=128,
        num_heads=heads,
        num_kv_heads=max(1, heads // kv_ratio),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2)
        if cfg.num_experts else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        attn_every=min(cfg.attn_every, 3) if cfg.attn_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_dim=64 if cfg.frontend else 0,
        frontend_len=8 if cfg.frontend else 0,
    )
