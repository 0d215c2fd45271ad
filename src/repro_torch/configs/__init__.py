from repro_torch.configs.base import (
    ARCH_IDS, ModelConfig, get_config, kv_cache_bytes_per_token,
    mixed_precision_recipe, reduced,
)

__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "kv_cache_bytes_per_token",
           "mixed_precision_recipe", "reduced"]
