"""Rotated int8 KV-cache codec (port of ``repro/serve/kv_quant.py``).

Each cached K/V vector (head_dim long) is rotated by H_head_dim and
quantized to int8 with a per-vector fp16 absmax scale. The scale is
clamped into fp16's finite normal range and the codes are rounded against
the value actually stored, so encode -> decode stays finite and
consistent at both magnitude extremes. ``torch.round`` rounds half to
even, as ``jnp.round`` does. The encoder's rotation goes through the FWHT
kernel (``kernels/fwht.py:fwht_last``) unless ``backend="ref"``; its bits
are the plain butterfly's either way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fwht import fwht, is_pow2
from repro_torch.kernels.fwht import fwht_last

__all__ = ["kv_encode", "kv_decode", "kv_scores", "F16_SCALE_MAX",
           "F16_SCALE_MIN"]

# Above fp16's max the cast gives inf (codes collapse to 0, decode 0*inf =
# NaN); below its smallest normal the stored scale flushes toward 0 while
# encode saturates against it. Clamp into the normal range.
F16_SCALE_MAX = float(np.finfo(np.float16).max)   # 65504
F16_SCALE_MIN = float(np.finfo(np.float16).tiny)  # 2^-14


def kv_encode(x: torch.Tensor, *, backend: str = "auto"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., HD) -> (int8 codes (..., HD), fp16 scales (..., 1))."""
    hd = x.shape[-1]
    if not is_pow2(hd):
        raise ValueError(f"head_dim {hd} must be a power of two")
    xr = fwht_last(x.to(torch.float32), backend=backend)
    amax = torch.amax(torch.abs(xr), dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, F16_SCALE_MIN,
                        F16_SCALE_MAX).to(torch.float16)
    safe = scale.to(torch.float32)  # quantize by the stored value
    q = torch.clamp(torch.round(xr / safe), -127, 127).to(torch.int8)
    return q, scale


def kv_decode(q: torch.Tensor, scale: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """Dequantize and inverse-FWHT (self-inverse)."""
    return fwht(q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def kv_scores(q_rot: torch.Tensor, k_codes: torch.Tensor,
              k_scale: torch.Tensor) -> torch.Tensor:
    """Scores without dequantizing keys: q_rot (..., G, Tq, HD) rotated,
    k_codes (..., Tk, HD), k_scale (..., Tk, 1) -> (..., G, Tq, Tk)."""
    s = torch.einsum("...gqd,...td->...gqt", q_rot.to(torch.float32),
                     k_codes.to(torch.float32))
    scale = k_scale.to(torch.float32).transpose(-1, -2)  # (..., 1, Tk)
    return s * scale[..., None, :, :]
