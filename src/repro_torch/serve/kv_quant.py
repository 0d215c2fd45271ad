"""Rotated int8 KV-cache codec (port of ``repro/serve/kv_quant.py``).

Each cached K/V vector (head_dim long) is rotated by H_head_dim and
quantized to int8 with a per-vector fp16 absmax scale
(``core/act_quant.py:kv_quantize``: ``amax * ACT_RECIP``, as the jitted
reference, clamped into fp16's finite normal range, the codes rounded
against the value actually stored). ``torch.round`` rounds half to even,
as ``jnp.round`` does. A layer's K and V go through
:func:`kv_encode_pair`: one launch of the fused rotate-and-encode kernel
for both (``kernels/fwht.py:fwht_kv_encode``) on CUDA tensors.
:func:`kv_encode` encodes one tensor with its rotation on the FWHT kernel
(``kernels/fwht.py:fwht_last``). With ``backend="ref"`` both run the plain
butterfly and the plain ops; their bits are the same every way.
"""
from __future__ import annotations

import torch

from repro_torch.core.act_quant import (
    F16_SCALE_MAX, F16_SCALE_MIN, kv_quantize,
)
from repro_torch.core.fwht import fwht, is_pow2
from repro_torch.kernels.fwht import fwht_kv_encode, fwht_last

__all__ = ["kv_encode", "kv_encode_pair", "kv_decode", "kv_scores",
           "F16_SCALE_MAX", "F16_SCALE_MIN"]


def kv_encode(x: torch.Tensor, *, backend: str = "auto"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., HD) -> (int8 codes (..., HD), fp16 scales (..., 1))."""
    hd = x.shape[-1]
    if not is_pow2(hd):
        raise ValueError(f"head_dim {hd} must be a power of two")
    return kv_quantize(fwht_last(x.to(torch.float32), backend=backend))


def kv_encode_pair(k: torch.Tensor, v: torch.Tensor, *,
                   backend: str = "auto"):
    """Encode one layer's K and V, f32 ``(B, KV, T, HD)`` each, as
    :func:`kv_encode` does: ``((k_codes, k_scales), (v_codes,
    v_scales))``. ``backend="ref"`` is two :func:`kv_encode` calls on the
    plain butterfly; otherwise :func:`~repro_torch.kernels.fwht.
    fwht_kv_encode`, one launch for both on CUDA tensors (its plain version
    on CPU ones), with the same bits."""
    if backend not in ("auto", "ref", "cuda"):
        raise ValueError(f"backend {backend!r} not in ('auto', 'ref', 'cuda')")
    if backend == "cuda" and not k.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    if backend == "ref":
        return kv_encode(k, backend="ref"), kv_encode(v, backend="ref")
    return fwht_kv_encode(k, v)


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
