"""Rotation-domain activation codec, the W3A8 online half (port of
``repro/core/act_quant.py``).

The weights are ternary codes of the rotated tensor, ``W_hat = H (d (q -
z))`` per 256-block, and H is symmetric and involutory, so each block
contributes ``x_b . W_hat_b = (H x_b) . (d (q - z))_b``. This module
quantizes ``H x`` to int8 with one absmax scale per row, so the contraction
against the integer weights ``wint = q - z`` (exact in int8: the stored
zero-point is integer-valued) runs as int8 x int8 -> int32 MACs:

    y[m, n] = s_m * sum_b d_{n,b} * ( xq[m, b] . wint[n, b] )

The block scale ``d`` lands on each block's int32 partial and the row
scale ``s_m`` once at the end (``kernels/itq3.py``). All-zero (or
padding-only) rows get scale 1.0 for the division, 0.0 stored and all-zero
codes, never a 0/0 NaN. ``torch.round`` rounds half to even, as
``jnp.round`` does.

Both codec scales, this one and the KV cache's (:func:`kv_quantize`,
``serve/kv_quant.py``), are ``amax * ACT_RECIP``, the f32 reciprocal of
127, as the jitted reference computes them: XLA rewrites ``amax / 127`` as
a multiply by the f32 reciprocal, which rounds differently from a true
division in about one row of twenty. The product of two f32 values is
rounded once on either device, so the CPU and the card give the same
scale, and the fused kernels of ``csrc/fwht.cu`` reproduce it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fwht import blocked_fwht

__all__ = ["ACT_QMAX", "ACT_RECIP", "F16_SCALE_MAX", "F16_SCALE_MIN",
           "act_encode", "act_decode", "kv_quantize"]

ACT_QMAX = 127.0  # symmetric int8 grid
# fl32(1 / 127), exact as a Python float: ``t * ACT_RECIP`` on an f32
# tensor is one f32 multiply, rounded once
ACT_RECIP = float(np.float32(1) / np.float32(ACT_QMAX))

# The KV codec stores its scale in fp16. Above fp16's max the cast gives
# inf (codes collapse to 0, decode 0*inf = NaN); below its smallest normal
# the stored scale flushes toward 0 while encode saturates against it.
# Clamp into the normal range.
F16_SCALE_MAX = float(np.finfo(np.float16).max)   # 65504
F16_SCALE_MIN = float(np.finfo(np.float16).tiny)  # 2^-14


def act_encode(x: torch.Tensor, *, block: int = 256, rotate: bool = True,
               dsign: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate and int8-quantize activations ``x (..., K_pad)``, K_pad a
    multiple of ``block`` (callers pad first). Returns int8 codes of the
    same shape and one f32 absmax scale per row ``(..., 1)``. ``dsign``
    (quip3) is applied before the rotation. The scale is ``amax *
    ACT_RECIP``, as the jitted reference: XLA multiplies by the f32
    reciprocal. The kernel path runs this codec in one launch
    (``kernels/fwht.py:fwht_act_encode``), with the same bits."""
    xf = x.to(torch.float32)
    if rotate:
        if dsign is not None:
            *lead, k = xf.shape
            xf = (xf.reshape(*lead, k // block, block)
                  * dsign.to(torch.float32)).reshape(*lead, k)
        xf = blocked_fwht(xf, block)
    amax = torch.amax(xf.abs(), dim=-1, keepdim=True)
    nonzero = amax > 0
    step = amax * ACT_RECIP
    safe = torch.where(nonzero, step, torch.ones_like(step))
    codes = torch.clamp(torch.round(xf / safe), -ACT_QMAX, ACT_QMAX).to(
        torch.int8)
    scale = torch.where(nonzero, step, torch.zeros_like(step))
    return codes, scale


def kv_quantize(xr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The KV codec after its head_dim rotation: ``xr (..., HD)`` f32 ->
    (int8 codes (..., HD), fp16 scales (..., 1)). The scale is ``amax *
    ACT_RECIP`` clamped into fp16's normal range, as the jitted reference:
    XLA multiplies by the f32 reciprocal. The codes are rounded against the
    stored fp16 value, so encode -> decode stays finite and consistent at
    both magnitude extremes."""
    amax = torch.amax(torch.abs(xr), dim=-1, keepdim=True)
    scale = torch.clamp(amax * ACT_RECIP, F16_SCALE_MIN,
                        F16_SCALE_MAX).to(torch.float16)
    safe = scale.to(torch.float32)  # quantize by the stored value
    q = torch.clamp(torch.round(xr / safe), -127, 127).to(torch.int8)
    return q, scale


def act_decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Rotation-domain reconstruction ``H x ~= scale * codes`` (f32)."""
    return codes.to(torch.float32) * scale.to(torch.float32)
