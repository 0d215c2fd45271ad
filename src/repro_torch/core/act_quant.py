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
"""
from __future__ import annotations

import torch

from repro_torch.core.fwht import blocked_fwht

__all__ = ["ACT_QMAX", "act_encode", "act_decode"]

ACT_QMAX = 127.0  # symmetric int8 grid


def act_encode(x: torch.Tensor, *, block: int = 256, rotate: bool = True,
               dsign: torch.Tensor | None = None, fwht_fn=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate and int8-quantize activations ``x (..., K_pad)``, K_pad a
    multiple of ``block`` (callers pad first). Returns int8 codes of the
    same shape and one f32 absmax scale per row ``(..., 1)``. ``dsign``
    (quip3) is applied before the rotation; ``fwht_fn(x, block)`` lets the
    kernel path rotate with the FWHT kernel (default: the plain butterfly,
    the same arithmetic)."""
    xf = x.to(torch.float32)
    if rotate:
        if dsign is not None:
            *lead, k = xf.shape
            xf = (xf.reshape(*lead, k // block, block)
                  * dsign.to(torch.float32)).reshape(*lead, k)
        fn = fwht_fn if fwht_fn is not None else blocked_fwht
        xf = fn(xf, block)
    amax = torch.amax(xf.abs(), dim=-1, keepdim=True)
    nonzero = amax > 0
    step = amax / ACT_QMAX
    safe = torch.where(nonzero, step, torch.ones_like(step))
    codes = torch.clamp(torch.round(xf / safe), -ACT_QMAX, ACT_QMAX).to(
        torch.int8)
    scale = torch.where(nonzero, step, torch.zeros_like(step))
    return codes, scale


def act_decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Rotation-domain reconstruction ``H x ~= scale * codes`` (f32)."""
    return codes.to(torch.float32) * scale.to(torch.float32)
