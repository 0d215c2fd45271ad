"""Offline Algorithm 1 kernel wrapper (kernel 7, ``csrc/quantize_blocks.cu``).

Replaces ``repro/kernels/quantize_kernel.py:quantize_blocks_pallas``: per
256-element block, rotate (normalized FWHT), take the mean and then the
population std of the rotated block, ``d = f16(alpha * sigma)``,
``z = clip(-round(mu / d), -1, 1)`` and the codes
``clip(round(w' / d) + z, -1, 1) + 1``, rounding half to even. It computes
exactly the TPU kernel's case: rotated, one scale per block, three levels,
no sign diagonal (``itq3_s``); ``TernaryFormat.quantize`` packs its codes
into planes with ``core/packing.py``. The plain version is
:func:`quantize_blocks_ref`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import grids
from repro_torch.core.fwht import fwht
from repro_torch.core.quantize import ternary_levels
from repro_torch.kernels import _build

__all__ = ["quantize_blocks", "quantize_blocks_ref", "BLOCK"]

BLOCK = 256

_SIG = {"quantize_blocks_launch": (ctypes.c_void_p,) * 4
        + (ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p)}


def _alpha(rule: str) -> float:
    try:
        return float(np.float32(grids.SCALE_RULES[rule]))
    except KeyError:
        raise ValueError(f"unknown scale rule {rule!r}; options "
                         f"{sorted(grids.SCALE_RULES)}") from None


def quantize_blocks_ref(wb: torch.Tensor, *, rule: str = "paper"):
    """Plain version: the plain butterfly, then the block branch of the
    plain Algorithm 1 (:func:`~repro_torch.core.quantize.ternary_levels`).
    Returns ``(codes (NB, 256) uint8 in {0, 1, 2}, d (NB,) f16,
    z (NB,) f16)``."""
    q, d, z = ternary_levels(fwht(wb.to(torch.float32)), alpha=_alpha(rule))
    return (q + 1.0).to(torch.uint8), d.to(torch.float16), z.to(torch.float16)


def quantize_blocks(wb: torch.Tensor, *, rule: str = "paper"):
    """Algorithm 1 over ``wb (NB, 256)`` f32 blocks, all in one launch."""
    if wb.dim() != 2 or wb.shape[1] != BLOCK:
        raise ValueError(f"quantize_blocks expects (NB, {BLOCK}) blocks, got "
                         f"{tuple(wb.shape)}")
    _build.check_operands("quantize_blocks", wb.device,
                          ((wb, torch.float32),))
    if wb.device.type == "cpu":
        return quantize_blocks_ref(wb, rule=rule)
    if not wb.is_cuda:
        raise ValueError(f"quantize_blocks: unsupported device {wb.device}")
    alpha = _alpha(rule)
    nb = wb.shape[0]
    codes = torch.empty((nb, BLOCK), dtype=torch.uint8, device=wb.device)
    d = torch.empty((nb,), dtype=torch.float16, device=wb.device)
    z = torch.empty((nb,), dtype=torch.float16, device=wb.device)
    if nb:
        lib = _build.library("quantize_blocks", _SIG)
        _build.check(lib.quantize_blocks_launch(
            wb.data_ptr(), codes.data_ptr(), d.data_ptr(), z.data_ptr(), nb,
            alpha, _build.stream_of(wb)), "quantize_blocks")
        _build.launches["quantize_blocks"] += 1
    return codes, d, z
