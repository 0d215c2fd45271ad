"""Blocked FWHT kernel wrapper (kernel 1, ``csrc/fwht.cu``).

Replaces ``repro/kernels/fwht_kernel.py:fwht_pallas``. On the serving path
it rotates the activations before every quantized projection
(activations mode). ``block`` takes any power of two from 32 to 256, so the
per-head FWHTs of the KV codec can move onto it later.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core.fwht import blocked_fwht, is_pow2
from repro_torch.kernels import _build

__all__ = ["fwht", "fwht_ref"]

_SIG = {"fwht_launch": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_float, ctypes.c_void_p)}


def fwht_ref(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Plain version: the butterfly of ``core.fwht`` over each block."""
    return blocked_fwht(x.to(torch.float32), block=block)


def fwht(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Normalized blockwise FWHT of a 2-D ``(M, K)`` f32 tensor, K a
    multiple of ``block``. Self-inverse."""
    if x.dim() != 2:
        raise ValueError(f"fwht expects a 2-D (M, K) tensor, got {tuple(x.shape)}")
    m, k = x.shape
    if not is_pow2(block) or not 32 <= block <= 256 or k % block:
        raise ValueError(f"K={k} must be a multiple of a pow2 block in "
                         f"[32, 256], got block={block}")
    _build.check_operands("fwht", x.device, ((x, torch.float32),))
    if x.device.type == "cpu":
        return fwht_ref(x, block)
    if not x.is_cuda:
        raise ValueError(f"fwht: unsupported device {x.device}")
    y = torch.empty_like(x)
    nvec = m * k // block
    if nvec:
        lib = _build.library("fwht", _SIG)
        scale = float(np.float32(1.0 / math.sqrt(block)))
        _build.check(lib.fwht_launch(x.data_ptr(), y.data_ptr(), nvec, block,
                                     scale, _build.stream_of(x)), "fwht")
        _build.launches["fwht"] += 1
    return y
