"""Blocked Fast Walsh-Hadamard Transform (port of ``repro/core/fwht.py``).

The normalized Walsh-Hadamard matrix H_n is symmetric and involutory
(H @ H = I), so one transform is both the forward rotation and its inverse.
``fwht`` is the O(n log n) butterfly with the same stage order as the
reference (h = 1, 2, 4, ...), so on the CPU it agrees with the reference to
float rounding. ``hadamard_matrix`` is the explicit H_n, used only as the
yardstick product ``x @ H`` that ``chip_smoke.py`` times beside the kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fwht", "blocked_fwht", "hadamard_matrix", "is_pow2"]


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def hadamard_matrix(n: int, *, device="cuda", dtype=torch.float32,
                    normalized: bool = True) -> torch.Tensor:
    """Normalized (or raw +-1) Sylvester Hadamard matrix H_n."""
    if not is_pow2(n):
        raise ValueError(f"Hadamard size must be a power of two, got {n}")
    h = np.array([[1.0]], dtype=np.float64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    if normalized:
        h = h / np.sqrt(n)
    return torch.as_tensor(h, dtype=dtype, device=device)


def fwht(x: torch.Tensor, *, normalized: bool = True) -> torch.Tensor:
    """FWHT along the last axis (a power of two), batched over the rest.

    log2(n) butterfly stages of (u, v) -> (u + v, u - v), computed in f32
    at least. Self-inverse when ``normalized``."""
    n = x.shape[-1]
    if not is_pow2(n):
        raise ValueError(f"fwht requires power-of-two trailing dim, got {n}")
    orig_dtype = x.dtype
    x = x.to(torch.promote_types(orig_dtype, torch.float32))
    shape = x.shape
    h = 1
    while h < n:
        x = x.reshape(*shape[:-1], n // (2 * h), 2, h)
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    x = x.reshape(shape)
    if normalized:
        # the reference multiplies by the f32 rounding of 1/sqrt(n)
        x = x * float(np.float32(1.0 / math.sqrt(n)))
    return x.to(orig_dtype)


def blocked_fwht(x: torch.Tensor, block: int = 256, *,
                 normalized: bool = True) -> torch.Tensor:
    """Independent ``block``-point FWHT of each contiguous block of the
    trailing dimension, which must be divisible by ``block``."""
    n = x.shape[-1]
    if n % block != 0:
        raise ValueError(f"trailing dim {n} not divisible by block {block}")
    shape = x.shape
    x = fwht(x.reshape(*shape[:-1], n // block, block), normalized=normalized)
    return x.reshape(shape)
