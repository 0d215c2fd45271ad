"""Blocked FWHT kernel wrapper (kernel 1, ``csrc/fwht.cu``).

Replaces ``repro/kernels/fwht_kernel.py:fwht_pallas``. ``block`` takes any
power of two from 2 to 1024. On the serving path it rotates the
activations of every prefill projection and of every W3A8 projection at
256 points (a float decode projection rotates inside ``itq3_matvec``), and
through :func:`fwht_last` it runs the per-head FWHTs at head_dim points:
the KV codec's, and the attention's query and output rotations. Each
launch counts under ``fwht/<block>``, so a run can tell the two apart.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core.fwht import blocked_fwht
from repro_torch.core.fwht import fwht as plain_fwht
from repro_torch.kernels import _build

__all__ = ["fwht", "fwht_ref", "fwht_last", "FWHT_BLOCKS"]

FWHT_BLOCKS = tuple(2 ** i for i in range(1, 11))  # 2 .. 1024
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
    if block not in FWHT_BLOCKS or k % block:
        raise ValueError(f"K={k} must be a multiple of a pow2 block in "
                         f"[2, 1024], got block={block}")
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
        _build.launches[f"fwht/{block}"] += 1
    return y


def fwht_last(x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """Normalized FWHT along the last axis (a power of two from 2 to 1024)
    of an f32 ``(..., HD)`` tensor: the per-head rotation. ``backend="ref"``
    runs ``core.fwht``'s plain butterfly and nothing of this wrapper;
    otherwise :func:`fwht` at ``block = HD`` (its plain version on a CPU
    tensor, the kernel on a CUDA one), whose bits are the same."""
    if backend not in ("auto", "ref", "cuda"):
        raise ValueError(f"backend {backend!r} not in ('auto', 'ref', 'cuda')")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    if backend == "ref":
        return plain_fwht(x)
    hd = x.shape[-1]
    return fwht(x.reshape(-1, hd).contiguous(), block=hd).reshape(x.shape)
