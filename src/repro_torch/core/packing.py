"""ITQ3_S bit-plane packing (port of ``repro/core/packing.py``).

Storage per 256-element block is 96 bytes = 3 bits/weight, planar and
interleaved:

  * ``plane2`` — 64 bytes, the 2-bit payload: byte ``i`` holds elements
    ``{i, 64+i, 128+i, 192+i}`` in bit pairs (element ``c*64+i`` in bits
    ``2c..2c+1``).
  * ``plane1`` — 32 bytes, the 1-bit selector: byte ``i`` bit ``b`` holds
    element ``b*32+i``.

The CUDA kernels in ``csrc/`` decode exactly this layout; these functions
are the plain reference they are held against. All act on the trailing
axis and batch over the leading ones.
"""
from __future__ import annotations

import torch

__all__ = ["pack_plane2", "unpack_plane2", "pack_plane1", "unpack_plane1",
           "pack_codes", "unpack_codes"]


def pack_plane2(codes2: torch.Tensor) -> torch.Tensor:
    """2-bit values (trailing n, n % 4 == 0) -> n//4 interleaved bytes."""
    n = codes2.shape[-1]
    if n % 4 != 0:
        raise ValueError(f"plane2 pack needs trailing dim % 4 == 0, got {n}")
    c = codes2.to(torch.uint8).reshape(*codes2.shape[:-1], 4, n // 4)
    return c[..., 0, :] | (c[..., 1, :] << 2) | (c[..., 2, :] << 4) \
        | (c[..., 3, :] << 6)


def unpack_plane2(plane2: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_plane2`: n//4 bytes -> n 2-bit values."""
    p = plane2.to(torch.uint8)
    out = torch.stack([(p >> (2 * k)) & 0x3 for k in range(4)], dim=-2)
    return out.reshape(*plane2.shape[:-1], plane2.shape[-1] * 4)


def pack_plane1(codes1: torch.Tensor) -> torch.Tensor:
    """1-bit values (trailing n, n % 8 == 0) -> n//8 bytes, stride n//8."""
    n = codes1.shape[-1]
    if n % 8 != 0:
        raise ValueError(f"plane1 pack needs trailing dim % 8 == 0, got {n}")
    c = codes1.to(torch.uint8).reshape(*codes1.shape[:-1], 8, n // 8)
    out = c[..., 0, :]
    for k in range(1, 8):
        out = out | (c[..., k, :] << k)
    return out


def unpack_plane1(plane1: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_plane1`."""
    p = plane1.to(torch.uint8)
    out = torch.stack([(p >> k) & 0x1 for k in range(8)], dim=-2)
    return out.reshape(*plane1.shape[:-1], plane1.shape[-1] * 8)


def pack_codes(codes3: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3-bit codes (0..7) -> ``(plane2, plane1)``."""
    return pack_plane2(codes3 & 0x3), pack_plane1((codes3 >> 2) & 0x1)


def unpack_codes(plane2: torch.Tensor, plane1: torch.Tensor) -> torch.Tensor:
    """Reassemble 3-bit codes from the two planes."""
    return (unpack_plane2(plane2) | (unpack_plane1(plane1) << 2)).to(
        torch.uint8)
