"""ITQ3_S blockwise quantization — paper Algorithm 1 (port of
``repro/core/quantize.py``).

Per 256-element block ``w`` taken along the reduction dimension:

    w'  = FWHT(w)                               # rotation-domain smoothing
    d_k = alpha * std(w')                       # rounded through fp16
    z_k = -round(mean(w') / d_k)                # integer zero-point
    q   = clamp(round(w'/d_k) + z_k, -1, 1)     # ternary codes
    store(pack3b(q + 1), d_k, z_k)              # planar 3-bit planes

Weights are ``(..., K, N)`` (``x @ W``); storage is output-major
``(..., N, KB, block)`` so one packed row is one output feature's stream.
``torch.round`` rounds half to even, as ``jnp.round`` does, so port and
reference codes agree except where the f32 statistics themselves differ in
the last bit at a rounding tie.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import grids, packing
from repro_torch.core.fwht import fwht

__all__ = [
    "QMeta", "QTensor", "quantize_blocks_ternary", "dequantize_blocks_ternary",
    "pad_reduction_dim", "pad_last_dim", "to_blocks", "from_blocks",
    "decode_values", "decode_wint", "ternary_levels", "pack_ternary_codes",
    "DEFAULT_BLOCK",
]

DEFAULT_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class QMeta:
    """Static metadata for a quantized tensor (same fields and JSON form as
    the reference's ``QMeta``, so ``to_dict`` output crosses over)."""

    fmt: str
    shape: tuple[int, ...]  # original (unpadded) shape (..., K, N)
    block: int
    rule: str = "paper"
    rotate: bool = True
    sub_blocks: int = 0  # 0 = single block scale; 8 = sub-block variant
    fivelevel: bool = False
    bits_per_weight: float = 3.125
    act_quant: bool = True  # W3A8 eligibility (QuantRule can opt out)

    @property
    def k(self) -> int:
        return self.shape[-2]

    @property
    def n(self) -> int:
        return self.shape[-1]

    @property
    def k_padded(self) -> int:
        return -(-self.k // self.block) * self.block

    @property
    def kb(self) -> int:
        return self.k_padded // self.block

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["shape"] = list(d["shape"])
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "QMeta":
        d = dict(d)
        d["shape"] = tuple(d["shape"])
        return cls(**d)


@dataclasses.dataclass
class QTensor:
    """A quantized weight: packed tensors plus :class:`QMeta`.

    ``data`` for the ternary family:
      plane2  (..., N, KB, block//4) uint8   2-bit payload plane
      plane1  (..., N, KB, block//8) uint8   1-bit selector plane
      scales  (..., N, KB) f16 — or (..., N, KB, sub) for the sub variant
      zps     (..., N, KB) f16 (integer-valued)
      dsign   (block,) int8 — only for quip3 (random sign diagonal)

    Stacked layer leaves carry a leading L axis on every array (``dsign``
    too, as the reference's vmapped quantizer emits it); :meth:`layer`
    takes one layer's view."""

    data: dict[str, torch.Tensor]
    meta: QMeta

    @property
    def fmt(self) -> str:
        return self.meta.fmt

    @property
    def shape(self) -> tuple[int, ...]:
        return self.meta.shape

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values())).device

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def layer(self, i: int) -> "QTensor":
        """Layer ``i`` of a stacked leaf (views, no copy)."""
        return QTensor({k: (v if k == "dsign" and v.dim() == 1 else v[i])
                        for k, v in self.data.items()}, self.meta)

    def first_layers(self, n: int) -> "QTensor":
        """The first ``n`` layers of a stacked leaf (views, no copy); a 1-D
        ``dsign`` is shared by every layer and kept whole."""
        return QTensor({k: (v if k == "dsign" and v.dim() == 1 else v[:n])
                        for k, v in self.data.items()}, self.meta)


# ---------------------------------------------------------------------------
# Shape plumbing: (..., K, N) <-> output-major blocks (..., N, KB, block)
# ---------------------------------------------------------------------------

def pad_reduction_dim(w: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad axis -2 (the reduction dim K) to a multiple of ``block``."""
    pad = (-w.shape[-2]) % block
    if pad == 0:
        return w
    return torch.nn.functional.pad(w, (0, 0, 0, pad))


def pad_last_dim(x: torch.Tensor, to: int) -> torch.Tensor:
    """Zero-pad the last axis to a multiple of ``to`` (activation side)."""
    pad = (-x.shape[-1]) % to
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, pad))


def to_blocks(w: torch.Tensor, block: int) -> torch.Tensor:
    """(..., K, N) -> (..., N, KB, block); pads K as needed."""
    w = pad_reduction_dim(w, block)
    *lead, kp, n = w.shape
    w = w.reshape(*lead, kp // block, block, n)
    return torch.movedim(w, -1, -3)


def from_blocks(wb: torch.Tensor, k_orig: int) -> torch.Tensor:
    """(..., N, KB, block) -> (..., K, N), trimming the K padding."""
    *lead, n, kb, block = wb.shape
    w = torch.movedim(wb, -3, -1).reshape(*lead, kb * block, n)
    return w[..., :k_orig, :]


# ---------------------------------------------------------------------------
# Block-level ternary quantization (Algorithm 1) and its inverse
# ---------------------------------------------------------------------------

def _std(x: torch.Tensor) -> torch.Tensor:
    """Population std over the last axis (``jnp.std``'s ddof=0)."""
    mu = x.mean(dim=-1, keepdim=True)
    return torch.sqrt(((x - mu) ** 2).mean(dim=-1))


def _to_f16_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(torch.float32)


def ternary_levels(wb: torch.Tensor, *, alpha: float, sub_blocks: int = 0,
                   fivelevel: bool = False):
    """Algorithm 1's statistics and codes on already rotated f32 blocks
    ``wb (..., block)``: returns the grid values ``q`` (f32, in {-1, 0, 1},
    or {-2..2} with ``fivelevel``), the scales (f32 rounded through f16;
    ``(..., sub_blocks)`` for the sub-block variant) and the zero-points."""
    block = wb.shape[-1]
    if sub_blocks:
        sub = wb.reshape(*wb.shape[:-1], sub_blocks, block // sub_blocks)
        d_sub = _to_f16_f32(alpha * _std(sub))  # (..., sub)
        zp = torch.zeros_like(d_sub.mean(dim=-1))  # symmetric: z absorbed
        scales = d_sub
        d_for_codes = torch.repeat_interleave(d_sub, block // sub_blocks,
                                              dim=-1)
        z_for_codes = 0.0
    else:
        d_block = _to_f16_f32(alpha * _std(wb))
        mu = wb.mean(dim=-1)
        safe_d = torch.where(d_block > 0, d_block, torch.ones_like(d_block))
        zmax = 2.0 if fivelevel else 1.0
        zp = torch.clamp(-torch.round(mu / safe_d), -zmax, zmax)
        scales = d_block
        d_for_codes = d_block[..., None]
        z_for_codes = zp[..., None]

    safe_d = torch.where(d_for_codes > 0, d_for_codes,
                         torch.ones_like(d_for_codes))
    qmax = 2.0 if fivelevel else 1.0
    q = torch.clamp(torch.round(wb / safe_d) + z_for_codes, -qmax, qmax)
    return q, scales, zp


def pack_ternary_codes(codes: torch.Tensor):
    """Three-level codes ``(..., block)`` uint8 in {0, 1, 2} -> ``(plane2,
    plane1)``. The selector plane carries the interleave parity bit (paper
    Eq. 9's high nibble bit): informational, NOT zero — a decoder must not
    read it as a five-level escape."""
    parity = (torch.arange(codes.shape[-1], device=codes.device) & 1
              ).to(torch.uint8)
    return packing.pack_codes(codes | (parity << 2))


def quantize_blocks_ternary(
    wb: torch.Tensor,
    *,
    rotate: bool = True,
    rule: str = "paper",
    sub_blocks: int = 0,
    fivelevel: bool = False,
    dsign: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Quantize blocks ``wb`` (..., block) -> packed planes + scales + zps.

    Algorithm 1 for the defaults; ``rotate=False`` is the IQ3_S baseline,
    ``sub_blocks=8`` the sub-block-scale variant, ``fivelevel=True`` the
    five-level escape grid."""
    wb = wb.to(torch.float32)
    if rotate:
        if dsign is not None:
            wb = wb * dsign.to(wb.dtype)
        wb = fwht(wb)
    alpha = grids.fivelevel_alpha() if fivelevel else grids.SCALE_RULES[rule]
    q, scales, zp = ternary_levels(wb, alpha=alpha, sub_blocks=sub_blocks,
                                   fivelevel=fivelevel)
    if fivelevel:
        q = q.to(torch.int8)
        payload = (torch.clamp(q, -1, 1) + 1).to(torch.uint8)
        sel = (q.abs() == 2).to(torch.uint8)
        plane2, plane1 = packing.pack_codes(payload | (sel << 2))
    else:
        plane2, plane1 = pack_ternary_codes((q + 1).to(torch.uint8))
    out = {"plane2": plane2, "plane1": plane1,
           "scales": scales.to(torch.float16), "zps": zp.to(torch.float16)}
    if dsign is not None:
        out["dsign"] = dsign.to(torch.int8)
    # the blocks arrive as a permuted view of (..., K, N) and elementwise
    # results keep its strides; the kernels read row-major planes
    return {k: v.contiguous() for k, v in out.items()}


def decode_values(plane2: torch.Tensor, plane1: torch.Tensor, *,
                  fivelevel: bool = False) -> torch.Tensor:
    """Packed planes -> int8 grid values (..., block): {-1,0,1}, or
    {-2..2} with the five-level escape."""
    codes3 = packing.unpack_codes(plane2, plane1)
    payload = (codes3 & 0x3).to(torch.int8) - 1
    if fivelevel:
        sel = ((codes3 >> 2) & 0x1).to(torch.int8)
        return payload * (1 + sel)
    return payload


def decode_wint(plane2: torch.Tensor, plane1: torch.Tensor,
                zps: torch.Tensor, *, fivelevel: bool = False,
                sub_blocks: int = 0) -> torch.Tensor:
    """Packed planes -> exact int8 ``wint = q - z`` (..., block). The
    zero-point is integer-valued, so the subtraction is exact; sub-block
    formats store z = 0."""
    qv = decode_values(plane2, plane1, fivelevel=fivelevel)
    if sub_blocks:
        return qv
    return qv - zps.to(torch.int8)[..., None]


def dequantize_blocks_ternary(
    data: dict[str, torch.Tensor],
    *,
    rotate: bool = True,
    sub_blocks: int = 0,
    fivelevel: bool = False,
    dtype=torch.float32,
) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks_ternary`: unpack, dequantize on the
    grid, inverse FWHT (self-inverse), undo the sign diagonal."""
    qv = decode_values(data["plane2"], data["plane1"],
                       fivelevel=fivelevel).to(torch.float32)
    block = qv.shape[-1]
    if sub_blocks:
        d_full = torch.repeat_interleave(data["scales"].to(torch.float32),
                                         block // sub_blocks, dim=-1)
        vals = d_full * qv
    else:
        d = data["scales"].to(torch.float32)[..., None]
        z = data["zps"].to(torch.float32)[..., None]
        vals = d * (qv - z)
    if rotate:
        vals = fwht(vals)
        dsign = data.get("dsign")
        if dsign is not None:
            vals = vals * dsign.to(vals.dtype)
    return vals.to(dtype)
