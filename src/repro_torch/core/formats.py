"""Pluggable quantization-format registry (port of ``repro/core/formats.py``).

  fp16 / bf16    identity casts
  q8_0           GGUF-style: 32-element blocks, int8 absmax, fp16 scale
  q4_0           GGUF-style: 32-element blocks, int4 absmax in nibbles
  iq3_s          ternary without rotation — the paper's 3-bit baseline
  quip3          random sign diagonal + FWHT (QuIP#-3bit analogue)
  itq3_s         THE PAPER: FWHT rotation + optimal-scale ternary (3.125 bpw)
  itq3_s_sub     sub-block-scale variant (8 fp16 scales per block)
  itq3_x         five-level magnitude-escape grid at the same 3.125 bpw

A :class:`Format` quantizes ``(..., K, N)`` weights along K
(``quantize_blocks`` / ``dequantize_blocks`` plus the tensor-level
``quantize`` / ``dequantize`` that own the block plumbing) and offers
``contract``, the plain ``x @ W_hat`` that ``qmatmul(backend="ref")`` runs.
``supports_fused`` marks the ternary family, whose packed planes the
contraction kernels read; the other formats always contract through their
dequantized weight. ``TernaryFormat.contract_int8`` is the plain W3A8
contraction. New formats plug in with :func:`register_format`.

``itq3_s`` blocks (rotated, one scale per block, three levels, no sign
diagonal) are quantized by the ``quantize_blocks`` kernel wrapper
(``kernels/quantize.py``); the other ternary formats by the plain
:func:`~repro_torch.core.quantize.quantize_blocks_ternary`, as in the
reference. ``quip3`` draws its sign diagonal from JAX's threefry stream
of the quantization seed (``core/prng.py``), so its planes and ``dsign``
equal the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.act_quant import act_encode
from repro_torch.core.fwht import fwht
from repro_torch.core.quantize import (
    DEFAULT_BLOCK, QMeta, QTensor, decode_values, decode_wint,
    dequantize_blocks_ternary, from_blocks, pack_ternary_codes, pad_last_dim,
    quantize_blocks_ternary, to_blocks,
)
from repro_torch.kernels.itq3 import itq3_matmul_int8_ref
from repro_torch.kernels.quantize import quantize_blocks

__all__ = ["FORMATS", "Format", "TernaryFormat", "FloatFormat",
           "AbsmaxFormat", "register_format", "get_format", "quantize",
           "dequantize", "bits_per_weight"]

_FLOAT_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


class Format:
    """Base class: a named storage format for matmul weights."""

    name: str = ""
    bits_per_weight: float = 16.0
    block: int = 1
    is_float: bool = False
    supports_fused: bool = False

    def quantize_blocks(self, wb, *, rule="paper", seed=0) -> dict:
        raise NotImplementedError

    def dequantize_blocks(self, data) -> torch.Tensor:
        raise NotImplementedError

    def contract(self, x: torch.Tensor, qt: QTensor, *,
                 mode: str = "dequant") -> torch.Tensor:
        """Plain ``x (..., K) @ W_hat (K, N)`` in f32 through the
        materialized weight."""
        return torch.matmul(x.to(torch.float32), self.dequantize(qt))

    def make_meta(self, shape, *, rule: str = "paper") -> QMeta:
        return QMeta(self.name, tuple(shape), block=self.block, rule=rule,
                     rotate=False, bits_per_weight=self.bits_per_weight)

    def quantize(self, w: torch.Tensor, *, rule: str = "paper",
                 seed: int = 0) -> QTensor:
        """Quantize ``w (..., K, N)``; leading (stacked-layer) axes are
        blocked independently and the meta records one matrix's shape."""
        data = self.quantize_blocks(to_blocks(w, self.block), rule=rule,
                                    seed=seed)
        return QTensor(data, self.make_meta(w.shape[-2:], rule=rule))

    def dequantize(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        wb = self.dequantize_blocks(qt.data)
        return from_blocks(wb, qt.meta.k).to(dtype)


FORMATS: dict[str, Format] = {}


def register_format(fmt):
    """Register a :class:`Format` (instance or zero-arg class) under its
    ``name``. Usable as a decorator; re-registration overwrites."""
    inst = fmt() if isinstance(fmt, type) else fmt
    if not inst.name:
        raise ValueError(f"format {inst!r} has no name")
    FORMATS[inst.name] = inst
    return fmt


def get_format(name: str) -> Format:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(
            f"unknown format {name!r}; options {sorted(FORMATS)}") from None


# ---------------------------------------------------------------------------
# Float identity formats
# ---------------------------------------------------------------------------

class FloatFormat(Format):
    is_float = True

    def __init__(self, name: str, dtype: str):
        self.name = name
        self.float_dtype = dtype
        self.bits_per_weight = 16.0
        self.block = 1

    def quantize(self, w, *, rule="paper", seed=0) -> QTensor:
        return QTensor({"w": w.to(_FLOAT_DTYPES[self.float_dtype])},
                       self.make_meta(w.shape[-2:], rule=rule))

    def dequantize(self, qt, dtype=torch.float32):
        return qt.data["w"].to(dtype)

    def quantize_blocks(self, wb, *, rule="paper", seed=0):
        return {"w": wb.to(_FLOAT_DTYPES[self.float_dtype])}

    def dequantize_blocks(self, data):
        return data["w"]


# ---------------------------------------------------------------------------
# GGUF-style absmax integer formats (q8_0 / q4_0)
# ---------------------------------------------------------------------------

class AbsmaxFormat(Format):
    """Blockwise absmax scaling to a symmetric int grid (scale rounded
    through fp16); q4_0 packs two offset-8 nibbles per byte."""

    def __init__(self, name: str, qbits: int, bits_per_weight: float):
        self.name = name
        self.qbits = qbits
        self.bits_per_weight = bits_per_weight
        self.block = 32
        self.qmax = float(2 ** (qbits - 1) - 1)

    def quantize_blocks(self, wb, *, rule="paper", seed=0):
        wb = wb.to(torch.float32)
        amax = torch.amax(wb.abs(), dim=-1)
        scale = (amax / self.qmax).to(torch.float16).to(torch.float32)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(wb / safe[..., None]), -self.qmax,
                        self.qmax).to(torch.int8)
        if self.qbits == 4:
            u = (q + 8).to(torch.uint8)
            q = u[..., 0::2] | (u[..., 1::2] << 4)
        return {"q": q.contiguous(),
                "scales": scale.to(torch.float16).contiguous()}

    def dequantize_blocks(self, data):
        q = data["q"]
        if self.qbits == 4:
            lo = (q & 0xF).to(torch.int8) - 8
            hi = ((q >> 4) & 0xF).to(torch.int8) - 8
            q = torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1],
                                                      q.shape[-1] * 2)
        return q.to(torch.float32) * data["scales"].to(torch.float32)[..., None]


# ---------------------------------------------------------------------------
# The ternary family
# ---------------------------------------------------------------------------

class TernaryFormat(Format):
    """Rotation-domain ternary storage, parameterized by the rotation and
    scale-structure knobs; per-call ``sub_blocks`` overrides are honoured."""

    supports_fused = True

    def __init__(self, name: str, *, rotate: bool = True, sub_blocks: int = 0,
                 fivelevel: bool = False, sign_diag: bool = False,
                 block: int = DEFAULT_BLOCK):
        self.name = name
        self.rotate = rotate
        self.sub_blocks = sub_blocks
        self.fivelevel = fivelevel
        self.sign_diag = sign_diag
        self.block = block
        self.bits_per_weight = self._bpw(sub_blocks)

    def _bpw(self, sub_blocks: int) -> float:
        scale_bits = 16 * (sub_blocks + 1 if sub_blocks else 2)
        return 3.0 + scale_bits / self.block

    def make_meta(self, shape, *, rule="paper", sub_blocks=None) -> QMeta:
        sub = self.sub_blocks if sub_blocks is None else sub_blocks
        return QMeta(self.name, tuple(shape), block=self.block, rule=rule,
                     rotate=self.rotate, sub_blocks=sub,
                     fivelevel=self.fivelevel, bits_per_weight=self._bpw(sub))

    def _dsign(self, seed: int, device) -> torch.Tensor | None:
        """The ±1 sign diagonal of a ``sign_diag`` format: the reference's
        ``bernoulli(PRNGKey(seed), 0.5, (block,)) * 2 - 1``."""
        if not self.sign_diag:
            return None
        bits = prng.bernoulli(prng.seed_key(seed), 0.5, (self.block,))
        return (bits.to(torch.int8) * 2 - 1).to(device)

    def quantize_blocks(self, wb, *, rule="paper", seed=0, sub_blocks=None):
        sub = self.sub_blocks if sub_blocks is None else sub_blocks
        if (self.rotate and not sub and not self.fivelevel
                and not self.sign_diag and self.block == DEFAULT_BLOCK):
            return _quantize_blocks_fused(wb, rule)
        return quantize_blocks_ternary(
            wb, rotate=self.rotate, rule=rule, sub_blocks=sub,
            fivelevel=self.fivelevel, dsign=self._dsign(seed, wb.device))

    def dequantize_blocks(self, data, *, sub_blocks=None):
        sub = self.sub_blocks if sub_blocks is None else sub_blocks
        return dequantize_blocks_ternary(
            data, rotate=self.rotate, sub_blocks=sub,
            fivelevel=self.fivelevel, dtype=torch.float32)

    def quantize(self, w, *, rule="paper", seed=0, sub_blocks=None) -> QTensor:
        data = self.quantize_blocks(to_blocks(w, self.block), rule=rule,
                                    seed=seed, sub_blocks=sub_blocks)
        return QTensor(data, self.make_meta(w.shape[-2:], rule=rule,
                                            sub_blocks=sub_blocks))

    def dequantize(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        wb = self.dequantize_blocks(qt.data, sub_blocks=qt.meta.sub_blocks)
        return from_blocks(wb, qt.meta.k).to(dtype)

    def contract(self, x: torch.Tensor, qt: QTensor, *,
                 mode: str = "dequant") -> torch.Tensor:
        """Plain ``y = x @ W_hat`` in f32, three ways that agree in exact
        arithmetic:

        * ``dequant``     — materialize W_hat, then matmul.
        * ``weights``     — decode, dequantize and inverse-FWHT the weight
          blocks, then matmul (the paper's fused form).
        * ``activations`` — rotate each activation block once and contract
          against ``d * (q - z)``: ``sum_b (H w_b) . x_b = sum_b w_b . (H x_b)``
          because H is symmetric and involutory.
        """
        if mode == "dequant":
            return super().contract(x, qt)
        m = qt.meta
        block, kb, n = m.block, m.kb, m.n
        if mode == "weights":
            qv = decode_values(qt.data["plane2"], qt.data["plane1"],
                               fivelevel=m.fivelevel).to(torch.float32)
            if m.sub_blocks:
                d = torch.repeat_interleave(qt.data["scales"].float(),
                                            block // m.sub_blocks, dim=-1)
                vals = d * qv
            else:
                d = qt.data["scales"].float()[..., None]
                z = qt.data["zps"].float()[..., None]
                vals = d * (qv - z)
            if m.rotate:
                vals = fwht(vals)
                dsign = qt.data.get("dsign")
                if dsign is not None:
                    vals = vals * dsign.to(vals.dtype)
            w = vals.reshape(n, kb * block).T
            return torch.matmul(pad_last_dim(x, block).to(torch.float32), w)
        if mode != "activations":
            raise ValueError(f"unknown contraction mode {mode!r}")
        xp = pad_last_dim(x, block).to(torch.float32)
        *lead, _ = xp.shape
        xb = xp.reshape(*lead, kb, block)
        if m.rotate:
            dsign = qt.data.get("dsign")
            if dsign is not None:
                xb = xb * dsign.to(xb.dtype)  # w = D H v => w.x = v.(H D x)
            xb = fwht(xb)
        wint = decode_wint(qt.data["plane2"], qt.data["plane1"],
                           qt.data["zps"], fivelevel=m.fivelevel,
                           sub_blocks=m.sub_blocks)  # (N, KB, block) int8
        d = qt.data["scales"].to(torch.float32)
        if m.sub_blocks:
            d = torch.repeat_interleave(d, block // m.sub_blocks, dim=-1)
            wq = d * wint
        else:
            wq = d[..., None] * wint
        return torch.einsum("...kb,nkb->...n", xb, wq)

    def contract_int8(self, x: torch.Tensor, qt: QTensor) -> torch.Tensor:
        """Plain W3A8 ``x @ W_hat``: quantize the rotated activations to
        int8 (:func:`~repro_torch.core.act_quant.act_encode`) and contract
        against the int8 ``wint`` with exact integer block partials, ``d`` on
        each block (or sub-block) partial and ``s_m`` once at the end —
        the kernels' order (``kernels/itq3.py:itq3_matmul_int8_ref``)."""
        m = qt.meta
        xq, xs = act_encode(pad_last_dim(x, m.block), block=m.block,
                            rotate=m.rotate, dsign=qt.data.get("dsign"))
        lead = xq.shape[:-1]
        y = itq3_matmul_int8_ref(
            xq.reshape(-1, xq.shape[-1]), xs.reshape(-1, 1),
            qt.data["plane2"], qt.data["plane1"], qt.data["scales"],
            qt.data["zps"], fivelevel=m.fivelevel, sub_blocks=m.sub_blocks)
        return y.reshape(*lead, m.n)


def _quantize_blocks_fused(wb: torch.Tensor, rule: str) -> dict:
    """Algorithm 1 for ``itq3_s`` blocks ``(..., 256)`` through the
    ``quantize_blocks`` wrapper (every block of the leaf in one call), then
    the planar pack that ``quantize_blocks_ternary`` uses."""
    lead, block = wb.shape[:-1], wb.shape[-1]
    codes, d, z = quantize_blocks(
        wb.reshape(-1, block).to(torch.float32).contiguous(), rule=rule)
    plane2, plane1 = pack_ternary_codes(codes)
    return {"plane2": plane2.reshape(*lead, block // 4),
            "plane1": plane1.reshape(*lead, block // 8),
            "scales": d.reshape(lead), "zps": z.reshape(lead)}


register_format(FloatFormat("fp16", "float16"))
register_format(FloatFormat("bf16", "bfloat16"))
register_format(AbsmaxFormat("q8_0", qbits=8, bits_per_weight=8.5))
register_format(AbsmaxFormat("q4_0", qbits=4, bits_per_weight=4.5))
register_format(TernaryFormat("iq3_s", rotate=False))
register_format(TernaryFormat("quip3", rotate=True, sign_diag=True))
register_format(TernaryFormat("itq3_s", rotate=True))
register_format(TernaryFormat("itq3_s_sub", rotate=True, sub_blocks=8))
register_format(TernaryFormat("itq3_x", rotate=True, fivelevel=True))


# ---------------------------------------------------------------------------
# Module-level shims (the string-keyed API)
# ---------------------------------------------------------------------------

def bits_per_weight(fmt: str) -> float:
    return get_format(fmt).bits_per_weight


def quantize(w: torch.Tensor, fmt: str = "itq3_s", *, rule: str = "paper",
             seed: int = 0, **overrides) -> QTensor:
    """Quantize ``w (..., K, N)`` into format ``fmt`` (registry lookup)."""
    return get_format(fmt).quantize(w, rule=rule, seed=seed, **overrides)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the ``(..., K, N)`` weight from any registered format."""
    return get_format(qt.meta.fmt).dequantize(qt, dtype=dtype)
