"""The ternary format family (port of ``repro/core/formats.py``).

  iq3_s       ternary without rotation — the paper's 3-bit baseline
  quip3       random sign diagonal + FWHT (QuIP#-3bit analogue)
  itq3_s      THE PAPER: FWHT rotation + optimal-scale ternary (3.125 bpw)
  itq3_s_sub  sub-block-scale variant (8 fp16 scales per block)
  itq3_x      five-level magnitude-escape grid at the same 3.125 bpw

Each :class:`TernaryFormat` quantizes ``(..., K, N)`` weights along K and
offers ``contract``, the plain ``x @ W_hat`` in three modes (``dequant``,
``weights``, ``activations``) that ``qmatmul(backend="ref")`` runs. The
float and absmax formats (fp16, bf16, q8_0, q4_0) belong to the
mixed-policy slice. Quantizing ``quip3`` here also waits: the reference
draws its sign diagonal from ``jax.random``, so its planes and ``dsign``
arrive through ``repro_torch.bridge`` instead.
"""
from __future__ import annotations

import torch

from repro_torch.core.fwht import fwht
from repro_torch.core.quantize import (
    DEFAULT_BLOCK, QMeta, QTensor, decode_values, decode_wint,
    dequantize_blocks_ternary, from_blocks, pad_last_dim,
    quantize_blocks_ternary, to_blocks,
)

__all__ = ["FORMATS", "TernaryFormat", "get_format", "quantize"]


class TernaryFormat:
    """Rotation-domain ternary storage, parameterized by the rotation and
    scale-structure knobs."""

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

    def quantize(self, w: torch.Tensor, *, rule: str = "paper",
                 sub_blocks=None) -> QTensor:
        """Quantize ``w`` (..., K, N); leading axes (stacked layers) are
        blocked independently, so each matrix gets its own statistics."""
        if self.sign_diag:
            raise NotImplementedError(
                f"{self.name}: quantizing with a sign diagonal lands with the "
                f"mixed-policy slice (the reference draws it from "
                f"jax.random); bring quip3 planes over with "
                f"repro_torch.bridge.params_from_numpy")
        sub = self.sub_blocks if sub_blocks is None else sub_blocks
        data = quantize_blocks_ternary(
            to_blocks(w, self.block), rotate=self.rotate, rule=rule,
            sub_blocks=sub, fivelevel=self.fivelevel)
        return QTensor(data, self.make_meta(w.shape[-2:], rule=rule,
                                            sub_blocks=sub_blocks))

    def dequantize(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        wb = dequantize_blocks_ternary(
            qt.data, rotate=self.rotate, sub_blocks=qt.meta.sub_blocks,
            fivelevel=self.fivelevel, dtype=torch.float32)
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
            return torch.matmul(x.to(torch.float32), self.dequantize(qt))
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


FORMATS: dict[str, TernaryFormat] = {
    f.name: f for f in (
        TernaryFormat("iq3_s", rotate=False),
        TernaryFormat("quip3", rotate=True, sign_diag=True),
        TernaryFormat("itq3_s", rotate=True),
        TernaryFormat("itq3_s_sub", rotate=True, sub_blocks=8),
        TernaryFormat("itq3_x", rotate=True, fivelevel=True),
    )
}


def get_format(name: str) -> TernaryFormat:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(
            f"unknown or not-yet-ported format {name!r}; the port serves "
            f"{sorted(FORMATS)} (fp16/bf16/q8_0/q4_0 land with the "
            f"mixed-policy slice)") from None


def quantize(w: torch.Tensor, fmt: str = "itq3_s", *, rule: str = "paper",
             **overrides) -> QTensor:
    """Quantize ``w`` (..., K, N) into format ``fmt``."""
    return get_format(fmt).quantize(w, rule=rule, **overrides)
