"""Blocked FWHT kernel wrappers (kernel 1, ``csrc/fwht.cu``): the rotation
alone and the two rotate-and-encode forms of the serving path.

Replaces ``repro/kernels/fwht_kernel.py:fwht_pallas`` and, fused after it,
the reference's codec ops. ``fwht`` takes any power of two from 2 to 1024
as ``block``; on the serving path it rotates the activations of every
float prefill projection at 256 points (a float decode projection rotates
inside ``itq3_matvec``), and through :func:`fwht_last` the attention's
query and output at head_dim points. :func:`fwht_act_encode` is the W3A8
activation codec of one projection in one launch (256-point FWHT, row
absmax, int8 codes and scale; ``core/act_quant.py:act_encode``), and
:func:`fwht_kv_encode` the KV codec of one layer's K and V in one launch
(head_dim FWHT, per-vector absmax, int8 codes and fp16 scale;
``serve/kv_quant.py:kv_encode``). Launches count under ``fwht/<block>``,
``fwht_act/256`` and ``fwht_kv/<head_dim>``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core.act_quant import ACT_RECIP, act_encode, kv_quantize
from repro_torch.core.fwht import blocked_fwht
from repro_torch.core.fwht import fwht as plain_fwht
from repro_torch.core.quantize import pad_last_dim
from repro_torch.kernels import _build

__all__ = ["fwht", "fwht_ref", "fwht_last", "fwht_act_encode",
           "fwht_act_encode_ref", "fwht_kv_encode", "fwht_kv_encode_ref",
           "FWHT_BLOCKS", "ACT_BLOCK"]

FWHT_BLOCKS = tuple(2 ** i for i in range(1, 11))  # 2 .. 1024
ACT_BLOCK = 256  # the activation codec's block, the ternary formats' own
_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_SIG = {
    "fwht_launch": (_P, _P, _LL, _I, _F, _P),
    "fwht_act_encode_launch": (_P, _P, _P, _LL, _I, _I, _I, _F, _P),
    "fwht_kv_encode_launch": (_P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I,
                              _LL, _I, _P, _P, _F, _F, _P),
}


def _norm(block: int) -> float:
    """The f32 rounding of 1/sqrt(block), the plain butterfly's scale."""
    return float(np.float32(1.0 / math.sqrt(block)))


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
        _build.check(lib.fwht_launch(x.data_ptr(), y.data_ptr(), nvec, block,
                                     _norm(block), _build.stream_of(x)),
                     "fwht")
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


def fwht_act_encode_ref(x: torch.Tensor, *, block: int = ACT_BLOCK,
                        rotate: bool = True, dsign=None):
    """Plain version: ``act_encode`` of the rows zero-padded to whole
    blocks."""
    return act_encode(pad_last_dim(x, block), block=block, rotate=rotate,
                      dsign=dsign)


def fwht_act_encode(x: torch.Tensor, *, block: int = ACT_BLOCK,
                    rotate: bool = True, dsign: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The W3A8 activation codec of ``x (M, K)`` f32 in one launch: the
    rows zero-padded to ``KB = ceil(K / 256)`` blocks (the kernel reads
    the tail as zeros), ``dsign`` (quip3, ``(KB, 256)``) applied and each
    block rotated if ``rotate``, then int8 codes ``(M, KB * 256)`` and the
    f32 row scale ``(M, 1)``: the bits of :func:`fwht_act_encode_ref`."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"fwht_act_encode expects a 2-D (M, K >= 1) "
                         f"tensor, got {tuple(x.shape)}")
    if block != ACT_BLOCK:
        raise ValueError(f"fwht_act_encode: block must be {ACT_BLOCK}, got "
                         f"{block}")
    _build.check_operands("fwht_act_encode", x.device, ((x, torch.float32),))
    if x.device.type == "cpu":
        return fwht_act_encode_ref(x, block=block, rotate=rotate, dsign=dsign)
    if not x.is_cuda:
        raise ValueError(f"fwht_act_encode: unsupported device {x.device}")
    m, k = x.shape
    kb = -(-k // block)
    if rotate and dsign is not None:  # a +-1 product: exact, before the launch
        x = (pad_last_dim(x, block).reshape(m, kb, block)
             * dsign.to(torch.float32)).reshape(m, kb * block).contiguous()
        k = kb * block
    codes = torch.empty((m, kb * block), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        lib = _build.library("fwht", _SIG)
        _build.check(lib.fwht_act_encode_launch(
            x.data_ptr(), codes.data_ptr(), scale.data_ptr(), m, k, kb,
            int(rotate), ACT_RECIP, _build.stream_of(x)), "fwht_act_encode")
        _build.launches[f"fwht_act/{block}"] += 1
    return codes, scale


def fwht_kv_encode_ref(k: torch.Tensor, v: torch.Tensor):
    """Plain version: the plain butterfly along head_dim, then the KV
    codec's ops (``kv_encode(x, backend="ref")``), for K and for V."""
    return tuple(kv_quantize(plain_fwht(x.to(torch.float32))) for x in (k, v))


def fwht_kv_encode(k: torch.Tensor, v: torch.Tensor):
    """The KV codec of one layer in one launch: ``k``, ``v`` f32 ``(B, KV,
    T, HD)``, HD a power of two from 2 to 1024, the last axis contiguous
    (the kernel takes the other strides, so the transposed V needs no
    copy). Returns ``((k_codes, k_scales), (v_codes, v_scales))``, int8
    ``(B, KV, T, HD)`` and fp16 ``(B, KV, T, 1)``, contiguous: the bits of
    :func:`fwht_kv_encode_ref`."""
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"fwht_kv_encode expects K and V of one (B, KV, T, "
                         f"HD) shape, got {tuple(k.shape)}, {tuple(v.shape)}")
    hd = k.shape[-1]
    if hd not in FWHT_BLOCKS:
        raise ValueError(f"head_dim {hd} must be a power of two in [2, 1024]")
    for t in (k, v):
        if t.device != k.device or t.dtype != torch.float32:
            raise ValueError(f"fwht_kv_encode: operand {t.dtype} on "
                             f"{t.device}, want float32 on {k.device}")
    if k.device.type == "cpu":
        return fwht_kv_encode_ref(k, v)
    if not k.is_cuda:
        raise ValueError(f"fwht_kv_encode: unsupported device {k.device}")
    k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (k, v))
    b, kvh, t, _ = k.shape
    codes = torch.empty((2, b, kvh, t, hd), dtype=torch.int8, device=k.device)
    scales = torch.empty((2, b, kvh, t, 1), dtype=torch.float16,
                         device=k.device)
    nvec = b * kvh * t
    if nvec:
        lib = _build.library("fwht", _SIG)
        _build.check(lib.fwht_kv_encode_launch(
            k.data_ptr(), v.data_ptr(), *k.stride()[:3], *v.stride()[:3], kvh,
            t, nvec, hd, codes.data_ptr(), scales.data_ptr(), _norm(hd),
            ACT_RECIP, _build.stream_of(k)), "fwht_kv_encode")
        _build.launches[f"fwht_kv/{hd}"] += 1
    return (codes[0], scales[0]), (codes[1], scales[1])
