"""Fused ITQ3_S contraction wrappers (kernels 2, 3, 5 and 6).

The float pair computes ``x (M, KB*256) @ W_hat`` from the packed planes —
``plane2 (N, KB, 64)`` and ``plane1 (N, KB, 32)`` uint8, fp16 ``scales
(N, KB)`` or ``(N, KB, sub)`` and ``zps (N, KB)`` — with an optional
in-kernel inverse FWHT of the weights (``rotate_weights``, the paper's
weights mode); its plain version is :func:`itq3_matmul_ref`:

* ``itq3_matvec`` (``csrc/itq3_matvec.cu``) replaces
  ``repro/kernels/itq3_matvec.py:itq3_matvec_pallas`` for M <= 16;
* ``itq3_matmul`` (``csrc/itq3_matmul.cu``) replaces
  ``repro/kernels/itq3_matmul.py:itq3_matmul_pallas`` for M > 16.

The int8 pair is the W3A8 path: ``xq (M, KB*256)`` int8 rotation-domain
activation codes and their ``xscale (M, 1)`` f32 row scales against the
exact int8 ``wint = q - z``, with int32 block partials, ``d`` on each block
(or sub-block) partial and ``xscale`` once at the end; its plain version
is :func:`itq3_matmul_int8_ref`:

* ``itq3_matvec_int8`` (``csrc/itq3_matvec_int8.cu``) replaces
  ``repro/kernels/itq3_matvec.py:itq3_matvec_int8_pallas`` for M <= 16
  (every W3A8 decode step);
* ``itq3_matmul_int8`` (``csrc/itq3_matmul_int8.cu``) replaces
  ``repro/kernels/itq3_matmul.py:itq3_matmul_int8_pallas`` for M > 16
  (every W3A8 prefill wave).

The int8 kernels take sub-blocks of 32 elements or more (``sub_blocks`` 0,
2, 4 or 8: itq3_s_sub has 8); the plain version takes any divisor of 256.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fwht import fwht
from repro_torch.core.quantize import decode_values, decode_wint
from repro_torch.kernels import _build

__all__ = ["itq3_matvec", "itq3_matmul", "itq3_matmul_ref",
           "itq3_matvec_int8", "itq3_matmul_int8", "itq3_matmul_int8_ref",
           "MATVEC_MAX_M", "INT8_SUB_BLOCKS"]

MATVEC_MAX_M = 16  # decode / small-batch regime; above this, the tiled kernel
INT8_SUB_BLOCKS = (0, 2, 4, 8)  # what the int8 kernels take: >= 32 per sub

_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_INT8_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def dequant_blocks(plane2, plane1, scales, zps, *, rotate_weights: bool,
                   fivelevel: bool, sub_blocks: int) -> torch.Tensor:
    """(N, KB, 256) f32 weight blocks as the kernels see them: ``d*(q-z)``
    (or ``d_sub*q``), inverse-FWHT'd when ``rotate_weights``."""
    qv = decode_values(plane2, plane1, fivelevel=fivelevel).to(torch.float32)
    if sub_blocks:
        d = torch.repeat_interleave(scales.to(torch.float32),
                                    256 // sub_blocks, dim=-1)
        vals = d * qv
    else:
        vals = scales.to(torch.float32)[..., None] * (
            qv - zps.to(torch.float32)[..., None])
    return fwht(vals) if rotate_weights else vals


def itq3_matmul_ref(x, plane2, plane1, scales, zps, *, rotate_weights: bool,
                    fivelevel: bool = False, sub_blocks: int = 0):
    """Plain version of both kernels: dequantize, then one f32 matmul."""
    n, kb = plane2.shape[0], plane2.shape[1]
    w = dequant_blocks(plane2, plane1, scales, zps,
                       rotate_weights=rotate_weights, fivelevel=fivelevel,
                       sub_blocks=sub_blocks).reshape(n, kb * 256)
    return torch.matmul(x.to(torch.float32), w.T)


def _check(name, x, plane2, plane1, scales, zps, sub_blocks):
    _build.check_operands(name, x.device, (
        (x, torch.float32), (plane2, torch.uint8), (plane1, torch.uint8),
        (scales, torch.float16), (zps, torch.float16)))
    return _check_shapes(x, plane2, plane1, scales, zps, sub_blocks)


def _check_shapes(x, plane2, plane1, scales, zps, sub_blocks):
    """(M, N, KB) of a contraction, or ValueError."""
    m, kpad = x.shape
    n, kb = plane2.shape[0], plane2.shape[1]
    if kpad != kb * 256:
        raise ValueError(f"x K dim {kpad} != KB*256 = {kb * 256}")
    if plane2.shape != (n, kb, 64) or plane1.shape != (n, kb, 32):
        raise ValueError(f"planes must be (N, KB, 64)/(N, KB, 32), got "
                         f"{tuple(plane2.shape)}/{tuple(plane1.shape)}")
    want_sc = (n, kb, sub_blocks) if sub_blocks else (n, kb)
    if tuple(scales.shape) != want_sc or tuple(zps.shape) != (n, kb):
        raise ValueError(f"scales {tuple(scales.shape)} / zps "
                         f"{tuple(zps.shape)} do not match planes (N={n}, "
                         f"KB={kb}, sub_blocks={sub_blocks})")
    if sub_blocks and 256 % sub_blocks:
        raise ValueError(f"sub_blocks {sub_blocks} must divide 256")
    return m, n, kb


def _launch(name, fn, x, plane2, plane1, scales, zps, rotate_weights,
            fivelevel, sub_blocks):
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    m, n, kb = _check(name, x, plane2, plane1, scales, zps, sub_blocks)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _build.library(name, {fn: _ARGS})
    _build.check(getattr(lib, fn)(
        x.data_ptr(), plane2.data_ptr(), plane1.data_ptr(), scales.data_ptr(),
        zps.data_ptr(), out.data_ptr(), m, n, kb, int(rotate_weights),
        int(fivelevel), int(sub_blocks), _build.stream_of(x)), name)
    _build.launches[name] += 1
    return out


def itq3_matvec(x, plane2, plane1, scales, zps, *, rotate_weights: bool,
                fivelevel: bool = False, sub_blocks: int = 0):
    """Decode-shaped ``x (M <= 16, KB*256) @ W_hat -> (M, N)`` f32."""
    if not 1 <= x.shape[0] <= MATVEC_MAX_M:
        raise ValueError(f"matvec kernel is for 1 <= M <= {MATVEC_MAX_M}, "
                         f"got {x.shape[0]}")
    if x.device.type == "cpu":
        _check("itq3_matvec", x, plane2, plane1, scales, zps, sub_blocks)
        return itq3_matmul_ref(x, plane2, plane1, scales, zps,
                               rotate_weights=rotate_weights,
                               fivelevel=fivelevel, sub_blocks=sub_blocks)
    return _launch("itq3_matvec", "itq3_matvec_launch", x, plane2, plane1,
                   scales, zps, rotate_weights, fivelevel, sub_blocks)


def itq3_matmul(x, plane2, plane1, scales, zps, *, rotate_weights: bool,
                fivelevel: bool = False, sub_blocks: int = 0):
    """Tiled ``x (M, KB*256) @ W_hat -> (M, N)`` f32 for any M >= 1 (the
    serving path sends it M > 16)."""
    if x.device.type == "cpu":
        _check("itq3_matmul", x, plane2, plane1, scales, zps, sub_blocks)
        return itq3_matmul_ref(x, plane2, plane1, scales, zps,
                               rotate_weights=rotate_weights,
                               fivelevel=fivelevel, sub_blocks=sub_blocks)
    return _launch("itq3_matmul", "itq3_matmul_launch", x, plane2, plane1,
                   scales, zps, rotate_weights, fivelevel, sub_blocks)


# --- the W3A8 integer pair ---------------------------------------------------

def itq3_matmul_int8_ref(xq, xscale, plane2, plane1, scales, zps, *,
                         fivelevel: bool = False, sub_blocks: int = 0):
    """Plain version of both int8 kernels (port of
    ``repro/kernels/ref.py:itq3_matmul_int8_ref``).

    The integer block partials ``xq[m, b] . wint[n, b]`` are carried in f32,
    which is exact: |xq * wint| <= 127 * 4 and a 256-wide sum stays below
    2**24, on the CPU and on the card alike. ``d`` multiplies each block
    (or sub-block) partial and the products are added in ascending K, then
    ``xscale`` multiplies once: the kernels' order, so the two agree to the
    last bit."""
    n, kb = plane2.shape[0], plane2.shape[1]
    m = xq.shape[0]
    sub = max(sub_blocks, 1)
    per = 256 // sub
    wint = decode_wint(plane2, plane1, zps, fivelevel=fivelevel,
                       sub_blocks=sub_blocks).to(torch.float32)
    xs = xq.to(torch.float32).reshape(m, kb * sub, per)
    part = torch.einsum("msp,nsp->mns", xs, wint.reshape(n, kb * sub, per))
    d = scales.to(torch.float32).reshape(n, kb * sub)
    y = torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    for s in range(kb * sub):
        y = y + part[:, :, s] * d[:, s]
    return y * xscale.to(torch.float32)


def _check_int8(name, xq, xscale, plane2, plane1, scales, zps, sub_blocks):
    _build.check_operands(name, xq.device, (
        (xq, torch.int8), (xscale, torch.float32), (plane2, torch.uint8),
        (plane1, torch.uint8), (scales, torch.float16), (zps, torch.float16)))
    if xq.dim() != 2 or tuple(xscale.shape) != (xq.shape[0], 1):
        raise ValueError(f"xq must be (M, K) with xscale (M, 1), got "
                         f"{tuple(xq.shape)} / {tuple(xscale.shape)}")
    return _check_shapes(xq, plane2, plane1, scales, zps, sub_blocks)


def _launch_int8(name, fn, xq, xscale, plane2, plane1, scales, zps,
                 fivelevel, sub_blocks):
    if not xq.is_cuda:
        raise ValueError(f"{name}: unsupported device {xq.device}")
    m, n, kb = _check_int8(name, xq, xscale, plane2, plane1, scales, zps,
                           sub_blocks)
    if sub_blocks not in INT8_SUB_BLOCKS:
        raise ValueError(f"{name}: the kernel takes sub_blocks in "
                         f"{INT8_SUB_BLOCKS}, got {sub_blocks}")
    if xq.data_ptr() % 16:
        raise ValueError(f"{name}: xq must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    lib = _build.library(name, {fn: _INT8_ARGS})
    _build.check(getattr(lib, fn)(
        xq.data_ptr(), xscale.data_ptr(), plane2.data_ptr(),
        plane1.data_ptr(), scales.data_ptr(), zps.data_ptr(), out.data_ptr(),
        m, n, kb, int(fivelevel), int(sub_blocks), _build.stream_of(xq)),
        name)
    _build.launches[name] += 1
    return out


def itq3_matvec_int8(xq, xscale, plane2, plane1, scales, zps, *,
                     fivelevel: bool = False, sub_blocks: int = 0):
    """Decode-shaped W3A8 ``xq (M <= 16, KB*256) int8 -> (M, N)`` f32."""
    if not 1 <= xq.shape[0] <= MATVEC_MAX_M:
        raise ValueError(f"matvec kernel is for 1 <= M <= {MATVEC_MAX_M}, "
                         f"got {xq.shape[0]}")
    if xq.device.type == "cpu":
        _check_int8("itq3_matvec_int8", xq, xscale, plane2, plane1, scales,
                    zps, sub_blocks)
        return itq3_matmul_int8_ref(xq, xscale, plane2, plane1, scales, zps,
                                    fivelevel=fivelevel,
                                    sub_blocks=sub_blocks)
    return _launch_int8("itq3_matvec_int8", "itq3_matvec_int8_launch", xq,
                        xscale, plane2, plane1, scales, zps, fivelevel,
                        sub_blocks)


def itq3_matmul_int8(xq, xscale, plane2, plane1, scales, zps, *,
                     fivelevel: bool = False, sub_blocks: int = 0):
    """Tiled W3A8 ``xq (M, KB*256) int8 -> (M, N)`` f32 for any M >= 1
    (the serving path sends it M > 16)."""
    if xq.device.type == "cpu":
        _check_int8("itq3_matmul_int8", xq, xscale, plane2, plane1, scales,
                    zps, sub_blocks)
        return itq3_matmul_int8_ref(xq, xscale, plane2, plane1, scales, zps,
                                    fivelevel=fivelevel,
                                    sub_blocks=sub_blocks)
    return _launch_int8("itq3_matmul_int8", "itq3_matmul_int8_launch", xq,
                        xscale, plane2, plane1, scales, zps, fivelevel,
                        sub_blocks)
