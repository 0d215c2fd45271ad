"""Fused ITQ3_S contraction wrappers (kernels 2, 3, 5 and 6).

The float pair computes ``x (M, KB*256) @ W_hat`` from the packed planes —
``plane2 (N, KB, 64)`` and ``plane1 (N, KB, 32)`` uint8, fp16 ``scales
(N, KB)`` or ``(N, KB, sub)`` and ``zps (N, KB)`` — with an optional
in-kernel inverse FWHT of the weights (``rotate_weights``, the paper's
weights mode); its plain version is :func:`itq3_matmul_ref`:

* ``itq3_matvec`` (``csrc/itq3_matvec.cu``) replaces
  ``repro/kernels/itq3_matvec.py:itq3_matvec_pallas`` for M <= 16. With
  ``rotate_x`` it also runs the activation FWHT (activations mode) on x
  as it stages it, so a float decode projection is one launch; its plain
  version is then ``itq3_matmul_ref(fwht_ref(x))``, and the kernel gives
  the bits of ``fwht.cu`` followed by the matvec. Like the int8 matvec it
  cuts K into runs of blocks, one per warp (:func:`matvec_tiles`), and
  adds the runs' sums in ascending order;
* ``itq3_matmul`` (``csrc/itq3_matmul.cu``) replaces
  ``repro/kernels/itq3_matmul.py:itq3_matmul_pallas`` for M > 16.

``itq3_matmul`` runs on the TF32 tensor cores at f32 accuracy. In
activations mode its weight operand is exact in TF32: ``wint = q - z``
for block-scaled formats, with ``d`` applied to each 256-block's partial,
or ``d_sub * q`` for sub-block formats. Only x is split, ``x_hi =
tf32(x)``, ``x_lo = tf32(x - x_hi)``, and each block's partial is ``x_hi
. w + x_lo . w``. In weights mode the IFWHT'd weight is split as well and
three products are summed (``x_hi w_hi + x_hi w_lo + x_lo w_hi``). The
blocks are summed in ascending K; where :func:`matmul_tiles` cuts K into
splits (one thread block cluster per output tile), the split partials are
added in ascending split order, so two calls give the same bits.
:func:`itq3_matmul_split_ref` is that arithmetic in plain PyTorch, for the
tests.

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

**The expert axis.** Each of the four kernels also takes a stack of E
matrices with their E inputs in one launch — ``x (E, M, K)`` against
planes ``(E, N, KB, 64)`` / ``(E, N, KB, 32)``, scales and zero-points
``(E, N, KB[, sub])``, giving ``(E, M, N)`` — as the reference's
``jax.vmap`` of ``dense`` over the stacked expert planes gives its one
``pallas_call`` an extra grid axis (``repro/models/moe.py:_edense``). The
matvecs take the expert from ``blockIdx.y``; the matmuls fold it into y
(``blockIdx.y = e * m_tiles + m_tile``), z staying the K-split cluster
axis. E = 1 gives the bits of the one-matrix call. The expert launches
count under ``<kernel>_experts``; their plain version is the
one-matrix plain function applied expert by expert (``itq3_matmul_ref``
and ``itq3_matmul_int8_ref`` take the axis), which CPU tensors take and
nothing on the card's path does.

Both int8 kernels take ``sub_blocks`` 0 or any divisor of 256, as the
plain version and the float kernels do. They cut K into splits (thread
block clusters in the matmul, warps of one block in the matvec; the cut
from :func:`matmul_tiles` and :func:`matvec_int8_tiles`) and add the
splits' sums in ascending order: :func:`itq3_matmul_int8_split_ref` is
that arithmetic in plain PyTorch, for the tests.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.fwht import fwht
from repro_torch.core.quantize import decode_values, decode_wint
from repro_torch.kernels import _build
from repro_torch.kernels.fwht import fwht_ref

__all__ = ["itq3_matvec", "itq3_matmul", "itq3_matmul_ref",
           "itq3_matmul_split_ref", "matmul_operand", "matmul_tiles",
           "tf32_round", "itq3_matvec_int8", "itq3_matmul_int8",
           "itq3_matmul_int8_ref", "itq3_matmul_int8_split_ref",
           "matvec_int8_tiles", "matvec_tiles", "matvec_window",
           "MATVEC_MAX_M"]

MATVEC_MAX_M = 16  # decode / small-batch regime; above this, the tiled kernel
MATMUL_BN = 64  # output columns per itq3_matmul block
MATMUL_BM = (32, 64)  # its row tiles: 2 or 4 warps of 16 rows (x 2)
MATMUL_MAX_SPLITS = 8  # K splits form one cluster: the portable size
MATMUL_SMS = 132  # SMs of an H100

_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
_INT8_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7
# after the cut: E, then the per-expert strides (in elements) of x (and,
# int8, xscale), plane2, plane1, scales, zps and out, then the stream
_EXPERT_ARGS = (ctypes.c_int,) + (ctypes.c_longlong,) * 6
_INT8_EXPERT_ARGS = (ctypes.c_int,) + (ctypes.c_longlong,) * 7
MAX_GRID_Y = 65535  # the matvecs' experts, the matmuls' experts x row tiles
MATVEC_INT8_FEATURES = (8, 16, 32)  # output features per block: 8 per warp
MATVEC_INT8_MAX_WARPS = 8  # features / 8 x splits per block
MATVEC_INT8_SMEM = 227 * 1024  # the H100's shared memory per block
MATVEC_XBLOCK_BYTES = 1152  # one 256-block of x staged by itq3_matvec
MATVEC_EXPERT_CUT = (32, 1)  # both matvecs' cut of an expert stack


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


def _per_expert(fn, x, *planes):
    """``fn(x, *planes)`` for one matrix (2-D x), or applied expert by
    expert to an ``(E, M, K)`` x and its ``(E, ...)`` stacks, stacked to
    ``(E, M, N)``: the plain version of an expert launch."""
    if x.dim() == 2:
        return fn(x, *planes)
    return torch.stack([fn(x[e], *(p[e] for p in planes))
                        for e in range(x.shape[0])])


def itq3_matmul_ref(x, plane2, plane1, scales, zps, *, rotate_weights: bool,
                    fivelevel: bool = False, sub_blocks: int = 0):
    """Plain version of both kernels: dequantize, then one f32 matmul
    (expert by expert for a stack)."""
    if x.dim() == 3:
        return _per_expert(functools.partial(
            itq3_matmul_ref, rotate_weights=rotate_weights,
            fivelevel=fivelevel, sub_blocks=sub_blocks),
            x, plane2, plane1, scales, zps)
    n, kb = plane2.shape[0], plane2.shape[1]
    w = dequant_blocks(plane2, plane1, scales, zps,
                       rotate_weights=rotate_weights, fivelevel=fivelevel,
                       sub_blocks=sub_blocks).reshape(n, kb * 256)
    return torch.matmul(x.to(torch.float32), w.T)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 stored mantissa bits), nearest with ties
    away from zero: the kernel's ``cvt.rna.tf32.f32``, emulated with
    integer ops on the f32 bits (add half a TF32 ulp to the magnitude,
    clear the 13 low bits). Finite inputs."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_operand(plane2, plane1, scales, zps, *, rotate_weights: bool,
                   fivelevel: bool = False, sub_blocks: int = 0):
    """The weight operand ``itq3_matmul`` stages, ``(N, KB, 256)`` f32, and
    the scale ``(N, KB)`` it puts on each block's partial. Activations
    mode, block-scaled: ``wint = q - z`` and ``d``; sub-block: ``d_sub *
    q`` and 1. Weights mode: the IFWHT'd ``d * (q - z)`` (or ``d_sub * q``)
    and 1. In activations mode the operand is exact in TF32."""
    n, kb = plane2.shape[0], plane2.shape[1]
    ones = torch.ones((n, kb), dtype=torch.float32, device=plane2.device)
    if rotate_weights or sub_blocks:
        return dequant_blocks(plane2, plane1, scales, zps,
                              rotate_weights=rotate_weights,
                              fivelevel=fivelevel,
                              sub_blocks=sub_blocks), ones
    wint = decode_wint(plane2, plane1, zps, fivelevel=fivelevel,
                       sub_blocks=0).to(torch.float32)
    return wint, scales.to(torch.float32)


def itq3_matmul_split_ref(x, plane2, plane1, scales, zps, *,
                          rotate_weights: bool, fivelevel: bool = False,
                          sub_blocks: int = 0, splits: int = 1):
    """Plain version of the kernel's arithmetic: x split into TF32 hi/lo
    halves; per 256-block the partial ``x_hi . w + x_lo . w`` against the
    :func:`matmul_operand` (three products of hi/lo halves in weights
    mode), scaled by that block's ``d`` and added in ascending K within
    each of ``splits`` runs of ``ceil(KB / splits)`` blocks; the runs'
    sums added in ascending order. The rounding of the operands, the
    scales and the order of blocks and splits are the kernel's; the
    tensor cores' own f32 accumulation is taken as exact within a block,
    the block partial rounded once (the kernel keeps the x_hi products and
    the others in two accumulators, added per block where d is applied,
    at the end of the split otherwise). The tests hold it against the
    plain version and the reference; the main path never calls it."""
    n, kb = plane2.shape[0], plane2.shape[1]
    m = x.shape[0]
    xb = x.to(torch.float32).reshape(m, kb, 256)
    x_hi = tf32_round(xb)
    x_lo = tf32_round(xb - x_hi)
    w, d = matmul_operand(plane2, plane1, scales, zps,
                          rotate_weights=rotate_weights, fivelevel=fivelevel,
                          sub_blocks=sub_blocks)
    if rotate_weights:
        w_hi = tf32_round(w)
        w_lo = tf32_round(w - w_hi)
        prods = ((x_hi, w_hi), (x_hi, w_lo), (x_lo, w_hi))
    else:
        prods = ((x_hi, w), (x_lo, w))
    per = -(-kb // splits)
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for s0 in range(0, kb, per):
        acc = torch.zeros_like(out)
        for b in range(s0, min(kb, s0 + per)):
            # the products of TF32 halves are exact in f64; the block's
            # partial is their f32-rounded sum, and acc = fma(d, P, acc)
            part = sum(a[:, b].double() @ ww[:, b].double().T
                       for a, ww in prods).float()
            acc = (d[:, b].double() * part.double() + acc.double()).float()
        out = out + acc
    return out


def matmul_tiles(m: int, n: int, kb: int, e: int = 1) -> tuple[int, int]:
    """``itq3_matmul``'s cut, from static shapes only: ``(bm, splits)``.
    The KB blocks are cut into the most equal splits (a divisor of KB, at
    most ``MATMUL_MAX_SPLITS``) that keep the grid within two blocks per
    SM, the most that fit at once; 32-row tiles where 64-row ones would
    leave more than half the SMs idle even so. The output tiles of all
    ``e`` experts of a stacked launch count alike. ``chip_smoke.py`` phase
    3 times every cut at the serving shapes on the H100."""
    def cut(bm):
        tiles = e * -(-m // bm) * -(-n // MATMUL_BN)
        splits = max(s for s in range(1, min(kb, MATMUL_MAX_SPLITS) + 1)
                     if kb % s == 0 and (s == 1
                                         or tiles * s <= 2 * MATMUL_SMS))
        return tiles * splits, splits

    blocks, splits = cut(64)
    if m <= 32 or 2 * blocks < MATMUL_SMS:
        return 32, cut(32)[1]
    return 64, splits


def _check(name, x, plane2, plane1, scales, zps, sub_blocks):
    _build.check_operands(name, x.device, (
        (x, torch.float32), (plane2, torch.uint8), (plane1, torch.uint8),
        (scales, torch.float16), (zps, torch.float16)))
    return _check_shapes(x, plane2, plane1, scales, zps, sub_blocks)


def _check_shapes(x, plane2, plane1, scales, zps, sub_blocks):
    """(E, M, N, KB) of a contraction — E = 1 for one ``(M, K)`` x, the
    stack's for an ``(E, M, K)`` x with ``(E, ...)`` planes — or
    ValueError."""
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (M, K) or (E, M, K), got "
                         f"{tuple(x.shape)}")
    lead = tuple(x.shape[:-2])  # () or (E,)
    e = x.shape[0] if lead else 1
    m, kpad = x.shape[-2:]
    if plane2.dim() != 3 + len(lead):
        raise ValueError(f"planes {tuple(plane2.shape)} do not match x "
                         f"{tuple(x.shape)}")
    n, kb = plane2.shape[-3], plane2.shape[-2]
    if kpad != kb * 256:
        raise ValueError(f"x K dim {kpad} != KB*256 = {kb * 256}")
    if (tuple(plane2.shape) != lead + (n, kb, 64)
            or tuple(plane1.shape) != lead + (n, kb, 32)):
        raise ValueError(f"planes must be [E,] (N, KB, 64)/(N, KB, 32), got "
                         f"{tuple(plane2.shape)}/{tuple(plane1.shape)} for x "
                         f"{tuple(x.shape)}")
    want_sc = lead + ((n, kb, sub_blocks) if sub_blocks else (n, kb))
    if (tuple(scales.shape) != want_sc
            or tuple(zps.shape) != lead + (n, kb)):
        raise ValueError(f"scales {tuple(scales.shape)} / zps "
                         f"{tuple(zps.shape)} do not match planes (N={n}, "
                         f"KB={kb}, sub_blocks={sub_blocks})")
    if sub_blocks and 256 % sub_blocks:
        raise ValueError(f"sub_blocks {sub_blocks} must divide 256")
    return e, m, n, kb


def _expert_args(x, out, *operands):
    """E and the per-expert element strides of ``x``, ``operands`` and
    ``out`` for the C launcher: the stacks' leading strides, 0 for one
    matrix (its expert index is always 0)."""
    if x.dim() == 2:
        return (1,) + (0,) * (len(operands) + 2)
    return (x.shape[0],) + tuple(t.stride(0)
                                 for t in (x, *operands, out))


def _count(name, x) -> None:
    _build.launches[f"{name}_experts" if x.dim() == 3 else name] += 1


def _launch(name, x, plane2, plane1, scales, zps, rotate_weights,
            fivelevel, sub_blocks, extra):
    """Launch ``csrc/<name>.cu`` on one matrix or an expert stack;
    ``extra(e, m, n, kb)`` gives the ints the kernel takes after the flags
    (its cut)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    e, m, n, kb = _check(name, x, plane2, plane1, scales, zps, sub_blocks)
    ints = extra(e, m, n, kb)
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32,
                      device=x.device)
    fn = f"{name}_launch"
    lib = _build.library(name, {fn: _ARGS + (ctypes.c_int,) * len(ints)
                                + _EXPERT_ARGS + (ctypes.c_void_p,)})
    _build.check(getattr(lib, fn)(
        x.data_ptr(), plane2.data_ptr(), plane1.data_ptr(), scales.data_ptr(),
        zps.data_ptr(), out.data_ptr(), m, n, kb, int(rotate_weights),
        int(fivelevel), int(sub_blocks), *ints,
        *_expert_args(x, out, plane2, plane1, scales, zps),
        _build.stream_of(x)), name)
    _count(name, x)
    return out


def matvec_window(m: int, kb: int, features: int, splits: int) -> int:
    """Blocks of x ``itq3_matvec`` stages per run at once: the whole run
    where all of x and the splits' sums fit the block's shared memory,
    else the most that fit in two buffers per run (one filling behind the
    math); 0 where not even one block fits."""
    room = MATVEC_INT8_SMEM - (4 * splits * features * m if splits > 1
                               else 0)
    if m * kb * MATVEC_XBLOCK_BYTES <= room:
        return -(-kb // splits)
    return room // (2 * splits * m * MATVEC_XBLOCK_BYTES)


def matvec_tiles(m: int, n: int, kb: int, e: int = 1) -> tuple[int, int]:
    """``itq3_matvec``'s cut, from static shapes only: ``(features,
    splits)``. :func:`matvec_int8_tiles`'s rule (8 features per block, the
    most splits that divide KB, so each warp loads the fewest blocks'
    planes before its math; an expert stack 32 features unsplit), among
    the splits whose staged x fits the block's shared memory
    (:func:`matvec_window`). ``chip_smoke.py`` phase 3 times every cut at
    the serving shapes on the H100."""
    if e > 1 and matvec_window(m, kb, *MATVEC_EXPERT_CUT) >= 1:
        return MATVEC_EXPERT_CUT
    features = MATVEC_INT8_FEATURES[0]
    most = MATVEC_INT8_MAX_WARPS // (features // 8)
    return features, max(s for s in range(1, min(kb, most) + 1)
                         if kb % s == 0
                         and matvec_window(m, kb, features, s) >= 1)


def itq3_matvec(x, plane2, plane1, scales, zps, *, rotate_weights: bool,
                fivelevel: bool = False, sub_blocks: int = 0,
                rotate_x: bool = False, cut=None):
    """Decode-shaped ``x (M <= 16, KB*256) @ W_hat -> (M, N)`` f32, cut by
    :func:`matvec_tiles`; or an expert stack, ``x (E, M, KB*256)`` against
    ``(E, ...)`` planes -> ``(E, M, N)``, in one launch. With ``rotate_x``
    x is taken unrotated (for quip3 already scaled by its sign diagonal)
    and its 256-point FWHT runs in the kernel; it excludes
    ``rotate_weights``. ``cut`` (features, splits) overrides the rule's:
    a tensor-parallel shard takes the cut of the unsharded launch, so its
    columns add their K runs in the same order (``serve/tp.py``)."""
    if not 1 <= x.shape[-2] <= MATVEC_MAX_M:
        raise ValueError(f"matvec kernel is for 1 <= M <= {MATVEC_MAX_M}, "
                         f"got {x.shape[-2]}")
    if rotate_x and rotate_weights:
        raise ValueError("itq3_matvec: rotate_x and rotate_weights exclude "
                         "each other (one rotation per contraction)")
    if x.device.type == "cpu":
        _check("itq3_matvec", x, plane2, plane1, scales, zps, sub_blocks)
        if rotate_x:
            x = fwht_ref(x.reshape(-1, x.shape[-1])).reshape(x.shape)
        return itq3_matmul_ref(x, plane2, plane1, scales, zps,
                               rotate_weights=rotate_weights,
                               fivelevel=fivelevel, sub_blocks=sub_blocks)

    def extra(e, m, n, kb):
        if e > MAX_GRID_Y:
            raise ValueError(f"itq3_matvec: {e} experts > {MAX_GRID_Y}")
        c = tuple(cut) if cut is not None else matvec_tiles(m, n, kb, e)
        window = matvec_window(m, kb, *c)
        if window < 1:
            raise ValueError(f"itq3_matvec: cut {c} leaves no room for x "
                             f"(M={m}, KB={kb})")
        return (*c, window, int(rotate_x))
    return _launch("itq3_matvec", x, plane2, plane1, scales, zps,
                   rotate_weights, fivelevel, sub_blocks, extra)


def itq3_matmul(x, plane2, plane1, scales, zps, *, rotate_weights: bool,
                fivelevel: bool = False, sub_blocks: int = 0, cut=None):
    """Tiled ``x (M, KB*256) @ W_hat -> (M, N)`` f32 for any M >= 1 (the
    serving path sends it M > 16), cut by :func:`matmul_tiles`; or an
    expert stack, ``x (E, M, KB*256)`` -> ``(E, M, N)``, in one launch.
    ``cut`` (bm, splits) overrides the rule's, as :func:`itq3_matvec`'s
    does."""
    if x.device.type == "cpu":
        _check("itq3_matmul", x, plane2, plane1, scales, zps, sub_blocks)
        return itq3_matmul_ref(x, plane2, plane1, scales, zps,
                               rotate_weights=rotate_weights,
                               fivelevel=fivelevel, sub_blocks=sub_blocks)
    return _launch("itq3_matmul", x, plane2, plane1, scales, zps,
                   rotate_weights, fivelevel, sub_blocks,
                   functools.partial(_matmul_cut, cut=cut))


def _matmul_cut(e, m, n, kb, cut=None):
    """The tiled kernels' cut of an ``e``-expert launch (``cut`` when
    given, else :func:`matmul_tiles`'s), checked against the grid's y
    limit."""
    bm, splits = tuple(cut) if cut is not None else matmul_tiles(m, n, kb, e)
    if e * -(-m // bm) > MAX_GRID_Y:
        raise ValueError(f"{e} experts x {-(-m // bm)} row tiles > "
                         f"{MAX_GRID_Y}")
    return bm, splits


# --- the W3A8 integer pair ---------------------------------------------------

def _int8_partials(xq, plane2, plane1, scales, zps, *, fivelevel, sub_blocks):
    """The exact integer (sub-)block partials ``(M, N, KB*sub)``, carried
    in f32, and their scales ``(N, KB*sub)``, in ascending K."""
    n, kb = plane2.shape[0], plane2.shape[1]
    m = xq.shape[0]
    sub = max(sub_blocks, 1)
    per = 256 // sub
    wint = decode_wint(plane2, plane1, zps, fivelevel=fivelevel,
                       sub_blocks=sub_blocks).to(torch.float32)
    xs = xq.to(torch.float32).reshape(m, kb * sub, per)
    part = torch.einsum("msp,nsp->mns", xs, wint.reshape(n, kb * sub, per))
    return part, scales.to(torch.float32).reshape(n, kb * sub)


def itq3_matmul_int8_ref(xq, xscale, plane2, plane1, scales, zps, *,
                         fivelevel: bool = False, sub_blocks: int = 0):
    """Plain version of both int8 kernels (port of
    ``repro/kernels/ref.py:itq3_matmul_int8_ref``).

    The integer block partials ``xq[m, b] . wint[n, b]`` are carried in f32,
    which is exact: |xq * wint| <= 127 * 4 and a 256-wide sum stays below
    2**24, on the CPU and on the card alike. ``d`` multiplies each block
    (or sub-block) partial and the products are added in ascending K, then
    ``xscale`` multiplies once: the kernels' order, so the two agree to the
    last bit. An expert stack (``xq (E, M, K)``, ``xscale (E, M, 1)``) is
    taken expert by expert."""
    if xq.dim() == 3:
        return _per_expert(
            lambda x, xs, *p: itq3_matmul_int8_ref(
                x, xs, *p, fivelevel=fivelevel, sub_blocks=sub_blocks),
            xq, xscale, plane2, plane1, scales, zps)
    part, d = _int8_partials(xq, plane2, plane1, scales, zps,
                             fivelevel=fivelevel, sub_blocks=sub_blocks)
    y = torch.zeros(part.shape[:2], dtype=torch.float32, device=xq.device)
    for s in range(part.shape[2]):
        y = y + part[:, :, s] * d[:, s]
    return y * xscale.to(torch.float32)


def itq3_matmul_int8_split_ref(xq, xscale, plane2, plane1, scales, zps, *,
                               fivelevel: bool = False, sub_blocks: int = 0,
                               splits: int = 1):
    """Plain version of the int8 kernels' split arithmetic: the KB blocks
    cut into ``splits`` runs of ``ceil(KB / splits)`` blocks (the cut of
    :func:`itq3_matmul_split_ref`); within a run, from 0, ``f32(partial) *
    d`` added per (sub-)block in ascending K, each product and each sum
    rounded on its own; the runs' sums added in ascending order, the first
    taken as it is; ``xscale`` once at the end. With ``splits=1`` it is
    :func:`itq3_matmul_int8_ref` to the last bit. The tests hold it
    against the plain version and the reference; the main path never
    calls it."""
    kb = plane2.shape[1]
    part, d = _int8_partials(xq, plane2, plane1, scales, zps,
                             fivelevel=fivelevel, sub_blocks=sub_blocks)
    sub = part.shape[2] // kb
    run = -(-kb // splits)
    out = None
    for b0 in range(0, kb, run):
        acc = torch.zeros(part.shape[:2], dtype=torch.float32,
                          device=xq.device)
        for s in range(b0 * sub, min(kb, b0 + run) * sub):
            acc = acc + part[:, :, s] * d[:, s]
        out = acc if out is None else out + acc
    return out * xscale.to(torch.float32)


def matvec_int8_tiles(m: int, n: int, kb: int,
                      e: int = 1) -> tuple[int, int]:
    """``itq3_matvec_int8``'s cut, from static shapes only: ``(features,
    splits)``, the output features of one block (8 per warp) and the runs
    of K its warps take, added in ascending order: 8 features per block
    (the most blocks) and the most splits that divide KB, so each warp
    loads the fewest blocks' planes before its math. An expert stack
    (``e`` > 1) already has E times the blocks: 32 features unsplit
    (``MATVEC_EXPERT_CUT``), so fewer blocks stage the same x; at
    olmoe-1b-7b's E = 64, M = 4 (NVIDIA H100 80GB HBM3, 700 W) it was the
    fastest of the cuts timed or tied for it, for both matvecs: 0.47-0.57x
    the time of the one-matrix rule's cut for the float matvec, 0.60-0.70x
    for this one. ``chip_smoke.py``
    phase 3 times every cut at the serving shapes; on an NVIDIA H100
    80GB HBM3 at 700 W (M = 4) this rule's cut was the fastest or tied
    for it at all four: 8 x 3 at 0.0040-0.0041 ms for wq, wk and gate (KB
    3; unsplit 0.0055-0.0059; 16 x 3 tied at gate), 8 x 6 at 0.0041 ms
    for down (KB 6; unsplit 0.0077, 3 splits 0.0045)."""
    if e > 1 and _matvec_int8_smem(m, kb, *MATVEC_EXPERT_CUT) \
            <= MATVEC_INT8_SMEM:
        return MATVEC_EXPERT_CUT
    features = MATVEC_INT8_FEATURES[0]
    most = MATVEC_INT8_MAX_WARPS // (features // 8)
    return features, max(s for s in range(1, min(kb, most) + 1)
                         if kb % s == 0)


def _check_int8(name, xq, xscale, plane2, plane1, scales, zps, sub_blocks):
    _build.check_operands(name, xq.device, (
        (xq, torch.int8), (xscale, torch.float32), (plane2, torch.uint8),
        (plane1, torch.uint8), (scales, torch.float16), (zps, torch.float16)))
    if (xq.dim() not in (2, 3)
            or tuple(xscale.shape) != tuple(xq.shape[:-1]) + (1,)):
        raise ValueError(f"xq must be [E,] (M, K) with xscale [E,] (M, 1), "
                         f"got {tuple(xq.shape)} / {tuple(xscale.shape)}")
    return _check_shapes(xq, plane2, plane1, scales, zps, sub_blocks)


def _matvec_int8_smem(m, kb, features, splits) -> int:
    """Bytes of shared memory the matvec takes: the (M, K) codes and the
    splits' sums."""
    return m * kb * 256 + 4 * splits * features * m


def _launch_int8(name, xq, xscale, plane2, plane1, scales, zps, fivelevel,
                 sub_blocks, mnk, cut):
    """Launch ``csrc/<name>.cu`` on checked operands of shape ``mnk`` with
    the cut ``cut``."""
    if not xq.is_cuda:
        raise ValueError(f"{name}: unsupported device {xq.device}")
    if xq.data_ptr() % 16:
        raise ValueError(f"{name}: xq must be 16-byte aligned")
    m, n, kb = mnk
    out = torch.empty(xq.shape[:-1] + (n,), dtype=torch.float32,
                      device=xq.device)
    fn = f"{name}_launch"
    lib = _build.library(name, {fn: _INT8_ARGS + _INT8_EXPERT_ARGS
                                + (ctypes.c_void_p,)})
    _build.check(getattr(lib, fn)(
        xq.data_ptr(), xscale.data_ptr(), plane2.data_ptr(),
        plane1.data_ptr(), scales.data_ptr(), zps.data_ptr(), out.data_ptr(),
        m, n, kb, int(fivelevel), int(sub_blocks), *cut,
        *_expert_args(xq, out, xscale, plane2, plane1, scales, zps),
        _build.stream_of(xq)), name)
    _count(name, xq)
    return out


def itq3_matvec_int8(xq, xscale, plane2, plane1, scales, zps, *,
                     fivelevel: bool = False, sub_blocks: int = 0, cut=None):
    """Decode-shaped W3A8 ``xq (M <= 16, KB*256) int8 -> (M, N)`` f32, cut
    by :func:`matvec_int8_tiles`; or an expert stack (``xq (E, M, K)``,
    ``xscale (E, M, 1)``) -> ``(E, M, N)`` in one launch. The operands are
    checked before the device, so what the kernel cannot take is refused
    on any device. ``cut`` (features, splits) overrides the rule's, as
    :func:`itq3_matvec`'s does."""
    if not 1 <= xq.shape[-2] <= MATVEC_MAX_M:
        raise ValueError(f"matvec kernel is for 1 <= M <= {MATVEC_MAX_M}, "
                         f"got {xq.shape[-2]}")
    name = "itq3_matvec_int8"
    e, m, n, kb = _check_int8(name, xq, xscale, plane2, plane1, scales, zps,
                              sub_blocks)
    if e > MAX_GRID_Y:
        raise ValueError(f"{name}: {e} experts > {MAX_GRID_Y}")
    if xq.device.type == "cpu":
        return itq3_matmul_int8_ref(xq, xscale, plane2, plane1, scales, zps,
                                    fivelevel=fivelevel,
                                    sub_blocks=sub_blocks)
    cut = tuple(cut) if cut is not None else matvec_int8_tiles(m, n, kb, e)
    if _matvec_int8_smem(m, kb, *cut) > MATVEC_INT8_SMEM:
        raise ValueError(f"{name}: M*K = {m * kb * 256} codes exceed the "
                         f"block's shared memory")
    return _launch_int8(name, xq, xscale, plane2, plane1, scales, zps,
                        fivelevel, sub_blocks, (m, n, kb), cut)


def itq3_matmul_int8(xq, xscale, plane2, plane1, scales, zps, *,
                     fivelevel: bool = False, sub_blocks: int = 0, cut=None):
    """Tiled W3A8 ``xq (M, KB*256) int8 -> (M, N)`` f32 for any M >= 1
    (the serving path sends it M > 16), cut by :func:`matmul_tiles`; or an
    expert stack (``xq (E, M, K)``) -> ``(E, M, N)`` in one launch.
    ``cut`` (bm, splits) overrides the rule's, as :func:`itq3_matvec`'s
    does."""
    name = "itq3_matmul_int8"
    e, m, n, kb = _check_int8(name, xq, xscale, plane2, plane1, scales, zps,
                              sub_blocks)
    if xq.device.type == "cpu":
        return itq3_matmul_int8_ref(xq, xscale, plane2, plane1, scales, zps,
                                    fivelevel=fivelevel,
                                    sub_blocks=sub_blocks)
    return _launch_int8(name, xq, xscale, plane2, plane1, scales, zps,
                        fivelevel, sub_blocks, (m, n, kb),
                        _matmul_cut(e, m, n, kb, cut))
