"""Quantized linear forward (port of ``repro/core/qlinear.py`` and of the
dispatch in ``repro/kernels/ops.py``).

:func:`qmatmul` is the one entry point for ``y = x @ W_hat`` on a QTensor.

**mode** — where the rotation lands (see ``TernaryFormat.contract``):
``dequant`` (materialize W_hat; plain only), ``weights`` (inverse-FWHT the
weight tiles inside the contraction kernel), ``activations`` (rotate each
activation block once, then contract without a weight rotation; the
serving default: M <= 16 rows rotate inside the matvec kernel, larger M
with the FWHT kernel before the tiled one), ``auto`` (rotate the smaller
operand).

**backend** — ``ref`` runs the plain ``Format.contract``; ``cuda`` runs the
kernel path and requires CUDA tensors; ``auto`` runs the kernel path,
whose wrappers launch the Hopper kernels on CUDA tensors and run their
plain versions on CPU tensors. The kernel path dispatches by shape: M <= 16
rows go to the matvec kernel, larger M to the tiled kernel. Formats
without packed ternary planes (fp16, bf16, q8_0, q4_0) always take the
plain ``dequant`` contraction, so mixed-precision trees serve through this
one entry point.

**act_quant** — the W3A8 integer path: rotate the activations and
quantize them to int8 per row in one launch
(``kernels/fwht.py:fwht_act_encode``, the bits of ``core/act_quant.py``),
and contract against the int8 ``wint`` in the int8 kernels. It is honoured only
for the ternary family, when the weight's ``QMeta.act_quant`` allows it and
never for ``mode="dequant"``; ``ref`` then runs ``contract_int8``.

:func:`qmatmul_experts` is the expert-batched entry, ``x (E, M, K)``
against an ``(E, K, N)`` stacked QTensor (the MoE expert projections, the
reference's ``jax.vmap`` of ``dense`` over the stack), with the same
modes, backends and ``act_quant``: on the kernel path one FWHT (or one
``fwht_act_encode``) over all E·M rows where the path has one, then ONE
expert-axis launch of the matvec (M <= 16 rows per expert, as the
reference decides per expert) or of the tiled kernel. It never loops
over experts on the card; the plain paths take the experts one by one.

**cut_from** — a tensor-parallel shard (``serve/tp.py``) holds N/m columns
of a weight, or E/m experts of a stack, and its launch would take the cut
its own ``(E, N)`` gives: a different K split, so its columns would add
their K runs in another order than the unsharded launch's. ``cut_from=(E,
N)`` names the unsharded launch; the kernel path then works the cut out
with the kernel's own rule (:func:`launch_cut`) at those E and N and
passes it to the shard's launch, so every column has the bits it has on
one device.
"""
from __future__ import annotations

import torch

from repro_torch.core import formats as fmt_mod
from repro_torch.core.quantize import QTensor, pad_last_dim
from repro_torch.kernels import fwht as fwht_kernels
from repro_torch.kernels.fwht import fwht_act_encode
from repro_torch.kernels.itq3 import (
    MATVEC_MAX_M, itq3_matmul, itq3_matmul_int8, itq3_matvec,
    itq3_matvec_int8, matmul_tiles, matvec_int8_tiles, matvec_tiles,
)

__all__ = ["qmatmul", "qmatmul_kernel", "qmatmul_experts", "resolve_mode",
           "launch_cut", "QLINEAR_MODES", "QMATMUL_BACKENDS"]

QLINEAR_MODES = ("dequant", "weights", "activations", "auto")
QMATMUL_BACKENDS = ("auto", "ref", "cuda")


def resolve_mode(x: torch.Tensor, m, mode: str) -> str:
    """Resolve mode="auto": rotate the smaller operand."""
    if mode != "auto":
        return mode
    rows = 1
    for d in x.shape[:-1]:
        rows *= d
    return "activations" if rows <= m.n else "weights"


def _checked(x, qt, mode, backend):
    """Validate the knobs; returns the format spec."""
    m = qt.meta
    if len(m.shape) != 2:
        raise ValueError(f"qmatmul expects 2-D weights, got shape {m.shape}")
    if mode not in QLINEAR_MODES:
        raise ValueError(f"mode {mode!r} not in {QLINEAR_MODES}")
    if backend not in QMATMUL_BACKENDS:
        raise ValueError(f"backend {backend!r} not in {QMATMUL_BACKENDS}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    return fmt_mod.get_format(m.fmt)


def launch_cut(rows: int, kb: int, *, act_quant: bool, e: int, n: int):
    """The cut the kernel path's launch takes for ``rows`` rows (per
    expert) of ``kb`` blocks against ``e`` experts of ``n`` columns: the
    matvec's rule for at most ``MATVEC_MAX_M`` rows, the tiled kernels'
    above (the float and int8 matvecs have rules of their own)."""
    if rows > MATVEC_MAX_M:
        return matmul_tiles(rows, n, kb, e)
    return (matvec_int8_tiles if act_quant else matvec_tiles)(rows, n, kb, e)


def qmatmul(x: torch.Tensor, qt: QTensor, *, mode: str = "activations",
            backend: str = "auto", act_quant: bool = False,
            cut_from=None) -> torch.Tensor:
    """``x (..., K) @ W_hat (K, N) -> (..., N)`` in f32. ``cut_from``: the
    (E, N) of the unsharded launch whose cut a shard takes."""
    m = qt.meta
    spec = _checked(x, qt, mode, backend)
    mode = resolve_mode(x, m, mode) if spec.supports_fused else "dequant"
    act = act_quant and spec.supports_fused and m.act_quant \
        and mode != "dequant"
    if backend == "ref" or mode == "dequant":
        if act:
            return spec.contract_int8(x, qt)
        return spec.contract(x, qt, mode=mode)
    return qmatmul_kernel(x, qt, mode=mode, act_quant=act, cut_from=cut_from)


def qmatmul_kernel(x: torch.Tensor, qt: QTensor, *,
                   mode: str = "activations",
                   act_quant: bool = False, cut_from=None) -> torch.Tensor:
    """Kernel-path ``x @ W_hat``:

    * ``act_quant``: rotate and int8-encode the rows in one launch (its
      kernel reads the unpadded rows), then the int8 matvec (M <= 16) or
      tiled kernel;
    * otherwise pad K to whole blocks, pre-scale by the sign diagonal
      (quip3), then the float matvec, which rotates x itself in
      activations mode, or the FWHT kernel (activations mode) and the
      tiled kernel."""
    lead = x.shape[:-1]
    x3 = x.reshape(1, -1, x.shape[-1])
    out = _contract(x3, qt, mode, act_quant, stacked=False,
                    cut_from=cut_from)
    return out.reshape(*lead, out.shape[-1])


def _contract(x3: torch.Tensor, qt: QTensor, mode: str, act_quant: bool, *,
              stacked: bool, cut_from=None) -> torch.Tensor:
    """The kernel path on ``x3 (E, rows, K)``: one matrix (E = 1, the
    wrappers given 2-D operands) or an expert stack (``stacked``, one
    expert-axis launch). Returns ``(E, rows, N)``, or ``(rows, N)`` for
    one matrix."""
    m = qt.meta
    e, rows = x3.shape[:2]
    x2 = x3.reshape(e * rows, x3.shape[-1]).to(torch.float32)
    dsign = qt.data.get("dsign")
    d = qt.data
    small = rows <= MATVEC_MAX_M
    if stacked and dsign is not None and dsign.dim() == 2 and m.rotate:
        # one sign diagonal per expert, (E, block), as the reference's
        # nested vmap stacks it: w_hat = D H v, so pre-scale each expert's
        # rows by its own D (a +-1 product: exact)
        xp = pad_last_dim(x2, m.block)
        x2 = (xp.reshape(e, rows, -1, m.block) * dsign.to(xp.dtype)[
            :, None, None, :]).reshape(e * rows, -1)
        dsign = None

    def operand(t):  # the wrappers' operand: (E, rows, ...) for a stack
        return t.reshape(e, rows, -1) if stacked else t

    cut = None
    if cut_from is not None:
        cut = launch_cut(rows, d["plane2"].shape[-2], act_quant=act_quant,
                         e=cut_from[0], n=cut_from[1])
    if act_quant:
        xq, xs = fwht_act_encode(x2.contiguous(), block=m.block,
                                 rotate=m.rotate, dsign=dsign)
        fn = itq3_matvec_int8 if small else itq3_matmul_int8
        return fn(operand(xq), operand(xs), d["plane2"], d["plane1"],
                  d["scales"], d["zps"], fivelevel=m.fivelevel,
                  sub_blocks=m.sub_blocks, cut=cut)
    xp = pad_last_dim(x2, m.block)
    rotate_weights = rotate_x = False
    if m.rotate:
        if dsign is not None:
            # w_hat = D H v  =>  y = v . (H D x): pre-scale x by D either way
            xp = (xp.reshape(xp.shape[0], -1, m.block)
                  * dsign.to(xp.dtype)).reshape(xp.shape)
        if mode == "activations":
            if small:
                rotate_x = True
            else:
                xp = fwht_kernels.fwht(xp.contiguous(), m.block)
        elif mode == "weights":
            rotate_weights = True
        else:
            raise ValueError(f"unknown kernel mode {mode!r}")
    xp = operand(xp).contiguous()
    planes = (d["plane2"], d["plane1"], d["scales"], d["zps"])
    kw = dict(rotate_weights=rotate_weights, fivelevel=m.fivelevel,
              sub_blocks=m.sub_blocks, cut=cut)
    return (itq3_matvec(xp, *planes, rotate_x=rotate_x, **kw) if small
            else itq3_matmul(xp, *planes, **kw))


def qmatmul_experts(x: torch.Tensor, qt: QTensor, *,
                    mode: str = "activations", backend: str = "auto",
                    act_quant: bool = False, cut_from=None) -> torch.Tensor:
    """Expert-batched ``x (E, M, K) @ W_hat_e (K, N) -> (E, M, N)`` in f32
    for a QTensor stacked ``(E, K, N)``. ``mode="auto"`` and the
    matvec/matmul choice look at one expert's M rows, as the reference's
    vmapped ``qmatmul`` does. ``cut_from``: the (E, N) of the unsharded
    stack whose cut an expert-parallel shard takes."""
    m = qt.meta
    spec = _checked(x, qt, mode, backend)
    e = x.shape[0]
    experts = next(v for k, v in qt.data.items() if k != "dsign").shape[0]
    if x.dim() != 3 or experts != e:
        raise ValueError(f"qmatmul_experts: x {tuple(x.shape)} against a "
                         f"stack of {experts} experts")
    mode = resolve_mode(x[0], m, mode) if spec.supports_fused else "dequant"
    act = act_quant and spec.supports_fused and m.act_quant \
        and mode != "dequant"
    if backend == "ref" or mode == "dequant":
        # the plain path: the per-matrix contraction, expert by expert
        def one(i):
            qe = qt.layer(i)
            return (spec.contract_int8(x[i], qe) if act
                    else spec.contract(x[i], qe, mode=mode))
        return torch.stack([one(i) for i in range(e)])
    return _contract(x, qt, mode, act, stacked=True, cut_from=cut_from)
