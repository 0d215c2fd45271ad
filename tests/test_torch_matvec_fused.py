"""The float decode matvec with the activation FWHT folded in, on the CPU.

``itq3_matvec(..., rotate_x=True)`` takes x unrotated (for quip3 already
scaled by its sign diagonal) and rotates it inside the kernel; on a CPU
tensor it runs its plain version, ``itq3_matmul_ref(fwht_ref(x))``. Here
it is held to that plain version bit for bit, and to the reference's
``blocked_fwht_op`` followed by ``itq3_matvec_pallas`` (interpret mode)
within rtol/atol 1e-5 (f32 on both sides, summed in another order: the
reference contracts against H on its MXU path), on planes the reference
quantizes from a numpy seed (the five ternary formats) and on codes the
port quantizes with seeded scales of 32 sub-blocks. Then ``qmatmul``'s
decode routing against the reference's ``qmatmul``, the matvec's tile
rule, and the wrapper's refusals. The CUDA kernel itself is held to
``fwht.cu`` followed by the unfused matvec, bit for bit, on the card
(the ``gpu``-marked test, and ``chip_smoke.py`` phase 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core.qlinear import qmatmul as jqmatmul
from repro.kernels.itq3_matvec import itq3_matvec_pallas
from repro.kernels.ops import blocked_fwht_op
from repro_torch.bridge import params_from_numpy
from repro_torch.core import formats as tformats
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.quantize import pad_last_dim
from repro_torch.kernels import _build
from repro_torch.kernels import fwht as tfwht
from repro_torch.kernels import itq3 as titq3
from test_torch_bridge import to_numpy_tree

FORMATS = ["iq3_s", "quip3", "itq3_s", "itq3_s_sub", "itq3_x"]
TOL = dict(rtol=1e-5, atol=1e-5)
PLANES = ("plane2", "plane1", "scales", "zps")
N = 24
MS = (1, 4, 16)
KBS = (1, 3, 6, 11)
# (M, KB) pairs held against the interpret-mode reference: every M and
# every KB once, so the slow interpret runs stay few
REF_CASES = ((1, 1), (4, 3), (16, 6), (4, 11))


@functools.lru_cache(maxsize=None)
def _ref_planes(fmt, kb):
    """A reference-quantized (KB*256, N) weight: its planes (bridged), its
    kwargs and its QTensor on both sides."""
    w = (np.random.default_rng(kb).standard_normal((kb * 256, N))
         / np.sqrt(kb * 256)).astype(np.float32)
    jqt = jax.jit(functools.partial(jformats.quantize, fmt=fmt))(
        jnp.asarray(w))
    tqt = params_from_numpy(to_numpy_tree(jqt), device="cpu")
    return (tuple(tqt.data[k] for k in PLANES),
            dict(fivelevel=tqt.meta.fivelevel,
                 sub_blocks=tqt.meta.sub_blocks), jqt, tqt)


@functools.lru_cache(maxsize=None)
def _sub32_planes(kb):
    """Codes of a port itq3_s_sub quantization of a (KB*256, N) weight
    with 32 seeded fp16 sub-block scales of the same magnitude."""
    w = torch.from_numpy((np.random.default_rng(100 + kb).standard_normal(
        (kb * 256, N)) / np.sqrt(kb * 256)).astype(np.float32))
    qt = tformats.quantize(w, "itq3_s_sub", sub_blocks=8)
    p2, p1, sc, zp = (qt.data[k] for k in PLANES)
    mag = sc.float().abs().mean().item()
    scales = torch.from_numpy(np.random.default_rng(kb).uniform(
        0.5 * mag, 1.5 * mag, size=(N, kb, 32)).astype(np.float16))
    return (p2, p1, scales, zp), dict(fivelevel=False, sub_blocks=32)


def _case(fmt, kb):
    """Planes and kwargs for a format name, or "sub32"."""
    if fmt == "sub32":
        return _sub32_planes(kb)
    return _ref_planes(fmt, kb)[:2]


def _x(m, kb, seed=0):
    return (np.random.default_rng(seed + 7 * m + kb)
            .standard_normal((m, kb * 256)).astype(np.float32))


@pytest.mark.parametrize("kb", KBS)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("fmt", FORMATS + ["sub32"])
def test_rotate_x_is_plain_fwht_then_matvec(fmt, m, kb):
    planes, kw = _case(fmt, kb)
    x = torch.from_numpy(_x(m, kb))
    got = titq3.itq3_matvec(x, *planes, rotate_weights=False, rotate_x=True,
                            **kw)
    want = titq3.itq3_matmul_ref(tfwht.fwht_ref(x), *planes,
                                 rotate_weights=False, **kw)
    assert torch.equal(got, want)
    # the unfused pair on the CPU: the FWHT wrapper, then the matvec
    pair = titq3.itq3_matvec(tfwht.fwht(x), *planes, rotate_weights=False,
                             **kw)
    assert torch.equal(got, pair)


@pytest.mark.parametrize("m,kb", REF_CASES)
@pytest.mark.parametrize("fmt", FORMATS + ["sub32"])
def test_rotate_x_matches_reference_fwht_then_matvec(fmt, m, kb):
    planes, kw = _case(fmt, kb)
    x = _x(m, kb, seed=1)
    got = titq3.itq3_matvec(torch.from_numpy(x), *planes,
                            rotate_weights=False, rotate_x=True, **kw)
    xr = blocked_fwht_op(jnp.asarray(x), 256, interpret=True)
    want = itq3_matvec_pallas(
        xr, *(jnp.asarray(p.numpy()) for p in planes), rotate_weights=False,
        interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("fmt", FORMATS)
def test_qmatmul_decode_routing_matches_reference(fmt, m, monkeypatch):
    """Activations mode at M <= 16, ``backend="auto"``: the port sends the
    unrotated rows to the fused matvec and calls no FWHT wrapper; the
    result agrees with the reference's kernel path (interpret mode)."""
    _, _, jqt, tqt = _ref_planes(fmt, 3)
    k = jqt.meta.shape[0]
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    calls = []
    real = tfwht.fwht
    monkeypatch.setattr(tfwht, "fwht",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tqlinear.qmatmul(torch.from_numpy(x), tqt, mode="activations",
                           backend="auto")
    assert not calls
    want = jax.jit(functools.partial(
        jqmatmul, mode="activations", backend="pallas",
        compute_dtype=jnp.float32, interpret=True))(jnp.asarray(x), jqt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bit-equal to the unfused route the prefill path still takes
    xp = pad_last_dim(torch.from_numpy(x), 256)
    dsign = tqt.data.get("dsign")
    if dsign is not None:
        xp = (xp.reshape(m, -1, 256) * dsign).reshape(xp.shape)
    if tqt.meta.rotate:
        xp = tfwht.fwht_ref(xp)
    planes = tuple(tqt.data[p] for p in PLANES)
    unfused = titq3.itq3_matvec(xp, *planes, rotate_weights=False,
                                fivelevel=tqt.meta.fivelevel,
                                sub_blocks=tqt.meta.sub_blocks)
    assert torch.equal(got, unfused)


@pytest.mark.parametrize("m", [1, 4, 5, 16])
def test_matvec_tiles_divide_kb_within_eight_warps(m):
    for kb in range(1, 65):
        for n in (29, 192, 576, 1536):
            features, splits = titq3.matvec_tiles(m, n, kb)
            assert features in titq3.MATVEC_INT8_FEATURES
            assert kb % splits == 0
            assert features // 8 * splits <= titq3.MATVEC_INT8_MAX_WARPS
            window = titq3.matvec_window(m, kb, features, splits)
            run = kb // splits
            assert 1 <= window <= run
            staged = (m * kb if window == run
                      else 2 * splits * m * window)
            sums = 4 * splits * features * m if splits > 1 else 0
            assert (staged * titq3.MATVEC_XBLOCK_BYTES + sums
                    <= titq3.MATVEC_INT8_SMEM)


def test_matvec_tiles_at_the_serving_shapes():
    # smollm-135m at M = 4: 8 features per block, one block of K per warp
    assert titq3.matvec_tiles(4, 576, 3) == (8, 3)
    assert titq3.matvec_tiles(4, 576, 6) == (8, 6)
    # x staged whole there; in windows where M x K does not fit
    assert titq3.matvec_window(4, 6, 8, 6) == 1
    assert titq3.matvec_window(16, 24, *titq3.matvec_tiles(16, 576, 24)) == 1
    assert titq3.matvec_tiles(16, 576, 24) == (8, 6)


def test_matvec_refuses_rotate_x_with_rotate_weights():
    planes, kw = _case("itq3_s", 1)
    with pytest.raises(ValueError, match="rotate_x"):
        titq3.itq3_matvec(torch.zeros(2, 256), *planes, rotate_weights=True,
                          rotate_x=True, **kw)
    with pytest.raises(ValueError, match="M <= 16"):
        titq3.itq3_matvec(torch.zeros(17, 256), *planes,
                          rotate_weights=False, rotate_x=True, **kw)
    _build.reset_launches()
    titq3.itq3_matvec(torch.zeros(2, 256), *planes, rotate_weights=False,
                      rotate_x=True, **kw)
    assert not _build.launches  # the CPU path launches nothing


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["itq3_s", "itq3_s_sub", "itq3_x"])
def test_cuda_fused_matvec_equals_fwht_then_matvec(fmt):
    """On the card: the fused kernel gives the bits of fwht.cu followed by
    the unfused kernel, and agrees with its plain version to 1e-4
    relative. Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    dev = torch.device("cuda")
    planes, kw = _case(fmt, 6)
    planes = tuple(p.to(dev) for p in planes)
    x = torch.from_numpy(_x(4, 6)).to(dev)
    got = titq3.itq3_matvec(x, *planes, rotate_weights=False, rotate_x=True,
                            **kw)
    pair = titq3.itq3_matvec(tfwht.fwht(x), *planes, rotate_weights=False,
                             **kw)
    assert torch.equal(got, pair)
    want = titq3.itq3_matmul_ref(tfwht.fwht_ref(x), *planes,
                                 rotate_weights=False, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()
