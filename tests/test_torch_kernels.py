"""The port's kernel wrappers vs the reference's Pallas kernels, run in
interpret mode on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; that
is what is held here against ``fwht_pallas``, ``itq3_matvec_pallas`` /
``itq3_matmul_pallas``, their int8 variants, ``attn_q8_pallas`` and
``quantize_blocks_pallas``. The hand-written CUDA
kernels themselves are held against the same plain versions on the card
(the ``gpu``-marked test below, and ``chip_smoke.py``). Tolerance: rtol
1e-5, atol 1e-5 — f32 on both sides, summed in another order (the Pallas
kernels contract against H on the MXU path, the port runs the butterfly).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.kernels.attn_decode import attn_q8_pallas
from repro.kernels.fwht_kernel import fwht_pallas
from repro.core.act_quant import act_encode as jact_encode
from repro.core.packing import unpack_codes as junpack_codes
from repro.core.quantize import quantize_blocks_ternary as jquantize_blocks
from repro.kernels.itq3_matmul import (
    itq3_matmul_int8_pallas, itq3_matmul_pallas,
)
from repro.kernels.itq3_matvec import (
    itq3_matvec_int8_pallas, itq3_matvec_pallas,
)
from repro.kernels.quantize_kernel import quantize_blocks_pallas
from repro_torch.bridge import params_from_numpy
from repro_torch.core import formats as tformats
from repro_torch.core import quantize as tcore_quantize
from repro_torch.core.quantize import pad_last_dim
from repro_torch.kernels import _build, attn_q8 as tattn, fwht as tfwht
from repro_torch.kernels import itq3 as titq3
from repro_torch.kernels import quantize as tquantize
from test_torch_bridge import to_numpy_tree

FORMATS = ["iq3_s", "quip3", "itq3_s", "itq3_s_sub", "itq3_x"]
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _planes(fmt, k=300, n=24):
    """JAX-quantized (K, N) weights (K ragged) and their bridged planes."""
    w = (np.random.default_rng(3).standard_normal((k, n))
         / np.sqrt(k)).astype(np.float32)
    jqt = jax.jit(functools.partial(jformats.quantize, fmt=fmt))(
        jnp.asarray(w))
    return jqt, params_from_numpy(to_numpy_tree(jqt), device="cpu")


def test_fwht_matches_pallas(rng):
    x = rng.standard_normal((5, 512)).astype(np.float32)
    want = fwht_pallas(jnp.asarray(x), interpret=True)
    got = tfwht.fwht(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tfwht.fwht(got).numpy(), x, **TOL)


@pytest.mark.parametrize("block", [32, 64, 128, 256])
def test_fwht_block_sizes_match_plain_butterfly(block, rng):
    x = torch.from_numpy(rng.standard_normal((3, 512)).astype(np.float32))
    np.testing.assert_array_equal(tfwht.fwht(x, block).numpy(),
                                  tfwht.fwht_ref(x, block).numpy())


@pytest.mark.parametrize("m", [1, 3, 16, 40])
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_itq3_contraction_matches_pallas(fmt, rotate, m, rng):
    """M <= 16 -> matvec kernel, M > 16 -> tiled kernel, as qmatmul
    dispatches; x already padded to KB*256 like the kernel path pads it."""
    jqt, tqt = _planes(fmt)
    meta, jd, td = jqt.meta, jqt.data, tqt.data
    x = pad_last_dim(torch.from_numpy(
        rng.standard_normal((m, meta.k)).astype(np.float32)), 256)
    pallas = itq3_matvec_pallas if m <= 16 else itq3_matmul_pallas
    want = pallas(jnp.asarray(x.numpy()), jd["plane2"], jd["plane1"],
                  jd["scales"], jd["zps"], rotate_weights=rotate,
                  fivelevel=meta.fivelevel, sub_blocks=meta.sub_blocks,
                  interpret=True)
    port = titq3.itq3_matvec if m <= 16 else titq3.itq3_matmul
    got = port(x, td["plane2"], td["plane1"], td["scales"], td["zps"],
               rotate_weights=rotate, fivelevel=meta.fivelevel,
               sub_blocks=meta.sub_blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _attn_inputs(rng, tq, g=2, hd=32, t=40):
    r = 3
    q = rng.standard_normal((r, tq, g, hd)).astype(np.float32)
    kc = rng.integers(-127, 128, (r, t, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (r, t, hd)).astype(np.int8)
    ks = (rng.random((r, t)) * 0.05 + 1e-3).astype(np.float16)
    vs = (rng.random((r, t)) * 0.05 + 1e-3).astype(np.float16)
    kv_len = np.array([0, 17, t], np.int32)  # an empty row, ragged rows
    q_offset = (np.array([0, 12, t - tq], np.int32) if tq > 1
                else np.zeros(r, np.int32))
    return q, kc, ks, vc, vs, kv_len, q_offset


@pytest.mark.parametrize("tq,causal", [(1, False), (5, True), (5, False)])
def test_attn_q8_matches_pallas(tq, causal, rng):
    args = _attn_inputs(rng, tq)
    sm_scale = 32 ** -0.5
    want = attn_q8_pallas(*map(jnp.asarray, args), sm_scale=sm_scale,
                          causal=causal, tq=tq, tt=16, interpret=True)
    got = tattn.attn_q8(*map(torch.from_numpy, args), sm_scale=sm_scale,
                        causal=causal)
    for name, a, b in zip(("acc", "m", "l"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    # the empty row: m = -1e30 and l = 0 exactly, never -inf or NaN
    assert (got[1][0] == -1e30).all() and (got[2][0] == 0).all()
    assert (got[0][0] == 0).all()


def test_wrappers_refuse_bad_operands():
    _, tqt = _planes("itq3_s")
    d = tqt.data
    with pytest.raises(ValueError, match="M <= 16"):
        titq3.itq3_matvec(torch.zeros(17, 512), d["plane2"], d["plane1"],
                          d["scales"], d["zps"], rotate_weights=False)
    with pytest.raises(ValueError, match="KB"):
        titq3.itq3_matmul(torch.zeros(20, 300), d["plane2"], d["plane1"],
                          d["scales"], d["zps"], rotate_weights=False)
    with pytest.raises(ValueError, match="2-D"):
        tfwht.fwht(torch.zeros(2, 2, 256))
    with pytest.raises(ValueError, match="block"):
        tfwht.fwht(torch.zeros(2, 256), block=512)
    n, kb, w = d["plane2"].shape
    strided = torch.empty(kb, n, w, dtype=torch.uint8).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        titq3.itq3_matvec(torch.zeros(2, 512), strided.copy_(d["plane2"]),
                          d["plane1"], d["scales"], d["zps"],
                          rotate_weights=False)
    with pytest.raises(ValueError, match="dtype"):
        titq3.itq3_matvec(torch.zeros(2, 512), d["plane2"], d["plane1"],
                          d["scales"].float(), d["zps"],
                          rotate_weights=False)
    args = [torch.from_numpy(a) for a in _attn_inputs(
        np.random.default_rng(0), 1, hd=48)]
    with pytest.raises(ValueError, match="head_dim"):
        tattn.attn_q8(*args, sm_scale=1.0, causal=False)


def test_plain_path_counts_no_launches(rng):
    _build.reset_launches()
    tfwht.fwht(torch.zeros(2, 256))
    _, tqt = _planes("itq3_s")
    d = tqt.data
    titq3.itq3_matvec(torch.zeros(2, 512), d["plane2"], d["plane1"],
                      d["scales"], d["zps"], rotate_weights=False)
    assert sum(_build.launches.values()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("rotate", [False, True])
def test_cuda_kernels_match_plain_versions(rotate, rng):
    """On the card: each kernel against its plain version (1e-4 relative:
    f32 in another summation order). Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    dev = torch.device("cuda")
    _, tqt = _planes("itq3_x")
    d = {k: v.to(dev) for k, v in tqt.data.items()}
    for m, fn in ((4, titq3.itq3_matvec), (40, titq3.itq3_matmul)):
        x = torch.randn(m, 512, device=dev)
        got = fn(x, d["plane2"], d["plane1"], d["scales"], d["zps"],
                 rotate_weights=rotate, fivelevel=True)
        want = titq3.itq3_matmul_ref(x, d["plane2"], d["plane1"],
                                     d["scales"], d["zps"],
                                     rotate_weights=rotate, fivelevel=True)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    x = torch.randn(7, 768, device=dev)
    torch.testing.assert_close(tfwht.fwht(x), tfwht.fwht_ref(x))
    args = [torch.from_numpy(a).to(dev) for a in _attn_inputs(rng, 5)]
    for a, b in zip(tattn.attn_q8(*args, sm_scale=0.2, causal=True),
                    tattn.attn_q8_ref(*args, sm_scale=0.2, causal=True)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()


# --- the W3A8 int8 pair and the offline quantizer ----------------------------

def _int8_operands(fmt, m, rng, *, unit=False):
    """Reference-encoded activation codes for ``m`` rows and the planes,
    on both sides; ``unit`` sets every d and xscale to 1."""
    jqt, tqt = _planes(fmt)
    meta = jqt.meta
    x = rng.standard_normal((m, meta.kb * 256)).astype(np.float32)
    xq, xs = jax.jit(functools.partial(
        jact_encode, rotate=meta.rotate))(jnp.asarray(x),
                                          dsign=jqt.data.get("dsign"))
    xq, xs = np.asarray(xq), np.asarray(xs)
    scales = np.array(jqt.data["scales"])
    if unit:
        xs, scales = np.ones_like(xs), np.ones_like(scales)
    jd = dict(jqt.data, scales=jnp.asarray(scales))
    td = dict(tqt.data, scales=torch.from_numpy(scales))
    return meta, (xq, xs), jd, td


@pytest.mark.parametrize("m", [1, 16, 40])
@pytest.mark.parametrize("fmt", FORMATS)
def test_itq3_int8_contraction_matches_pallas(fmt, m, rng):
    """M <= 16 -> int8 matvec, larger M -> int8 tiled kernel; both
    ``rtol 1e-5`` of the Pallas kernels: the integer partials are exact on
    both sides, and only the f32 sum of the scaled partials differs in
    order."""
    meta, (xq, xs), jd, td = _int8_operands(fmt, m, rng)
    kw = dict(fivelevel=meta.fivelevel, sub_blocks=meta.sub_blocks)
    pallas = itq3_matvec_int8_pallas if m <= 16 else itq3_matmul_int8_pallas
    want = pallas(jnp.asarray(xq), jnp.asarray(xs), jd["plane2"],
                  jd["plane1"], jd["scales"], jd["zps"], **kw,
                  interpret=True)
    port = titq3.itq3_matvec_int8 if m <= 16 else titq3.itq3_matmul_int8
    got = port(torch.from_numpy(xq), torch.from_numpy(xs), td["plane2"],
               td["plane1"], td["scales"], td["zps"], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fmt", ["itq3_s", "itq3_s_sub", "itq3_x"])
def test_itq3_int8_unit_scales_exact_against_pallas(fmt, rng):
    """With d = 1 and xscale = 1 every output is an integer below 2**24:
    port and Pallas must agree exactly."""
    meta, (xq, xs), jd, td = _int8_operands(fmt, 20, rng, unit=True)
    kw = dict(fivelevel=meta.fivelevel, sub_blocks=meta.sub_blocks)
    want = np.asarray(itq3_matmul_int8_pallas(
        jnp.asarray(xq), jnp.asarray(xs), jd["plane2"], jd["plane1"],
        jd["scales"], jd["zps"], **kw, interpret=True))
    got = titq3.itq3_matmul_int8(
        torch.from_numpy(xq), torch.from_numpy(xs), td["plane2"],
        td["plane1"], td["scales"], td["zps"], **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got, np.round(got)) and np.abs(got).max() > 0


def test_int8_wrappers_refuse_bad_operands():
    _, tqt = _planes("itq3_s")
    d = tqt.data
    xq, xs = torch.zeros(2, 512, dtype=torch.int8), torch.ones(2, 1)
    args = (d["plane2"], d["plane1"], d["scales"], d["zps"])
    with pytest.raises(ValueError, match="dtype"):
        titq3.itq3_matvec_int8(xq.float(), xs, *args)
    with pytest.raises(ValueError, match="xscale"):
        titq3.itq3_matvec_int8(xq, torch.ones(2), *args)
    with pytest.raises(ValueError, match="M <= 16"):
        titq3.itq3_matvec_int8(torch.zeros(17, 512, dtype=torch.int8),
                               torch.ones(17, 1), *args)
    with pytest.raises(ValueError, match="KB"):
        titq3.itq3_matmul_int8(torch.zeros(20, 256, dtype=torch.int8),
                               torch.ones(20, 1), *args)
    with pytest.raises(ValueError, match="unsupported device"):
        titq3.itq3_matmul_int8(xq.to("meta"), xs.to("meta"),
                               *(a.to("meta") for a in args))


def test_quantize_blocks_matches_pallas(rng):
    """The reference's own contract for its TPU kernel
    (tests/test_kernels.py): d within rtol 1e-3, z equal, codes equal on
    more than 0.999 of the elements (f16-grid rounding ties only)."""
    wb = (rng.standard_t(df=4, size=(40, 256)) * 0.05).astype(np.float32)
    ck, dk, zk = quantize_blocks_pallas(jnp.asarray(wb), rule="paper", tm=8)
    cp, dp, zp = tquantize.quantize_blocks(torch.from_numpy(wb))
    assert cp.dtype == torch.uint8 and dp.dtype == zp.dtype == torch.float16
    np.testing.assert_allclose(dp.float().numpy(),
                               np.asarray(dk, np.float32), rtol=1e-3)
    np.testing.assert_array_equal(zp.numpy(), np.asarray(zk))
    assert np.mean(cp.numpy() == np.asarray(ck)) > 0.999
    assert set(np.unique(cp.numpy())) <= {0, 1, 2}


@pytest.mark.parametrize("rule", ["paper", "lloyd"])
def test_quantize_blocks_matches_reference_algorithm1(rule, rng):
    """The plain version equals the reference's Algorithm 1 (codes, d and
    z) for the blocks the kernel covers, except at rounding ties."""
    wb = (rng.standard_normal((64, 256)) * 0.03).astype(np.float32)
    cp, dp, zp = tquantize.quantize_blocks(torch.from_numpy(wb), rule=rule)
    ref = jax.jit(functools.partial(jquantize_blocks, rule=rule))(
        jnp.asarray(wb))
    codes = np.asarray(junpack_codes(ref["plane2"], ref["plane1"])) & 0x3
    assert np.mean(cp.numpy() == codes) > 0.999
    np.testing.assert_array_equal(dp.numpy(), np.asarray(ref["scales"]))
    np.testing.assert_array_equal(zp.numpy(), np.asarray(ref["zps"]))


@pytest.mark.parametrize("rule", ["paper", "lloyd"])
def test_quantize_blocks_route_packs_like_plain_algorithm1(rule, rng):
    """``itq3_s`` through the ``quantize_blocks`` wrapper stores exactly the
    planes, scales and zero-points of the port's plain Algorithm 1
    (``quantize_blocks_ternary``): one set of formulas, one packing."""
    wb = torch.from_numpy(
        (rng.standard_normal((3, 40, 256)) * 0.03).astype(np.float32))
    fused = tformats._quantize_blocks_fused(wb, rule)
    plain = tcore_quantize.quantize_blocks_ternary(wb, rotate=True, rule=rule)
    assert fused.keys() == plain.keys()
    for k in plain:
        assert fused[k].dtype == plain[k].dtype, k
        assert torch.equal(fused[k], plain[k]), k


def test_quantize_blocks_refuses_bad_operands():
    with pytest.raises(ValueError, match="blocks"):
        tquantize.quantize_blocks(torch.zeros(4, 128))
    with pytest.raises(ValueError, match="dtype"):
        tquantize.quantize_blocks(torch.zeros(4, 256, dtype=torch.float64))
    with pytest.raises(ValueError, match="scale rule"):
        tquantize.quantize_blocks(torch.zeros(4, 256), rule="nope")


def test_new_plain_paths_count_no_launches(rng):
    _build.reset_launches()
    tquantize.quantize_blocks(torch.zeros(3, 256))
    _, tqt = _planes("itq3_s")
    d = tqt.data
    for m in (2, 20):
        fn = titq3.itq3_matvec_int8 if m <= 16 else titq3.itq3_matmul_int8
        fn(torch.zeros(m, 512, dtype=torch.int8), torch.ones(m, 1),
           d["plane2"], d["plane1"], d["scales"], d["zps"])
    assert sum(_build.launches.values()) == 0
    assert set(_build.SOURCES) >= {"itq3_matvec_int8", "itq3_matmul_int8",
                                   "quantize_blocks"}


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["itq3_s", "itq3_s_sub", "itq3_x"])
def test_cuda_int8_and_quantize_kernels_match_plain_versions(fmt, rng,
                                                            monkeypatch):
    """On the card: the int8 kernels equal their plain versions exactly at
    unit scales and to 1e-5 relative otherwise, and give the bits of the
    split model at their own cut and at a forced two-way split of K, also
    with 16 and 32 sub-blocks (itq3_s_sub's codes, seeded scales);
    quantize_blocks within the reference's tie tolerance. Skips where
    there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    dev = torch.device("cuda")
    kernels = ((4, titq3.itq3_matvec_int8, "matvec_int8_tiles"),
               (40, titq3.itq3_matmul_int8, "matmul_tiles"))

    def check(a, kw, unit):
        n, kb = a[2].shape[:2]
        for m, fn, rule in kernels:
            am = (a[0][:m], a[1][:m]) + a[2:]
            got, want = fn(*am, **kw), titq3.itq3_matmul_int8_ref(*am, **kw)
            if unit:
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            own = getattr(titq3, rule)
            for cut in (own(m, n, kb), (own(m, n, kb)[0], 2)):
                monkeypatch.setattr(titq3, rule, lambda *_, c=cut: c)
                assert torch.equal(fn(*am, **kw),
                                   titq3.itq3_matmul_int8_split_ref(
                                       *am, splits=cut[1], **kw)), (m, cut)
                monkeypatch.setattr(titq3, rule, own)

    for unit in (True, False):
        meta, (xq, xs), _, td = _int8_operands(fmt, 40, rng, unit=unit)
        kw = dict(fivelevel=meta.fivelevel, sub_blocks=meta.sub_blocks)
        d = {k: v.to(dev) for k, v in td.items()}
        a = (torch.from_numpy(xq).to(dev), torch.from_numpy(xs).to(dev),
             d["plane2"], d["plane1"], d["scales"], d["zps"])
        check(a, kw, unit)
        if fmt == "itq3_s_sub" and not unit:
            n, kb = d["plane2"].shape[:2]
            for sub in (16, 32):
                sc = torch.from_numpy(rng.uniform(0.01, 0.03, size=(
                    n, kb, sub)).astype(np.float16)).to(dev)
                check(a[:4] + (sc, a[5]), dict(kw, sub_blocks=sub), False)
    wb = torch.randn(999, 256, device=dev) * 0.05
    (ck, dk, zk), (cp, dp, zp) = (tquantize.quantize_blocks(wb),
                                  tquantize.quantize_blocks_ref(wb))
    assert torch.equal(zk, zp) and (ck == cp).float().mean() > 0.999
    torch.testing.assert_close(dk.float(), dp.float(), rtol=1e-3, atol=0)
    torch.cuda.synchronize()
