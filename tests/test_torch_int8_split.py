"""The W3A8 integer pair's split arithmetic, in its plain version.

``csrc/itq3_matmul_int8.cu`` and ``csrc/itq3_matvec_int8.cu`` contract int8
activation codes against the exact int8 ``wint = q - z``: exact int32
partials per block or sub-block (any divisor of 256), ``f32(P) * d`` added
in ascending K within each of ``splits`` runs of blocks, the runs' sums
added in ascending order, ``xscale`` once at the end.
``itq3_matmul_int8_split_ref`` is that arithmetic in plain PyTorch. Here
it is held against the plain version ``itq3_matmul_int8_ref`` (exactly
with unit scales, where every sum is an integer below 2**24; bit for bit
at one split; within 1e-6 of the largest output otherwise) and against
the reference's ``itq3_matvec_int8_pallas`` (M <= 16) and
``itq3_matmul_int8_pallas`` (M > 16) in interpret mode (exactly with unit
scales, the kernel tests' rtol/atol 1e-5 otherwise) at the cut the
wrappers pick, on planes the reference quantizes from a numpy seed
(itq3_s, itq3_s_sub, itq3_x) and on codes the port quantizes with
seeded scales of every other sub-block count. Then the matvec's tile rule, and the wrappers'
operand checks without a card: every divisor of 256 passes, a
non-divisor is refused. The kernels themselves are held to the split
model on the card (the ``gpu``-marked tests, and ``chip_smoke.py`` phase
3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.kernels.itq3_matmul import itq3_matmul_int8_pallas
from repro.kernels.itq3_matvec import itq3_matvec_int8_pallas
from repro_torch.bridge import params_from_numpy
from repro_torch.core import formats as tformats
from repro_torch.kernels import itq3 as titq3
from test_torch_bridge import to_numpy_tree

FORMATS = ["itq3_s", "itq3_s_sub", "itq3_x"]
DIVISORS = [1, 2, 4, 8, 16, 32, 64, 128, 256]
TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT_REL = 1e-6
PLANES = ("plane2", "plane1", "scales", "zps")
KB, N = 6, 24


@functools.lru_cache(maxsize=None)
def _ref_planes(fmt):
    """A reference-quantized (KB*256, N) weight's planes, bridged, and its
    kwargs."""
    w = (np.random.default_rng(17).standard_normal((KB * 256, N))
         / np.sqrt(KB * 256)).astype(np.float32)
    jqt = jax.jit(functools.partial(jformats.quantize, fmt=fmt))(
        jnp.asarray(w))
    qt = params_from_numpy(to_numpy_tree(jqt), device="cpu")
    return (tuple(qt.data[k] for k in PLANES),
            dict(fivelevel=qt.meta.fivelevel, sub_blocks=qt.meta.sub_blocks))


@functools.lru_cache(maxsize=None)
def _port_planes(sub):
    """Planes of a (KB*256, N) weight the port quantizes to itq3_s (sub 0)
    or itq3_s_sub, with ``sub`` seeded fp16 sub-block scales of the same
    magnitude: sub-blocks of one element leave a quantizer nothing to
    scale (every code 0), so the codes come from its 8-sub-block run and
    the scales take each count. Returns the planes and their kwargs."""
    w = torch.from_numpy((np.random.default_rng(sub).standard_normal(
        (KB * 256, N)) / np.sqrt(KB * 256)).astype(np.float32))
    if not sub:
        qt = tformats.quantize(w, "itq3_s")
        return (tuple(qt.data[k] for k in PLANES),
                dict(fivelevel=False, sub_blocks=0))
    qt = tformats.quantize(w, "itq3_s_sub", sub_blocks=8)
    p2, p1, sc, zp = (qt.data[k] for k in PLANES)
    mag = sc.float().abs().mean().item()
    scales = torch.from_numpy(np.random.default_rng(sub + 1).uniform(
        0.5 * mag, 1.5 * mag, size=(N, KB, sub)).astype(np.float16))
    return (p2, p1, scales, zp), dict(fivelevel=False, sub_blocks=sub)


def _case(case):
    return _ref_planes(case) if isinstance(case, str) else _port_planes(case)


def _codes(m, kb=KB, seed=0):
    """Seeded int8 codes over the full range and positive row scales."""
    rng = np.random.default_rng(seed + 100 * m)
    xq = rng.integers(-127, 128, size=(m, kb * 256)).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, size=(m, 1)).astype(np.float32)
    return torch.from_numpy(xq), torch.from_numpy(xs)


def _unit(planes, xs):
    p2, p1, sc, zp = planes
    return (p2, p1, torch.ones_like(sc), zp), torch.ones_like(xs)


def _splits(kb):
    """Every count that cuts KB blocks into equal runs, none empty."""
    return sorted({-(-kb // -(-kb // s)) for s in range(1, kb + 1)})


@pytest.mark.parametrize("sub", [0] + DIVISORS)
def test_split_ref_unit_scales_exact(sub):
    planes, kw = _port_planes(sub)
    xq, xs = _codes(20)
    uplanes, uxs = _unit(planes, xs)
    want = titq3.itq3_matmul_int8_ref(xq, uxs, *uplanes, **kw)
    assert torch.equal(want, torch.round(want)) and want.abs().max() > 0
    for splits in _splits(KB):
        got = titq3.itq3_matmul_int8_split_ref(xq, uxs, *uplanes,
                                               splits=splits, **kw)
        assert torch.equal(got, want), splits


@pytest.mark.parametrize("case", FORMATS + [1, 16, 256])
def test_split_ref_one_split_is_plain(case):
    planes, kw = _case(case)
    xq, xs = _codes(7)
    got = titq3.itq3_matmul_int8_split_ref(xq, xs, *planes, splits=1, **kw)
    want = titq3.itq3_matmul_int8_ref(xq, xs, *planes, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("splits", [2, 3, 6])
@pytest.mark.parametrize("case", FORMATS + [2, 32, 128])
def test_split_ref_matches_plain(case, splits):
    planes, kw = _case(case)
    xq, xs = _codes(33)
    want = titq3.itq3_matmul_int8_ref(xq, xs, *planes, **kw)
    got = titq3.itq3_matmul_int8_split_ref(xq, xs, *planes, splits=splits,
                                           **kw)
    err = (got - want).abs().max().item()
    assert err <= SPLIT_REL * want.abs().max().item(), (splits, err)


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("case", FORMATS + [1, 2, 16, 32, 64, 128, 256])
def test_split_ref_matches_pallas(case, m, unit):
    """At the cut the wrapper would launch: the matvec's for M = 4, the
    tiled kernel's for M = 40 (three blocks, so both cut K)."""
    planes, kw = _case(case)
    planes = tuple(p[:, :3].contiguous() for p in planes)
    xq, xs = _codes(m, kb=3, seed=5)
    if unit:
        planes, xs = _unit(planes, xs)
    rule = titq3.matvec_int8_tiles if m <= 16 else titq3.matmul_tiles
    splits = rule(m, N, 3)[1]
    assert splits > 1
    got = titq3.itq3_matmul_int8_split_ref(xq, xs, *planes, splits=splits,
                                           **kw)
    pallas = itq3_matvec_int8_pallas if m <= 16 else itq3_matmul_int8_pallas
    want = np.asarray(pallas(jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy()),
                             *(jnp.asarray(p.numpy()) for p in planes),
                             interpret=True, **kw))
    if unit:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# phase 3's four serving shapes (M = 4 rows of a decode step) and the cut
# the sweep chose for each (8 features, as many splits as blocks); then
# ragged ones, qwen1.5-0.5b's d_ff of 11 blocks among them
TILE_CASES = [((4, 576, 3), (8, 3)), ((4, 192, 3), (8, 3)),
              ((4, 1536, 3), (8, 3)), ((4, 576, 6), (8, 6)),
              ((1, 24, 1), (8, 1)), ((16, 2816, 11), (8, 1)),
              ((3, 100, 12), (8, 6)), ((16, 24, 8), (8, 8)),
              ((7, 3000, 16), (8, 8))]


@pytest.mark.parametrize("shape,cut", TILE_CASES)
def test_matvec_int8_tiles_rule(shape, cut):
    """The cut is static; its splits divide KB, stay within the block's
    warps and the portable cluster size, and the block's shared memory
    holds the codes and the splits' sums."""
    m, n, kb = shape
    features, splits = titq3.matvec_int8_tiles(m, n, kb)
    assert (features, splits) == cut
    assert features in titq3.MATVEC_INT8_FEATURES and kb % splits == 0
    assert splits <= titq3.MATMUL_MAX_SPLITS
    assert features // 8 * splits <= titq3.MATVEC_INT8_MAX_WARPS
    assert titq3._matvec_int8_smem(m, kb, features, splits) \
        <= titq3.MATVEC_INT8_SMEM


def _synthetic(sub, m, kb=2, n=8):
    """Zero planes of any sub-block count, and codes: shapes only."""
    shape = (n, kb, sub) if sub else (n, kb)
    return ((torch.zeros(m, kb * 256, dtype=torch.int8), torch.ones(m, 1)),
            (torch.zeros(n, kb, 64, dtype=torch.uint8),
             torch.zeros(n, kb, 32, dtype=torch.uint8),
             torch.ones(shape, dtype=torch.float16),
             torch.zeros(n, kb, dtype=torch.float16)))


@pytest.mark.parametrize("sub", [0] + DIVISORS)
@pytest.mark.parametrize("m", [4, 40])
def test_int8_wrappers_take_every_divisor(sub, m):
    """Without a card: on the CPU the wrapper gives the plain version; on
    the meta device it passes every operand check and stops only at the
    device, so nothing in it refuses a sub-block count the reference
    serves."""
    fn = titq3.itq3_matvec_int8 if m <= 16 else titq3.itq3_matmul_int8
    planes, kw = _port_planes(sub)
    xq, xs = _codes(m)
    assert torch.equal(fn(xq, xs, *planes, **kw),
                       titq3.itq3_matmul_int8_ref(xq, xs, *planes, **kw))
    (zq, zs), zplanes = _synthetic(sub, m)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(zq.to("meta"), zs.to("meta"), *(p.to("meta") for p in zplanes),
           sub_blocks=sub)


@pytest.mark.parametrize("sub", [3, 96, 512])
@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_int8_wrappers_refuse_non_divisor(sub, m, device):
    fn = titq3.itq3_matvec_int8 if m <= 16 else titq3.itq3_matmul_int8
    (zq, zs), zplanes = _synthetic(sub, m)
    with pytest.raises(ValueError, match="must divide 256"):
        fn(zq.to(device), zs.to(device), *(p.to(device) for p in zplanes),
           sub_blocks=sub)


def test_matvec_int8_refuses_codes_past_shared_memory():
    (zq, zs), zplanes = _synthetic(0, 16, kb=64)
    with pytest.raises(ValueError, match="shared memory"):
        titq3.itq3_matvec_int8(zq.to("meta"), zs.to("meta"),
                               *(p.to("meta") for p in zplanes))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 40])
def test_cuda_qmatmul_act_quant_sub16(m):
    """On the card: qmatmul's W3A8 path on an itq3_s_sub leaf with 16
    sub-blocks (a mixed policy's ``QuantRule(..., sub_blocks=16)``)
    launches the int8 kernel and gives the split model's bits on the codes
    it encodes. Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    from repro_torch.core.qlinear import qmatmul
    from repro_torch.kernels import _build, fwht as tfwht

    dev = torch.device("cuda")
    w = torch.from_numpy((np.random.default_rng(16).standard_normal(
        (KB * 256, 192)) / np.sqrt(KB * 256)).astype(np.float32)).to(dev)
    qt = tformats.quantize(w, "itq3_s_sub", sub_blocks=16)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, KB * 256)).astype(np.float32)).to(dev)
    name = "itq3_matvec_int8" if m <= 16 else "itq3_matmul_int8"
    before = _build.launches[name]
    got = qmatmul(x, qt, act_quant=True)
    assert _build.launches[name] == before + 1
    xq, xs = tfwht.fwht_act_encode(x)
    planes = tuple(qt.data[k] for k in PLANES)
    rule = titq3.matvec_int8_tiles if m <= 16 else titq3.matmul_tiles
    want = titq3.itq3_matmul_int8_split_ref(
        xq, xs, *planes, sub_blocks=16, splits=rule(m, 192, KB)[1])
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got, titq3.itq3_matmul_int8_ref(xq, xs, *planes, sub_blocks=16),
        rtol=1e-5, atol=1e-5)
