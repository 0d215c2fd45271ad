"""The tensor-core matmul's split arithmetic, in its plain version.

``csrc/itq3_matmul.cu`` contracts on the TF32 tensor cores at f32
accuracy: x is split into TF32 hi/lo halves, the weight operand is exact in
TF32 in activations mode (``wint = q - z`` with ``d`` on each block's
partial, or ``d_sub * q``), weights mode splits the IFWHT'd weight too and
sums three products, and K may be cut into splits added in ascending
order. ``itq3_matmul_split_ref`` is that math in plain PyTorch. Here it is
held against the plain version ``itq3_matmul_ref`` (1e-6 of the largest
output: the model's dropped terms, the rounding of ``x_lo`` and ``x_lo *
w_lo``, are ~2^-22 relative; the rest is the plain version's own f32
rounding) and against the reference's ``itq3_matmul_pallas`` in interpret
mode (the kernel tests' rtol/atol 1e-5), for all five formats, both
modes, M in {1, 17, 40, 256}, N in {24, 192} and KB in {1, 3, 6} (shapes
that take every value), on planes quantized by the reference from a
numpy seed, and for sub-block counts from 1 to 256 on planes the port
quantizes. The premise of the activations-mode design, that the staged
weight operand equals its own TF32 rounding, is asserted for every
format. The kernel itself is held to the plain version on the card (the
``gpu``-marked test, and ``chip_smoke.py`` phase 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.kernels.itq3_matmul import itq3_matmul_pallas
from repro.kernels.ref import itq3_matmul_ref as jitq3_matmul_ref
from repro_torch.bridge import params_from_numpy
from repro_torch.core import formats as tformats
from repro_torch.core.quantize import decode_values
from repro_torch.kernels import itq3 as titq3
from test_torch_bridge import to_numpy_tree

FORMATS = ["iq3_s", "quip3", "itq3_s", "itq3_s_sub", "itq3_x"]
TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT_REL = 1e-6
KERNEL_REL = 1e-4


PLANES = ("plane2", "plane1", "scales", "zps")


@functools.lru_cache(maxsize=None)
def _quantized(fmt):
    """A reference-quantized (6*256, 192) weight, bridged to the port."""
    w = (np.random.default_rng(6).standard_normal((6 * 256, 192))
         / np.sqrt(6 * 256)).astype(np.float32)
    jqt = jax.jit(functools.partial(jformats.quantize, fmt=fmt))(
        jnp.asarray(w))
    return params_from_numpy(to_numpy_tree(jqt), device="cpu")


def _planes(fmt, kb, n):
    """The planes of the first N output features and KB blocks of that
    weight (each block is quantized on its own, so they are the planes of
    a (KB*256, N) weight), and its meta."""
    qt = _quantized(fmt)
    return (tuple(qt.data[k][:n, :kb].contiguous() for k in PLANES),
            qt.meta)


def _x(m, kb, seed=0):
    return np.random.default_rng(seed + m).standard_normal(
        (m, kb * 256)).astype(np.float32)


def _kw(meta, rotate):
    return dict(rotate_weights=rotate, fivelevel=meta.fivelevel,
                sub_blocks=meta.sub_blocks)


def _planes_of(qt):
    return tuple(qt.data[k] for k in PLANES)


def _jnp(planes):
    return tuple(jnp.asarray(p.numpy()) for p in planes)


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    half_ulp = 2.0 ** -11  # TF32 keeps 10 bits after the point
    vals = torch.tensor([one + half_ulp, -(one + half_ulp),
                         one + half_ulp - 2.0 ** -23, one + 3 * half_ulp,
                         0.0, 3.0, 2.0 ** -126], dtype=torch.float32)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                         one + 4 * half_ulp, 0.0, 3.0, 2.0 ** -126],
                        dtype=torch.float32)
    assert torch.equal(titq3.tf32_round(vals), want)
    x = torch.from_numpy(_x(64, 1))
    hi = titq3.tf32_round(x)
    assert torch.equal(titq3.tf32_round(hi), hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_staged_operand_exact_in_tf32(fmt):
    """Design point 1: in activations mode the weight operand the kernel
    stages (wint = q - z, or d_sub * q) equals its own TF32 rounding, so
    only x needs a split; and it is the grid value it claims to be."""
    for kb, n in ((1, 24), (6, 192)):
        (p2, p1, sc, zp), meta = _planes(fmt, kb, n)
        w, d = titq3.matmul_operand(p2, p1, sc, zp, **_kw(meta, False))
        assert torch.equal(titq3.tf32_round(w), w)
        q = decode_values(p2, p1, fivelevel=meta.fivelevel).float()
        if meta.sub_blocks:
            dsub = torch.repeat_interleave(sc.float(), 256 // meta.sub_blocks,
                                           dim=-1)
            assert torch.equal(w, dsub * q)
            assert torch.equal(d, torch.ones_like(d))
        else:
            assert torch.equal(w, q - zp.float()[..., None])
            assert torch.equal(d, sc.float())
            assert w.abs().max() <= (4 if meta.fivelevel else 2)
    # why d stays on the partial: an fp16 d with all 11 bits set times
    # q - z = 3 needs 12 significant bits, more than TF32 keeps
    folded = torch.tensor([(1 + 2.0 ** -10) * 3], dtype=torch.float32)
    assert not torch.equal(titq3.tf32_round(folded), folded)


# (M, N, KB): every M, N and KB of the grid, M = 256 the rows of a
# serving prefill wave
SHAPES = [(1, 24, 3), (1, 192, 1), (17, 192, 6), (40, 24, 1), (256, 192, 3),
          (256, 24, 6)]


@pytest.mark.parametrize("m,n,kb", SHAPES)
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_split_matches_plain(fmt, rotate, m, n, kb):
    planes, meta = _planes(fmt, kb, n)
    kw = _kw(meta, rotate)
    x = torch.from_numpy(_x(m, kb))
    want = titq3.itq3_matmul_ref(x, *planes, **kw)
    scale = want.abs().max().item()
    for splits in sorted({1, 2, kb} & set(range(1, kb + 1))):
        got = titq3.itq3_matmul_split_ref(x, *planes, splits=splits, **kw)
        err = (got - want).abs().max().item()
        assert err <= SPLIT_REL * scale, (splits, err, scale)


# each M, N and KB of the grid above, against the reference's kernel
PALLAS_SHAPES = [(1, 24, 1), (17, 192, 3), (40, 24, 6), (256, 192, 3)]


@pytest.mark.parametrize("m,n,kb", PALLAS_SHAPES)
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_split_matches_pallas(fmt, rotate, m, n, kb):
    planes, meta = _planes(fmt, kb, n)
    kw = _kw(meta, rotate)
    x = _x(m, kb, seed=7)
    want = itq3_matmul_pallas(jnp.asarray(x), *_jnp(planes), interpret=True,
                              **kw)
    got = titq3.itq3_matmul_split_ref(torch.from_numpy(x), *planes,
                                      splits=kb, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("sub", [1, 2, 16, 32, 128, 256])
def test_split_any_sub_blocks(sub, rotate):
    """Sub-block scales for other divisors of 256 than itq3_s_sub's 8 (the
    kernel reads one scale per 16 columns from 16 columns per sub-block
    up, one per column below), on planes the port quantizes: the operand
    d_sub * q exact in TF32, the model within 1e-6 of the plain version
    and within the kernel tests' tolerance of the reference. The
    reference's Pallas kernel expands sub-blocks of at most 64 elements
    (its 64-wide chunks), so for 1 and 2 sub-blocks its oracle
    ``kernels/ref.py:itq3_matmul_ref`` stands in."""
    w = (np.random.default_rng(sub).standard_normal((512, 24))
         / np.sqrt(512)).astype(np.float32)
    qt = tformats.quantize(torch.from_numpy(w), "itq3_s_sub", sub_blocks=sub)
    planes = _planes_of(qt)
    kw = _kw(qt.meta, rotate)
    if not rotate:
        op, _ = titq3.matmul_operand(*planes, **kw)
        assert torch.equal(titq3.tf32_round(op), op)
    x = _x(40, 2, seed=sub)
    tx = torch.from_numpy(x)
    want = titq3.itq3_matmul_ref(tx, *planes, **kw)
    got = titq3.itq3_matmul_split_ref(tx, *planes, splits=2, **kw)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= SPLIT_REL * scale
    jargs = (jnp.asarray(x), *_jnp(planes))
    ref = (itq3_matmul_pallas(*jargs, interpret=True, **kw) if sub >= 4
           else jitq3_matmul_ref(*jargs, **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# phase 3's four serving shapes (M = 256 rows of a prefill wave) and the
# cut the rule gives each; then ragged ones
TILE_CASES = [((256, 576, 3), (64, 3)), ((256, 192, 3), (32, 3)),
              ((256, 1536, 3), (64, 1)), ((256, 576, 6), (64, 6)),
              ((1, 24, 1), (32, 1)), ((17, 192, 6), (32, 6)),
              ((300, 24, 6), (32, 6)), ((4096, 576, 3), (64, 1))]


@pytest.mark.parametrize("shape,cut", TILE_CASES)
def test_matmul_tiles_rule(shape, cut):
    """The cut is static, its splits divide KB and stay within the
    cluster size, and the grid stays within two blocks per SM."""
    m, n, kb = shape
    bm, splits = titq3.matmul_tiles(m, n, kb)
    assert (bm, splits) == cut
    assert bm in titq3.MATMUL_BM and kb % splits == 0
    assert splits <= titq3.MATMUL_MAX_SPLITS
    tiles = -(-m // bm) * -(-n // titq3.MATMUL_BN)
    assert splits == 1 or tiles * splits <= 2 * titq3.MATMUL_SMS


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FORMATS)
def test_cuda_matmul_matches_plain(fmt):
    """On the card: the kernel against its plain version (1e-4 of the
    largest output) in both modes at ragged and main-path row counts, and
    two calls bit-equal. Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    dev = torch.device("cuda")
    for kb, n in ((1, 24), (6, 192)):
        planes, meta = _planes(fmt, kb, n)
        planes = [p.to(dev) for p in planes]
        for rotate in (False, True):
            kw = _kw(meta, rotate)
            for m in (1, 17, 255, 256, 300):
                x = torch.from_numpy(_x(m, kb)).to(dev)
                got = titq3.itq3_matmul(x, *planes, **kw)
                want = titq3.itq3_matmul_ref(x, *planes, **kw)
                err = (got - want).abs().max().item()
                assert err <= KERNEL_REL * want.abs().max().item(), (
                    fmt, rotate, m, n, kb, err)
                assert torch.equal(got, titq3.itq3_matmul(x, *planes, **kw))
    torch.cuda.synchronize()
