"""PyTorch port vs the live JAX reference: packing, FWHT, Algorithm 1, the
ternary formats' contractions and the qmatmul dispatch, on the CPU.

Integer stages (codes, grid values, ``wint``) must match exactly; float
stages within the stated tolerances (both sides f32, summed in another
order by XLA's and PyTorch's CPU kernels).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fwht as jfwht
from repro.core import formats as jformats
from repro.core import grids as jgrids
from repro.core import packing as jpacking
from repro.core import quantize as jquant
from repro.core.qlinear import qmatmul as jqmatmul
from repro_torch.bridge import params_from_numpy
from repro_torch.core import fwht as tfwht
from repro_torch.core import formats as tformats
from repro_torch.core import grids as tgrids
from repro_torch.core import packing as tpacking
from repro_torch.core import quantize as tquant
from repro_torch.core.qlinear import qmatmul as tqmatmul
from test_torch_bridge import to_numpy_tree

FORMATS = ["iq3_s", "quip3", "itq3_s", "itq3_s_sub", "itq3_x"]
TOL = dict(rtol=1e-5, atol=1e-5)
K_RAGGED, N = 300, 40  # K pads to two 256-blocks


def _jit(fn, **static):
    """The reference under jit: eager JAX compiles op by op, which would
    dominate these tests' time."""
    return jax.jit(functools.partial(fn, **static))


@functools.lru_cache(maxsize=None)
def _weights(fmt):
    """(w, JAX QTensor, port QTensor bridged from it) for one format."""
    # scaled as the model's projections are, so outputs are O(1)
    w = (np.random.default_rng(7).standard_normal((K_RAGGED, N))
         / np.sqrt(K_RAGGED)).astype(np.float32)
    jqt = _jit(jformats.quantize, fmt=fmt)(jnp.asarray(w))
    return w, jqt, params_from_numpy(to_numpy_tree(jqt), device="cpu")


def test_grid_constants_match_reference():
    assert tgrids.SCALE_RULES["paper"] == jgrids.SCALE_RULES["paper"]
    assert tgrids.fivelevel_alpha() == jgrids.FIVELEVEL_ALPHA


def test_pack_unpack_planes_exact(rng):
    codes3 = rng.integers(0, 8, (5, 3, 256)).astype(np.uint8)
    jp2, jp1 = _jit(jpacking.pack_codes)(jnp.asarray(codes3))
    tp2, tp1 = tpacking.pack_codes(torch.from_numpy(codes3))
    np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))
    np.testing.assert_array_equal(tp1.numpy(), np.asarray(jp1))
    np.testing.assert_array_equal(tpacking.unpack_codes(tp2, tp1).numpy(),
                                  codes3)
    c2 = rng.integers(0, 4, (7, 64)).astype(np.uint8)
    c1 = rng.integers(0, 2, (7, 64)).astype(np.uint8)
    np.testing.assert_array_equal(
        tpacking.pack_plane2(torch.from_numpy(c2)).numpy(),
        np.asarray(_jit(jpacking.pack_plane2)(jnp.asarray(c2))))
    np.testing.assert_array_equal(
        tpacking.pack_plane1(torch.from_numpy(c1)).numpy(),
        np.asarray(_jit(jpacking.pack_plane1)(jnp.asarray(c1))))
    np.testing.assert_array_equal(tpacking.unpack_plane2(
        tpacking.pack_plane2(torch.from_numpy(c2))).numpy(), c2)
    np.testing.assert_array_equal(tpacking.unpack_plane1(
        tpacking.pack_plane1(torch.from_numpy(c1))).numpy(), c1)


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_values_and_wint_exact(fmt):
    _, jqt, tqt = _weights(fmt)
    m, jd, td = jqt.meta, jqt.data, tqt.data
    np.testing.assert_array_equal(
        tquant.decode_values(td["plane2"], td["plane1"],
                             fivelevel=m.fivelevel).numpy(),
        np.asarray(_jit(jquant.decode_values, fivelevel=m.fivelevel)(
            jd["plane2"], jd["plane1"])))
    np.testing.assert_array_equal(
        tquant.decode_wint(td["plane2"], td["plane1"], td["zps"],
                           fivelevel=m.fivelevel,
                           sub_blocks=m.sub_blocks).numpy(),
        np.asarray(_jit(jquant.decode_wint, fivelevel=m.fivelevel,
                        sub_blocks=m.sub_blocks)(jd["plane2"], jd["plane1"],
                                                 jd["zps"])))


def test_plain_itq3_s_plane1_carries_parity_not_escape():
    _, _, tqt = _weights("itq3_s")
    sel = tpacking.unpack_plane1(tqt.data["plane1"])
    assert sel.any(), "plane1 of plain itq3_s holds the parity bit"
    values = tquant.decode_values(tqt.data["plane2"], tqt.data["plane1"])
    assert set(values.unique().tolist()) <= {-1, 0, 1}


@pytest.mark.parametrize("n", [32, 64, 128, 256])
def test_fwht_matches_reference(n, rng):
    x = rng.standard_normal((6, 3 * n)).astype(np.float32)
    np.testing.assert_allclose(
        tfwht.blocked_fwht(torch.from_numpy(x), n).numpy(),
        np.asarray(_jit(jfwht.blocked_fwht, block=n)(jnp.asarray(x))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tfwht.fwht(torch.from_numpy(x[:, :n])).numpy(),
        np.asarray(_jit(jfwht.fwht)(jnp.asarray(x[:, :n]))), rtol=0,
        atol=1e-6)
    np.testing.assert_allclose(
        tfwht.hadamard_matrix(n, device="cpu").numpy(),
        np.asarray(jfwht.hadamard_matrix(n)), rtol=0, atol=1e-7)


def _codes3(data):
    return tpacking.unpack_codes(data["plane2"], data["plane1"]).numpy()


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_blocks_matches_reference(fmt, rng):
    """Port Algorithm 1 on the same weights: codes equal except where the
    f32 block statistics straddle a rounding tie (<= 1e-4 of codes),
    fp16 scales and zero-points equal except at such ties."""
    w = rng.standard_normal((3, 576, 96)).astype(np.float32)
    spec = jformats.get_format(fmt)
    wb = jquant.to_blocks(jnp.asarray(w), 256)
    dsign = spec._dsign(0)
    jd = _jit(jquant.quantize_blocks_ternary, rotate=spec.rotate,
              sub_blocks=spec.sub_blocks, fivelevel=spec.fivelevel)(
        wb, dsign=dsign)
    td = tquant.quantize_blocks_ternary(
        tquant.to_blocks(torch.from_numpy(w), 256), rotate=spec.rotate,
        sub_blocks=spec.sub_blocks, fivelevel=spec.fivelevel,
        dsign=None if dsign is None else torch.tensor(np.asarray(dsign)))
    jd = {k: np.asarray(v) for k, v in jd.items()}
    assert td.keys() == jd.keys()
    diff = (_codes3(td) != np.asarray(_jit(jpacking.unpack_codes)(
        jd["plane2"], jd["plane1"]))).sum()
    assert diff <= 1e-4 * _codes3(td).size, f"{diff} codes differ"
    for key in ("scales", "zps"):
        got, want = td[key].numpy(), jd[key]
        assert got.dtype == want.dtype == np.float16
        assert (got != want).mean() <= 1e-3, key
    if dsign is not None:
        np.testing.assert_array_equal(td["dsign"].numpy(), jd["dsign"])


@pytest.mark.parametrize("fmt", ["iq3_s", "itq3_s", "itq3_s_sub", "itq3_x"])
def test_tensor_quantize_meta_and_dequantize(fmt):
    w, jqt, _ = _weights(fmt)
    tqt = tformats.quantize(torch.from_numpy(w), fmt)
    assert tqt.meta.to_dict() == jqt.meta.to_dict()
    np.testing.assert_allclose(
        tformats.get_format(fmt).dequantize(tqt).numpy(),
        np.asarray(_jit(jformats.dequantize, dtype=jnp.float32)(jqt)), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**32 - 1])
def test_quip3_quantize_waits_for_mixed_policy_slice(seed):
    """The port quantizes quip3 itself: its sign diagonal is JAX's threefry
    draw from the seed (equal), its codes, scales and zero-points those of
    the reference's quantize on the same weights (up to the f32 ties
    test_quantize_blocks_matches_reference allows), its meta equal."""
    w = (np.random.default_rng(seed % 97).standard_normal((K_RAGGED, N))
         / np.sqrt(K_RAGGED)).astype(np.float32)
    jqt = _jit(jformats.quantize, fmt="quip3", seed=seed)(jnp.asarray(w))
    tqt = tformats.quantize(torch.from_numpy(w), "quip3", seed=seed)
    assert tqt.meta.to_dict() == jqt.meta.to_dict()
    jd = {k: np.asarray(v) for k, v in jqt.data.items()}
    assert tqt.data.keys() == jd.keys()
    np.testing.assert_array_equal(tqt.data["dsign"].numpy(), jd["dsign"])
    assert set(np.unique(jd["dsign"])) == {-1, 1}
    codes = _codes3(tqt.data)
    diff = (codes != np.asarray(_jit(jpacking.unpack_codes)(
        jd["plane2"], jd["plane1"]))).sum()
    assert diff <= 1e-4 * codes.size, f"{diff} codes differ"
    for key in ("scales", "zps"):
        assert (tqt.data[key].numpy() != jd[key]).mean() <= 1e-3, key


@pytest.mark.parametrize("mode", ["dequant", "weights", "activations"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_contract_matches_reference(fmt, mode, rng):
    _, jqt, tqt = _weights(fmt)
    x = rng.standard_normal((3, 5, K_RAGGED)).astype(np.float32)
    want = _jit(jformats.get_format(fmt).contract, mode=mode,
                compute_dtype=jnp.float32)(jnp.asarray(x), jqt)
    got = tformats.get_format(fmt).contract(torch.from_numpy(x), tqt,
                                            mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m", [1, 20])
@pytest.mark.parametrize("mode", ["weights", "activations"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_qmatmul_kernel_path_on_cpu_matches_ref_path(fmt, mode, m, rng):
    """backend="auto" on CPU tensors runs the kernel path's plain versions
    (pad, FWHT, then matvec for M <= 16 or the tiled contraction) and
    agrees with backend="ref", which test_contract_matches_reference holds
    against the reference."""
    _, _, tqt = _weights(fmt)
    x = torch.from_numpy(rng.standard_normal((m, K_RAGGED)).astype(np.float32))
    np.testing.assert_allclose(
        tqmatmul(x, tqt, mode=mode, backend="auto").numpy(),
        tqmatmul(x, tqt, mode=mode, backend="ref").numpy(), **TOL)


def test_qmatmul_matches_reference_qmatmul(rng):
    _, jqt, tqt = _weights("itq3_s")
    x = rng.standard_normal((2, 3, K_RAGGED)).astype(np.float32)
    want = _jit(jqmatmul, backend="ref", compute_dtype=jnp.float32)(
        jnp.asarray(x), jqt)
    np.testing.assert_allclose(tqmatmul(torch.from_numpy(x), tqt).numpy(),
                               np.asarray(want), **TOL)


def test_qmatmul_cuda_backend_refuses_cpu_tensors():
    _, _, tqt = _weights("itq3_s")
    with pytest.raises(ValueError, match="CUDA"):
        tqmatmul(torch.zeros(1, K_RAGGED), tqt, backend="cuda")
