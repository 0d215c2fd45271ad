"""The port's kernel wrappers vs the reference's Pallas kernels, run in
interpret mode on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; that
is what is held here against ``fwht_pallas``, ``itq3_matvec_pallas`` /
``itq3_matmul_pallas`` and ``attn_q8_pallas``. The hand-written CUDA
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
from repro.kernels.itq3_matmul import itq3_matmul_pallas
from repro.kernels.itq3_matvec import itq3_matvec_pallas
from repro_torch.bridge import params_from_numpy
from repro_torch.core.quantize import pad_last_dim
from repro_torch.kernels import _build, attn_q8 as tattn, fwht as tfwht
from repro_torch.kernels import itq3 as titq3
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
