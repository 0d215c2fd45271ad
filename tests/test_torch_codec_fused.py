"""The fused rotate-and-encode codecs of ``csrc/fwht.cu`` against the live
JAX reference, on the CPU.

Both codec scales are ``amax * fl32(1/127)``: the reference serves under
``jax.jit``, where XLA rewrites ``amax / 127`` as a multiply by the f32
reciprocal, and a true division rounds the scale differently in about one
row of twenty. The port's plain versions multiply, so their scales are the
jitted reference's bit for bit; the fused kernels give the plain versions'
bits (held on the card by ``chip_smoke.py`` phase 3).

* ``act_encode`` on a seeded (4096, 768) input, and ``kv_encode`` at
  vectors built so that the two roundings give different fp16 scales.
* ``fwht_act_encode`` (a CPU tensor runs its plain version, padding the
  rows to whole blocks as the kernel reads them) against the jitted
  reference's ``act_encode`` of the padded rows, codes and scales exact:
  the five ternary formats, rotation on and off, quip3's sign diagonal,
  1 to 96 blocks, zero and padding-only rows, rows at +-127 and exact .5
  ties; a non-finite row's scale (its codes are not compared).
* ``kv_encode_pair`` against two jitted reference ``kv_encode`` calls at
  head_dim 2 to 1024, with huge and tiny vectors and V as the transpose
  the attention hands over.
* Greedy streams of a reduced model on the float and W3A8 paths against
  the live JAX engine.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import act_quant as jact
from repro.models.layers import Runtime as JRuntime
from repro.serve import kv_quant as jkv
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import act_quant as tact
from repro_torch.core.fwht import blocked_fwht
from repro_torch.core.quantize import pad_last_dim
from repro_torch.kernels import fwht as tfwht
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import kv_quant as tkv
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_act_quant import _weights
from test_torch_bridge import jax_quantized_params, to_numpy_tree

RECIP = np.float32(1) / np.float32(127)


@functools.lru_cache(maxsize=None)
def _jit_act(rotate: bool, block: int = 256):
    return jax.jit(functools.partial(jact.act_encode, rotate=rotate,
                                     block=block))


_jit_kv = jax.jit(jkv.kv_encode)


def _act_ref(xp: np.ndarray, rotate=True, dsign=None):
    q, s = _jit_act(rotate)(jnp.asarray(xp), dsign=None if dsign is None
                            else jnp.asarray(dsign))
    return np.asarray(q), np.asarray(s)


# --- the scale repair --------------------------------------------------------

def test_act_encode_scale_is_the_jitted_references():
    x = np.random.default_rng(0).standard_normal((4096, 768)).astype(
        np.float32)
    jq, js = _act_ref(x)
    tq, ts = tact.act_encode(torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tq.numpy(), jq)
    # the input tells the two roundings apart: a true division differs
    amax = blocked_fwht(torch.from_numpy(x)).abs().amax(-1, keepdim=True)
    assert (amax / 127.0 != ts).sum() > 100
    assert torch.equal(amax * tact.ACT_RECIP, ts)


def _split_amaxes(n: int = 6) -> list:
    """f32 values a whose scale rounds to another fp16 as fl32(a / 127)
    than as fl32(a * fl32(1/127)), inside fp16's normal range."""
    found = []
    for e in range(-6, 10):
        ulp16 = np.float32(2.0 ** (e - 10))
        for m in range(0, 1024, 3):
            mid = np.float32(2.0 ** e) + np.float32(m + 0.5) * ulp16
            a = np.float32(mid * np.float32(127))
            for _ in range(3):
                div = (a / np.float32(127)).astype(np.float16)
                mul = (a * RECIP).astype(np.float16)
                if div != mul:
                    found.append(a)
                a = np.nextafter(a, np.float32(np.inf))
            if len(found) >= n:
                return found
    return found


@pytest.mark.parametrize("hd", [4, 16, 64, 256, 1024])
def test_kv_encode_scale_is_the_jitted_references_at_a_split(hd):
    """Vectors whose rotation is ``a`` at element 0 and exact zeros
    elsewhere (a constant a/sqrt(HD): HD is a power of 4), at values of a
    where the two roundings give different fp16 scales."""
    amaxes = _split_amaxes()
    assert len(amaxes) == 6
    x = np.stack([np.full(hd, a / np.float32(np.sqrt(hd)), np.float32)
                  for a in amaxes])[None]  # (1, 6, HD)
    jq, js = _jit_kv(jnp.asarray(x))
    want = (np.asarray(jq), np.asarray(js).view(np.uint16))
    t = torch.from_numpy(x)
    for encode in (lambda: tkv.kv_encode(t),
                   lambda: tkv.kv_encode(t, backend="ref"),
                   lambda: tkv.kv_encode_pair(t[None], t[None])[1]):
        got = encode()
        np.testing.assert_array_equal(got[0].numpy().reshape(want[0].shape),
                                      want[0])
        np.testing.assert_array_equal(
            got[1].numpy().view(np.uint16).reshape(want[1].shape), want[1])
    div = (np.asarray(amaxes, np.float32) / np.float32(127)).astype(
        np.float16)
    assert (div.view(np.uint16) != want[1].ravel()).all()


# --- fwht_act_encode ---------------------------------------------------------

def _both(x: np.ndarray, **kw):
    """The wrapper (its plain version on a CPU tensor) and the plain
    version, each checked equal to the other."""
    t = torch.from_numpy(x)
    got = tfwht.fwht_act_encode(t, **kw)
    ref = tfwht.fwht_act_encode_ref(t, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    return got[0].numpy(), got[1].numpy()


@pytest.mark.parametrize("fmt", ["iq3_s", "quip3", "itq3_s", "itq3_s_sub",
                                 "itq3_x"])
def test_fwht_act_encode_formats_match_reference(fmt, rng):
    _, jqt, tqt = _weights(fmt)
    k = jqt.meta.shape[0]
    x = rng.standard_normal((6, k)).astype(np.float32) * 3
    x[1] = 0.0
    tq, ts = _both(x, rotate=jqt.meta.rotate, dsign=tqt.data.get("dsign"))
    jq, js = _act_ref(pad_last_dim(torch.from_numpy(x), 256).numpy(),
                      jqt.meta.rotate, jqt.data.get("dsign"))
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    assert ts[1, 0] == 0 and (tq[1] == 0).all()


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("kb,k", [(1, 200), (3, 576), (6, 1536), (11, 2816),
                                  (96, 96 * 256 - 7)])
def test_fwht_act_encode_blocks_match_reference(kb, k, rotate):
    rng = np.random.default_rng(kb)
    x = (rng.standard_normal((5, k)) * rng.uniform(0.1, 30, (5, 1))).astype(
        np.float32)
    x[2] = 0.0  # all zero: only padding reaches the codec
    dsign = np.where(rng.random((kb, 256)) < 0.5, -1.0, 1.0).astype(
        np.float32)
    xp = pad_last_dim(torch.from_numpy(x), 256).numpy()
    assert xp.shape == (5, kb * 256)
    for ds in (None, dsign):
        tq, ts = _both(x, rotate=rotate, dsign=None if ds is None
                       else torch.from_numpy(ds))
        jq, js = _act_ref(xp, rotate, ds)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ts, js)
        assert ts[2, 0] == 0 and (tq[2] == 0).all()
        assert np.isfinite(ts).all()


def test_fwht_act_encode_grid_ends_and_ties_match_reference():
    """rotate=False rows whose scale is exactly 1 (amax 127: 127 *
    fl32(1/127) rounds to 1), so exact halves reach the rounding: half to
    even, as jnp.round; and the grid's ends at +-127."""
    row = np.zeros((3, 300), np.float32)
    row[0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    row[1, :4] = [-127.0, 127.0, -126.5, 3.5]
    row[2, :3] = [254.0, -254.0, 1.0]  # scale 2: +-127, and 0.5 -> 0
    tq, ts = _both(row, rotate=False)
    jq, js = _act_ref(pad_last_dim(torch.from_numpy(row), 256).numpy(),
                      False)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    assert ts[:, 0].tolist() == [1.0, 1.0, 2.0]
    assert tq[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert tq[1, :4].tolist() == [-127, 127, -126, 4]
    assert tq[2, :3].tolist() == [127, -127, 0]


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_fwht_act_encode_non_finite_row_scale(bad, rng):
    x = rng.standard_normal((3, 600)).astype(np.float32)
    x[1, 17] = bad
    for rotate in (True, False):
        tq, ts = _both(x, rotate=rotate)
        jq, js = _act_ref(pad_last_dim(torch.from_numpy(x), 256).numpy(),
                          rotate)
        np.testing.assert_array_equal(ts, js)  # NaN equals NaN here
        np.testing.assert_array_equal(tq[[0, 2]], jq[[0, 2]])


def test_fwht_act_encode_refuses_what_the_kernel_cannot_take():
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="block"):
        tfwht.fwht_act_encode(x, block=128)
    with pytest.raises(ValueError, match="dtype"):
        tfwht.fwht_act_encode(x.double())
    with pytest.raises(ValueError, match="2-D"):
        tfwht.fwht_act_encode(x[None])
    with pytest.raises(ValueError, match="contiguous"):
        tfwht.fwht_act_encode(torch.zeros(256, 2).t())


# --- kv_encode_pair ----------------------------------------------------------

def _kv_inputs(hd: int, seed: int):
    """K (B, KV, T, HD) contiguous and V as the transpose of a (B, T, KV,
    HD) projection, with a huge vector (scale at fp16's max), a tiny one
    (scale at its smallest normal) and a zero one in each."""
    rng = np.random.default_rng(seed)
    b, kvh, t = 2, 3, 5
    k = rng.standard_normal((b, kvh, t, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kvh, hd)).astype(np.float32) * 4
    k[0, 0, 0] *= 1e9
    k[1, 2, 4] *= 1e-7
    k[0, 1, 2] = 0.0
    v[1, 0, 1] *= 1e9
    v[0, 3, 2] *= 1e-8
    v[1, 4, 0] = 0.0
    return k, v


@pytest.mark.parametrize("hd", [2 ** i for i in range(1, 11)])
def test_kv_encode_pair_matches_two_reference_calls(hd):
    k, v = _kv_inputs(hd, hd)
    tk = torch.from_numpy(k)
    tv = torch.from_numpy(v).transpose(1, 2)  # (B, KV, T, HD), strided
    assert not tv.is_contiguous()
    want = [_jit_kv(jnp.asarray(a)) for a in (k, np.swapaxes(v, 1, 2))]
    for backend in ("auto", "ref"):
        got = tkv.kv_encode_pair(tk, tv, backend=backend)
        for (tq, ts), (jq, js) in zip(got, want):
            assert tq.dtype == torch.int8 and ts.dtype == torch.float16
            assert tq.shape == tk.shape and ts.shape == (*tk.shape[:3], 1)
            assert tq.is_contiguous() and ts.is_contiguous()
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy().view(np.uint16),
                                          np.asarray(js).view(np.uint16))
            assert np.isfinite(ts.numpy()).all()
    fmax, fmin = np.float16(tkv.F16_SCALE_MAX), np.float16(tkv.F16_SCALE_MIN)
    ks, vs = got[0][1].numpy(), got[1][1].numpy()
    assert ks[0, 0, 0, 0] == fmax and ks[1, 2, 4, 0] == fmin
    assert vs[1, 1, 0, 0] == fmax and vs[0, 2, 3, 0] == fmin


def test_kv_encode_pair_refuses_what_the_kernel_cannot_take():
    k = torch.zeros(1, 2, 3, 64)
    with pytest.raises(ValueError, match="shape"):
        tfwht.fwht_kv_encode(k, k[..., :32])
    with pytest.raises(ValueError, match="power of two"):
        tfwht.fwht_kv_encode(k[..., :48], k[..., :48])
    with pytest.raises(ValueError, match="float32"):
        tfwht.fwht_kv_encode(k, k.double())
    with pytest.raises(ValueError, match="backend"):
        tkv.kv_encode_pair(k, k, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tkv.kv_encode_pair(k, k, backend="cuda")


# --- the model ---------------------------------------------------------------

SLOTS, ENGINE_LEN, MAX_NEW = 4, 96, 6


@pytest.mark.parametrize("act_quant", [False, True])
def test_engine_streams_equal_reference_engine(act_quant):
    """A reduced smollm-135m over the reference's itq3_s planes with the
    rotated-int8 cache: the port's kernel path (plain versions on the
    CPU, through the fused codecs' wrappers) serves the live JAX engine's
    greedy streams token for token."""
    cfg, jp = jax_quantized_params("smollm-135m", "itq3_s")
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, 512, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 21, size=5)]
    jeng = JServeEngine(jp, cfg, slots=SLOTS, max_len=ENGINE_LEN,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref", act_quant=act_quant))
    want = jeng.run([JRequest(rid=i, prompt=p, max_new=MAX_NEW)
                     for i, p in enumerate(prompts)])
    eng = ServeEngine(params_from_numpy(to_numpy_tree(jp), device="cpu"),
                      tconfigs.reduced(tconfigs.get_config("smollm-135m")),
                      slots=SLOTS, max_len=ENGINE_LEN,
                      rt=TRuntime(kv_quant=True, act_quant=act_quant),
                      device="cpu")
    got = eng.run([Request(rid=i, prompt=p, max_new=MAX_NEW)
                   for i, p in enumerate(prompts)])
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.finish_reason == "length" for r in got)
