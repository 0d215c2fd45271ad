"""Rotated-int8 KV codec and q8-cache attention: port vs live reference.

``kv_encode`` codes are exact and its fp16 scales bit-equal, extremes
included (both sides round half to even and clamp the scale into fp16's
normal range). Attention entry points agree with the reference's
``backend="ref"`` within rtol/atol 1e-5 (f32, another summation order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attn_decode as jattn
from repro.serve import kv_quant as jkv
from repro_torch.kernels import attn_q8 as tattn
from repro_torch.serve import kv_quant as tkv

TOL = dict(rtol=1e-5, atol=1e-5)


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _vectors(rng, hd=32):
    x = rng.standard_normal((2, 3, 7, hd)).astype(np.float32)
    x[0, 0, 0] *= 1e6   # scale saturates at fp16's max, codes stay finite
    x[0, 1, 2] *= 1e-7  # scale clamps to fp16's smallest normal
    x[1, 2, 3] = 0.0
    return x


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_kv_encode_codes_exact_scales_bit_equal(hd, rng):
    x = _vectors(rng, hd)
    jq, js = _jit(jkv.kv_encode)(jnp.asarray(x))
    tq, ts = tkv.kv_encode(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint16),
                                  np.asarray(js).view(np.uint16))
    assert np.isfinite(ts.numpy()).all()
    np.testing.assert_allclose(
        tkv.kv_decode(tq, ts).numpy(),
        np.asarray(_jit(jkv.kv_decode)(jq, js)), rtol=1e-6, atol=1e-6)


def test_kv_scores_match(rng):
    q = rng.standard_normal((2, 3, 2, 4, 32)).astype(np.float32)
    kq, ks = tkv.kv_encode(torch.from_numpy(
        rng.standard_normal((2, 3, 9, 32)).astype(np.float32)))
    want = _jit(jkv.kv_scores)(jnp.asarray(q), jnp.asarray(kq.numpy()),
                               jnp.asarray(ks.numpy()))
    got = tkv.kv_scores(torch.from_numpy(q), kq, ks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cache(rng, b=3, kv=2, t=24, hd=32):
    k, v = (rng.standard_normal((b, kv, t, hd)).astype(np.float32)
            for _ in range(2))
    kq, ks = tkv.kv_encode(torch.from_numpy(k))
    vq, vs = tkv.kv_encode(torch.from_numpy(v))
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _to_jax(tree):
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_decode_attn_q8_matches_reference(backend, rng):
    cache = _cache(rng)
    b, kv, t, hd = cache["k"].shape
    g = 3
    q = rng.standard_normal((b, kv, g, 1, hd)).astype(np.float32)
    k_tok = tkv.kv_encode(torch.from_numpy(
        rng.standard_normal((b, kv, 1, hd)).astype(np.float32)))
    v_tok = tkv.kv_encode(torch.from_numpy(
        rng.standard_normal((b, kv, 1, hd)).astype(np.float32)))
    kv_len = np.array([0, 9, t], np.int32)  # an empty slot decodes finite
    want = _jit(jattn.decode_attn_q8, backend="ref")(
        jnp.asarray(q), _to_jax(cache),
        tuple(jnp.asarray(a.numpy()) for a in k_tok),
        tuple(jnp.asarray(a.numpy()) for a in v_tok), jnp.asarray(kv_len))
    got = tattn.decode_attn_q8(torch.from_numpy(q), cache, k_tok, v_tok,
                               torch.from_numpy(kv_len), backend=backend)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_prefill_attn_q8_matches_reference(backend, rng):
    cache = _cache(rng)
    b, kv, t, hd = cache["k"].shape
    g, tq = 2, 6
    q = rng.standard_normal((b, kv, g, tq, hd)).astype(np.float32)
    q_offset = np.array([0, 4, t - tq], np.int32)
    kv_len = q_offset + tq
    want = _jit(jattn.prefill_attn_q8, backend="ref")(
        jnp.asarray(q), _to_jax(cache), jnp.asarray(kv_len),
        jnp.asarray(q_offset))
    got = tattn.prefill_attn_q8(torch.from_numpy(q), cache,
                                torch.from_numpy(kv_len),
                                torch.from_numpy(q_offset), backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_backend_knob_is_checked(rng):
    cache = _cache(rng)
    q = torch.zeros(3, 2, 2, 4, 32)
    lens = torch.full((3,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="backend"):
        tattn.prefill_attn_q8(q, cache, lens, lens * 0, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tattn.prefill_attn_q8(q, cache, lens, lens * 0, backend="cuda")
