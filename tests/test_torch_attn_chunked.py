"""Query-chunked attention (``models/layers.py:_sdpa_chunked``) on the port
against the live reference, on the CPU, at chunks of 4 to 8 queries:

* ``_sdpa_chunked`` within 1e-5 of the reference's, causal and not, with
  a per-row ``q_offset``, with ``kv_len``, at T a multiple of the chunk
  and not;
* one chunk (T <= ``attn_chunk``) is the port's one-chunk ``_sdpa``, and
  both the former ``_sdpa``'s bits (kept here as ``_former_sdpa``);
* ``forward_xent``'s loss within 1e-5, and its gradients within 5e-5 of
  each leaf's largest, against ``jax.grad`` at T > ``attn_chunk`` (the
  chunks under their checkpoints, inside the per-layer remat);
* reduced phi-3-vision (an 8-patch prefix) and seamless-m4t (an 8-frame
  encoder, cross-attention) prefills on fp weights over an fp cache at
  T > ``attn_chunk``: logits within 1e-4 of the reference's (an fp cache
  has no rounding ties).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime
from repro_torch.train.grad import value_and_grad
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_train import _cfgs, _hold_grads, _jax_params, _port

ATTN_TOL = 1e-5
LOSS_TOL = 1e-5
LOGIT_ATOL = 1e-4
B, KV, G, HD = 2, 2, 3, 16


def _qkv(tq, tk, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, tq, HD)).astype(np.float32)
    k = rng.standard_normal((B, KV, tk, HD)).astype(np.float32)
    v = rng.standard_normal((B, KV, tk, HD)).astype(np.float32)
    return q, k, v


# (Tq, Tk, chunk, causal, q_offset, kv_len)
CASES = [
    (12, 12, 4, True, None, None),  # a multiple of the chunk
    (13, 13, 4, True, None, None),  # padded to 16
    (11, 11, 8, False, None, None),  # non-causal (an encoder)
    (9, 20, 4, True, (3, 11), None),  # a span written at per-row offsets
    (10, 24, 6, True, (5, 14), (15, 24)),  # and kv_len (an fp-cache prefill)
    (7, 16, 5, False, None, (16, 9)),  # cross-attention shapes, kv_len
]


@pytest.mark.parametrize("tq,tk,chunk,causal,q_offset,kv_len", CASES)
def test_sdpa_chunked_matches_reference(tq, tk, chunk, causal, q_offset,
                                        kv_len):
    q, k, v = _qkv(tq, tk)
    off = None if q_offset is None else np.asarray(q_offset, np.int32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jlayers._sdpa_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        JRuntime(compute_dtype=jnp.float32, attn_chunk=chunk),
        causal=causal, q_offset=None if off is None else jnp.asarray(off),
        kv_len=None if kl is None else jnp.asarray(kl))
    got = tlayers._sdpa_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        Runtime(attn_chunk=chunk), causal=causal,
        q_offset=None if off is None else torch.from_numpy(off).long(),
        kv_len=None if kl is None else torch.from_numpy(kl).long())
    assert got.shape == (B, KV, G, tq, HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_TOL)


def _former_sdpa(q, k, v, *, causal, q_offset, kv_len):
    """The port's one-chunk attention as it was before the chunked form
    (an f32 cache): the bits every serving path keeps."""
    b, _, _, tq, hd = q.shape
    tk = k.shape[2]
    s = torch.einsum("bkgqd,bktd->bkgqt", q, k) * (1.0 / math.sqrt(hd))
    kpos = torch.arange(tk)
    mask = torch.ones((b, 1, 1, tq, tk), dtype=torch.bool)
    if causal:
        qpos = q_offset[:, None] + torch.arange(tq)
        mask = mask & (kpos[None, None, None, None, :]
                       <= qpos[:, None, None, :, None])
    if kv_len is not None:
        mask = mask & (kpos[None, None, None, None, :]
                       < kv_len[:, None, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, tlayers.NEG_INF))
    return torch.einsum("bkgqt,bktd->bkgqd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("causal", [True, False])
def test_one_chunk_is_sdpa_bit_for_bit(causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(12, 20, seed=3))
    off = torch.tensor([2, 8])
    kl = torch.tensor([14, 20])
    want = _former_sdpa(q, k, v, causal=causal, q_offset=off, kv_len=kl)
    assert torch.equal(tlayers._sdpa(q, k, v, causal=causal, q_offset=off,
                                     kv_len=kl), want)
    for chunk in (12, 512):
        got = tlayers._sdpa_chunked(q, k, v, Runtime(attn_chunk=chunk),
                                    causal=causal, q_offset=off, kv_len=kl)
        assert torch.equal(got, want)


# --- training at T > attn_chunk ---------------------------------------------

XENT_ARCH, XB, XT, XCHUNK = "smollm-135m", 2, 16, 6


@functools.lru_cache(maxsize=None)
def _xent_inputs():
    cfg = tconfigs.reduced(tconfigs.get_config(XENT_ARCH))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (XB, XT)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (XB, XT)).astype(np.int32)
    return cfg, toks, labels


def test_forward_xent_chunked_matches_jax_grad():
    tcfg, toks, labels = _xent_inputs()
    jp = _jax_params(XENT_ARCH)
    jcfg = _cfgs(XENT_ARCH)[0]
    jrt = JRuntime(compute_dtype=jnp.float32, attn_chunk=XCHUNK)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.forward_xent(p, toks, labels, jrt, jcfg)[0]))(jp)
    rt = Runtime(attn_chunk=XCHUNK, remat=True, remat_policy="dots")

    def loss(p, _):
        xent, aux = tlm.forward_xent(p, toks, labels, rt, tcfg)
        return xent, aux
    (tloss, _), tgrads = value_and_grad(loss, _port(jp), None)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    _hold_grads(jgrads, tgrads, "forward_xent, chunked attention")


# --- frontend prefills at T > attn_chunk ------------------------------------

FRONT_T, FRONT_CHUNK, FRONT_MAX = 12, 5, 32


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_frontend_prefill_chunked_matches_reference(arch):
    cfg, tcfg = _cfgs(arch)
    jp = _jax_params(arch)
    tp = _port(jp)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, FRONT_T)).astype(np.int32)
    feats = rng.standard_normal((B, cfg.frontend_len, cfg.frontend_dim)
                                ).astype(np.float32)
    jrt = JRuntime(compute_dtype=jnp.float32, backend="ref",
                   attn_chunk=FRONT_CHUNK)
    jl, _ = jax.jit(lambda p, t, f, c: jlm.forward(
        p, t, jrt, cfg, frontend_feats=f, cache=c, pos=0)[:2])(
        jp, jnp.asarray(toks), jnp.asarray(feats),
        jlm.init_cache(cfg, B, FRONT_MAX, dtype=jnp.float32))
    tl, _ = tlm.forward(tp, toks, Runtime(attn_chunk=FRONT_CHUNK), tcfg,
                        frontend_feats=feats,
                        cache=tlm.init_cache(tcfg, B, FRONT_MAX,
                                             device="cpu"))
    assert tl.shape == (B, FRONT_T, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
