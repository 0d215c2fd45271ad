"""The frontend families at the model level, on the port against the live
reference, on the CPU: reduced phi-3-vision-4.2b (``vlm``: 8 projected
64-wide patch embeddings prefixed to the tokens) and reduced
seamless-m4t-medium (``audio``: 8 projected frames through a 2-layer
non-causal encoder, cross-attended by each of 4 decoder layers), both at
d_model 128 with ``itq3_s`` planes quantized by the reference and
bridged.

* the init trees, and the cache trees (reduced, and full size on the
  ``meta`` device), have the reference's keys, shapes and dtypes: the vlm
  cache ``max_len + frontend_len`` long, the audio ``xattn`` leaves fp
  even under ``kv_quant``;
* the encoder memory, the ``xattn`` K/V the prefill writes and the vlm
  prefix's hidden rows within 1e-5;
* ``forward`` logits with frontend features (with and without
  ``kv_quant``), then ``decode_step`` logits, within 1e-4 of the largest,
  each row up to its first KV rounding tie (``test_torch_model.py``
  explains the tie; the int8 codes are equal up to it);
* a greedy 8-token decode loop token for token, on ``itq3_s`` and W3A8;
* ``quantize_params`` gives the reference's planes, bit for bit, for
  ``frontend_proj`` (K = 64, and seamless's full-width K = 160),
  ``encoder.*`` and ``layers.xattn.*``, uniform and under the mixed
  recipe;
* an audio forward without frames, and a memory whose length is not the
  cache's, raise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import mixed_precision_recipe as jrecipe
from repro.configs.base import reduced as jreduced
from repro.core.quantize import QTensor as JQTensor
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.serve import quantized as jquantized
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.quantize import QTensor
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import quantized as tquantized
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree
from test_torch_model import LOGIT_ATOL, MAX_LEN, B, T, _first_tie
from test_torch_policy_ckpt import _leaves

ARCHS = ("phi-3-vision-4.2b", "seamless-m4t-medium")
HIDDEN_ATOL = 1e-5
DECODE_STEPS, LOOP_STEPS = 4, 8


def _tcfg(arch):
    return tconfigs.reduced(tconfigs.get_config(arch))


def _prefix(cfg) -> int:
    """Cache positions ahead of the tokens: a vlm's patch prefix."""
    return cfg.frontend_len if cfg.family == "vlm" else 0


@functools.lru_cache(maxsize=None)
def _trees(arch):
    cfg, jp = jax_quantized_params(arch, "itq3_s")
    return cfg, jp, params_from_numpy(to_numpy_tree(jp), device="cpu")


def _inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    feats = rng.standard_normal((B, cfg.frontend_len, cfg.frontend_dim)
                                ).astype(np.float32)
    return toks, feats


@functools.lru_cache(maxsize=None)
def _jax_fns(cfg, kv_quant, act_quant=False):
    rt = JRuntime(compute_dtype=jnp.float32, kv_quant=kv_quant,
                  backend="ref", act_quant=act_quant)
    fwd = jax.jit(lambda p, toks, feats, c: jlm.forward(
        p, toks, rt, cfg, frontend_feats=feats, cache=c, pos=0)[:2])
    dec = jax.jit(lambda p, toks, c, pos: jlm.decode_step(p, toks, c, pos,
                                                          rt, cfg))
    return fwd, dec


def _prefill(arch, kv_quant, act_quant=False):
    """The frontend prefill on both sides: (cfg, params, toks, (jax
    logits, cache), (port logits, cache))."""
    cfg, jp, tp = _trees(arch)
    toks, feats = _inputs(cfg)
    fwd, _ = _jax_fns(cfg, kv_quant, act_quant)
    jout = fwd(jp, jnp.asarray(toks), jnp.asarray(feats),
               jlm.init_cache(cfg, B, MAX_LEN, dtype=jnp.float32,
                              kv_quant=kv_quant))
    tout = tlm.forward(tp, toks, TRuntime(kv_quant=kv_quant,
                                          act_quant=act_quant), _tcfg(arch),
                       frontend_feats=feats,
                       cache=tlm.init_cache(_tcfg(arch), B, MAX_LEN,
                                            kv_quant=kv_quant, device="cpu"))
    return cfg, (jp, tp), toks, jout, tout


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


# --- trees -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_trees_match_reference(arch):
    jcfg = jreduced(jget_config(arch))
    want = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda k: jlm.init_params(k, jcfg), jax.random.PRNGKey(0)))
    tcfg = _tcfg(arch)
    got = tlm.init_params(tcfg, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), got) == want
    assert got["frontend_proj"].shape == (64, 128)
    if tcfg.family == "audio":
        assert "bq" not in got["layers"]["xattn"]
        assert got["encoder"]["attn"]["wq"].shape[0] == 2
    # seeded on the card the same tree comes out, quantized as drawn
    q = tlm.init_quantized_params(tcfg, "itq3_s", device="cpu")
    assert dict(_leaves(q)).keys() == dict(_leaves(got)).keys()
    described = tquantized.describe_quantized(q)
    assert described == tquantized.describe_quantized(
        tquantized.quantize_params(got, "itq3_s"))
    assert described["frontend_proj"] == "itq3_s"
    for full in (False, True):
        for kvq in (False, True):
            jc, tc = (jget_config(arch), tconfigs.get_config(arch)) if full \
                else (jcfg, tcfg)
            if kvq and tc.resolved_head_dim == 96:  # phi's: no int8 codec
                with pytest.raises(ValueError, match="power-of-two"):
                    tlm.init_cache(tc, 4, 256, kv_quant=True, device="meta")
                continue
            jcache = jax.eval_shape(lambda: jlm.init_cache(
                jc, 4, 256, dtype=jnp.float32, kv_quant=kvq))
            tcache = tlm.init_cache(tc, 4, 256, kv_quant=kvq, device="meta")
            assert _shapes(tcache) == jax.tree.map(
                lambda a: (tuple(a.shape), str(a.dtype)), jcache)
            if tc.family == "vlm":
                assert tcache["attn"]["k"].shape[3] == 256 + tc.frontend_len
            else:
                assert tcache["xattn"]["k"].dtype == torch.float32
                assert tcache["xattn"]["k"].shape[3] == tc.frontend_len


# --- hidden states -----------------------------------------------------------

def test_encoder_memory_matches_reference():
    arch = "seamless-m4t-medium"
    cfg, jp, tp = _trees(arch)
    _, feats = _inputs(cfg)
    rt = JRuntime(compute_dtype=jnp.float32, backend="ref")
    want = jax.jit(lambda p, f: jlm._encode(p, f, rt, cfg))(
        jp, jnp.asarray(feats))
    got = tlm._encode(tp, torch.from_numpy(feats), TRuntime(), _tcfg(arch))
    assert got.shape == (B, cfg.frontend_len, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=HIDDEN_ATOL)


def test_vlm_prefix_hidden_rows_match_reference():
    arch = "phi-3-vision-4.2b"
    cfg, jp, tp = _trees(arch)
    toks, feats = _inputs(cfg)
    jrt = JRuntime(compute_dtype=jnp.float32, backend="ref")

    def jhidden(p, t, f):
        prefix = jlm.dense(f, p["frontend_proj"], jrt)
        x = jnp.concatenate([prefix, jlm._embed(p, t, jrt, cfg)], axis=1)
        return prefix, jlm._run_decoder(p, x, jrt, cfg, cache=None,
                                        pos=0)[0]
    jprefix, jx = jax.jit(jhidden)(jp, jnp.asarray(toks), jnp.asarray(feats))
    rt, tcfg = TRuntime(), _tcfg(arch)
    tprefix = tlm.dense(torch.from_numpy(feats), tp["frontend_proj"], rt)
    tx, _ = tlm._run_decoder(tp, torch.cat([tprefix, tlm._embed(
        tp, torch.from_numpy(toks))], dim=1), rt, tcfg, cache=None, pos=0)
    p = cfg.frontend_len
    np.testing.assert_allclose(tprefix.numpy(), np.asarray(jprefix), rtol=0,
                               atol=HIDDEN_ATOL)
    np.testing.assert_allclose(tx[:, :p].numpy(), np.asarray(jx[:, :p]),
                               rtol=0, atol=HIDDEN_ATOL)


# --- logits ------------------------------------------------------------------

@pytest.mark.parametrize("arch,kv_quant", [(a, k) for a in ARCHS
                                           for k in (False, True)])
def test_forward_and_decode_logits_match_reference(arch, kv_quant):
    cfg, (jp, tp), toks, (jl, jcache), (tl, tcache) = _prefill(arch,
                                                               kv_quant)
    tcfg, p = _tcfg(arch), _prefix(cfg)
    assert tl.shape == (B, T, cfg.vocab_size)
    assert _shapes(tcache) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), jcache)
    if cfg.family == "audio":  # the memory K/V the prefill wrote
        for k in ("k", "v"):
            np.testing.assert_allclose(
                tcache["xattn"][k].numpy(), np.asarray(jcache["xattn"][k]),
                rtol=0, atol=HIDDEN_ATOL, err_msg=k)
    first = _first_tie(tcache, jcache) - p  # in token positions
    for row in range(B):
        upto = min(first[row], T)
        np.testing.assert_allclose(tl[row, :upto].numpy(),
                                   np.asarray(jl[row, :upto]), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"row {row}")
    assert first.min() >= T // 2, "rounding ties cut most of the check"
    _, dec = _jax_fns(cfg, kv_quant)
    rt = TRuntime(kv_quant=kv_quant)
    pos = np.array([T - 3, T], np.int32) + p  # row 0 inside its prompt
    nxt = np.array(jnp.argmax(jl[np.arange(B), pos - p - 1], -1))[:, None]
    for step in range(DECODE_STEPS):
        jl2, jcache = dec(jp, jnp.asarray(nxt, jnp.int32), jcache,
                          jnp.asarray(pos + step))
        tl2, tcache = tlm.decode_step(tp, nxt, tcache, pos + step, rt, tcfg)
        first = _first_tie(tcache, jcache)
        for row in np.nonzero(first > pos + step)[0]:
            np.testing.assert_allclose(
                tl2[row].numpy(), np.asarray(jl2[row]), rtol=0,
                atol=LOGIT_ATOL, err_msg=f"step {step} row {row}")
        nxt = np.array(jnp.argmax(jl2[:, 0], -1))[:, None]


@pytest.mark.parametrize("arch,act_quant", [(a, q) for a in ARCHS
                                            for q in (False, True)])
def test_greedy_decode_loop_equals_reference(arch, act_quant):
    cfg, (jp, tp), _, (jl, jcache), (tl, tcache) = _prefill(
        arch, True, act_quant)
    _, dec = _jax_fns(cfg, True, act_quant)
    rt = TRuntime(kv_quant=True, act_quant=act_quant)
    jtok = np.array(jnp.argmax(jl[:, -1], -1))
    ttok = tl[:, -1].argmax(-1).numpy()
    jstream, tstream = [jtok], [ttok]
    pos = np.full(B, T + _prefix(cfg), np.int32)  # the logits test's shape
    for step in range(LOOP_STEPS):
        jl2, jcache = dec(jp, jnp.asarray(jtok[:, None], jnp.int32), jcache,
                          jnp.asarray(pos + step))
        tl2, tcache = tlm.decode_step(tp, ttok[:, None], tcache, pos + step,
                                      rt, _tcfg(arch))
        jtok = np.array(jnp.argmax(jl2[:, 0], -1))
        ttok = tl2[:, 0].argmax(-1).numpy()
        jstream.append(jtok)
        tstream.append(ttok)
    np.testing.assert_array_equal(np.stack(tstream), np.stack(jstream))


def test_one_token_prompt_still_writes_the_memory():
    """A one-token prompt with frames takes the layer loop, so the
    encoder memory reaches every layer's cross-attention cache: the same
    K/V as a longer prompt's (the memory depends on the frames only)."""
    arch = "seamless-m4t-medium"
    _, _, tp = _trees(arch)
    tcfg = _tcfg(arch)
    toks, feats = _inputs(tcfg)
    caches = []
    for t in (1, T):
        c = tlm.init_cache(tcfg, B, MAX_LEN, kv_quant=True, device="cpu")
        tlm.forward(tp, toks[:, :t], TRuntime(kv_quant=True), tcfg,
                    frontend_feats=feats, cache=c)
        caches.append(c)
    assert caches[0]["xattn"]["k"].abs().max() > 0
    for k in ("k", "v"):
        assert torch.equal(caches[0]["xattn"][k], caches[1]["xattn"][k])


# --- quantization ------------------------------------------------------------

def _frontend_leaf(path: str) -> bool:
    return (path.startswith(("frontend_proj", "encoder."))
            or path.startswith("layers.xattn."))


@functools.lru_cache(maxsize=None)
def _fp_trees(arch):
    cfg = jreduced(jget_config(arch))
    jp = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    cfg)
    return cfg, jp, params_from_numpy(to_numpy_tree(jp), device="cpu")


def _policies(jcfg, tcfg, kind):
    if kind == "paper":
        return "itq3_s", "itq3_s"
    return (jquantized.QuantPolicy.from_dict(jrecipe(jcfg)),
            tquantized.QuantPolicy.from_dict(
                tconfigs.mixed_precision_recipe(tcfg)))


def _assert_planes_equal(jq, tq, select) -> int:
    jflat, tflat = dict(_leaves(jq)), dict(_leaves(tq))
    assert jflat.keys() == tflat.keys()
    n = 0
    for path, jleaf in jflat.items():
        if not select(path):
            continue
        tleaf = tflat[path]
        assert isinstance(tleaf, QTensor) == isinstance(jleaf, JQTensor), path
        if not isinstance(jleaf, JQTensor):
            np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
            continue
        n += 1
        assert tleaf.meta.to_dict() == jleaf.meta.to_dict(), path
        for k, v in jleaf.data.items():
            v = np.asarray(v)
            assert tleaf.data[k].numpy().dtype == v.dtype, (path, k)
            np.testing.assert_array_equal(tleaf.data[k].numpy(), v,
                                          err_msg=f"{path} {k}")
    return n


@pytest.mark.parametrize("arch,kind", [(a, k) for a in ARCHS
                                       for k in ("paper", "mixed")])
def test_quantize_params_frontend_leaves_match_reference(arch, kind):
    jcfg, jp, tp = _fp_trees(arch)
    jpol, tpol = _policies(jcfg, _tcfg(arch), kind)
    jq = jax.jit(functools.partial(jquantized.quantize_params, fmt=jpol))(jp)
    tq = tquantized.quantize_params(tp, tpol)
    assert tquantized.describe_quantized(tq) == \
        jquantized.describe_quantized(jq)
    n = _assert_planes_equal(jq, tq, _frontend_leaf)
    # frontend_proj; seamless's encoder (wq wk wv wo, gelu's up and down)
    # and the decoder's 4 xattn projections
    assert n == (1 if jcfg.family == "vlm" else 1 + 6 + 4)


@pytest.mark.parametrize("kind", ["paper", "mixed"])
def test_quantize_full_width_frontend_proj_k160(kind):
    """seamless-m4t-medium's full-width projection: K = 160, one block of
    256 after padding (kept to 128 columns)."""
    jcfg = jget_config("seamless-m4t-medium")
    tcfg = tconfigs.get_config("seamless-m4t-medium")
    assert jcfg.frontend_dim == tcfg.frontend_dim == 160
    w = np.random.default_rng(3).standard_normal((160, 128)).astype(
        np.float32) / np.sqrt(160)
    jpol, tpol = _policies(jcfg, tcfg, kind)
    jq = jax.jit(functools.partial(jquantized.quantize_params, fmt=jpol))(
        {"frontend_proj": jnp.asarray(w)})
    tq = tquantized.quantize_params({"frontend_proj": torch.from_numpy(w)},
                                    tpol)
    assert _assert_planes_equal(jq, tq, lambda p: True) == 1
    assert tq["frontend_proj"].meta.shape == (160, 128)


# --- errors ------------------------------------------------------------------

def test_audio_without_frames_and_memory_length_raise():
    arch = "seamless-m4t-medium"
    cfg, jp, tp = _trees(arch)
    tcfg = _tcfg(arch)
    toks, feats = _inputs(tcfg)
    with pytest.raises(ValueError, match="seamless needs encoder frames"):
        tlm.forward(tp, toks, TRuntime(), tcfg)
    with pytest.raises(AssertionError, match="seamless needs encoder frames"):
        jlm.forward(jp, jnp.asarray(toks), JRuntime(
            compute_dtype=jnp.float32, backend="ref"), cfg)
    cache = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="memory of 6 positions against a "
                                         "cache of 8"):
        tlm.forward(tp, toks, TRuntime(), tcfg, frontend_feats=feats[:, :6],
                    cache=cache)
    assert not cache["xattn"]["k"].any()  # nothing was written
    # without a cache any length serves, as in the reference
    logits, _ = tlm.forward(tp, toks, TRuntime(), tcfg,
                            frontend_feats=feats[:, :6])
    assert torch.isfinite(logits).all()
