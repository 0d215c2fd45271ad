"""Full-model parity: the port's ``forward`` / ``decode_step`` against the
live reference's, from the same bridged planes, on the CPU.

Reduced smollm-135m (GQA) and reduced qwen1.5-0.5b (MHA, QKV bias), with
the rotated-int8 KV cache: prefill logits, then four teacher-forced
decode steps at ragged per-row positions, within atol 1e-4.

Both sides compute in f32, summed in another order by XLA's and
PyTorch's CPU kernels, so K/V reach ``kv_encode`` differing by ~1e-7
relative. About one int8 code (or fp16 scale) in 4e4 then rounds to the
neighbouring value on the two sides — a rounding tie, not a port fault —
and the row's later logits move by up to ~1e-3 from there on. So each
row is held to atol 1e-4 up to its first cache position whose codes or
scales differ, and that first difference must be one rounding step.
Without the q8 cache the logits agree everywhere.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jconfigs
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime as TRuntime
from test_torch_bridge import jax_quantized_params, to_numpy_tree

LOGIT_ATOL = 1e-4
B, T, MAX_LEN = 2, 12, 32
CASES = [(arch, fmt, True, "activations")
         for arch in ("smollm-135m", "qwen1.5-0.5b")
         for fmt in ("itq3_s", "itq3_s_sub", "itq3_x")] + [
    ("smollm-135m", "itq3_s", False, "activations"),  # fp cache
]


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_configs_match_reference(arch):
    for get in (lambda m: m.get_config(arch),
                lambda m: m.reduced(m.get_config(arch))):
        tcfg, jcfg = get(tconfigs), get(jconfigs)
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
        for kvq in (False, True):
            assert (tconfigs.kv_cache_bytes_per_token(tcfg, kv_quant=kvq)
                    == jconfigs.kv_cache_bytes_per_token(jcfg, kv_quant=kvq))


def _params(arch, fmt):
    """Reference-quantized params (random QKV biases where the arch has
    them, so the bias path carries signal) and the port's bridged copy."""
    cfg, jp = jax_quantized_params(arch, fmt)
    if cfg.qkv_bias:
        rng = np.random.default_rng(1)
        attn = dict(jp["layers"]["attn"])
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(
                0.1 * rng.standard_normal(attn[b].shape).astype(np.float32))
        jp = dict(jp, layers=dict(jp["layers"], attn=attn))
    return cfg, jp, params_from_numpy(to_numpy_tree(jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_fns(cfg, kv_quant, mode):
    rt = JRuntime(compute_dtype=jnp.float32, kv_quant=kv_quant,
                  backend="ref", quant_mode=mode)
    fwd = jax.jit(lambda p, toks, c: jlm.forward(p, toks, rt, cfg, cache=c,
                                                 pos=0)[:2])
    dec = jax.jit(lambda p, toks, c, pos: jlm.decode_step(p, toks, c, pos,
                                                          rt, cfg))
    return fwd, dec


def _first_tie(tcache, jcache) -> np.ndarray:
    """Per batch row: the first cache position whose int8 codes or fp16
    scales differ between port and reference (MAX_LEN if none), after
    checking that the difference there is one rounding step."""
    first = np.full(B, MAX_LEN)
    if "k_scale" not in tcache["attn"]:
        return first
    for key in ("k", "v", "k_scale", "v_scale"):
        t = tcache["attn"][key].numpy()
        j = np.asarray(jcache["attn"][key])
        for row in range(B):  # leaves are (L, B, KV, T, X)
            diff = np.argwhere(t[:, row] != j[:, row])
            if not len(diff):
                continue
            p = diff[:, 2].min()
            at = diff[diff[:, 2] == p]
            if key in ("k", "v"):
                steps = np.abs(t[:, row].astype(np.int32)
                               - j[:, row].astype(np.int32))
            else:  # adjacent fp16 values differ by one in their bits
                steps = np.abs(t[:, row].view(np.int16).astype(np.int32)
                               - j[:, row].view(np.int16).astype(np.int32))
            assert steps[tuple(at.T)].max() == 1, (key, row, p)
            first[row] = min(first[row], p)
    return first


@pytest.mark.parametrize("arch,fmt,kv_quant,mode", CASES)
def test_prefill_and_decode_logits_match_reference(arch, fmt, kv_quant, mode):
    cfg, jp, tp = _params(arch, fmt)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    fwd, dec = _jax_fns(cfg, kv_quant, mode)
    rt = TRuntime(kv_quant=kv_quant, quant_mode=mode)  # auto: CPU -> plain
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, T))
    jl, jcache = fwd(jp, jnp.asarray(toks, jnp.int32),
                     jlm.init_cache(cfg, B, MAX_LEN, dtype=jnp.float32,
                                    kv_quant=kv_quant))
    tcache = tlm.init_cache(tcfg, B, MAX_LEN, kv_quant=kv_quant,
                            device="cpu")
    tl, tcache = tlm.forward(tp, toks, rt, tcfg, cache=tcache, pos=0)
    first = _first_tie(tcache, jcache)
    compared = 0
    for row in range(B):
        upto = min(first[row], T)
        np.testing.assert_allclose(tl[row, :upto].numpy(),
                                   np.asarray(jl[row, :upto]), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"row {row}")
        compared += upto
    assert compared >= B * T // 2, "rounding ties cut most of the check"
    # ragged decode: row 0 resumes inside its padded prefill span
    pos = np.array([T - 3, T], np.int32)
    nxt = np.array(jnp.argmax(jl[np.arange(B), pos - 1], -1))[:, None]
    for step in range(4):
        jl2, jcache = dec(jp, jnp.asarray(nxt, jnp.int32), jcache,
                          jnp.asarray(pos + step))
        tl2, tcache = tlm.decode_step(tp, nxt, tcache, pos + step, rt, tcfg)
        first = _first_tie(tcache, jcache)
        for row in np.nonzero(first > pos + step)[0]:
            np.testing.assert_allclose(
                tl2[row].numpy(), np.asarray(jl2[row]), rtol=0,
                atol=LOGIT_ATOL, err_msg=f"step {step} row {row}")
        nxt = np.array(jnp.argmax(jl2[:, 0], -1))[:, None]


def test_forward_without_cache_and_last_idx_match_reference():
    cfg, jp, tp = _params("smollm-135m", "itq3_s")
    tcfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    rt_j = JRuntime(compute_dtype=jnp.float32, backend="ref")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, T))
    last = np.array([4, T - 1])
    want = jax.jit(lambda p, t: jlm.forward(p, t, rt_j, cfg, last_idx=last)[0])(
        jp, jnp.asarray(toks, jnp.int32))
    got, cache = tlm.forward(tp, toks, TRuntime(), tcfg, last_idx=last)
    assert cache is None and got.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_without_token_write_back_matches_token_path(kv_quant):
    """``decode_token_cache=False`` writes the token through the span path
    inside attention; logits and cache equal the token-write path (the fp
    cache to f32 rounding: its two attention forms sum differently)."""
    _, _, tp = _params("smollm-135m", "itq3_s")
    cfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, T))
    pos = np.array([T - 3, T])
    runs = []
    for token_cache in (True, False):
        rt = TRuntime(kv_quant=kv_quant, decode_token_cache=token_cache)
        cache = tlm.init_cache(cfg, B, MAX_LEN, kv_quant=kv_quant,
                               device="cpu")
        tlm.forward(tp, toks, rt, cfg, cache=cache, pos=0)
        logits, cache = tlm.decode_step(tp, toks[:, :1], cache, pos, rt, cfg)
        runs.append((logits, cache))
    (l1, c1), (l2, c2) = runs
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=0, atol=1e-6)
    for key in c1["attn"]:
        np.testing.assert_allclose(c1["attn"][key].float().numpy(),
                                   c2["attn"][key].float().numpy(), rtol=0,
                                   atol=1e-6 if not kv_quant else 0)


def test_greedy_sampling_and_finite_rows():
    import torch
    logits = torch.tensor([[0.0, 2.0, 2.0], [1.0, float("nan"), 0.0]])
    assert tlm.sample_tokens(logits).tolist() == [1, 1]  # first max on ties
    assert tlm.finite_rows(logits).tolist() == [True, False]
    # a temperature without a key stays greedy, as in the reference
    assert tlm.sample_tokens(logits, temperature=0.7).tolist() == [1, 1]


def test_init_params_seeded_and_quantizable():
    from repro_torch.serve.quantized import quantize_params
    cfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-0.5b"))
    a = tlm.init_params(cfg, seed=3, device="cpu")
    b = tlm.init_params(cfg, seed=3, device="cpu")
    assert (a["layers"]["mlp"]["down"] == b["layers"]["mlp"]["down"]).all()
    assert a["layers"]["attn"]["wq"].shape == (cfg.num_layers, cfg.d_model,
                                               cfg.num_heads * 32)
    q = quantize_params(a, "itq3_s")
    assert q["layers"]["attn"]["wq"].meta.shape == (cfg.d_model,
                                                    cfg.num_heads * 32)
    assert not hasattr(q["embed"], "meta")  # tied table stays fp
    wq = q["layers"]["attn"]["wq"]  # the kernels read row-major planes
    for qt in (wq, wq.layer(1)):
        assert all(v.is_contiguous() for v in qt.data.values())
    assert q["layers"]["attn"]["bq"] is a["layers"]["attn"]["bq"]
