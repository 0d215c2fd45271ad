"""The rest of the dense family on the port against the live reference,
on the CPU: the relu2 and gelu MLPs, LayerNorm with its bias, untied
heads and partial rotary, in reduced nemotron-4-15b (LayerNorm, relu2, GQA
48/8, untied) and reduced stablelm-3b (LayerNorm, swiglu, rotary_pct
0.25, untied).

* ``mlp_apply``: gelu (``jax.nn.gelu``'s tanh form) within 1e-6
  relative, relu2 bit for bit (the same f32 products, then exact ops);
* the seeded init trees have the reference's keys and shapes (LayerNorm
  biases, no ``gate`` for relu2, ``lm_head``);
* prefill and four decode steps of the bridged ``itq3_s`` models within
  1e-4 of the reference's logits, each row up to its first KV rounding
  tie (``test_torch_model.py`` explains the tie);
* greedy engine streams equal the live JAX engine's: nemotron on the
  rotated-int8 KV cache, stablelm on the fp cache (its full-width
  head_dim 80 has no int8 codec);
* a head_dim-80 ``kv_quant`` cache and codec are refused as the
  reference refuses them;
* the launcher serves both models at ``--reduced`` size on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.models.layers import mlp_apply as jmlp_apply
from repro.serve import kv_quant as jkv
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.models.layers import mlp_apply as tmlp_apply
from repro_torch.serve import kv_quant as tkv
from repro_torch.serve.engine import Request, ServeEngine
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree
from test_torch_model import LOGIT_ATOL, MAX_LEN, B, T, _first_tie, _jax_fns

ARCHS = ("nemotron-4-15b", "stablelm-3b")
# stablelm serves on the fp cache: its full-width head_dim 80 has no codec
KV_QUANT = {"nemotron-4-15b": True, "stablelm-3b": False}
SLOTS, ENGINE_LEN, MAX_NEW = 4, 64, 6


@pytest.mark.parametrize("activation", ["gelu", "relu2", "swiglu"])
def test_mlp_apply_matches_reference(activation):
    rng = np.random.default_rng(0)
    d, f = 128, 256
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))}
    if activation != "swiglu":
        del p["gate"]
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = np.asarray(jax.jit(lambda pp, xx: jmlp_apply(
        pp, xx, JRuntime(compute_dtype=jnp.float32), activation))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = tmlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), TRuntime(), activation).numpy()
    if activation == "relu2":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="activation"):
        tmlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                   torch.from_numpy(x), TRuntime(), "tanh")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    jcfg = jreduced(jget_config(arch))
    want = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda k: jlm.init_params(k, jcfg), jax.random.PRNGKey(0)))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    got = tlm.init_params(tcfg, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), got) == want
    layers = got["layers"]
    assert ("gate" in layers["mlp"]) == (tcfg.activation == "swiglu")
    assert torch.equal(layers["ln1"]["bias"], torch.zeros(4, 128))
    assert "lm_head" in got and "bias" in got["ln_f"]


def forward_parity(arch: str, fmt: str, kv_quant: bool) -> None:
    """Prefill then four ragged decode steps of the bridged reduced
    ``arch``, port against reference, each row within LOGIT_ATOL up to
    its first KV rounding tie."""
    cfg, jp = jax_quantized_params(arch, fmt)
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    fwd, dec = _jax_fns(cfg, kv_quant, "activations")
    rt = TRuntime(kv_quant=kv_quant)  # auto: CPU tensors -> plain versions
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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_logits_match_reference(arch):
    forward_parity(arch, "itq3_s", KV_QUANT[arch])


def _prompts():
    rng = np.random.default_rng(17)
    return [rng.integers(0, 512, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 16, size=SLOTS)]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_reference_engine(arch):
    cfg, jp = jax_quantized_params(arch, "itq3_s")
    kvq = KV_QUANT[arch]
    jeng = JServeEngine(jp, cfg, slots=SLOTS, max_len=ENGINE_LEN,
                        prompt_pad=16,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=kvq,
                                    backend="ref"))
    want = jeng.run([JRequest(rid=i, prompt=p, max_new=MAX_NEW)
                     for i, p in enumerate(_prompts())])
    eng = ServeEngine(params_from_numpy(to_numpy_tree(jp), device="cpu"),
                      tconfigs.reduced(tconfigs.get_config(arch)),
                      slots=SLOTS, max_len=ENGINE_LEN, prompt_pad=16,
                      rt=TRuntime(kv_quant=kvq), device="cpu")
    got = eng.run([Request(rid=i, prompt=p, max_new=MAX_NEW)
                   for i, p in enumerate(_prompts())])
    assert [r.out for r in got] == [r.out for r in want]
    st = eng.stats()
    assert st["host_syncs"] == st["decode_steps"] + st["prefill_waves"]
    assert st["cache_bytes"] == jeng.stats()["cache_bytes"]


def test_head_dim_80_kv_quant_refused_like_reference():
    """stablelm-3b's head_dim 80: the rotated-int8 cache and its codec
    need a power-of-two head_dim, on both sides."""
    jcfg = jget_config("stablelm-3b")
    tcfg = tconfigs.get_config("stablelm-3b")
    assert jcfg.resolved_head_dim == tcfg.resolved_head_dim == 80
    small = dataclasses.replace(tconfigs.reduced(tcfg), head_dim=80)
    jsmall = dataclasses.replace(jreduced(jcfg), head_dim=80)
    with pytest.raises(ValueError, match="power-of-two") as terr:
        tlm.init_cache(small, 1, 8, kv_quant=True, device="cpu")
    with pytest.raises(ValueError, match="power-of-two") as jerr:
        jlm.init_cache(jsmall, 1, 8, kv_quant=True)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="power of two"):
        tkv.kv_encode(torch.zeros(1, 80))
    with pytest.raises(ValueError, match="power of two"):
        jkv.kv_encode(jnp.zeros((1, 80)))
    # the fp cache serves it
    cache = tlm.init_cache(small, 1, 8, kv_quant=False, device="cpu")
    assert cache["attn"]["k"].shape[-1] == 80


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_reduced_arch_on_cpu(arch, capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--requests", "2", "--max-new", "3"]
                + (["--kv-quant"] if KV_QUANT[arch] else []))
    assert "served 2 requests / 6 tokens" in capsys.readouterr().out
