"""The MoE family served by the port against the live reference, on the
CPU: reduced olmoe-1b-7b (8 experts, top-2) and reduced
qwen3-moe-235b-a22b, ``itq3_s`` planes bridged from the reference.

* prefill and four decode steps of both models within 1e-4 of the
  reference's logits, each row up to its first KV rounding tie;
* greedy streams of olmoe equal the live JAX engine's on the dense and
  the paged rotated-int8 caches (one reference engine: its dense and
  paged engines give the same streams), and under W3A8 with the mixed
  policy (the untied head at q8_0, experts at itq3_s_sub, router fp), one
  host sync per step and per wave;
* a speculative run (1-layer self-draft, K = 2) equals the live JAX
  speculative engine's streams and window counters. Its verify window of
  K+1 positions routes at capacity 1 where decode never drops, so MoE
  speculation is not lossless against non-speculative decode, in the
  reference as in the port: the oracle is the reference's speculative
  engine, never the non-speculative one;
* an MoE checkpoint saved by either side restores in the other, byte for
  byte, and the reference's boots the port's ``from_checkpoint``;
* the launcher serves both models at ``--reduced`` size on the CPU.
"""
import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import mixed_precision_recipe as jrecipe
from repro.models.layers import Runtime as JRuntime
from repro.serve import spec as jspec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.quantized import QuantPolicy as JQuantPolicy
from repro.serve.quantized import quantize_params as jquantize_params
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import spec as tspec
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree
from test_torch_dense_family import forward_parity
from test_torch_policy_ckpt import _assert_trees_equal

ARCH = "olmoe-1b-7b"
# one prompt bucket and one full wave: one prefill shape per engine
SLOTS, MAX_LEN, PROMPT_PAD, MAX_NEW, K = 4, 64, 16, 8, 2
WINDOW_STATS = ("host_syncs", "tokens_decoded", "decode_steps", "spec_steps",
                "draft_proposed", "draft_accepted", "num_draft_tokens")


def _prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(0, 512, size=int(n)).astype(np.int32)
            for n in rng.integers(3, PROMPT_PAD + 1, size=SLOTS)]


def _requests(cls, sp_cls=None, sampled=False):
    mix = [dict(), dict(temperature=0.8, top_k=40, top_p=0.95, seed=3),
           dict(), dict()] if sampled else [dict()] * SLOTS
    return [cls(rid=i, prompt=p, max_new=MAX_NEW,
                **({"sampling": sp_cls(ignore_eos=True, **m)}
                   if sp_cls else {}))
            for i, (p, m) in enumerate(zip(_prompts(), mix))]


@functools.lru_cache(maxsize=None)
def _mixed():
    """The reference's mixed-policy olmoe tree and the port's copy."""
    cfg, _ = jax_quantized_params(ARCH, "itq3_s")
    from repro.models import lm as jlm
    fp = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    cfg)
    jq = jax.jit(functools.partial(
        jquantize_params, fmt=JQuantPolicy.from_dict(jrecipe(cfg))))(fp)
    return cfg, jq, params_from_numpy(to_numpy_tree(jq), device="cpu")


def _trees(kind):
    if kind == "mixed":
        return _mixed()
    cfg, jq = jax_quantized_params(ARCH, "itq3_s")
    return cfg, jq, params_from_numpy(to_numpy_tree(jq), device="cpu")


@functools.lru_cache(maxsize=None)
def _reference_streams(kind):
    cfg, jq, _ = _trees(kind)
    jeng = JServeEngine(jq, cfg, slots=SLOTS, max_len=MAX_LEN,
                        prompt_pad=PROMPT_PAD,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref",
                                    act_quant=kind == "mixed"))
    return [r.out for r in jeng.run(_requests(JRequest))]


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
def test_forward_and_decode_logits_match_reference(arch):
    forward_parity(arch, "itq3_s", True)


@pytest.mark.parametrize("kind,layout", [("itq3_s", "dense"),
                                         ("itq3_s", "paged"),
                                         ("mixed", "dense")])
def test_greedy_streams_equal_reference_engine(kind, layout):
    _, _, tp = _trees(kind)
    eng = ServeEngine(tp, tconfigs.reduced(tconfigs.get_config(ARCH)),
                      slots=SLOTS, max_len=MAX_LEN, prompt_pad=PROMPT_PAD,
                      rt=TRuntime(kv_quant=True, act_quant=kind == "mixed"),
                      device="cpu",
                      **(dict(paged=True, block_size=16)
                         if layout == "paged" else {}))
    got = eng.run(_requests(Request))
    assert [r.out for r in got] == _reference_streams(kind)
    assert all(r.finish_reason == "length" for r in got)
    st = eng.stats()
    assert st["prefill_waves"] == 1 and st["quarantined"] == 0
    assert st["host_syncs"] == st["decode_steps"] + st["prefill_waves"]
    if layout == "paged":
        assert eng.pool.used() == 0


def test_speculative_streams_equal_reference_speculative_engine():
    cfg, jq, tp = _trees("itq3_s")
    dp, dc = jspec.draft_from_params(jq, cfg, 1)
    jeng = JServeEngine(jq, cfg, slots=SLOTS, max_len=MAX_LEN,
                        prompt_pad=PROMPT_PAD, seed=5,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref"),
                        draft_params=dp, draft_cfg=dc, num_draft_tokens=K)
    want = jeng.run(_requests(JRequest, JSamplingParams, sampled=True))
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    tdp, tdc = tspec.draft_from_params(tp, tcfg, 1)
    eng = ServeEngine(tp, tcfg, slots=SLOTS, max_len=MAX_LEN,
                      prompt_pad=PROMPT_PAD, seed=5,
                      rt=TRuntime(kv_quant=True), device="cpu",
                      draft_params=tdp, draft_cfg=tdc, num_draft_tokens=K)
    got = eng.run(_requests(Request, SamplingParams, sampled=True))
    assert [r.out for r in got] == [r.out for r in want]
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in WINDOW_STATS} == {k: jst[k]
                                                for k in WINDOW_STATS}
    assert st["draft_proposed"] > 0
    assert st["host_syncs"] == st["spec_steps"] + st["prefill_waves"]


def test_moe_checkpoints_cross_over_byte_for_byte(tmp_path):
    _, jq, tq = _mixed()
    jdir = jckpt.save(str(tmp_path / "jax"), 2, jq)
    tdir = tckpt.save(str(tmp_path / "port"), 2, tq)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert any("moe__up__Q__plane2" in n for n in names)
    assert any(n.startswith("layers__moe__router") for n in names)
    _, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names, shallow=False)
    assert not mismatch and not errors, mismatch
    restored, step = tckpt.restore_params(str(tmp_path / "jax"), device="cpu")
    assert step == 2
    _assert_trees_equal(restored, jq)
    jrestored, _ = jckpt.restore_tree(str(tmp_path / "port"))
    _assert_trees_equal(tq, jrestored)
    # the reference's checkpoint boots the port's engine with no template
    # and serves the reference's W3A8 streams
    eng = ServeEngine.from_checkpoint(
        str(tmp_path / "jax"), tconfigs.reduced(tconfigs.get_config(ARCH)),
        slots=SLOTS, max_len=MAX_LEN, prompt_pad=PROMPT_PAD,
        rt=TRuntime(kv_quant=True, act_quant=True), device="cpu")
    assert [r.out for r in eng.run(_requests(Request))] == \
        _reference_streams("mixed")


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
def test_cli_serves_reduced_moe_on_cpu(arch, capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", arch, "--reduced", "--kv-quant", "--device",
                 "cpu", "--requests", "2", "--max-new", "3"])
    assert "served 2 requests / 6 tokens" in capsys.readouterr().out
