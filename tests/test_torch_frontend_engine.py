"""The frontend families through the port's engine, on the CPU, served as
the reference's engine serves them: requests carry tokens only.

* reduced phi-3-vision-4.2b (``vlm``) serves text with its longer cache
  (``max_len + frontend_len`` positions): greedy streams equal the live
  JAX ``ServeEngine``'s on the dense and the paged rotated-int8 caches,
  the paged table as wide as the reference's, and ``stats()`` prices a
  position as the reference does;
* a 1-layer self-draft speculative run equals the port's
  non-speculative streams;
* the mixed-policy tree (W3A8) booted with ``from_checkpoint``, from the
  reference's checkpoint and from the port's, streams what the in-memory
  engine streamed; both models' trees cross over byte for byte;
* an audio engine (reduced seamless-m4t-medium) is built on both sides
  and fails at its first admission with "seamless needs encoder frames";
* the launcher serves ``--arch phi-3-vision-4.2b --reduced --kv-quant`` on
  the CPU.
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
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.quantized import QuantPolicy as JQuantPolicy
from repro.serve.quantized import quantize_params as jquantize_params
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import spec as tspec
from repro_torch.serve.engine import Request, ServeEngine
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree
from test_torch_policy_ckpt import _assert_trees_equal

VLM, AUDIO = "phi-3-vision-4.2b", "seamless-m4t-medium"
# one prompt bucket and one full wave: one prefill shape per engine
SLOTS, MAX_LEN, PROMPT_PAD, MAX_NEW, BLOCK = 4, 48, 16, 6, 16


def _tcfg(arch):
    return tconfigs.reduced(tconfigs.get_config(arch))


def _prompts():
    rng = np.random.default_rng(29)
    return [rng.integers(0, 512, size=int(n)).astype(np.int32)
            for n in rng.integers(3, PROMPT_PAD + 1, size=SLOTS)]


def _requests(cls):
    return [cls(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]


@functools.lru_cache(maxsize=None)
def _trees(arch, kind):
    """The reference's tree (uniform itq3_s, or the mixed policy) and the
    port's copy."""
    if kind == "itq3_s":
        cfg, jq = jax_quantized_params(arch, "itq3_s")
    else:
        cfg, _ = jax_quantized_params(arch, "itq3_s")
        fp = jax.jit(jlm.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), cfg)
        jq = jax.jit(functools.partial(
            jquantize_params, fmt=JQuantPolicy.from_dict(jrecipe(cfg))))(fp)
    return cfg, jq, params_from_numpy(to_numpy_tree(jq), device="cpu")


def _jax_engine(paged=False):
    cfg, jq, _ = _trees(VLM, "itq3_s")
    return JServeEngine(jq, cfg, slots=SLOTS, max_len=MAX_LEN,
                        prompt_pad=PROMPT_PAD,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref"),
                        **(dict(paged=True, block_size=BLOCK) if paged
                           else {}))


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The live JAX engine's streams and stats (one dense engine, run
    once per module)."""
    jeng = _jax_engine()
    return [r.out for r in jeng.run(_requests(JRequest))], jeng.stats()


def _engine(kind="itq3_s", **kw):
    _, _, tp = _trees(VLM, kind)
    return ServeEngine(tp, _tcfg(VLM), slots=SLOTS, max_len=MAX_LEN,
                       prompt_pad=PROMPT_PAD,
                       rt=TRuntime(kv_quant=True,
                                   act_quant=kind == "mixed"),
                       device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _port_streams(kind="itq3_s"):
    return [r.out for r in _engine(kind).run(_requests(Request))]


@pytest.mark.parametrize("paged", [False, True])
def test_vlm_text_streams_equal_reference_engine(paged):
    want, jst = _reference_run()
    eng = _engine(**(dict(paged=True, block_size=BLOCK) if paged else {}))
    frontend = eng.cfg.frontend_len
    assert frontend == 8
    got = eng.run(_requests(Request))
    assert [r.out for r in got] == want
    assert all(r.finish_reason == "length" for r in got)
    st = eng.stats()
    assert st["prefill_waves"] == 1 and st["quarantined"] == 0
    assert st["host_syncs"] == st["decode_steps"] + st["prefill_waves"]
    if paged:
        # the table reaches max_len + frontend_len, as the reference's does
        jeng = _jax_engine(paged=True)
        assert eng._maxb == jeng._maxb == -(-(MAX_LEN + frontend) // BLOCK)
        assert eng.num_blocks == jeng.num_blocks == SLOTS * eng._maxb + 1
        jst = jeng.stats()
        assert eng.pool.used() == 0
    else:
        assert eng.cache["attn"]["k"].shape[3] == MAX_LEN + frontend
        # a position is priced by the cache's real length, not max_len
        assert st["cache_bytes_per_token"] == \
            tconfigs.kv_cache_bytes_per_token(eng.cfg, kv_quant=True)
    for key in ("cache_bytes", "cache_bytes_per_token",
                "cache_bytes_reserved"):
        assert st[key] == jst[key], key


def test_self_draft_speculation_equals_plain_streams():
    tcfg = _tcfg(VLM)
    _, _, tp = _trees(VLM, "itq3_s")
    dp, dc = tspec.draft_from_params(tp, tcfg, 1)
    eng = _engine(draft_params=dp, draft_cfg=dc, num_draft_tokens=2)
    assert eng.draft_cache["attn"]["k"].shape[3] == \
        MAX_LEN + 2 + tcfg.frontend_len
    got = eng.run(_requests(Request))
    assert [r.out for r in got] == _port_streams()
    st = eng.stats()
    assert st["draft_proposed"] > 0
    assert st["host_syncs"] == st["spec_steps"] + st["prefill_waves"]


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_checkpoints_cross_over_byte_for_byte(arch, tmp_path):
    _, jq, tq = _trees(arch, "mixed")
    jdir = jckpt.save(str(tmp_path / "jax"), 4, jq)
    tdir = tckpt.save(str(tmp_path / "port"), 4, tq)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert any("frontend_proj__Q__plane2" in n for n in names)
    if arch == AUDIO:
        assert any("encoder__attn__wq__Q__plane2" in n for n in names)
        assert any("layers__xattn__wk__Q__plane2" in n for n in names)
        assert any(n.startswith("enc_ln_f__bias") for n in names)
    _, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names, shallow=False)
    assert not mismatch and not errors, mismatch
    restored, step = tckpt.restore_params(str(tmp_path / "jax"), device="cpu")
    assert step == 4
    _assert_trees_equal(restored, jq)
    jrestored, _ = jckpt.restore_tree(str(tmp_path / "port"))
    _assert_trees_equal(tq, jrestored)
    if arch == VLM:
        # W3A8 booted from either side's checkpoint streams what the
        # in-memory engine streamed
        for d in ("jax", "port"):
            eng = ServeEngine.from_checkpoint(
                str(tmp_path / d), _tcfg(VLM), slots=SLOTS, max_len=MAX_LEN,
                prompt_pad=PROMPT_PAD,
                rt=TRuntime(kv_quant=True, act_quant=True), device="cpu")
            assert [r.out for r in eng.run(_requests(Request))] == \
                _port_streams("mixed")


def test_audio_engine_fails_at_first_admission_like_reference():
    cfg, jq, tq = _trees(AUDIO, "itq3_s")
    jeng = JServeEngine(jq, cfg, slots=2, max_len=MAX_LEN,
                        prompt_pad=PROMPT_PAD,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref"))
    eng = ServeEngine(tq, _tcfg(AUDIO), slots=2, max_len=MAX_LEN,
                      prompt_pad=PROMPT_PAD, rt=TRuntime(kv_quant=True),
                      device="cpu")
    # built as the reference builds it: the self-attention planes and the
    # fp cross-attention memory
    assert eng.cache_bytes == jeng.cache_bytes
    assert eng.stats()["cache_bytes_per_token"] == \
        jeng.stats()["cache_bytes_per_token"]
    assert set(eng.cache) == {"attn", "xattn"}
    for e, req in ((jeng, JRequest), (eng, Request)):
        with pytest.raises((AssertionError, ValueError),
                           match="seamless needs encoder frames"):
            e.run(_requests(req)[:1])


def test_cli_serves_reduced_vlm_on_cpu(capsys):
    from repro_torch.launch import serve as tserve
    argv = ["--arch", VLM, "--reduced", "--kv-quant", "--device", "cpu",
            "--requests", "2", "--max-new", "3"]
    tserve.main(argv)
    out = capsys.readouterr().out
    assert "served 2 requests / 6 tokens" in out
    tserve.main(argv)
    ids = [line for line in out.splitlines() if "rid=" in line]
    assert ids and ids == [line for line in capsys.readouterr(
        ).out.splitlines() if "rid=" in line]
