"""The recurrent families served by the port against the live reference,
on the CPU: reduced rwkv6-3b (attention-free RWKV6) and reduced zamba2-7b
(Mamba2 with one shared attention block every 3 layers, 7 layers: two
macroblocks and a one-layer tail), ``itq3_s`` planes bridged from the
reference.

* ``forward`` and ``decode_step`` logits within 1e-4 (zamba2 also on the
  rotated-int8 cache, each row up to its first KV rounding tie,
  ``test_torch_model.py`` explains the tie), the recurrent states too;
* greedy streams equal the live JAX engine's through the chunk ladder
  (``prompt_chunk=8``, prompts of 9, 5, 11 and 13 tokens over 2 slots, so
  every slot is reused and must start from a zeroed state), one host
  sync per step and per admitted request; a mixed greedy/sampled batch;
  W3A8 under the mixed policy (zamba2);
* a request preempted mid-stream resumes bit for bit, on both sides, its
  recurrent state riding the swap;
* checkpoints of both families cross over byte for byte and boot the
  port's ``from_checkpoint``;
* the paged and speculative engines refuse both families with the
  reference's wording; ``kv_quant`` on rwkv6 changes nothing; ``stats()``
  prices the attention planes per token (0 for rwkv6) and counts the
  recurrent state in ``cache_bytes``;
* the launcher serves both models at ``--reduced`` size on the CPU.
"""
import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import mixed_precision_recipe as jrecipe
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.quantized import QuantPolicy as JQuantPolicy
from repro.serve.quantized import quantize_params as jquantize_params
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import spec as tspec
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree
from test_torch_model import LOGIT_ATOL, MAX_LEN, B, T, _first_tie
from test_torch_policy_ckpt import _assert_trees_equal

ARCHS = ("rwkv6-3b", "zamba2-7b")
SLOTS, ENGINE_LEN, CHUNK, MAX_NEW, SEED = 2, 48, 8, 6, 5
PROMPT_LENS = (9, 5, 11, 13)
# greedy, a temperature, top-k, top-p with an explicit seed
MIX = [dict(), dict(temperature=0.8), dict(),
       dict(temperature=1.0, top_k=40, top_p=0.9, seed=3)]


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _requests(cls, sp_cls=None, mix=None):
    return [cls(rid=i, prompt=p, max_new=MAX_NEW,
                **({} if mix is None else
                   {"sampling": sp_cls(ignore_eos=True, **mix[i])}))
            for i, p in enumerate(_prompts())]


def _tcfg(arch):
    return tconfigs.reduced(tconfigs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _trees(arch, kind):
    """The reference's tree (uniform itq3_s, or the mixed policy: the tied
    table at q8_0, every other projection at itq3_s) and the port's copy."""
    if kind == "itq3_s":
        cfg, jq = jax_quantized_params(arch, "itq3_s")
    else:
        cfg, _ = jax_quantized_params(arch, "itq3_s")
        fp = jax.jit(jlm.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), cfg)
        jq = jax.jit(functools.partial(
            jquantize_params, fmt=JQuantPolicy.from_dict(jrecipe(cfg))))(fp)
    return cfg, jq, params_from_numpy(to_numpy_tree(jq), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_engine(arch, kind):
    """One reference engine per tree: every run below reuses its compiled
    ladder shapes."""
    cfg, jq, _ = _trees(arch, kind)
    return JServeEngine(jq, cfg, slots=SLOTS, max_len=ENGINE_LEN,
                        prompt_chunk=CHUNK, seed=SEED,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref",
                                    act_quant=kind == "mixed"))


def _engine(arch, kind="itq3_s", slots=SLOTS, **kw):
    _, _, tp = _trees(arch, kind)
    return ServeEngine(tp, _tcfg(arch), slots=slots, max_len=ENGINE_LEN,
                       prompt_chunk=CHUNK, seed=SEED,
                       rt=TRuntime(kv_quant=True, act_quant=kind == "mixed"),
                       device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _reference_streams(arch, kind, sampled=False):
    reqs = _jax_engine(arch, kind).run(_requests(
        JRequest, JSamplingParams, MIX if sampled else None))
    return [r.out for r in reqs]


def _check_counters(eng):
    st = eng.stats()
    # one sync per decode step and one per admitted request (its ladder)
    assert st["host_syncs"] == st["decode_steps"] + len(PROMPT_LENS)
    assert st["prefill_waves"] == len(PROMPT_LENS)
    # 9 = 8+1, 5 = 4+1, 11 = 8+2+1, 13 = 8+4+1
    assert st["prefill_chunks"] == 10
    assert st["quarantined"] == 0


# --- model level ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fns(cfg, kv_quant):
    rt = JRuntime(compute_dtype=jnp.float32, kv_quant=kv_quant,
                  backend="ref")
    fwd = jax.jit(lambda p, toks, c: jlm.forward(p, toks, rt, cfg, cache=c,
                                                 pos=0)[:2])
    dec = jax.jit(lambda p, toks, c, pos: jlm.decode_step(p, toks, c, pos,
                                                          rt, cfg))
    return fwd, dec


@pytest.mark.parametrize("arch,kv_quant", [("rwkv6-3b", False),
                                           ("zamba2-7b", False),
                                           ("zamba2-7b", True)])
def test_forward_and_decode_logits_match_reference(arch, kv_quant):
    cfg, jp, tp = _trees(arch, "itq3_s")
    tcfg = _tcfg(arch)
    fwd, dec = _jax_fns(cfg, kv_quant)
    rt = TRuntime(kv_quant=kv_quant)  # auto: CPU tensors -> plain versions
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, T))
    jl, jcache = fwd(jp, jnp.asarray(toks, jnp.int32),
                     jlm.init_cache(cfg, B, MAX_LEN, dtype=jnp.float32,
                                    kv_quant=kv_quant))
    tcache = tlm.init_cache(tcfg, B, MAX_LEN, kv_quant=kv_quant,
                            device="cpu")
    tl, tcache = tlm.forward(tp, toks, rt, tcfg, cache=tcache, pos=0)

    def first_tie():
        return (_first_tie(tcache, jcache) if "attn" in tcache
                else np.full(B, MAX_LEN))

    def states_close():
        for k, v in tcache["ssm"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(
                jcache["ssm"][k]), rtol=LOGIT_ATOL, atol=LOGIT_ATOL,
                err_msg=k)

    first = first_tie()
    for row in range(B):
        upto = min(first[row], T)
        np.testing.assert_allclose(tl[row, :upto].numpy(),
                                   np.asarray(jl[row, :upto]), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"row {row}")
    assert first.min() >= T // 2, "rounding ties cut most of the check"
    if not kv_quant:
        states_close()
    nxt = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    for step in range(4):
        pos = np.full(B, T + step, np.int32)
        jl2, jcache = dec(jp, jnp.asarray(nxt, jnp.int32), jcache,
                          jnp.asarray(pos))
        tl2, tcache = tlm.decode_step(tp, nxt, tcache, pos, rt, tcfg)
        first = first_tie()
        for row in np.nonzero(first > pos)[0]:
            np.testing.assert_allclose(
                tl2[row].numpy(), np.asarray(jl2[row]), rtol=0,
                atol=LOGIT_ATOL, err_msg=f"step {step} row {row}")
        if not kv_quant:
            states_close()
        nxt = np.array(jnp.argmax(jl2[:, 0], -1))[:, None]


# --- the engine -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_reference_engine(arch):
    eng = _engine(arch)
    got = eng.run(_requests(Request))
    assert [r.out for r in got] == _reference_streams(arch, "itq3_s")
    assert all(r.finish_reason == "length" for r in got)
    _check_counters(eng)


def test_mixed_sampled_batch_equals_reference_engine():
    arch = "rwkv6-3b"
    eng = _engine(arch)
    got = eng.run(_requests(Request, SamplingParams, MIX))
    assert [r.out for r in got] == _reference_streams(arch, "itq3_s", True)
    assert got[0].out == _reference_streams(arch, "itq3_s")[0]  # greedy row
    _check_counters(eng)


def test_w3a8_mixed_policy_streams_equal_reference_engine():
    arch = "zamba2-7b"
    _, _, tq = _trees(arch, "mixed")
    assert tq["embed"].meta.fmt == "q8_0"
    assert tq["mamba_blocks"]["mamba"]["wz"].meta.fmt == "itq3_s"
    assert isinstance(tq["mamba_blocks"]["mamba"]["wB"], torch.Tensor)
    eng = _engine(arch, "mixed")
    got = eng.run(_requests(Request))
    assert [r.out for r in got] == _reference_streams(arch, "mixed")
    _check_counters(eng)


def _preempted_run(eng, reqs, rid=1, at=2):
    """Serve ``reqs``, swapping request ``rid`` out after its token
    ``at``; returns the swap entry's leaves."""
    done = False
    for ev in eng.generate(reqs):
        if not done and ev.rid == rid and ev.index == at:
            assert eng.preempt(rid)
            done = True
    assert done
    return reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_preempt_resume_equals_reference_bit_for_bit(arch):
    want = _preempted_run(_jax_engine(arch, "itq3_s"), _requests(JRequest))
    assert [r.out for r in want] == _reference_streams(arch, "itq3_s")
    eng = _engine(arch)
    # the swap entry holds every leaf's rows, recurrent state included
    real = eng.preempt
    seen = {}

    def spy(rid):
        s = next(i for i, r in enumerate(eng.active)
                 if r is not None and r.rid == rid)
        seen["rows"] = {k: v[:, s].clone() for k, v in
                        eng.cache["ssm"].items()}
        ok = real(rid)
        seen["entry"] = eng._swapped[rid]["cache"]
        return ok
    eng.preempt = spy
    got = _preempted_run(eng, _requests(Request))
    assert [r.out for r in got] == [r.out for r in want]
    assert got[1].preemptions == 1
    st = eng.stats()
    assert st["preemptions"] == st["resumes"] == 1
    paths = [p for p, _, _ in seen["entry"][1]]
    assert ("ssm", sorted(seen["rows"])[0]) in paths
    assert (("attn", "k") in paths) == (arch == "zamba2-7b")
    # a resume re-prefills nothing: one ladder per request
    assert st["prefill_waves"] == len(PROMPT_LENS)


def test_admission_zeroes_the_slot_state():
    """A finished request's state must not leak into the next admitted
    to its slot: serving request 3 alone on a fresh engine and after
    three others on a one-slot engine gives the same stream."""
    arch = "rwkv6-3b"
    alone = _engine(arch, slots=1).run(_requests(Request)[3:])[0].out
    eng = _engine(arch, slots=1)
    after = eng.run(_requests(Request))[3].out
    assert after == alone == _reference_streams(arch, "itq3_s")[3]


# --- checkpoints, refusals, stats, launcher ---------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_over_byte_for_byte(arch, tmp_path):
    cfg, jq, tq = _trees(arch, "itq3_s")
    jdir = jckpt.save(str(tmp_path / "jax"), 1, jq)
    tdir = tckpt.save(str(tmp_path / "port"), 1, tq)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    marker = ("mamba_blocks__mamba__wz__Q__plane2" if arch == "zamba2-7b"
              else "layers__cm_k__Q__plane2")
    assert any(marker in n for n in names)
    _, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names, shallow=False)
    assert not mismatch and not errors, mismatch
    restored, step = tckpt.restore_params(str(tmp_path / "jax"), device="cpu")
    assert step == 1
    _assert_trees_equal(restored, jq)
    jrestored, _ = jckpt.restore_tree(str(tmp_path / "port"))
    _assert_trees_equal(tq, jrestored)
    eng = ServeEngine.from_checkpoint(
        str(tmp_path / "jax"), _tcfg(arch), slots=SLOTS, max_len=ENGINE_LEN,
        prompt_chunk=CHUNK, rt=TRuntime(kv_quant=True), device="cpu")
    assert [r.out for r in eng.run(_requests(Request))] == \
        _reference_streams(arch, "itq3_s")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_and_speculative_engines_refuse_like_reference(arch):
    cfg, jq, tq = _trees(arch, "itq3_s")
    tcfg = _tcfg(arch)
    jrt = JRuntime(compute_dtype=jnp.float32, kv_quant=True, backend="ref")
    with pytest.raises(ValueError, match="paged KV cache") as jerr:
        JServeEngine(jq, cfg, slots=SLOTS, max_len=ENGINE_LEN, rt=jrt,
                     paged=True)
    with pytest.raises(ValueError, match="paged KV cache") as terr:
        ServeEngine(tq, tcfg, slots=SLOTS, max_len=ENGINE_LEN,
                    rt=TRuntime(kv_quant=True), device="cpu", paged=True)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="speculative") as jerr:
        JServeEngine(jq, cfg, slots=SLOTS, max_len=ENGINE_LEN, rt=jrt,
                     draft_params=jq, draft_cfg=cfg)
    with pytest.raises(ValueError, match="speculative") as terr:
        ServeEngine(tq, tcfg, slots=SLOTS, max_len=ENGINE_LEN,
                    rt=TRuntime(kv_quant=True), device="cpu",
                    draft_params=tq, draft_cfg=tcfg)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="pure-attention"):
        tspec.draft_from_params(tq, tcfg, 1)


def test_kv_quant_is_a_no_op_without_attention():
    tcfg = _tcfg("rwkv6-3b")
    q = tlm.init_cache(tcfg, SLOTS, ENGINE_LEN, kv_quant=True, device="cpu")
    f = tlm.init_cache(tcfg, SLOTS, ENGINE_LEN, device="cpu")
    assert q.keys() == f.keys() == {"ssm"}
    assert {k: v.shape for k, v in q["ssm"].items()} == {
        k: v.shape for k, v in f["ssm"].items()}
    assert all(v.dtype == torch.float32 for v in q["ssm"].values())
    plain = _engine("rwkv6-3b")
    plain.rt = TRuntime()
    assert [r.out for r in plain.run(_requests(Request))] == \
        _reference_streams("rwkv6-3b", "itq3_s")


@pytest.mark.parametrize("arch", ARCHS)
def test_stats_price_attention_planes_per_token(arch):
    eng = _engine(arch)
    st = eng.stats()
    jst = _jax_engine(arch, "itq3_s").stats()
    assert st["cache_bytes"] == jst["cache_bytes"] > 0
    assert st["cache_bytes_per_token"] == jst["cache_bytes_per_token"]
    assert st["cache_bytes_reserved"] == jst["cache_bytes_reserved"]
    state_bytes = sum(v.numel() * 4 for v in eng.cache["ssm"].values())
    if arch == "rwkv6-3b":
        assert st["cache_bytes_per_token"] == 0
        assert st["cache_bytes"] == state_bytes
    else:
        # 3 shared-attention KV layers (ceil(7 / 3)), int8 codes + scales
        tcfg = _tcfg(arch)
        assert st["cache_bytes_per_token"] == \
            tconfigs.kv_cache_bytes_per_token(tcfg, kv_quant=True)
        assert st["cache_bytes"] > state_bytes


def test_family_gates_name_only_the_frontends():
    """The frontends (vlm, audio) were the last families the port refused:
    now every family of the reference builds a model and an engine, and
    an unknown family raises with the reference's words, in
    ``init_params`` and in the engine."""
    import dataclasses
    from repro.configs.base import ARCH_IDS as JARCH_IDS
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import reduced as jreduced

    assert {jget_config(a).family for a in JARCH_IDS} == set(tlm._FAMILIES)
    for arch in JARCH_IDS:
        tcfg = _tcfg(arch)
        eng = ServeEngine(tlm.init_params(tcfg, device="cpu"), tcfg, slots=1,
                          max_len=8, device="cpu")
        assert eng.cache_bytes > 0
    bad = dataclasses.replace(_tcfg("smollm-135m"), family="retnet")
    with pytest.raises(ValueError, match="unknown family 'retnet'") as err:
        tlm.init_params(bad, device="cpu")
    jbad = dataclasses.replace(jreduced(jget_config("smollm-135m")),
                               family="retnet")
    with pytest.raises(ValueError, match="unknown family") as jerr:
        jlm.init_params(jax.random.PRNGKey(0), jbad)
    assert str(err.value) == str(jerr.value)
    tp = tlm.init_params(_tcfg("smollm-135m"), device="cpu")
    with pytest.raises(ValueError, match="unknown family 'retnet'"):
        ServeEngine(tp, bad, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_reduced_arch_on_cpu(arch, capsys):
    from repro_torch.launch import serve as tserve
    argv = ["--arch", arch, "--reduced", "--kv-quant", "--device", "cpu",
            "--requests", "2", "--max-new", "3"]
    tserve.main(argv)
    out = capsys.readouterr().out
    assert "served 2 requests / 6 tokens" in out
    tserve.main(argv)
    again = capsys.readouterr().out
    ids = [line for line in out.splitlines() if "rid=" in line]
    assert ids and ids == [line for line in again.splitlines()
                           if "rid=" in line]
