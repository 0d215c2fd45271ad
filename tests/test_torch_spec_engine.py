"""The port's speculative ServeEngine against the live JAX speculative
engine and against its own non-speculative engine, on the CPU.

Reduced smollm-135m, ``itq3_s`` planes bridged from the reference,
rotated-int8 KV cache, 6 slots, a 1-layer self-draft and K = 2. One live
JAX engine, the reference's paged speculative engine, serves as the
oracle of both port layouts (the reference's dense and paged engines give
the same streams) and runs once per module. Held:

* a mixed batch (greedy, temperature with top-k and top-p, explicit
  seeds) on the dense-q8 and the paged-q8 layouts: every stream equal to
  the JAX speculative engine's token for token, with equal window
  counters; the greedy streams also equal the port's non-speculative
  engine's; one host sync per window and per wave; the target and draft
  caches written in place;
* the ``draft=False`` and ``draft_tokens=0`` opt-outs: every stream,
  sampled ones included, equal to the non-speculative engine's;
* a perfect draft (the full-depth self-draft): acceptance 1.0 and
  ``ceil(max_new / (K+1))`` windows per request;
* a cancel, a preemption and a decode timeout landing between windows of
  the paged engine, after its batch, on sampled requests: the reference's
  finish reasons, streams, events and fault log;
* a paged pool too small for the batch: preemptions and resumes, every
  stream the reference's, the pool drained and consistent;
* the constructor's refusals, the ``stats()`` keys and the launcher's
  ``--draft-depth`` / ``--num-draft-tokens``.

Never compared with the committed golden files (ROADMAP Queue 3).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.layers import Runtime as JRuntime
from repro.serve import spec as jspec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.faults import Fault as JFault
from repro.serve.faults import FaultPlan as JFaultPlan
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import spec as tspec
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.faults import Fault, FaultPlan
from repro_torch.serve.sampling import SamplingParams
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree

# Each distinct shape or form of the reference's jitted prefill, propose
# and verify is one compile of several seconds, so the traffic keeps to
# one of each: every request of a batch in one wave (SLOTS of them, their
# prompts in one PROMPT_PAD bucket); every sampled row carries both
# filters (their values differ per row); sampled rows run longer than the
# greedy ones, so a sampled row is live in every window.
SLOTS, MAX_LEN, PROMPT_PAD, K, DEPTH, SEED = 6, 64, 16, 2, 1, 5
MAX_NEW, GREEDY_NEW = 12, 8
MIX = [dict(), dict(temperature=0.8, top_k=40, top_p=0.95),
       dict(temperature=1.0, top_k=5, top_p=0.9), dict(),
       dict(temperature=0.7, top_k=100, top_p=0.8, seed=3),
       dict(temperature=1.3, top_k=20, top_p=0.99, seed=99)]
LAYOUTS = {"dense_q8": {}, "paged_q8": dict(paged=True, block_size=16)}
# the port's host-wall counters, which the reference's stats() lacks
PORT_ONLY_STATS = {"decode_seconds", "prefill_waves", "prefill_seconds"}
WINDOW_STATS = ("host_syncs", "tokens_decoded", "decode_steps", "spec_steps",
                "draft_proposed", "draft_accepted", "cache_donated",
                "cache_bytes_moved", "num_draft_tokens")


def _prompts(n=len(MIX)):
    rng = np.random.default_rng(13)
    # one prompt bucket (PROMPT_PAD): one prefill shape per engine
    return [rng.integers(0, 512, size=int(k)).astype(np.int32)
            for k in rng.integers(3, PROMPT_PAD + 1, size=n)]


def _requests(cls, sp_cls, mix=MIX, **over):
    return [cls(rid=i, prompt=p, max_new=MAX_NEW if m else GREEDY_NEW,
                sampling=sp_cls(ignore_eos=True, **m, **over))
            for i, (p, m) in enumerate(zip(_prompts(len(mix)), mix))]


@functools.lru_cache(maxsize=None)
def _port_params():
    _, jp = jax_quantized_params("smollm-135m", "itq3_s")
    return params_from_numpy(to_numpy_tree(jp), device="cpu")


def _tcfg():
    return tconfigs.reduced(tconfigs.get_config("smollm-135m"))


def _port_engine(layout="dense_q8", depth=DEPTH, **kw):
    kw.setdefault("slots", SLOTS)
    params, cfg = _port_params(), _tcfg()
    if depth:
        dp, dc = tspec.draft_from_params(params, cfg, depth)
        kw.update(draft_params=dp, draft_cfg=dc, num_draft_tokens=K)
    return ServeEngine(params, cfg, max_len=MAX_LEN, prompt_pad=PROMPT_PAD,
                       seed=SEED, rt=TRuntime(kv_quant=True), device="cpu",
                       **LAYOUTS[layout], **kw)


def _jax_engine():
    """The reference's paged speculative engine: the oracle of both port
    layouts (its dense and paged engines give the same streams, the
    reference's own paged contract)."""
    cfg, jp = jax_quantized_params("smollm-135m", "itq3_s")
    dp, dc = jspec.draft_from_params(jp, cfg, DEPTH)
    return JServeEngine(jp, cfg, slots=SLOTS, max_len=MAX_LEN,
                        prompt_pad=PROMPT_PAD, seed=SEED,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref"),
                        draft_params=dp, draft_cfg=dc, num_draft_tokens=K,
                        **LAYOUTS["paged_q8"])


def _session(eng, req_cls, sp_cls, fault_cls, plan_cls):
    """One engine's traffic: the mixed batch, then, on a paged engine, a
    full wave of sampled requests with a cancel and a preemption landing
    between windows and a decode timeout. Returns (the batch's requests,
    stats after the batch[, chaos requests, chaos events, fault log])."""
    out = (eng.run(_requests(req_cls, sp_cls)), eng.stats())
    if not eng.paged:
        return out
    step = eng.decode_steps
    eng.faults = plan_cls([fault_cls("cancel", step=step + 3, rid=0),
                           fault_cls("preempt", step=step + 4, rid=1)])
    kw = [dict(max_new=12), dict(max_new=12),
          dict(max_new=12, decode_timeout_ms=0.0)] + [
        dict(max_new=6)] * (SLOTS - 3)
    reqs = [req_cls(rid=i, prompt=np.arange(4 + 3 * i % 7, dtype=np.int32),
                    sampling=sp_cls(temperature=0.9, top_k=50, top_p=0.95,
                                    seed=i, ignore_eos=True), **k)
            for i, k in enumerate(kw)]
    events = [(e.rid, e.token, e.index, e.finished, e.finish_reason)
              for e in eng.generate(reqs)]
    return out + (reqs, events, eng.faults.log)


@functools.lru_cache(maxsize=None)
def _reference():
    return _session(_jax_engine(), JRequest, JSamplingParams, JFault,
                    JFaultPlan)


def _cache_ptrs(eng):
    """Storage of every cache leaf, the draft's too: equal before and
    after serving iff every step wrote in place."""
    return [v.data_ptr() for t in (eng.cache, eng.draft_cache)
            for v in t["attn"].values()]


@functools.lru_cache(maxsize=None)
def _port_session(layout):
    eng = _port_engine(layout)
    ptrs = _cache_ptrs(eng)
    out = _session(eng, Request, SamplingParams, Fault, FaultPlan)
    return eng, ptrs, out


@functools.lru_cache(maxsize=None)
def _non_spec():
    """The non-speculative engine's streams of the mixed batch."""
    reqs = _port_engine(depth=0).run(_requests(Request, SamplingParams))
    return [r.out for r in reqs]


def _check_drained(eng):
    assert all(r is None for r in eng.active)
    assert (eng._slot_draft_k == 0).all()
    if eng.paged:
        assert eng.pool.used() == 0, "pool blocks leaked"
        eng.pool.check(eng._table)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_streams_equal_reference_and_greedy_lossless(layout):
    eng, ptrs, (reqs, st, *_) = _port_session(layout)
    jreqs, jst = _reference()[:2]
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    nonspec = _non_spec()
    for r in reqs:
        if r.sampling.temperature == 0:
            assert r.out == nonspec[r.rid], f"greedy rid {r.rid} diverged"
    assert {k: st[k] for k in WINDOW_STATS} == {k: jst[k]
                                                for k in WINDOW_STATS}
    assert st["host_syncs"] == st["spec_steps"] + st["prefill_waves"]
    assert st["spec_steps"] == st["decode_steps"] > 0
    assert st["draft_proposed"] > 0 and st["cache_donated"]
    assert _cache_ptrs(eng) == ptrs  # target and draft caches in place
    assert sum(r.spec_windows for r in reqs) >= st["spec_steps"]
    assert all(r.finish_reason == "length" and len(r.out) == r.max_new
               for r in reqs)
    _check_drained(eng)


@pytest.mark.parametrize("optout", [dict(draft=False),
                                    dict(draft_tokens=0)],
                         ids=["draft", "draft_tokens"])
def test_optouts_commit_the_non_speculative_stream(optout):
    eng = _port_engine()
    reqs = eng.run(_requests(Request, SamplingParams, **optout))
    assert [r.out for r in reqs] == _non_spec()
    st = eng.stats()
    assert st["draft_proposed"] == st["draft_accepted"] == 0
    assert st["tokens_per_step"] <= SLOTS
    _check_drained(eng)


def test_perfect_draft_full_acceptance_accounting():
    cfg = _tcfg()
    eng = _port_engine(depth=cfg.num_layers)
    reqs = [Request(rid=i, prompt=(np.arange(5 + 3 * i) % cfg.vocab_size
                                   ).astype(np.int32), max_new=MAX_NEW)
            for i in range(3)]
    eng.run(reqs)
    st = eng.stats()
    assert st["acceptance_rate"] == pytest.approx(1.0)
    assert st["draft_accepted"] == st["draft_proposed"] > 0
    assert st["tokens_per_step"] > 2.0
    assert all(r.spec_windows == -(-MAX_NEW // (K + 1)) for r in reqs)
    for r in reqs:
        rs = r.stats()
        assert r.finish_reason == "length"
        assert rs["draft_accepted"] == rs["draft_proposed"] == r.drafted
        assert rs["acceptance_rate"] == pytest.approx(1.0)
    assert [r.out for r in reqs] == [r.out for r in _port_engine(depth=0).run(
        [Request(rid=r.rid, prompt=r.prompt, max_new=MAX_NEW) for r in reqs])]


def test_midwindow_cancel_preempt_deadline_equal_reference():
    eng, _, (_, _, reqs, events, log) = _port_session("paged_q8")
    _, _, jreqs, jevents, jlog = _reference()
    assert [r.finish_reason for r in reqs] == [
        "cancelled", "length", "deadline"] + ["length"] * (SLOTS - 3)
    assert [r.finish_reason for r in reqs] == [r.finish_reason
                                               for r in jreqs]
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert events == jevents and log == jlog and len(log) == 2
    assert reqs[1].preemptions >= 1 and 1 <= len(reqs[2].out) < 12
    for r in reqs:
        idx = [e[2] for e in events if e[0] == r.rid]
        assert idx == sorted(set(idx)), f"rid {r.rid}: indices not dense"
        assert sum(e[3] for e in events if e[0] == r.rid) == 1
    _check_drained(eng)


def test_tiny_paged_pool_preempts_and_stays_lossless():
    """Five usable blocks for six requests: windows preempt and resume
    slots, and every stream, sampled ones included, stays the reference's
    (the greedy ones the non-speculative engine's)."""
    eng = _port_engine("paged_q8", num_blocks=6)
    reqs = eng.run(_requests(Request, SamplingParams))
    assert [r.out for r in reqs] == [r.out for r in _reference()[0]]
    st = eng.stats()
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    _check_drained(eng)


def test_constructor_refusals_match_reference():
    params, cfg = _port_params(), _tcfg()
    dp, dc = tspec.draft_from_params(params, cfg, 1)
    base = dict(slots=2, max_len=48, rt=TRuntime(kv_quant=True),
                device="cpu", draft_params=dp)
    for kw, match in ((dict(), "draft_cfg"),
                      (dict(draft_cfg=dc, sample_on_host=True),
                       "sample_on_host"),
                      (dict(draft_cfg=dc, num_draft_tokens=0),
                       "num_draft_tokens"),
                      (dict(draft_cfg=dataclasses.replace(
                          dc, vocab_size=cfg.vocab_size + 1)), "vocab"),
                      (dict(draft_cfg=dataclasses.replace(
                          dc, family="ssm")), "famil")):
        with pytest.raises(ValueError, match=match):
            ServeEngine(params, cfg, **{**base, **kw})


def test_stats_keys_equal_reference():
    """The paged engine's keys are the reference's paged engine's (plus the
    port's host-wall counters); the dense engine's are those without the
    pool's."""
    paged_keys = set(_port_session("paged_q8")[2][1])
    assert paged_keys - PORT_ONLY_STATS == set(_reference()[1])
    for layout in sorted(LAYOUTS):
        eng, _, (_, st, *_) = _port_session(layout)
        assert PORT_ONLY_STATS <= set(st) <= paged_keys
        assert eng.paged == (set(st) == paged_keys)
        assert st["speculative"] and st["num_draft_tokens"] == K
        assert st["draft_cache_bytes"] == sum(
            a.numel() * a.element_size()
            for a in eng.draft_cache["attn"].values())


def test_launcher_serves_speculatively(capsys):
    from repro_torch.launch import serve as tserve

    base = ["--reduced", "--kv-quant", "--device", "cpu", "--requests", "3",
            "--max-new", "6"]
    runs = []
    for extra in (["--draft-depth", "1", "--num-draft-tokens", "2"], []):
        tserve.main(base + extra)
        runs.append(capsys.readouterr().out)
    spec_out, plain_out = runs
    assert "1-layer self-draft, K=2" in spec_out
    assert "speculation: acceptance" in spec_out
    assert "served 3 requests / 18 tokens" in spec_out

    def ids(out):
        return [ln for ln in out.splitlines() if ln.strip().startswith("rid=")]
    assert ids(spec_out) == ids(plain_out) and len(ids(spec_out)) == 3


def test_launcher_boots_speculatively_from_checkpoint(tmp_path, capsys):
    """``--load-quantized`` with ``--draft-depth``: the engine boots
    through ``ServeEngine.from_checkpoint`` with the restored tree's
    prefix as its draft, and prints the ids of the run that saved it."""
    from repro_torch.launch import serve as tserve

    q = str(tmp_path / "q")
    base = ["--reduced", "--kv-quant", "--device", "cpu", "--requests", "3",
            "--max-new", "6", "--draft-depth", "1", "--num-draft-tokens", "2"]
    tserve.main(base + ["--save-quantized", q])
    saved = capsys.readouterr().out
    tserve.main(base + ["--load-quantized", q])
    loaded = capsys.readouterr().out
    assert "with ServeEngine.from_checkpoint" in loaded
    assert "1-layer self-draft, K=2" in loaded

    def ids(out):
        return [ln for ln in out.splitlines() if ln.strip().startswith("rid=")]
    assert ids(loaded) == ids(saved) and len(ids(saved)) == 3
