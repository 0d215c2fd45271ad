"""Sampled decoding in the port against the live JAX reference, on the CPU.

Reduced smollm-135m, ``itq3_s`` planes bridged from the reference,
rotated-int8 KV cache. ``top_mask`` must give the reference's mask; a
mixed batch (greedy, temperature only, top-k, top-p, both; explicit and
derived seeds) must give the live JAX engine's streams token for token on
the dense and the paged cache, with one host sync per decode step and
wave; ``sample_on_host`` must give the on-device greedy streams with one
sync per live slot; a preempted sampled request resumes bit-identically.
Never compared with the committed golden files (ROADMAP Queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import prng
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree

SLOTS, MAX_LEN, MAX_NEW, ENGINE_SEED = 4, 128, 12, 5
# greedy; temperature only; top-k; top-p; both filters with an explicit
# seed; a hot temperature with an explicit seed; greedy carrying filters
MIX = [dict(), dict(temperature=0.8), dict(temperature=0.8, top_k=40),
       dict(temperature=1.0, top_p=0.9),
       dict(temperature=0.7, top_k=5, top_p=0.8, seed=3),
       dict(temperature=1.3, seed=99), dict(temperature=0.0, top_k=3)]


def _prompts(n=len(MIX)):
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, size=int(k)).astype(np.int32)
            for k in rng.integers(3, 21, size=n)]


@functools.lru_cache(maxsize=None)
def _port_params():
    _, jp = jax_quantized_params("smollm-135m", "itq3_s")
    return params_from_numpy(to_numpy_tree(jp), device="cpu")


def _port_engine(**kw):
    kw.setdefault("slots", SLOTS)
    cfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    return ServeEngine(_port_params(), cfg, max_len=MAX_LEN,
                       seed=ENGINE_SEED, rt=TRuntime(kv_quant=True),
                       device="cpu", **kw)


def _jax_engine(**kw):
    cfg, jp = jax_quantized_params("smollm-135m", "itq3_s")
    return JServeEngine(jp, cfg, slots=SLOTS, max_len=MAX_LEN,
                        seed=ENGINE_SEED,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref"), **kw)


def _requests(cls, sp_cls, mix=MIX, max_new=MAX_NEW):
    return [cls(rid=i, prompt=p, max_new=max_new,
                sampling=sp_cls(ignore_eos=True, **m))
            for i, (p, m) in enumerate(zip(_prompts(len(mix)), mix))]


@functools.lru_cache(maxsize=None)
def _reference_streams(paged: bool):
    reqs = _jax_engine(paged=paged).run(_requests(JRequest, JSamplingParams))
    return [r.out for r in reqs]


# ---------------------------------------------------------------------------
# top_mask and sample_tokens
# ---------------------------------------------------------------------------

def _masks_equal(logits, top_k, top_p):
    want = np.asarray(jax.jit(jlm.top_mask)(
        jnp.asarray(logits), None if top_k is None else jnp.asarray(top_k),
        None if top_p is None else jnp.asarray(top_p)))
    got = tlm.top_mask(torch.from_numpy(logits),
                       None if top_k is None else torch.from_numpy(top_k),
                       None if top_p is None else torch.from_numpy(top_p))
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(want))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ties", [False, True])
def test_top_mask_equals_reference(ties):
    """Per-row k in {0, 1, 7, V+5} against p in {1.0, 0.9, 1e-6}: every
    combination in one batch, alone and together; with ``ties`` the
    logits take few distinct values, so thresholds land on tied runs."""
    rng = np.random.default_rng(4)
    v = 300
    ks = np.array([0, 1, 7, v + 5], np.int32)
    ps = np.array([1.0, 0.9, 1e-6], np.float32)
    top_k, top_p = (a.reshape(-1) for a in np.meshgrid(ks, ps, indexing="ij"))
    logits = rng.standard_normal((len(top_k), v)).astype(np.float32) * 3
    if ties:
        logits = np.round(logits)
    _masks_equal(logits, top_k, top_p)
    _masks_equal(logits, top_k, None)
    _masks_equal(logits, None, top_p)


def test_sample_tokens_equals_reference_per_row_and_shared_key():
    """``sample_tokens`` with (B, 2) keys and per-row vectors, and with one
    shared (2,) key, against the reference's on the same logits."""
    rng = np.random.default_rng(8)
    b, v = 6, 512
    logits = rng.standard_normal((b, v)).astype(np.float32) * 2
    keys = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)
    temp = np.array([0.0, 0.8, 0.8, 1.0, 0.7, 1.3], np.float32)
    top_k = np.array([0, 0, 40, 0, 5, 0], np.int32)
    top_p = np.array([1.0, 1.0, 1.0, 0.9, 0.8, 1.0], np.float32)
    want = np.asarray(jax.jit(jlm.sample_tokens)(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temp),
        top_k=jnp.asarray(top_k), top_p=jnp.asarray(top_p)))
    got = tlm.sample_tokens(torch.from_numpy(logits),
                            torch.from_numpy(keys.astype(np.int64)),
                            torch.from_numpy(temp),
                            top_k=torch.from_numpy(top_k),
                            top_p=torch.from_numpy(top_p))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == int(np.argmax(logits[0]))  # temperature 0: greedy
    want = np.asarray(jax.jit(jlm.sample_tokens)(
        jnp.asarray(logits), jax.random.PRNGKey(2), 0.9))
    got = tlm.sample_tokens(torch.from_numpy(logits), prng.seed_key(2), 0.9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_sampled_alone_equals_row_in_a_batch():
    rng = np.random.default_rng(9)
    b, v = 5, 512
    logits = torch.from_numpy(rng.standard_normal((b, v)).astype(np.float32))
    keys = torch.from_numpy(rng.integers(0, 2**32, (b, 2), dtype=np.uint64)
                            .astype(np.int64))
    temp = torch.tensor([0.5, 0.9, 1.2, 0.7, 2.0])
    top_k = torch.tensor([0, 10, 0, 3, 0])
    top_p = torch.tensor([0.95, 1.0, 0.5, 1.0, 1.0])
    batch = tlm.sample_tokens(logits, keys, temp, top_k=top_k, top_p=top_p)
    for i in range(b):
        alone = tlm.sample_tokens(logits[i:i + 1], keys[i:i + 1],
                                  temp[i:i + 1], top_k=top_k[i:i + 1],
                                  top_p=top_p[i:i + 1])
        assert alone.item() == batch[i].item()


def test_greedy_request_filters_are_normalized():
    eng = _port_engine()
    sp = eng._resolve(Request(rid=0, prompt=np.arange(3), sampling=(
        SamplingParams(temperature=0.0, top_k=7, top_p=0.5))))
    assert (sp.top_k, sp.top_p, sp.max_new) == (0, 1.0, 32)
    kept = SamplingParams(temperature=0.9, top_k=7, top_p=0.5)
    assert eng._resolve(Request(rid=1, prompt=np.arange(3),
                                sampling=kept)).top_k == 7
    # a wave or step with no sampled row draws no key at all
    _, keys, temp, top_k, top_p = eng._group_sampling(
        [Request(rid=2, prompt=np.arange(3), sampling=SamplingParams(
            top_k=3))])
    assert keys is temp is top_k is top_p is None
    assert eng._filter_vectors([0, 0], [1.0, 1.0]) == (None, None)


def test_engine_temperature_property_and_seed():
    eng = _port_engine(temperature=0.5)
    assert eng.temperature == 0.5 and eng.seed == ENGINE_SEED
    eng.temperature = 0.0
    assert eng.default_sampling.greedy


# ---------------------------------------------------------------------------
# The engine against the live reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_mixed_batch_streams_equal_live_reference(paged):
    eng = _port_engine(paged=paged)
    got = eng.run(_requests(Request, SamplingParams))
    assert [r.out for r in got] == list(_reference_streams(paged))
    assert all(r.finish_reason == "length" and len(r.out) == MAX_NEW
               for r in got)
    st = eng.stats()
    # sampled rows ride the same single transfer per step and wave
    assert st["host_syncs"] == st["decode_steps"] + st["prefill_waves"]
    assert st["prefill_waves"] == 2


def test_sampled_streams_do_not_depend_on_slot_or_batchmates():
    """Each request run alone on a one-slot engine gives its stream from
    the mixed batch."""
    want = _reference_streams(False)
    for i, (p, m) in enumerate(zip(_prompts(), MIX)):
        if i not in (1, 4):
            continue
        req = Request(rid=i, prompt=p, max_new=MAX_NEW,
                      sampling=SamplingParams(ignore_eos=True, **m))
        _port_engine(slots=1).run([req])
        assert req.out == want[i]


def test_sample_on_host_gives_device_greedy_streams():
    greedy = [dict()] * 5
    dev = _port_engine().run(_requests(Request, SamplingParams, greedy))
    eng = _port_engine(sample_on_host=True)
    host = eng.run(_requests(Request, SamplingParams, greedy))
    assert [r.out for r in host] == [r.out for r in dev]
    jeng = _jax_engine(sample_on_host=True)
    jreqs = jeng.run(_requests(JRequest, JSamplingParams, greedy))
    assert [r.out for r in jreqs] == [r.out for r in host]
    st = eng.stats()
    # one transfer per admitted row and per live slot per step
    live_steps = sum(len(r.out) for r in host) - len(host)
    assert st["host_syncs"] == len(host) + live_steps
    assert st["host_syncs"] == jeng.stats()["host_syncs"]


@pytest.mark.parametrize("paged", [False, True])
def test_preempted_sampled_request_resumes_bit_identically(paged):
    """A sampled request swapped out mid-stream keeps its key; its next
    draw folds in its own token index, so the stream is unchanged."""
    want = _reference_streams(paged)
    eng = _port_engine(paged=paged)
    reqs = _requests(Request, SamplingParams)
    done = False
    for ev in eng.generate(reqs):
        if not done and ev.rid == 2 and ev.index == 4:
            assert eng.preempt(2)
            done = True
    assert [r.out for r in reqs] == list(want)
    assert eng.stats()["preemptions"] == 1 and eng.stats()["resumes"] == 1
