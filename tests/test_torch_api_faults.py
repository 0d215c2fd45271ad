"""The reference's public API that the port lacked, and the attention's
``auto`` backend at head_dims its kernel does not build, against the live
JAX reference on the CPU.

* ``ServeEngine.submit`` / ``step``: the same (rid, token) lists as the
  reference engine's, step by step, on reduced smollm-135m with the
  rotated-int8 cache.
* ``BlockPool.available`` / ``lookup_prefix`` / ``register_prefix``: one
  scripted sequence (first writer wins, a freed block drops its key) gives
  the reference's results call for call.
* ``cache_donated`` / ``cache_bytes_moved``: the port writes its cache in
  place, shown by every cache leaf's ``data_ptr()`` across waves and
  steps, and then reports the reference's values.
* ``decode_attn_q8`` / ``prefill_attn_q8`` under ``backend="auto"`` at
  head_dim 16 and 256 (and G = 33 query heads per KV head) take the plain
  path on CPU tensors and equal the reference within 1e-5; off the CPU
  ``auto`` raises for them, as ``backend="cuda"`` does everywhere; head_dim
  32 is unchanged.

Never compared with the committed golden files (ROADMAP Queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attn_decode as jattn
from repro.models.layers import Runtime as JRuntime
from repro.serve import paged as jpaged
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import attn_q8 as tattn
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import kv_quant as tkv
from repro_torch.serve import paged as tpaged
from repro_torch.serve.engine import Request, ServeEngine
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree

SLOTS, MAX_LEN, MAX_NEW = 2, 64, 6
# the plain attention against the reference's: both f32, summed in another
# order
TOL = dict(rtol=1e-5, atol=1e-5)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, size=int(n)).astype(np.int32)
            for n in (5, 9, 4)]


def _drive(eng, req_cls):
    """submit() the first two requests, a third that finds no free slot,
    then step() until every slot is free. Returns (submit results, the
    list of each step's (rid, token) pairs, the engine)."""
    reqs = [req_cls(rid=i, prompt=p, max_new=MAX_NEW - i)
            for i, p in enumerate(_prompts())]
    admitted = [eng.submit(r) for r in reqs]
    steps = []
    while any(r is not None for r in eng.active):
        steps.append([(int(r), int(t)) for r, t in eng.step()])
    steps.append(eng.step())  # nothing live: []
    return admitted, steps, eng


@functools.lru_cache(maxsize=None)
def _reference_run():
    cfg, jp = jax_quantized_params("smollm-135m", "itq3_s")
    eng = JServeEngine(jp, cfg, slots=SLOTS, max_len=MAX_LEN,
                       rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                   backend="ref"))
    admitted, steps, eng = _drive(eng, JRequest)
    return admitted, steps, eng.stats()


def _port_engine(**kw):
    _, jp = jax_quantized_params("smollm-135m", "itq3_s")
    cfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    return ServeEngine(params_from_numpy(to_numpy_tree(jp), device="cpu"),
                       cfg, slots=SLOTS, max_len=MAX_LEN,
                       rt=TRuntime(kv_quant=True), device="cpu", **kw)


def test_submit_and_step_equal_reference():
    admitted, steps, _ = _drive(_port_engine(), Request)
    want_admitted, want_steps, _ = _reference_run()
    assert admitted == want_admitted == [True, True, False]
    assert steps == want_steps
    assert steps[-1] == [] and len(steps) > 2


@pytest.mark.parametrize("paged", [False, True])
def test_cache_written_in_place_and_reported(paged):
    """Every cache leaf keeps its storage through two admission waves and
    every decode step (paged: the pool planes); only then does the port
    report ``cache_donated`` True and ``cache_bytes_moved`` 0, the live
    reference's values on the same traffic."""
    eng = _port_engine(paged=paged)
    assert eng.stats()["cache_donated"] is False  # no step yet
    ptrs = {k: v.data_ptr() for k, v in eng.cache["attn"].items()}
    seen = []
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for ev in eng.generate(reqs):
        seen.append({k: v.data_ptr() for k, v in eng.cache["attn"].items()})
    assert eng.stats()["prefill_waves"] == 2
    assert seen and all(p == ptrs for p in seen)
    st = eng.stats()
    want = _reference_run()[2]
    assert (st["cache_donated"], st["cache_bytes_moved"]) == (
        want["cache_donated"], want["cache_bytes_moved"]) == (True, 0)


def test_block_pool_prefix_api_equals_reference():
    """One scripted sequence on both pools: allocation, publishing two
    keys (the second writer of a key loses), lookups, sharing through
    ``alloc_prompt``, and frees that drop a block's key."""
    def script(mod):
        pool = mod.BlockPool(6, 4)
        log = [pool.available()]
        a, b = pool.alloc(), pool.alloc()
        log += [a, b, pool.available(), pool.lookup_prefix(b"x")]
        pool.register_prefix(b"x", a)
        pool.register_prefix(b"x", b)  # first writer wins
        pool.register_prefix(b"y", b)
        log += [pool.lookup_prefix(b"x"), pool.lookup_prefix(b"y")]
        log.append(pool.decref(a))  # freed: its key goes with it
        log += [pool.lookup_prefix(b"x"), pool.lookup_prefix(b"y"),
                pool.available()]
        prompt = np.arange(10, dtype=np.int32)
        first = pool.alloc_prompt(prompt)
        keys = mod.BlockPool.chain_hashes(prompt, 4)
        log += [first, [pool.lookup_prefix(k) for k in keys],
                pool.alloc_prompt(prompt), pool.prefix_hits,
                pool.available()]
        for blk in first:
            pool.decref(blk)
        log += [[pool.lookup_prefix(k) for k in keys], pool.available()]
        pool.check()
        return log

    assert script(tpaged) == script(jpaged)


def _cache(rng, b, kv, t, hd):
    k, v = (rng.standard_normal((b, kv, t, hd)).astype(np.float32)
            for _ in range(2))
    kq, ks = tkv.kv_encode(torch.from_numpy(k))
    vq, vs = tkv.kv_encode(torch.from_numpy(v))
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _jcache(cache):
    return {k: jnp.asarray(v.numpy()) for k, v in cache.items()}


def _decode_case(rng, hd, g):
    b, kv, t = 3, 2, 20
    cache = _cache(rng, b, kv, t, hd)
    q = rng.standard_normal((b, kv, g, 1, hd)).astype(np.float32)
    toks = [tkv.kv_encode(torch.from_numpy(
        rng.standard_normal((b, kv, 1, hd)).astype(np.float32)))
        for _ in range(2)]
    kv_len = np.array([0, 7, t], np.int32)
    want = jax.jit(functools.partial(jattn.decode_attn_q8, backend="auto"))(
        jnp.asarray(q), _jcache(cache),
        *(tuple(jnp.asarray(a.numpy()) for a in tok) for tok in toks),
        jnp.asarray(kv_len))

    def run(backend):
        return tattn.decode_attn_q8(torch.from_numpy(q), cache, *toks,
                                    torch.from_numpy(kv_len), backend=backend)
    return run, np.asarray(want)


def _prefill_case(rng, hd, g):
    b, kv, t, tq = 3, 2, 20, 5
    cache = _cache(rng, b, kv, t, hd)
    q = rng.standard_normal((b, kv, g, tq, hd)).astype(np.float32)
    q_offset = np.array([0, 6, t - tq], np.int32)
    kv_len = q_offset + tq
    want = jax.jit(functools.partial(jattn.prefill_attn_q8, backend="auto"))(
        jnp.asarray(q), _jcache(cache), jnp.asarray(kv_len),
        jnp.asarray(q_offset))

    def run(backend):
        return tattn.prefill_attn_q8(torch.from_numpy(q), cache,
                                     torch.from_numpy(kv_len),
                                     torch.from_numpy(q_offset),
                                     backend=backend)
    return run, np.asarray(want)


@pytest.mark.parametrize("case", [_decode_case, _prefill_case],
                         ids=["decode", "prefill"])
@pytest.mark.parametrize("hd,g", [(16, 2), (256, 2), (32, 33), (32, 2)])
def test_auto_attention_serves_every_power_of_two_head_dim(case, hd, g):
    """``auto`` at a shape the kernel refuses (head_dim 16 or 256, 33
    query heads per KV head) takes the plain path on CPU tensors, and at
    head_dim 32 the kernel pass as before (on the CPU its plain version):
    all within 1e-5 of the reference's ``auto``. ``cuda`` refuses the
    shapes the kernel does not build, and so does ``auto`` on a tensor off
    the CPU (a meta tensor here): the card never serves them plain."""
    rng = np.random.default_rng(hd + g)
    run, want = case(rng, hd, g)
    got = run("auto")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    supported = tattn.kernel_supported(hd, g)
    assert supported == (hd == 32 and g == 2)
    with pytest.raises(ValueError, match="CUDA" if supported else
                       "head_dim|query heads"):
        run("cuda")
    off_cpu = torch.empty((1, 1, g, 1, hd), device="meta")
    if supported:
        assert tattn._use_kernel("auto", off_cpu)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            tattn._use_kernel("auto", off_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,g", [(16, 2), (256, 2), (32, 33)])
def test_cuda_auto_attention_refuses_unbuilt_shapes(hd, g):
    """On the card ``auto`` raises for a shape the kernel does not build
    instead of serving it plain. Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    q = torch.zeros((1, 1, g, 1, hd), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        tattn._use_kernel("auto", q)
