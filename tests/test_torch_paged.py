"""The paged rotated-int8 KV cache of the port against the live reference.

* ``BlockPool``: the same operation sequence on the port's and the
  reference's pools gives the same block ids, refcounts, free lists and
  prefix hits (a scripted sequence and seeded random ones, ``check()``
  after every operation).
* Pool planes, ``zero_blocks``, ``paged_row_table`` and ``paged_to_dense``
  equal the reference's.
* Paged attention: the port's plain paths over a paged cache match the
  reference's ``backend="ref"`` within 1e-5 (f32, another summation
  order), and equal the port's own dense results bit for bit (the paged
  plain path gathers the dense view and runs the same math).
* The engine: reduced smollm-135m with itq3_s planes bridged from the
  reference and the q8 cache. Streams and pool/preemption counters equal
  the live JAX paged engine's on the golden request set (its sampled
  request left out: the port is greedy-only), at the default pool and at a
  5-block pool that forces preemption. Never the committed golden file,
  which does not match the live reference on this jax.
* Prefix sharing, oversize prompts, quarantine, preempt/resume on both
  layouts, the scheduler's preemption hook, ``stats()`` and the CLI.

The hand-written kernel is held to the dense kernel on the card by the
``gpu``-marked test at the end and by ``chip_smoke.py``.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.kernels import attn_decode as jattn
from repro.models.layers import Runtime as JRuntime
from repro.serve import kv_quant as jkv
from repro.serve import paged as jpaged
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import attn_q8 as tattn
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import kv_quant as tkv
from repro_torch.serve import paged as tpaged
from repro_torch.serve.engine import Request, ServeEngine
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree

TOL = dict(rtol=1e-5, atol=1e-5)
SLOTS, MAX_LEN, PAD, BS = 4, 64, 16, 16
SAMPLED_RID = 102  # the golden set's one sampled request


def _golden_requests(vocab):
    path = os.path.join(os.path.dirname(__file__), "goldens",
                        "capture_paged_goldens.py")
    spec = importlib.util.spec_from_file_location("capture_paged_goldens",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [r for r in mod.golden_requests(vocab) if r.rid != SAMPLED_RID]


def _port_requests(jreqs):
    return [Request(rid=r.rid, prompt=np.asarray(r.prompt), max_new=r.max_new,
                    priority=r.priority) for r in jreqs]


@functools.lru_cache(maxsize=None)
def _port_params():
    _, jp = jax_quantized_params("smollm-135m", "itq3_s")
    return params_from_numpy(to_numpy_tree(jp), device="cpu")


def _cfg():
    return tconfigs.reduced(tconfigs.get_config("smollm-135m"))


def _port_engine(**kw):
    kw.setdefault("slots", SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("prompt_pad", PAD)
    kw.setdefault("rt", TRuntime(kv_quant=True))
    return ServeEngine(_port_params(), _cfg(), device="cpu", **kw)


def _jax_engine(**kw):
    cfg, jp = jax_quantized_params("smollm-135m", "itq3_s")
    kw.setdefault("slots", SLOTS)
    return JServeEngine(jp, cfg, max_len=MAX_LEN, prompt_pad=PAD,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref"), **kw)


# ---------------------------------------------------------------------------
# BlockPool
# ---------------------------------------------------------------------------

def _same_pool(tp, jp):
    assert tp.ref.tolist() == jp.ref.tolist()
    assert tp._free == jp._free
    assert tp.prefix_hits == jp.prefix_hits
    assert tp._prefix == jp._prefix


def test_blockpool_scripted_sequence_matches_reference():
    """alloc/incref/decref, LIFO reuse, prefix sharing in alloc_prompt and
    its all-or-nothing rollback on PoolExhausted, step by step."""
    tp, jp = tpaged.BlockPool(8, 4), jpaged.BlockPool(8, 4)
    p = np.arange(10, dtype=np.int32)  # 2 full blocks + a partial tail
    for pool in (tp, jp):
        assert pool.capacity == 7 and pool.ref[tpaged.NULL_BLOCK] == 1
    ops = [("alloc_prompt", p), ("alloc_prompt", p), ("alloc",),
           ("incref", 4), ("decref", 4), ("decref", 3), ("alloc",),
           ("alloc_prompt", np.arange(40, dtype=np.int32)),
           ("alloc_prompt", np.concatenate([p[:4], p[:6] + 1]))]
    for op, *args in ops:
        results = []
        for pool, exc in ((tp, tpaged.PoolExhausted),
                          (jp, jpaged.PoolExhausted)):
            try:
                results.append(getattr(pool, op)(*args))
            except exc:
                results.append("exhausted")
        assert results[0] == results[1], op
        _same_pool(tp, jp)
    # 2 on the second prompt, 2 counted before the 40-token rollback, 1
    assert tp.prefix_hits == 5 and tp.used() == jp.used()
    tp.check(), jp.check()
    with pytest.raises(tpaged.PoolExhausted):
        tp.alloc()
    assert tp.decref(5)
    with pytest.raises(RuntimeError, match="double free"):
        tp.decref(5)


def _pool_op(pool, exc, tab, swapped, op, prompt, pick):
    """One admit/grow/finish/preempt/resume on ``pool`` and its live
    ``tab`` (slot -> chain); returns what it did, or None."""
    live = sorted(tab)
    try:
        if op == "admit":
            sid = len(tab) + len(swapped) + pick
            tab[sid] = pool.alloc_prompt(prompt)
            return op, sid, tab[sid]
        if op == "grow" and live:
            sid = live[pick % len(live)]
            tab[sid].append(pool.alloc())
            return op, sid, tab[sid][-1]
        if op in ("finish", "preempt") and live:
            sid = live[pick % len(live)]
            chain = tab.pop(sid)
            if op == "preempt":
                swapped[sid] = len(chain)
            return op, sid, [pool.decref(b) for b in chain]
        if op == "resume" and swapped:
            sid = sorted(swapped)[pick % len(swapped)]
            got: list[int] = []
            try:
                for _ in range(swapped[sid]):
                    got.append(pool.alloc())
            except exc:
                for b in got:  # all or nothing, as the engine does
                    pool.decref(b)
                raise
            tab[sid] = got
            del swapped[sid]
            return op, sid, got
    except exc:
        return "exhausted"
    return None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_blockpool_random_sequences_match_reference(seed):
    """Seeded admit/grow/finish/preempt/resume sequences on both pools:
    equal results and state after every operation, both ``check()``s
    passing against the live tables."""
    rng = np.random.default_rng(seed)
    nb, bs = int(rng.integers(3, 12)), int(rng.integers(1, 6))
    sides = [(tpaged.BlockPool(nb, bs), tpaged.PoolExhausted, {}, {}),
             (jpaged.BlockPool(nb, bs), jpaged.PoolExhausted, {}, {})]
    for _ in range(60):
        op = str(rng.choice(["admit", "grow", "finish", "preempt", "resume"]))
        # few distinct tokens, so prompts share prefixes now and then
        prompt = rng.integers(0, 3, size=int(rng.integers(1, 20))).astype(
            np.int32)
        pick = int(rng.integers(0, 1 << 20))
        got = [_pool_op(*side, op, prompt, pick) for side in sides]
        assert got[0] == got[1], op
        _same_pool(sides[0][0], sides[1][0])
        for pool, _, tab, _ in sides:
            pool.check(tab.values())
    assert sides[0][2] == sides[1][2]


def test_blockpool_guards_and_chain_hashes():
    for mod in (tpaged, jpaged):
        with pytest.raises(ValueError, match="blocks"):
            mod.BlockPool(1, 16)
        with pytest.raises(ValueError, match="block_size"):
            mod.BlockPool(4, 0)
    a = np.arange(37, dtype=np.int32)
    assert (tpaged.BlockPool.chain_hashes(a, 16)
            == jpaged.BlockPool.chain_hashes(a, 16))
    assert [tpaged.blocks_needed(p, 16) for p in (0, 15, 16, 63)] == \
        [jpaged.blocks_needed(p, 16) for p in (0, 15, 16, 63)]


# ---------------------------------------------------------------------------
# Pool planes, table helpers
# ---------------------------------------------------------------------------

def test_init_paged_cache_and_zero_blocks_match_reference():
    jcfg = jreduced(jget_config("smollm-135m"))
    tc = tpaged.init_paged_cache(_cfg(), 4, 8, device="cpu")["attn"]
    jc = jpaged.init_paged_cache(jcfg, 4, 8)["attn"]
    for key in jc:
        assert tc[key].shape == jc[key].shape
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
        tc[key] += 1
    tpaged.zero_blocks({"attn": tc}, [2, 3])
    jz = jax.jit(jpaged.zero_blocks, static_argnums=1)(
        {"attn": {k: v + 1 for k, v in jc.items()}}, (2, 3))["attn"]
    for key in jc:
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jz[key]))
    import dataclasses
    with pytest.raises(ValueError, match="famil"):
        tpaged.init_paged_cache(dataclasses.replace(_cfg(), family="ssm"), 4,
                                8, device="cpu")


def _jit(fn):
    """The reference's plain path, jitted (op-by-op dispatch is slow)."""
    return jax.jit(functools.partial(fn, backend="ref"))


def _pool_and_dense(rng, b=3, kvh=2, bs=8, maxb=3, hd=64):
    """Random int8 codes and f16 scales in a pool with a shuffled block
    table (numpy), plus the same rows laid out densely."""
    nb = b * maxb + 2  # null block + one unused block
    table = (1 + rng.permutation(b * maxb)).reshape(b, maxb).astype(np.int32)
    pool = {}
    for key, last in (("k", hd), ("v", hd), ("k_scale", 1), ("v_scale", 1)):
        if last == hd:
            pool[key] = rng.integers(-127, 128, (nb, kvh, bs, hd)).astype(
                np.int8)
        else:
            pool[key] = (rng.random((nb, kvh, bs, 1)) * 0.05 + 1e-3).astype(
                np.float16)
    dense = {k: np.swapaxes(v[table], 1, 2).reshape(b, kvh, maxb * bs, -1)
             for k, v in pool.items()}
    return pool, table, dense


def _torch(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_table_helpers_match_reference(rng):
    pool, table, dense = _pool_and_dense(rng)
    want = jattn.paged_row_table(jnp.asarray(table), 2)
    got = tattn.paged_row_table(torch.from_numpy(table), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    jd = jattn.paged_to_dense(dict(_jax(pool), table=jnp.asarray(table)))
    td = tattn.paged_to_dense(dict(_torch(pool),
                                   table=torch.from_numpy(table)))
    for key in dense:
        np.testing.assert_array_equal(td[key].numpy(), np.asarray(jd[key]))
        np.testing.assert_array_equal(td[key].numpy(), dense[key])


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_paged_attention_matches_reference_and_own_dense(kind, rng):
    pool, table, dense = _pool_and_dense(rng)
    b, kvh, t, hd = dense["k"].shape
    g, tq = 3, (1 if kind == "decode" else 5)
    q = rng.standard_normal((b, kvh, g, tq, hd)).astype(np.float32)
    kv_len = np.asarray([t - 3, 5, 11], np.int32)  # ragged, mid-block
    tpool = dict(_torch(pool), table=torch.from_numpy(table))
    jpool = dict(_jax(pool), table=jnp.asarray(table))
    if kind == "decode":
        tok = [rng.standard_normal((b, kvh, 1, hd)).astype(np.float32)
               for _ in range(2)]
        ttok = [tkv.kv_encode(torch.from_numpy(x)) for x in tok]
        jtok = [jax.jit(jkv.kv_encode)(jnp.asarray(x)) for x in tok]

        def port(cache, backend="ref"):
            return tattn.decode_attn_q8(torch.from_numpy(q), cache, *ttok,
                                        torch.from_numpy(kv_len),
                                        backend=backend)
        want = _jit(jattn.decode_attn_q8)(jnp.asarray(q), jpool, *jtok,
                                          jnp.asarray(kv_len))
    else:
        off = kv_len - tq

        def port(cache, backend="ref"):
            return tattn.prefill_attn_q8(torch.from_numpy(q), cache,
                                         torch.from_numpy(kv_len),
                                         torch.from_numpy(off),
                                         backend=backend)
        want = _jit(jattn.prefill_attn_q8)(jnp.asarray(q), jpool,
                                           jnp.asarray(kv_len),
                                           jnp.asarray(off))
    got = port(tpool)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, port(_torch(dense)))
    # backend "auto" on a CPU tensor: the paged wrapper's plain path
    _build.reset_launches()
    assert torch.equal(port(tpool, "auto"), got) and not _build.launches


@pytest.mark.parametrize("bs", [4, 16, 64])
def test_attn_q8_paged_ref_is_the_gathered_dense_pass(bs, rng):
    r, maxb, hd, g, tq = 6, 128 // bs, 64, 3, 4
    pr = r * maxb + 3
    kc = torch.from_numpy(rng.integers(-127, 128, (pr, bs, hd)).astype(np.int8))
    vc = torch.from_numpy(rng.integers(-127, 128, (pr, bs, hd)).astype(np.int8))
    ks = torch.from_numpy((rng.random((pr, bs)) * 0.05).astype(np.float16))
    vs = torch.from_numpy((rng.random((pr, bs)) * 0.05).astype(np.float16))
    table = torch.from_numpy(rng.permutation(pr)[:r * maxb].reshape(r, maxb)
                             .astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((r, tq, g, hd)).astype(np.float32))
    kv_len = torch.tensor([0, 1, bs, bs + 1, 100, 128], dtype=torch.int32)
    off = torch.clamp(kv_len - tq, min=0)
    kw = dict(sm_scale=hd ** -0.5, causal=True)
    got = tattn.attn_q8_paged(q, kc, ks, vc, vs, kv_len, off, table,
                              block_size=bs, **kw)
    want = tattn.attn_q8_ref(q, kc[table].reshape(r, -1, hd),
                             ks[table].reshape(r, -1),
                             vc[table].reshape(r, -1, hd),
                             vs[table].reshape(r, -1), kv_len, off, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2][0].abs().max() == 0 and got[1][0].max() == -1e30  # empty row
    with pytest.raises(ValueError, match="shapes"):
        tattn.attn_q8_paged(q, kc, ks, vc, vs, kv_len, off, table,
                            block_size=bs * 2, **kw)
    with pytest.raises(ValueError, match="dtype"):
        tattn.attn_q8_paged(q, kc, ks, vc, vs, kv_len, off, table.long(),
                            block_size=bs, **kw)


# ---------------------------------------------------------------------------
# Engine against the live reference engine
# ---------------------------------------------------------------------------

PAGED_COUNTERS = ("preemptions", "resumes", "blocks_swapped", "prefix_hits",
                  "pool_exhausted", "pool_blocks", "max_concurrent",
                  "cache_bytes", "host_syncs", "decode_steps")


@pytest.mark.parametrize("num_blocks", [None, 5])
def test_paged_engine_matches_live_reference(num_blocks):
    cfg, _ = jax_quantized_params("smollm-135m", "itq3_s")
    jreqs = _golden_requests(cfg.vocab_size)
    jeng = _jax_engine(paged=True, block_size=BS, num_blocks=num_blocks)
    want = {r.rid: r.out for r in jeng.run(jreqs)}
    eng = _port_engine(paged=True, block_size=BS, num_blocks=num_blocks)
    got = eng.run(_port_requests(_golden_requests(cfg.vocab_size)))
    assert {r.rid: r.out for r in got} == want
    assert all(r.finish_reason == "length" for r in got)
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in PAGED_COUNTERS} == {
        k: jst[k] for k in PAGED_COUNTERS}
    if num_blocks == 5:
        assert st["preemptions"] >= 1 and st["resumes"] == st["preemptions"]
    assert st["pool_blocks_used"] == 0 and st["prefix_hits"] >= 1
    eng.pool.check(eng._table)
    # and the dense layout serves the same streams
    dense = _port_engine().run(_port_requests(_golden_requests(
        cfg.vocab_size)))
    assert {r.rid: r.out for r in dense} == want


def test_paged_prefix_sharing_refcounts():
    """Two live requests over one 32-token prefix hold its two full
    blocks once, with refcount 2."""
    eng = _port_engine(paged=True, slots=2)
    shared = np.arange(32, dtype=np.int32)
    reqs = [Request(rid=0, prompt=shared.copy(), max_new=8),
            Request(rid=1, prompt=np.append(shared, 7).astype(np.int32),
                    max_new=8)]
    it = eng.generate(reqs)
    next(it)
    assert eng.pool.prefix_hits == 2
    common = set(eng._slot_blocks[0]) & set(eng._slot_blocks[1])
    assert len(common) == 2 and all(eng.pool.ref[b] == 2 for b in common)
    eng.pool.check(eng._table)
    list(it)
    assert eng.pool.used() == 0
    assert [r.out for r in reqs] == [
        r.out for r in _port_engine(slots=2).run(
            [Request(rid=r.rid, prompt=r.prompt, max_new=8) for r in reqs])]


def test_paged_oversize_prompt_finishes_with_error():
    eng = _port_engine(paged=True, num_blocks=3)  # 2 usable blocks
    big = Request(rid=0, prompt=np.arange(40, dtype=np.int32), max_new=4)
    ok = Request(rid=1, prompt=np.arange(4, dtype=np.int32), max_new=3)
    events = list(eng.generate([big, ok]))
    assert big.finish_reason == "error" and big.out == []
    assert ok.finish_reason == "length"
    assert [e.finish_reason for e in events if e.rid == 0] == ["error"]
    assert eng.stats()["pool_exhausted"] == 1 and eng.pool.used() == 0


def test_paged_requires_kv_quant():
    with pytest.raises(ValueError, match="kv_quant"):
        _port_engine(paged=True, rt=TRuntime())


def _prompts(n=6):
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, size=int(k)).astype(np.int32)
            for k in rng.integers(3, 21, size=n)]


def test_paged_quarantine_zeroes_exclusive_blocks_neighbours_unchanged():
    clean = [r.out for r in _port_engine(paged=True).run(
        [Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(_prompts())])]
    eng = _port_engine(paged=True)
    reqs = [Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(_prompts())]
    held, zeroed = None, None
    for ev in eng.generate(reqs):
        if ev.rid == 0 and ev.index == 2:
            s = [r.rid if r else None for r in eng.active].index(0)
            held = list(eng._slot_blocks[s])
            assert all(eng.pool.ref[b] == 1 for b in held)
            eng.cache["attn"]["k_scale"][0, held] = float("inf")
        if ev.rid == 0 and ev.finished:  # before a new tenant moves in
            zeroed = all((v[:, held] == 0).all()
                         for v in eng.cache["attn"].values())
    assert reqs[0].finish_reason == "error" and len(reqs[0].out) == 3
    assert zeroed and eng.stats()["quarantined"] == 1
    for r in reqs[1:]:
        assert r.finish_reason == "length" and r.out == clean[r.rid]
    assert eng.pool.used() == 0
    eng.pool.check(eng._table)


@pytest.mark.parametrize("paged", [False, True])
def test_preempt_then_resume_is_bit_identical(paged):
    clean = [r.out for r in _port_engine(paged=paged).run(
        [Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(_prompts())])]
    eng = _port_engine(paged=paged)
    reqs = [Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(_prompts())]
    held = 0
    for ev in eng.generate(reqs):
        if ev.rid == 1 and ev.index == 2:
            if paged:
                s = [r.rid if r else None for r in eng.active].index(1)
                held = len(eng._slot_blocks[s])
            syncs = eng.host_syncs
            assert eng.preempt(1) and not eng.preempt(1)
            assert eng.host_syncs == syncs  # the swap is no step sync
    assert [r.out for r in reqs] == clean
    st = eng.stats()
    assert st["preemptions"] == st["resumes"] == 1
    assert reqs[1].preemptions == 1 and reqs[1].stats()["preemptions"] == 1
    assert st["host_syncs"] == st["decode_steps"] + st["prefill_waves"]
    if paged:
        assert st["blocks_swapped"] == held >= 1
        assert st["pool_blocks_used"] == 0


def test_priority_scheduler_preemption_matches_reference():
    """A higher-priority request arriving at a full engine preempts the
    lowest-priority live one (the scheduler's hook); streams and counters
    equal the live reference engine's."""
    prompts = _prompts(3)

    def drive(eng, req_cls):
        reqs = [req_cls(rid=i, prompt=p, max_new=8, priority=int(i == 2))
                for i, p in enumerate(prompts)]
        it = eng.generate(reqs[:2])
        next(it)
        eng.submit_request(reqs[2])
        list(it)
        return [r.out for r in reqs], eng.stats()

    want, jst = drive(_jax_engine(slots=2, scheduler="priority"), JRequest)
    got, st = drive(_port_engine(slots=2, scheduler="priority"), Request)
    assert got == want
    assert st["preemptions"] == jst["preemptions"] == 1
    assert st["resumes"] == jst["resumes"] == 1


def test_stats_reserved_vs_live_split():
    dense = _port_engine(slots=2)
    it = dense.generate([Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                                 max_new=4)])
    next(it)
    st = dense.stats()
    assert st["cache_bytes_reserved"] == dense.cache_bytes
    assert 0 < st["cache_bytes_live"] <= st["cache_bytes_reserved"]
    list(it)
    assert dense.stats()["cache_bytes_live"] == 0

    eng = _port_engine(paged=True, slots=2)
    it = eng.generate([Request(rid=0, prompt=np.arange(18, dtype=np.int32),
                               max_new=4)])
    next(it)
    st = eng.stats()
    # 18 tokens: 2 blocks reserved (32 positions), 18 live
    assert st["cache_bytes_reserved"] == 2 * BS * st["cache_bytes_per_token"]
    assert st["cache_bytes_reserved"] > st["cache_bytes_live"] > 0
    assert st["pool_utilization"] > 0 and st["max_concurrent"] == 1
    list(it)
    st = eng.stats()
    assert st["cache_bytes_live"] == 0 and st["pool_utilization"] == 0


def test_cli_serves_paged_on_cpu(capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--reduced", "--kv-quant", "--paged", "--device", "cpu",
                 "--requests", "3", "--max-new", "4", "--num-blocks", "4"])
    out = capsys.readouterr().out
    assert "paged pool: 3 blocks x 16 tokens" in out
    assert "served 3 requests / 12 tokens" in out
    assert "0 blocks still held" in out


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_paged_kernel_equals_dense_kernel_on_gathered_view(rng):
    """On the card: the paged kernel gives the dense kernel's bits over
    ``paged_to_dense`` of the same pool, and is within 1e-4 of its plain
    version. Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    dev = torch.device("cuda")
    pool, table, _ = _pool_and_dense(rng, b=4, kvh=3, bs=16, maxb=16)
    cache = {k: v.to(dev) for k, v in _torch(pool).items()}
    cache["table"] = torch.from_numpy(table).to(dev)
    kv_len = torch.tensor([5, 64, 130, 255], dtype=torch.int32, device=dev)
    q = torch.randn(4, 3, 3, 64, 64, device=dev)
    dense = tattn.paged_to_dense(cache)
    for tq, off in ((1, torch.zeros_like(kv_len)), (64, kv_len - 64)):
        qq = q[..., :tq, :].contiguous()
        got = tattn.prefill_attn_q8(qq, cache, kv_len, off.clamp(min=0))
        want = tattn.prefill_attn_q8(qq, dense, kv_len, off.clamp(min=0))
        plain = tattn.prefill_attn_q8(qq, cache, kv_len, off.clamp(min=0),
                                      backend="ref")
        assert torch.equal(got, want)
        assert ((got - plain).abs().max() / plain.abs().max()).item() < 1e-4
