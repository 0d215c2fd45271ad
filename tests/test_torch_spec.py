"""The speculative-decoding primitives of the port (``serve/spec.py``,
``lm.score_tokens``, ``lm.advance_cache``, the paged lookahead) against
the live JAX reference on the CPU.

* The PRNG streams: acceptance uniforms, draft keys and the window-end
  keys bit-equal to the reference's (the tags are above 2**31 and fold in
  as uint32).
* ``verify_commit``: all-greedy and mixed sampled windows (temperature,
  top-k, top-p) with ``kvec`` 0, partial and K: ``(out, n)`` equal to the
  reference's on seeded logits. The acceptance test compares
  ``u * q(d)`` with ``p(d)`` from two softmaxes that XLA and PyTorch sum
  in another order, and the residual draw takes a ``log`` whose last bit
  can differ (ROADMAP Queue 3); the seeded windows here hit neither.
* ``draft_from_params``: layer leaves sliced (views), ``embed`` / ``ln_f``
  / ``lm_head`` shared by identity, a 1-D ``dsign`` kept whole, depths
  outside [1, L] and non-attention families refused.
* ``score_tokens`` / ``advance_cache``: logits within 1e-4 and KV codes
  exact up to each row's first rounding tie (the rule of
  ``test_torch_model.py``); ``advance_cache`` of one token writes exactly
  its position.
* ``blocks_needed`` with the reference's lookahead cases.

Never compared with the committed golden files (ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.serve import paged as jpaged
from repro.serve import spec as jspec
from repro_torch import configs as tconfigs
from repro_torch.core.quantize import QTensor
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import paged as tpaged
from repro_torch.serve import spec as tspec
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_model import LOGIT_ATOL, MAX_LEN, _first_tie, _params

S, K, V = 6, 3, 64
# per row: temperature, top_k, top_p; two greedy rows, the rest sampled
KNOBS = [(0.0, 0, 1.0), (0.8, 0, 1.0), (1.0, 5, 1.0), (0.7, 0, 0.8),
         (1.3, 7, 0.9), (0.0, 0, 1.0)]


def _keys(rng, s=S):
    return rng.integers(0, 2**32, (s, 2), dtype=np.uint64).astype(np.uint32)


def test_stream_keys_and_uniforms_bit_equal():
    rng = np.random.default_rng(0)
    keys = _keys(rng)
    gen = np.array([0, 1, 17, 255, 2**31 - 2, 2**31 + 5], np.uint32)
    jkeys, jgen = jnp.asarray(keys), jnp.asarray(gen.astype(np.int32))
    got = tspec.accept_uniforms(keys, gen, K).numpy()
    want = np.asarray(jspec.accept_uniforms(jkeys, jgen, K))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for w in range(K):
        np.testing.assert_array_equal(
            tspec.draft_keys(keys, gen, w),
            np.asarray(jspec.draft_keys(jkeys, jgen, w)))
    uni, ends = tspec.window_draws(keys, gen, K, "cpu")
    assert torch.equal(uni, torch.from_numpy(got))
    for a in range(K + 1):
        np.testing.assert_array_equal(
            ends[:, a].numpy(), np.asarray(jspec._natural_keys(
                jkeys, jgen, jnp.full(S, a, jnp.int32))))


def _window(rng, kvec, greedy: bool):
    """Seeded logits (S, K+1, V), the draft's scaled and masked logits, and
    candidates: greedy rows propose the target's argmax up to a seeded
    first miss; sampled rows draw from the draft's distribution."""
    logits = (rng.standard_normal((S, K + 1, V)) * 2).astype(np.float32)
    draft = logits[:, :K] + (rng.standard_normal((S, K, V)) * 0.7
                             ).astype(np.float32)
    temp = np.array([0.0 if greedy else t for t, _, _ in KNOBS], np.float32)
    top_k = np.array([k for _, k, _ in KNOBS], np.int32)
    top_p = np.array([p for _, _, p in KNOBS], np.float32)
    qlog = np.array(jlm.top_mask(
        jnp.asarray(draft / np.maximum(temp, 1e-6)[:, None, None]
                    ).reshape(S * K, V),
        jnp.repeat(jnp.asarray(top_k), K), jnp.repeat(jnp.asarray(top_p), K)
    )).reshape(S, K, V)
    cand = np.zeros((S, K + 1), np.int32)
    cand[:, 0] = rng.integers(0, V, S)
    for s in range(S):
        miss = rng.integers(0, K + 1)
        for w in range(K):
            if temp[s] <= 0:
                cand[s, w + 1] = (np.argmax(logits[s, w]) if w < miss
                                  else rng.integers(0, V))
            else:
                q = np.exp(qlog[s, w] - qlog[s, w].max())
                cand[s, w + 1] = rng.choice(V, p=q / q.sum())
    return logits, cand, np.asarray(kvec, np.int32), temp, top_k, top_p, qlog


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kvec", [[0] * S, [1, 2, 0, 3, 1, 2], [K] * S],
                         ids=["kvec0", "partial", "full"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "mixed"])
def test_verify_commit_equals_reference(seed, kvec, greedy):
    rng = np.random.default_rng(seed)
    logits, cand, kv, temp, top_k, top_p, qlog = _window(rng, kvec, greedy)
    keys = _keys(rng)
    gen = rng.integers(0, 200, S).astype(np.int32)
    if greedy:
        want = jspec.verify_commit(jnp.asarray(logits), jnp.asarray(cand),
                                   jnp.asarray(kv))
        got = tspec.verify_commit(torch.from_numpy(logits),
                                  torch.from_numpy(cand), torch.from_numpy(kv))
    else:
        want = jax.jit(jspec.verify_commit)(
            jnp.asarray(logits), jnp.asarray(cand), jnp.asarray(kv),
            keys=jnp.asarray(keys), gen=jnp.asarray(gen),
            temp=jnp.asarray(temp), top_k=jnp.asarray(top_k),
            top_p=jnp.asarray(top_p), qlog=jnp.asarray(qlog))
        got = tspec.verify_commit(
            torch.from_numpy(logits), torch.from_numpy(cand),
            torch.from_numpy(kv), keys=keys, gen=gen,
            temp=torch.from_numpy(temp), top_k=torch.from_numpy(top_k),
            top_p=torch.from_numpy(top_p), qlog=torch.from_numpy(qlog))
    out, n = (g.numpy() for g in got)
    np.testing.assert_array_equal(n, np.asarray(want[1]))
    for s in range(S):  # positions past n are never read
        np.testing.assert_array_equal(out[s, :n[s]],
                                      np.asarray(want[0])[s, :n[s]])
    assert ((1 <= n) & (n <= kv + 1)).all()
    if greedy and kvec == [K] * S:
        assert n.max() > 1, "no proposal was accepted: a weak case"


def test_draft_from_params_shares_and_slices():
    cfg, _, tp = _params("smollm-135m", "itq3_s")
    tcfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    wq = tp["layers"]["attn"]["wq"]
    sign = torch.ones(256, dtype=torch.int8)
    stacked = torch.ones(tcfg.num_layers, 256, dtype=torch.int8)
    tp = dict(tp, lm_head=torch.zeros(tcfg.d_model, tcfg.vocab_size))
    tp["layers"] = dict(tp["layers"], attn=dict(
        tp["layers"]["attn"],
        wq=QTensor(dict(wq.data, dsign=sign), wq.meta),
        wk=QTensor(dict(tp["layers"]["attn"]["wk"].data, dsign=stacked),
                   tp["layers"]["attn"]["wk"].meta)))
    dp, dcfg = tspec.draft_from_params(tp, tcfg, 2)
    assert dcfg == dataclasses.replace(tcfg, num_layers=2)
    for leaf in ("embed", "ln_f", "lm_head"):
        assert dp[leaf] is tp[leaf]
    dwq = dp["layers"]["attn"]["wq"]
    assert dwq.meta is wq.meta and dwq.data["dsign"] is sign
    assert dp["layers"]["attn"]["wk"].data["dsign"].shape == (2, 256)
    for key, plane in dwq.data.items():
        if key != "dsign":
            assert plane.shape[0] == 2
            assert plane.data_ptr() == wq.data[key].data_ptr()  # a view
    assert dp["layers"]["ln1"]["scale"].shape[0] == 2
    for depth in (0, tcfg.num_layers + 1):
        with pytest.raises(ValueError, match="depth"):
            tspec.draft_from_params(tp, tcfg, depth)
    with pytest.raises(ValueError, match="famil"):
        tspec.draft_from_params(tp, dataclasses.replace(tcfg, family="ssm"),
                                1)


B, T, WIN = 2, 8, K + 1


def _prefilled(cfg, jp, tp, tcfg, rt, jrt):
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, T))
    _, jcache = jax.jit(lambda p, x, c: jlm.forward(
        p, x, jrt, cfg, cache=c, pos=0)[:2])(
        jp, jnp.asarray(toks, jnp.int32),
        jlm.init_cache(cfg, B, MAX_LEN, dtype=jnp.float32, kv_quant=True))
    tcache = tlm.init_cache(tcfg, B, MAX_LEN, kv_quant=True, device="cpu")
    _, tcache = tlm.forward(tp, toks, rt, tcfg, cache=tcache, pos=0)
    return jcache, tcache


def test_score_tokens_and_advance_cache_match_reference():
    """A K+1 window scored at ragged positions (row 0 inside its prefill
    span), then a single token appended with no head."""
    cfg, jp, tp = _params("smollm-135m", "itq3_s")
    tcfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    rt = TRuntime(kv_quant=True)
    jrt = JRuntime(compute_dtype=jnp.float32, kv_quant=True, backend="ref")
    jcache, tcache = _prefilled(cfg, jp, tp, tcfg, rt, jrt)
    rng = np.random.default_rng(6)
    pos = np.array([T - 3, T], np.int32)
    win = rng.integers(0, cfg.vocab_size, (B, WIN)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, x, c, q: jlm.score_tokens(
        p, x, c, q, jrt, cfg))(jp, jnp.asarray(win), jcache, jnp.asarray(pos))
    tl, tcache = tlm.score_tokens(tp, win, tcache, pos, rt, tcfg)
    assert tl.shape == (B, WIN, cfg.vocab_size)
    first = _first_tie(tcache, jcache)
    compared = 0
    for row in range(B):
        upto = int(np.clip(first[row] - pos[row], 0, WIN))
        np.testing.assert_allclose(tl[row, :upto].numpy(),
                                   np.asarray(jl[row, :upto]), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"row {row}")
        compared += upto
    assert compared >= WIN, "rounding ties cut most of the check"

    # the draft's last propose step: one token at pos + K, through the
    # decode token path (its admission prefill is a span: the engine tests)
    pos = pos + WIN
    jadv = jax.jit(lambda p, x, c, q: jlm.advance_cache(p, x, c, q, jrt, cfg))
    one = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    before = {k: v.clone() for k, v in tcache["attn"].items()}
    jcache = jadv(jp, jnp.asarray(one), jcache, jnp.asarray(pos))
    tcache = tlm.advance_cache(tp, one, tcache, pos, rt, tcfg)
    first = _first_tie(tcache, jcache)
    for key, leaf in tcache["attn"].items():
        # (L, B, KV, T, X) -> (B, T): the positions any layer changed
        changed = (leaf != before[key]).any(-1).any(2).any(0)
        for row in range(B):
            assert changed[row].nonzero().flatten().tolist() in (
                [], [int(pos[row])]), key
    assert (first > pos).any(), "every row tied before the last write"


def test_blocks_needed_lookahead_equals_reference():
    cases = [(0, 16, 0), (15, 16, 0), (16, 16, 0), (13, 16, 4), (11, 16, 4),
             (31, 16, 1), (60, 16, 3), (63, 16, 4), (5, 4, 2)]
    assert [tpaged.blocks_needed(*c) for c in cases] == \
        [jpaged.blocks_needed(*c) for c in cases]
    assert tpaged.blocks_needed(13, 16, lookahead=4) == 2
