"""The attention kernel's split-and-combine, in its plain version.

The CUDA kernel cuts each row's keys into splits of whole 32-key tiles,
computes a partial ``(acc, m, l)`` per split and combines the splits below
the row's limit in ascending order. ``attn_q8_split_ref`` is that math in
plain PyTorch. Here it is held against the plain version ``attn_q8_ref``
(1e-6 of the largest magnitude: both f32, the combine rescales once more;
``m`` exactly, a max of maxima) and against the reference's
``attn_q8_pallas`` in interpret mode (the kernel-test tolerance), at the
edges of the cut: split lengths 32, 64 and T; ``kv_len`` 0, 1, on a split
boundary and T; causal query tiles whose limit ends inside the first split;
the paged layout through ``paged_to_dense``. The kernel itself is held to
the same cases on the card (the ``gpu``-marked test, and ``chip_smoke.py``
phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn_decode import attn_q8_pallas
from repro_torch.kernels import attn_q8 as tattn

TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT_REL = 1e-6


def _inputs(seed, *, r, tq, g, hd, t, kv_len, q_offset):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((r, tq, g, hd)).astype(np.float32)
    kc = rng.integers(-127, 128, (r, t, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (r, t, hd)).astype(np.int8)
    ks = (rng.random((r, t)) * 0.05 + 1e-3).astype(np.float16)
    vs = (rng.random((r, t)) * 0.05 + 1e-3).astype(np.float16)
    return (q, kc, ks, vc, vs, np.asarray(kv_len, np.int32),
            np.asarray(q_offset, np.int32))


def _assert_split_matches_plain(got, want):
    for name, a, b in zip(("acc", "l"), (got[0], got[2]), (want[0], want[2])):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        assert err <= SPLIT_REL * max(scale, 1.0), (name, err, scale)
    assert torch.equal(got[1], want[1]), "m differs"


def _assert_empty(acc, m, l, rows):
    assert (m[rows] == -1e30).all() and (l[rows] == 0).all()
    assert (acc[rows] == 0).all()
    assert torch.isfinite(acc).all() and torch.isfinite(m).all()


# (T, kv_len per row): empty, one key, on a 32 and a 64 boundary, full
DECODE_ROWS = (96, [0, 1, 32, 64, 95, 96])


@pytest.mark.parametrize("split_keys", [32, 64, 96])
@pytest.mark.parametrize("hd", [32, 64])
def test_decode_split_matches_plain_and_reference(split_keys, hd):
    t, lens = DECODE_ROWS
    r = len(lens)
    args = _inputs(split_keys + hd, r=r, tq=1, g=3, hd=hd, t=t, kv_len=lens,
                   q_offset=[0] * r)
    sm = hd ** -0.5
    targs = [torch.from_numpy(a) for a in args]
    got = tattn.attn_q8_split_ref(*targs, sm_scale=sm, causal=False,
                                  split_keys=split_keys)
    _assert_split_matches_plain(
        got, tattn.attn_q8_ref(*targs, sm_scale=sm, causal=False))
    want = attn_q8_pallas(*map(jnp.asarray, args), sm_scale=sm, causal=False,
                          tq=1, tt=16, interpret=True)
    for name, a, b in zip(("acc", "m", "l"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    _assert_empty(*got, rows=0)


# causal query tiles: row 0's limit ends inside the first split (queries
# 0..7 see keys 0..7), row 1 starts on a split boundary, row 2 is causally
# empty past kv_len (kv_len 0 with a nonzero offset), row 3 spans the cache
CAUSAL_ROWS = dict(t=96, kv_len=[8, 40, 0, 96], q_offset=[0, 32, 20, 88])


@pytest.mark.parametrize("split_keys", [32, 64, 96])
def test_causal_split_matches_plain_and_reference(split_keys):
    tq = 8
    args = _inputs(7 + split_keys, r=4, tq=tq, g=2, hd=32, **CAUSAL_ROWS)
    sm = 32 ** -0.5
    targs = [torch.from_numpy(a) for a in args]
    got = tattn.attn_q8_split_ref(*targs, sm_scale=sm, causal=True,
                                  split_keys=split_keys)
    _assert_split_matches_plain(
        got, tattn.attn_q8_ref(*targs, sm_scale=sm, causal=True))
    want = attn_q8_pallas(*map(jnp.asarray, args), sm_scale=sm, causal=True,
                          tq=tq, tt=16, interpret=True)
    for name, a, b in zip(("acc", "m", "l"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    _assert_empty(*got, rows=2)
    # row 0 query 0 sees key 0 alone: l is its one weight, exp(0) * 1
    assert got[2][0, 0].eq(1.0).all()


def test_split_ref_on_paged_cache_matches_paged_plain_version():
    """The paged layout: pool planes behind a shuffled table, gathered by
    ``paged_to_dense``; the split-and-combine over that view equals the
    paged plain version (the kernel's paged and dense passes are bit-equal
    over the same view)."""
    rng = np.random.default_rng(11)
    b, kvh, g, hd, bs, maxb = 2, 3, 2, 32, 16, 5
    nb = b * maxb + 1
    t = maxb * bs
    cache = {
        "k": torch.from_numpy(rng.integers(-127, 128, (nb, kvh, bs, hd))
                              .astype(np.int8)),
        "v": torch.from_numpy(rng.integers(-127, 128, (nb, kvh, bs, hd))
                              .astype(np.int8)),
        "k_scale": torch.from_numpy((rng.random((nb, kvh, bs, 1)) * 0.05
                                     + 1e-3).astype(np.float16)),
        "v_scale": torch.from_numpy((rng.random((nb, kvh, bs, 1)) * 0.05
                                     + 1e-3).astype(np.float16)),
        "table": torch.from_numpy(
            (1 + rng.permutation(b * maxb)).reshape(b, maxb)
            .astype(np.int32)),
    }
    dense = tattn.paged_to_dense(cache)
    r = b * kvh
    q = torch.from_numpy(rng.standard_normal((r, 1, g, hd))
                         .astype(np.float32))
    kv_len = torch.tensor([64, 33], dtype=torch.int32).repeat_interleave(kvh)
    q_off = torch.zeros(r, dtype=torch.int32)
    sm = hd ** -0.5
    got = tattn.attn_q8_split_ref(
        q, dense["k"].reshape(r, t, hd), dense["k_scale"].reshape(r, t),
        dense["v"].reshape(r, t, hd), dense["v_scale"].reshape(r, t), kv_len,
        q_off, sm_scale=sm, causal=False, split_keys=32)
    pr = nb * kvh
    want = tattn.attn_q8_paged(
        q, cache["k"].reshape(pr, bs, hd), cache["k_scale"].reshape(pr, bs),
        cache["v"].reshape(pr, bs, hd), cache["v_scale"].reshape(pr, bs),
        kv_len, q_off, tattn.paged_row_table(cache["table"], kvh),
        block_size=bs, sm_scale=sm, causal=False)
    _assert_split_matches_plain(got, want)


@pytest.mark.parametrize("r,tq,g,t,want", [
    (12, 1, 3, 256, (1, 1, (8, 1, 12))),     # decode: 96 blocks, the most
    (12, 64, 3, 256, (10, 1, (8, 7, 12))),   # prefill: 672 blocks
    (1, 1, 1, 40, (1, 1, (2, 1, 1))),        # a ragged last tile
    (64, 1, 1, 4096, (1, 8, (16, 1, 64))),   # 16 splits of 8 tiles
    (1, 1, 1, 10240, (1, 16, (20, 1, 1))),   # a split holds at most 16 tiles
])
def test_attn_grid_from_static_shapes(r, tq, g, t, want):
    assert tattn.attn_grid(r, tq, g, t) == want
    tqb, st, (ns, nqt, rows) = want
    assert tqb * g <= tattn.ROWS_PER_BLOCK and st <= tattn.MAX_SPLIT_TILES
    assert ns * st * tattn.KEY_TILE >= t and nqt * tqb >= tq


def test_attn_grid_and_alignment_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="query heads"):
        tattn.attn_grid(4, 1, 33, 64)
    codes = torch.zeros(4 * 64 + 1, dtype=torch.int8)
    tattn.check_aligned("attn_q8", codes[:256])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_aligned("attn_q8", codes[1:].view(4, 64))


@pytest.mark.gpu
def test_cuda_split_kernel_edges_deterministic_and_paged_exact():
    """On the card: the kernel at the split edges against the plain
    version (1e-4 relative), twice with the same bits, the empty rows
    exact, and the paged kernel equal to the dense one over the gathered
    view. Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    dev = torch.device("cuda")
    for causal, tq, rows in ((False, 1, dict(t=DECODE_ROWS[0],
                                             kv_len=DECODE_ROWS[1],
                                             q_offset=[0] * 6)),
                             (True, 8, CAUSAL_ROWS)):
        args = [torch.from_numpy(a).to(dev) for a in _inputs(
            5, r=len(rows["kv_len"]), tq=tq, g=3, hd=64, **rows)]
        kw = dict(sm_scale=0.125, causal=causal)
        got = tattn.attn_q8(*args, **kw)
        again = tattn.attn_q8(*args, **kw)
        want = tattn.attn_q8_ref(*args, **kw)
        for a, b, c in zip(got, again, want):
            assert torch.equal(a, b)
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
        q, kc, ks, vc, vs, kl, off = args
        r, t = kc.shape[:2]
        bs = 16
        table = torch.arange(r * (t // bs), dtype=torch.int32,
                             device=dev).reshape(r, t // bs)
        paged = tattn.attn_q8_paged(
            q, kc.reshape(-1, bs, 64), ks.reshape(-1, bs),
            vc.reshape(-1, bs, 64), vs.reshape(-1, bs), kl, off, table,
            block_size=bs, **kw)
        for a, b in zip(paged, got):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
