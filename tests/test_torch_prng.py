"""The port's threefry PRNG (``repro_torch.core.prng``) against JAX's own,
on the CPU: integer stages exactly equal, the float recipes bit for bit
where they are the same f32 operations, and where they call ``log`` (whose
XLA and PyTorch implementations differ in the last bit) within one ulp of
each log, with the count stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro_torch.core import prng

SEEDS = [0, 1, 42, 2**31 - 1, 2**31, 2**32 - 1, 2**32, -1, -2**31,
         12345678901]
VOCABS = [1, 2, 3, 255, 576, 49152, 151936]
TINY = np.finfo(np.float32).tiny


def _u32(rng, size):
    return rng.integers(0, 2**32, size=size, dtype=np.uint64).astype(np.uint32)


def _key(seed=0):
    return jax.random.PRNGKey(seed)


def _raw(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f32 units in the last place (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_partitionable_threefry_is_jaxs_default():
    """random_bits follows the partitionable scheme: if JAX's default
    changes, this fails first."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("n", [1, 2, 3, 10, 11, 1000, 1001])
def test_threefry_2x32_matches_jax(n):
    rng = np.random.default_rng(n)
    for _ in range(4):
        key, count = _u32(rng, 2), _u32(rng, n)
        want = np.asarray(jprng.threefry_2x32(jnp.asarray(key),
                                              jnp.asarray(count)))
        k64, c64 = key.astype(np.int64), count.astype(np.int64)
        got = prng.threefry_2x32(torch.as_tensor(k64), torch.as_tensor(c64))
        np.testing.assert_array_equal(got.numpy(), want)
        # the hash itself on numpy words, as the engine folds keys on the host
        half = (n + 1) // 2
        pad = np.concatenate([c64, np.zeros(n % 2, np.int64)])
        o1, o2 = prng.threefry2x32(k64[0], k64[1], pad[:half], pad[half:])
        np.testing.assert_array_equal(np.concatenate([o1, o2])[:n], want)


def test_seed_key_matches_prngkey():
    for s in SEEDS:
        np.testing.assert_array_equal(prng.seed_key(s), _raw(_key(s)),
                                      err_msg=str(s))


@pytest.mark.parametrize("data", [0, 1, 2**31 - 1, 2**32 - 1])
def test_fold_in_matches_jax(data):
    for s in (0, 7, 2**32 - 1):
        want = _raw(jax.random.fold_in(_key(s), data))
        np.testing.assert_array_equal(
            prng.fold_in(prng.seed_key(s), np.int64(data)), want)
        np.testing.assert_array_equal(
            prng.fold_in(torch.as_tensor(prng.seed_key(s)),
                         torch.tensor(data)).numpy(), want)


def test_fold_in_vectorized_matches_vmap():
    """The engine folds a (slots, 2) key batch with per-row token indices
    on the host, as the reference's ``vmap(fold_in)``."""
    rng = np.random.default_rng(3)
    keys, gen = _u32(rng, (6, 2)), rng.integers(0, 300, 6).astype(np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                                   jnp.asarray(gen)))
    np.testing.assert_array_equal(
        prng.fold_in(keys.astype(np.int64), gen.astype(np.int64)), want)


@pytest.mark.parametrize("vocab", VOCABS)
def test_random_bits_match_jax(vocab):
    for s in (0, 42):
        want = np.asarray(jax.random.bits(_key(s), (vocab,)))
        got = prng.random_bits(prng.seed_key(s), (vocab,))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_key_batch_and_shapes_match_jax():
    rng = np.random.default_rng(5)
    keys = _u32(rng, (4, 2))
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (3, 7)))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(
        prng.random_bits(keys.astype(np.int64), (3, 7)).numpy(), want)
    want = np.asarray(jax.random.bits(_key(9), (5, 33)))
    np.testing.assert_array_equal(
        prng.random_bits(prng.seed_key(9), (5, 33)).numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (TINY, 1.0), (-2.5, 3.0)])
def test_uniform_is_bit_equal(lo, hi):
    for s in (0, 1, 2**32 - 1):
        want = np.asarray(jax.random.uniform(_key(s), (3, 4096),
                                             minval=lo, maxval=hi))
        got = prng.uniform(prng.seed_key(s), (3, 4096), lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_gumbel_within_one_ulp_of_each_log():
    """gumbel = -log(-log(u)) with u bit-equal. XLA's and PyTorch's f32
    logs differ in the last bit on some inputs; the port is held to one
    ulp per log, and the gumbels to the propagation of those ulps. The
    share that is bit-equal is stated."""
    key = _key(42)
    u = np.asarray(jax.random.uniform(key, (49152,), minval=TINY, maxval=1.))
    want = np.asarray(jax.random.gumbel(key, (49152,)))
    got = prng.gumbel(prng.seed_key(42), (49152,)).numpy()
    np.testing.assert_array_equal(
        prng.uniform(prng.seed_key(42), (49152,), TINY, 1.0).numpy(), u)
    jlog = jax.jit(jnp.log)
    inner_j = -np.asarray(jlog(u))
    inner_t = -torch.log(torch.from_numpy(u.copy())).numpy()
    assert _ulps(inner_t, inner_j).max() <= 1
    outer_j = np.asarray(jlog(inner_t))
    outer_t = torch.log(torch.from_numpy(inner_t)).numpy()
    assert _ulps(outer_t, outer_j).max() <= 1
    np.testing.assert_array_equal(-outer_t, got)
    # |d gumbel| <= |d inner| / inner (one ulp of the inner log carried
    # through the outer) + one ulp of each side's outer log
    spacing = lambda x: np.spacing(np.abs(x).astype(np.float32))  # noqa: E731
    bound = (spacing(inner_j) / inner_j + 2 * spacing(want)
             ).astype(np.float64)
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound * 1.0001)
    equal = (got == want).mean()
    print(f"gumbel bit-equal on {equal:.4f} of 49152 draws")
    assert equal > 0.5


def test_categorical_same_token_or_a_measured_tie():
    """>= 1000 seeded (key, row) draws: the same token as
    ``jax.random.categorical``; a difference only where the two best
    perturbed logits lie within the measured gumbel difference."""
    rng = np.random.default_rng(0)
    v, n = 512, 1200
    rows = (rng.standard_normal((n, v)) * rng.uniform(0.1, 4, (n, 1))
            ).astype(np.float32)
    rows[::7, rng.integers(0, v, n)[::7]] = -np.inf  # masked entries
    keys = _u32(rng, (n, 2))
    want = np.asarray(jax.jit(jax.vmap(jax.random.categorical))(
        jnp.asarray(keys), jnp.asarray(rows)))
    got = prng.categorical(keys.astype(np.int64),
                           torch.from_numpy(rows)).numpy()
    differ = np.nonzero(got != want)[0]
    for i in differ:
        gj = np.asarray(jax.random.gumbel(jnp.asarray(keys[i]), (v,)))
        gt = prng.gumbel(keys[i].astype(np.int64), (v,)).numpy()
        pert = np.sort(gj + rows[i])[::-1]
        assert pert[0] - pert[1] <= 2 * np.abs(gt - gj).max()
    print(f"categorical: {n - len(differ)}/{n} draws equal")
    assert len(differ) <= n // 1000


def test_categorical_shared_key_matches_jax():
    """A single (2,) key draws one stream over the whole (B, V) batch."""
    rows = np.random.default_rng(1).standard_normal((4, 300)).astype(
        np.float32)
    want = np.asarray(jax.random.categorical(_key(3), jnp.asarray(rows)))
    got = prng.categorical(prng.seed_key(3), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
def test_bernoulli_is_bit_equal(p):
    for s in (0, 1, 2**32 - 1, 12345):
        want = np.asarray(jax.random.bernoulli(_key(s), p, (256,)))
        got = prng.bernoulli(prng.seed_key(s), p, (256,)).numpy()
        np.testing.assert_array_equal(got, want)
