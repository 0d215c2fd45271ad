"""JAX's threefry2x32 PRNG in integer torch ops (the functions of
``jax.random`` that the reference's sampler and ``quip3`` reach).

``torch.Generator`` cannot reproduce JAX's streams, so the port computes
them itself: the Threefry-2x32 hash (20 rounds, JAX's key schedule), raw
keys from a seed, ``fold_in``, 32-bit random bits, and the float recipes
on top of them (``uniform``, ``gumbel``, ``categorical``, ``bernoulli``),
each as the jax 0.9 sources compute it under the default
``jax_threefry_partitionable=True``: the counters of ``random_bits`` are
the (hi, lo) words of each element's flat index and the bits are the
hash's two output words XOR-ed.

A key is a pair of uint32 words, held here as an integer array of shape
(..., 2) (numpy on the host, or a torch tensor on any device). The words
are computed in int64 and masked to 32 bits after every add and left
shift: PyTorch has no uint32 shifts on the CPU, and the same code then
runs, bit for bit, on the host, the CPU and the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["threefry2x32", "threefry_2x32", "seed_key", "fold_in",
           "random_bits", "uniform", "gumbel", "categorical", "bernoulli"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000  # 1.0f: uniform's exponent
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter words ``(x1, x2)`` under key
    ``(k1, k2)``: five groups of four rounds, the key injected after each
    group. Every argument is an int64 array (numpy or torch) of uint32
    values; they broadcast. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def threefry_2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``jax._src.prng.threefry_2x32``: hash the flat ``count`` words, the
    first half as x1 and the second as x2 (an odd count padded with one
    zero, dropped again), concatenated back to ``count``'s shape."""
    flat = count.reshape(-1)
    n = flat.shape[0]
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.shape[0] // 2
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], flat[:half], flat[half:])
    return torch.cat([o1, o2])[:n].reshape(count.shape)


def seed_key(seed: int) -> np.ndarray:
    """The raw key of ``jax.random.PRNGKey(seed)``: JAX's default 32-bit
    mode keeps the seed's low 32 bits (negative seeds wrap) under a zero
    high word. An int64 (2,) numpy array."""
    return np.array([0, int(seed) & _M32], np.int64)


def fold_in(key, data):
    """``jax.random.fold_in``: the hash of the count ``[0, data]`` (data
    cast to uint32) under ``key``. Vectorized: ``key`` (..., 2) and
    ``data`` (...) broadcast, as ``vmap(fold_in)`` over a batch."""
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], 0, data & _M32)
    if isinstance(o1, torch.Tensor):
        return torch.stack([o1, o2], dim=-1)
    return np.stack(np.broadcast_arrays(o1, o2), axis=-1)


def random_bits(key, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``shape`` under ``key`` (2,), or one
    row of bits per key under ``key`` (..., 2) (a vmapped draw: the
    leading axes of ``key`` prepend to ``shape``). int64 values below
    2**32 on ``key``'s device."""
    key = torch.as_tensor(key, dtype=torch.int64)
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    o1, o2 = threefry2x32(k1, k2, (idx >> 32).reshape(shape),
                          (idx & _M32).reshape(shape))
    return o1 ^ o2


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """23 random mantissa bits under the exponent of 1.0, minus 1: f32 in
    [0, 1)."""
    fb = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0
            ) -> torch.Tensor:
    """f32 ``jax.random.uniform``: ``max(minval, u * (maxval - minval) +
    minval)`` with ``u`` from the bits. XLA contracts the scale and shift
    into one fused multiply-add; the port takes the product exactly in f64
    (24-bit by 24-bit mantissas) and rounds the sum to f32, which is the
    same value for the unit ranges the sampler and ``bernoulli`` use
    (``maxval - minval`` is 1.0 there, so the product is exact anyway)."""
    u = _bits_to_unit(random_bits(key, shape))
    # the bounds stay Python scalars holding f32 values: a tensor made from
    # one would be a blocking host-to-device copy
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    if span == 1.0:
        return torch.clamp_min(u + lo, lo)
    return torch.clamp_min((u.double() * span + lo).to(torch.float32), lo)


def gumbel(key, shape) -> torch.Tensor:
    """f32 ``jax.random.gumbel``, mode ``"low"`` (JAX's default):
    ``-log(-log(uniform(tiny, 1)))``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY_F32, 1.0)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the first argmax of
    ``gumbel + logits``. ``key`` (2,) draws one stream over the whole of
    ``logits``; ``key`` (B, 2) with ``logits`` (B, V) draws row b under
    key b (``vmap(categorical)``), so a row's token does not depend on its
    batchmates. int64."""
    key = torch.as_tensor(key, dtype=torch.int64, device=logits.device)
    logits = logits.to(torch.float32)
    if key.dim() == 2:
        g = gumbel(key, logits.shape[-1:])
    else:
        g = gumbel(key, logits.shape)
    return torch.argmax(g + logits, dim=-1)


def bernoulli(key, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` in f32, mode ``"low"``: ``uniform < p``."""
    return uniform(key, shape) < p
