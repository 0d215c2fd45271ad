"""Deterministic sharded synthetic-token pipeline (a copy of
``repro/data/pipeline.py``, numpy only).

A fixed Markov-Zipf "language": a seeded transition table gives every token
a small set of likely successors (bigram structure a model can learn), with
occasional resets to a Zipf-distributed unigram draw. A batch is a pure
function of ``(seed, step, shard, num_shards)``, so a resumed run replays
exactly the batches it would have seen and hosts' shards are disjoint. The
draws are numpy's, in the reference's order, so every batch equals the
reference's bit for bit.

The same corpus gives the held-out eval stream (steps from a disjoint
range) on which the quantization formats' eval losses are compared.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticCorpus"]


@dataclasses.dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    branching: int = 4
    reset_prob: float = 0.05

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # each token's successor menu; Zipf-biased resets
        zipf_p = 1.0 / np.arange(1, v + 1)
        zipf_p /= zipf_p.sum()
        self._perm = rng.permutation(v)  # rank -> token for Zipf draws
        self._zipf_cdf = np.cumsum(zipf_p)
        self._table = rng.integers(0, v, size=(v, self.branching),
                                   dtype=np.int64)

    def _zipf_draw(self, u: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self._zipf_cdf, u, side="right")
        return self._perm[np.clip(idx, 0, self.vocab_size - 1)]

    def batch(self, step: int, batch_size: int, seq_len: int,
              shard: int = 0, num_shards: int = 1) -> dict:
        """``{"tokens": (B, T) int32, "labels": (B, T) int32}``, labels the
        tokens shifted by one; ``(step, shard)`` fixes the contents."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard, num_shards]))
        b, t = batch_size, seq_len
        seq = np.empty((b, t + 1), dtype=np.int64)
        seq[:, 0] = self._zipf_draw(rng.random(b))
        resets = rng.random((b, t)) < self.reset_prob
        choice = rng.integers(0, self.branching, size=(b, t))
        uz = rng.random((b, t))
        zipf_next = self._zipf_draw(uz.reshape(-1)).reshape(b, t)
        for i in range(t):
            nxt = self._table[seq[:, i], choice[:, i]]
            seq[:, i + 1] = np.where(resets[:, i], zipf_next[:, i], nxt)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def eval_batches(self, n: int, batch_size: int, seq_len: int):
        """Held-out stream: steps from a range training never reaches."""
        for i in range(n):
            yield self.batch(10_000_000 + i, batch_size, seq_len)
