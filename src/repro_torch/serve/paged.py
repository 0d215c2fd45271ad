"""Paged rotated-int8 KV cache: a block-pool allocator over the quantized
code and scale planes (port of ``repro/serve/paged.py``).

One shared pool of ``num_blocks`` fixed-size blocks replaces the dense
``slots x max_len`` reservation. A per-slot int32 block table maps logical
position ``p`` to pool block ``table[slot, p // BS]`` at offset ``p % BS``;
:class:`BlockPool` hands out ref-counted blocks from a LIFO free list.

Layout: pool planes are ``(L, num_blocks, KV, block_size, HD)`` int8 codes
and ``(L, num_blocks, KV, block_size, 1)`` fp16 scales, the dense
``(L, B, KV, T, X)`` layout with (batch, position) re-cut into (block,
offset), so the engine's slot swap gathers blocks along axis 1 exactly as
it gathers slots on the dense layout.

**Block 0 is the reserved null block.** Empty table entries point at it,
and pad writes of a bucketed prefill (and the writes of idle decode slots)
land there. It collects finite garbage that attention never reads (keys at
or past ``kv_len`` get weight exactly 0), so admission never zeroes a
block. The one garbage the mask cannot neutralize is NaN (``0 * NaN``):
quarantine zeroes a poisoned slot's exclusively held blocks before they
return to the free list (:func:`zero_blocks`).

Prefix sharing: requests whose prompts share a prefix of FULL blocks share
those blocks through refcounts, keyed by chain hashes (each block's sha1
folds in its predecessor's), because the K/V at position ``p`` depend on
every earlier token. The partial tail block is always private. Admission
still prefills the whole prompt, so a shared block is rewritten with
bit-identical values.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core.fwht import is_pow2

__all__ = ["BlockPool", "PoolExhausted", "init_paged_cache", "zero_blocks",
           "blocks_needed", "NULL_BLOCK"]

# Block 0 never leaves the pool: a table row of zeros is always safe to
# gather and scatter through.
NULL_BLOCK = 0


def blocks_needed(pos: int, block_size: int, lookahead: int = 0) -> int:
    """Blocks a slot must own before a decode window starting at ``pos``:
    every position the window can commit, up to ``pos + lookahead``
    inclusive (a speculative window of K drafts commits at most K+1
    tokens, the last at ``pos + K``). Verify writes past that land in the
    null block, which is safe only for positions the mask never reads."""
    return (int(pos) + int(lookahead)) // int(block_size) + 1


class PoolExhausted(RuntimeError):
    """Raised by :meth:`BlockPool.alloc` when no free block remains; the
    engine turns it into admission backoff or victim preemption."""


class BlockPool:
    """Host-side free-list allocator with ref-counted blocks. Pure
    bookkeeping: it never touches device memory."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (block 0 is the reserved "
                             f"null block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.ref = np.zeros(num_blocks, np.int32)
        self.ref[NULL_BLOCK] = 1  # pinned forever
        # LIFO free list: the most recently freed block is reused first
        self._free = list(range(num_blocks - 1, NULL_BLOCK, -1))
        # chain hash of a FULL prompt block <-> the block holding it
        self._prefix: dict[bytes, int] = {}
        self._block_key: dict[int, bytes] = {}
        self.prefix_hits = 0

    # --- capacity ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Usable blocks (the null block is not allocatable)."""
        return self.num_blocks - 1

    def available(self) -> int:
        return len(self._free)

    def used(self) -> int:
        return self.capacity - len(self._free)

    def utilization(self) -> float:
        return self.used() / self.capacity

    # --- alloc / refcount -------------------------------------------------
    def alloc(self) -> int:
        """Pop a free block with refcount 1; :class:`PoolExhausted` when
        the pool is dry."""
        if not self._free:
            raise PoolExhausted(
                f"block pool dry: {self.capacity} blocks all referenced")
        blk = self._free.pop()
        if self.ref[blk] != 0:
            raise RuntimeError(f"free-list block {blk} has refs")
        self.ref[blk] = 1
        return blk

    def incref(self, blk: int) -> None:
        if blk == NULL_BLOCK:
            return
        if self.ref[blk] <= 0:
            raise RuntimeError(f"incref on unallocated block {blk}")
        self.ref[blk] += 1

    def decref(self, blk: int) -> bool:
        """Drop one reference; True when the block was freed."""
        if blk == NULL_BLOCK:
            return False
        if self.ref[blk] <= 0:
            raise RuntimeError(f"double free of block {blk}")
        self.ref[blk] -= 1
        if self.ref[blk] == 0:
            key = self._block_key.pop(blk, None)
            if key is not None:
                self._prefix.pop(key, None)
            self._free.append(blk)
            return True
        return False

    # --- prefix sharing ---------------------------------------------------
    @staticmethod
    def chain_hashes(prompt: np.ndarray, block_size: int) -> list[bytes]:
        """Chain hash per FULL block of ``prompt``: hash(i) covers tokens
        [0, (i+1)*BS), so two prompts share hash(i) iff their first
        (i+1)*BS tokens are equal."""
        toks = np.asarray(prompt, np.int32)
        out, h = [], b""
        for i in range(len(toks) // block_size):
            chunk = toks[i * block_size:(i + 1) * block_size]
            h = hashlib.sha1(h + chunk.tobytes()).digest()
            out.append(h)
        return out

    def lookup_prefix(self, key: bytes) -> Optional[int]:
        """The live block holding chain hash ``key``, or None."""
        return self._prefix.get(key)

    def register_prefix(self, key: bytes, blk: int) -> None:
        """Publish ``blk`` as the holder of chain hash ``key``; the first
        writer wins (both wrote the same bytes). Freeing the block drops
        its key."""
        if key not in self._prefix:
            self._prefix[key] = blk
            self._block_key[blk] = key

    def alloc_prompt(self, prompt: np.ndarray) -> list[int]:
        """The block chain for a prompt: full prefix blocks are shared
        when a live holder exists, the rest allocated. All or nothing: on
        :class:`PoolExhausted` every block taken so far is released."""
        n = len(prompt)
        nblk = -(-n // self.block_size)
        keys = self.chain_hashes(prompt, self.block_size)
        blocks: list[int] = []
        try:
            for i in range(nblk):
                shared = self.lookup_prefix(keys[i]) if i < len(keys) else None
                if shared is not None:
                    self.incref(shared)
                    self.prefix_hits += 1
                    blocks.append(shared)
                else:
                    blk = self.alloc()
                    if i < len(keys):  # a full block: publish it for sharers
                        self.register_prefix(keys[i], blk)
                    blocks.append(blk)
        except PoolExhausted:
            for blk in blocks:
                self.decref(blk)
            raise
        return blocks

    def check(self, tables: Iterable[Iterable[int]] = ()) -> None:
        """Assert allocator consistency: refcounts cover the live tables,
        the free list is disjoint from referenced blocks, no block leaked,
        and the prefix map points only at live blocks."""
        counts = np.zeros(self.num_blocks, np.int64)
        for row in tables:
            for blk in row:
                if blk != NULL_BLOCK:
                    counts[blk] += 1
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert NULL_BLOCK not in free, "null block escaped into free list"
        assert self.ref[NULL_BLOCK] >= 1, "null block lost its pin"
        for blk in range(1, self.num_blocks):
            r = int(self.ref[blk])
            assert r >= 0, f"negative refcount on block {blk}"
            assert (blk in free) == (r == 0), (
                f"block {blk}: ref={r} but free-list membership "
                f"{blk in free}")
            assert r >= counts[blk], (
                f"block {blk}: {counts[blk]} table references exceed "
                f"refcount {r}")
        for key, blk in self._prefix.items():
            assert self.ref[blk] > 0, f"prefix map points at freed block {blk}"
            assert self._block_key.get(blk) == key, "prefix maps diverged"


def init_paged_cache(cfg, num_blocks: int, block_size: int, *,
                     device="cuda") -> dict:
    """Zeroed pool ``{"attn": {k, v, k_scale, v_scale}}`` with planes
    (L, num_blocks, KV, block_size, HD|1): the paged counterpart of
    ``lm.init_cache(..., kv_quant=True)``. The block table lives outside
    this tree; the engine passes it beside the planes."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if not is_pow2(hd):
        raise ValueError(f"paged kv cache needs a power-of-two head_dim, "
                         f"got {hd}")
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(
            f"paged KV cache supports pure-attention families "
            f"(dense/vlm/moe); {cfg.family!r} carries recurrent or "
            f"cross-attention state that has no block structure")
    shape = (cfg.num_layers, num_blocks, kvh, block_size)
    return {"attn": {
        "k": torch.zeros(*shape, hd, dtype=torch.int8, device=device),
        "v": torch.zeros(*shape, hd, dtype=torch.int8, device=device),
        "k_scale": torch.zeros(*shape, 1, dtype=torch.float16, device=device),
        "v_scale": torch.zeros(*shape, 1, dtype=torch.float16, device=device),
    }}


def zero_blocks(cache: dict, blocks) -> dict:
    """Zero ``blocks`` of every layer and plane, in place (quarantine
    cleanup before the blocks return to the free list). Returns
    ``cache``."""
    blocks = list(blocks)
    if blocks:
        for leaf in cache["attn"].values():
            idx = torch.as_tensor(blocks, dtype=torch.int64,
                                  device=leaf.device)
            leaf.index_fill_(1, idx, 0)
    return cache
