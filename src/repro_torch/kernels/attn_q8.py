"""Attention over the rotated-int8 KV cache (kernel 4, ``csrc/attn_q8.cu``).

Port of the dense layout of ``repro/kernels/attn_decode.py``. The cache
holds each K/V vector FWHT-rotated and int8-quantized with an fp16 scale.
Because H is an isometry, ``q . k = (H q) . (H k)``: scores come straight
from the K codes against the rotated query, the V scale folds into the
softmax weight, and one inverse FWHT per query span undoes the rotation of
the weighted V sum.

:func:`attn_q8` (the kernel wrapper; plain version :func:`attn_q8_ref`)
works on the kernel layout ``q_rot (R, TQ, G, HD)`` with R = B*KV rows and
returns the unnormalized ``(acc, m, l)``. :func:`attn_q8_paged` (plain
version :func:`attn_q8_paged_ref`) is the same kernel over a block pool
(``serve/paged.py``): key ``t`` of row ``i`` lies in pool row
``table[i, t // BS]`` at offset ``t % BS``. :func:`decode_attn_q8` and
:func:`prefill_attn_q8` are the serving entry points: they rotate q, call
the kernel (or, with ``backend="ref"``, and under ``"auto"`` on CPU
tensors for a shape :func:`kernel_supported` refuses, the plain versions
:func:`decode_attn_q8_ref` / :func:`prefill_attn_q8_ref`, over
:func:`paged_to_dense` of a paged cache), merge the decode self token,
normalize and apply the final inverse FWHT. Both rotations run in the FWHT
kernel at head_dim points (``kernels/fwht.py:fwht_last``), or with
``backend="ref"`` in the plain butterfly. A cache dict with a ``"table"``
entry is paged.

The kernel splits each row's keys across blocks and combines the splits'
partial ``(acc, m, l)`` in split order (:func:`attn_grid` picks the cut
from the static shapes; :func:`attn_q8_split_ref` is the plain version of
that split-and-combine, for the tests). Its workspace and its zeroed
ticket array persist per device and are reused by every call, which is
safe because the calls run in order on one stream.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.fwht import is_pow2
from repro_torch.kernels import _build
from repro_torch.kernels.fwht import fwht_last

__all__ = ["attn_q8", "attn_q8_ref", "attn_q8_split_ref", "attn_q8_paged",
           "attn_q8_paged_ref", "attn_grid", "decode_attn_q8",
           "decode_attn_q8_ref", "prefill_attn_q8", "prefill_attn_q8_ref",
           "paged_row_table", "paged_to_dense", "kernel_supported",
           "ATTN_BACKENDS"]

NEG_INF = -1e30
ATTN_BACKENDS = ("auto", "ref", "cuda")
ROWS_PER_BLOCK = 32  # query rows (TQB * G) one thread block holds
KEY_TILE = 32  # keys per tile; a split is a run of whole tiles
MAX_SPLIT_TILES = 16  # tiles per split (the kernel's shared key offsets)
MAX_SPLITS = 16  # splits per row the combine reads, up to 16 tiles each

_SIG = {"attn_q8_launch": (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 7
        + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p),
        "attn_q8_paged_launch": (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 9
        + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)}
_SCRATCH: dict = {}  # (device, name) -> persistent workspace / tickets


def attn_grid(r: int, tq: int, g: int, t: int):
    """The kernel's cut, from static shapes only (never ``kv_len``'s
    values): ``(tqb, split_tiles, grid)``. A block holds ``tqb`` query
    positions (all G heads of each, up to 32 rows), so one K/V tile feeds
    as many rows as it can; a split is one 32-key tile while that gives at
    most ``MAX_SPLITS`` splits, else the fewest tiles (up to 16) that keep
    to it, so the combine reads a bounded number of partials. The
    shortest split fills the card best: on the H100 at smollm-135m's rows,
    ``chip_smoke.py`` phase 3 times every longer split, and fewer query
    positions per block, as slower. ``grid`` is (splits, query tiles,
    rows)."""
    if g > ROWS_PER_BLOCK:
        raise ValueError(f"attn_q8: {g} query heads per KV head; the kernel "
                         f"holds at most {ROWS_PER_BLOCK}")
    tqb = max(1, min(tq, ROWS_PER_BLOCK // g))
    tiles = max(1, -(-t // KEY_TILE))
    st = min(MAX_SPLIT_TILES, -(-tiles // MAX_SPLITS))
    return tqb, st, (-(-tiles // st), -(-tq // tqb), r)


def attn_q8_split_ref(q_rot, k_codes, k_scale, v_codes, v_scale, kv_len,
                      q_offset, *, sm_scale: float, causal: bool,
                      split_keys: int):
    """Plain version of the kernel's split-and-combine: the plain
    formulas of :func:`attn_q8_ref` over each run of ``split_keys`` keys
    give the split's partial ``(acc, m, l)``; then, per query row, over the
    splits that start below its limit (``kv_len`` clamped to T, and with
    ``causal`` its own position + 1), in ascending order: ``m = max m_s``,
    ``l = sum l_s e^(m_s - m)``, ``acc = sum acc_s e^(m_s - m)``. A row with
    no such split gets ``m = -1e30, l = 0, acc = 0``. The tests hold it
    against the plain version and the reference; the main path never
    calls it."""
    r, tq, g, hd = q_rot.shape
    t = k_codes.shape[1]
    dev = q_rot.device
    limit = torch.clamp(kv_len.to(torch.int64), max=t)[:, None].expand(r, tq)
    if causal:
        qpos = (q_offset.to(torch.int64)[:, None]
                + torch.arange(tq, device=dev)[None, :])
        limit = torch.minimum(limit, qpos + 1)
    limit = limit[:, :, None, None]  # (R, TQ, 1, 1)
    m = torch.full((r, tq, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((r, tq, g, hd), dtype=torch.float32, device=dev)
    parts = []
    for t0 in range(0, t, split_keys):
        t1 = min(t0 + split_keys, t)
        lens = torch.clamp(kv_len.to(torch.int64) - t0, 0, t1 - t0)
        offs = q_offset.to(torch.int64) - t0
        parts.append((t0, attn_q8_ref(
            q_rot, k_codes[:, t0:t1].contiguous(),
            k_scale[:, t0:t1].contiguous(), v_codes[:, t0:t1].contiguous(),
            v_scale[:, t0:t1].contiguous(), lens.to(torch.int32),
            offs.to(torch.int32), sm_scale=sm_scale, causal=causal)))
    for t0, (_, m_s, _) in parts:
        m = torch.where(t0 < limit, torch.maximum(m, m_s), m)
    for t0, (acc_s, m_s, l_s) in parts:
        used = t0 < limit
        e = torch.exp(m_s - m)
        l = torch.where(used, l + l_s * e, l)
        acc = torch.where(used, acc + acc_s * e, acc)
    return acc, m, l


def attn_q8_ref(q_rot, k_codes, k_scale, v_codes, v_scale, kv_len, q_offset,
                *, sm_scale: float, causal: bool):
    """Plain version of the kernel: the same score and V-scale-folding
    formulas with a plain (non-online) max and sum over all keys.

    q_rot (R, TQ, G, HD) f32; codes (R, T, HD) int8; scales (R, T) f16;
    kv_len, q_offset (R,) int32. Returns acc (R, TQ, G, HD), m and l
    (R, TQ, G, 1), f32."""
    r, tq, g, hd = q_rot.shape
    t = k_codes.shape[1]
    s = torch.einsum("rqgd,rtd->rqgt", q_rot.to(torch.float32),
                     k_codes.to(torch.float32))
    s = s * (k_scale.to(torch.float32) * sm_scale)[:, None, None, :]
    kpos = torch.arange(t, device=q_rot.device)
    valid = kpos[None, None, None, :] < kv_len.to(torch.int64)[:, None, None, None]
    if causal:
        qpos = (q_offset.to(torch.int64)[:, None]
                + torch.arange(tq, device=q_rot.device)[None, :])  # (R, TQ)
        valid = valid & (kpos[None, None, None, :] <= qpos[:, :, None, None])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    pv = p * v_scale.to(torch.float32)[:, None, None, :]
    acc = torch.einsum("rqgt,rtd->rqgd", pv, v_codes.to(torch.float32))
    return acc, m, l


def _check_head_dim(what: str, hd: int) -> None:
    if not is_pow2(hd) or not 32 <= hd <= 128:
        raise ValueError(f"{what}: head_dim {hd} must be a power of two "
                         f"in [32, 128]")


def check_aligned(what: str, *planes) -> None:
    """Raise unless every code plane starts on a 16-byte boundary: the
    kernel copies 16 codes at a time."""
    for p in planes:
        if p.data_ptr() % 16:
            raise ValueError(f"{what}: code plane at {p.data_ptr():#x} is "
                             f"not 16-byte aligned")


def _scratch(device, name: str, n: int, dtype, zero: bool):
    buf = _SCRATCH.get((device, name))
    if buf is None or buf.numel() < n:
        buf = (torch.zeros if zero else torch.empty)(
            max(n, 1), dtype=dtype, device=device)
        _SCRATCH[(device, name)] = buf
    return buf


def _launch_args(q_rot, t: int):
    """Outputs, workspace, tickets and the cut for one launch."""
    r, tq, g, hd = q_rot.shape
    dev = q_rot.device
    acc = torch.empty((r, tq, g, hd), dtype=torch.float32, device=dev)
    m = torch.empty((r, tq, g, 1), dtype=torch.float32, device=dev)
    tqb, st, (nsplit, nqt, _) = attn_grid(r, tq, g, t)
    ws = _scratch(dev, "ws", nsplit * r * tq * g * (hd + 2) if nsplit > 1
                  else 0, torch.float32, zero=False)
    ticket = _scratch(dev, "ticket", r * nqt, torch.int32, zero=True)
    return acc, m, torch.empty_like(m), ws, ticket, tqb, st


def attn_q8(q_rot, k_codes, k_scale, v_codes, v_scale, kv_len, q_offset, *,
            sm_scale: float, causal: bool):
    """Online-softmax attention of rotated queries over int8 K/V codes:
    the kernel on a CUDA tensor, :func:`attn_q8_ref` on a CPU tensor."""
    r, tq, g, hd = q_rot.shape
    t = k_codes.shape[1]
    if (k_codes.shape != (r, t, hd) or v_codes.shape != (r, t, hd)
            or k_scale.shape != (r, t) or v_scale.shape != (r, t)
            or kv_len.shape != (r,) or q_offset.shape != (r,)):
        raise ValueError("attn_q8: operand shapes do not match q_rot "
                         f"{tuple(q_rot.shape)} and codes {tuple(k_codes.shape)}")
    _check_head_dim("attn_q8", hd)
    _build.check_operands("attn_q8", q_rot.device, zip(
        (q_rot, k_codes, k_scale, v_codes, v_scale, kv_len, q_offset),
        (torch.float32, torch.int8, torch.float16, torch.int8, torch.float16,
         torch.int32, torch.int32)))
    if q_rot.device.type == "cpu":
        return attn_q8_ref(q_rot, k_codes, k_scale, v_codes, v_scale, kv_len,
                           q_offset, sm_scale=sm_scale, causal=causal)
    if not q_rot.is_cuda:
        raise ValueError(f"attn_q8: unsupported device {q_rot.device}")
    check_aligned("attn_q8", k_codes, v_codes)
    acc, m, l, ws, ticket, tqb, st = _launch_args(q_rot, t)
    lib = _build.library("attn_q8", _SIG)
    _build.check(lib.attn_q8_launch(
        q_rot.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        ws.data_ptr(), ticket.data_ptr(), r, tq, g, hd, t, tqb, st,
        float(sm_scale), int(causal), _build.stream_of(q_rot)), "attn_q8")
    _build.launches["attn_q8"] += 1
    return acc, m, l


def attn_q8_paged_ref(q_rot, k_pool, k_scale_pool, v_pool, v_scale_pool,
                      kv_len, q_offset, table, *, block_size: int,
                      sm_scale: float, causal: bool):
    """Plain version of the paged kernel: gather each row's keys through
    the table into the dense view (R, MAXB*BS, ...), then
    :func:`attn_q8_ref`.

    Pooled planes: codes (PR, BS, HD) int8, scales (PR, BS) f16, PR =
    num_blocks*KV pool rows; table (R, MAXB) int32 pool-row table
    (:func:`paged_row_table`)."""
    if k_pool.shape[1] != block_size:
        raise ValueError(f"pooled planes {tuple(k_pool.shape)} are not cut "
                         f"in blocks of {block_size}")
    r, maxb = table.shape
    t = maxb * block_size
    hd = k_pool.shape[-1]
    return attn_q8_ref(q_rot, k_pool[table].reshape(r, t, hd),
                       k_scale_pool[table].reshape(r, t),
                       v_pool[table].reshape(r, t, hd),
                       v_scale_pool[table].reshape(r, t), kv_len, q_offset,
                       sm_scale=sm_scale, causal=causal)


def attn_q8_paged(q_rot, k_pool, k_scale_pool, v_pool, v_scale_pool, kv_len,
                  q_offset, table, *, block_size: int, sm_scale: float,
                  causal: bool):
    """:func:`attn_q8` over a block pool (the reference's ``table``
    contract, ``attn_decode.py:230-247``): key ``t`` of row ``i`` is pool
    row ``table[i, t // block_size]`` at offset ``t % block_size``; masks
    use logical positions, so the result equals :func:`attn_q8` over the
    gathered dense view bit for bit. Table entries must lie in [0, PR).
    The kernel on a CUDA tensor, :func:`attn_q8_paged_ref` on a CPU
    tensor."""
    r, tq, g, hd = q_rot.shape
    pr = k_pool.shape[0]
    maxb = table.shape[1] if table.dim() == 2 else -1
    if (k_pool.shape != (pr, block_size, hd)
            or v_pool.shape != (pr, block_size, hd)
            or k_scale_pool.shape != (pr, block_size)
            or v_scale_pool.shape != (pr, block_size)
            or table.shape != (r, maxb) or kv_len.shape != (r,)
            or q_offset.shape != (r,)):
        raise ValueError(
            f"attn_q8_paged: operand shapes do not match q_rot "
            f"{tuple(q_rot.shape)}, pooled codes {tuple(k_pool.shape)}, "
            f"block_size {block_size} and table {tuple(table.shape)}")
    _check_head_dim("attn_q8_paged", hd)
    _build.check_operands("attn_q8_paged", q_rot.device, zip(
        (q_rot, k_pool, k_scale_pool, v_pool, v_scale_pool, kv_len, q_offset,
         table),
        (torch.float32, torch.int8, torch.float16, torch.int8, torch.float16,
         torch.int32, torch.int32, torch.int32)))
    if q_rot.device.type == "cpu":
        return attn_q8_paged_ref(q_rot, k_pool, k_scale_pool, v_pool,
                                 v_scale_pool, kv_len, q_offset, table,
                                 block_size=block_size, sm_scale=sm_scale,
                                 causal=causal)
    if not q_rot.is_cuda:
        raise ValueError(f"attn_q8_paged: unsupported device {q_rot.device}")
    check_aligned("attn_q8_paged", k_pool, v_pool)
    acc, m, l, ws, ticket, tqb, st = _launch_args(q_rot, maxb * block_size)
    lib = _build.library("attn_q8", _SIG)
    _build.check(lib.attn_q8_paged_launch(
        q_rot.data_ptr(), k_pool.data_ptr(), k_scale_pool.data_ptr(),
        v_pool.data_ptr(), v_scale_pool.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), table.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), ws.data_ptr(), ticket.data_ptr(), r, tq, g, hd, pr,
        block_size, maxb, tqb, st, float(sm_scale), int(causal),
        _build.stream_of(q_rot)), "attn_q8_paged")
    _build.launches["attn_q8_paged"] += 1
    return acc, m, l


def paged_row_table(table: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """Per-slot pool-BLOCK table (B, MAXB) -> per-(slot, kv head) pool-ROW
    table (B*KV, MAXB): the pooled planes flatten (num_blocks, KV, ...) to
    row ``block*KV + head``."""
    b, maxb = table.shape
    heads = torch.arange(kv_heads, dtype=table.dtype, device=table.device)
    rows = table[:, None, :] * kv_heads + heads[None, :, None]
    return rows.reshape(b * kv_heads, maxb)


def paged_to_dense(cache: dict) -> dict:
    """The dense per-slot view of a paged cache dict, ``pool[table]`` per
    plane: (NB, KV, BS, X) planes and a (B, MAXB) table give
    (B, KV, MAXB*BS, X). The plain path runs the dense math over it."""
    kvh = cache["k"].shape[1]
    tbl = cache["table"]

    def g(leaf):
        x = leaf[tbl].transpose(1, 2)  # (B, KV, MAXB, BS, X)
        return x.reshape(x.shape[0], kvh, -1, x.shape[-1])

    return {key: g(cache[key]) for key in ("k", "v", "k_scale", "v_scale")}


def _merge_self_token(acc, m, l, s_self, v_self):
    """One more online-softmax step for the current token, then normalize.

    acc (..., G, HD), m/l (..., G, 1); s_self (..., G, 1) score of the new
    token; v_self (..., 1, HD) its dequantized (still rotated) V row."""
    m_tot = torch.maximum(m, s_self)
    alpha = torch.exp(m - m_tot)
    p_self = torch.exp(s_self - m_tot)
    l_tot = l * alpha + p_self
    return (acc * alpha + p_self * v_self) / l_tot


def kernel_supported(head_dim: int, g: int) -> bool:
    """The kernel's shape gate, static shapes only: a power-of-two
    head_dim in [32, 128] and at most ``ROWS_PER_BLOCK`` query heads per KV
    head."""
    return is_pow2(head_dim) and 32 <= head_dim <= 128 and g <= ROWS_PER_BLOCK


def _use_kernel(backend: str, x: torch.Tensor) -> bool:
    """Kernel pass or plain path for q (B, KV, G, TQ, HD). ``auto`` takes
    the plain path for a shape the kernel does not build only on CPU
    tensors, as the reference's ``auto`` does; on any other device, and
    under ``cuda``, such a shape raises. The gate reads the static shapes
    and the device only, never the outcome of a build or a launch."""
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"backend {backend!r} not in {ATTN_BACKENDS}")
    if backend == "ref":
        return False
    g, hd = x.shape[2], x.shape[-1]
    if not kernel_supported(hd, g):
        if backend == "auto" and x.device.type == "cpu":
            return False
        raise ValueError(f"attn_q8: head_dim {hd} with {g} query heads per "
                         f"KV head; the kernel builds a power-of-two head_dim"
                         f" in [32, 128] and at most {ROWS_PER_BLOCK} query "
                         f"heads")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    return True


def decode_attn_q8_ref(q_rot, k_codes, k_scale, v_codes, v_scale, kv_len, *,
                       sm_scale: float):
    """Plain decode cache pass in the reference layout: q_rot (B, KV, G, HD),
    codes (B, KV, T, HD), scales (B, KV, T, 1), kv_len (B,). Returns the
    unnormalized (acc (B, KV, G, HD), m, l (B, KV, G, 1))."""
    b, kv, g, hd = q_rot.shape
    t = k_codes.shape[2]
    r = b * kv
    acc, m, l = attn_q8_ref(
        q_rot.reshape(r, 1, g, hd), k_codes.reshape(r, t, hd),
        k_scale.reshape(r, t), v_codes.reshape(r, t, hd),
        v_scale.reshape(r, t), kv_len.repeat_interleave(kv),
        torch.zeros(r, dtype=torch.int32, device=q_rot.device),
        sm_scale=sm_scale, causal=False)
    return (acc.reshape(b, kv, g, hd), m.reshape(b, kv, g, 1),
            l.reshape(b, kv, g, 1))


def prefill_attn_q8_ref(q_rot, k_codes, k_scale, v_codes, v_scale, kv_len,
                        q_offset, *, sm_scale: float, causal: bool = True):
    """Plain q-tile cache pass in the reference layout: q_rot
    (B, KV, G, TQ, HD). Returns unnormalized (acc (B, KV, G, TQ, HD),
    m, l (B, KV, G, TQ, 1))."""
    b, kv, g, tq, hd = q_rot.shape
    t = k_codes.shape[2]
    r = b * kv
    acc, m, l = attn_q8_ref(
        q_rot.transpose(2, 3).reshape(r, tq, g, hd), k_codes.reshape(r, t, hd),
        k_scale.reshape(r, t), v_codes.reshape(r, t, hd),
        v_scale.reshape(r, t), kv_len.repeat_interleave(kv),
        q_offset.repeat_interleave(kv), sm_scale=sm_scale, causal=causal)

    def back(a):
        return a.reshape(b, kv, tq, g, a.shape[-1]).transpose(2, 3)
    return back(acc), back(m), back(l)


def _rows(v: torch.Tensor, kv: int) -> torch.Tensor:
    """(B,) per-slot vector -> (B*KV,) int32 per-row vector."""
    return v.to(torch.int32).repeat_interleave(kv).contiguous()


def _kernel_pass(q_rot, cache, kv_len, q_offset, *, kv: int,
                 sm_scale: float, causal: bool):
    """The cache pass through the kernel, dense or paged by the cache
    dict: q_rot (R, TQ, G, HD) with R = B*KV; kv_len (B,); q_offset (B,)
    or None for zeros (decode)."""
    hd = q_rot.shape[-1]
    lens = _rows(kv_len, kv)
    offs = (torch.zeros_like(lens) if q_offset is None
            else _rows(q_offset, kv))
    if "table" in cache:
        nb, _, bs, _ = cache["k"].shape
        pr = nb * kv
        return attn_q8_paged(
            q_rot.contiguous(), cache["k"].reshape(pr, bs, hd),
            cache["k_scale"].reshape(pr, bs), cache["v"].reshape(pr, bs, hd),
            cache["v_scale"].reshape(pr, bs), lens, offs,
            paged_row_table(cache["table"].to(torch.int32), kv),
            block_size=bs, sm_scale=sm_scale, causal=causal)
    r, t = q_rot.shape[0], cache["k"].shape[2]
    return attn_q8(
        q_rot.contiguous(), cache["k"].reshape(r, t, hd),
        cache["k_scale"].reshape(r, t), cache["v"].reshape(r, t, hd),
        cache["v_scale"].reshape(r, t), lens, offs, sm_scale=sm_scale,
        causal=causal)


def decode_attn_q8(q, cache, k_tok, v_tok, kv_len, *, backend: str = "auto"):
    """Single-token decode attention against the rotated-int8 cache.

    q (B, KV, G, 1, HD) unrotated; cache {"k","v": (B, KV, T, HD) int8,
    "k_scale","v_scale": (B, KV, T, 1) f16} (or, paged, (NB, KV, BS, X)
    pool planes plus a (B, MAXB) "table") NOT yet holding the current
    token; k_tok/v_tok its encoded (codes (B, KV, 1, HD), scale
    (B, KV, 1, 1)); kv_len (B,) valid cached positions. The cache pass runs
    in the kernel; the self term merges here. Returns (B, KV, G, 1, HD)."""
    b, kv, g, _, hd = q.shape
    sm_scale = 1.0 / math.sqrt(hd)
    kernel = _use_kernel(backend, q)
    q_rot = fwht_last(q[..., 0, :].to(torch.float32),
                      backend=backend)  # (B, KV, G, HD)
    if kernel:
        acc, m, l = _kernel_pass(q_rot.reshape(b * kv, 1, g, hd), cache,
                                 kv_len, None, kv=kv,
                                 sm_scale=sm_scale, causal=False)
        acc = acc.reshape(b, kv, g, hd)
        m = m.reshape(b, kv, g, 1)
        l = l.reshape(b, kv, g, 1)
    else:
        dc = paged_to_dense(cache) if "table" in cache else cache
        acc, m, l = decode_attn_q8_ref(
            q_rot, dc["k"], dc["k_scale"], dc["v"], dc["v_scale"], kv_len,
            sm_scale=sm_scale)
    kc_tok, ks_tok = k_tok
    vc_tok, vs_tok = v_tok
    # self score through the same dequantize-free formula: (Hq).codes * scale
    s_self = torch.einsum("bkgd,bkd->bkg", q_rot,
                          kc_tok[..., 0, :].to(torch.float32))[..., None]
    s_self = s_self * (ks_tok[..., 0, :].to(torch.float32)[:, :, None]
                       * sm_scale)
    v_self = vc_tok.to(torch.float32) * vs_tok.to(torch.float32)  # rotated
    out = _merge_self_token(acc, m, l, s_self, v_self)
    # sum_t w_t (H v_t) = H (sum_t w_t v_t): one inverse FWHT per step
    return fwht_last(out, backend=backend)[..., None, :]


def prefill_attn_q8(q, cache, kv_len, q_offset, *, backend: str = "auto"):
    """Query-span attention against the rotated-int8 cache, whose rows
    already hold the span's codes at ``q_offset..q_offset+TQ-1``, so the
    causal mask merges the span's own block into the cache pass.

    q (B, KV, G, TQ, HD) unrotated; kv_len, q_offset (B,). Returns
    (B, KV, G, TQ, HD) with the rotation undone."""
    b, kv, g, tq, hd = q.shape
    sm_scale = 1.0 / math.sqrt(hd)
    kernel = _use_kernel(backend, q)
    q_rot = fwht_last(q.transpose(2, 3).to(torch.float32),
                      backend=backend)  # (B, KV, TQ, G, HD)
    if kernel:
        acc, _, l = _kernel_pass(q_rot.reshape(b * kv, tq, g, hd), cache,
                                 kv_len, q_offset, kv=kv, sm_scale=sm_scale,
                                 causal=True)
        acc = acc.reshape(b, kv, tq, g, hd).transpose(2, 3)
        l = l.reshape(b, kv, tq, g, 1).transpose(2, 3)
    else:
        dc = paged_to_dense(cache) if "table" in cache else cache
        acc, _, l = prefill_attn_q8_ref(
            q_rot.transpose(2, 3), dc["k"], dc["k_scale"], dc["v"],
            dc["v_scale"], kv_len, q_offset, sm_scale=sm_scale)
    # one inverse FWHT per query span, outside the kernel
    return fwht_last(acc / l, backend=backend)
