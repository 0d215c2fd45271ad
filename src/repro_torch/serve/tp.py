"""Tensor-parallel serving on ``torch.distributed`` (port of
``repro/serve/tp.py``): the placement specs of the packed ITQ3_S planes
and of the rotated-int8 KV cache, and the column- and head-sharded
launches of the card's kernels.

The serving layout is the reference's, **column-parallel everywhere**:

* Every packed QTensor array (``plane2``/``plane1``/``scales``/``zps``) is
  sharded along its output-feature dim N over the ``model`` axis
  (``sharding/rules.py:_qtensor_leaf_spec``); MoE expert stacks along the
  expert dim instead (``models/moe.py``'s expert-parallel combine). The
  FWHT runs along K, within a 256-block, so an N shard never splits a
  transform.
* The embedding table shards its D column (the gather is exact); every
  other float leaf is replicated.
* The rotated-int8 KV cache (codes and scale planes, or the fp cache)
  shards its kv_heads dim; GQA head counts that do not divide the axis
  keep a replicated cache. Recurrent state is replicated.

One process per rank, each holding only its slice of every sharded leaf:
:func:`shard_params` and :func:`shard_cache` slice a whole tree,
:func:`init_cache` allocates only the local slices, and restore-to-sharding
(:func:`restore_shardings` with ``checkpoint/ckpt.py``) reads only the
local rows of each plane off disk. A sharded QTensor keeps its whole
weight's ``QMeta``; its arrays hold this rank's rows.

Each rank runs the unchanged kernel on its shard, then one all-gather
brings the shards together (``all_gather_into_tensor`` under NCCL,
``all_gather`` and a concatenation under gloo). No collective is a float
reduction, so every rank holds the activations a single device computes,
bit for bit, provided each shard's columns equal the full launch's: a
shard launch takes the cut of the unsharded launch (``cut_from`` in
``core/qlinear.py``), since the contraction kernels pick their K split
from the output tiles' count. Every rank then samples the same tokens
from the same gathered logits.

The reference has two execution forms (GSPMD-partitioned jit, and
explicit ``shard_map`` of the kernels); PyTorch has no counterpart of
GSPMD, so the port's one form is the explicit one, and ``tp_shard_map``
is always True.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import formats as fmt_mod
from repro_torch.core.qlinear import qmatmul, resolve_mode
from repro_torch.core.quantize import QTensor
from repro_torch.kernels.attn_q8 import decode_attn_q8, prefill_attn_q8
from repro_torch.launch.mesh import Placement, all_gather
from repro_torch.sharding import rules as R

__all__ = [
    "serve_rules", "serve_param_pspecs", "param_shardings", "shard_params",
    "cache_pspecs", "shard_cache", "cache_bytes_per_device",
    "restore_shardings", "place_draft", "can_tp_qmatmul", "tp_qmatmul",
    "tp_decode_attn_q8", "tp_prefill_attn_q8", "shard_qmatmul",
    "init_cache", "all_gather", "Placement", "LockstepClock",
]


# ---------------------------------------------------------------------------
# Rules / specs
# ---------------------------------------------------------------------------

def serve_rules(mesh, cfg) -> R.Rules:
    """Serving variant of :func:`repro_torch.sharding.rules.make_rules`:
    no FSDP (serving weights are read-only) and no sequence-sharded KV
    (a serving softmax is never split across devices). When the KV heads
    do not divide the model axis the cache is replicated."""
    rules = R.make_rules(mesh, cfg, fsdp=False)
    assignments = dict(rules.assignments)
    assignments["kv_seq"] = None
    assignments["seq_sp"] = None
    return R.Rules(mesh=mesh, assignments=assignments)


def _msize(mesh) -> int:
    return int(mesh.shape.get("model", 1))


def _map(tree, fn, parts: tuple = ()):
    """``fn(parts, leaf)`` over a params or cache tree; a QTensor maps to
    a QTensor of ``fn`` over its arrays (path ``... / data / key``)."""
    if isinstance(tree, QTensor):
        return QTensor({k: fn(parts + ("data", k), v)
                        for k, v in tree.data.items()}, tree.meta)
    if isinstance(tree, dict):
        return {k: _map(v, fn, parts + (k,)) for k, v in tree.items()}
    return fn(parts, tree)


def _param_spec(parts: tuple, leaf, rules: R.Rules):
    msize = _msize(rules.mesh)
    if not hasattr(leaf, "shape"):
        return ()
    name = parts[-1]
    if "data" in parts and name in R._QDATA:
        return R._qtensor_leaf_spec("/".join(parts), name, tuple(leaf.shape),
                                    rules, msize, R._stack_depth(parts))
    if name == "embed" and len(leaf.shape) == 2:
        dshard = msize > 1 and leaf.shape[1] % msize == 0
        return (None, "model" if dshard else None)
    return (None,) * len(leaf.shape)


def serve_param_pspecs(params, cfg, rules: R.Rules):
    """Spec tree for a SERVING params tree (quantized or mixed), leaf for
    leaf the reference's: packed planes N over ``model`` (the expert dim
    for MoE stacks), the embedding table's D column over ``model``, every
    other float leaf replicated (serving refuses row-parallel float
    reductions)."""
    return _map(params, lambda parts, leaf: _param_spec(parts, leaf, rules))


def param_shardings(params, cfg, rules: R.Rules):
    """:class:`Placement` tree matching ``params`` leaf for leaf
    (including the arrays inside each QTensor)."""
    return _placements(serve_param_pspecs(params, cfg, rules), rules.mesh)


def _placements(specs, mesh):
    if isinstance(specs, QTensor):
        return QTensor({k: Placement(v, mesh) for k, v in specs.data.items()},
                       specs.meta)
    if isinstance(specs, dict):
        return {k: _placements(v, mesh) for k, v in specs.items()}
    return Placement(specs, mesh)


def _place_tree(tree, places):
    if isinstance(tree, QTensor):
        return QTensor({k: places.data[k](v) for k, v in tree.data.items()},
                       tree.meta)
    if isinstance(tree, dict):
        return {k: _place_tree(v, places[k]) for k, v in tree.items()}
    return places(tree)


def shard_params(params, cfg, rules: R.Rules):
    """This rank's slice of every leaf of a whole params tree, on
    ``rules.mesh.device``."""
    return _place_tree(params, param_shardings(params, cfg, rules))


def cache_pspecs(cache, cfg, rules: R.Rules):
    """Specs for a serving cache tree (``lm.init_cache`` layout, or the
    paged pool). Attention K/V planes, codes and their fp16 scale planes or
    the fp cache, are (L, B|NB, KV, T|BS, HD|1): kv_heads over ``model``
    when they divide, else replicated (the GQA fallback). Recurrent states
    stay replicated."""
    msize = _msize(rules.mesh)
    kv_ax = rules.assignments.get("kv_heads")

    def spec_of(parts, leaf):
        if not hasattr(leaf, "shape"):
            return ()
        if parts and parts[0] in ("attn", "xattn") and len(leaf.shape) == 5:
            ax = kv_ax if (kv_ax and leaf.shape[2] % msize == 0) else None
            return (None, None, ax, None, None)
        return (None,) * len(leaf.shape)

    return _map(cache, spec_of)


def shard_cache(cache, cfg, rules: R.Rules):
    """This rank's slice of every leaf of a whole cache tree."""
    return _place_tree(cache, _placements(cache_pspecs(cache, cfg, rules),
                                          rules.mesh))


def init_cache(cache_meta, cfg, rules: R.Rules):
    """A zeroed cache already in the serving layout: ``cache_meta`` is the
    whole cache built on the ``meta`` device (``lm.init_cache(...,
    device="meta")`` or ``paged.init_paged_cache``), and only this rank's
    slice of each leaf is allocated, on ``rules.mesh.device``."""
    mesh = rules.mesh

    def local(spec, leaf):
        shape = [n // _msize(mesh) if ax else n
                 for n, ax in zip(leaf.shape, spec)]
        return torch.zeros(shape, dtype=leaf.dtype, device=mesh.device)

    def walk(tree, specs):
        if isinstance(tree, dict):
            return {k: walk(v, specs[k]) for k, v in tree.items()}
        return local(specs, tree)

    return walk(cache_meta, cache_pspecs(cache_meta, cfg, rules))


def cache_bytes_per_device(cache) -> int:
    """Bytes this rank holds for ``cache``: head-sharded planes count
    their local heads, replicated leaves count whole."""
    total = 0

    def add(_, leaf):
        nonlocal total
        total += leaf.numel() * leaf.element_size()
        return leaf

    _map(cache, add)
    return total


def restore_shardings(cfg, mesh) -> Callable[[str, Any], Any]:
    """Restore-to-sharding callback for :func:`repro_torch.checkpoint.ckpt.
    restore_tree`: maps each leaf as it loads (by dotted path) to its
    serving :class:`Placement`, so each rank reads only its rows of each
    packed plane. A QTensor leaf gets a dict of placements keyed like its
    ``data``; a leaf that is not an array gets None. The ``params.``
    prefix of TrainState checkpoints is stripped."""
    rules = serve_rules(mesh, cfg)
    msize = _msize(mesh)

    def place(dotted: str, leaf):
        parts = dotted.split(".")
        if parts and parts[0] == "params":  # TrainState checkpoints
            parts = parts[1:]
        path = "/".join(parts)
        stacked = R._stack_depth(parts)
        if isinstance(leaf, QTensor):
            return {k: Placement(R._qtensor_leaf_spec(
                        path, k, tuple(v.shape), rules, msize, stacked), mesh)
                    for k, v in leaf.data.items()}
        if not hasattr(leaf, "shape"):
            return None
        if parts[-1] == "embed" and len(leaf.shape) == 2:
            dshard = msize > 1 and leaf.shape[1] % msize == 0
            return Placement((None, "model" if dshard else None), mesh)
        return Placement((None,) * len(leaf.shape), mesh)

    return place


def place_draft(draft_params, draft_cfg, mesh, draft_rt, *,
                placed: bool = False):
    """Place a speculative DRAFT model in the serving layout under its
    own rules (its head and column splits follow the draft's shape) and
    thread them into the draft Runtime. ``placed``: the params already
    hold this rank's slices (a layer prefix of a placed target). Returns
    ``(params, draft_rt)``."""
    rules = serve_rules(mesh, draft_cfg)
    draft_rt = dataclasses.replace(draft_rt, rules=rules)
    if not placed:
        draft_params = shard_params(draft_params, draft_cfg, rules)
    return draft_params, draft_rt


# ---------------------------------------------------------------------------
# The clock on a mesh (the exact gathers are launch/mesh.py's all_gather)
# ---------------------------------------------------------------------------

class LockstepClock:
    """The engine's clock on a mesh: rank 0 reads the wrapped clock and
    broadcasts it, so every rank decides deadlines, the watchdog, queue
    shedding and faults on the same time. Inside a tick
    (:meth:`begin_tick` .. :meth:`end_tick`) every read returns the tick's
    one broadcast time; a read outside a tick (a submit between ticks)
    broadcasts one of its own."""

    def __init__(self, clock, mesh):
        self.clock = clock
        self.mesh = mesh
        self.now: Optional[float] = None

    def _shared(self) -> float:
        if self.mesh.size == 1:
            return self.clock()
        t = torch.tensor([self.clock() if self.mesh.rank == 0 else 0.0],
                         dtype=torch.float64, device=self.mesh.device)
        dist.broadcast(t, src=0, group=self.mesh.group)
        return float(t.item())

    def begin_tick(self) -> None:
        self.now = self._shared()

    def end_tick(self) -> None:
        self.now = None

    def __call__(self) -> float:
        return self.now if self.now is not None else self._shared()


# ---------------------------------------------------------------------------
# The kernels on column and head shards
# ---------------------------------------------------------------------------

def can_tp_qmatmul(qt: QTensor, mesh) -> bool:
    """Column-parallel eligibility of a whole QTensor: 2-D weight, N
    divides the model axis, and so does every N-carrying array's leading
    dim (``dsign`` is replicated)."""
    msize = _msize(mesh)
    if msize <= 1 or len(qt.meta.shape) != 2 or qt.meta.n % msize:
        return False
    return all(v.shape[0] % msize == 0
               for k, v in qt.data.items() if k != "dsign")


def _local_rows(qt: QTensor) -> int:
    return next(v for k, v in qt.data.items() if k != "dsign").shape[0]


def _gather_qtensor(qt: QTensor, mesh) -> QTensor:
    """The whole QTensor from every rank's rows (a placed leaf whose
    format keeps N off its leading dim, such as fp16's ``w`` (K, N))."""
    return QTensor({k: v if k == "dsign" else all_gather(v, 0, mesh)
                    for k, v in qt.data.items()}, qt.meta)


def tp_qmatmul(x: torch.Tensor, qt: QTensor, rules: R.Rules, *, mode: str,
               backend: str, act_quant: bool = False) -> torch.Tensor:
    """Column-parallel ``x @ W_hat``: x whole on every rank, this rank's
    N/m columns (:func:`shard_qmatmul`), then one all-gather along N. A
    leaf that was not sharded takes the plain call. ``act_quant``
    composes freely: the activation codec depends only on x, so every
    rank quantizes identically."""
    mesh = rules.mesh
    m = qt.meta
    if _msize(mesh) <= 1 or len(m.shape) != 2 or _local_rows(qt) == m.n:
        return qmatmul(x, qt, mode=mode, backend=backend,
                       act_quant=act_quant)
    if "w" in qt.data:  # a float format stores (K, N): its split is on K
        return qmatmul(x, _gather_qtensor(qt, mesh), mode=mode,
                       backend=backend, act_quant=act_quant)
    return all_gather(shard_qmatmul(x, qt, mode=mode, backend=backend,
                                    act_quant=act_quant), -1, mesh)


def shard_qmatmul(x: torch.Tensor, qt: QTensor, *, mode: str, backend: str,
                  act_quant: bool = False) -> torch.Tensor:
    """One rank's columns of a column-parallel ``x @ W_hat``: ``qt`` is a
    placed QTensor (the whole weight's meta, this rank's rows of its
    planes). ``mode="auto"`` resolves on the whole weight, and the launch
    takes the whole weight's cut (``cut_from``), so the columns equal the
    single-device launch's bit for bit."""
    m = qt.meta
    local = _local_rows(qt)
    if fmt_mod.get_format(m.fmt).supports_fused:
        mode = resolve_mode(x, m, mode)
    local_qt = QTensor(qt.data, dataclasses.replace(m, shape=(m.k, local)))
    return qmatmul(x, local_qt, mode=mode, backend=backend,
                   act_quant=act_quant, cut_from=(1, m.n))


def _can_tp_heads(kv_heads: int, mesh) -> bool:
    msize = _msize(mesh)
    return msize > 1 and kv_heads % msize == 0


def head_slice(kv_heads: int, rules: Optional[R.Rules]) -> Optional[slice]:
    """This rank's KV heads when the cache is head-sharded, else None."""
    if rules is None or not _can_tp_heads(kv_heads, rules.mesh):
        return None
    n = kv_heads // _msize(rules.mesh)
    r = rules.mesh.rank
    return slice(r * n, (r + 1) * n)


def gather_heads(out: torch.Tensor, rules: R.Rules) -> torch.Tensor:
    """Every rank's heads of ``out`` (B, KV/m, ...) -> (B, KV, ...)."""
    return all_gather(out, 1, rules.mesh)


def tp_decode_attn_q8(q, cache, k_tok, v_tok, kv_len, rules: R.Rules, *,
                      backend: str = "auto") -> torch.Tensor:
    """Head-sharded decode attention: ``q`` (B, KV, G, 1, HD) whole; the
    cache planes (dense (B, KV/m, T, X) or the paged pool (NB, KV/m, BS,
    X) with its replicated ``table``) and the token's encoded K/V are this
    rank's heads. The kernel runs over the local heads (the per-head
    online softmax never crosses a device), then one all-gather along
    the head axis. GQA counts that do not divide take the plain call on
    the replicated cache."""
    heads = head_slice(q.shape[1], rules)
    if heads is None:
        return decode_attn_q8(q, cache, k_tok, v_tok, kv_len,
                              backend=backend)
    out = decode_attn_q8(q[:, heads].contiguous(), cache, k_tok, v_tok,
                         kv_len, backend=backend)
    return gather_heads(out, rules)


def tp_prefill_attn_q8(q, cache, kv_len, q_offset, rules: R.Rules, *,
                       backend: str = "auto") -> torch.Tensor:
    """Head-sharded prefill counterpart (``q`` (B, KV, G, TQ, HD))."""
    heads = head_slice(q.shape[1], rules)
    if heads is None:
        return prefill_attn_q8(q, cache, kv_len, q_offset, backend=backend)
    out = prefill_attn_q8(q[:, heads].contiguous(), cache, kv_len, q_offset,
                          backend=backend)
    return gather_heads(out, rules)


# ---------------------------------------------------------------------------
# The embedding table (D-sharded)
# ---------------------------------------------------------------------------

def full_table(table, cfg, rules: Optional[R.Rules]):
    """The whole embedding table from a placed one: a float table's D
    columns, a quantized table's (D, V) planes' V rows, gathered. Returns
    ``table`` when it was not sharded."""
    if rules is None or _msize(rules.mesh) <= 1:
        return table
    if isinstance(table, QTensor):
        if _local_rows(table) == table.meta.n:
            return table
        return _gather_qtensor(table, rules.mesh)
    if table.shape[1] == cfg.d_model:
        return table
    return all_gather(table, 1, rules.mesh)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor, cfg,
               rules: Optional[R.Rules]) -> torch.Tensor:
    """``table[tokens]`` of a float table: the local D columns gathered
    per token, then one all-gather along D (exact)."""
    rows = table.to(torch.float32)[tokens]
    if rules is None or table.shape[1] == cfg.d_model:
        return rows
    return all_gather(rows, -1, rules.mesh)
