"""Counts of the work a step dispatches: the port's counterpart of
``repro/launch/hlo_analysis.py`` (``analyze_hlo``, ``HloStats``,
``_op_bytes``, ``top_ops``). The port has no HLO to read, so it counts the
aten ops that PyTorch dispatches while the step runs, under a
``TorchDispatchMode`` (:func:`count_ops`), with the reference's rules:

  * matmul FLOPs: ``2 * prod(result) * contraction`` for every ``mm``,
    ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv`` and ``dot``, which
    is what ``einsum``, ``matmul`` and ``linear`` decompose into before
    they reach the dispatcher, backward products included; each adds one
    to ``dot_count``;
  * collective bytes by the reference's kinds (all-gather, all-reduce,
    reduce-scatter, all-to-all, collective-permute): the operand bytes of
    each ``c10d`` op that the step's process group dispatches;
  * a coarse bytes-accessed estimate, operands plus results, through the
    aliasing model of :func:`_op_bytes`: a write into a slice (``copy_``
    into a view, ``index_put``, ``slice_scatter``, ``select_scatter``) is
    a ``dynamic-update-slice``, a read of one (``slice``, ``select``,
    ``index``, ``index_select``) a ``dynamic-slice``, ``scatter``,
    ``scatter_add`` and ``index_add`` a ``scatter``; layout and dtype ops
    (views, reshapes, permutes, expands, ``_to_copy``, ``clone``, fills,
    pads) are skipped, as ``_SKIP_BYTES`` skips their HLO forms.

An eager step dispatches every layer's ops in turn, so there are no loop
trip counts to recover: ``dynamic_whiles`` is always 0. Run on fake
tensors (``models/lm.py:shape_params``) and a fake process group, the
count costs no device memory at any width (``launch/dryrun.py``); on real
tensors it counts the same ops while they run.

A hand-written kernel launched through ``ctypes`` never reaches the
dispatcher, so its work would go uncounted: a ``csrc/`` launch inside the
counter raises (``kernels/_build.py``'s launch counter).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _build

__all__ = ["OpStats", "count_ops", "top_ops", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op -> (the reference's kind, the argument holding the operand, the
# argument holding the result); an all-reduce writes its operand in place
_C10D = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "allgather_": ("all-gather", 1, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "send": ("collective-permute", 0, 0),
    "recv_": ("collective-permute", 0, 0),
    "broadcast_": ("broadcast", 0, 0),
}

# matmul op -> the argument whose last dim is the contraction
_DOTS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1,
         "addmv": 1}

_DUS = {"index_put", "index_put_", "slice_scatter", "select_scatter",
        "_unsafe_index_put"}
_DYNAMIC_SLICE = {"slice", "select", "index", "index_select"}
_SCATTER = {"scatter", "scatter_", "scatter_add", "scatter_add_",
            "index_add", "index_add_", "scatter_reduce", "scatter_reduce_"}
_SKIP_BYTES = {
    # layout: views and reshapes (the HLO's bitcast, reshape, transpose)
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
    "transpose", "transpose_", "t", "expand", "expand_as", "squeeze",
    "squeeze_", "unsqueeze", "unsqueeze_", "as_strided", "alias",
    "detach", "detach_", "lift_fresh", "lift_fresh_copy", "unbind",
    "split", "split_with_sizes", "chunk", "movedim", "narrow",
    "_unsafe_view_copy", "view_as_real", "view_as_complex", "unfold",
    # dtype and copies (convert, copy)
    "_to_copy", "to", "clone", "contiguous", "copy", "_copy_from",
    "_copy_from_and_resize",
    # constants, iotas and broadcasts of a value
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "new_zeros", "new_ones", "new_full", "arange",
    "fill_", "zero_", "scalar_tensor", "_local_scalar_dense",
    # pad, reverse
    "constant_pad_nd", "flip",
}


def _op_bytes(op: str, operand_bytes: list[float], result_bytes: float) -> float:
    """The reference's aliasing-aware per-op traffic model, by HLO kind.

    A dynamic-update-slice or scatter writes in place: the update slice
    is read and written, not the whole buffer (a scatter also reads its
    indices). A dynamic-slice reads only the slice it produces.
    Everything else: operands plus result (an unfused upper bound)."""
    if op == "dynamic-update-slice":
        upd = operand_bytes[1] if len(operand_bytes) > 1 else 0.0
        return 2.0 * upd
    if op == "scatter":
        upd = operand_bytes[-1] if operand_bytes else 0.0
        return 2.0 * upd + (operand_bytes[1] if len(operand_bytes) > 2 else 0.0)
    if op in ("dynamic-slice", "slice"):
        return 2.0 * result_bytes
    return sum(operand_bytes) + result_bytes


@dataclasses.dataclass
class OpStats:
    """``HloStats``'s fields, counted from dispatched ops; ``by_tag`` holds
    (bytes, count) per :func:`top_ops` tag."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    dot_count: float = 0.0
    dynamic_whiles: int = 0
    by_tag: dict = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def scaled(self, k: float) -> "OpStats":
        return OpStats(
            flops=self.flops * k,
            bytes_accessed=self.bytes_accessed * k,
            collective_bytes={kk: v * k for kk, v in
                              self.collective_bytes.items()},
            collective_counts={kk: v * k for kk, v in
                               self.collective_counts.items()},
            dot_count=self.dot_count * k,
            dynamic_whiles=self.dynamic_whiles,
            by_tag={t: [b * k, n * k] for t, (b, n) in self.by_tag.items()})

    def add(self, other: "OpStats"):
        self.flops += other.flops
        self.bytes_accessed += other.bytes_accessed
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + v
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0.0) + v
        self.dot_count += other.dot_count
        self.dynamic_whiles += other.dynamic_whiles
        for t, (b, n) in other.by_tag.items():
            cur = self.by_tag.setdefault(t, [0.0, 0.0])
            cur[0] += b
            cur[1] += n


def _tensors(x) -> list:
    """The tensors in an argument (a tensor, or a list or tuple of them,
    nested as c10d's gathers take them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _kind(name: str, args) -> str:
    """The HLO kind that :func:`_op_bytes` charges an aten op as."""
    if name in _DUS:
        return "dynamic-update-slice"
    if name == "copy_" and args and args[0]._is_view():
        return "dynamic-update-slice"
    if name in _DYNAMIC_SLICE:
        return "dynamic-slice"
    if name in _SCATTER:
        return "scatter"
    return name


def _operands(name: str, args) -> list[float]:
    """Operand bytes in the order :func:`_op_bytes` reads them: a write
    into a slice as (buffer, update), a scatter as (buffer, index,
    updates)."""
    if name in ("index_put", "index_put_", "_unsafe_index_put"):
        return [_nbytes(args[0]), _nbytes(args[2])]
    return [_nbytes(a) for a in args if _tensors(a)]


def _caller() -> str:
    """The innermost ``repro_torch`` function on the Python stack (this
    module's frames aside): the tag's counterpart of the HLO's
    ``op_name``."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if "repro_torch" in path and not path.endswith("op_analysis.py"):
            mod = path.rsplit("repro_torch", 1)[1].strip("/\\")
            return f"{mod.removesuffix('.py')}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Counter(TorchDispatchMode):
    def __init__(self, stats: OpStats, tags: bool):
        super().__init__()
        self.stats = stats
        self.tags = tags
        self.launches = sum(_build.launches.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if sum(_build.launches.values()) != self.launches:
            raise RuntimeError(
                "a csrc/ kernel launched inside count_ops: its work never "
                "reaches the dispatcher and would go uncounted")
        st = self.stats
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "c10d":
            if name not in _C10D:
                return out
            kind, src, dst = _C10D[name]
            nbytes = _nbytes(args[src])
            st.collective_bytes[kind] = st.collective_bytes.get(kind, 0.0) + \
                nbytes
            st.collective_counts[kind] = st.collective_counts.get(kind, 0.0) \
                + 1
            st.bytes_accessed += nbytes + (_nbytes(args[dst]) if dst != src
                                           else nbytes)
            return out
        if ns != "aten" or name in _SKIP_BYTES:
            return out
        result = _nbytes(out)
        if name in _DOTS:
            lhs = args[_DOTS[name]]
            n = 1
            for d in _tensors(out)[0].shape:
                n *= int(d)
            st.flops += 2.0 * n * max(int(lhs.shape[-1]), 1)
            st.dot_count += 1
            nbytes = sum(_operands(name, args)) + result
        else:
            kind = _kind(name, args)
            if kind == "copy_":  # a copy into a whole buffer: a "copy"
                return out
            nbytes = _op_bytes(kind, _operands(name, args), result)
        st.bytes_accessed += nbytes
        if self.tags:
            cur = st.by_tag.setdefault(f"{name} @ {_caller()}", [0.0, 0.0])
            cur[0] += nbytes
            cur[1] += 1
        return out


@contextlib.contextmanager
def count_ops(*, tags: bool = True):
    """Count every op dispatched inside the block into the
    :class:`OpStats` it yields (``tags``: also per :func:`top_ops` tag).
    Raises if a ``csrc/`` kernel launches inside it."""
    stats = OpStats()
    counter = _Counter(stats, tags)
    with counter:
        yield stats
    if sum(_build.launches.values()) != counter.launches:
        raise RuntimeError("a csrc/ kernel launched inside count_ops")


def top_ops(stats: OpStats, k: int = 25) -> list[tuple[str, float, float]]:
    """The ``k`` tags that moved the most bytes: (aten op @ innermost
    ``repro_torch`` function, bytes, count), the dry-run's profile of
    where a step's traffic goes."""
    ranked = sorted(((t, b, n) for t, (b, n) in stats.by_tag.items()),
                    key=lambda x: -x[1])
    return ranked[:k]
