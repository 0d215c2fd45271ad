"""Logical-axis sharding rules over the ``(pod, data, model)`` mesh (port
of ``repro/sharding/rules.py``).

``make_rules`` resolves the logical names (batch, heads, kv_heads, ffn,
experts, vocab, embed, fsdp, ...) to mesh axes once per (config, mesh): a
logical dim is ``model``-sharded only when it divides the axis, so one
model runs on a mesh of any size. :func:`param_pspecs` walks a params
tree: :func:`_qtensor_leaf_spec` for the packed planes of a QTensor (N
over ``model``, the expert dim for MoE stacks; serving), :func:`_leaf_spec`
for a float leaf (FSDP over ``data``, tensor parallel over ``model``;
training). :func:`batch_pspec` splits a batch's rows over the batch axes.

A spec is the port's spelling of a ``PartitionSpec``: a tuple with one
entry per dimension, a mesh axis name, a tuple of them or ``None`` (``()``
for a leaf without a shape). It equals the reference's spec element for
element. The port has no SPMD partitioner: ``Rules.constrain`` returns the
spec the reference's ``with_sharding_constraint`` would apply, and
``train/sharded.py`` moves the data to match it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

from repro_torch.core.quantize import QTensor

__all__ = ["Rules", "make_rules", "param_pspecs", "batch_pspec"]

Spec = tuple


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: object  # launch/mesh.py Mesh (or anything with .shape)
    assignments: dict  # logical name -> mesh axis | tuple | None

    def axis_for(self, name: Optional[str]):
        if name is None:
            return None
        return self.assignments.get(name)

    def spec(self, names: tuple) -> Spec:
        return tuple(self.axis_for(n) for n in names)

    def constrain(self, shape: tuple, names: tuple, mesh=None) -> Spec:
        """The spec the reference's ``constrain`` applies to an array of
        ``shape`` under the logical ``names``: each dim takes its name's
        axis (or axis tuple) only when no earlier dim took one of those
        axes and the axes' product divides it; the rest, and dims past
        ``names``, are ``None``."""
        mesh = mesh or self.mesh
        axes: list = []
        used: set = set()
        for dim, n in enumerate(names):
            ax = self.axis_for(n)
            if ax is None:
                axes.append(None)
                continue
            ax_tuple = ax if isinstance(ax, tuple) else (ax,)
            if any(a in used for a in ax_tuple):
                axes.append(None)  # a mesh axis can shard only one dim
                continue
            size = 1
            for a in ax_tuple:
                size *= int(mesh.shape[a])
            if dim < len(shape) and shape[dim] % size == 0 and shape[dim] > 0:
                axes.append(ax)
                used.update(ax_tuple)
            else:
                axes.append(None)
        axes += [None] * (len(shape) - len(axes))
        return tuple(axes[:len(shape)])


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def make_rules(mesh, cfg, *, fsdp: bool = True) -> Rules:
    """Resolve logical axes for one (arch, mesh)."""
    axes = dict(mesh.shape)
    model = "model" if "model" in axes else None
    msize = axes.get("model", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes) or None
    if batch_axes and len(batch_axes) == 1:
        batch_axes = batch_axes[0]

    kv_ok = _div(cfg.num_kv_heads, msize)
    assignments = {
        "batch": batch_axes,
        "seq": None,  # SP applied selectively via "seq_sp"
        "seq_sp": model,
        "ffn": model if _div(cfg.d_ff, msize) else None,
        "heads": model if _div(cfg.num_heads * cfg.resolved_head_dim,
                               msize) else None,
        "kv_heads": model if kv_ok else None,
        # flash-decode fallback: shard the KV length when heads can't shard
        "kv_seq": None if kv_ok else model,
        "experts": model if _div(cfg.num_experts, msize) else None,
        "vocab": model if _div(cfg.vocab_size, msize) else None,
        "embed": model if _div(cfg.d_model, msize) else None,
        "fsdp": "data" if (fsdp and "data" in axes) else None,
    }
    return Rules(mesh=mesh, assignments=assignments)


# ---------------------------------------------------------------------------
# Parameter leaf specs (the param tree walked by path)
# ---------------------------------------------------------------------------

_COL = re.compile(r"(wq|wk|wv|wg|wr|gate|up|wz|wx|lm_head|frontend_proj|"
                  r"w_lora_a)$")
_ROW = re.compile(r"(wo|down|out_proj|cm_v|w_lora_b)$")
_REPL = re.compile(r"(scale|bias|mu|cm_mu|A_log|dt_bias|conv_\w+|router|"
                   r"w_base|u|D)$")


def _leaf_spec(path: str, shape: tuple, rules: Rules, msize: int, dsize: int,
               stacked: int) -> Spec:
    """Spec for one float parameter leaf under the training rules.
    ``stacked`` = number of leading stacked layer dims (never sharded)."""
    lead = [None] * stacked
    dims = shape[stacked:]
    model = "model" if rules.mesh.shape.get("model", 1) > 1 else None
    fsdp = rules.assignments.get("fsdp")

    def div(d, k):
        return k > 1 and d % k == 0

    name = path.split("/")[-1]
    if len(dims) == 0:
        return tuple(lead)

    if _REPL.search(name) and "embed" not in path:
        return tuple(lead + [None] * len(dims))

    if name == "embed":  # (V, D): fsdp on vocab rows, TP on embed dim
        return tuple(lead + [fsdp if div(dims[0], dsize) else None,
                             model if div(dims[1], msize) else None])

    if "moe" in path and name in ("gate", "up", "down"):
        # (E, K, N): experts over model (EP); fsdp the K dim
        e, k, _ = dims
        return tuple(lead + [model if div(e, msize) else None,
                             fsdp if div(k, dsize) else None, None])

    if _COL.search(name) and len(dims) == 2:
        k, n = dims
        return tuple(lead + [fsdp if div(k, dsize) else None,
                             model if div(n, msize) else None])
    if _ROW.search(name) and len(dims) == 2:
        k, n = dims
        return tuple(lead + [model if div(k, msize) else None,
                             fsdp if div(n, dsize) else None])
    # default: fsdp the largest divisible dim
    spec = [None] * len(dims)
    for i in sorted(range(len(dims)), key=lambda i: -dims[i]):
        if div(dims[i], dsize):
            spec[i] = fsdp
            break
    return tuple(lead + spec)


def _stack_depth(parts: Sequence[str]) -> int:
    """Leading stacked dims of the leaf at path ``parts``: 2 for a hybrid's
    macroblocks, 1 for the other layer stacks."""
    parts = [str(p) for p in parts]
    if "mamba_blocks" in parts:
        return 2
    for tag in ("layers", "encoder", "mamba_tail"):
        if tag in parts:
            return 1
    return 0


_QDATA = {"plane2", "plane1", "scales", "zps", "q", "w", "dsign"}


def _qtensor_leaf_spec(path: str, name: str, shape: tuple, rules: Rules,
                       msize: int, stacked: int) -> Spec:
    """Spec of one packed QTensor array (serving).

    plane2/plane1 are (..., N, KB, bytes); scales/zps (..., N, KB[, sub]).
    The output-feature dim N is the TP dim; the packed reduction stream is
    replicated, which keeps decode free of weight all-gathers. MoE expert
    stacks shard the expert dim instead (EP): the leaf is (L, E, N, ...)
    and ``stacked`` counts only the L dim, so E is the first dim after
    it."""
    if name == "dsign":
        return (None,) * len(shape)
    lead = [None] * stacked
    dims = list(shape[stacked:])
    model = "model" if msize > 1 else None
    spec = [None] * len(dims)
    if "moe" in path and stacked >= 1:
        if dims and model and shape[stacked] % msize == 0:
            spec[0] = model  # E over model (EP)
        return tuple(lead + spec)
    if model and dims and dims[0] % msize == 0:
        spec[0] = model  # N over model
    return tuple(lead + spec)


def param_pspecs(params, cfg, rules: Rules):
    """Spec tree matching ``params`` (nested dicts of tensors or
    QTensors; a QTensor maps to a QTensor of its arrays' specs), leaf for
    leaf the reference's: packed QTensor arrays by
    :func:`_qtensor_leaf_spec`, float leaves by :func:`_leaf_spec` (FSDP
    over ``data`` when the rules have it), ``()`` for a leaf without a
    shape."""
    msize = rules.mesh.shape.get("model", 1)
    dsize = rules.mesh.shape.get("data", 1)

    def spec_of(parts: tuple, leaf) -> Spec:
        if not hasattr(leaf, "shape"):
            return ()
        path = "/".join(parts)
        stacked = _stack_depth(parts)
        name = parts[-1]
        if "data" in parts and name in _QDATA:
            return _qtensor_leaf_spec(path, name, tuple(leaf.shape), rules,
                                      msize, stacked)
        return _leaf_spec(path, tuple(leaf.shape), rules, msize, dsize,
                          stacked)

    def walk(node, parts: tuple):
        if isinstance(node, QTensor):
            return QTensor({k: spec_of(parts + ("data", k), v)
                            for k, v in node.data.items()}, node.meta)
        if isinstance(node, dict):
            return {k: walk(v, parts + (str(k),)) for k, v in node.items()}
        return spec_of(parts, node)

    return walk(params, ())


def batch_pspec(rules: Rules) -> Spec:
    """A batch's rows over the batch axes (``data``, or ``("pod",
    "data")`` with pods)."""
    return (rules.assignments["batch"],)
