"""Logical-axis sharding rules over the ``(data, model)`` serving mesh
(port of the serving subset of ``repro/sharding/rules.py``).

``make_rules`` resolves the logical names (heads, kv_heads, ffn, experts,
vocab, embed, ...) to mesh axes once per (config, mesh): a logical dim is
``model``-sharded only when it divides the axis, so one model serves on a
mesh of any size. The leaf-spec functions give one parameter leaf's
placement: :func:`_qtensor_leaf_spec` for the packed planes of a QTensor
(N over ``model``, the expert dim for MoE stacks), :func:`_leaf_spec` for
a float leaf under the training rules.

A spec is the port's spelling of a ``PartitionSpec``: a tuple with one
entry per dimension, a mesh axis name or ``None`` (``()`` for a leaf
without a shape). It equals the reference's spec element for element.
The FSDP and training specs (``param_pspecs`` with ``fsdp=True``,
``batch_pspec``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

__all__ = ["Rules", "make_rules"]

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
