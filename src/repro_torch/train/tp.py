"""The ``model`` axis's compute split in training: the port's explicit form
of what the reference's SPMD partitioner derives from ``param_pspecs`` on
the ``model`` axis (column-parallel wq, wk, wv, gate, up, lm_head; row-
parallel wo, down; heads by ``kv_heads``, else the key sequence split
over the axis (``kv_seq``); the vocab-sharded head and its logsumexp;
experts over ``model``).

Four autograd collectives over this rank's model group carry it. Every
rank of a model group computes the same loss, and a tensor whose
gradient every rank must hold whole is *replicated*:

* :func:`enter`: a replicated tensor entering split compute. Forward
  identity, backward the all-reduce sum of the ranks' shares;
* :func:`leave`: the partial sums of a row-parallel product. Forward the
  all-reduce sum, in f32 at least whatever the product's dtype; backward
  identity;
* :func:`gather_replicated`: a split tensor made whole for compute that
  every rank repeats. Forward all-gather; backward this rank's block of
  the (already whole, already equal) gradient. ``torch.distributed.nn``'s
  gather sums its backward over the ranks instead, which behind
  replicated compute counts the group's loss once per rank;
* :func:`gather_split`: a split tensor made whole for compute of which
  each rank does a part. Forward all-gather; backward reduce-scatter sum.

:func:`swap` moves a tensor split along one dim into one split along
another (an all-to-all; backward the all-to-all back). The tied head, the
step's one consumer of a gather feeding split compute, takes its
vocabulary rows of the table (stored split along D) this way: it moves
1/m of the table where :func:`gather_split` would make all of it whole on
every rank to keep 1/m.

:func:`max_over` (no gradient) is the all-reduce max of a detached shift:
the logsumexp's and the key-split attention's, whose gradient cancels.
Each works on NCCL, gloo and the dry-run's fake group.

:class:`ModelSplit` is one rank's plan, read from the state's specs
(:func:`plan`): which leaves hold their model slice, and which attention
case the architecture takes. The dense and MoE families split; ``vlm``,
``audio``, ``ssm`` and ``hybrid`` keep the storage form on a mesh
(:data:`SPLIT_FAMILIES`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import TENSOR_COLLECTIVES, all_gather, axis_index

__all__ = ["SPLIT_FAMILIES", "ModelSplit", "plan", "enter", "leave",
           "gather_replicated", "gather_split", "swap", "max_over",
           "all_reduce", "reduce_scatter"]

#: The families whose train step splits its compute over ``model``.
SPLIT_FAMILIES = ("dense", "moe")


def all_reduce(t: torch.Tensor, mesh, axis, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``op`` of ``t`` over the ranks along ``axis`` (a new tensor)."""
    group = mesh.group_of(axis)
    if group is None:
        return t
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter(t: torch.Tensor, dim: int, mesh, axis) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over the ranks
    along ``axis`` (NCCL's reduce-scatter, and the dry-run's fake group's;
    gloo sums the whole tensor and keeps the block)."""
    coord, ways = axis_index(mesh, axis)
    if ways == 1:
        return t
    dim = dim % t.dim()
    n = t.shape[dim] // ways
    if mesh.backend in TENSOR_COLLECTIVES:
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((n,) + moved.shape[1:], dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, moved, group=mesh.group_of(axis))
        return out.movedim(0, dim).contiguous()
    return all_reduce(t, mesh, axis).narrow(dim, coord * n, n).contiguous()


def _sum_f32(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the model group, taken in f32 at least."""
    return all_reduce(t.to(torch.promote_types(t.dtype, torch.float32)),
                      mesh, "model")


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.mesh).to(grad.dtype), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.dtype = t.dtype
        return _sum_f32(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.mesh, ctx.n = dim, mesh, t.shape[dim]
        return all_gather(t, dim, mesh, axis="model")

    @staticmethod
    def backward(ctx, grad):
        coord = axis_index(ctx.mesh, "model")[0]
        return grad.narrow(ctx.dim, coord * ctx.n, ctx.n), None, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather(t, dim, mesh, axis="model")

    @staticmethod
    def backward(ctx, grad):
        out = reduce_scatter(grad.to(torch.promote_types(
            grad.dtype, torch.float32)), ctx.dim, ctx.mesh, "model")
        return out.to(grad.dtype), None, None


def _all_to_all(t: torch.Tensor, split_dim: int, cat_dim: int, mesh
                ) -> torch.Tensor:
    """Block ``s`` of ``t`` along ``split_dim`` sent to model rank ``s``;
    the blocks received from the ranks concatenated along ``cat_dim`` in
    coordinate order."""
    ways = axis_index(mesh, "model")[1]
    moved = t.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(moved)
    dist.all_to_all_single(out, moved, group=mesh.group_of("model"))
    return torch.cat([b.movedim(0, split_dim)
                      for b in out.chunk(ways, dim=0)], dim=cat_dim)


class _Swap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split_dim, cat_dim, mesh):
        ctx.dims, ctx.mesh = (split_dim, cat_dim), mesh
        return _all_to_all(t, split_dim, cat_dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        split_dim, cat_dim = ctx.dims
        return (_all_to_all(grad, cat_dim, split_dim, ctx.mesh), None,
                None, None)


def enter(t: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated tensor into split compute (forward identity, backward
    the model group's sum)."""
    return _Enter.apply(t, mesh)


def leave(t: torch.Tensor, mesh) -> torch.Tensor:
    """The f32 sum over the model group of a row-parallel product's
    partials (backward identity)."""
    return _Leave.apply(t, mesh)


def gather_replicated(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The model group's blocks of ``t`` along ``dim`` made whole, for
    compute every rank repeats (backward: this rank's block)."""
    return _GatherReplicated.apply(t, dim % t.dim(), mesh)


def gather_split(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The model group's blocks of ``t`` along ``dim`` made whole, for
    compute each rank does a part of (backward: reduce-scatter sum)."""
    return _GatherSplit.apply(t, dim % t.dim(), mesh)


def swap(t: torch.Tensor, split_dim: int, cat_dim: int, mesh
         ) -> torch.Tensor:
    """``t``, split along ``cat_dim`` over the model group, re-split along
    ``split_dim``: this rank's block of ``split_dim``, whole along
    ``cat_dim`` (an all-to-all; backward the all-to-all back)."""
    if axis_index(mesh, "model")[1] == 1:
        return t
    return _Swap.apply(t, split_dim % t.dim(), cat_dim % t.dim(), mesh)


def max_over(t: torch.Tensor, mesh) -> torch.Tensor:
    """The model group's elementwise max of a detached ``t``."""
    return all_reduce(t.detach(), mesh, "model", op=dist.ReduceOp.MAX)


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """One rank's plan of the model axis's split (``Runtime.model_split``,
    set by the train step only): ``leaves`` names the layer and top-level
    leaves stored as their model slice (``"attn.wq"``, ``"mlp.down"``,
    ``"moe.up"``, ``"embed"``, ``"lm_head"``); ``heads`` is True where
    the KV heads divide the axis (each rank attends its ``kv_heads / m``
    groups), else the attention splits the key sequence where T divides
    the axis (``kv_seq``) and runs replicated where it does not;
    ``vocab`` is True where the head's vocabulary divides the axis."""

    mesh: Any
    ways: int
    coord: int
    leaves: frozenset
    heads: bool
    vocab: bool

    def has(self, name: str) -> bool:
        return name in self.leaves

    @property
    def attention(self) -> str:
        """The attention case: ``heads`` or ``kv_seq``."""
        return "heads" if self.heads else "kv_seq"

    def block(self, n: int) -> tuple[int, int]:
        """(first index, count) of this rank's block of ``n``."""
        per = n // self.ways
        return self.coord * per, per

    def enter(self, t):
        return enter(t, self.mesh)

    def leave(self, t):
        return leave(t, self.mesh)

    def max(self, t):
        return max_over(t, self.mesh)

    def gather(self, t, dim: int):
        return gather_replicated(t, dim, self.mesh)

    def swap(self, t, split_dim: int, cat_dim: int):
        return swap(t, split_dim, cat_dim, self.mesh)

    def whole(self, w, name: str, dim: int):
        """Leaf ``name`` whole for replicated compute: gathered along
        ``dim`` where it holds its model slice."""
        return self.gather(w, dim) if self.has(name) else w

    def whole_cat(self, ws, names, dim: int):
        """Leaves ``names`` whole along ``dim`` and concatenated along it,
        those holding their model slice gathered in one collective."""
        dim = dim % ws[0].dim()
        held = [self.has(n) for n in names]
        parts = [w for w, h in zip(ws, held) if h]
        if not parts:
            return torch.cat(ws, dim)
        sizes = [w.shape[dim] for w in parts]
        # rank r's block is [part 0's slice r | part 1's slice r | ...]
        g = self.gather(torch.cat(parts, dim), dim).unflatten(
            dim, (self.ways, sum(sizes)))
        whole = iter(t.flatten(dim, dim + 1) for t in g.split(sizes, dim + 1))
        return torch.cat([next(whole) if h else w
                          for w, h in zip(ws, held)], dim)

    def own(self, t, dim: int):
        """This rank's block along ``dim`` of a replicated tensor, entered
        into split compute."""
        lo, n = self.block(t.shape[dim])
        return self.enter(t).narrow(dim, lo, n)


def plan(cfg, mesh, pspecs) -> Optional[ModelSplit]:
    """The split of ``cfg``'s step on ``mesh`` from its param specs
    (``sharding/rules.py:param_pspecs``), or None: a model axis of one
    rank, or a family that keeps the storage form."""
    if mesh is None or cfg.family not in SPLIT_FAMILIES:
        return None
    coord, ways = axis_index(mesh, "model")
    if ways == 1:
        return None
    leaves = set()
    layers = pspecs["layers"]
    for block, names in layers.items():
        if not isinstance(names, dict):
            continue
        for name, spec in names.items():
            if "model" in spec:
                leaves.add(f"{block}.{name}")
    for name in ("embed", "lm_head"):
        if name in pspecs and "model" in pspecs[name]:
            leaves.add(name)
    heads = cfg.num_kv_heads % ways == 0
    if heads and not {"attn.wq", "attn.wk", "attn.wv",
                      "attn.wo"} <= leaves:
        raise ValueError("the KV heads divide the model axis but the "
                         "attention's projections are not all split")
    vocab = ("lm_head" in leaves if not cfg.tie_embeddings
             else cfg.vocab_size % ways == 0)
    return ModelSplit(mesh=mesh, ways=ways, coord=coord,
                      leaves=frozenset(leaves), heads=heads, vocab=vocab)
