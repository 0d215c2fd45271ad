"""Training on a mesh of ranks: the port's explicit form of what the
reference gets from ``jax.jit(step, in_shardings=..., out_shardings=...)``
over a sharded train state (``repro/launch/train.py:build_trainer``).

The state is stored as each rank's slices under the reference's specs
(``sharding/rules.py:param_pspecs``, FSDP over ``data``, the ``model``
axis where a dim divides it), the moments as the params, the two step
counters whole. One step on a rank:

1. :func:`split_batch`: this rank's rows of the global batch, which every
   rank draws whole (``batch_pspec``: rows over the batch axes);
2. :func:`gather_params`: every leaf made whole (all-gathers along the
   axes its spec names);
3. the loss and its gradients on the local rows (``train/grad.py``);
4. :func:`reduce_grads`: the mean over the batch ranks, reduce-scattered
   onto each leaf's ``data`` dim (all-reduced where it has none), this
   rank's slice of any ``model`` dim;
5. :func:`global_sq_norm`: the squared norm of the whole gradient, each
   element counted once;
6. AdamW on the local slices (elementwise, so a slice's update is the
   whole leaf's update restricted to it).

The ``model`` axis is a storage layout here: the model ranks of one data
group compute the same rows with the same gathered params. The MoE aux
loss takes its token means over the global batch (:func:`batch_mean`,
``models/moe.py``). Gradient reductions are float sums in another order
than one process's, so a mesh step is not bitwise with one device.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import BATCH_AXES, Placement, axis_index
from repro_torch.sharding.rules import Rules, batch_pspec
from repro_torch.train.tree import tree_leaves, tree_map

__all__ = ["map_state", "placements", "shard_state", "gather_params",
           "split_batch", "reduce_grads", "global_sq_norm", "world_mean",
           "batch_mean", "batch_axis", "batch_runtime"]


def map_state(fn, state, *rest):
    """``fn`` over every leaf of a ``TrainState`` (params, both moments,
    the two step counters) and the matching leaves of ``rest``."""
    def tree(get):
        return tree_map(fn, get(state), *(get(r) for r in rest))
    opt = dataclasses.replace(
        state.opt, mu=tree(lambda s: s.opt.mu), nu=tree(lambda s: s.opt.nu),
        step=fn(state.opt.step, *(r.opt.step for r in rest)))
    return dataclasses.replace(state, params=tree(lambda s: s.params),
                               opt=opt,
                               step=fn(state.step, *(r.step for r in rest)))


def placements(specs, mesh):
    """The :class:`Placement` of every leaf of a ``TrainState`` of specs:
    what ``checkpoint/ckpt.py`` gathers a save by and places a restore
    by."""
    return map_state(lambda spec: Placement(spec, mesh), specs)


def shard_state(state, specs, mesh):
    """This rank's slice of every leaf of a whole ``TrainState``, on
    ``mesh.device``."""
    return map_state(lambda leaf, spec: Placement(spec, mesh)(leaf), state,
                     specs)


def gather_params(local, specs, mesh):
    """The whole params tree from every rank's slices."""
    return tree_map(lambda t, spec: Placement(spec, mesh).gather(t), local,
                    specs)


def batch_axis(mesh):
    """The mesh axis (or axes) a batch's rows split over, as ``make_rules``
    assigns ``batch``."""
    axes = tuple(a for a in BATCH_AXES if a in mesh.shape)
    return axes[0] if len(axes) == 1 else (axes or None)


def batch_runtime(rt, mesh):
    """``rt`` for a step on ``mesh``: with more than one batch rank the MoE
    aux takes its token means over the global batch (``batch_mesh``)."""
    if mesh is None or axis_index(mesh, batch_axis(mesh))[1] == 1:
        return rt
    return dataclasses.replace(rt, batch_mesh=mesh)


def split_batch(batch: dict, mesh, rules: Rules, num_micro: int = 1) -> dict:
    """This rank's rows of a global batch (arrays with a leading row dim):
    each micro-batch's rows split over the batch axes in coordinate order,
    so a rank's micro-batch ``i`` is its rows of the global micro-batch
    ``i``. Raises where the rows do not divide, as jit's
    ``in_shardings`` does."""
    ax = batch_pspec(rules)[0]
    coord, ways = axis_index(mesh, ax)
    if ways == 1:
        return batch
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % num_micro or rules.constrain(
                (rows // num_micro,), ("batch",)) != (ax,):
            raise ValueError(f"a batch of {rows} rows in {num_micro} "
                             f"micro-batch(es) does not split over the "
                             f"{ways} batch ranks of {ax}")
        per = rows // num_micro // ways
        v = v.reshape(num_micro, rows // num_micro, *v.shape[1:])
        out[k] = v[:, coord * per:(coord + 1) * per].reshape(
            num_micro * per, *v.shape[2:])
    return out


def _all_reduce(t: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axis`` (a new tensor)."""
    group = mesh.group_of(axis)
    if group is None:
        return t
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=group)
    return t


def _reduce_scatter(t: torch.Tensor, dim: int, mesh, axis) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over the ranks
    along ``axis`` (NCCL's reduce-scatter; gloo sums the whole tensor and
    keeps the block)."""
    coord, ways = axis_index(mesh, axis)
    if ways == 1:
        return t
    n = t.shape[dim] // ways
    if mesh.backend == "nccl":
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((n,) + moved.shape[1:], dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, moved, group=mesh.group_of(axis))
        return out.movedim(0, dim).contiguous()
    return _all_reduce(t, mesh, axis).narrow(dim, coord * n, n).contiguous()


def reduce_grads(grads, specs, mesh):
    """This rank's slices of the mean gradient over the batch ranks:
    ``grads`` is the whole gradient tree of this rank's rows (the same on
    the model ranks of one data group). Each leaf takes its ``model``
    slice first, then is reduce-scattered onto its ``data`` dim over the
    data ranks (all-reduced where its spec names none) and all-reduced
    over the pods, then divided by the batch ranks' count."""
    pods = axis_index(mesh, "pod")[1] if "pod" in mesh.shape else 1
    ranks = pods * axis_index(mesh, "data")[1]

    def leaf(g, spec):
        g = Placement(tuple(ax if ax == "model" else None for ax in spec),
                      mesh)(g)
        if "data" in spec:
            g = _reduce_scatter(g, spec.index("data"), mesh, "data")
        else:
            g = _all_reduce(g, mesh, "data")
        if pods > 1:
            g = _all_reduce(g, mesh, "pod")
        return g / ranks if ranks > 1 else g

    return tree_map(leaf, grads, specs)


def global_sq_norm(grads, specs, mesh) -> torch.Tensor:
    """The sum of the squares of the whole gradient tree's elements from
    every rank's slices: a leaf counts on a rank only at coordinate 0 of
    every axis its spec does not name (where it is replicated), so each
    element counts once; one all-reduce over the mesh."""
    coords = mesh.coords
    total = torch.zeros((), device=mesh.device)
    for g, spec in zip(tree_leaves(grads), tree_leaves(specs)):
        named = {a for ax in spec if ax is not None
                 for a in (ax if isinstance(ax, tuple) else (ax,))}
        if all(coords[a] == 0 for a in mesh.shape if a not in named):
            total = total + torch.sum(torch.square(g.to(torch.float32)))
    if mesh.size > 1:
        dist.all_reduce(total, group=mesh.group)
    return total


def world_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``t`` over every rank (the same bits on every rank)."""
    if mesh.size == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, group=mesh.group)
    return t / mesh.size


class _BatchMean(torch.autograd.Function):
    """Forward: the mean of a per-rank mean over the batch ranks. Backward:
    the incoming gradient as it is, since the step's gradient reduction
    averages every rank's gradient over the same ranks: each rank's share
    is then 1/n of its own mean's, as in one process over the whole
    batch."""

    @staticmethod
    def forward(ctx, t, mesh):
        axis = batch_axis(mesh)
        t = _all_reduce(t, mesh, axis)
        return t / axis_index(mesh, axis)[1]

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def batch_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """A per-rank token mean made the global batch's (equal rows per
    rank), counted once in the gradient (:class:`_BatchMean`)."""
    return _BatchMean.apply(t, mesh)
