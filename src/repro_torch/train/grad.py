"""Gradients of a loss over a param tree, micro-batch accumulation, and
the int8 gradient exchange across pods (port of ``repro/train/grad.py``).

:func:`compressed_pod_allreduce` is the reference's 1-byte exchange with
error feedback over the ``pod`` mesh axis (4x fewer bytes than f32 across
the slow inter-pod links): each pod quantizes ``g + e`` to int8 against a
scale shared by the pods, the codes are summed as int32, and each pod
keeps its quantization residual for the next step. As in the reference,
it is a library function: the train step does not call it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["value_and_grad", "accumulate_grads", "zeros_error_buf",
           "compressed_pod_allreduce", "pod_quantize"]


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, aux), grads)`` of ``loss_fn(params, batch) -> (loss,
    aux)``, the gradient taken of ``loss`` w.r.t. every leaf of
    ``params`` (zeros for a leaf the loss does not reach, as JAX gives).
    The params are not modified: the loss sees detached views of them."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), aux.detach()), tree_unflatten(params, grads)


def accumulate_grads(loss_fn: Callable, params, batches, *, num_micro: int):
    """``batches``: a dict of tensors with a leading ``num_micro`` axis.
    Sums the micro-batches' losses, aux values and f32 gradients in order,
    then scales by ``1 / num_micro``. Returns ``(mean_loss, mean_grads,
    mean_aux)``."""
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    dev = tree_leaves(params)[0].device
    lsum = torch.zeros((), device=dev)
    asum = torch.zeros((), device=dev)
    for i in range(num_micro):
        (loss, aux), g = value_and_grad(
            loss_fn, params, {k: v[i] for k, v in batches.items()})
        gsum = tree_map(torch.add, gsum, g)
        lsum, asum = lsum + loss, asum + aux
    inv = 1.0 / num_micro
    return lsum * inv, tree_map(lambda g: g * inv, gsum), asum * inv


def zeros_error_buf(grads):
    """The error-feedback buffer of a compressed exchange: f32 zeros
    shaped as ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def pod_quantize(x: torch.Tensor, amax: torch.Tensor):
    """One pod's side of the exchange: ``x`` (f32, gradient plus residual)
    against ``amax``, the largest ``|x|`` over every pod. Returns ``(q,
    scale, residual)``: int8-range codes as int32, ``max(amax, 1e-12) /
    127`` and ``x - q * scale``. Rounding is half to even, as
    ``jnp.round``."""
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int32), scale, x - q * scale


def compressed_pod_allreduce(grads, error_buf, mesh, *, axis: str = "pod"):
    """int8 + error-feedback mean over the ``axis`` ranks of ``mesh``.

    Contract (the reference's): each leaf of ``grads`` is this pod's
    partial gradient with a leading pod axis of length 1 (the slice a
    ``shard_map`` body sees); ``error_buf`` is f32 and shaped alike.
    Returns ``(mean, new_error_buf)``, the mean equal on every pod; both
    unchanged where the mesh has no ``axis`` or it is 1."""
    if axis not in mesh.shape or mesh.shape[axis] == 1:
        return grads, error_buf
    npod = mesh.shape[axis]
    group = mesh.group_of(axis)

    def leaf(g, e):
        x = g.to(torch.float32) + e
        amax = torch.max(torch.abs(x))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        q, scale, new_e = pod_quantize(x, amax)
        dist.all_reduce(q, group=group)
        return (q.to(torch.float32) * scale / npod).to(g.dtype), new_e

    out = tree_map(leaf, grads, error_buf)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
