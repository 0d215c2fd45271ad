"""Gradients of a loss over a param tree, and micro-batch accumulation
(port of ``repro/train/grad.py``: ``accumulate_grads`` and
``zeros_error_buf``).

``compressed_pod_allreduce``, the reference's int8 gradient exchange with
error feedback over a ``pod`` mesh axis, belongs to multi-rank training
and is not ported here (ROADMAP item 10).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["value_and_grad", "accumulate_grads", "zeros_error_buf"]


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
