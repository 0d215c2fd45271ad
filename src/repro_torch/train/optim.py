"""AdamW and the cosine schedule (port of ``repro/train/optim.py``).

Moments are f32 trees shaped as the params. :func:`adamw_update` takes the
reference's defaults (b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1, a
global-norm clip at 1.0) and its operation order, and reports the gradient
norm before the clip. It returns new tensors and leaves its arguments as
they were, so a state stays valid after the step that read it (a
checkpoint snapshot, a test's copy). Every scalar stays a 0-d tensor on
the params' device: a step makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.train.tree import tree_leaves, tree_map

__all__ = ["OptState", "adamw_init", "adamw_update", "cosine_lr"]


@dataclasses.dataclass
class OptState:
    mu: Any
    nu: Any
    step: torch.Tensor  # int32, shape ()


def adamw_init(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step_dev = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=step_dev))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 gnorm=None):
    """Returns ``(new_params, new_state, grad_norm)``; ``lr`` a float or a
    0-d tensor. ``gnorm``: the global gradient norm, given by the caller
    when ``grads`` are this rank's shards of a tree sharded over a mesh
    (``train/sharded.py:global_sq_norm``); else the norm of ``grads``."""
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in tree_leaves(grads)))
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    c1 = 1.0 - torch.pow(torch.tensor(b1, device=step.device),
                         step.to(torch.float32))
    c2 = 1.0 - torch.pow(torch.tensor(b2, device=step.device),
                         step.to(torch.float32))

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / c1
        vh = v / c2
        pf = p.to(torch.float32)
        new_p = pf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    new_p, mu, nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, OptState(mu, nu, step), gnorm


def cosine_lr(step, *, peak: float, warmup: int, total: int,
              floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak``, then a cosine to ``floor * peak`` at
    ``total``; ``step`` an int tensor (or int). f32, as the reference."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(
        math.pi * prog))
    return torch.where(s < warmup, warm, cos)
