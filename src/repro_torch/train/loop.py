"""The training step (port of ``repro/train/loop.py``): loss, per-layer
remat, micro-batch accumulation and AdamW.

``make_train_step(cfg, rt, ...)`` returns ``train_step(state, batch) ->
(state, metrics)``. The loss is ``lm.forward_xent`` (the head and its
logsumexp per chunk of positions, never the whole (B, T, V) logits) plus
``aux_weight`` times the MoE load-balancing loss. Params and optimizer
moments stay f32. With ``compute_dtype=torch.bfloat16`` the loss runs
under ``torch.autocast`` on the batch's device, the counterpart of the
reference's bf16 compute off the CPU; autocast casts at the matmuls and
leaves the serving code as it is. ``train_step`` returns a new state and
never modifies the one it was given. No step reaches a hand-written
kernel: the params are full precision and the reference's training
forward reaches no ``pallas_call``.

On a mesh of ranks (``make_train_step(..., mesh=, specs=)``) the state
holds this rank's slices under ``specs`` and the step runs as
``train/sharded.py`` describes: the batch split over the batch ranks,
the params gathered, the gradients reduced to the specs, one global norm,
AdamW on the slices, and the loss and aux averaged over the ranks, so
every rank reports the same metrics. By family on a model axis of more
than one rank: ``dense`` and ``moe`` split the compute over ``model``
(``train/tp.py``: the params gathered along ``data`` only, column- and
row-parallel products, the attention by KV heads or by blocks of keys,
the vocab-parallel head and cross-entropy, experts over ``model``);
``vlm``, ``audio``, ``ssm`` and ``hybrid`` keep the storage form (every
leaf gathered whole, the model ranks of a data group computing the same
rows).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.layers import Runtime
from repro_torch.sharding.rules import make_rules, param_pspecs
from repro_torch.train import optim, sharded, tp
from repro_torch.train.grad import accumulate_grads, value_and_grad

__all__ = ["TrainState", "make_train_step", "init_train_state",
           "softmax_xent", "state_specs"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: optim.OptState
    step: torch.Tensor  # int32, shape ()


def init_train_state(cfg, *, seed: int = 0, device="cuda", mesh=None,
                     specs=None) -> TrainState:
    """The port's seeded params (``lm.init_params``), zero moments and
    step 0. With ``mesh`` and ``specs`` every rank draws the whole state
    from the same seed and keeps its slices, so every mesh starts from
    one device's state."""
    params = lm.init_params(cfg, seed=seed, device=device)
    state = TrainState(params=params, opt=optim.adamw_init(params),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=device))
    if mesh is None:
        return state
    return sharded.shard_state(state, specs, mesh)


def state_specs(cfg, rules) -> TrainState:
    """The ``TrainState`` of specs a state is stored under on
    ``rules.mesh``: ``param_pspecs`` for the params and both moments, the
    step counters replicated (the reference's ``build_trainer``). Read
    from the shape-only tree (``lm.shape_params``): nothing is drawn."""
    pspecs = param_pspecs(lm.shape_params(cfg), cfg, rules)
    return TrainState(params=pspecs, opt=optim.OptState(pspecs, pspecs, ()),
                      step=())


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of (..., V) logits, in f32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - ll)


def make_train_step(cfg, rt: Runtime, *, lr_peak: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    num_micro: int = 1, aux_weight: float = 0.01,
                    remat: bool = True, remat_policy: Optional[str] = "dots",
                    compute_dtype: torch.dtype = torch.float32, mesh=None,
                    specs: Optional[TrainState] = None):
    """Build the train step of one architecture. A batch is ``{"tokens",
    "labels"}`` ((B, T) ints, numpy or tensors) and, for a frontend
    model, ``"frontend"`` (B, P, F); ``num_micro`` splits B into that many
    micro-batches whose gradients are averaged. Metrics (0-d tensors):
    ``loss`` (with the aux term), ``gnorm`` (before the clip), ``lr`` and
    ``moe_aux``. With ``mesh``, ``state`` holds this rank's slices under
    ``specs`` (:func:`state_specs`), every rank passes the whole batch,
    and the metrics are the mesh's, the same on every rank."""
    rt = dataclasses.replace(rt, remat=remat,
                             remat_policy=remat_policy or "none")
    rules = None if mesh is None else make_rules(mesh, cfg)
    split = None if mesh is None else tp.plan(cfg, mesh, specs.params)
    rt = sharded.step_runtime(rt, mesh, split)

    def loss_fn(params, batch):
        dev = batch["tokens"].device
        with torch.autocast(dev.type, dtype=compute_dtype,
                            enabled=compute_dtype != torch.float32):
            loss, aux = lm.forward_xent(params, batch["tokens"],
                                        batch["labels"], rt, cfg,
                                        frontend_feats=batch.get("frontend"))
        return loss + aux_weight * aux, aux

    def train_step(state: TrainState, batch):
        dev = state.step.device
        params, gnorm = state.params, None
        if mesh is not None:
            batch = sharded.split_batch(batch, mesh, rules, num_micro)
            params = sharded.gather_params(params, specs.params, mesh,
                                           split)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        lr = optim.cosine_lr(state.step, peak=lr_peak, warmup=warmup,
                             total=total_steps)
        if num_micro > 1:
            mb = {k: v.reshape(num_micro, v.shape[0] // num_micro,
                               *v.shape[1:]) for k, v in batch.items()}
            loss, grads, aux = accumulate_grads(loss_fn, params, mb,
                                                num_micro=num_micro)
        else:
            (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        del params
        if mesh is not None:
            grads = sharded.reduce_grads(grads, specs.params, mesh, split)
            gnorm = torch.sqrt(sharded.global_sq_norm(grads, specs.params,
                                                      mesh))
            loss = sharded.world_mean(loss, mesh)
            aux = sharded.world_mean(aux, mesh)
        new_params, new_opt, gnorm = optim.adamw_update(
            grads, state.opt, state.params, lr, gnorm=gnorm)
        metrics = {"loss": loss, "gnorm": gnorm, "lr": lr, "moe_aux": aux}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
