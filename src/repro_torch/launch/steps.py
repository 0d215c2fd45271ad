"""The step and input stand-ins of every (arch x shape) cell (port
of ``repro/launch/steps.py``).

``build_cell(arch, shape, mesh)`` returns one rank's step of the cell:
the step function, its arguments and the layout it runs in. By default
the arguments are fake tensors (``FakeTensorMode``: shapes and dtypes,
no storage; ``models/lm.py:shape_params``), so a 235B config costs
nothing to stage and ``launch/dryrun.py`` counts the step's work on a
fake process group of 256 or 512 ranks. With ``fake=False`` they are
seeded tensors on the mesh's device, and the same step runs for real
(``chip_smoke.py`` phase 18 (b), on one card).

Cell kinds, as the reference's:
  train   -> train_step(TrainState, batch)           [bf16 autocast, f32 optim]
  prefill -> prefill_step(qparams, batch) -> last-position logits
  decode  -> decode_fn(qparams, tokens, cache, pos) -> (logits, cache)

Serving cells take ITQ3_S-quantized parameter trees, training cells full
precision ones. The runtime is the reference's dry-run runtime: bf16
compute, the plain path (``backend="ref"``, the reference's
``use_kernel=False``) and 256-query attention chunks.

Per rank, the port's own semantics (the reference leaves them to its
SPMD partitioner):

  * a ``train`` cell runs ``make_train_step`` on the mesh
    (``train/sharded.py``): this rank's slices of the state under
    ``param_pspecs``, the global batch split over the batch axes, the
    params gathered along ``data``. The ``model`` axis splits the compute
    of every family (``train/tp.py``: column- and row-parallel products,
    the attention by KV heads or by blocks of keys, RWKV6's and Mamba2's
    mixers by heads, the vocab-parallel head, experts over ``model``);
    ``Cell.layout`` records each stack's case;
  * a serving cell takes its rows of the global batch over the batch axes
    (:func:`_batch_axis_for`) and runs the ``model`` axis through
    ``serve/tp.py``'s rules on its model group: packed planes column-
    parallel, the cache over KV heads where they divide the axis, else
    replicated where the reference (:func:`_cache_pspec`) splits the
    cache's sequence (``Cell.layout`` records which).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, \
    get_config
from repro_torch.launch.mesh import Mesh, axis_index, local_mesh
from repro_torch.models import lm
from repro_torch.models.layers import Runtime
from repro_torch.serve import tp as tp_mod
from repro_torch.serve.quantized import QuantPolicy, quantize_params
from repro_torch.sharding import rules as rules_mod
from repro_torch.train import loop as train_loop
from repro_torch.train import optim

__all__ = ["Cell", "build_cell", "input_specs", "param_tree"]


def input_specs(arch: str, shape_name: str) -> tuple:
    """Fake stand-ins for every input of the (arch, shape) cell on one
    device: ``(TrainState, {tokens, labels[, frontend]})`` for training,
    ``(qparams, batch)`` for prefill, ``(qparams, tokens, cache, pos)``
    for decode."""
    return build_cell(arch, shape_name, local_mesh("cpu")).args


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    mesh: Any  # this rank's launch/mesh.py Mesh
    rules: Any  # sharding/rules.py Rules of the mesh: the reference's specs
    rt: Runtime  # the step's runtime (``with_backend`` swaps its route)
    step_fn: Any  # step_fn(rt, *args)
    args: tuple  # this rank's arguments
    # the whole (unsharded) params or TrainState and its specs under
    # ``rules``: what ``param_bytes_per_device`` counts
    param_tree: Any
    param_specs: Any
    layout: dict  # what this rank runs (rows, batch axis, model axis, cache)
    mode: Any = None  # the FakeTensorMode of fake arguments, else None

    def run(self):
        """One call of the step on the arguments (under their fake mode;
        a serving step under bf16 autocast and no grad, a train step
        autocasts itself). Replaces the reference's ``lower()``."""
        fake = self.mode if self.mode is not None else contextlib.nullcontext()
        serving = self.shape.kind != "train"
        with fake, torch.autocast(self.mesh.device.type, dtype=torch.bfloat16,
                                  enabled=serving), \
                torch.set_grad_enabled(not serving):
            return self.step_fn(self.rt, *self.args)

    def with_backend(self, backend: str) -> "Cell":
        """The same step on the same arguments through another route:
        ``"ref"`` the plain path, ``"auto"`` the card's kernels."""
        return dataclasses.replace(
            self, rt=dataclasses.replace(self.rt, backend=backend))


def _runtime(cfg, rules, *, quant_mode="activations") -> Runtime:
    """The reference dry-run's runtime: the plain path (its
    ``use_kernel=False``) and 256-query attention chunks; its bf16
    compute is ``Cell.run``'s autocast (a train step's own). ``rules``:
    the serving rules of the rank's model group, or None."""
    return Runtime(quant_mode=quant_mode, backend="ref", attn_chunk=256,
                   rules=rules)


def _batch_sds(cfg, shape: ShapeConfig, *, with_labels: bool,
               rows: Optional[int] = None, gen=None, device="cpu"):
    """The batch of ``rows`` (the shape's global batch by default): int32
    tokens (and labels), bf16 frontend features. Zeros, or drawn from
    ``gen`` (a seeded generator on ``device``)."""
    gb, t = rows or shape.global_batch, shape.seq_len

    def ints(*size):
        if gen is None:
            return torch.zeros(size, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab_size, size, generator=gen,
                             device=device, dtype=torch.int32)
    out = {"tokens": ints(gb, t)}
    if with_labels:
        out["labels"] = ints(gb, t)
    if cfg.frontend:
        size = (gb, cfg.frontend_len, cfg.frontend_dim)
        out["frontend"] = (torch.zeros(size, device=device) if gen is None
                           else torch.randn(size, generator=gen,
                                            device=device)).to(torch.bfloat16)
    return out


def _batch_axis_for(n_rows: int, rules, mesh):
    """Largest prefix of the (pod, data) batch axes that divides n_rows:
    ``long_500k`` has global_batch 1 (one 500k-token stream), which cannot
    be split; it falls back to a replicated batch."""
    b = rules.assignments["batch"]
    if b is None:
        return None
    axes = b if isinstance(b, tuple) else (b,)
    keep = []
    size = 1
    for a in axes:
        if n_rows % (size * mesh.shape[a]) == 0:
            keep.append(a)
            size *= mesh.shape[a]
    if not keep:
        return None
    return tuple(keep) if len(keep) > 1 else keep[0]


def _batch_specs(batch, rules, mesh) -> dict:
    """Each batch leaf's spec: its rows over :func:`_batch_axis_for`."""
    return {k: (_batch_axis_for(v.shape[0], rules, mesh),)
            + (None,) * (v.dim() - 1) for k, v in batch.items()}


def _cache_pspec(leaf, rules, mesh) -> tuple:
    """The reference's spec of an (L, B, ...) cache leaf: batch on dim 1;
    ``model`` on the first trailing dim it divides (KV heads, or the
    sequence by the adaptive ``kv_seq`` rule)."""
    msize = rules.mesh.shape.get("model", 1)
    kv_ax = rules.assignments.get("kv_heads")
    seq_ax = rules.assignments.get("kv_seq")
    dims = list(leaf.shape)
    spec = [None, _batch_axis_for(dims[1], rules, mesh)] + [None] * (len(dims) - 2)
    if len(dims) >= 5:  # (L, B, KV, T, HD) attention cache
        if kv_ax and dims[2] % msize == 0:
            spec[2] = kv_ax
        elif seq_ax and dims[3] % msize == 0:
            spec[3] = seq_ax
    elif len(dims) >= 3 and msize > 1:
        for i in range(2, len(dims)):
            if dims[i] % msize == 0 and dims[i] >= msize:
                spec[i] = "model"
                break
    return tuple(spec)


def _model_mesh(mesh: Mesh) -> Optional[Mesh]:
    """This rank's model group as a serving mesh (data 1, model m), or
    None where the model axis has one rank."""
    m = int(mesh.shape.get("model", 1))
    if m == 1:
        return None
    group = mesh.group_of("model")
    return Mesh(shape={"data": 1, "model": m}, rank=mesh.coords["model"],
                size=m, device=mesh.device, group=group,
                groups={"data": None, "model": group})


def _map(fn, tree):
    """``fn`` over the tensors of a params tree or ``TrainState`` (a
    QTensor's arrays included)."""
    return tp_mod._map(tree, lambda _, leaf: fn(leaf))


def param_tree(cfg, kind: str, rules, *, policy, mode=None):
    """A cell's whole shape-only argument 0 and its specs under ``rules``
    (the reference's ``in_shardings[0]``): for ``train`` the
    ``TrainState`` (params, both moments, the step counters) and
    ``state_specs``; for serving the params quantized under ``policy`` and
    their ``param_pspecs``. Fake tensors of ``mode`` (a new one when
    None)."""
    params = lm.shape_params(cfg, mode)
    with params["embed"].fake_mode:
        if kind == "train":
            tree = train_loop.TrainState(
                params=params, opt=optim.adamw_init(params),
                step=torch.zeros((), dtype=torch.int32))
            return tree, train_loop.state_specs(cfg, rules)
        qparams = quantize_params(params, policy)
    return qparams, rules_mod.param_pspecs(qparams, cfg, rules)


def _seeded_state(cfg, dev, seed: int):
    params = lm.init_params(cfg, seed=seed, device=dev)
    return train_loop.TrainState(
        params=params, opt=optim.adamw_init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def build_cell(arch: str, shape_name: str, mesh: Mesh, *,
               quant_fmt: str = "itq3_s", quant_rule: str = "paper",
               quant_mode: str = "activations", num_micro: int = 1,
               fake: bool = True, rows: Optional[int] = None,
               seed: int = 0, cfg: Optional[ModelConfig] = None) -> Cell:
    """One rank's step of the (arch, shape) cell on ``mesh``: fake
    arguments by default; ``fake=False`` seeds real ones on the mesh's
    device (one device only). ``rows`` cuts the global batch (a measured
    cell's cut); ``cfg`` replaces the arch's config (a test's reduced
    one). The step takes the plain route (``Cell.with_backend`` gives
    the kernel route on the same arguments)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    if not fake and mesh.size > 1:
        raise ValueError("a cell runs on real tensors on one device only")
    rules = rules_mod.make_rules(mesh, cfg)
    gb = rows or shape.global_batch
    dev = mesh.device
    mode = None
    gen = None
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode()
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    ctx = mode if mode is not None else contextlib.nullcontext()
    b = _batch_axis_for(gb, rules, mesh)
    local_rows = gb // axis_index(mesh, b)[1]
    layout = {"rows_per_rank": local_rows, "global_rows": gb,
              "batch_axis": b}

    policy = QuantPolicy.uniform(quant_fmt, rule=quant_rule)
    if fake:
        tree, specs = param_tree(cfg, shape.kind, rules, policy=policy,
                                 mode=mode)

    if shape.kind == "train":
        rt = _runtime(cfg, None, quant_mode=quant_mode)
        with ctx:
            if fake:
                state = tree
            else:
                state = _seeded_state(cfg, dev, seed)
                specs = train_loop.state_specs(cfg, rules)
            local = state
            if mesh.size > 1:
                from repro_torch.train import sharded
                local = sharded.shard_state(state, specs, mesh)
            batch = _batch_sds(cfg, shape, with_labels=True, rows=gb,
                               gen=gen, device=dev)

        def train_step(rt, state, batch):
            step = train_loop.make_train_step(
                cfg, rt, num_micro=num_micro, compute_dtype=torch.bfloat16,
                mesh=mesh if mesh.size > 1 else None,
                specs=specs if mesh.size > 1 else None)
            out = step(state, batch)
            layout["model_axis"] = _train_model_axis(cfg, step.split, specs)
            return out

        layout["batch_specs"] = _batch_specs(batch, rules, mesh)
        return Cell(arch, shape, cfg, mesh, rules, rt, train_step,
                    (local, batch), state, specs, layout, mode)

    # ---- serving cells: quantized params, this rank's model group ----
    smesh = _model_mesh(mesh)
    srules = None if smesh is None else tp_mod.serve_rules(smesh, cfg)
    rt = _runtime(cfg, srules, quant_mode=quant_mode)
    if fake:
        qparams, qspecs = tree, specs
    else:
        qparams = lm.init_quantized_params(cfg, policy, seed=seed, device=dev)
        qspecs = rules_mod.param_pspecs(qparams, cfg, rules)
    with ctx:
        local = qparams if srules is None else tp_mod.shard_params(
            qparams, cfg, srules)
    layout["model_axis"] = ("tensor parallel: serve/tp.py rules on this "
                            "rank's model group" if srules else "one rank")

    if shape.kind == "prefill":
        with ctx:
            batch = _batch_sds(cfg, shape, with_labels=False,
                               rows=local_rows, gen=gen, device=dev)

        def prefill_step(rt, params, batch):
            # the serving prefill: the head over the last position only
            logits, _ = lm.forward(params, batch["tokens"], rt, cfg,
                                   frontend_feats=batch.get("frontend"),
                                   last_only=True)
            return logits

        return Cell(arch, shape, cfg, mesh, rules, rt, prefill_step,
                    (local, batch), qparams, qspecs, layout, mode)

    # ---- decode ----
    with ctx:
        cache = lm.init_cache(cfg, gb, shape.seq_len, dtype=torch.bfloat16,
                              device=dev)
        ref_specs = tp_mod._map(cache, lambda _, leaf: _cache_pspec(
            leaf, rules, mesh))
        local_cache = _map(lambda leaf: leaf.narrow(1, 0, local_rows)
                           .contiguous(), cache)
        if srules is not None:
            local_cache = tp_mod.shard_cache(local_cache, cfg, srules)
        if gen is not None:
            local_cache = _map(lambda leaf: leaf.normal_(generator=gen)
                               if leaf.is_floating_point() else leaf,
                               local_cache)
        tokens = (torch.zeros((local_rows, 1), dtype=torch.int32, device=dev)
                  if gen is None else torch.randint(
                      0, cfg.vocab_size, (local_rows, 1), generator=gen,
                      device=dev, dtype=torch.int32))
        pos = torch.full((local_rows,), shape.seq_len - 1, dtype=torch.int32,
                         device=dev)
    layout["cache"] = _cache_layout(cfg, cache, srules, ref_specs)

    def decode_fn(rt, params, tokens, cache, pos):
        return lm.decode_step(params, tokens, cache, pos, rt, cfg)

    return Cell(arch, shape, cfg, mesh, rules, rt, decode_fn,
                (local, tokens, local_cache, pos), qparams, qspecs, layout,
                mode)


def _train_model_axis(cfg, split, specs) -> str:
    """What a train step's ``model`` axis did (read after the step ran):
    ``train/tp.py``'s split, stack by stack (the attention's case and,
    under ``kv_seq``, whether the step split the keys' length, RWKV6's
    time mix and Mamba2's mixer by heads or replicated, the MLP's or
    channel mix's split), and the head's."""
    if split is None:
        return "one rank"
    keys = {"split": "every query against each rank's 1/m of the keys",
            "replicated": "the keys' length does not divide the axis, "
                          "replicated"}
    parts = []
    for key, case in split.cases:
        stack, block = key.split(".")
        if block in ("attn", "xattn"):
            what = "cross-attention" if block == "xattn" else "attention"
            how = ("each rank its kv_heads / m groups" if case == "heads"
                   else keys[split.taken[key]])
            parts.append(f"{stack} {what} {case}: {how}")
        elif block == "time_mix":
            parts.append(f"{stack} RWKV6 time mix {case}" + (
                ": each rank its num_heads / m heads" if case == "heads"
                else ": the heads do not divide the axis"))
        else:
            parts.append(f"{stack} Mamba2 {case}" + (
                ": each rank its heads" if case == "heads"
                else ": the heads do not divide the axis"))
    for stack in ("encoder", "layers"):
        s = split.at(stack)
        ffn = ("experts over model" if s.has("moe.up") else
               "mlp column/row-parallel" if s.has("mlp.up") else
               "channel mix column/row-parallel" if s.has("cm_v") else
               None)
        if stack in specs.params and ffn:
            parts.append(f"{stack} {ffn}")
    parts.append("vocab-parallel head" if split.vocab else
                 "head replicated")
    return "tensor parallel (train/tp.py): " + "; ".join(parts)


def _cache_layout(cfg, cache, srules, ref_specs) -> dict:
    """Per cache leaf: the port's spec on this rank's model group, and the
    reference's on the whole mesh (they differ where the KV heads do not
    divide the model axis: the port replicates the cache, the reference
    splits its sequence)."""
    port = ({} if srules is None else tp_mod.cache_pspecs(cache, cfg, srules))
    out = {}

    def walk(tree, ref, mine, path):
        for k, v in tree.items():
            p = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                walk(v, ref[k], mine.get(k, {}) if mine else {}, p)
            else:
                out[p] = {"port": list(mine.get(k, (None,) * v.dim())
                                       if mine else (None,) * v.dim()),
                          "reference": list(ref[k]),
                          "shape": list(v.shape)}
    walk(cache, ref_specs, port, "")
    return out
