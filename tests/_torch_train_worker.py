"""The scenarios of ``test_torch_train_mesh.py``, run alike by the test
process (one process, no mesh) and by each spawned gloo rank (four ranks
over a ``file://`` store, on the meshes of ``MESHES``), so both sides
train exactly the same models on the same batches. It imports torch and
the port only: a spawned rank never loads JAX.

Each scenario returns plain data: per step the metrics (floats, so the
ranks' bits can be compared), and, from rank 0 and the single process,
the step's whole gradient tree and the whole params after it.
"""
import dataclasses
import os

import numpy as np
import torch

ARCHS = ("smollm-135m", "olmoe-1b-7b")
MESHES = {"4x1": {"data": 4, "model": 1}, "2x2": {"data": 2, "model": 2}}
POD_MESH = {"pod": 2, "data": 2, "model": 1}
STEP_KW = dict(lr_peak=3e-3, warmup=2, total_steps=10)
B, T, STEPS, MICRO = 8, 16, 3, 2
POD_STEPS = 6
SAVE_STEP = STEPS


def cfg_of(arch: str):
    from repro_torch import configs
    return configs.reduced(configs.get_config(arch))


def batches(cfg) -> list:
    from repro_torch.data.pipeline import SyntheticCorpus
    corpus = SyntheticCorpus(cfg.vocab_size, seed=3)
    return [corpus.batch(s, B, T) for s in range(STEPS)]


def _runtime(mesh, split=None):
    """The train step's runtime on ``mesh`` (None: one process) under
    ``split`` (``train/tp.py:plan``)."""
    from repro_torch.models.layers import Runtime
    from repro_torch.train import sharded
    return sharded.step_runtime(Runtime(capacity_factor=2.0), mesh, split)


def _whole(tree, specs, mesh):
    """The whole tree from this rank's slices (every rank calls it);
    detached CPU tensors."""
    from repro_torch.train import sharded
    from repro_torch.train.tree import tree_map
    if mesh is not None:
        tree = sharded.gather_params(tree, specs, mesh)
    return tree_map(lambda t: t.detach().cpu().clone(), tree)


def grads_of(cfg, params, batch, mesh, specs, *, aux_only=False):
    """The gradient of the train loss (or of the MoE aux alone) at
    ``params`` (this rank's slices on a mesh): ``(value, whole grads)``.
    On a mesh, as the train step takes them: this rank's rows, the params
    gathered (along ``data`` only where the model axis splits the
    compute), the gradients reduced to the specs, then gathered whole."""
    from repro_torch.models import lm
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import sharded, tp
    from repro_torch.train.grad import value_and_grad

    split = None if mesh is None else tp.plan(cfg, mesh, specs.params)
    rt = _runtime(mesh, split)

    def loss_fn(p, b):
        xent, aux = lm.forward_xent(p, b["tokens"], b["labels"], rt, cfg)
        return (aux if aux_only else xent + 0.01 * aux), aux

    if mesh is not None:
        batch = sharded.split_batch(batch, mesh, make_rules(mesh, cfg))
        params = sharded.gather_params(params, specs.params, mesh, split)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    (value, _), grads = value_and_grad(loss_fn, params, batch)
    if mesh is not None:
        grads = sharded.reduce_grads(grads, specs.params, mesh, split)
        value = sharded.world_mean(value, mesh)
    return float(value), _whole(grads, specs.params if specs else None,
                                mesh)


def run_steps(arch: str, mesh, *, num_micro: int = 1, steps: int = STEPS,
              start_step: int = 0):
    """``steps`` train steps from the seeded state (its step counter set
    to ``start_step``). Returns (per step: metrics, whole grads at the
    state it starts from, whole params after it; the final state)."""
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import loop

    cfg = cfg_of(arch)
    specs = None
    if mesh is not None:
        specs = loop.state_specs(cfg, make_rules(mesh, cfg))
    state = loop.init_train_state(cfg, seed=0, device="cpu", mesh=mesh,
                                  specs=specs)
    state = dataclasses.replace(state, step=torch.full_like(state.step,
                                                            start_step))
    step = loop.make_train_step(cfg, _runtime(None), num_micro=num_micro,
                                mesh=mesh, specs=specs, **STEP_KW)
    out = []
    for batch in batches(cfg)[:steps]:
        _, grads = grads_of(cfg, state.params, batch, mesh, specs)
        state, m = step(state, batch)
        out.append(dict(metrics={k: float(v) for k, v in m.items()},
                        grads=grads,
                        params=_whole(state.params,
                                      specs.params if specs else None,
                                      mesh)))
    return out, state, specs


def aux_grads(mesh):
    """olmoe's aux alone and its gradient at the seeded state, over the
    first batch."""
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import loop

    cfg = cfg_of("olmoe-1b-7b")
    specs = None
    if mesh is not None:
        specs = loop.state_specs(cfg, make_rules(mesh, cfg))
    state = loop.init_train_state(cfg, seed=0, device="cpu", mesh=mesh,
                                  specs=specs)
    return grads_of(cfg, state.params, batches(cfg)[0], mesh, specs,
                    aux_only=True)


def pod_grads(pod: int) -> dict:
    """Pod ``pod``'s seeded partial gradients: the leaf of
    ``tests/test_train.py``'s model and a 2-D one."""
    rng = np.random.default_rng(0)
    leaves = [[rng.normal(size=shape).astype(np.float32)
               for _ in range(POD_MESH["pod"])]
              for shape in ((64,), (24, 40))]
    return {"v": leaves[0][pod], "w": leaves[1][pod]}


def pod_exchange(mesh) -> list:
    """``compressed_pod_allreduce`` over the pod axis for POD_STEPS steps
    on this rank's pod's gradients: per step, the mean and the residuals
    (leading pod axis of length 1 on each rank)."""
    from repro_torch.launch.mesh import axis_index
    from repro_torch.train.grad import (compressed_pod_allreduce,
                                        zeros_error_buf)

    pod = axis_index(mesh, "pod")[0]
    g = {k: torch.from_numpy(v)[None] for k, v in pod_grads(pod).items()}
    e = zeros_error_buf(g)
    out = []
    for _ in range(POD_STEPS):
        red, e = compressed_pod_allreduce(g, e, mesh)
        out.append(({k: v.clone() for k, v in red.items()},
                    {k: v.clone() for k, v in e.items()}))
    return out


def run_all(mesh_of, rank: int) -> dict:
    """Every scenario on every mesh of ``MESHES`` and ``POD_MESH``
    (``mesh_of(shape)`` builds one), keyed ``(mesh, arch, kind)``. Whole
    trees are kept by rank 0 only; every rank keeps its metrics. The 2 x 2
    smollm state after its steps is saved through the mesh."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.train import sharded

    keep = rank == 0
    out = {}
    for name, shape in MESHES.items():
        mesh = mesh_of(shape)
        for arch in ARCHS:
            run, state, specs = run_steps(arch, mesh)
            out[(name, arch, "steps")] = _strip(run, keep)
            if name == "2x2" and arch == "smollm-135m":
                places = sharded.placements(specs, mesh)
                ckpt.save(os.path.join(mesh_of.tmp, "save22"), SAVE_STEP,
                          state, shardings=places)
                whole = sharded.map_state(lambda t, p: p.gather(t).clone(),
                                          state, places)
                out["save22_state"] = whole if keep else None
            micro, _, _ = run_steps(arch, mesh, num_micro=MICRO, steps=1,
                                    start_step=STEP_KW["warmup"])
            out[(name, arch, "micro")] = _strip(micro, keep)
        value, grads = aux_grads(mesh)
        out[(name, "aux")] = (value, grads if keep else None)
    out["pod"] = pod_exchange(mesh_of(POD_MESH))
    return out


def _strip(run: list, keep: bool) -> list:
    """Rank 0 keeps every record; the others their metrics."""
    return run if keep else [{"metrics": r["metrics"]} for r in run]


class _Meshes:
    """One mesh per shape over the process group, built once per shape
    in the same order on every rank."""

    def __init__(self, rank: int, world: int, store: str, tmp: str):
        self.rank, self.world, self.store, self.tmp = rank, world, store, tmp
        self.meshes = {}

    def __call__(self, shape: dict):
        from repro_torch.launch.mesh import make_mesh
        key = tuple(shape.items())
        if key not in self.meshes:
            self.meshes[key] = make_mesh(
                shape, device=torch.device("cpu"), init_method=self.store,
                rank=self.rank, world_size=self.world)
        return self.meshes[key]


def rank_main(rank: int, world: int, store: str, tmp: str) -> None:
    """One spawned rank: join the gloo group, run every scenario on one
    intra-op thread, save the results for the test process."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        out = run_all(_Meshes(rank, world, store, tmp), rank)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def single() -> dict:
    """The scenarios in one process (the yardstick), keyed ``(arch,
    kind)``."""
    out = {}
    for arch in ARCHS:
        out[(arch, "steps")] = run_steps(arch, None)[0]
        out[(arch, "micro")] = run_steps(arch, None, num_micro=MICRO,
                                         steps=1,
                                         start_step=STEP_KW["warmup"])[0]
    out["aux"] = aux_grads(None)
    return out
