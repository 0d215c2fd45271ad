"""The scenarios of ``test_torch_train_tp.py``, run by each spawned gloo
rank (four ranks over a ``file://`` store) on the meshes of ``MESHES``,
whose ``model`` axis splits the compute (``train/tp.py``). The train
steps are ``_torch_train_worker.run_steps``, so the test process holds
them against the same single-process runs as ``test_torch_train_mesh.py``
does. It imports torch and the port only: a spawned rank never loads
JAX.
"""
import os

import numpy as np
import torch

import _torch_train_worker as TW

ARCHS = ("smollm-135m", "qwen1.5-0.5b", "olmoe-1b-7b")
# a family that keeps the storage form on a model axis > 1 (train/tp.py
# SPLIT_FAMILIES): its leaves gathered whole, the gradients' model slices
# taken after
STORAGE_ARCHS = ("rwkv6-3b",)
MESHES = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2}}
STEPS = 2
# the collectives' cases: (rows, K, N) of X @ W, each dim split 4 ways
ROWS, K, N = 8, 8, 12


def collective_inputs() -> dict:
    """The seeded f64 inputs of every collective case."""
    rng = np.random.default_rng(5)
    return {"X": rng.normal(size=(ROWS, K)), "W": rng.normal(size=(K, N)),
            "C": rng.normal(size=(ROWS, N)),
            "M": rng.normal(size=(4, ROWS, N))}


def collectives(mesh) -> dict:
    """Each collective's forward and the gradient this rank gets, on
    ``collective_inputs`` (every rank holds them whole and takes its
    block where the case needs one): ``enter`` before column-parallel
    products, ``leave`` after row-parallel ones, ``gather_replicated``
    feeding a product every rank repeats, ``gather_split`` feeding one
    whose rows each rank takes a block of, ``swap`` re-splitting the
    weight's column blocks into row blocks for such a product, ``max_over``
    of per-rank tensors."""
    from repro_torch.launch.mesh import axis_index
    from repro_torch.train import tp

    r, m = axis_index(mesh, "model")
    t = {k: torch.from_numpy(v) for k, v in collective_inputs().items()}
    cols = slice(r * N // m, (r + 1) * N // m)
    ks = slice(r * K // m, (r + 1) * K // m)
    rows = slice(r * ROWS // m, (r + 1) * ROWS // m)
    out = {}

    x = t["X"].clone().requires_grad_(True)
    y = tp.enter(x, mesh) @ t["W"][:, cols]
    torch.sum(y * t["C"][:, cols]).backward()
    out["enter"] = (y.detach(), x.grad)

    x = t["X"][:, ks].clone().requires_grad_(True)
    y = tp.leave(x @ t["W"][ks], mesh)
    torch.sum(y * t["C"]).backward()
    out["leave"] = (y.detach(), x.grad)

    w = t["W"][:, cols].clone().requires_grad_(True)
    y = tp.gather_replicated(w, -1, mesh)
    torch.sum((t["X"] @ y) * t["C"]).backward()
    out["gather_replicated"] = (y.detach(), w.grad)

    w = t["W"][:, cols].clone().requires_grad_(True)
    y = tp.gather_split(w, -1, mesh)
    torch.sum((t["X"][rows] @ y) * t["C"][rows]).backward()
    out["gather_split"] = (y.detach(), w.grad)

    w = t["W"][:, cols].clone().requires_grad_(True)
    y = tp.swap(w, 0, -1, mesh)
    torch.sum((t["X"][:, ks] @ y) * t["C"]).backward()
    out["swap"] = (y.detach(), w.grad)

    out["max_over"] = tp.max_over(t["M"][r], mesh)
    return out


def working_set(arch: str, mesh) -> dict:
    """One split step on ``mesh``: ``leaves``, (path, the shape the train
    step's gather gives, the leaf's whole shape, its spec) of every params
    leaf; ``gathers``, (the collective, its output shape) of every
    model-axis gather and swap the forward (and its recompute) made."""
    from repro_torch.models import lm
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import loop, sharded, tp
    from repro_torch.train.tree import tree_leaves

    cfg = TW.cfg_of(arch)
    specs = loop.state_specs(cfg, make_rules(mesh, cfg))
    state = loop.init_train_state(cfg, seed=0, device="cpu", mesh=mesh,
                                  specs=specs)
    seen = []
    gather = sharded.gather_params

    def spy(local, pspecs, mesh_, split=None):
        out = gather(local, pspecs, mesh_, split)
        seen.append([tuple(v.shape) for v in tree_leaves(out)])
        return out
    gathers = []
    forward = {n: getattr(tp, n) for n in ("gather_replicated",
                                            "gather_split", "swap")}

    def seen_by(name, fn):
        def spied(*args):
            out = fn(*args)
            gathers.append((name, tuple(out.shape)))
            return out
        return spied
    sharded.gather_params = spy
    for n, fn in forward.items():
        setattr(tp, n, seen_by(n, fn))
    try:
        step = loop.make_train_step(cfg, TW._runtime(None), mesh=mesh,
                                    specs=specs, **TW.STEP_KW)
        step(state, TW.batches(cfg)[0])
    finally:
        sharded.gather_params = gather
        for n, fn in forward.items():
            setattr(tp, n, fn)
    whole = lm.shape_params(cfg)
    paths = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            paths.append(".".join(path))
    walk(whole, ())
    return {"leaves": list(zip(paths, seen[0], [tuple(v.shape)
                                                for v in tree_leaves(whole)],
                               tree_leaves(specs.params))),
            "gathers": gathers}


def run_all(mesh_of, rank: int) -> dict:
    """Every scenario, keyed ``(mesh, arch, kind)``: the collectives on
    (1, 4), the steps of every arch on every mesh and of the storage form
    on (2, 2) (whole trees kept by rank 0 only), the working set of each
    arch on (1, 4)."""
    keep = rank == 0
    out = {"collectives": collectives(mesh_of(MESHES["1x4"]))}
    for name, shape in MESHES.items():
        mesh = mesh_of(shape)
        for arch in ARCHS:
            run, _, _ = TW.run_steps(arch, mesh, steps=STEPS)
            out[(name, arch, "steps")] = TW._strip(run, keep)
            if name == "1x4":
                out[(name, arch, "working_set")] = working_set(arch, mesh)
    mesh = mesh_of(MESHES["2x2"])
    for arch in STORAGE_ARCHS:
        run, _, _ = TW.run_steps(arch, mesh, steps=STEPS)
        out[("2x2", arch, "steps")] = TW._strip(run, keep)
    return out


def rank_main(rank: int, world: int, store: str, tmp: str) -> None:
    """One spawned rank: join the gloo group, run every scenario on one
    intra-op thread, save the results for the test process."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        out = run_all(TW._Meshes(rank, world, store, tmp), rank)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def single() -> dict:
    """The steps of every arch in one process (the yardstick)."""
    return {arch: TW.run_steps(arch, None, steps=STEPS)[0]
            for arch in ARCHS + STORAGE_ARCHS}
