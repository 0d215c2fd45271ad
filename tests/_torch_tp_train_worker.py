"""The scenarios of ``test_torch_train_tp.py``, run by each spawned gloo
rank (four ranks over a ``file://`` store) on the meshes of ``MESHES``,
whose ``model`` axis splits the compute (``train/tp.py``). The train
steps are ``_torch_train_worker.run_steps``, so the test process holds
them against the same single-process runs as ``test_torch_train_mesh.py``
does. It imports torch and the port only: a spawned rank never loads
JAX.
"""
import dataclasses
import os

import numpy as np
import torch

import _torch_train_worker as TW

# trained on both meshes of MESHES
ARCHS = ("smollm-135m", "qwen1.5-0.5b", "olmoe-1b-7b", "rwkv6-3b",
         "zamba2-7b")
# trained on (1, 4) only: RWKV6 whose 2 heads do not divide the axis (its
# time mix replicated), the vlm and the audio model with their seeded
# frontend features
ONE_MESH = ("rwkv6-3b/2 heads", "phi-3-vision-4.2b", "seamless-m4t-medium")
VARIANTS = {"rwkv6-3b/2 heads": ("rwkv6-3b", {"num_heads": 2})}
MESHES = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2}}
SCENARIOS = ([(m, a) for m in MESHES for a in ARCHS]
             + [("1x4", a) for a in ONE_MESH])
# the (1, 4) working set and gathers of every config
WORKING_SETS = ARCHS + ONE_MESH[1:]
STEPS = 2
# the collectives' cases: (rows, K, N) of X @ W, each dim split 4 ways
ROWS, K, N = 8, 8, 12


def cfg_of(name: str):
    """The reduced config of an arch, or of a variant of VARIANTS."""
    arch, kw = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(TW.cfg_of(arch), **kw)


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

    x = t["X"][:, ks].clone().requires_grad_(True)
    y = tp.scatter(x @ t["W"][ks], -1, mesh)
    torch.sum(y * t["C"][:, cols]).backward()
    out["scatter"] = (y.detach(), x.grad)

    w = t["W"].clone().requires_grad_(True)
    y = tp.own(w, -1, mesh)
    torch.sum((t["X"] @ y) * t["C"][:, cols]).backward()
    out["own"] = (y.detach(), w.grad)

    x = t["X"][:, ks].clone().requires_grad_(True)
    y = tp.total(x @ t["W"][ks], mesh)
    torch.sum(y[:, cols] * t["C"][:, cols]).backward()
    out["total"] = (y.detach(), x.grad)

    out["max_over"] = tp.max_over(t["M"][r], mesh)
    return out


def block_inputs() -> dict:
    """The seeded inputs of the split blocks' cases: a (ROWS, N) width
    with its norm's scale and bias, a gate, the decay LoRA's streams and
    weights, and a cross-attention of reduced seamless-m4t-medium with 2
    KV heads (which do not divide 4) over 8 memory rows."""
    rng = np.random.default_rng(6)
    cfg = cross_cfg()
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    f = np.float32
    return {
        "x": rng.normal(1.0, 2.0, size=(ROWS, N)), "scale":
        rng.normal(size=N), "bias": rng.normal(size=N),
        "z": rng.normal(size=(ROWS, N)), "C": rng.normal(size=(ROWS, N)),
        "xs": rng.normal(size=(ROWS, 16)), "a": rng.normal(size=(16, K)),
        "b": rng.normal(size=(K, N)),
        "q_in": rng.normal(size=(2, 4, d)).astype(f),
        "memory": rng.normal(size=(2, 8, d)).astype(f),
        "wq": (rng.normal(size=(d, h * hd)) / d ** 0.5).astype(f),
        "wk": (rng.normal(size=(d, kv * hd)) / d ** 0.5).astype(f),
        "wv": (rng.normal(size=(d, kv * hd)) / d ** 0.5).astype(f),
        "wo": (rng.normal(size=(h * hd, d)) / d ** 0.5).astype(f),
        "Co": rng.normal(size=(2, 4, d)).astype(f)}


def cross_cfg():
    return dataclasses.replace(TW.cfg_of("seamless-m4t-medium"),
                               num_kv_heads=2)


# per block case: the leaves each rank holds as a block (the dim it is
# cut along), the rest whole
BLOCK_CUTS = {
    "layernorm": {"y": -1, "x": -1},
    "gated_rmsnorm": {"y": -1, "x": -1, "z": -1},
    "decay_lora": {"y": -1, "a": -1, "b": 0},
    "cross_kv_seq": {"wq": -1, "wk": -1, "wv": -1, "wo": 0},
}


def blocks(mesh=None) -> dict:
    """Per case of BLOCK_CUTS, {name: tensor} of its output ``y`` and the
    gradients this rank gets of ``sum(y * C)``: under the split on
    ``mesh`` (this rank's blocks of the BLOCK_CUTS leaves), or, without a
    mesh, the plain function on the whole inputs. The LayerNorm and the
    gated RMSNorm over a split width, the decay LoRA's reduce-scattered
    partial sums, and cross-attention whose KV heads do not divide the
    axis (``kv_seq``: every query against each rank's 2 of the 8 memory
    rows, the weights gathered, wo row-parallel)."""
    from repro_torch.launch.mesh import axis_index
    from repro_torch.models import layers
    from repro_torch.train import tp

    t = {k: torch.from_numpy(v) for k, v in block_inputs().items()}
    r, m = (0, 1) if mesh is None else axis_index(mesh, "model")
    split = None if mesh is None else tp.ModelSplit(
        mesh=mesh, ways=m, coord=r, leaves=frozenset(
            f"layers.xattn.{n}" for n in ("wq", "wk", "wv", "wo")),
        cases=(("layers.xattn", "kv_seq"),), vocab=False, stack="layers")

    def leaf(case, name):
        dim = BLOCK_CUTS[case].get(name)
        v = t[name]
        if split is not None and dim is not None:
            n = v.shape[dim] // m
            v = v.narrow(dim, r * n, n)
        return v.clone().requires_grad_(True)

    def run(case, fn, names, c):
        args = {n: leaf(case, n) for n in names}
        y = fn(**args)
        cut = BLOCK_CUTS[case].get("y")
        if split is not None and cut is not None:
            n = c.shape[cut] // m
            c = c.narrow(cut, r * n, n)
        torch.sum(y * c).backward()
        return dict(y=y.detach(), **{n: a.grad for n, a in args.items()})

    out = {}
    for kind in ("layernorm", "gated_rmsnorm"):
        def norm(x, scale, bias=None, z=None, kind=kind):
            p = {"scale": scale} if bias is None else {"scale": scale,
                                                       "bias": bias}
            y = layers.norm_apply(p, x, kind.split("_")[-1], split=split)
            return y if z is None else y * torch.nn.functional.silu(z)
        names = (("x", "scale", "bias") if kind == "layernorm"
                 else ("x", "scale", "z"))
        out[kind] = run(kind, norm, names, t["C"].float())

    def lora(xs, a, b):
        if split is None:
            return torch.tanh(xs @ a) @ b
        return split.scatter(torch.tanh(split.enter(xs) @ a) @ b, -1)
    out["decay_lora"] = run("decay_lora", lora, ("xs", "a", "b"), t["C"])

    cfg = cross_cfg()
    rt = layers.Runtime(model_split=split)

    def cross(q_in, memory, wq, wk, wv, wo):
        p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
        return layers.attention_apply(p, q_in, rt, cfg, memory=memory,
                                      cross=True)[0]
    out["cross_kv_seq"] = run("cross_kv_seq", cross,
                              ("q_in", "memory", "wq", "wk", "wv", "wo"),
                              t["Co"])
    return out


def spied_steps(arch: str, mesh) -> tuple:
    """The train steps of ``arch`` on ``mesh`` (``TW.run_steps``) and
    their working set: ``leaves``, (path, the shape the steps' first
    gather of the params gives, the leaf's whole shape, its spec) of
    every params leaf; ``gathers``, (the collective, its output shape) of
    every model-axis gather and swap the forwards (and their recomputes)
    made."""
    from repro_torch.models import lm
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import loop, sharded, tp
    from repro_torch.train.tree import tree_leaves

    cfg = cfg_of(arch)
    seen = []
    gather = sharded.gather_params

    def spy(local, pspecs, mesh_):
        out = gather(local, pspecs, mesh_)
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
        run, _, specs = TW.run_steps(arch, mesh, steps=STEPS, cfg=cfg)
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
    return run, {"leaves": list(zip(paths, seen[0],
                                    [tuple(v.shape)
                                     for v in tree_leaves(whole)],
                                    tree_leaves(specs.params))),
                 "gathers": gathers}


def run_all(mesh_of, rank: int) -> dict:
    """Every scenario, keyed ``(mesh, arch, kind)``: the collectives and
    the split blocks on (1, 4), the steps of every scenario of SCENARIOS
    (whole trees kept by rank 0 only), and, taken from the same steps on
    (1, 4), the working set of each config of WORKING_SETS."""
    keep = rank == 0
    one = mesh_of(MESHES["1x4"])
    out = {"collectives": collectives(one), "blocks": blocks(one)}
    for name, arch in SCENARIOS:
        mesh = mesh_of(MESHES[name])
        if name == "1x4" and arch in WORKING_SETS:
            run, out[(name, arch, "working_set")] = spied_steps(arch, mesh)
        else:
            run, _, _ = TW.run_steps(arch, mesh, steps=STEPS,
                                     cfg=cfg_of(arch))
        out[(name, arch, "steps")] = TW._strip(run, keep)
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
    """The steps of every config in one process (the yardstick)."""
    return {arch: TW.run_steps(arch, None, steps=STEPS, cfg=cfg_of(arch))[0]
            for arch in ARCHS + ONE_MESH}
