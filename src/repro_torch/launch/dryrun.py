"""Per-cell dry-run on the production topology (port of
``repro/launch/dryrun.py``): every (architecture x input shape x mesh)
cell's step, run once by rank 0 of a fake process group of 256 or 512
ranks on fake tensors, with the work it dispatches counted
(``launch/op_analysis.py``), and the roofline terms derived from the
count against one NVIDIA H100's rates.

The fake group (``torch.testing._internal.distributed.fake_pg``) is
joined here and only here, by name, for the cell's mesh, and destroyed
when the cell ends; a dry-run refuses to start inside a process that
already has a default group. Its collectives return at once and leave
their outputs as they are: with fake tensors nothing is computed, only
shapes, dtypes and the ops that would run. The record keeps the
reference's keys, so ``benchmarks/roofline_report.py`` reads it
unchanged; the reference's lowering and compile times become one
``trace_s``, and there is no compiler memory analysis to report.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --jobs 4
    python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape prefill_32k --mesh one --rows 1   # a cut cell, one device
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.quantize import QTensor
from repro_torch.launch.mesh import local_mesh, make_mesh, production_shape
from repro_torch.launch.op_analysis import count_ops, top_ops
from repro_torch.launch.steps import build_cell
from repro_torch.models.lm import model_flops
from repro_torch.train.loop import TrainState

__all__ = ["run_cell", "main", "fake_world", "param_bytes_per_device",
           "roofline", "PEAK_FLOPS", "HBM_BW", "COLL_BW", "DEVICE"]

# One NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, from NVIDIA's data
# sheet: dense bf16 tensor-core rate, HBM3 bandwidth, and the collective
# rate of one 400 Gb/s NDR link per GPU (50 GB/s): every production axis
# of 16 ranks spans two 8-GPU nodes, so a collective along it crosses
# the network, not NVLink alone.
DEVICE = "NVIDIA H100 80GB HBM3 (SXM5), 700 W"
PEAK_FLOPS = 989.4e12  # bf16, dense
HBM_BW = 3.35e12  # bytes/s
COLL_BW = 50e9  # bytes/s per link (one usable link per collective)


@contextlib.contextmanager
def fake_world(world: int):
    """Rank 0 of a fake process group of ``world`` ranks, for the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run joins a fake process group of its "
                           "own; this process already has a default group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _pairs(tree, specs):
    """(leaf, spec) pairs of a params tree or ``TrainState`` and its spec
    tree (a QTensor's arrays against the QTensor of their specs)."""
    if isinstance(tree, TrainState):
        for a, b in ((tree.params, specs.params), (tree.opt.mu, specs.opt.mu),
                     (tree.opt.nu, specs.opt.nu), (tree.opt.step,
                                                   specs.opt.step),
                     (tree.step, specs.step)):
            yield from _pairs(a, b)
    elif isinstance(tree, QTensor):
        for k, v in tree.data.items():
            yield v, specs.data[k]
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    else:
        yield tree, specs


def param_bytes_per_device(tree, specs, mesh_shape: dict) -> float:
    """Bytes per device of a spec'd tree, by the reference's rule: each
    leaf's bytes over the product of the mesh axes its spec names."""
    total = 0.0
    for leaf, spec in _pairs(tree, specs):
        n = 1.0
        for d in leaf.shape:
            n *= int(d)
        denom = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    denom *= mesh_shape[a]
        total += n * leaf.element_size() / denom
    return total


def roofline(flops: float, nbytes: float, coll_bytes: float) -> dict:
    """The three roofline terms of one device's step, in seconds."""
    return {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW,
            "collective_s": coll_bytes / COLL_BW}


def run_cell(arch: str, shape_name: str, multi_pod: Optional[bool], *,
             quant_mode: str = "activations", quant_rule: str = "paper",
             quant_fmt: str = "itq3_s", skip_analysis: bool = False,
             rows: Optional[int] = None) -> dict:
    """One cell's record on the single (16 x 16) or multi-pod (2 x 16 x
    16) mesh, from rank 0 of a fake group of its size; ``multi_pod=None``:
    on one device (1 x 1, no group). ``rows`` cuts the global batch (the
    cuts of the cells ``chip_smoke.py`` measures on one card)."""
    shape = ({"data": 1, "model": 1} if multi_pod is None
             else production_shape(multi_pod))
    nchips = 1
    for n in shape.values():
        nchips *= n
    rec: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in shape.values()),
        "chips": nchips, "quant_mode": quant_mode, "status": "started",
        "device": DEVICE,
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "coll_bw": COLL_BW},
    }
    with (contextlib.nullcontext() if nchips == 1 else fake_world(nchips)):
        mesh = (local_mesh("cpu") if nchips == 1 else
                make_mesh(shape, device="cpu", rank=0, world_size=nchips))
        t0 = time.time()
        cell = build_cell(arch, shape_name, mesh, quant_mode=quant_mode,
                          quant_rule=quant_rule, quant_fmt=quant_fmt,
                          rows=rows)
        rec["layout"] = cell.layout
        rec["memory_analysis"] = ("unavailable: an eager step on fake "
                                  "tensors has no compiler memory analysis")
        rec["param_bytes_per_device"] = param_bytes_per_device(
            cell.param_tree, cell.param_specs, shape)
        if skip_analysis:
            cell.run()
            rec["trace_s"] = round(time.time() - t0, 1)
            rec["status"] = "ok"
            return rec
        with count_ops() as stats:
            cell.run()
        rec["trace_s"] = round(time.time() - t0, 1)
    rec["hlo_flops"] = stats.flops
    rec["hlo_bytes"] = stats.bytes_accessed
    rec["collective_bytes"] = stats.collective_bytes
    rec["collective_counts"] = stats.collective_counts
    rec["dynamic_whiles"] = stats.dynamic_whiles
    rec["dot_count"] = stats.dot_count
    # counted on one rank: already per device
    rec["roofline"] = roofline(stats.flops, stats.bytes_accessed,
                               stats.total_collective_bytes)
    rec["bottleneck"] = max(rec["roofline"], key=rec["roofline"].get)
    mf = model_flops(cell.cfg, cell.shape.seq_len,
                     cell.layout["global_rows"], decode=cell.shape.is_decode)
    if cell.shape.kind == "train":
        mf *= 3.0  # forward and backward
    rec["model_flops_global"] = mf
    rec["model_flops_per_device"] = mf / nchips
    rec["useful_flops_frac"] = (mf / nchips) / max(stats.flops, 1.0)
    rec["top_ops"] = [list(t) for t in top_ops(stats, 12)]
    rec["status"] = "ok"
    return rec


_MESH_TAG = {False: "single", True: "multi", None: "one"}


def _record(arch: str, shape: str, multi: Optional[bool], args) -> dict:
    """One cell's record, or its error with the cause."""
    try:
        return run_cell(arch, shape, multi, quant_mode=args.quant_mode,
                        quant_rule=args.quant_rule, quant_fmt=args.quant_fmt,
                        skip_analysis=args.skip_analysis, rows=args.rows)
    except Exception as e:
        return {"arch": arch, "shape": shape, "mesh": _MESH_TAG[multi],
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def _write(path: str, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=float)
    print(f"       -> {os.path.basename(path)} {rec['status']}"
          + (f" trace={rec.get('trace_s')}s bottleneck={rec.get('bottleneck')}"
             if rec["status"] == "ok" else f" {rec.get('error', '')[:200]}"),
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both", "one"],
                    default="single",
                    help="16x16, 2x16x16, both, or one device (1x1)")
    ap.add_argument("--rows", type=int, default=None,
                    help="cut the global batch to this many rows")
    ap.add_argument("--quant-mode", default="activations",
                    choices=["activations", "weights", "dequant", "auto"])
    ap.add_argument("--quant-rule", default="paper")
    ap.add_argument("--quant-fmt", default="itq3_s")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--skip-analysis", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a forked process of "
                         "its own (one fake group per process)")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import runnable_cells

    if args.all:
        cells = runnable_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = {"single": [False], "multi": [True], "both": [False, True],
              "one": [None]}[args.mesh]

    torch.set_num_threads(1)  # fake tensors compute nothing
    os.makedirs(args.out, exist_ok=True)
    todo = []
    for arch, shape in cells:
        for multi in meshes:
            tag = (f"{arch}_{shape}_{_MESH_TAG[multi]}_{args.quant_mode}"
                   + (f"_rows{args.rows}" if args.rows else ""))
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (exists)")
                continue
            print(f"[run ] {tag}", flush=True)
            todo.append((arch, shape, multi, path))
    if args.jobs <= 1:
        for arch, shape, multi, path in todo:
            _write(path, _record(arch, shape, multi, args))
        return
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("fork")) as ex:
        runs = {ex.submit(_record, arch, shape, multi, args): path
                for arch, shape, multi, path in todo}
        for run in concurrent.futures.as_completed(runs):
            _write(runs[run], run.result())


if __name__ == "__main__":
    main()
