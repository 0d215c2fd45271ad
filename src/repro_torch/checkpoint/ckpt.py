"""Checkpoints in the reference's on-disk layout (port of
``repro/checkpoint/ckpt.py``: save, async save, template and template-free
restore).

Layout per checkpoint, byte for byte the reference's:

    <dir>/step_00000123/
        meta.json          step, leaf paths, shapes, dtypes, QTensor metas
        <leafpath>.npy     one file per leaf, path keys joined by "__"
        <leafpath>__Q__<key>.npy   one file per packed array of a QTensor
        _COMMITTED         marker written last

A save writes into ``step_N.tmp`` and renames it only after every leaf and
the marker are written, so a crashed save is never taken for a checkpoint
(restore reads only directories holding ``_COMMITTED``). Leaves are walked
as JAX flattens a tree: a dict in sorted key order, a dataclass
(``TrainState``, ``OptState``) in field order, a QTensor's arrays in sorted
key order; so a tree saved here and the same tree saved by the reference
give the same files, and either side restores the other's. A QTensor's
:class:`~repro_torch.core.quantize.QMeta` travels in ``meta.json``, so
:func:`restore_tree` rebuilds a servable quantized tree from a bare
directory with no template: quantize -> save -> serve never runs
Algorithm 1 twice, and :func:`restore` rebuilds a saved QTensor even where
its template holds the fp weight.

:func:`save_async` (the training loop's) blocks only for the copy to host
memory and writes on a daemon thread; :func:`wait_pending` joins every
write still running.

On a mesh of ranks (``shardings``: a tree of
:class:`~repro_torch.launch.mesh.Placement` matching the tree, as
``train/sharded.py:placements`` gives it) a save gathers each leaf to
whole size, one leaf at a time (a collective: every rank calls it), and
rank 0 writes the files a single process writes; every rank then meets at
a barrier (for :func:`save_async`, in :func:`wait_pending`), so no rank
sees the step before it is committed. A restore reads each rank's rows of
each mapped ``.npy`` through its placement: resuming onto a mesh of
another shape (elastic) is the same path as a plain resume.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.quantize import QMeta, QTensor
from repro_torch.launch.mesh import Placement, barrier

__all__ = ["save", "save_async", "wait_pending", "latest_step", "restore",
           "restore_tree", "restore_params"]

_SEP = "__"
_QMARK = _SEP + "Q" + _SEP  # <leafpath>__Q__<datakey>.npy
# (the writer thread, or None on a mesh rank that writes nothing; the mesh)
_pending: list[tuple[Optional[threading.Thread], Any]] = []


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):  # a host snapshot (save_async)
        return t
    if t.dtype == torch.bfloat16:
        raise TypeError("bf16 leaves have no numpy dtype here; save them as "
                        "f32 or fp16")
    return t.detach().cpu().numpy()


def _children(tree) -> Optional[list]:
    """``[(key, child)]`` of an inner node in JAX's flatten order (a dict
    sorted, a dataclass by field), None for a leaf or a QTensor."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if (dataclasses.is_dataclass(tree) and not isinstance(tree, type)
            and not isinstance(tree, QTensor)):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _path(prefix: str, key: str) -> str:
    return f"{prefix}{_SEP}{key}" if prefix else key


def _flatten(tree, prefix: str = "", flat=None, qmetas=None, place=None):
    """Path-flatten ``tree`` in JAX's order into ``{key: (leaf,
    placement)}`` (the placement from the parallel tree ``place``, None
    without one); QTensor leaves expand to their packed arrays plus a
    JSON-able meta record."""
    flat = {} if flat is None else flat
    qmetas = {} if qmetas is None else qmetas
    children = _children(tree)
    if isinstance(tree, QTensor):
        keys = sorted(tree.data)
        qmetas[prefix] = {"meta": tree.meta.to_dict(), "keys": keys}
        for dkey in keys:
            flat[prefix + _QMARK + dkey] = (tree.data[dkey], None)
    elif children is not None:
        places = dict(_children(place)) if place is not None else {}
        for k, child in children:
            _flatten(child, _path(prefix, k), flat, qmetas, places.get(k))
    else:
        flat[prefix] = (tree, place)
    return flat, qmetas


def _mesh_of(shardings):
    """The mesh of a tree of placements (None for no tree)."""
    if shardings is None:
        return None
    if isinstance(shardings, Placement):
        return shardings.mesh
    return next(m for m in (_mesh_of(c) for _, c in _children(shardings))
                if m is not None)


def _whole(leaf, place) -> np.ndarray:
    """A leaf as a whole host array (gathered over the mesh first when it
    has a placement)."""
    if place is not None:
        leaf = place.gather(leaf)
    return _to_numpy(leaf if isinstance(leaf, np.ndarray)
                     else torch.as_tensor(leaf))


def _to_host(tree, place=None, keep: bool = True):
    """A copy of ``tree`` with every tensor a host numpy array of its own
    (dicts, dataclasses and QTensors rebuilt around them), each leaf with
    a placement in ``place`` gathered whole first. ``keep=False`` (a mesh
    rank that writes nothing) takes part in the gathers and keeps
    nothing."""
    if isinstance(tree, QTensor):
        return QTensor({k: _to_host(v) for k, v in tree.data.items()},
                       tree.meta)
    children = _children(tree)
    if children is not None:
        places = dict(_children(place)) if place is not None else {}
        host = {k: _to_host(v, places.get(k), keep) for k, v in children}
        if isinstance(tree, dict):
            return host
        return dataclasses.replace(tree, **host)
    if place is not None:
        tree = place.gather(tree)
    if not keep:
        return None
    if isinstance(tree, torch.Tensor):
        return _to_numpy(tree.detach().to("cpu", copy=True))
    return np.array(tree)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         shardings=None) -> str:
    """Write ``tree`` (nested dicts and dataclasses of tensors, numpy
    arrays and QTensors) as checkpoint ``step``; keeps the ``keep`` newest
    committed steps. Returns its path. ``shardings``: the tree's
    placements on a mesh (every rank calls it; rank 0 writes; all meet at
    a barrier before it returns)."""
    mesh = _mesh_of(shardings)
    writer = mesh is None or mesh.rank == 0
    flat, qmetas = _flatten(tree, place=shardings)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(tmp, exist_ok=True)
    meta: dict[str, Any] = {"step": step, "leaves": {}, "qtensors": qmetas}
    for key, (leaf, place) in flat.items():
        arr = _whole(leaf, place)  # one leaf on the device at a time
        if writer:
            np.save(os.path.join(tmp, key + ".npy"), arr)
            meta["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    if writer:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)
    if mesh is not None:
        barrier(mesh)
    return final


def save_async(ckpt_dir: str, step: int, tree, *, keep: int = 3,
               shardings=None) -> Optional[threading.Thread]:
    """Snapshot ``tree`` to host memory (the one blocking part: the
    device-to-host copies, and on a mesh the gathers), then :func:`save`
    it on a daemon thread. Returns the thread (None on a mesh rank that
    writes nothing); :func:`wait_pending` joins it."""
    mesh = _mesh_of(shardings)
    writer = mesh is None or mesh.rank == 0
    host = _to_host(tree, shardings, keep=writer)
    th = None
    if writer:
        th = threading.Thread(target=save, args=(ckpt_dir, step, host),
                              kwargs={"keep": keep}, daemon=True)
        th.start()
    _pending.append((th, mesh))
    return th


def wait_pending() -> None:
    """Join every :func:`save_async` write still running; on a mesh every
    rank then meets at a barrier per save (every rank calls it)."""
    while _pending:
        th, mesh = _pending.pop()
        if th is not None:
            th.join()
        if mesh is not None:
            barrier(mesh)


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in sorted(_committed_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _committed_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(name[5:]) for name in os.listdir(ckpt_dir)
            if name.startswith("step_") and not name.endswith(".tmp")
            and os.path.exists(os.path.join(ckpt_dir, name, "_COMMITTED"))]


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(ckpt_dir)
    return max(steps) if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> tuple[str, int]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step:08d}"), step


def _load_qtensor(d: str, key: str, rec: dict, device) -> QTensor:
    return QTensor({k: torch.from_numpy(np.load(
        os.path.join(d, key + _QMARK + k + ".npy"))).to(device)
        for k in rec["keys"]}, QMeta.from_dict(rec["meta"]))


def _mapped(d: str, key: str) -> np.ndarray:
    """A leaf's ``.npy`` memory-mapped (read whole where it cannot be)."""
    path = os.path.join(d, key + ".npy")
    try:
        return np.load(path, mmap_mode="r")
    except ValueError:  # an empty array has nothing to map
        return np.load(path)


def restore(ckpt_dir: str, template, *, step: Optional[int] = None,
            device=None, shardings=None):
    """Rebuild a ``template``-shaped tree (dicts, dataclasses, tensors,
    QTensors) from checkpoint ``step`` (default: the latest). A leaf takes
    its template's dtype and goes to ``device`` (default: the template
    leaf's). A leaf saved as a QTensor is rebuilt as a QTensor (its QMeta
    from ``meta.json``) whether the template holds one or the fp weight.
    ``shardings``: a tree of placements matching ``template`` (whose
    leaves are then this rank's slices): each leaf is read as this rank's
    rows of its mapped file, onto the placement's device; a QTensor's
    arrays each through the placement at its slot. Returns ``(tree,
    step)``."""
    d, step = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "meta.json")) as f:
        qmetas = json.load(f).get("qtensors", {})

    def build(node, key: str, place):
        dev = device
        if key in qmetas:
            rec = qmetas[key]
            if place is not None:
                return QTensor({k: place(_mapped(d, key + _QMARK + k))
                                for k in rec["keys"]},
                               QMeta.from_dict(rec["meta"]))
            if dev is None:
                dev = (next(iter(node.data.values())).device
                       if isinstance(node, QTensor) else node.device)
            return _load_qtensor(d, key, rec, dev)
        children = _children(node)
        if children is not None:
            places = dict(_children(place)) if place is not None else {}
            built = {k: build(c, _path(key, k), places.get(k))
                     for k, c in children}
            if isinstance(node, dict):
                return built
            return dataclasses.replace(node, **built)
        if place is not None:
            return place(_mapped(d, key)).to(dtype=node.dtype)
        arr = torch.from_numpy(np.load(os.path.join(d, key + ".npy")))
        return arr.to(device=node.device if dev is None else dev,
                      dtype=node.dtype)

    return build(template, "", shardings), step


def restore_tree(ckpt_dir: str, *, step: Optional[int] = None,
                 device="cuda", shardings=None) -> tuple[dict, int]:
    """Template-free restore: rebuild the nested-dict tree from
    ``meta.json``, QTensor leaves from their packed arrays and stored
    QMeta, every array on ``device``. Returns ``(tree, step)``.

    ``shardings``, when given, is a callable ``(dotted_key, leaf) ->
    placement`` consulted per leaf as it loads (restore-to-sharding, the
    callback of :func:`repro_torch.serve.tp.restore_shardings`). ``leaf``
    is the leaf over memory-mapped arrays (a QTensor of them, or one), so
    the callback sees shapes without a read. A placement is a callable
    taking a whole array and returning this rank's slice as a tensor on
    its device; for a QTensor leaf, a dict of them keyed like its
    ``data``. Only the rows a placement takes are read off disk. None
    loads the leaf whole onto ``device``."""
    d, step = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    qmetas = meta.get("qtensors", {})

    def load(arr: np.ndarray) -> torch.Tensor:
        # a copy: the mapped file stays read-only and unshared
        return torch.from_numpy(np.array(arr, order="C")).to(device)

    def place(key: str, leaf):
        shard = (None if shardings is None
                 else shardings(key.replace(_SEP, "."), leaf))
        if isinstance(leaf, QTensor):
            per = shard if isinstance(shard, dict) else {
                k: shard for k in leaf.data}
            return QTensor({k: load(v) if per[k] is None else per[k](v)
                            for k, v in leaf.data.items()}, leaf.meta)
        return load(leaf) if shard is None else shard(leaf)

    tree: dict[str, Any] = {}

    def insert(key: str, value) -> None:
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for key, rec in qmetas.items():
        insert(key, place(key, QTensor(
            {k: _mapped(d, key + _QMARK + k) for k in rec["keys"]},
            QMeta.from_dict(rec["meta"]))))
    owned = {k + _QMARK + dk for k, rec in qmetas.items()
             for dk in rec["keys"]}
    for key in meta["leaves"]:
        if key not in owned:
            insert(key, place(key, _mapped(d, key)))
    return tree, step


def restore_params(ckpt_dir: str, *, step: Optional[int] = None,
                   device="cuda", shardings=None) -> tuple[dict, int]:
    """Template-free restore of a servable params tree: a bare params
    checkpoint as it is, a train-state checkpoint unwrapped to its
    ``params`` member. The serve launcher's way to boot from disk.
    ``shardings``: the per-leaf placement callable of :func:`restore_tree`
    (dotted keys keep a train state's leading ``params.``; the callable of
    ``serve/tp.py`` strips it)."""
    tree, step = restore_tree(ckpt_dir, step=step, device=device,
                              shardings=shardings)
    if "params" in tree:
        tree = tree["params"]
    return tree, step
