"""Meshes of ranks on ``torch.distributed`` (port of
``repro/launch/mesh.py``: ``make_host_mesh`` and ``make_production_mesh``).

JAX drives every device of a mesh from one controller; here each rank is
a process of its own, joined to one process group. A :class:`Mesh` is one
rank's view: the reference's ``shape`` and ``axis_names``, this process's
``rank`` and its coordinate on each axis (``coords``), the group's
``size``, the ``device`` its shards live on, the whole group, and one
process group per axis (the ranks that differ only on that axis; for a
mesh with pods also the ``("pod", "data")`` batch group). Ranks are laid
out row-major over ``("pod", "data", "model")``, as ``jax.make_mesh``
lays out devices. NCCL joins ranks on CUDA devices (rank r on
``cuda:{local_rank}``), gloo on the CPU.

One mesh serves serving and training. Serving runs every rank on the
``model`` axis: ``ServeEngine`` refuses a ``data`` axis larger than 1 in
the reference's words (:func:`check_serving_mesh`). Training stores
params and moments sharded over both axes (``train/sharded.py``). Unlike
the reference, whose mesh takes the first ``data * model`` devices, a
mesh must take every rank: a rank outside it would have nothing to do.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 1,2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --data 2 \\
        --model 2
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "make_host_mesh", "make_production_mesh",
           "production_shape", "check_serving_mesh", "local_mesh",
           "coords_of", "axis_index", "all_gather", "barrier", "Placement"]

BATCH_AXES = ("pod", "data")
#: Backends that gather and reduce-scatter into one tensor: NCCL, and the
#: fake process group of the dry-run (``launch/dryrun.py``), which stands
#: in for the card's NCCL ranks; gloo gathers a list.
TENSOR_COLLECTIVES = ("nccl", "fake")


def coords_of(shape: dict, rank: int) -> dict:
    """The coordinate on each axis of ``rank`` in a row-major mesh of
    ``shape`` (axes in the dict's order, the last fastest)."""
    out = {}
    for ax in reversed(list(shape)):
        rank, out[ax] = divmod(rank, int(shape[ax]))
    return {ax: out[ax] for ax in shape}


def axis_index(mesh, axis) -> tuple[int, int]:
    """``(coordinate, size)`` of this rank along ``axis``: a mesh axis, a
    tuple of them (one row-major coordinate over the tuple, as a
    ``PartitionSpec`` entry ``("pod", "data")`` splits a dim) or None
    (``(0, 1)``). Works on any mesh with ``shape`` and ``rank``."""
    axes = () if axis is None else (
        axis if isinstance(axis, tuple) else (axis,))
    coords = coords_of(mesh.shape, mesh.rank)
    coord, size = 0, 1
    for ax in axes:
        coord = coord * int(mesh.shape[ax]) + coords[ax]
        size *= int(mesh.shape[ax])
    return coord, size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh over the process group."""

    shape: dict  # {"data": d, "model": m}, or with "pod" first
    rank: int
    size: int
    device: torch.device
    group: Any = None  # the torch.distributed process group
    axis_names: tuple = ("data", "model")
    # axis name, or the batch axes' tuple -> the process group of the
    # ranks that differ only there (None where that is this rank alone)
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group) if self.size > 1 else "none"

    @property
    def coords(self) -> dict:
        return coords_of(self.shape, self.rank)

    def group_of(self, axis):
        """The process group along ``axis`` (a name or the batch tuple),
        or None when no other rank lies along it."""
        if axis is None or axis_index(self, axis)[1] == 1:
            return None
        return self.groups[axis]


def local_mesh(device) -> Mesh:
    """The one-device mesh (data 1, model 1) of a single process on
    ``device``, joining no process group."""
    return Mesh(shape={"data": 1, "model": 1}, rank=0, size=1,
                device=torch.device(device))


def check_serving_mesh(mesh) -> None:
    """The serving layout shards over ``model`` and keeps the slot batch
    whole on every device: a multi-way ``data`` axis would place every
    "replicated" leaf wrong silently, so it is refused."""
    if mesh.shape.get("data", 1) > 1:
        raise ValueError(
            f"ServeEngine assumes a serving mesh with a trivial 'data' "
            f"axis (data=1); got data={mesh.shape['data']}. The slot "
            f"batch is not data-sharded — reshape the mesh so all "
            f"devices sit on the 'model' axis for tensor-parallel "
            f"serving.")


def _env_rank_world(rank, world_size) -> tuple[int, int]:
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else int(world_size))
    return rank, world


def _join(device, init_method, rank: int, world: int) -> torch.device:
    """Join (or reuse) the default process group; returns this rank's
    device: ``cuda:{LOCAL_RANK}`` where CUDA is present unless
    ``device`` says otherwise, NCCL on CUDA devices, gloo on the CPU."""
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = (torch.device("cuda", local) if torch.cuda.is_available()
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if init_method is None:
            init_method = "env://"
            os.environ.setdefault("MASTER_ADDR", "localhost")
            os.environ.setdefault("MASTER_PORT", "29500")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    return device


def _axis_groups(shape: dict, rank: int) -> dict:
    """One process group per axis (and per batch-axes tuple with pods):
    every group of the mesh is made, in one order on every rank, as
    ``dist.new_group`` requires; this rank keeps the one it lies in."""
    world = 1
    for n in shape.values():
        world *= int(n)
    keys = list(shape)
    if all(a in shape for a in BATCH_AXES):
        keys.append(BATCH_AXES)
    mine = coords_of(shape, rank)
    groups = {}
    for key in keys:
        along = key if isinstance(key, tuple) else (key,)
        n = 1
        for ax in along:
            n *= int(shape[ax])
        if n == 1:
            groups[key] = None
            continue
        if n == world:
            groups[key] = dist.group.WORLD
            continue
        others = [ax for ax in shape if ax not in along]
        for fixed in itertools.product(*(range(int(shape[ax]))
                                         for ax in others)):
            ranks = [r for r in range(world)
                     if all(coords_of(shape, r)[ax] == c
                            for ax, c in zip(others, fixed))]
            group = dist.new_group(ranks)
            if all(mine[ax] == c for ax, c in zip(others, fixed)):
                groups[key] = group
    return groups


def make_mesh(shape: dict, *, device: Optional[torch.device] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """Join (or reuse) the default process group and return this rank's
    :class:`Mesh` of ``shape`` (axes in order, e.g. ``{"pod": 2, "data":
    2, "model": 1}``). Rank and world size come from the arguments, else
    from ``RANK``/``WORLD_SIZE`` (torchrun's environment; a lone process
    is rank 0 of 1). The mesh must take every rank."""
    rank, world = _env_rank_world(rank, world_size)
    device = _join(device, init_method, rank, world)
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = {ax: int(n) for ax, n in shape.items()}
    cells = 1
    for n in shape.values():
        cells *= n
    if cells != world:
        raise ValueError(f"a mesh of {shape} takes {cells} ranks, not every "
                         f"one of the {world} ranks")
    return Mesh(shape=shape, rank=rank, size=world, device=device,
                group=dist.group.WORLD, axis_names=tuple(shape),
                groups=_axis_groups(shape, rank))


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: Optional[torch.device] = None,
                   init_method: Optional[str] = None,
                   rank: Optional[int] = None,
                   world_size: Optional[int] = None) -> Mesh:
    """A ``(data, model)`` mesh over the ranks there are, clamped as the
    reference clamps it to the devices: ``data = min(data, n)``, then
    ``model = min(model, n // data)``. Serving and training both use it;
    ``ServeEngine`` refuses a data axis."""
    _, world = _env_rank_world(rank, world_size)
    if dist.is_initialized():
        world = dist.get_world_size()
    data = max(1, min(int(data), world))
    model = max(1, min(int(model), world // data))
    return make_mesh({"data": data, "model": model}, device=device,
                     init_method=init_method, rank=rank,
                     world_size=world_size)


def production_shape(multi_pod: bool = False) -> dict:
    """The production topology: a pod of 16 x 16 (data, model), or two
    along a leading ``pod`` axis (data parallel across pods only)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[torch.device] = None,
                         init_method: Optional[str] = None) -> Mesh:
    """The production mesh over torchrun's ranks (256, or 512 with
    ``multi_pod``); refused before joining any group when ``WORLD_SIZE``
    is another count."""
    shape = production_shape(multi_pod)
    need = 1
    for n in shape.values():
        need *= n
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != need:
        raise ValueError(f"the production mesh {shape} takes {need} ranks; "
                         f"WORLD_SIZE is {world}")
    return make_mesh(shape, device=device, init_method=init_method)


def all_gather(t: torch.Tensor, dim: int, mesh, axis=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in coordinate order
    (the same on every rank): over the whole group, or along ``axis``.
    NCCL (and the dry-run's fake group) gathers into one tensor; gloo
    gathers a list and concatenates it."""
    if axis is None:
        group, n = mesh.group, mesh.size
    else:
        group, n = mesh.group_of(axis), axis_index(mesh, axis)[1]
    if n == 1:
        return t
    dim = dim % t.dim()
    if mesh.backend in TENSOR_COLLECTIVES:
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * moved.shape[0],) + moved.shape[1:],
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, moved, group=group)
        return out.movedim(0, dim).contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf's place on the mesh: its ``spec`` and the mesh. Calling it
    on a whole array (a tensor, or a numpy array, memory-mapped or not)
    returns this rank's slice as a tensor on ``mesh.device``: only the
    local rows of a memory-mapped ``.npy`` are ever read. A dim named by
    an axis (or a tuple of axes) is cut by this rank's coordinate along
    it; :meth:`gather` is the inverse, every rank's slices made whole."""

    spec: tuple
    mesh: Any

    def __call__(self, arr):
        idx = []
        for dim, ax in enumerate(self.spec):
            if ax is None:
                idx.append(slice(None))
                continue
            coord, ways = axis_index(self.mesh, ax)
            n = arr.shape[dim] // ways
            idx.append(slice(coord * n, (coord + 1) * n))
        part = arr[tuple(idx)] if idx else arr
        if isinstance(part, torch.Tensor):
            return part.to(self.mesh.device).contiguous()
        # a copy of the rows only: a mapped file stays read-only
        return torch.from_numpy(np.array(part, order="C")).to(
            self.mesh.device)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from this rank's slice (a collective: every
        rank of the mesh calls it, in the same order)."""
        for dim, ax in enumerate(self.spec):
            if ax is not None:
                local = all_gather(local, dim, self.mesh, axis=ax)
        return local


def barrier(mesh) -> None:
    """Every rank of ``mesh`` meets here (a one-element all-reduce on the
    mesh's device, which NCCL and gloo both take)."""
    if mesh.size > 1:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)
