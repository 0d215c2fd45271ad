"""The serving mesh on ``torch.distributed`` (port of
``repro/launch/mesh.py:make_host_mesh``).

JAX drives every device of a mesh from one controller; here each rank is
a process of its own, joined to one process group. :func:`make_host_mesh`
joins the group (from torchrun's environment, or an explicit
``init_method`` such as a ``file://`` store) and returns a small
:class:`Mesh`: the reference's ``shape`` and ``axis_names``, plus this
process's ``rank``, the group's ``size``, the ``device`` its shards live on
and the process group. NCCL joins ranks on CUDA devices (rank r on
``cuda:{local_rank}``), gloo on the CPU.

Serving runs every rank on the ``model`` axis; a ``data`` axis larger than
1 is refused in the reference's words (the slot batch is not
data-sharded). Training runs on one device (:func:`local_mesh`).

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 1,2
"""
from __future__ import annotations

import dataclasses
import os
import types
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_host_mesh", "check_serving_mesh", "local_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``(data, model)`` mesh over the process
    group."""

    shape: dict  # {"data": d, "model": m}
    rank: int
    size: int
    device: torch.device
    group: Any = None  # the torch.distributed process group
    axis_names: tuple = ("data", "model")

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group) if self.size > 1 else "none"


def local_mesh(device) -> Mesh:
    """The one-device mesh (data 1, model 1) of a single process on
    ``device``, joining no process group: the training launcher's."""
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


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: Optional[torch.device] = None,
                   init_method: Optional[str] = None,
                   rank: Optional[int] = None,
                   world_size: Optional[int] = None) -> Mesh:
    """Join (or reuse) the default process group and return this rank's
    :class:`Mesh`. Rank and world size come from the arguments, else from
    ``RANK``/``WORLD_SIZE`` (torchrun's environment; a lone process is
    rank 0 of 1). ``device`` defaults to ``cuda:{LOCAL_RANK}`` where CUDA
    is present, else the CPU; NCCL serves CUDA devices, gloo the CPU.
    ``model`` is clamped to the ranks there are, as the reference clamps
    it to the devices; every rank must sit on the mesh."""
    if data > 1:
        check_serving_mesh(types.SimpleNamespace(shape={"data": data}))
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else int(world_size))
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
    world = dist.get_world_size()
    model = max(1, min(int(model), world))
    if model != world:
        raise ValueError(f"a serving mesh takes every rank: model={model} "
                         f"of {world} ranks")
    return Mesh(shape={"data": 1, "model": model}, rank=dist.get_rank(),
                size=world, device=device, group=dist.group.WORLD)
