"""The process world and its device meshes.

``init_world`` starts ``torch.distributed`` over a ``FileStore`` in a
directory every rank can reach (no TCP port: the machines this runs on
have no network): NCCL for CUDA with one card a rank, gloo for the CPU,
and gloo over CUDA tensors (``"cuda:gloo"``) for a world of several ranks
on one card, which NCCL refuses (it rejects two ranks on one device).
Gloo stages each CUDA collective through the host, and offers
``all_reduce`` and ``broadcast`` on CUDA tensors; its point-to-point calls
take CPU tensors only (``core/snapshot.py`` stages them).

``make_mesh`` is the counterpart of the reference's ``default_make_mesh``
(``repro/train/elastic.py:49-53``): a ``DeviceMesh`` over ranks [0, n) of
that world, the whole world when it has fewer; ``make_tp_mesh`` lays
``data * model`` ranks out as a ("data", "model") mesh, "model" minor, as
the reference's ``Mesh`` reshapes its devices.

Every rank of the world calls ``make_mesh`` together (a mesh over part of
the world creates a process group, which all ranks take part in); a rank
outside the mesh gets the same object, whose ``get_coordinate()`` is None.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo", "cuda:gloo")
_DEVICE_TYPE: list = []      # the initialised world's device type


def default_backend(device) -> str:
    """The backend of a world whose state lies on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(rank: int, world: int, backend: str, store_dir) -> None:
    """Join the process world as ``rank`` of ``world`` through a
    ``FileStore`` under ``store_dir``; ``backend`` "nccl" (CUDA: rank r
    takes card r, one card a rank), "gloo" (CPU) or "cuda:gloo" (CUDA
    tensors over gloo: rank r takes card r % count, so several ranks may
    share one card)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend != "gloo":
        if not torch.cuda.is_available():
            raise RuntimeError(f"the {backend} backend needs a CUDA card")
        count = torch.cuda.device_count()
        if backend == "nccl" and world > count:
            raise ValueError(f"NCCL takes one card a rank: {world} ranks on "
                             f"{count} card(s); use 'cuda:gloo'")
        torch.cuda.set_device(rank % count)
    Path(store_dir).mkdir(parents=True, exist_ok=True)
    store = dist.FileStore(os.path.join(str(store_dir), "store"), world)
    dist.init_process_group("nccl" if backend == "nccl" else "gloo",
                            store=store, rank=rank, world_size=world)
    _DEVICE_TYPE[:] = ["cpu" if backend == "gloo" else "cuda"]


def world_device_type() -> str:
    """The device type of the initialised world's tensors."""
    if _DEVICE_TYPE:
        return _DEVICE_TYPE[0]
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(ranks: int, axis_names: Sequence[str] = ("data",)):
    """A one-axis ``DeviceMesh`` over ranks [0, n) of the initialised
    world, n = min(ranks, world size), named ``axis_names``.  On a CUDA
    world the mesh is of CUDA devices: the state it holds never lands on
    the CPU."""
    n = min(int(ranks), _world_size())
    return _mesh(torch.arange(n), axis_names)


def make_tp_mesh(data: int, model: int):
    """A ("data", "model") ``DeviceMesh`` over ranks [0, data * model) of
    the initialised world, "model" minor: rank r sits at (r // model,
    r % model), as the reference's ``Mesh`` lays out its devices."""
    n = int(data) * int(model)
    if n > _world_size():
        raise ValueError(f"a {data} x {model} mesh in a world of "
                         f"{_world_size()}")
    return _mesh(torch.arange(n).reshape(int(data), int(model)),
                 ("data", "model"))


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(init_world)")
    return dist.get_world_size()


def _mesh(layout: torch.Tensor, axis_names: Sequence[str]):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(world_device_type(), layout,
                      mesh_dim_names=tuple(axis_names))
