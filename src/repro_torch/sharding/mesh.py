"""The process world and its device meshes.

``init_world`` starts ``torch.distributed`` over a ``FileStore`` in a
directory every rank can reach (no TCP port: the machines this runs on
have no network), with NCCL for CUDA and gloo for the CPU.  ``make_mesh``
is the counterpart of the reference's ``default_make_mesh``
(``repro/train/elastic.py:49-53``): a ``DeviceMesh`` over ranks
[0, ranks) of that world, the whole world when it has fewer.

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


def default_backend(device) -> str:
    """The backend of a world whose state lies on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(rank: int, world: int, backend: str, store_dir) -> None:
    """Join the process world as ``rank`` of ``world`` through a
    ``FileStore`` under ``store_dir``; ``backend`` "nccl" (CUDA: rank r
    takes card r) or "gloo" (CPU)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA card")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    Path(store_dir).mkdir(parents=True, exist_ok=True)
    store = dist.FileStore(os.path.join(str(store_dir), "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)


def world_device_type() -> str:
    """The device type of the initialised world's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(ranks: int, axis_names: Sequence[str] = ("data",)):
    """A one-axis ``DeviceMesh`` over ranks [0, n) of the initialised
    world, n = min(ranks, world size), named ``axis_names``.  On NCCL the
    mesh is of CUDA devices: the state it holds never lands on the
    CPU."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(init_world)")
    n = min(int(ranks), dist.get_world_size())
    return DeviceMesh(world_device_type(), torch.arange(n),
                      mesh_dim_names=tuple(axis_names))
