"""Device→host snapshots of PyTorch state trees.

The bridge between a PyTorch application's tensors and iCheck's
byte-oriented agents, the twin of ``repro/core/snapshot.py``: every leaf
of a tree of dicts, lists and NamedTuples becomes a *region* named by its
``/``-joined path, exactly as the reference names the leaves of the same
JAX pytree:

* dict keys are walked in sorted order, as JAX flattens dicts;
* NamedTuple fields appear under their field names;
* ``None`` fields and empty lists produce no leaf;
* a 0-d tensor becomes a region of shape ``()``.

On one device a leaf is one part (the whole tensor).  bfloat16 leaves
travel as their uint16 bit patterns (region dtype ``"uint16"``): the
service calls ``np.dtype(meta.dtype)`` throughout, and numpy knows no
bfloat16 without ``ml_dtypes``.  ``restore_pytree`` views the bits back
to the template's bfloat16.

The device→host copy is synchronous (``Tensor.cpu``), so a caller may
write into the snapshotted tensors in place as soon as this returns.

Only the ``raw`` codec is ported; the on-device q8 / q8-delta encode comes
with the training slice and its codec kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import plan as planlib
from .tiers import EncodedRegion
from .types import PartitionDesc, PartitionScheme, RegionMeta


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _flatten(v, path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, tree


def _unflatten(template, fn, path: Tuple[str, ...] = ()):
    """Rebuild ``template``'s structure with ``fn(name, leaf)`` at each
    leaf."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, fn, path + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, fn, path + (name,))
                                for name, v in zip(template._fields,
                                                   template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, fn, path + (str(i),))
                              for i, v in enumerate(template))
    return fn(_leaf_name(path), template)


def _leaf_name(path: Tuple[str, ...]) -> str:
    return "/".join(path) or "leaf"


@dataclasses.dataclass
class SnapshotRegion:
    meta: RegionMeta
    parts: Dict[int, np.ndarray]          # part index -> host array
    boxes: Tuple[planlib.Box, ...]        # global boxes, canonical order
    encoded: Optional[EncodedRegion] = None


@dataclasses.dataclass
class HostSnapshot:
    regions: Dict[str, SnapshotRegion]
    step: int = 0

    def total_bytes(self) -> int:
        """Bytes held on the host (raw parts + encoded wire frames)."""
        total = 0
        for r in self.regions.values():
            total += sum(p.nbytes for p in r.parts.values())
            if r.encoded is not None:
                total += sum(len(b) for b in r.encoded.blobs.values())
        return total


def leaf_names(tree) -> List[str]:
    return [_leaf_name(path) for path, _ in _flatten(tree)]


def _to_host(leaf) -> np.ndarray:
    """Host numpy copy of one leaf; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def snapshot_pytree(tree, step: int = 0, codec: str = "raw") -> HostSnapshot:
    """Snapshot a tree of tensors to host memory, one region per leaf."""
    if codec != "raw":
        raise NotImplementedError(
            f"codec {codec!r}: the on-device q8 encode comes with the "
            f"training slice (codec kernels K1-K3)")
    regions: Dict[str, SnapshotRegion] = {}
    for path, leaf in _flatten(tree):
        name = _leaf_name(path)
        arr = _to_host(leaf)
        boxes = (tuple((0, s) for s in arr.shape),)
        desc = PartitionDesc(scheme=PartitionScheme.MESH, num_parts=1,
                             bounds=boxes)
        meta = RegionMeta(name=name, shape=tuple(arr.shape),
                          dtype=str(arr.dtype), partition=desc,
                          nbytes=arr.nbytes)
        regions[name] = SnapshotRegion(meta=meta, parts={0: arr}, boxes=boxes)
    return HostSnapshot(regions=regions, step=step)


def restore_pytree(template, regions: Dict[str, Dict[int, np.ndarray]],
                   region_meta: Dict[str, RegionMeta], device=None):
    """Rebuild a tree of tensors from fetched region parts.

    ``template`` gives the structure and each leaf's dtype (its tensors may
    lie on the ``meta`` device); leaves go to ``device``, or to the
    template leaf's device when that is not ``meta``.  Parts are
    reassembled through their recorded boxes.
    """
    def rebuild(name: str, leaf) -> torch.Tensor:
        meta = region_meta[name]
        parts = regions[name]
        if meta.partition.scheme == PartitionScheme.MESH:
            boxes = meta.partition.bounds
            full = np.empty(meta.shape, dtype=np.dtype(meta.dtype))
            for idx, part in parts.items():
                dsl = tuple(slice(lo, hi) for lo, hi in boxes[idx])
                full[dsl] = part.reshape([hi - lo for lo, hi in boxes[idx]])
        else:
            ordered = [parts[i] for i in range(meta.partition.num_parts)]
            full = planlib.assemble_array(ordered, meta.partition, meta.shape)
        if leaf.dtype == torch.bfloat16 and full.dtype == np.uint16:
            out = torch.from_numpy(full.view(np.int16)).view(torch.bfloat16)
        else:
            out = torch.from_numpy(full).to(leaf.dtype)
        target = device if device is not None else leaf.device
        if torch.device(target).type == "meta":
            raise ValueError(f"{name}: give a device for a meta template")
        return out.to(target)

    return _unflatten(template, rebuild)
