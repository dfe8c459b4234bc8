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

A plain tensor is one part (the whole tensor).  A ``DTensor`` leaf (a
tensor sharded or replicated over a ``DeviceMesh``) is the parts of the
distinct boxes of its sharding, replicas deduplicated, the twin of the
reference's ``_device_parts`` (``repro/core/snapshot.py:80-110``).  The
iCheck client lives in rank 0 of the process world, as the reference's
single controller holds it: every rank of a DTensor leaf's mesh calls
``snapshot_pytree`` together, each box's first holder sends it to rank 0
(a gather of the distinct shards only: with a replicated leaf rank 0
holds every box and no bytes move), and the snapshot is rank 0's; the
other ranks get None.  ``load_leaf_`` is the reverse: rank 0 assembles a
leaf from its fetched parts and sends each rank of the mesh its box (a
scatter), which lands in that rank's local shard.  Rank 0 is a rank of
every such mesh.  bfloat16 leaves
travel as their uint16 bit patterns (region dtype ``"uint16"``): the
service calls ``np.dtype(meta.dtype)`` throughout, and numpy knows no
bfloat16 without ``ml_dtypes``.  ``restore_pytree`` views the bits back
to the template's bfloat16.

With ``codec="q8"`` / ``"q8-delta"`` every float leaf is encoded on its
device before the device→host copy (``kernels/ckpt_codec``: the Hopper
kernels on CUDA tensors): int8 codes and one f32 scale per 256 values
cross the link instead of the raw leaf, and ``q8-delta`` XORs them against
the catalog's previous codes, which stay on the device between commits
(``DeltaState.codes_dev``).  Ints travel raw.  A bfloat16 leaf encoded
this way is recorded as ``float32``: its dequantized values are cast back
to the template's bfloat16 on restore (numpy names no bfloat16 here).

Every device→host copy has finished when ``snapshot_pytree`` returns, so
a caller may write into the snapshotted tensors in place from then on.
The device holds one leaf's codes and delta beyond its state at a time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import plan as planlib
from ..kernels.ckpt_codec import BLOCK, quantize, quantize_delta
from .tiers import (Q8_EMPTY_DELTA_NBYTES, DeltaState, EncodedRegion,
                    _q8_full_size, is_float_dtype, pack_q8_region,
                    q8_pack_delta, q8_pack_full)
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


# --------------------------------------------------------------------------
# DTensor leaves: boxes, and the gather / scatter through rank 0
# --------------------------------------------------------------------------
ROOT = 0     # the rank that holds the iCheck client


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def dtensor_sharding(leaf):
    """The ``NamedSharding`` of a DTensor's placements: array dim d split
    over the mesh axes that ``Shard(d)`` (major first)."""
    from ..sharding import NamedSharding

    mesh = leaf.device_mesh
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DTensor leaf's mesh needs named dims")
    axes: List[List[str]] = [[] for _ in range(leaf.dim())]
    for i, pl in enumerate(leaf.placements):
        if pl.is_shard():
            axes[pl.dim].append(names[i])
        elif not pl.is_replicate():
            raise ValueError(f"placement {pl} (partial) has no boxes")
    return NamedSharding(mesh, [None if not a else a[0] if len(a) == 1
                                else tuple(a) for a in axes])


def _layout(leaf) -> Tuple[Tuple[planlib.Box, ...], Dict[int, int]]:
    """(distinct boxes in canonical order, rank -> its box's index) of a
    DTensor leaf."""
    idx_map = dtensor_sharding(leaf).devices_indices_map(tuple(leaf.shape))
    box_of = {r: tuple((sl.start, sl.stop) for sl in idx)
              for r, idx in idx_map.items()}
    boxes = tuple(sorted(set(box_of.values())))   # as mesh_part_bounds
    index = {b: i for i, b in enumerate(boxes)}
    if ROOT not in box_of:
        raise ValueError(f"rank {ROOT} is not in the leaf's mesh")
    return boxes, {r: index[b] for r, b in sorted(box_of.items())}


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor point-to-point calls move: bfloat16 as its int16 bits."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _p2p_device(device: torch.device) -> torch.device:
    """Where a point-to-point call's buffer must lie: gloo moves only CPU
    tensors (a world of several ranks on one card runs gloo over CUDA
    tensors, ``sharding/mesh.py``), so a CUDA shard is staged through the
    host there."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else device


def _send(t: torch.Tensor, dst: int) -> None:
    dist.send(_wire(t.detach().contiguous().to(_p2p_device(t.device))),
              dst=dst)


def _recv_into(buf: torch.Tensor, src: int) -> None:
    """Receive a tensor of ``buf``'s shape and dtype into ``buf``."""
    at = _p2p_device(buf.device)
    if at == buf.device and buf.is_contiguous():
        dist.recv(_wire(buf), src=src)
        return
    host = torch.empty(buf.shape, dtype=buf.dtype, device=at)
    dist.recv(_wire(host), src=src)
    buf.copy_(host)


def _box_shape(box: planlib.Box) -> Tuple[int, ...]:
    return tuple(hi - lo for lo, hi in box)


def _device_parts(leaf) -> Tuple[Tuple[planlib.Box, ...], Dict[int, Any]]:
    """(boxes, part index -> tensor or array) of one leaf.  A DTensor's
    distinct shards are gathered to rank 0, from the first rank holding
    each box; other ranks return no parts."""
    if not is_dtensor(leaf):
        shape = tuple(np.shape(leaf))
        return (tuple((0, int(s)) for s in shape),), {0: leaf}
    boxes, part_of = _layout(leaf)
    owner: Dict[int, int] = {}
    for r, p in part_of.items():
        owner.setdefault(p, r)
    me, local = _rank(), leaf.to_local()
    parts: Dict[int, Any] = {}
    for p, r in sorted(owner.items()):
        if r == ROOT:
            if me == ROOT:
                parts[p] = local
        elif me == r:
            _send(local, ROOT)
        elif me == ROOT:
            buf = torch.empty(_box_shape(boxes[p]), dtype=local.dtype,
                              device=local.device)
            _recv_into(buf, r)
            parts[p] = buf
    return boxes, parts


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


def _np_dtype(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype numpy has (not bfloat16)."""
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _region_meta(name: str, shape, dtype: str, nbytes: int, boxes=None
                 ) -> Tuple[RegionMeta, Tuple[planlib.Box, ...]]:
    """The region of a leaf split into ``boxes`` (default: one part
    covering the whole leaf)."""
    if boxes is None:
        boxes = (tuple((0, int(s)) for s in shape),)
    desc = PartitionDesc(scheme=PartitionScheme.MESH, num_parts=len(boxes),
                         bounds=tuple(boxes))
    return RegionMeta(name=name, shape=tuple(int(s) for s in shape),
                      dtype=dtype, partition=desc, nbytes=nbytes), boxes


def describe_pytree(tree, step: int = 0) -> HostSnapshot:
    """The regions of ``tree`` as ``snapshot_pytree(codec="raw")`` would
    name, shape and split them, with no parts: registering regions needs
    no device→host copy, and no rank but the caller takes part."""
    regions: Dict[str, SnapshotRegion] = {}
    for path, leaf in _flatten(tree):
        name = _leaf_name(path)
        split = None
        if isinstance(leaf, torch.Tensor):
            dtype = "uint16" if leaf.dtype == torch.bfloat16 else \
                _np_dtype(leaf.dtype)
            shape, nbytes = leaf.shape, leaf.numel() * leaf.element_size()
            if is_dtensor(leaf):
                split = _layout(leaf)[0]
        else:
            arr = np.asarray(leaf)
            dtype, shape, nbytes = str(arr.dtype), arr.shape, arr.nbytes
        meta, boxes = _region_meta(name, shape, dtype, nbytes, split)
        regions[name] = SnapshotRegion(meta=meta, parts={}, boxes=boxes)
    return HostSnapshot(regions=regions, step=step)


def _chain_states(chain_lookup, name: str, num_parts: int,
                  part_sizes: Dict[int, int]):
    """Previous-codes state usable for a device-side delta encode of this
    region, or (None, None) when the next frame must be a keyframe."""
    if chain_lookup is None:
        return None, None
    rc = chain_lookup(name, num_parts)
    if rc is None:
        return None, None
    prev: Dict[int, DeltaState] = dict(rc.parts)
    for p, n in part_sizes.items():
        st = prev.get(p)
        nb = -(-max(n, 1) // BLOCK)
        if st is None or st.n != n or st.codes.shape[0] != nb:
            return None, None
    return prev, tuple(rc.chain)


def _is_float_leaf(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return is_float_dtype(np.asarray(leaf).dtype)


def _delta_row_nbytes() -> int:
    """Bytes one changed block adds to a delta frame, measured on the
    packer itself (``tiers.q8_pack_delta``) so the two cannot drift."""
    one = np.ones((1, BLOCK), np.int8)
    blob = q8_pack_delta(BLOCK, one, np.ones((1, 1), np.float32),
                         DeltaState(n=BLOCK, codes=np.zeros_like(one),
                                    scales=np.ones((1, 1), np.float32)))
    return len(blob) - Q8_EMPTY_DELTA_NBYTES


_DELTA_ROW_NBYTES = _delta_row_nbytes()


def _delta_is_smaller(d: torch.Tensor, s: torch.Tensor,
                      prev: DeltaState) -> bool:
    """``tiers.pack_q8_region``'s choice for one part, made on the device
    from the dense XOR delta ``d`` and the new scales ``s``: a sparse delta
    frame only when it is smaller than a keyframe.  A part that changed
    nearly everywhere then copies its codes, not its delta, and the host
    builds no delta frame only to drop it.  A block is changed when its
    codes or its scale moved, as ``tiers.q8_pack_delta`` counts it."""
    prev_scales = torch.from_numpy(np.ascontiguousarray(prev.scales[:, 0]))
    changed = torch.ne(d, 0).any(dim=1) | torch.ne(s[:, 0],
                                                   prev_scales.to(s.device))
    nnz = int(changed.sum())
    return Q8_EMPTY_DELTA_NBYTES + nnz * _DELTA_ROW_NBYTES < _q8_full_size(
        d.shape[0])


def _encode_part(leaf: torch.Tensor, prev: Optional[DeltaState]):
    """Encode one float part on its device and copy the result to the
    host: the XOR delta when its frame will be a delta, else the codes,
    and the scales.  Returns ((host delta or codes, host scales, device
    codes), whether the frame is a delta).

    The copies go to pageable host memory: pinned buffers for a whole
    state's codes would stay in PyTorch's host cache after every commit
    (tens of GB at full width)."""
    if prev is not None:
        st = prev
        prev_q = st.codes_dev
        if prev_q is None or prev_q.device != leaf.device:
            prev_q = torch.from_numpy(np.ascontiguousarray(st.codes)) \
                .to(leaf.device)
        d, s, q = quantize_delta(leaf, prev_q)
        # the new codes take the old ones' place on the device: the
        # catalog's state keeps its host codes, which are uploaded again
        # should this snapshot never be committed
        st.codes_dev = None
        del prev_q
        if _delta_is_smaller(d, s, st):
            # the dense int8 delta crosses the link (the host packs it
            # sparse); the new codes stay on the device for the next commit
            return (d.cpu(), s.cpu(), q), True
        return (q.cpu(), s.cpu(), q), False
    q, s = quantize(leaf)
    return (q.cpu(), s.cpu(), q), False


def snapshot_pytree(tree, step: int = 0, codec: str = "raw",
                    chain_lookup=None) -> HostSnapshot:
    """Snapshot a tree of tensors to host memory, one region per leaf.

    ``codec="q8"`` / ``"q8-delta"``: float leaves are quantized on their
    device before the copy; ``chain_lookup(name, num_parts)`` supplies the
    catalog's previous-codes state so ``q8-delta`` regions ship sparse
    XOR-delta frames (``ICheckClient.delta_chain_lookup``).  Non-float
    leaves always travel raw.  With DTensor leaves every rank of their
    meshes calls it; rank 0 gets the snapshot, the others None.
    """
    if codec not in ("raw", "q8", "q8-delta"):
        raise ValueError(f"unknown snapshot codec {codec!r}")
    encode = codec != "raw"
    root = _rank() == ROOT
    # 1) gather each leaf's distinct parts to rank 0; there, encode every
    #    float leaf's parts on its device and copy their codes (or
    #    deltas) and scales to the host, or copy a raw leaf's parts
    regions: Dict[str, SnapshotRegion] = {}
    with torch.no_grad():
        for path, leaf in _flatten(tree):
            name = _leaf_name(path)
            boxes, parts = _device_parts(leaf)
            if not root:
                continue
            if encode and _is_float_leaf(leaf):
                regions[name] = _encode_region(name, codec, leaf, boxes,
                                               parts, chain_lookup)
                continue
            host = {p: _to_host(a) for p, a in parts.items()}
            shape, arr = tuple(np.shape(leaf)), host[0]
            nbytes = int(np.prod(shape, dtype=np.int64)) * arr.itemsize
            meta, boxes = _region_meta(name, shape, str(arr.dtype), nbytes,
                                       boxes)
            regions[name] = SnapshotRegion(meta=meta, parts=host,
                                           boxes=boxes)
    return HostSnapshot(regions=regions, step=step) if root else None


def _encode_region(name: str, codec: str, leaf, boxes, parts,
                   chain_lookup) -> SnapshotRegion:
    """Encode one float leaf's parts on their device, then pack its wire
    frames (2)."""
    leaf = torch.as_tensor(leaf)
    sizes = {p: max(int(np.prod(_box_shape(boxes[p]), dtype=np.int64)), 1)
             for p in parts}
    prev = parent_chain = None
    if codec == "q8-delta":
        prev, parent_chain = _chain_states(chain_lookup, name, len(boxes),
                                           sizes)
    t0 = time.monotonic()
    outs, delta = {}, {}
    for p, a in parts.items():
        outs[p], delta[p] = _encode_part(torch.as_tensor(a),
                                         None if prev is None else prev[p])
    # one frame kind a region: delta frames only where every part takes
    # one, else keyframes (a part that shipped its delta ships its codes)
    if not all(delta.values()):
        for p in (p for p, d in delta.items() if d):
            outs[p] = (outs[p][2].cpu(), *outs[p][1:])
    delta = prev is not None and all(delta.values())
    return _gather_encoded(name, codec, {
        "sizes": sizes, "outs": outs, "prev": prev if delta else None,
        "parent_chain": parent_chain, "leaf": leaf, "boxes": boxes,
        "launch_s": time.monotonic() - t0})


def _gather_encoded(name: str, codec: str, w: dict) -> SnapshotRegion:
    """Finish one device-encoded region: codes from deltas (host XOR),
    frames through the shared packer."""
    t0 = time.monotonic()
    prev: Optional[Dict[int, DeltaState]] = w["prev"]
    qparts: Dict[int, Tuple[int, np.ndarray, np.ndarray]] = {}
    dev_codes = {}
    dense_deltas: Dict[int, np.ndarray] = {}
    for p, (d_or_q, s, q_dev) in w["outs"].items():
        a = d_or_q.numpy()
        scales = s.numpy()
        if prev is not None:
            # the kernel shipped the XOR delta; the full codes come from the
            # host's previous codes (the packer reuses the dense delta)
            codes = np.bitwise_xor(prev[p].codes, a)
            dense_deltas[p] = a
        else:
            codes = a
        qparts[p] = (w["sizes"][p], codes, scales)
        dev_codes[p] = q_dev
    leaf = w["leaf"]
    itemsize = leaf.element_size()
    raw_nbytes = sum(n * itemsize for n, _, _ in qparts.values())
    dtype = "float32" if leaf.dtype == torch.bfloat16 else \
        _np_dtype(leaf.dtype)
    if codec == "q8-delta":
        blobs, states, frame = pack_q8_region(qparts, prev,
                                              deltas=dense_deltas or None)
        for p, st in states.items():
            st.codes_dev = dev_codes.get(p)
        enc = EncodedRegion(codec=codec, blobs=blobs, states=states,
                            frame=frame, raw_nbytes=raw_nbytes,
                            parent_chain=w["parent_chain"],
                            encode_s=w["launch_s"] + time.monotonic() - t0)
    else:
        blobs = {p: q8_pack_full(n, codes, scales)
                 for p, (n, codes, scales) in qparts.items()}
        enc = EncodedRegion(codec=codec, blobs=blobs, states=None,
                            frame=None, raw_nbytes=raw_nbytes,
                            encode_s=w["launch_s"] + time.monotonic() - t0)
    meta, boxes = _region_meta(name, tuple(leaf.shape), dtype, raw_nbytes,
                               w["boxes"])
    meta.codec = codec
    return SnapshotRegion(meta=meta, parts={}, boxes=boxes, encoded=enc)


def _assemble(meta: RegionMeta, parts: Dict[int, np.ndarray]) -> np.ndarray:
    """The whole host array of a region from its fetched parts."""
    if meta.partition.scheme == PartitionScheme.MESH:
        boxes = meta.partition.bounds
        whole = tuple((0, s) for s in meta.shape)
        if len(parts) == 1 and boxes[next(iter(parts))] == whole:
            return next(iter(parts.values())).reshape(meta.shape)
        full = np.empty(meta.shape, dtype=np.dtype(meta.dtype))
        for idx, part in parts.items():
            dsl = tuple(slice(lo, hi) for lo, hi in boxes[idx])
            full[dsl] = part.reshape([hi - lo for lo, hi in boxes[idx]])
        return full
    ordered = [parts[i] for i in range(meta.partition.num_parts)]
    return planlib.assemble_array(ordered, meta.partition, meta.shape)


def _host_tensor(full: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` (bfloat16 from uint16 bits)."""
    full = np.require(full, requirements="C")    # keeps 0-d arrays 0-d
    if dtype == torch.bfloat16 and full.dtype == np.uint16:
        return torch.from_numpy(full.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(full).to(dtype)


def restore_pytree(template, regions: Dict[str, Dict[int, np.ndarray]],
                   region_meta: Dict[str, RegionMeta], device=None):
    """Rebuild a tree of tensors from fetched region parts.

    ``template`` gives the structure and each leaf's dtype (its tensors may
    lie on the ``meta`` device); leaves go to ``device``, or to the
    template leaf's device when that is not ``meta``.  Parts are
    reassembled through their recorded boxes.
    """
    def rebuild(name: str, leaf) -> torch.Tensor:
        out = _host_tensor(_assemble(region_meta[name], regions[name]),
                           leaf.dtype)
        target = device if device is not None else leaf.device
        if torch.device(target).type == "meta":
            raise ValueError(f"{name}: give a device for a meta template")
        return out.to(target)

    return _unflatten(template, rebuild)


def load_leaf_(name: str, leaf: torch.Tensor, meta: Optional[RegionMeta],
               parts: Optional[Dict[int, np.ndarray]]) -> None:
    """Copy one region's fetched parts, placed by ``meta``'s boxes, into
    ``leaf`` in place (shapes must agree).  A DTensor leaf's box of each
    rank of its mesh is sent there from rank 0, which alone passes
    ``meta`` and ``parts``; each rank writes its box into its local
    shard."""
    if not is_dtensor(leaf):
        full = _assemble(meta, parts)
        if tuple(full.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: restored shape {full.shape} != "
                             f"{tuple(leaf.shape)}")
        with torch.no_grad():
            leaf.copy_(_host_tensor(full, leaf.dtype))
        return
    idx_map = dtensor_sharding(leaf).devices_indices_map(tuple(leaf.shape))
    local = leaf.to_local()
    with torch.no_grad():
        if _rank() != ROOT:
            _recv_into(local, ROOT)
            return
        full = _assemble(meta, parts)
        if tuple(full.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: restored shape {full.shape} != "
                             f"{tuple(leaf.shape)}")
        for r, box in sorted(idx_map.items()):
            t = _host_tensor(np.asarray(full[box]), local.dtype)
            if r == ROOT:
                local.copy_(t)
            else:
                _send(t.to(_p2p_device(local.device)), r)


def load_pytree_(tree, regions: Dict[str, Dict[int, np.ndarray]],
                 region_meta: Dict[str, RegionMeta]):
    """Copy fetched region parts into the tensors of ``tree`` in place
    (shapes must agree), one leaf at a time: the device holds no second
    copy of the state.  A region's host parts are released once copied.
    Returns ``tree``."""
    for path, leaf in _flatten(tree):
        name = _leaf_name(path)
        load_leaf_(name, leaf, region_meta[name], regions.pop(name))
    return tree
