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


def _region_meta(name: str, shape, dtype: str, nbytes: int
                 ) -> Tuple[RegionMeta, Tuple[planlib.Box, ...]]:
    """One part covering the whole leaf (one device)."""
    boxes = (tuple((0, int(s)) for s in shape),)
    desc = PartitionDesc(scheme=PartitionScheme.MESH, num_parts=1,
                         bounds=boxes)
    return RegionMeta(name=name, shape=tuple(int(s) for s in shape),
                      dtype=dtype, partition=desc, nbytes=nbytes), boxes


def describe_pytree(tree, step: int = 0) -> HostSnapshot:
    """The regions of ``tree`` as ``snapshot_pytree(codec="raw")`` would
    name and shape them, with no parts: registering regions needs no
    device→host copy."""
    regions: Dict[str, SnapshotRegion] = {}
    for path, leaf in _flatten(tree):
        name = _leaf_name(path)
        if isinstance(leaf, torch.Tensor):
            dtype = "uint16" if leaf.dtype == torch.bfloat16 else \
                _np_dtype(leaf.dtype)
            shape, nbytes = leaf.shape, leaf.numel() * leaf.element_size()
        else:
            arr = np.asarray(leaf)
            dtype, shape, nbytes = str(arr.dtype), arr.shape, arr.nbytes
        meta, boxes = _region_meta(name, shape, dtype, nbytes)
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


def _encode_leaf(leaf: torch.Tensor, prev: Optional[Dict[int, DeltaState]]):
    """Encode one float leaf (one part) on its device and copy the result
    to the host: the XOR delta when its frame will be a delta, else the
    codes, and the scales.  Returns ({part: (host delta or codes, host
    scales, device codes)}, whether the frame is a delta).

    The copies go to pageable host memory: pinned buffers for a whole
    state's codes would stay in PyTorch's host cache after every commit
    (tens of GB at full width)."""
    if prev is not None:
        st = prev[0]
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
            return {0: (d.cpu(), s.cpu(), q)}, True
        return {0: (q.cpu(), s.cpu(), q)}, False
    q, s = quantize(leaf)
    return {0: (q.cpu(), s.cpu(), q)}, False


def snapshot_pytree(tree, step: int = 0, codec: str = "raw",
                    chain_lookup=None) -> HostSnapshot:
    """Snapshot a tree of tensors to host memory, one region per leaf.

    ``codec="q8"`` / ``"q8-delta"``: float leaves are quantized on their
    device before the copy; ``chain_lookup(name, num_parts)`` supplies the
    catalog's previous-codes state so ``q8-delta`` regions ship sparse
    XOR-delta frames (``ICheckClient.delta_chain_lookup``).  Non-float
    leaves always travel raw.
    """
    if codec not in ("raw", "q8", "q8-delta"):
        raise ValueError(f"unknown snapshot codec {codec!r}")
    encode = codec != "raw"
    # 1) encode every float leaf on its device and copy its codes (or
    #    delta) and scales to the host
    work: Dict[str, dict] = {}
    with torch.no_grad():
        for path, leaf in _flatten(tree):
            name = _leaf_name(path)
            if not (encode and _is_float_leaf(leaf)):
                continue
            leaf = torch.as_tensor(leaf)
            n = max(leaf.numel(), 1)
            prev = parent_chain = None
            if codec == "q8-delta":
                prev, parent_chain = _chain_states(chain_lookup, name, 1,
                                                   {0: n})
            t0 = time.monotonic()
            outs, delta = _encode_leaf(leaf, prev)
            work[name] = {"n": n, "outs": outs,
                          "prev": prev if delta else None,
                          "parent_chain": parent_chain, "leaf": leaf,
                          "launch_s": time.monotonic() - t0}
    # 2) pack the encoded wire frames
    regions: Dict[str, SnapshotRegion] = {}
    for path, leaf in _flatten(tree):
        name = _leaf_name(path)
        if name in work:
            regions[name] = _gather_encoded(name, codec, work.pop(name))
            continue
        arr = _to_host(leaf)
        meta, boxes = _region_meta(name, arr.shape, str(arr.dtype),
                                   arr.nbytes)
        regions[name] = SnapshotRegion(meta=meta, parts={0: arr}, boxes=boxes)
    return HostSnapshot(regions=regions, step=step)


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
        qparts[p] = (w["n"], codes, scales)
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
    meta, boxes = _region_meta(name, leaf.shape, dtype, raw_nbytes)
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


def load_leaf_(name: str, leaf: torch.Tensor, meta: RegionMeta,
               parts: Dict[int, np.ndarray]) -> None:
    """Copy one region's fetched parts, placed by ``meta``'s boxes, into
    ``leaf`` in place (shapes must agree)."""
    full = _assemble(meta, parts)
    if tuple(full.shape) != tuple(leaf.shape):
        raise ValueError(f"{name}: restored shape {full.shape} != "
                         f"{tuple(leaf.shape)}")
    with torch.no_grad():
        leaf.copy_(_host_tensor(full, leaf.dtype))


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
