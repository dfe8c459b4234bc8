"""Redistribution planning — the data-management half of iCheck.

The paper (§III-B) supports BLOCK and CYCLIC re-partitioning of registered
arrays when the application's process count changes.  This module computes
*plans*: exact (src_part, src_range) → (dst_part, dst_range) move lists that
agents execute without ever materialising the global array.

Beyond the paper, ``mesh_moves`` generalises the same machinery to N-d
partitions of JAX arrays sharded over a (pod, data, model) device mesh, which
is what elastic mesh changes (grow/shrink) need.

Everything here is pure and deterministic → hypothesis property tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .types import PartitionDesc, PartitionScheme

Interval = Tuple[int, int]           # [lo, hi)


# --------------------------------------------------------------------------
# 1-d ownership maps (paper-faithful)
# --------------------------------------------------------------------------
def partition_intervals(n: int, desc: PartitionDesc) -> List[List[Interval]]:
    """Global index intervals owned by each part, in local-storage order."""
    p = desc.num_parts
    if p <= 0:
        raise ValueError("num_parts must be positive")
    if desc.scheme == PartitionScheme.REPLICATED:
        return [[(0, n)] for _ in range(p)]
    if desc.scheme == PartitionScheme.BLOCK:
        base, rem = divmod(n, p)
        out, lo = [], 0
        for i in range(p):
            size = base + (1 if i < rem else 0)
            out.append([(lo, lo + size)] if size else [])
            lo += size
        return out
    if desc.scheme == PartitionScheme.CYCLIC:
        b = max(1, desc.block)
        out: List[List[Interval]] = [[] for _ in range(p)]
        nblocks = -(-n // b)
        for j in range(nblocks):
            lo, hi = j * b, min((j + 1) * b, n)
            out[j % p].append((lo, hi))
        return out
    if desc.scheme == PartitionScheme.MESH:
        raise ValueError("MESH partitions use mesh_moves(), not 1-d intervals")
    raise ValueError(f"unknown scheme {desc.scheme}")


def local_size(n: int, desc: PartitionDesc, part: int) -> int:
    return sum(hi - lo for lo, hi in partition_intervals(n, desc)[part])


def local_shape(shape: Sequence[int], desc: PartitionDesc, part: int) -> Tuple[int, ...]:
    shape = tuple(shape)
    if desc.scheme == PartitionScheme.REPLICATED:
        return shape
    ax = desc.axis
    return shape[:ax] + (local_size(shape[ax], desc, part),) + shape[ax + 1:]


def _local_offsets(intervals: List[Interval]) -> List[int]:
    """Local start offset of each owned interval (prefix sums)."""
    offs, acc = [], 0
    for lo, hi in intervals:
        offs.append(acc)
        acc += hi - lo
    return offs


@dataclasses.dataclass(frozen=True)
class Move:
    """Copy global rows [glo, ghi) of the distributed axis:
    src part ``src``, local rows [src_lo, src_lo+len) →
    dst part ``dst``, local rows [dst_lo, dst_lo+len)."""

    src: int
    dst: int
    glo: int
    ghi: int
    src_lo: int
    dst_lo: int

    @property
    def length(self) -> int:
        return self.ghi - self.glo


def redistribution_moves(n: int, old: PartitionDesc, new: PartitionDesc) -> List[Move]:
    """All moves needed to go from distribution ``old`` to ``new``.

    Replicated sources are collapsed to part 0 (any replica is valid).
    """
    old_iv = partition_intervals(n, old)
    new_iv = partition_intervals(n, new)
    if old.scheme == PartitionScheme.REPLICATED:
        old_iv = [old_iv[0]]  # read from a single canonical replica

    # sweep: index every source interval by global range
    src_index = []          # (lo, hi, src_part, src_local_offset)
    for sp, ivs in enumerate(old_iv):
        offs = _local_offsets(ivs)
        for (lo, hi), off in zip(ivs, offs):
            src_index.append((lo, hi, sp, off))
    src_index.sort()

    moves: List[Move] = []
    for dp, ivs in enumerate(new_iv):
        offs = _local_offsets(ivs)
        for (dlo, dhi), doff in zip(ivs, offs):
            # binary search could apply; linear scan is fine at control-plane scale
            for slo, shi, sp, soff in src_index:
                if shi <= dlo:
                    continue
                if slo >= dhi:
                    break
                lo, hi = max(slo, dlo), min(shi, dhi)
                if lo < hi:
                    moves.append(Move(
                        src=sp, dst=dp, glo=lo, ghi=hi,
                        src_lo=soff + (lo - slo),
                        dst_lo=doff + (lo - dlo)))
    return moves


# --------------------------------------------------------------------------
# numpy executors (used by agents and by tests as the oracle)
# --------------------------------------------------------------------------
def split_array(arr: np.ndarray, desc: PartitionDesc) -> List[np.ndarray]:
    """Global array → per-part local arrays (local-storage order)."""
    if desc.scheme == PartitionScheme.REPLICATED:
        return [arr.copy() for _ in range(desc.num_parts)]
    ivs = partition_intervals(arr.shape[desc.axis], desc)
    out = []
    for part_ivs in ivs:
        chunks = [np.take(arr, np.arange(lo, hi), axis=desc.axis) for lo, hi in part_ivs]
        if chunks:
            out.append(np.concatenate(chunks, axis=desc.axis))
        else:
            shp = list(arr.shape)
            shp[desc.axis] = 0
            out.append(np.empty(shp, dtype=arr.dtype))
    return out

def assemble_array(parts: Sequence[np.ndarray], desc: PartitionDesc,
                   shape: Sequence[int]) -> np.ndarray:
    """Per-part local arrays → global array."""
    shape = tuple(shape)
    if desc.scheme == PartitionScheme.REPLICATED:
        return np.asarray(parts[0]).reshape(shape)
    out = np.empty(shape, dtype=np.asarray(parts[0]).dtype)
    ivs = partition_intervals(shape[desc.axis], desc)
    for part, part_ivs in enumerate(ivs):
        offs = _local_offsets(part_ivs)
        for (lo, hi), off in zip(part_ivs, offs):
            sl_g = [slice(None)] * len(shape)
            sl_g[desc.axis] = slice(lo, hi)
            sl_l = [slice(None)] * len(shape)
            sl_l[desc.axis] = slice(off, off + (hi - lo))
            out[tuple(sl_g)] = np.asarray(parts[part])[tuple(sl_l)]
    return out


def apply_moves(src_parts: Dict[int, np.ndarray], moves: Sequence[Move],
                old: PartitionDesc, new: PartitionDesc,
                shape: Sequence[int]) -> Dict[int, np.ndarray]:
    """Execute a move list: build every destination part from source parts.

    This is what agents do during ``icheck_redistribute`` — no global
    materialisation, only slice copies.
    """
    shape = tuple(shape)
    ax = new.axis if new.scheme != PartitionScheme.REPLICATED else old.axis
    dtype = next(iter(src_parts.values())).dtype
    dst_parts: Dict[int, np.ndarray] = {}
    for dp in range(new.num_parts):
        dst_parts[dp] = np.empty(local_shape(shape, new, dp), dtype=dtype)
    for mv in moves:
        src = src_parts[mv.src]
        sl_s = [slice(None)] * len(shape)
        sl_s[ax] = slice(mv.src_lo, mv.src_lo + mv.length)
        sl_d = [slice(None)] * len(shape)
        sl_d[ax] = slice(mv.dst_lo, mv.dst_lo + mv.length)
        dst_parts[mv.dst][tuple(sl_d)] = src[tuple(sl_s)]
    return dst_parts


# --------------------------------------------------------------------------
# N-d mesh partitions (beyond-paper: JAX sharded arrays)
# --------------------------------------------------------------------------
Box = Tuple[Interval, ...]            # one (lo, hi) per dim


@dataclasses.dataclass(frozen=True)
class MeshMove:
    src: int                          # source part index
    dst: int                          # destination part index
    src_box: Box                      # in src-local coordinates
    dst_box: Box                      # in dst-local coordinates

    @property
    def nelems(self) -> int:
        n = 1
        for lo, hi in self.src_box:
            n *= hi - lo
        return n


def mesh_part_bounds(shape: Sequence[int], sharding) -> Tuple[Box, ...]:
    """Distinct shard boxes of a jax NamedSharding, deduplicated across
    replicas, in a canonical (sorted) order.  Pure host math."""
    shape = tuple(shape)
    idx_map = sharding.devices_indices_map(shape)
    boxes = set()
    for idx in idx_map.values():
        box = []
        for d, sl in enumerate(idx):
            lo = 0 if sl.start is None else int(sl.start)
            hi = shape[d] if sl.stop is None else int(sl.stop)
            box.append((lo, hi))
        boxes.add(tuple(box))
    return tuple(sorted(boxes))


def boxes_to_desc(shape: Sequence[int], boxes: Tuple[Box, ...]) -> PartitionDesc:
    return PartitionDesc(scheme=PartitionScheme.MESH, num_parts=len(boxes),
                         bounds=tuple(boxes))


def mesh_moves(old_boxes: Sequence[Box], new_boxes: Sequence[Box]) -> List[MeshMove]:
    """Box-intersection plan between two N-d partitions of the same array."""
    moves: List[MeshMove] = []
    for dp, dbox in enumerate(new_boxes):
        for sp, sbox in enumerate(old_boxes):
            inter = []
            ok = True
            for (slo, shi), (dlo, dhi) in zip(sbox, dbox):
                lo, hi = max(slo, dlo), min(shi, dhi)
                if lo >= hi:
                    ok = False
                    break
                inter.append((lo, hi))
            if not ok:
                continue
            src_box = tuple((lo - sbox[d][0], hi - sbox[d][0])
                            for d, (lo, hi) in enumerate(inter))
            dst_box = tuple((lo - dbox[d][0], hi - dbox[d][0])
                            for d, (lo, hi) in enumerate(inter))
            moves.append(MeshMove(src=sp, dst=dp, src_box=src_box, dst_box=dst_box))
            # first covering source wins for the overlapping cells; later
            # sources would write identical data (replicas), skip them
    return _dedup_mesh_moves(moves)


def _dedup_mesh_moves(moves: List[MeshMove]) -> List[MeshMove]:
    """Drop moves that write a dst cell already fully written by an earlier
    move (replicated sources produce duplicates).  Exact-duplicate boxes only:
    partial overlaps between distinct sources cannot happen for GSPMD
    shardings (shards tile the array)."""
    seen = set()
    out = []
    for mv in moves:
        key = (mv.dst, mv.dst_box)
        if key in seen:
            continue
        seen.add(key)
        out.append(mv)
    return out


def apply_mesh_moves(src_parts: Dict[int, np.ndarray], moves: Sequence[MeshMove],
                     new_boxes: Sequence[Box], dtype) -> Dict[int, np.ndarray]:
    out: Dict[int, np.ndarray] = {}
    for dp, dbox in enumerate(new_boxes):
        shp = tuple(hi - lo for lo, hi in dbox)
        out[dp] = np.empty(shp, dtype=dtype)
    for mv in moves:
        src = src_parts[mv.src]
        ssl = tuple(slice(lo, hi) for lo, hi in mv.src_box)
        dsl = tuple(slice(lo, hi) for lo, hi in mv.dst_box)
        out[mv.dst][dsl] = src[ssl]
    return out


def moves_bytes(moves: Sequence[Move], row_bytes: int) -> int:
    """Total bytes a 1-d plan transfers (for scheduling/benchmarks)."""
    return sum(mv.length for mv in moves) * row_bytes


# --------------------------------------------------------------------------
# transfer programs (peer-to-peer redistribution)
# --------------------------------------------------------------------------
# A *move list* says which global slices change owner; a *transfer program*
# says, per destination part, exactly which flattened element ranges of which
# source shards an agent must pull and where they land in the assembled
# destination buffer.  Programs are what the resize forewarning pre-stages so
# the adapt window only executes: agents serve the ranges straight off their
# stored payloads (codec-aware slicing lives in ``core/tiers.py``) and ship
# only needed bytes, never whole shards.
@dataclasses.dataclass(frozen=True)
class TransferOp:
    """One slice read: flattened elements [src_lo, src_hi) of source part
    ``src`` land at flattened offset ``dst_lo`` of the destination part."""

    src: int
    src_lo: int
    src_hi: int
    dst_lo: int

    @property
    def nvals(self) -> int:
        return self.src_hi - self.src_lo


@dataclasses.dataclass(frozen=True)
class TransferProgram:
    """Everything one destination part needs: its flattened size and the
    ordered slice reads that assemble it."""

    dst: int
    nvals: int
    ops: Tuple[TransferOp, ...]

    @property
    def moved_vals(self) -> int:
        return sum(op.nvals for op in self.ops)


def compile_transfer_programs(n: int, old: PartitionDesc, new: PartitionDesc,
                              shape: Sequence[int]
                              ) -> "Optional[Dict[int, TransferProgram]]":
    """Compile a 1-d re-partitioning into per-destination transfer programs.

    Returns None when the layout cannot be expressed as contiguous flattened
    element ranges (non-leading distributed axis, replicated schemes) — the
    caller must fall back to the client-funnel path.
    """
    if PartitionScheme.REPLICATED in (old.scheme, new.scheme):
        return None
    if old.axis != 0 or new.axis != 0:
        return None
    shape = tuple(shape)
    rowvals = 1
    for s in shape[1:]:
        rowvals *= int(s)
    moves = redistribution_moves(n, old, new)
    ops_by_dst: Dict[int, List[TransferOp]] = {d: [] for d in range(new.num_parts)}
    for mv in moves:
        ops_by_dst[mv.dst].append(TransferOp(
            src=mv.src, src_lo=mv.src_lo * rowvals,
            src_hi=(mv.src_lo + mv.length) * rowvals,
            dst_lo=mv.dst_lo * rowvals))
    return {
        dp: TransferProgram(
            dst=dp, nvals=local_size(n, new, dp) * rowvals,
            ops=tuple(sorted(ops_by_dst[dp], key=lambda o: o.dst_lo)))
        for dp in range(new.num_parts)
    }


def _row_major_strides(shape: Sequence[int]) -> List[int]:
    st = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        st[d] = st[d + 1] * shape[d + 1]
    return st


def _box_runs(src_shape: Sequence[int], src_box: Box,
              dst_shape: Sequence[int], dst_box: Box
              ) -> List[Tuple[int, int, int]]:
    """Contiguous flattened runs of one mesh move (src part → dst part).

    Rows along the innermost dimension are contiguous in both local layouts;
    adjacent runs that stay contiguous in *both* buffers are merged.
    """
    import itertools as _it

    if not src_box:                       # scalar region
        return [(0, 1, 0)]
    sst = _row_major_strides(src_shape)
    dstst = _row_major_strides(dst_shape)
    extents = [hi - lo for lo, hi in src_box]
    run = extents[-1]
    runs: List[Tuple[int, int, int]] = []
    for idx in _it.product(*(range(e) for e in extents[:-1])):
        soff = src_box[-1][0] + sum(
            (src_box[d][0] + idx[d]) * sst[d] for d in range(len(idx)))
        doff = dst_box[-1][0] + sum(
            (dst_box[d][0] + idx[d]) * dstst[d] for d in range(len(idx)))
        if runs and runs[-1][1] == soff \
                and runs[-1][2] + (runs[-1][1] - runs[-1][0]) == doff:
            runs[-1] = (runs[-1][0], soff + run, runs[-1][2])
        else:
            runs.append((soff, soff + run, doff))
    return runs


def compile_mesh_transfer_programs(old_boxes: Sequence[Box],
                                   new_boxes: Sequence[Box]
                                   ) -> Dict[int, TransferProgram]:
    """N-d mesh variant: box-intersection moves → per-destination programs
    of contiguous flattened runs (src-local → dst-local coordinates)."""
    moves = mesh_moves(tuple(old_boxes), tuple(new_boxes))
    src_shapes = [tuple(hi - lo for lo, hi in b) for b in old_boxes]
    dst_shapes = [tuple(hi - lo for lo, hi in b) for b in new_boxes]
    ops_by_dst: Dict[int, List[TransferOp]] = {d: [] for d in range(len(new_boxes))}
    for mv in moves:
        for slo, shi, dlo in _box_runs(src_shapes[mv.src], mv.src_box,
                                       dst_shapes[mv.dst], mv.dst_box):
            ops_by_dst[mv.dst].append(TransferOp(src=mv.src, src_lo=slo,
                                                 src_hi=shi, dst_lo=dlo))
    out = {}
    for dp, shp in enumerate(dst_shapes):
        nvals = 1
        for s in shp:
            nvals *= s
        out[dp] = TransferProgram(
            dst=dp, nvals=nvals,
            ops=tuple(sorted(ops_by_dst[dp], key=lambda o: o.dst_lo)))
    return out


def apply_transfer_programs(src_flat: Dict[int, np.ndarray],
                            programs: Dict[int, TransferProgram],
                            dtype) -> Dict[int, np.ndarray]:
    """Numpy oracle for program execution: flattened source parts →
    flattened destination parts (tests compare this against both
    ``apply_moves`` and the agents' peer-assembled shards)."""
    out: Dict[int, np.ndarray] = {}
    for dp, prog in programs.items():
        buf = np.zeros(prog.nvals, dtype=np.dtype(dtype))
        for op in prog.ops:
            buf[op.dst_lo:op.dst_lo + op.nvals] = \
                src_flat[op.src][op.src_lo:op.src_hi]
        out[dp] = buf
    return out
