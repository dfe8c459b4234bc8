"""Pluggable checkpoint storage tiers.

The paper's two-level hierarchy — agent RAM (L1) drained into the parallel
file system (L2, §II) — is generalised into a :class:`StorageTier` protocol
so new levels can be added without touching the controller:

  * :class:`MemoryTier`       — L1, iCheck-node RAM agents RDMA shards into
  * :class:`LocalDiskTier`    — L0.5, node-local spill (NVMe burst-buffer
    analogue) that absorbs capacity pressure before the RM must grow us
  * :class:`PFSTier`          — L2, the bandwidth-limited PFS container format
  * :class:`RemoteObjectTier` — L3, S3/GCS-style remote object store: per-
    request latency floor, multipart parallel throughput, effectively
    unbounded capacity, per-byte/per-request cost accounting

Every tier does crc32 + capacity accounting.  A per-node
:class:`TierPipeline` owns shard placement across its tiers (spill on
capacity pressure, promotion back to RAM on read) and is a drop-in for the
old ``MemoryStore`` mapping interface.

The pipeline also owns the *codec path*: ``encode_payload`` /
``decode_payload`` thread the ``zstd``, ``q8`` and ``q8-delta`` codecs
uniformly through puts, degrading gracefully to ``"none"`` when
``zstandard`` is not installed instead of raising.  The blockwise int8
math is imported from ``kernels/ckpt_codec`` (one shared reference — the
host wire codec and the device kernels cannot drift); ``q8-delta`` adds
sparse XOR-delta *frames* (only blocks whose codes or scale changed travel)
whose chain state lives in the CheckpointCatalog.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import threading
import zlib
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np

from ..obs import trace_id_for
from . import events as _events
from ..kernels.ckpt_codec.blocks import (BLOCK as _Q8_BLOCK, dequantize_np,
                                         quantize_np, to_blocks_np)
from ..kernels.ckpt_codec.rs import (join_rows, rs_decode_np, rs_encode_np,
                                     split_rows)
from .retry import with_backoff
from .simnet import SimNIC
from .types import (CapacityError, CheckpointMeta, CkptStatus, ICheckError,
                    IntegrityError, PartitionDesc, PartitionScheme,
                    RegionMeta, RestoreError, ShardKey)

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover - optional dependency
    _zstd = None


def crc32(buf) -> int:
    return zlib.crc32(memoryview(buf).cast("B")) & 0xFFFFFFFF


def _tupled(x):
    """JSON round-trips tuples as lists; restore nested tuples."""
    if isinstance(x, list):
        return tuple(_tupled(v) for v in x)
    return x


# ==========================================================================
# codecs — applied on the transfer path, uniformly for every put
# ==========================================================================
# _Q8_BLOCK is imported from kernels/ckpt_codec/blocks: one definition of the
# blockwise layout for the device kernels and this host wire codec.
#
# q8 frame wire modes (first payload byte):
#   b"R"  raw passthrough        R + data                    (non-float dtype)
#   b"Q"  plain q8 frame         Q + n u64le + scales f32[nb] + codes i8[nb*B]
#   b"K"  q8-delta keyframe      same layout as Q, tagged as a chain root
#   b"D"  q8-delta sparse frame  D + n u64le + nnz u32le + idx u32le[nnz]
#                                  + scales f32[nnz] + deltas i8[nnz*B]
# A delta frame carries only the blocks whose codes or scale changed since
# the previous frame (XOR codes, absolute scales); unchanged blocks cost
# zero wire bytes — the steady-state win of incremental checkpointing.
_Q8_QUANT = b"Q"
_Q8_RAW = b"R"
_Q8_KEY = b"K"
_Q8_DELTA = b"D"
# a delta frame of a part with zero changed blocks is exactly the header:
# D + n u64le + nnz u32le (nnz=0) — knowing this lets consumers prune reads
# of unchanged parts from shard *sizes* alone (already in every manifest)
Q8_EMPTY_DELTA_NBYTES = 1 + 8 + 4


@dataclasses.dataclass
class DeltaState:
    """Previous-codes handle for one region part (owned by the catalog)."""

    n: int                    # unpadded element count
    codes: np.ndarray         # (nb, BLOCK) int8
    scales: np.ndarray        # (nb, 1) f32
    # device-resident copy of ``codes`` (a jax.Array), attached by the
    # device-encode path so the next ``quantize_delta`` reads the previous
    # codes in place instead of re-uploading them H2D every commit; costs
    # 1/4 of the region's f32 bytes in device memory, dropped on chain
    # reset.  None on the pure-host path.
    codes_dev: object = None


def zstd_available() -> bool:
    return _zstd is not None


def is_float_dtype(dtype) -> bool:
    """True for dtypes the q8 codecs quantize (f32/f16/... and bfloat16,
    whose numpy dtype reports kind 'V')."""
    try:
        dt = np.dtype(dtype)
    except TypeError:
        return False
    return dt.kind == "f" or dt.name == "bfloat16"


def resolve_codec(codec: str,
                  on_degrade: Optional[Callable[[str, str], None]] = None) -> str:
    """Map a requested codec to one this process can actually run.

    ``zstd`` without the ``zstandard`` module degrades to ``"none"``;
    ``on_degrade(requested, actual)`` is invoked so the caller can log an
    event instead of the old behaviour of silently mis-labelling (or, worse,
    raising mid-commit).
    """
    if codec in ("zstd",) and _zstd is None:
        if on_degrade is not None:
            on_degrade(codec, "none")
        return "none"
    if codec not in ("raw", "none", "zstd", "q8", "q8-delta"):
        raise ICheckError(f"unknown codec {codec!r}")
    return codec


def q8_pack_full(n: int, codes: np.ndarray, scales: np.ndarray,
                 mode: bytes = _Q8_QUANT) -> bytes:
    """Pack a full q8 frame (plain ``Q`` or chain keyframe ``K``)."""
    return (mode + int(n).to_bytes(8, "little")
            + np.ascontiguousarray(scales, np.float32).tobytes()
            + np.ascontiguousarray(codes, np.int8).tobytes())


def _q8_full_size(nb: int) -> int:
    return 9 + 4 * nb + _Q8_BLOCK * nb


def q8_pack_delta(n: int, codes: np.ndarray, scales: np.ndarray,
                  prev: DeltaState,
                  delta: Optional[np.ndarray] = None) -> Optional[bytes]:
    """Sparse XOR-delta frame against ``prev``; None when shapes mismatch
    (the caller must fall back to a keyframe).  ``delta`` short-circuits
    the XOR when the caller already holds it (the device kernel's output).
    """
    if prev.n != n or prev.codes.shape != codes.shape:
        return None
    if delta is None:
        delta = np.bitwise_xor(codes, prev.codes)
    changed = np.logical_or((delta != 0).any(axis=1),
                            (scales != prev.scales).any(axis=1))
    idx = np.flatnonzero(changed).astype(np.uint32)
    return (_Q8_DELTA + int(n).to_bytes(8, "little")
            + len(idx).to_bytes(4, "little") + idx.tobytes()
            + np.ascontiguousarray(scales[idx], np.float32).tobytes()
            + np.ascontiguousarray(delta[idx], np.int8).tobytes())


def _q8_unpack_full(blob: bytes) -> Tuple[int, np.ndarray, np.ndarray]:
    n = int.from_bytes(blob[1:9], "little")
    nb = -(-max(n, 1) // _Q8_BLOCK)
    if len(blob) != _q8_full_size(nb):
        raise RestoreError(
            f"truncated q8 frame: {len(blob)} bytes for n={n}")
    scales = np.frombuffer(blob[9:9 + 4 * nb], np.float32).reshape(nb, 1)
    codes = np.frombuffer(blob[9 + 4 * nb:], np.int8).reshape(nb, _Q8_BLOCK)
    return n, codes, scales


def _q8_unpack_delta(blob: bytes) -> Tuple[int, np.ndarray, np.ndarray,
                                           np.ndarray]:
    n = int.from_bytes(blob[1:9], "little")
    nnz = int.from_bytes(blob[9:13], "little")
    if len(blob) != 13 + nnz * (4 + 4 + _Q8_BLOCK):
        raise RestoreError(
            f"truncated q8-delta frame: {len(blob)} bytes for nnz={nnz}")
    off = 13
    idx = np.frombuffer(blob[off:off + 4 * nnz], np.uint32)
    off += 4 * nnz
    scales = np.frombuffer(blob[off:off + 4 * nnz], np.float32).reshape(-1, 1)
    off += 4 * nnz
    deltas = np.frombuffer(blob[off:], np.int8).reshape(-1, _Q8_BLOCK)
    return n, idx, scales, deltas


def q8_delta_apply(blob: bytes, state: Optional[DeltaState]) -> DeltaState:
    """Advance the replay state by one frame (keyframe or sparse delta)."""
    mode = blob[:1]
    if mode in (_Q8_QUANT, _Q8_KEY):
        n, codes, scales = _q8_unpack_full(blob)
        return DeltaState(n=n, codes=codes.copy(), scales=scales.copy())
    if mode != _Q8_DELTA:
        raise RestoreError(f"bad q8 frame mode {mode!r}")
    if state is None:
        raise RestoreError("delta frame without a preceding keyframe")
    n, idx, scales, deltas = _q8_unpack_delta(blob)
    if n != state.n:
        raise RestoreError(
            f"delta frame size mismatch: chain n={state.n}, frame n={n}")
    if len(idx) and int(idx.max()) >= state.codes.shape[0]:
        raise RestoreError("delta frame block index out of range")
    codes = state.codes.copy()
    new_scales = state.scales.copy()
    codes[idx] = np.bitwise_xor(codes[idx], deltas)
    new_scales[idx] = scales
    return DeltaState(n=n, codes=codes, scales=new_scales)


def q8_chain_decode(blobs: Sequence[bytes], dtype: str) -> bytes:
    """Replay keyframe + deltas back to raw bytes.

    Bit-identical to decoding a full q8 frame of the final commit: the chain
    reconstructs that frame's exact (codes, scales) and the dequantize math
    is the same f32 path the device kernels use.
    """
    if not blobs:
        raise RestoreError("empty delta chain")
    if blobs[-1][:1] == _Q8_RAW:
        # non-float passthrough: every frame is full, only the last matters
        return bytes(blobs[-1][1:])
    state: Optional[DeltaState] = None
    for blob in blobs:
        state = q8_delta_apply(blob, state)
    return dequantize_np(state.codes, state.scales, state.n, dtype).tobytes()


def q8_quantize_part(data: bytes, dtype: str) -> Tuple[int, np.ndarray,
                                                       np.ndarray]:
    """Host-side quantize of one region part: raw bytes -> (n, codes, scales)
    via the shared blockwise reference (kernels/ckpt_codec/blocks)."""
    x = np.frombuffer(data, dtype=np.dtype(dtype))
    blocks, n = to_blocks_np(x)
    codes, scales = quantize_np(blocks)
    return n, codes, scales


def pack_q8_region(parts: Dict[int, Tuple[int, np.ndarray, np.ndarray]],
                   prev: Optional[Dict[int, DeltaState]],
                   deltas: Optional[Dict[int, np.ndarray]] = None
                   ) -> Tuple[Dict[int, bytes], Dict[int, DeltaState], str]:
    """Frame one region's quantized parts as deltas or keyframes.

    ``parts[part] = (n, codes, scales)`` — produced host-side by
    :func:`q8_quantize_part` or device-side by the ``kernels/ckpt_codec``
    Pallas ops (both paths share this packer, so framing policy cannot
    drift).  Emits sparse deltas against ``prev`` when the whole region has
    matching previous-codes state **and** the delta frames are actually
    smaller than keyframes (high-churn commits fall back to a keyframe, so
    q8-delta never loses to plain q8); returns ``(blobs, new_states,
    frame)`` with frame ``"key"`` or ``"delta"``.
    """
    states = {p: DeltaState(n=n, codes=codes, scales=scales)
              for p, (n, codes, scales) in parts.items()}
    if prev is not None and set(prev) == set(parts):
        delta_blobs: Dict[int, bytes] = {}
        for p, (n, codes, scales) in parts.items():
            blob = q8_pack_delta(n, codes, scales, prev[p],
                                 delta=(deltas or {}).get(p))
            if blob is None:
                break
            delta_blobs[p] = blob
        if len(delta_blobs) == len(parts):
            key_total = sum(_q8_full_size(codes.shape[0])
                            for _, codes, _ in parts.values())
            if sum(len(b) for b in delta_blobs.values()) < key_total:
                return delta_blobs, states, "delta"
    keys = {p: q8_pack_full(n, codes, scales, _Q8_KEY)
            for p, (n, codes, scales) in parts.items()}
    return keys, states, "key"


# --------------------------------------------------------------------------
# slice frames — the peer-to-peer redistribution wire format
# --------------------------------------------------------------------------
# An agent serving a ``peer_read`` ships only the bytes another agent's
# transfer program asked for (flattened element range [vlo, vhi) of one
# stored shard), never the whole payload.  Three slice modes:
#
#   b"W"  raw value slice      W + exact [vlo*itemsize, vhi*itemsize) bytes
#   b"S"  q8 block slice       S + vlo u64 + vhi u64 + scales f32[nb]
#                                + codes i8[nb*BLOCK]   (blocks covering the
#                                range, cut from a Q/K frame — no decode)
#   b"T"  q8-delta block slice T + vlo u64 + vhi u64 + nnz u32
#                                + idx u32[nnz] (absolute block indices)
#                                + scales f32[nnz] + deltas i8[nnz*BLOCK]
#
# q8 frames are sliced at the 256-value block granularity of
# ``kernels/ckpt_codec/blocks.py`` so encoded payloads move without decode
# and are re-framed, not re-quantized; the destination replays S (+T chain)
# slices and dequantizes only the needed blocks — bit-identical to slicing a
# full-shard decode.
_SL_RAW = b"W"
_SL_FULL = b"S"
_SL_DELTA = b"T"


@dataclasses.dataclass
class SliceState:
    """Retained q8 decode state of one assembled slice range [vlo, vhi):
    the (codes, scales) of the covering blocks after replaying the base
    chain.  A zero-stall cutover advances this state with the tail delta
    frames committed during the overlap window instead of re-streaming the
    keyframe — the decoded scratch bytes alone could not absorb a ``T``
    frame (XOR needs the codes, not the dequantized values)."""

    vlo: int
    vhi: int
    codes: np.ndarray         # (nb, BLOCK) int8, blocks [vlo//B, ceil(vhi/B))
    scales: np.ndarray        # (nb, 1) f32


def _apply_slice_frame(blob: bytes, codes, scales, vlo: int, vhi: int):
    """Apply one S/T slice frame to (codes, scales); returns the new
    ``(codes, scales, changed_rel)`` where ``changed_rel`` is the array of
    relative block indices the frame touched (None = every block)."""
    blo, bhi = vlo // _Q8_BLOCK, -(-vhi // _Q8_BLOCK)
    nb = bhi - blo
    mode = blob[:1]
    flo = int.from_bytes(blob[1:9], "little")
    fhi = int.from_bytes(blob[9:17], "little")
    if (flo, fhi) != (vlo, vhi):
        raise RestoreError(
            f"slice range mismatch: frame [{flo},{fhi}) vs [{vlo},{vhi})")
    if mode == _SL_FULL:
        if len(blob) != 17 + nb * (4 + _Q8_BLOCK):
            raise RestoreError(f"truncated q8 slice: {len(blob)} bytes")
        scales = np.frombuffer(blob[17:17 + 4 * nb],
                               np.float32).reshape(nb, 1).copy()
        codes = np.frombuffer(blob[17 + 4 * nb:],
                              np.int8).reshape(nb, _Q8_BLOCK).copy()
        return codes, scales, None
    if mode == _SL_DELTA:
        if codes is None or scales is None:
            raise RestoreError("delta slice without a keyframe slice")
        nnz = int.from_bytes(blob[17:21], "little")
        if len(blob) != 21 + nnz * (4 + 4 + _Q8_BLOCK):
            raise RestoreError(
                f"truncated q8-delta slice: {len(blob)} bytes")
        off = 21
        idx = np.frombuffer(blob[off:off + 4 * nnz], np.uint32)
        off += 4 * nnz
        dsc = np.frombuffer(blob[off:off + 4 * nnz],
                            np.float32).reshape(-1, 1)
        off += 4 * nnz
        dl = np.frombuffer(blob[off:], np.int8).reshape(-1, _Q8_BLOCK)
        rel = idx.astype(np.int64) - blo
        if len(rel) and (rel.min() < 0 or rel.max() >= nb):
            raise RestoreError("delta slice block index out of range")
        codes[rel] = np.bitwise_xor(codes[rel], dl)
        scales[rel] = dsc
        return codes, scales, rel
    raise RestoreError(f"bad slice mode {mode!r}")


def _dequantize_slice(codes: np.ndarray, scales: np.ndarray,
                      dtype: str, vlo: int, vhi: int) -> np.ndarray:
    blo = vlo // _Q8_BLOCK
    vals = (codes.astype(np.float32) * scales).reshape(-1)
    return vals[vlo - blo * _Q8_BLOCK:vhi - blo * _Q8_BLOCK] \
        .astype(np.dtype(dtype))


def replay_slice_frames(state: Optional[SliceState], frames: Sequence[bytes],
                        dtype: str, vlo: int, vhi: int
                        ) -> Tuple[List[Tuple[int, np.ndarray]],
                                   Optional[SliceState]]:
    """Advance a retained :class:`SliceState` by tail frames (the deltas
    committed during an overlap window) and return the *value patches* a
    cutover must splice into the already-assembled scratch payload.

    Returns ``(patches, new_state)`` where each patch is ``(rel_offset,
    values)`` relative to ``vlo``, covering exactly the value spans whose
    blocks changed (adjacent changed blocks coalesce into one patch).  A
    raw (``W``) tail frame replaces the whole range and needs no state.
    """
    if not frames:
        return [], state
    if frames[-1][:1] == _SL_RAW:
        # raw passthrough: every chain frame is full, only the last matters
        arr = np.frombuffer(bytearray(frames[-1][1:]), dtype=np.dtype(dtype))
        if arr.size != vhi - vlo:
            raise RestoreError(
                f"raw slice carries {arr.size} values, wanted {vhi - vlo}")
        return [(0, arr)], state
    if state is not None and (state.vlo, state.vhi) != (vlo, vhi):
        raise RestoreError(
            f"slice state covers [{state.vlo},{state.vhi}), "
            f"tail frames cover [{vlo},{vhi})")
    codes = state.codes if state is not None else None
    scales = state.scales if state is not None else None
    blo, bhi = vlo // _Q8_BLOCK, -(-vhi // _Q8_BLOCK)
    nb = bhi - blo
    touched: Optional[set] = set()
    for blob in frames:
        codes, scales, changed = _apply_slice_frame(blob, codes, scales,
                                                    vlo, vhi)
        if changed is None:           # a full S frame rewrote every block
            touched = None
        elif touched is not None:
            touched.update(int(r) for r in changed)
    new_state = SliceState(vlo=vlo, vhi=vhi, codes=codes, scales=scales)
    if touched is None:
        return [(0, _dequantize_slice(codes, scales, dtype, vlo, vhi))], \
            new_state
    if not touched:
        return [], new_state
    vals = _dequantize_slice(codes, scales, dtype, vlo, vhi)
    patches: List[Tuple[int, np.ndarray]] = []
    run_lo: Optional[int] = None
    prev = None
    for rb in sorted(touched) + [None]:       # sentinel flushes the last run
        if run_lo is not None and (rb is None or rb != prev + 1):
            lo = max(vlo, (blo + run_lo) * _Q8_BLOCK)
            hi = min(vhi, (blo + prev + 1) * _Q8_BLOCK)
            patches.append((lo - vlo, vals[lo - vlo:hi - vlo]))
            run_lo = None
        if rb is not None:
            if run_lo is None:
                run_lo = rb
            prev = rb
    return patches, new_state


def slice_payload(blob: bytes, codec: str, dtype: str,
                  vlo: int, vhi: int) -> bytes:
    """Cut the slice frame for flattened elements [vlo, vhi) of one stored
    shard payload (source-agent side of a ``peer_read``)."""
    it = np.dtype(dtype).itemsize
    if codec in ("raw", "none"):
        return _SL_RAW + bytes(blob[vlo * it:vhi * it])
    if codec == "zstd":
        raw = decode_payload(blob, codec, dtype)
        return _SL_RAW + raw[vlo * it:vhi * it]
    if codec in ("q8", "q8-delta"):
        mode = blob[:1]
        if mode == _Q8_RAW:
            return _SL_RAW + bytes(blob[1 + vlo * it:1 + vhi * it])
        hdr = int(vlo).to_bytes(8, "little") + int(vhi).to_bytes(8, "little")
        blo, bhi = vlo // _Q8_BLOCK, -(-vhi // _Q8_BLOCK)
        if mode in (_Q8_QUANT, _Q8_KEY):
            _, codes, scales = _q8_unpack_full(blob)
            if bhi > codes.shape[0]:
                raise RestoreError(
                    f"slice [{vlo},{vhi}) beyond frame of {codes.shape[0]} "
                    f"blocks")
            return (_SL_FULL + hdr
                    + np.ascontiguousarray(scales[blo:bhi], np.float32).tobytes()
                    + np.ascontiguousarray(codes[blo:bhi], np.int8).tobytes())
        if mode == _Q8_DELTA:
            _, idx, scales, deltas = _q8_unpack_delta(blob)
            sel = (idx >= blo) & (idx < bhi)
            idx2 = idx[sel].astype(np.uint32)
            return (_SL_DELTA + hdr + len(idx2).to_bytes(4, "little")
                    + idx2.tobytes()
                    + np.ascontiguousarray(scales[sel], np.float32).tobytes()
                    + np.ascontiguousarray(deltas[sel], np.int8).tobytes())
        raise RestoreError(f"bad q8 frame mode {mode!r}")
    raise ICheckError(f"unknown codec {codec!r}")


def decode_slice_frames(frames: Sequence[bytes], dtype: str,
                        vlo: int, vhi: int, return_state: bool = False):
    """Replay slice frames back to values (destination-agent assembly).

    ``frames`` is chain-ordered (keyframe slice first, delta slices after)
    for ``q8-delta``; a single frame otherwise.  Returns a 1-d array of
    exactly ``vhi - vlo`` elements, bit-identical to decoding the full
    shards and slicing.  With ``return_state=True`` returns ``(values,
    SliceState | None)`` so an overlap-window cutover can later advance the
    decode with tail delta frames (:func:`replay_slice_frames`); raw slices
    have no q8 state and yield None.
    """
    if not frames:
        raise RestoreError("empty slice chain")
    if frames[-1][:1] == _SL_RAW:
        # raw passthrough: every chain frame is full, only the last matters
        arr = np.frombuffer(bytearray(frames[-1][1:]), dtype=np.dtype(dtype))
        if arr.size != vhi - vlo:
            raise RestoreError(
                f"raw slice carries {arr.size} values, wanted {vhi - vlo}")
        return (arr, None) if return_state else arr
    codes: Optional[np.ndarray] = None
    scales: Optional[np.ndarray] = None
    for blob in frames:
        codes, scales, _ = _apply_slice_frame(blob, codes, scales, vlo, vhi)
    if codes is None or scales is None:
        raise RestoreError("q8 slice chain has no keyframe slice")
    vals = _dequantize_slice(codes, scales, dtype, vlo, vhi)
    if return_state:
        return vals, SliceState(vlo=vlo, vhi=vhi, codes=codes, scales=scales)
    return vals


@dataclasses.dataclass
class EncodedRegion:
    """One region already encoded upstream of the client (device-side in
    ``core/snapshot.py`` before the D2H copy) — what ``commit_snapshot``
    hands the commit path instead of raw arrays."""

    codec: str                           # "q8" | "q8-delta"
    blobs: Dict[int, bytes]              # part -> wire frame
    states: Optional[Dict[int, DeltaState]]   # chain handles (q8-delta)
    frame: Optional[str]                 # "key" | "delta" (q8-delta only)
    raw_nbytes: int                      # pre-codec bytes (the f32 payload)
    parent_chain: Optional[tuple] = None  # chain expected live at commit
    encode_s: float = 0.0                # host-clock encode duration


def q8_repack_key(states: Dict[int, DeltaState]) -> Dict[int, bytes]:
    """Re-frame already-quantized parts as self-contained keyframes (used
    when a delta encode went stale: its chain reset between encode and
    commit — the carried codes are still the full current codes)."""
    return {p: q8_pack_full(st.n, st.codes, st.scales, _Q8_KEY)
            for p, st in states.items()}


def encode_delta_region(parts_bytes: Dict[int, bytes], dtype: str,
                        prev: Optional[Dict[int, DeltaState]]
                        ) -> Tuple[Dict[int, bytes],
                                   Optional[Dict[int, DeltaState]], str]:
    """Host-side q8-delta encode of one region (all parts together).

    Non-float regions pass through as full raw frames with no chain state.
    """
    if not is_float_dtype(dtype):
        return ({p: _Q8_RAW + bytes(b) for p, b in parts_bytes.items()},
                None, "key")
    parts = {p: q8_quantize_part(b, dtype) for p, b in parts_bytes.items()}
    return pack_q8_region(parts, prev)


def _q8_encode(data: bytes, dtype: str, mode: bytes = _Q8_QUANT) -> bytes:
    if not is_float_dtype(dtype):
        return _Q8_RAW + bytes(data)
    n, codes, scales = q8_quantize_part(data, dtype)
    return q8_pack_full(n, codes, scales, mode)


def _q8_decode(blob: bytes, dtype: str) -> bytes:
    mode = blob[:1]
    if mode == _Q8_RAW:
        return bytes(blob[1:])
    if mode == _Q8_DELTA:
        raise RestoreError(
            "q8-delta frame needs its chain; replay via q8_chain_decode")
    n, codes, scales = _q8_unpack_full(blob)
    return dequantize_np(codes, scales, n, dtype).tobytes()


def encode_payload(data: bytes, codec: str, dtype: str = "uint8") -> bytes:
    """Codec step of every put (client commit → agent → tier).

    ``q8-delta`` without chain state encodes a standalone keyframe — the
    client threads previous-codes state through :func:`encode_delta_region`
    on the commit hot path instead.
    """
    if codec in ("raw", "none"):
        return bytes(data)
    if codec == "zstd":
        if _zstd is None:
            raise ICheckError("zstandard not installed; resolve_codec() first")
        return _zstd.ZstdCompressor(level=1).compress(bytes(data))
    if codec == "q8":
        return _q8_encode(data, dtype)
    if codec == "q8-delta":
        return _q8_encode(data, dtype, _Q8_KEY)
    raise ICheckError(f"unknown codec {codec!r}")


def decode_payload(blob: bytes, codec: str, dtype: str = "uint8") -> bytes:
    if codec in ("raw", "none"):
        return bytes(blob)
    if codec == "zstd":
        if _zstd is None:
            raise ICheckError(
                "shard was zstd-compressed but zstandard is not installed")
        return _zstd.ZstdDecompressor().decompress(blob)
    if codec in ("q8", "q8-delta"):
        return _q8_decode(blob, dtype)
    raise ICheckError(f"unknown codec {codec!r}")


# ==========================================================================
# erasure-coded fragment framing (k data + m parity per logical shard)
# ==========================================================================
# A fragment rides the existing ShardKey by parking its index in the
# ``replica`` slot well above any replication count: data fragment i lives
# at replica FRAG_DATA0 + i, parity fragment j at replica FRAG_PARITY0 + j.
# Everything keyed on replica keeps working unchanged — LocalDiskTier paths
# stay unique (``_r{replica}``), the catalog's replica-0..3 probe never
# sees fragments, and the lifecycle demoter spots parity by replica alone.
FRAG_DATA0 = 16
FRAG_PARITY0 = 64

_EC_MAGIC = b"ICE1"
# magic, k, m, fragment index (0..k-1 data, k..k+m-1 parity), pad,
# original payload length, crc32 of the original payload
_EC_HEADER = struct.Struct("<4sBBBxQI")


def ec_fragment_replica(idx: int, k: int) -> int:
    """Fragment index (0..k+m-1) -> the ShardKey.replica it rides in."""
    return FRAG_DATA0 + idx if idx < k else FRAG_PARITY0 + (idx - k)


def ec_is_fragment(replica: int) -> bool:
    return replica >= FRAG_DATA0


def ec_is_parity(replica: int) -> bool:
    return replica >= FRAG_PARITY0


def ec_fragment_index(replica: int, k: int) -> int:
    """Inverse of :func:`ec_fragment_replica`."""
    if replica >= FRAG_PARITY0:
        return k + (replica - FRAG_PARITY0)
    return replica - FRAG_DATA0


def ec_encode_shard(payload: bytes, k: int, m: int) -> List[Tuple[int, bytes]]:
    """Payload -> [(replica, framed fragment blob)] for k data + m parity.

    Every fragment is self-describing (stripe geometry, its own index, the
    original length and crc), so any k surviving blobs reconstruct the
    payload with end-to-end integrity checking and no side-channel state.
    """
    data = split_rows(payload, k)
    parity = rs_encode_np(data, m)
    crc = crc32(payload)
    out: List[Tuple[int, bytes]] = []
    for idx in range(k + m):
        row = data[idx] if idx < k else parity[idx - k]
        hdr = _EC_HEADER.pack(_EC_MAGIC, k, m, idx, len(payload), crc)
        out.append((ec_fragment_replica(idx, k), hdr + row.tobytes()))
    return out


def ec_parse_fragment(blob: bytes) -> Tuple[int, int, int, int, int, bytes]:
    """Framed blob -> (k, m, idx, orig_len, crc, row bytes)."""
    if len(blob) < _EC_HEADER.size or blob[:4] != _EC_MAGIC:
        raise IntegrityError("not an erasure-coded fragment")
    magic, k, m, idx, orig_len, crc = _EC_HEADER.unpack_from(blob)
    return k, m, idx, orig_len, crc, blob[_EC_HEADER.size:]


def ec_decode_shard(fragments: Sequence[bytes]) -> bytes:
    """Any k framed fragments -> the original payload (crc-verified).

    Raises :class:`RestoreError` when fewer than k distinct fragments
    survive and :class:`IntegrityError` when the reconstruction does not
    match the payload crc carried in every fragment header.
    """
    rows: Dict[int, np.ndarray] = {}
    geom = None
    for blob in fragments:
        k, m, idx, orig_len, crc, row = ec_parse_fragment(blob)
        if geom is None:
            geom = (k, m, orig_len, crc)
        elif geom != (k, m, orig_len, crc):
            raise IntegrityError("mixed-stripe fragments in one decode")
        rows[idx] = np.frombuffer(row, dtype=np.uint8)
    if geom is None:
        raise RestoreError("ec decode with no fragments")
    k, m, orig_len, crc = geom
    if len(rows) < k:
        raise RestoreError(
            f"stripe lost: {len(rows)} of the {k} required fragments")
    data = rs_decode_np(rows, k, m)
    payload = join_rows(data, orig_len)
    if crc32(payload) != crc:
        raise IntegrityError("erasure reconstruction failed crc check")
    return payload


# ==========================================================================
# the tier protocol
# ==========================================================================
@runtime_checkable
class StorageTier(Protocol):
    """What the pipeline (and the controller's migration paths) rely on."""

    name: str
    level: float                 # 1.0 = RAM, 1.5 = local disk, 2.0 = PFS

    @property
    def capacity(self) -> float: ...
    @property
    def used_bytes(self) -> int: ...
    @property
    def free_bytes(self) -> float: ...

    def put(self, key: ShardKey, payload: bytes,
            crc: Optional[int] = None) -> None: ...
    def get(self, key: ShardKey, verify: bool = True) -> bytes: ...
    def has(self, key: ShardKey) -> bool: ...
    def drop(self, key: ShardKey) -> None: ...
    def keys(self) -> List[ShardKey]: ...
    def drop_checkpoint(self, app_id: str, ckpt_id: int) -> int: ...


# --------------------------------------------------------------------------
# L1: in-memory shard tier with capacity accounting
# --------------------------------------------------------------------------
class MemoryTier:
    name = "memory"
    level = 1.0

    def __init__(self, capacity_bytes: int):
        self._capacity = int(capacity_bytes)
        self._lock = threading.Lock()
        self._data: Dict[ShardKey, bytes] = {}
        self._crc: Dict[ShardKey, int] = {}
        self._used = 0

    @property
    def capacity(self) -> float:
        return self._capacity

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @property
    def free_bytes(self) -> float:
        with self._lock:
            return self._capacity - self._used

    def put(self, key: ShardKey, payload: bytes, crc: Optional[int] = None) -> None:
        payload = bytes(payload)
        with self._lock:
            old = len(self._data.get(key, b""))
            if self._used - old + len(payload) > self._capacity:
                raise CapacityError(
                    f"{self.name} tier over capacity: used={self._used} "
                    f"cap={self._capacity} put={len(payload)}")
            self._data[key] = payload
            self._crc[key] = crc32(payload) if crc is None else crc
            self._used += len(payload) - old

    def get(self, key: ShardKey, verify: bool = True) -> bytes:
        with self._lock:
            if key not in self._data:
                raise KeyError(key)
            payload = self._data[key]
            crc = self._crc[key]
        if verify and crc32(payload) != crc:
            raise IntegrityError(f"crc mismatch for {key}")
        return payload

    def has(self, key: ShardKey) -> bool:
        with self._lock:
            return key in self._data

    def drop(self, key: ShardKey) -> None:
        with self._lock:
            payload = self._data.pop(key, None)
            self._crc.pop(key, None)
            if payload is not None:
                self._used -= len(payload)

    def keys(self) -> List[ShardKey]:
        with self._lock:
            return list(self._data.keys())

    def drop_checkpoint(self, app_id: str, ckpt_id: int) -> int:
        freed = 0
        for k in self.keys():
            if k.app_id == app_id and k.ckpt_id == ckpt_id:
                with self._lock:
                    payload = self._data.pop(k, None)
                    self._crc.pop(k, None)
                    if payload is not None:
                        self._used -= len(payload)
                        freed += len(payload)
        return freed


# --------------------------------------------------------------------------
# L0.5: node-local disk spill (burst-buffer analogue)
# --------------------------------------------------------------------------
_SPILL_MAGIC = b"ICS1"


class LocalDiskTier:
    name = "local_disk"
    level = 1.5

    def __init__(self, root: str, capacity_bytes: int):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._capacity = int(capacity_bytes)
        self._lock = threading.Lock()
        self._index: Dict[ShardKey, int] = {}     # key -> payload nbytes
        self._used = 0

    @property
    def capacity(self) -> float:
        return self._capacity

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @property
    def free_bytes(self) -> float:
        with self._lock:
            return self._capacity - self._used

    def _path(self, key: ShardKey) -> str:
        return os.path.join(
            self.root, key.app_id, f"ckpt_{key.ckpt_id:08d}",
            key.region.replace("/", "__"),
            f"part_{key.part:05d}_r{key.replica}.bin")

    def put(self, key: ShardKey, payload: bytes, crc: Optional[int] = None) -> None:
        payload = bytes(payload)
        with self._lock:
            old = self._index.get(key, 0)
            had = key in self._index
            if self._used - old + len(payload) > self._capacity:
                raise CapacityError(
                    f"{self.name} tier over capacity: used={self._used} "
                    f"cap={self._capacity} put={len(payload)}")
            self._index[key] = len(payload)
            self._used += len(payload) - old
        crc = crc32(payload) if crc is None else crc
        path = self._path(key)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_SPILL_MAGIC + crc.to_bytes(4, "little"))
                f.write(payload)
            os.replace(tmp, path)
        except OSError:
            # roll back the reservation: the tier must not claim a shard
            # (or capacity) that has no backing file
            with self._lock:
                if had:
                    self._index[key] = old
                    self._used += old - len(payload)
                else:
                    self._index.pop(key, None)
                    self._used -= len(payload)
            raise

    def get(self, key: ShardKey, verify: bool = True) -> bytes:
        with self._lock:
            if key not in self._index:
                raise KeyError(key)
        with open(self._path(key), "rb") as f:
            blob = f.read()
        if blob[:4] != _SPILL_MAGIC:
            raise IntegrityError(f"bad spill magic for {key}")
        crc = int.from_bytes(blob[4:8], "little")
        payload = blob[8:]
        if verify and crc32(payload) != crc:
            raise IntegrityError(f"crc mismatch for spilled {key}")
        return payload

    def has(self, key: ShardKey) -> bool:
        with self._lock:
            return key in self._index

    def drop(self, key: ShardKey) -> None:
        with self._lock:
            nbytes = self._index.pop(key, None)
            if nbytes is not None:
                self._used -= nbytes
        if nbytes is not None:
            try:
                os.remove(self._path(key))
            except OSError:
                pass

    def keys(self) -> List[ShardKey]:
        with self._lock:
            return list(self._index.keys())

    def drop_checkpoint(self, app_id: str, ckpt_id: int) -> int:
        freed = 0
        for k in self.keys():
            if k.app_id == app_id and k.ckpt_id == ckpt_id:
                with self._lock:
                    nbytes = self._index.pop(k, None)
                if nbytes is not None:
                    freed += nbytes
                    with self._lock:
                        self._used -= nbytes
                    try:
                        os.remove(self._path(k))
                    except OSError:
                        pass
        return freed

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


# --------------------------------------------------------------------------
# L2: PFS container
# --------------------------------------------------------------------------
_SHARD_MAGIC = b"ICK1"


def _shard_path(root: str, key: ShardKey) -> str:
    return os.path.join(root, key.app_id, f"ckpt_{key.ckpt_id:08d}",
                        key.region.replace("/", "__"), f"part_{key.part:05d}.bin")


def _manifest_path(root: str, app_id: str, ckpt_id: int) -> str:
    return os.path.join(root, app_id, f"ckpt_{ckpt_id:08d}", "MANIFEST.json")


def region_doc(r: RegionMeta) -> dict:
    """JSON-serializable form of one RegionMeta — shared by the tier
    manifests and the control-plane metadata journal."""
    return {
        "shape": list(r.shape),
        "dtype": r.dtype,
        "nbytes": r.nbytes,
        "codec": r.codec,
        "frame": r.frame,
        "chain": list(r.chain) if r.chain is not None else None,
        "partition": {
            "scheme": r.partition.scheme.value,
            "axis": r.partition.axis,
            "num_parts": r.partition.num_parts,
            "block": r.partition.block,
            "bounds": r.partition.bounds,
        },
    }


def region_from_doc(name: str, r: dict) -> RegionMeta:
    chain = r.get("chain")
    return RegionMeta(
        name=name, shape=tuple(r["shape"]), dtype=r["dtype"],
        nbytes=r["nbytes"], codec=r.get("codec", "raw"),
        frame=r.get("frame"),
        chain=tuple(chain) if chain is not None else None,
        partition=PartitionDesc(
            scheme=PartitionScheme(r["partition"]["scheme"]),
            axis=r["partition"]["axis"],
            num_parts=r["partition"]["num_parts"],
            block=r["partition"]["block"],
            bounds=_tupled(r["partition"].get("bounds"))))


def _manifest_doc(meta: CheckpointMeta) -> dict:
    """Serializable manifest document (shared by the PFS and L3 tiers)."""
    return {
        "app_id": meta.app_id,
        "ckpt_id": meta.ckpt_id,
        "step": meta.step,
        "status": meta.status.value,
        "userdata_hex": meta.userdata.hex(),
        "regions": {name: region_doc(r) for name, r in meta.regions.items()},
    }


def _meta_from_manifest(doc: dict) -> CheckpointMeta:
    meta = CheckpointMeta(app_id=doc["app_id"], ckpt_id=doc["ckpt_id"],
                          step=doc["step"], status=CkptStatus(doc["status"]),
                          userdata=bytes.fromhex(doc.get("userdata_hex", "")))
    for name, r in doc["regions"].items():
        meta.regions[name] = region_from_doc(name, r)
    return meta


def _write_manifest_file(root: str, meta: CheckpointMeta) -> None:
    path = _manifest_path(root, meta.app_id, meta.ckpt_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_manifest_doc(meta), f)
    os.replace(tmp, path)


def _read_manifest_file(root: str, app_id: str,
                        ckpt_id: int) -> Optional[CheckpointMeta]:
    path = _manifest_path(root, app_id, ckpt_id)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return _meta_from_manifest(json.load(f))


def _list_manifest_ckpts(root: str, app_id: str) -> List[int]:
    base = os.path.join(root, app_id)
    if not os.path.isdir(base):
        return []
    out = []
    for d in os.listdir(base):
        if d.startswith("ckpt_") and os.path.exists(
                os.path.join(base, d, "MANIFEST.json")):
            out.append(int(d.split("_")[1]))
    return sorted(out)


class PFSTier:
    """Bandwidth-limited parallel-file-system tier.

    ``ingest`` is the aggregate PFS bandwidth all concurrent drains share —
    the resource the drain orchestrator rations (paper §II: "orchestrate the
    writing of the checkpoint data into PFS by minimizing the effect on
    running applications").  One file per shard so thousands of hosts can
    restore in parallel, plus a JSON manifest per checkpoint.
    """

    name = "pfs"
    level = 2.0

    def __init__(self, root: str, bandwidth: float = 40e9, compress: bool = False,
                 clock=None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.ingest = SimNIC("pfs", bandwidth, latency=1e-4, clock=clock)
        self.compress = bool(compress and _zstd is not None)
        self._lock = threading.Lock()

    # -- StorageTier protocol ---------------------------------------------
    @property
    def capacity(self) -> float:
        return float("inf")

    @property
    def used_bytes(self) -> int:
        total = 0
        for key in self.keys():
            try:
                total += os.path.getsize(_shard_path(self.root, key))
            except OSError:
                pass
        return total

    @property
    def free_bytes(self) -> float:
        return float("inf")

    def put(self, key: ShardKey, payload: bytes, crc: Optional[int] = None) -> None:
        self.write_shard(key, payload, crc)

    def get(self, key: ShardKey, verify: bool = True) -> bytes:
        return self.read_shard(key)

    def has(self, key: ShardKey) -> bool:
        return self.has_shard(key)

    def drop(self, key: ShardKey) -> None:
        try:
            os.remove(_shard_path(self.root, key))
        except OSError:
            pass

    def keys(self) -> List[ShardKey]:
        out: List[ShardKey] = []
        if not os.path.isdir(self.root):
            return out
        for app_id in os.listdir(self.root):
            base = os.path.join(self.root, app_id)
            if not os.path.isdir(base):
                continue
            for d in os.listdir(base):
                if not d.startswith("ckpt_"):
                    continue
                ckpt_id = int(d.split("_")[1])
                cdir = os.path.join(base, d)
                for region in os.listdir(cdir):
                    rdir = os.path.join(cdir, region)
                    if not os.path.isdir(rdir):
                        continue
                    for fn in os.listdir(rdir):
                        if fn.startswith("part_") and fn.endswith(".bin"):
                            part = int(fn[5:-4])
                            out.append(ShardKey(app_id, ckpt_id,
                                                region.replace("__", "/"), part))
        return out

    def drop_checkpoint(self, app_id: str, ckpt_id: int) -> int:
        base = os.path.join(self.root, app_id, f"ckpt_{ckpt_id:08d}")
        freed = 0
        if os.path.isdir(base):
            for dirpath, _, files in os.walk(base):
                for fn in files:
                    try:
                        freed += os.path.getsize(os.path.join(dirpath, fn))
                    except OSError:
                        pass
            shutil.rmtree(base, ignore_errors=True)
        return freed

    # -- shard IO ----------------------------------------------------------
    def write_shard(self, key: ShardKey, payload: bytes, crc: Optional[int] = None) -> float:
        raw_len = len(payload)
        if self.compress:
            payload = _zstd.ZstdCompressor(level=3).compress(bytes(payload))
        crc = crc32(payload)
        # simulate PFS ingest time on the *written* bytes
        dur = self.ingest.transfer(len(payload))
        path = _shard_path(self.root, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        header = _SHARD_MAGIC + crc.to_bytes(4, "little") + raw_len.to_bytes(8, "little") \
            + (b"Z" if self.compress else b"R")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)       # atomic publish
        return dur

    def read_shard(self, key: ShardKey) -> bytes:
        path = _shard_path(self.root, key)
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:4] != _SHARD_MAGIC:
            raise IntegrityError(f"bad magic in {path}")
        crc = int.from_bytes(blob[4:8], "little")
        raw_len = int.from_bytes(blob[8:16], "little")
        mode = blob[16:17]
        payload = blob[17:]
        if crc32(payload) != crc:
            raise IntegrityError(f"crc mismatch in {path}")
        self.ingest.transfer(len(payload))
        if mode == b"Z":
            payload = _zstd.ZstdDecompressor().decompress(payload, max_output_size=raw_len)
        return payload

    def has_shard(self, key: ShardKey) -> bool:
        return os.path.exists(_shard_path(self.root, key))

    # -- manifests -----------------------------------------------------------
    def write_manifest(self, meta: CheckpointMeta) -> None:
        _write_manifest_file(self.root, meta)

    def read_manifest(self, app_id: str, ckpt_id: int) -> Optional[CheckpointMeta]:
        return _read_manifest_file(self.root, app_id, ckpt_id)

    def list_checkpoints(self, app_id: str) -> List[int]:
        return _list_manifest_ckpts(self.root, app_id)

    def checkpoint_complete(self, meta: CheckpointMeta) -> bool:
        for name, region in meta.regions.items():
            for part in range(region.partition.num_parts):
                if not self.has_shard(ShardKey(meta.app_id, meta.ckpt_id, name, part)):
                    return False
        return True


# --------------------------------------------------------------------------
# L3: remote object store (S3/GCS analogue)
# --------------------------------------------------------------------------
_OBJECT_MAGIC = b"ICO1"


class RemoteObjectTier:
    """Remote object store behind the PFS — the durability floor (L3).

    What distinguishes an object store from the PFS, and what the lifecycle
    policies have to reason about:

      * every request pays a **latency floor** (``request_latency``, tens of
        milliseconds of HTTP/TLS round-trip) regardless of size — small
        objects are latency-bound, so restart cost is dominated by request
        count, not bytes;
      * a single connection is throughput-limited; large objects move as
        **multipart** transfers of ``part_bytes`` chunks with up to
        ``max_parallel_parts`` concurrent parts (the aggregate ``bandwidth``
        is still shared with every other in-flight operation);
      * capacity is **effectively unbounded** — ``put`` never raises
        :class:`CapacityError`;
      * nothing is free: ingress/egress bytes and every request are billed.
        :meth:`cost_usd` and :meth:`cost_breakdown` expose the running total
        so the retention policy's keep-last-K has a price signal.
    """

    name = "remote_object"
    level = 3.0

    def __init__(self, root: str, bandwidth: float = 5e9,
                 request_latency: float = 0.03, part_bytes: int = 8 << 20,
                 max_parallel_parts: int = 8, clock=None,
                 put_request_usd: float = 5e-6, get_request_usd: float = 4e-7,
                 egress_usd_per_gib: float = 0.09,
                 ingress_usd_per_gib: float = 0.0):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.link = SimNIC("l3-object-store", bandwidth, latency=0.0,
                           clock=clock)
        self.request_latency = float(request_latency)
        self.part_bytes = max(1, int(part_bytes))
        self.max_parallel_parts = max(1, int(max_parallel_parts))
        self.put_request_usd = float(put_request_usd)
        self.get_request_usd = float(get_request_usd)
        self.egress_usd_per_gib = float(egress_usd_per_gib)
        self.ingress_usd_per_gib = float(ingress_usd_per_gib)
        self._lock = threading.Lock()
        self._bytes_in = 0
        self._bytes_out = 0
        self._put_requests = 0
        self._get_requests = 0
        # event bus for retry_exhausted telemetry (wired by the controller)
        self.bus = None
        # fault injection: an unreachable object store (region outage).
        # Transfers raise ConnectionError; existence/listing probes answer
        # as an unreachable endpoint would (nothing visible) so restart
        # ladders fall back to L2/L1 instead of wedging on a read
        self._outage = False
        # payload bytes resident, kept incrementally: used_bytes is read on
        # every telemetry scrape and must not walk the whole object store.
        # One walk at attach time picks up objects from a previous
        # deployment (the cold-restart case).
        self._used = 0
        for key in self.keys():
            self._used += self._object_size(key)

    # -- cost accounting ----------------------------------------------------
    def cost_breakdown(self) -> dict:
        gib = float(1 << 30)
        with self._lock:
            bytes_in, bytes_out = self._bytes_in, self._bytes_out
            puts, gets = self._put_requests, self._get_requests
        return {
            "bytes_in": bytes_in,
            "bytes_out": bytes_out,
            "put_requests": puts,
            "get_requests": gets,
            "ingress_usd": bytes_in / gib * self.ingress_usd_per_gib,
            "egress_usd": bytes_out / gib * self.egress_usd_per_gib,
            "request_usd": puts * self.put_request_usd
            + gets * self.get_request_usd,
        }

    def cost_usd(self) -> float:
        c = self.cost_breakdown()
        return c["ingress_usd"] + c["egress_usd"] + c["request_usd"]

    # -- fault injection ----------------------------------------------------
    def set_outage(self, down: bool) -> None:
        """Make the object store unreachable (or reachable again)."""
        with self._lock:
            self._outage = bool(down)
        self.link.set_down(bool(down))

    @property
    def in_outage(self) -> bool:
        with self._lock:
            return self._outage

    def _check_reachable(self) -> None:
        if self.in_outage:
            raise ConnectionError(f"object store {self.root} unreachable")

    # -- transfer model -----------------------------------------------------
    def _xfer(self, nbytes: int, outbound: bool) -> float:
        """One object transfer, with bounded exponential backoff: a brief
        endpoint blip retries instead of failing the whole tier operation;
        a real outage exhausts the deadline, publishes ``retry_exhausted``
        and surfaces the ConnectionError to the caller."""
        return with_backoff(
            lambda: self._xfer_once(nbytes, outbound), 0.25,
            clock=self.link.clock, retry_on=(ConnectionError,),
            bus=self.bus, what=f"l3_{'get' if outbound else 'put'}")

    def _xfer_once(self, nbytes: int, outbound: bool) -> float:
        """One object transfer: multipart waves of latency + shared bw."""
        self._check_reachable()
        parts = max(1, -(-nbytes // self.part_bytes))
        waves = -(-parts // self.max_parallel_parts)
        lat = self.request_latency * waves
        self.link.clock.sleep(lat)
        dur = lat + self.link.transfer(nbytes)
        with self._lock:
            if outbound:
                self._bytes_out += nbytes
                self._get_requests += parts
            else:
                self._bytes_in += nbytes
                self._put_requests += parts
        return dur

    # -- StorageTier protocol -----------------------------------------------
    @property
    def capacity(self) -> float:
        return float("inf")

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @property
    def free_bytes(self) -> float:
        return float("inf")

    def put(self, key: ShardKey, payload: bytes, crc: Optional[int] = None) -> None:
        self.write_shard(key, payload, crc)

    def get(self, key: ShardKey, verify: bool = True) -> bytes:
        return self.read_shard(key)

    def has(self, key: ShardKey) -> bool:
        return self.has_shard(key)

    def _object_size(self, key: ShardKey) -> int:
        """Resident payload bytes of one object (0 if absent)."""
        try:
            return max(os.path.getsize(_shard_path(self.root, key)) - 8, 0)
        except OSError:
            return 0

    def drop(self, key: ShardKey) -> None:
        freed = self._object_size(key)
        try:
            os.remove(_shard_path(self.root, key))
        except OSError:
            return
        with self._lock:
            self._used -= freed

    def keys(self) -> List[ShardKey]:
        out: List[ShardKey] = []
        if not os.path.isdir(self.root):
            return out
        for app_id in os.listdir(self.root):
            base = os.path.join(self.root, app_id)
            if not os.path.isdir(base):
                continue
            for d in os.listdir(base):
                if not d.startswith("ckpt_"):
                    continue
                ckpt_id = int(d.split("_")[1])
                cdir = os.path.join(base, d)
                for region in os.listdir(cdir):
                    rdir = os.path.join(cdir, region)
                    if not os.path.isdir(rdir):
                        continue
                    for fn in os.listdir(rdir):
                        if fn.startswith("part_") and fn.endswith(".bin"):
                            part = int(fn[5:-4])
                            out.append(ShardKey(app_id, ckpt_id,
                                                region.replace("__", "/"),
                                                part))
        return out

    def drop_checkpoint(self, app_id: str, ckpt_id: int) -> int:
        base = os.path.join(self.root, app_id, f"ckpt_{ckpt_id:08d}")
        freed = 0
        payload_freed = 0
        if os.path.isdir(base):
            for dirpath, _, files in os.walk(base):
                for fn in files:
                    try:
                        size = os.path.getsize(os.path.join(dirpath, fn))
                    except OSError:
                        continue
                    freed += size
                    if fn.startswith("part_") and fn.endswith(".bin"):
                        payload_freed += max(size - 8, 0)
            shutil.rmtree(base, ignore_errors=True)
            with self._lock:
                self._used -= payload_freed
        return freed

    # -- object IO ----------------------------------------------------------
    def write_shard(self, key: ShardKey, payload: bytes,
                    crc: Optional[int] = None) -> float:
        payload = bytes(payload)
        crc = crc32(payload) if crc is None else crc
        dur = self._xfer(len(payload), outbound=False)
        old = self._object_size(key)
        path = _shard_path(self.root, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_OBJECT_MAGIC + crc.to_bytes(4, "little"))
            f.write(payload)
        os.replace(tmp, path)       # atomic publish, like a PUT completing
        with self._lock:
            self._used += len(payload) - old
        return dur

    def read_shard(self, key: ShardKey) -> bytes:
        path = _shard_path(self.root, key)
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:4] != _OBJECT_MAGIC:
            raise IntegrityError(f"bad object magic in {path}")
        crc = int.from_bytes(blob[4:8], "little")
        payload = blob[8:]
        if crc32(payload) != crc:
            raise IntegrityError(f"crc mismatch in {path}")
        self._xfer(len(payload), outbound=True)
        return payload

    def has_shard(self, key: ShardKey) -> bool:
        if self.in_outage:
            return False
        return os.path.exists(_shard_path(self.root, key))

    # -- manifests (same container contract as the PFS tier) ---------------
    def write_manifest(self, meta: CheckpointMeta) -> None:
        self._check_reachable()
        with self._lock:
            self._put_requests += 1
        _write_manifest_file(self.root, meta)

    def read_manifest(self, app_id: str, ckpt_id: int) -> Optional[CheckpointMeta]:
        if self.in_outage:
            return None
        # a manifest GET is small but still pays the request round-trip —
        # this is what makes a cold L3 catalog scan expensive in sim time
        self.link.clock.sleep(self.request_latency)
        with self._lock:
            self._get_requests += 1
        return _read_manifest_file(self.root, app_id, ckpt_id)

    def list_checkpoints(self, app_id: str) -> List[int]:
        if self.in_outage:
            return []
        # LIST round-trip, same latency floor as any other request
        self.link.clock.sleep(self.request_latency)
        with self._lock:
            self._get_requests += 1
        return _list_manifest_ckpts(self.root, app_id)

    def checkpoint_complete(self, meta: CheckpointMeta) -> bool:
        for name, region in meta.regions.items():
            for part in range(region.partition.num_parts):
                if not self.has_shard(ShardKey(meta.app_id, meta.ckpt_id,
                                               name, part)):
                    return False
        return True


# ==========================================================================
# the per-node pipeline
# ==========================================================================
class TierPipeline:
    """Ordered storage tiers of one iCheck node, fastest first.

    Drop-in for the old single-level ``MemoryStore``: puts land in the
    fastest tier with room (spilling down on :class:`CapacityError`), reads
    search top-down and promote a hit back into the fastest tier when it
    fits.  With a single :class:`MemoryTier` this degenerates to exactly the
    old behaviour, including raising ``CapacityError`` when full — which is
    what lets the controller escalate to the RM for more nodes (§III-A).
    """

    def __init__(self, tiers: Sequence[StorageTier], bus=None,
                 node_id: str = "?"):
        if not tiers:
            raise ICheckError("TierPipeline needs at least one tier")
        self.tiers = list(tiers)
        self.bus = bus
        self.node_id = node_id
        # compound operations (spill on put, promote on get) span tiers;
        # this lock makes them atomic w.r.t. each other, like the single
        # MemoryStore lock they replace (tier-internal locks are not enough:
        # a concurrent reader could observe a shard mid-promotion as absent
        # from both tiers)
        self._lock = threading.RLock()

    # -- capacity accounting (aggregated) ----------------------------------
    @property
    def capacity(self) -> float:
        return sum(t.capacity for t in self.tiers)

    @property
    def used_bytes(self) -> int:
        return sum(t.used_bytes for t in self.tiers)

    @property
    def free_bytes(self) -> float:
        return sum(t.free_bytes for t in self.tiers)

    def _publish(self, name: str, **kw) -> None:
        if self.bus is not None:
            self.bus.publish(name, **kw)

    # -- mapping interface (MemoryStore-compatible) ------------------------
    def put(self, key: ShardKey, payload: bytes, crc: Optional[int] = None) -> None:
        # events are published only after the pipeline lock is released:
        # a subscriber (e.g. the lifecycle service's watermark check) may
        # synchronously take *other* pipelines' locks, and publishing
        # under our lock would make that an ABBA deadlock
        spilled_into = None
        with self._lock:
            last_err: Optional[CapacityError] = None
            for i, tier in enumerate(self.tiers):
                try:
                    tier.put(key, payload, crc)
                except CapacityError as e:
                    last_err = e
                    continue
                if i > 0:
                    spilled_into = tier.name
                # a put supersedes any stale copy in other tiers
                for j, other in enumerate(self.tiers):
                    if j != i and other.has(key):
                        other.drop(key)
                break
            else:
                raise last_err if last_err is not None \
                    else CapacityError("no tiers")
        if spilled_into is not None:
            # spills happen under the putting agent's span (same thread), so
            # the span lands inside the trace tree; the id re-derivation
            # keeps even bare-pipeline spills attached to their checkpoint
            tracer = getattr(self.bus, "tracer", None)
            if tracer is not None:
                tracer.record("shard_spill",
                              trace_id_for(key.app_id, key.ckpt_id),
                              f"tiers/{self.node_id}", tier=spilled_into,
                              nbytes=len(payload))
            self._publish(_events.SHARD_SPILLED, node=self.node_id,
                          tier=spilled_into, key=str(key),
                          nbytes=len(payload))

    def get(self, key: ShardKey, verify: bool = True,
            promote: bool = True) -> bytes:
        """Top-down read; a lower-tier hit is promoted back into the fastest
        tier unless ``promote=False`` (the drain path reads spilled shards
        in place so it does not undo the watermark policy's demotions)."""
        with self._lock:
            for i, tier in enumerate(self.tiers):
                if not tier.has(key):
                    continue
                payload = tier.get(key, verify=verify)
                if i > 0 and promote:
                    self.promote(key, payload=payload, src=tier)
                return payload
            raise KeyError(key)

    def has(self, key: ShardKey) -> bool:
        with self._lock:
            return any(t.has(key) for t in self.tiers)

    def drop(self, key: ShardKey) -> None:
        with self._lock:
            for tier in self.tiers:
                tier.drop(key)

    def keys(self) -> List[ShardKey]:
        with self._lock:
            seen: Dict[ShardKey, None] = {}
            for tier in self.tiers:
                for k in tier.keys():
                    seen.setdefault(k, None)
            return list(seen.keys())

    def drop_checkpoint(self, app_id: str, ckpt_id: int) -> int:
        with self._lock:
            return sum(t.drop_checkpoint(app_id, ckpt_id) for t in self.tiers)

    # -- promotion / demotion ----------------------------------------------
    def promote(self, key: ShardKey, payload: Optional[bytes] = None,
                src: Optional[StorageTier] = None) -> bool:
        """Move a shard up into the fastest tier (best effort)."""
        with self._lock:
            top = self.tiers[0]
            if top.has(key):
                return False
            if src is None:
                src = next((t for t in self.tiers[1:] if t.has(key)), None)
                if src is None:
                    return False
            if payload is None:
                payload = src.get(key, verify=False)
            try:
                top.put(key, payload)
            except CapacityError:
                return False
            src.drop(key)
        self._publish(_events.SHARD_PROMOTED, node=self.node_id, key=str(key),
                      src=src.name, dst=top.name, nbytes=len(payload))
        return True

    def demote(self, key: ShardKey) -> bool:
        """Push a shard from the fastest tier one level down (free RAM).

        A demotion that cannot happen publishes ``DEMOTE_FAILED`` with the
        reason instead of only returning ``False`` — the lifecycle service's
        watermark decisions have to stay observable.  Events are published
        after the lock is released (see :meth:`put`).
        """
        failure = None
        nbytes = 0
        with self._lock:
            if len(self.tiers) < 2:
                failure = {"reason": "no_lower_tier"}
            elif not self.tiers[0].has(key):
                failure = {"reason": "not_resident"}
            else:
                payload = self.tiers[0].get(key, verify=False)
                nbytes = len(payload)
                try:
                    self.tiers[1].put(key, payload)
                except CapacityError:
                    failure = {"reason": "lower_tier_full",
                               "tier": self.tiers[1].name}
                else:
                    self.tiers[0].drop(key)
        if failure is not None:
            self._publish(_events.DEMOTE_FAILED, node=self.node_id,
                          key=str(key), **failure)
            return False
        # structured app/ckpt/region fields ride along so chain owners (the
        # catalog resets a delta chain whose frames get demoted) don't have
        # to parse the stringified key
        self._publish(_events.SHARD_DEMOTED, node=self.node_id,
                      src=self.tiers[0].name, dst=self.tiers[1].name,
                      key=str(key), nbytes=nbytes, app=key.app_id,
                      ckpt=key.ckpt_id, region=key.region)
        return True

    def close(self) -> None:
        for tier in self.tiers:
            closer = getattr(tier, "close", None)
            if closer is not None:
                closer()
