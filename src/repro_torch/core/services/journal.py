"""Write-ahead metadata journal + epoch fencing — the crash-consistent
control plane.

The catalog's in-memory state (checkpoint lifecycle, delta chains, holds,
pins, EC stripe placement) is the one thing a controller crash used to
destroy: every durable byte in L1/L2/L3 was orphaned except what the slow
cold-L3 manifest scan could rediscover.  :class:`MetadataJournal` fixes
that with the classic WAL discipline:

  * every catalog mutation is appended as a **length-prefixed, CRC-framed
    record** to a PFS-backed journal segment *before* the in-memory state
    changes (``IJL1 | u32 len | u32 crc32(body) | JSON body``);
  * periodic **compacted snapshots** (the full serialized state doc,
    written atomically, then the WAL truncated) keep replay O(live state)
    rather than O(history);
  * replay stops cleanly at a truncated or CRC-corrupt tail record — the
    torn final write of a crashing controller loses at most the mutation
    that was never acked;
  * record application is **idempotent** (set/overwrite semantics keyed by
    ids), so double replay of a tail is harmless.

:class:`EpochFence` is the companion zombie-guard: recovery bumps the
controller epoch, every agent inbox op / drain queue entry / RM interaction
is stamped with the epoch current at submit time, and validators raise
:class:`StaleEpochError` for anything stamped before the recovery.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Tuple
from zlib import crc32

from ..types import (CheckpointMeta, CkptStatus, ICheckError, ShardInfo,
                     ShardKey)

JOURNAL_MAGIC = b"IJL1"
_HEADER = len(JOURNAL_MAGIC) + 4 + 4        # magic + body len + body crc

# Record kinds that may sit in the process write buffer until the next
# barrier record: losing one to a crash never changes journaled *truth*.
# Shard and status records are rediscovered by the recovery reconciliation
# pass (it probes the live tiers and settles each checkpoint where its
# bytes actually are); tier moves and EC stripe placements are audit-only.
# Every other kind — new_ckpt (the identity record that defines per-app
# truth), app/region, pins, chain ops, epoch — is a durability barrier and
# flushes the whole buffered run ahead of it, preserving order.
_LAZY_KINDS = frozenset({"shard", "status", "tier_move", "ec_stripe"})


class StaleEpochError(ICheckError):
    """An op stamped with a pre-recovery controller epoch was refused."""


class EpochFence:
    """Monotonic controller epoch, bumped on every warm recovery.

    ``current`` is stamped on outbound work at submit time; ``check``
    refuses anything stamped with an older epoch.  ``None`` epochs pass —
    unstamped ops come from actors that never route through a recoverable
    controller (direct test harness calls)."""

    def __init__(self, epoch: int = 0):
        self._lock = threading.Lock()
        self._epoch = int(epoch)

    @property
    def current(self) -> int:
        with self._lock:
            return self._epoch

    def bump(self, at_least: Optional[int] = None) -> int:
        """Advance the epoch (to ``at_least`` when that is newer)."""
        with self._lock:
            self._epoch += 1
            if at_least is not None:
                self._epoch = max(self._epoch, int(at_least))
            return self._epoch

    def check(self, epoch: Optional[int], what: str = "op") -> None:
        if epoch is None:
            return
        cur = self.current
        if int(epoch) != cur:
            raise StaleEpochError(
                f"stale-epoch {what}: stamped {epoch}, fence at {cur}")


# --------------------------------------------------------------------------
# serialization helpers (shared with Controller.recover)
# --------------------------------------------------------------------------
def _region_docs(regions: dict) -> dict:
    from ..tiers import region_doc
    return {name: region_doc(r) for name, r in regions.items()}


def meta_from_ckpt_doc(app_id: str, doc: dict) -> CheckpointMeta:
    """Rebuild a CheckpointMeta (regions + shard index) from a journaled
    checkpoint doc."""
    from ..tiers import region_from_doc
    meta = CheckpointMeta(
        app_id=app_id, ckpt_id=int(doc["ckpt"]), step=int(doc["step"]),
        status=CkptStatus(doc.get("status", "pending")),
        userdata=bytes.fromhex(doc.get("userdata_hex", "")),
        pinned=bool(doc.get("pinned", False)))
    for name, r in doc.get("regions", {}).items():
        meta.regions[name] = region_from_doc(name, r)
    for s in doc.get("shards", {}).values():
        key = ShardKey(*s["key"][:3], int(s["key"][3]), int(s["key"][4]))
        meta.shards[key] = ShardInfo(key=key, nbytes=int(s["nbytes"]),
                                     crc32=int(s["crc"]),
                                     agent_id=s.get("agent"))
    return meta


@dataclasses.dataclass
class RecoveredState:
    """What replay (snapshot + tail) yields: the journal's view of truth."""

    epoch: int = 0
    # app_id -> {"ranks", "replication", "ec", "interval_s",
    #            "bytes_estimate", "next_ckpt", "regions", "ckpts"}
    apps: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # (app, region) -> chain frame ids open at crash time
    open_chains: Dict[Tuple[str, str], tuple] = \
        dataclasses.field(default_factory=dict)
    # (app, region) -> hold refcount open at crash time (overlap windows)
    holds: Dict[Tuple[str, str], int] = \
        dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=dict)

    def truth(self) -> Dict[str, int]:
        """Per-app max journaled checkpoint id (-1 when none)."""
        out = {}
        for app_id, app in self.apps.items():
            cids = [int(c) for c in app.get("ckpts", {})]
            out[app_id] = max(cids) if cids else -1
        return out


def _blank_app() -> dict:
    return {"ranks": 0, "replication": 1, "ec": None, "interval_s": 60.0,
            "bytes_estimate": 0, "next_ckpt": 0, "regions": {}, "ckpts": {}}


def apply_record(state: dict, rec: dict) -> None:
    """Apply one journal record to a state doc (idempotent)."""
    kind = rec.get("kind")
    apps = state.setdefault("apps", {})
    if kind == "epoch":
        state["epoch"] = max(int(state.get("epoch", 0)), int(rec["epoch"]))
        return
    if kind in ("tier_move", "ec_stripe"):
        # placement/audit records: probed live at reconcile time, nothing
        # to fold into the replayed catalog state
        return
    app_id = rec.get("app")
    if app_id is None:
        return
    app = apps.setdefault(app_id, _blank_app())
    if kind == "open_app":
        return
    if kind == "app":
        app.update(ranks=int(rec["ranks"]),
                   replication=int(rec.get("replication", 1)),
                   ec=rec.get("ec"),
                   interval_s=float(rec.get("interval_s", 60.0)),
                   bytes_estimate=int(rec.get("bytes_estimate", 0)))
        return
    if kind == "region":
        app["regions"][rec["name"]] = rec["doc"]
        return
    if kind == "new_ckpt":
        cid = int(rec["ckpt"])
        app["ckpts"][str(cid)] = {
            "ckpt": cid, "step": int(rec["step"]), "status": "pending",
            "userdata_hex": rec.get("userdata_hex", ""),
            "regions": rec.get("regions", {}), "shards": {}}
        app["next_ckpt"] = max(int(app["next_ckpt"]), cid + 1)
        return
    if kind == "shard":
        ck = app["ckpts"].get(str(int(rec["ckpt"])))
        if ck is not None:
            k = rec["key"]
            ck["shards"][f"{k[2]}/{k[3]}/{k[4]}"] = {
                "key": k, "nbytes": int(rec["nbytes"]),
                "crc": int(rec["crc"]), "agent": rec.get("agent")}
        return
    if kind == "status":
        ck = app["ckpts"].get(str(int(rec["ckpt"])))
        if ck is not None:
            ck["status"] = rec["status"]
        return
    if kind == "pin":
        ck = app["ckpts"].get(str(int(rec["ckpt"])))
        if ck is not None:
            ck["pinned"] = bool(rec.get("pinned", True))
        return
    chains = state.setdefault("chains", {})
    holds = state.setdefault("holds", {})
    ckey = f"{app_id}\x00{rec.get('region', '')}"
    if kind == "chain_advance":
        chains[ckey] = list(rec["chain"])
    elif kind == "chain_reset":
        chains.pop(ckey, None)
    elif kind == "chain_hold":
        holds[ckey] = int(holds.get(ckey, 0)) + 1
    elif kind == "chain_release":
        n = int(holds.get(ckey, 0)) - 1
        if n <= 0:
            holds.pop(ckey, None)
        else:
            holds[ckey] = n
    # unknown kinds are ignored: a newer journal replayed by older code
    # loses nothing it understands


class MetadataJournal:
    """PFS-backed write-ahead journal for the checkpoint catalog.

    ``append`` frames one JSON record and flushes it to the WAL segment
    *before* the caller mutates in-memory state; ``write_snapshot``
    atomically publishes a compacted state doc and truncates the WAL.
    ``replay_state`` folds snapshot + surviving tail records into a
    :class:`RecoveredState`.

    The simulated append cost (``len(frame) / byte_rate`` on the shared
    clock) models a dedicated low-latency metadata log device — the WAL is
    tiny sequential writes, deliberately *not* routed through the PFS
    ingest NIC whose per-op latency would put ~0.1 ms on every catalog
    mutation."""

    def __init__(self, root: str, clock=None, byte_rate: float = 2e9,
                 fsync: bool = False, compact_every: int = 256):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.wal_path = os.path.join(root, "wal.bin")
        self.snap_path = os.path.join(root, "snapshot.json")
        self.clock = clock
        self.byte_rate = float(byte_rate)
        self.fsync = bool(fsync)
        self.compact_every = max(1, int(compact_every))
        self.enabled = True
        self._lock = threading.RLock()
        self.appends = 0
        self.appends_since_snapshot = 0
        self.snapshots = 0
        self.bytes_appended = 0
        self._truth: Dict[str, int] = {}
        # warm reopen: pick up truth from whatever is already on disk
        state, _ = self.read_state()
        for app_id, hi in RecoveredState(apps=state.get("apps", {})) \
                .truth().items():
            self._truth[app_id] = hi
        self._fh = open(self.wal_path, "ab")

    # ------------------------------------------------------------- writing
    def append(self, kind: str, **fields) -> None:
        """Frame + flush one record.  MUST be called before the in-memory
        mutation it describes becomes visible."""
        if not self.enabled:
            return
        rec = {"kind": kind, **fields}
        body = json.dumps(rec, separators=(",", ":")).encode()
        frame = JOURNAL_MAGIC + len(body).to_bytes(4, "little") \
            + crc32(body).to_bytes(4, "little") + body
        with self._lock:
            self._fh.write(frame)
            if kind not in _LAZY_KINDS:
                self._fh.flush()
                if self.fsync:
                    os.fsync(self._fh.fileno())
            self.appends += 1
            self.appends_since_snapshot += 1
            self.bytes_appended += len(frame)
            if kind == "new_ckpt":
                app_id = fields["app"]
                self._truth[app_id] = max(self._truth.get(app_id, -1),
                                          int(fields["ckpt"]))
        if self.clock is not None and self.byte_rate > 0:
            self.clock.sleep(len(frame) / self.byte_rate)

    def compaction_due(self) -> bool:
        with self._lock:
            return self.enabled and \
                self.appends_since_snapshot >= self.compact_every

    def write_snapshot(self, state: dict) -> None:
        """Atomically publish a compacted snapshot and truncate the WAL.

        Call with the catalog lock held so the doc is a consistent cut:
        records folded into the snapshot must not also survive in the
        tail."""
        if not self.enabled:
            return
        with self._lock:
            tmp = self.snap_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            self._fh.close()
            self._fh = open(self.wal_path, "wb")    # truncate
            self.appends_since_snapshot = 0
            self.snapshots += 1

    # ------------------------------------------------------------- reading
    def read_frames(self) -> Tuple[List[dict], dict]:
        """Decode the WAL tail; stops at the first truncated or CRC-corrupt
        frame (the torn final write of a crash) without raising."""
        records: List[dict] = []
        stats = {"frames": 0, "truncated": 0, "crc_bad": 0}
        with self._lock:
            fh = getattr(self, "_fh", None)
            if fh is not None and not fh.closed:
                fh.flush()      # surface any lazily-buffered tail records
        try:
            with open(self.wal_path, "rb") as f:
                blob = f.read()
        except OSError:
            return records, stats
        off = 0
        while off + _HEADER <= len(blob):
            if blob[off:off + 4] != JOURNAL_MAGIC:
                stats["crc_bad"] += 1
                break
            n = int.from_bytes(blob[off + 4:off + 8], "little")
            crc = int.from_bytes(blob[off + 8:off + 12], "little")
            body = blob[off + 12:off + 12 + n]
            if len(body) < n:
                stats["truncated"] += 1
                break
            if crc32(body) != crc:
                stats["crc_bad"] += 1
                break
            try:
                records.append(json.loads(body))
            except ValueError:
                stats["crc_bad"] += 1
                break
            stats["frames"] += 1
            off += 12 + n
        else:
            if off < len(blob):
                stats["truncated"] += 1
        return records, stats

    def read_state(self) -> Tuple[dict, dict]:
        """Snapshot + tail folded into one state doc (plus replay stats)."""
        state: dict = {"epoch": 0, "apps": {}, "chains": {}, "holds": {}}
        stats = {"snapshot": False, "frames": 0, "truncated": 0,
                 "crc_bad": 0}
        try:
            with open(self.snap_path) as f:
                snap = json.load(f)
            state.update(snap)
            state.setdefault("chains", {})
            state.setdefault("holds", {})
            stats["snapshot"] = True
        except (OSError, ValueError):
            pass
        records, tail_stats = self.read_frames()
        stats.update({k: tail_stats[k]
                      for k in ("frames", "truncated", "crc_bad")})
        for rec in records:
            apply_record(state, rec)
        return state, stats

    def replay_state(self) -> RecoveredState:
        state, stats = self.read_state()
        rs = RecoveredState(epoch=int(state.get("epoch", 0)),
                            apps=state.get("apps", {}), stats=stats)
        for ckey, chain in state.get("chains", {}).items():
            app_id, _, region = ckey.partition("\x00")
            rs.open_chains[(app_id, region)] = tuple(chain)
        for ckey, n in state.get("holds", {}).items():
            app_id, _, region = ckey.partition("\x00")
            rs.holds[(app_id, region)] = int(n)
        return rs

    def truth(self) -> Dict[str, int]:
        """Per-app max checkpoint id ever journaled (the 'never newer than
        journaled truth' bound the recovery_fidelity invariant enforces)."""
        with self._lock:
            return dict(self._truth)

    def stats(self) -> dict:
        with self._lock:
            return {"appends": self.appends,
                    "appends_since_snapshot": self.appends_since_snapshot,
                    "snapshots": self.snapshots,
                    "bytes_appended": self.bytes_appended,
                    "enabled": self.enabled}

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass
            self.enabled = False

    # -- doc builders (called by the controller under its lock) ------------
    @staticmethod
    def ckpt_doc(meta: CheckpointMeta) -> dict:
        return {
            "ckpt": meta.ckpt_id, "step": meta.step,
            "status": meta.status.value,
            "userdata_hex": meta.userdata.hex(),
            "pinned": meta.pinned,
            "regions": _region_docs(meta.regions),
            "shards": {
                f"{k.region}/{k.part}/{k.replica}": {
                    "key": [k.app_id, k.ckpt_id, k.region, k.part,
                            k.replica],
                    "nbytes": s.nbytes, "crc": s.crc32,
                    "agent": s.agent_id}
                for k, s in meta.shards.items()},
        }
