"""Checkpoint catalog: lifecycle registry + multi-level restart read path.

Owns the PENDING → IN_L1 → DRAINING → IN_L2 → IN_L3 state machine of every
checkpoint (paper §II) and answers "what is the newest restartable
checkpoint and where does each shard live" — L1 via any live holding agent
(replicas tried in turn), else L2 (PFS), else L3 (remote object store,
promote-on-read back into the PFS) — including the cold-restart scan of PFS
manifests (then L3 manifests, when the PFS is empty too) when a fresh
controller knows nothing yet.

Also owns the **q8-delta chain state** of the incremental commit path: per
(app, region) the previous-codes handles every part's next delta encodes
against, the keyframe-every-K policy, and the mandatory resets — on
resize/redistribution (the controller calls :meth:`reset_delta_chains` when
a region's partition changes), on rank/agent/node failure, on demotion of a
chain frame out of L1, and on retention expiry of a chain frame.  After a
reset the next commit of that region emits a full keyframe; a restore
replays keyframe + deltas (``chain`` on the per-checkpoint RegionMeta).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ...obs import trace_id_for
from .. import events as E
from ..tiers import (FRAG_DATA0, FRAG_PARITY0, DeltaState, ec_decode_shard,
                     ec_parse_fragment)
from ..types import (AppId, CheckpointMeta, CkptId, CkptStatus, ICheckError,
                     IntegrityError, RegionMeta, ShardInfo, ShardKey)

# any of these may have destroyed (or made unreachable) an L1-only delta
# frame, or invalidated the codes the application will diff against next:
# the affected chains reset so the next commit is a self-contained keyframe
_CHAIN_RESET_EVENTS = (E.APP_RANK_FAILED, E.NODE_FAILED, E.AGENT_FAILED,
                       E.NODE_RETAKEN, E.MIGRATION_LOST_SHARD, E.CKPT_FAILED,
                       E.CKPT_EXPIRED, E.SHARD_DEMOTED)


@dataclasses.dataclass
class RegionChain:
    """Live delta chain of one region: frame ckpt ids + per-part handles."""

    chain: Tuple[CkptId, ...]            # keyframe first, newest last
    parts: Dict[int, DeltaState]         # part -> previous-codes handle


class CheckpointCatalog:
    # while a zero-stall resize holds a chain open, the keyframe-every-K
    # horizon stretches by this factor (a safety cap, not a policy: the
    # overlap window is short, but a wedged cutover must not let the chain
    # grow without bound)
    HOLD_HORIZON_FACTOR = 4

    def __init__(self, ctl, delta_keyframe_every: int = 8):
        self.ctl = ctl
        self._seq: Dict[AppId, itertools.count] = {}
        self.delta_keyframe_every = max(1, int(delta_keyframe_every))
        self._kf_every: Dict[AppId, int] = {}
        self._chain_lock = threading.Lock()
        self._chains: Dict[Tuple[AppId, str], RegionChain] = {}
        # (app, region) -> refcount of open overlap windows; a held chain
        # keeps producing deltas past the keyframe horizon so the window's
        # commits stay replayable tail frames (reset still happens normally
        # — the cutover detects it and re-hydrates instead)
        self._holds: Dict[Tuple[AppId, str], int] = {}
        self._unsub_chain = ctl.bus.subscribe(self._on_chain_event,
                                              events=_CHAIN_RESET_EVENTS)

    def close(self) -> None:
        self._unsub_chain()

    def _journal(self, kind: str, **fields) -> None:
        """Append one WAL record *before* the mutation it describes (no-op
        when the controller runs without a metadata journal)."""
        j = getattr(self.ctl, "journal", None)
        if j is not None:
            j.append(kind, **fields)

    # ------------------------------------------------------------- lifecycle
    def open_app(self, app_id: AppId) -> None:
        self._journal("open_app", app=app_id)
        self._seq[app_id] = itertools.count()

    def set_seq(self, app_id: AppId, next_ckpt: int) -> None:
        """Re-seat the id sequence past recovered history (recovery path)."""
        self._seq[app_id] = itertools.count(int(next_ckpt))

    def new_checkpoint(self, app_id: AppId, step: int,
                       regions: Dict[str, RegionMeta],
                       userdata: bytes = b"") -> CheckpointMeta:
        ctl = self.ctl
        with ctl._lock:
            app = ctl._apps.get(app_id)
            if app is None or app_id not in self._seq:
                raise ICheckError(f"app {app_id} is not registered")
            ckpt_id = next(self._seq[app_id])
            meta = CheckpointMeta(app_id=app_id, ckpt_id=ckpt_id, step=step,
                                  regions=dict(regions), userdata=userdata)
            from ..tiers import region_doc
            self._journal("new_ckpt", app=app_id, ckpt=ckpt_id, step=step,
                          userdata_hex=userdata.hex(),
                          regions={n: region_doc(r)
                                   for n, r in meta.regions.items()})
            app.checkpoints[ckpt_id] = meta
            total = sum(r.nbytes for r in regions.values())
            app.ckpt_bytes_estimate = max(app.ckpt_bytes_estimate, total)
        return meta

    def record_shard(self, meta: CheckpointMeta, info: ShardInfo) -> None:
        with self.ctl._lock:
            k = info.key
            self._journal("shard", app=meta.app_id, ckpt=meta.ckpt_id,
                          key=[k.app_id, k.ckpt_id, k.region, k.part,
                               k.replica],
                          nbytes=info.nbytes, crc=info.crc32,
                          agent=info.agent_id)
            meta.shards[info.key] = info

    def set_status(self, meta: CheckpointMeta, status: CkptStatus) -> None:
        """The single write path for checkpoint status transitions: WAL
        first, then the in-memory flip (under the controller lock)."""
        with self.ctl._lock:
            if meta.status is status:
                return
            self._journal("status", app=meta.app_id, ckpt=meta.ckpt_id,
                          status=status.value)
            meta.status = status

    def finalize(self, meta: CheckpointMeta, drain: bool = True) -> None:
        """All shards acked in L1 → durable pipeline."""
        ctl = self.ctl
        with ctl._lock:
            if not meta.is_complete_in_l1():
                raise ICheckError(
                    f"checkpoint {meta.ckpt_id} incomplete: "
                    f"{len(meta.shards)}/{meta.expected_shards()} shards")
            self.set_status(meta, CkptStatus.IN_L1)
            meta.completed_at = ctl.clock.now()
        ctl.bus.publish(E.CKPT_IN_L1, app=meta.app_id, ckpt=meta.ckpt_id,
                        step=meta.step)
        ctl.maybe_compact_journal()
        if drain:
            ctl.drains.submit(meta)

    # ---------------------------------------------------- q8-delta chains
    def keyframe_every(self, app_id: AppId) -> int:
        return self._kf_every.get(app_id, self.delta_keyframe_every)

    def set_keyframe_every(self, app_id: AppId, k: Optional[int]) -> None:
        """Per-app keyframe cadence override (None restores the default)."""
        if k is None:
            self._kf_every.pop(app_id, None)
        else:
            self._kf_every[app_id] = max(1, int(k))

    def delta_chain(self, app_id: AppId, region: str,
                    num_parts: int) -> Optional[RegionChain]:
        """Previous-codes state the next commit of ``region`` may delta
        against, or None when a keyframe is due (no chain, chain at the
        keyframe-every-K horizon, or a part-count mismatch).  A held chain
        (open overlap window) stretches the horizon so the window's commits
        keep extending the replayable tail instead of keyframing under it."""
        with self._chain_lock:
            rc = self._chains.get((app_id, region))
            horizon = self.keyframe_every(app_id)
            if self._holds.get((app_id, region), 0) > 0:
                horizon *= self.HOLD_HORIZON_FACTOR
            if rc is None or len(rc.chain) >= horizon:
                return None
            if set(rc.parts) != set(range(num_parts)):
                return None
            return rc

    def hold_chain(self, app_id: AppId, region: str) -> None:
        """Keep ``region``'s chain open across a zero-stall resize window
        (ref-counted; pair with :meth:`release_chain`)."""
        with self._chain_lock:
            k = (app_id, region)
            self._journal("chain_hold", app=app_id, region=region)
            self._holds[k] = self._holds.get(k, 0) + 1

    def release_chain(self, app_id: AppId, region: str) -> None:
        with self._chain_lock:
            k = (app_id, region)
            self._journal("chain_release", app=app_id, region=region)
            n = self._holds.get(k, 0) - 1
            if n <= 0:
                self._holds.pop(k, None)
            else:
                self._holds[k] = n

    def advance_chain(self, app_id: AppId, ckpt_id: CkptId, region: str,
                      states: Optional[Dict[int, DeltaState]],
                      frame: str) -> Tuple[CkptId, ...]:
        """Record the frame a commit just encoded; returns the region's new
        chain (what the per-checkpoint RegionMeta must carry for replay)."""
        with self._chain_lock:
            if states is None:          # chainless (non-float passthrough)
                if (app_id, region) in self._chains:
                    self._journal("chain_reset", app=app_id, region=region,
                                  reason="chainless")
                self._chains.pop((app_id, region), None)
                return (ckpt_id,)
            if frame == "key":
                chain: Tuple[CkptId, ...] = (ckpt_id,)
            else:
                rc = self._chains.get((app_id, region))
                if rc is None:
                    raise ICheckError(
                        f"delta frame for {app_id}/{region} without a chain")
                chain = rc.chain + (ckpt_id,)
            self._journal("chain_advance", app=app_id, region=region,
                          chain=list(chain))
            self._chains[(app_id, region)] = RegionChain(chain=chain,
                                                         parts=dict(states))
            return chain

    def reset_delta_chains(self, app_id: Optional[AppId] = None,
                           region: Optional[str] = None,
                           reason: str = "") -> int:
        """Drop matching chains (all when ``app_id`` is None); every dropped
        chain publishes ``DELTA_CHAIN_RESET`` so the policy stays observable.
        """
        with self._chain_lock:
            victims = [k for k in self._chains
                       if (app_id is None or k[0] == app_id)
                       and (region is None or k[1] == region)]
            for app, reg in victims:
                self._journal("chain_reset", app=app, region=reg,
                              reason=reason)
            dropped = [(k, self._chains.pop(k)) for k in victims]
        for (app, reg), rc in dropped:
            self.ctl.bus.publish(E.DELTA_CHAIN_RESET, app=app, region=reg,
                                 reason=reason, chain_len=len(rc.chain))
        return len(dropped)

    def _reset_chains_containing(self, app_id: Optional[AppId],
                                 ckpt_id: Optional[CkptId],
                                 region: Optional[str],
                                 reason: str) -> None:
        """Reset chains that have ``ckpt_id`` as one of their frames (a
        demoted or expired frame makes the replay path slow or impossible)."""
        if app_id is None or ckpt_id is None:
            return
        with self._chain_lock:
            victims = [k for k, rc in self._chains.items()
                       if k[0] == app_id and ckpt_id in rc.chain
                       and (region is None or k[1] == region)]
        for app, reg in victims:
            self.reset_delta_chains(app, reg, reason=reason)

    def _on_chain_event(self, ev: E.Event) -> None:
        name, p = ev.name, ev.payload
        if name in (E.APP_RANK_FAILED, E.CKPT_FAILED):
            self.reset_delta_chains(app_id=p.get("app"), reason=name)
        elif name in (E.CKPT_EXPIRED, E.SHARD_DEMOTED):
            self._reset_chains_containing(p.get("app"), p.get("ckpt"),
                                          p.get("region"), reason=name)
        else:   # node/agent failure, retake, migration loss: L1-only frames
            # may be gone — a keyframe next commit beats decoding garbage
            self.reset_delta_chains(reason=name)

    def chain_stats(self) -> List[dict]:
        with self._chain_lock:
            return [{"app": app, "region": region,
                     "chain_len": len(rc.chain), "root": rc.chain[0],
                     "head": rc.chain[-1]}
                    for (app, region), rc in self._chains.items()]

    def chain_holds(self) -> Dict[Tuple[AppId, str], int]:
        """Open hold refcounts per (app, region) — empty once every overlap
        window has closed (the chaos no-leak invariant reads this)."""
        with self._chain_lock:
            return dict(self._holds)

    # ------------------------------------------------------------- failure
    def mark_failed(self, app_id: AppId, ckpt_id: CkptId) -> None:
        """Mark a checkpoint failed, cascading to its q8-delta dependents:
        any non-durable checkpoint whose replay chain references the failed
        frame can never be reconstructed, so ``latest_restartable`` must
        skip it (and fall back to an older intact checkpoint)."""
        ctl = self.ctl
        failed = []
        with ctl._lock:
            app = ctl._apps.get(app_id)
            meta = app.checkpoints.get(ckpt_id) if app else None
            if meta is not None and meta.status not in (CkptStatus.IN_L2,
                                                        CkptStatus.IN_L3):
                victims = [meta]
                for dep in app.checkpoints.values():
                    if dep.ckpt_id == ckpt_id or \
                            dep.status in (CkptStatus.IN_L2, CkptStatus.IN_L3,
                                           CkptStatus.FAILED):
                        continue
                    if any(r.chain and ckpt_id in r.chain
                           for r in dep.regions.values()):
                        victims.append(dep)
                for v in victims:       # WAL first, then the state flips
                    self.set_status(v, CkptStatus.FAILED)
                    failed.append(v.ckpt_id)
        for cid in failed:
            ctl.bus.publish(E.CKPT_FAILED, app=app_id, ckpt=cid)

    # ------------------------------------------------------------- read path
    def latest_restartable(self, app_id: AppId) -> Optional[Tuple[CheckpointMeta, str]]:
        """Newest usable checkpoint: L1 preferred (fast), else L2, else L3.

        A q8-delta checkpoint is only usable if its whole replay chain is
        still fetchable from *some* tier — a candidate whose keyframe or a
        mid-chain delta is gone (e.g. a partially-drained chain on a cold
        restart) is skipped in favour of an older intact checkpoint.
        """
        ctl = self.ctl
        l3 = getattr(ctl, "l3", None)
        with ctl._lock:
            app = ctl._apps.get(app_id)
            metas = sorted(app.checkpoints.values(), key=lambda m: -m.ckpt_id) \
                if app else []
        for meta in metas:
            if meta.status in (CkptStatus.IN_L1, CkptStatus.DRAINING) \
                    and self.l1_complete(meta) and self.chain_restorable(meta):
                return meta, "l1"
            if meta.status in (CkptStatus.IN_L2, CkptStatus.IN_L3):
                if not self.chain_restorable(meta):
                    continue
                if self.l1_complete(meta):
                    return meta, "l1"
                if ctl.pfs.checkpoint_complete(meta):
                    return meta, "l2"
                # retention may have trimmed the PFS copy: serve from L3
                if l3 is not None and l3.checkpoint_complete(meta):
                    return meta, "l3"
        # cold restart: nothing in memory (e.g. new controller) — scan PFS
        for ckpt_id in reversed(ctl.pfs.list_checkpoints(app_id)):
            meta = ctl.pfs.read_manifest(app_id, ckpt_id)
            if meta is not None and ctl.pfs.checkpoint_complete(meta) \
                    and self.chain_restorable(meta):
                meta.status = CkptStatus.IN_L2
                with ctl._lock:
                    if app is not None:
                        app.checkpoints.setdefault(ckpt_id, meta)
                return meta, "l2"
        # still nothing: the PFS may have been lost/recycled too — scan the
        # remote object store's manifests (the durability floor)
        if l3 is not None:
            for ckpt_id in reversed(l3.list_checkpoints(app_id)):
                meta = l3.read_manifest(app_id, ckpt_id)
                if meta is not None and l3.checkpoint_complete(meta) \
                        and self.chain_restorable(meta):
                    meta.status = CkptStatus.IN_L3
                    with ctl._lock:
                        if app is not None:
                            app.checkpoints.setdefault(ckpt_id, meta)
                    return meta, "l3"
        return None

    def chain_restorable(self, meta: CheckpointMeta) -> bool:
        """Every *ancestor* frame of the checkpoint's delta chains is still
        fetchable (L1 agent, PFS, or L3).  The checkpoint's own frames are
        covered by the caller's completeness check; raw/q8 regions have no
        chain and always pass.  Presence only — a corrupt frame still
        surfaces as RestoreError at replay time."""
        ctl = self.ctl
        l3 = getattr(ctl, "l3", None)
        for name, region in meta.regions.items():
            if region.codec != "q8-delta" or not region.chain:
                continue
            for cid in region.chain[:-1]:
                for part in range(region.partition.num_parts):
                    if next(self.agents_with(meta.app_id, cid, name, part),
                            None) is not None:
                        continue
                    key = ShardKey(meta.app_id, cid, name, part)
                    if ctl.pfs.has_shard(key):
                        continue
                    if l3 is not None and l3.has_shard(key):
                        continue
                    return False
        return True

    def l1_complete(self, meta: CheckpointMeta) -> bool:
        ec = self.ec_geometry(meta.app_id)
        for name, region in meta.regions.items():
            for part in range(region.partition.num_parts):
                if ec is not None:
                    k = ec[0]
                    alive = 0
                    for _ in self.fragments_with(meta.app_id, meta.ckpt_id,
                                                 name, part):
                        alive += 1
                        if alive >= k:
                            break
                    if alive >= k:       # any k fragments reconstruct it
                        continue
                if next(self.agents_with(meta.app_id, meta.ckpt_id, name,
                                         part), None) is None:
                    return False
        return True

    def agents_with(self, app_id: AppId, ckpt_id: CkptId, region: str,
                    part: int) -> Iterator:
        """Live (agent, key) pairs holding any replica of the shard."""
        for mgr in self.ctl.managers():
            if not mgr.alive():
                continue
            for agent in mgr.agents():
                if not agent.alive():        # failover: skip dead replicas
                    continue
                for rep in range(4):
                    k = ShardKey(app_id, ckpt_id, region, part, rep)
                    if agent.has(k):
                        yield agent, k

    def ec_geometry(self, app_id: AppId) -> Optional[Tuple[int, int]]:
        """The app's (k, m) stripe geometry, or None when not erasure-coded."""
        with self.ctl._lock:
            app = self.ctl._apps.get(app_id)
            return app.ec if app is not None else None

    def fragments_with(self, app_id: AppId, ckpt_id: CkptId, region: str,
                       part: int) -> Iterator:
        """Live (agent, key) pairs holding erasure fragments of the shard.

        One (agent, key) per *distinct* fragment index — a fragment hosted
        twice (e.g. rebuilt while its original survived a partition) counts
        once, so callers can treat the yield count as surviving-fragment
        count."""
        ec = self.ec_geometry(app_id)
        if ec is None:
            return
        k, m = ec
        reps = [FRAG_DATA0 + i for i in range(k)] + [
            FRAG_PARITY0 + j for j in range(m)
        ]
        seen = set()
        for mgr in self.ctl.managers():
            if not mgr.alive():
                continue
            for agent in mgr.agents():
                if not agent.alive():
                    continue
                for rep in reps:
                    if rep in seen:
                        continue
                    fk = ShardKey(app_id, ckpt_id, region, part, rep)
                    if agent.has(fk):
                        seen.add(rep)
                        yield agent, fk

    def fetch_shard(self, app_id: AppId, ckpt_id: CkptId, region: str,
                    part: int) -> bytes:
        """Restart/redistribution read path: L1 via any *live* holding agent
        (replicas tried in turn, then erasure reconstruction from any k
        fragments), else L2 (PFS), else L3 (object store)."""
        for agent, k in self.agents_with(app_id, ckpt_id, region, part):
            try:
                return agent.get(k)
            except (ConnectionError, KeyError):
                continue                     # race with a failure: next copy
        payload = self._fetch_from_fragments(app_id, ckpt_id, region, part)
        if payload is not None:
            return payload
        key = ShardKey(app_id, ckpt_id, region, part)
        if self.ctl.pfs.has_shard(key):
            return self.ctl.pfs.read_shard(key)
        l3 = getattr(self.ctl, "l3", None)
        if l3 is not None and l3.has_shard(key):
            # promote-on-read back through the pipeline: repopulate the PFS
            # copy so the remaining shards of this restart (and the next
            # restart) are served at PFS latency instead of object-store
            # request-latency
            with self.ctl.tracer.span("shard_promote",
                                      trace_id_for(app_id, ckpt_id),
                                      "catalog/fetch", region=region,
                                      part=part):
                payload = l3.read_shard(key)
                self.ctl.pfs.write_shard(key, payload)
            self.ctl.bus.publish(E.SHARD_PROMOTED, node="cluster",
                                 key=str(key), src=l3.name,
                                 dst=self.ctl.pfs.name, nbytes=len(payload))
            return payload
        raise KeyError(f"shard {app_id}/{ckpt_id}/{region}/{part} lost")

    def _fetch_from_fragments(self, app_id: AppId, ckpt_id: CkptId,
                              region: str, part: int) -> Optional[bytes]:
        """Reconstruct one logical shard from any k surviving L1 fragments
        (None when the app isn't erasure-coded or fewer than k survive)."""
        frags: Dict[int, bytes] = {}
        need: Optional[int] = None
        for agent, fk in self.fragments_with(app_id, ckpt_id, region, part):
            try:
                blob = agent.get(fk)
                k_geom, _, idx, _, _, _ = ec_parse_fragment(blob)
            except (ConnectionError, KeyError, IntegrityError):
                continue                     # race with a failure: next one
            need = k_geom
            frags[idx] = blob
            if len(frags) >= need:
                break
        if need is None or len(frags) < need:
            return None
        payload = ec_decode_shard(list(frags.values()))
        if sorted(frags)[:need] != list(range(need)):
            # a data fragment was among the casualties: the read GF-decoded
            # around it (durability held, latency paid) — say so
            self.ctl.bus.publish(E.EC_DEGRADED_READ, app=app_id,
                                 ckpt=ckpt_id, region=region, part=part,
                                 have=sorted(frags))
        return payload
