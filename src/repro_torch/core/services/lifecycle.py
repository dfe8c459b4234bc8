"""Storage lifecycle: watermark demotion, L2→L3 trickle, retention/GC.

The paper treats checkpoint storage as a *managed* resource: the controller
escalates to the RM when iCheck memory runs out (§III-A interaction 1) and
orchestrates PFS writes to bound interference (§II).  This service closes
the remaining gap — today the system reacts to a ``CapacityError`` *after* a
commit already hit a full node, and a checkpoint's life ends at the PFS.
Three policies, all driven off the telemetry the event bus already carries:

  * **Watermark demotion** — when a node's L1 occupancy crosses
    ``watermark_high``, cold shards (oldest checkpoints first, durable
    before draining) are demoted into the node's lower tier until occupancy
    falls under ``watermark_low`` (classic hysteresis so a single hot
    commit doesn't cause demotion ping-pong).  Commits then keep landing in
    RAM instead of raising ``CapacityError`` and forcing an RM escalation.

  * **Async L2→L3 trickle** — every checkpoint that becomes durable on the
    PFS is queued for background promotion into the
    :class:`~repro.core.tiers.RemoteObjectTier`, through the
    DrainOrchestrator's low-priority background lane so the trickle never
    contends with live L1→L2 drains.  ``CKPT_IN_L3`` announces durability
    in the object store.

  * **Retention / GC** — keep-last-K per tier per application: once a
    checkpoint is safe in L3, its PFS copy beyond ``keep_l2`` is dropped;
    L3 itself keeps ``keep_l3`` objects.  Pinned checkpoints
    (:meth:`pin`) are exempt everywhere.  Every removal publishes
    ``CKPT_EXPIRED`` with the tier it left; expiry from L3 is terminal.
"""
from __future__ import annotations

import threading
from typing import List, Set, Tuple

from ...obs import trace_id_for
from .. import events as E
from ..tiers import ec_is_parity
from ..types import AppId, CkptId, CkptStatus, ICheckError, ShardKey

# statuses whose shards may be demoted out of L1 (durable copies exist, or
# at worst the checkpoint is restartable from its lower-tier copy); an
# in-flight PENDING commit or an actively DRAINING checkpoint is hot
_DEMOTABLE = (CkptStatus.IN_L1, CkptStatus.IN_L2, CkptStatus.IN_L3)
_DURABLE = (CkptStatus.IN_L2, CkptStatus.IN_L3)


class StorageLifecycleService:
    def __init__(self, ctl, l3=None, *, watermark_high: float = 0.85,
                 watermark_low: float = 0.60, keep_l2: int = 0,
                 keep_l3: int = 0, trickle_to_l3: bool = True):
        if not (0.0 < watermark_low <= watermark_high <= 1.0):
            raise ICheckError(
                f"watermarks must satisfy 0 < low <= high <= 1, got "
                f"low={watermark_low} high={watermark_high}")
        self.ctl = ctl
        self.l3 = l3
        self.watermark_high = float(watermark_high)
        self.watermark_low = float(watermark_low)
        self.keep_l2 = max(0, int(keep_l2))      # 0 = unlimited
        self.keep_l3 = max(0, int(keep_l3))      # 0 = unlimited
        self.trickle_to_l3 = bool(trickle_to_l3) and l3 is not None
        self._lock = threading.Lock()
        self._uploading: Set[Tuple[AppId, CkptId]] = set()
        self._unsubscribe = ctl.bus.subscribe(
            self._on_event,
            events=(E.COMMIT_DONE, E.CKPT_IN_L1, E.CKPT_IN_L2,
                    E.SHARD_SPILLED))

    def close(self) -> None:
        self._unsubscribe()

    # -------------------------------------------------------------- pinning
    def pin(self, app_id: AppId, ckpt_id: CkptId, pinned: bool = True) -> bool:
        """Exempt (or re-expose) one checkpoint from retention on all tiers."""
        with self.ctl._lock:
            app = self.ctl._apps.get(app_id)
            meta = app.checkpoints.get(ckpt_id) if app else None
            if meta is None:
                return False
            self.ctl.catalog._journal("pin", app=app_id, ckpt=ckpt_id,
                                      pinned=bool(pinned))
            meta.pinned = bool(pinned)
            return True

    def reset_inflight(self) -> None:
        """Forget in-flight upload dedup state (controller recovery): the
        old closures are epoch-fenced in the background lane, so recovered
        IN_L2 checkpoints must be free to reschedule their trickle."""
        with self._lock:
            self._uploading.clear()

    # ---------------------------------------------------------- bus wiring
    def _on_event(self, ev: E.Event) -> None:
        if ev.name in (E.COMMIT_DONE, E.CKPT_IN_L1, E.SHARD_SPILLED):
            self.run_watermarks()
        elif ev.name == E.CKPT_IN_L2:
            app_id = ev.payload["app"]
            if self.trickle_to_l3:
                self.schedule_upload(app_id, ev.payload["ckpt"])
            self.run_retention(app_id)
            self.run_watermarks()

    # ------------------------------------------------- watermark demotion
    def run_watermarks(self) -> int:
        """Demote cold L1 shards on every node above the high watermark.

        Returns the number of shards demoted.  Hysteresis: a node is only
        touched above ``watermark_high`` and is drained down to
        ``watermark_low``, so occupancy oscillating between the two marks
        causes no churn.
        """
        demoted_total = 0
        for mgr in self.ctl.managers():
            if not mgr.alive():
                continue
            pipe = mgr.store
            if len(pipe.tiers) < 2:
                continue        # nowhere to demote to on this node
            top = pipe.tiers[0]
            cap = float(top.capacity)
            if not cap or cap != cap or cap == float("inf"):
                continue
            occupancy = top.used_bytes / cap
            if occupancy <= self.watermark_high:
                continue
            self.ctl.bus.publish(
                E.WATERMARK_CROSSED, node=mgr.node_id, tier=top.name,
                direction="high", occupancy=occupancy,
                watermark=self.watermark_high)
            target = self.watermark_low * cap
            demoted = 0
            for key in self._cold_first(top.keys()):
                if top.used_bytes <= target:
                    break
                if pipe.demote(key):
                    demoted += 1
                else:
                    # most likely the lower tier is full: retrying the
                    # remaining K cold keys would copy each payload out of
                    # L1 just to fail the same way — stop this pass (the
                    # next commit-class event retries the whole check)
                    break
            demoted_total += demoted
            occupancy = top.used_bytes / cap
            if occupancy <= self.watermark_low:
                self.ctl.bus.publish(
                    E.WATERMARK_CROSSED, node=mgr.node_id, tier=top.name,
                    direction="low", occupancy=occupancy,
                    watermark=self.watermark_low, demoted=demoted)
        return demoted_total

    def _cold_first(self, keys: List[ShardKey]) -> List[ShardKey]:
        """Demotion order: erasure *parity* fragments first (pure redundancy
        — the stripe stays reconstructable from its k data fragments, and a
        demoted parity is still fetchable from the lower tier), then durable
        checkpoints before merely-L1 ones, oldest checkpoint first within
        each class; hot (in-flight) shards never."""
        statuses = {}
        with self.ctl._lock:
            for key in keys:
                app = self.ctl._apps.get(key.app_id)
                meta = app.checkpoints.get(key.ckpt_id) if app else None
                statuses[(key.app_id, key.ckpt_id)] = \
                    meta.status if meta else CkptStatus.IN_L2

        def eligible(key: ShardKey) -> bool:
            return statuses[(key.app_id, key.ckpt_id)] in _DEMOTABLE

        def coldness(key: ShardKey):
            durable = statuses[(key.app_id, key.ckpt_id)] in _DURABLE
            return (0 if ec_is_parity(key.replica) else 1,
                    0 if durable else 1, key.ckpt_id, key.region, key.part)

        return sorted((k for k in keys if eligible(k)), key=coldness)

    # --------------------------------------------------- L2 -> L3 trickle
    MAX_UPLOAD_ATTEMPTS = 3

    def schedule_upload(self, app_id: AppId, ckpt_id: CkptId,
                        attempt: int = 0, trace=None) -> None:
        with self._lock:
            if (app_id, ckpt_id) in self._uploading:
                return
            self._uploading.add((app_id, ckpt_id))
        # the CKPT_IN_L2 handler runs on the drain worker, whose current
        # context is the l2_drain span: capture it into the background-lane
        # closure so the trickle re-joins the checkpoint's trace tree
        tracer = getattr(self.ctl, "tracer", None)
        if trace is None and tracer is not None:
            trace = tracer.current()
        self.ctl.drains.submit_background(
            lambda: self._upload_to_l3(app_id, ckpt_id, attempt, trace))

    def wait_uploads(self, timeout: float = 30.0) -> None:
        """Testing/benchmark helper: block until the trickle lane settles."""
        self.ctl.drains.wait_background(timeout)

    def _upload_to_l3(self, app_id: AppId, ckpt_id: CkptId,
                      attempt: int = 0, trace=None) -> None:
        tracer = getattr(self.ctl, "tracer", None)
        if tracer is not None and tracer.enabled:
            with tracer.use(trace), tracer.span(
                    "l3_trickle", trace_id_for(app_id, ckpt_id),
                    "lifecycle/trickle", attempt=attempt):
                self._upload_attempt(app_id, ckpt_id, attempt, trace)
        else:
            self._upload_attempt(app_id, ckpt_id, attempt, trace)

    def _upload_attempt(self, app_id: AppId, ckpt_id: CkptId,
                        attempt: int = 0, trace=None) -> None:
        try:
            self._upload_to_l3_once(app_id, ckpt_id)
        except Exception as e:  # noqa: BLE001 - must not kill the worker
            with self._lock:
                self._uploading.discard((app_id, ckpt_id))
            if attempt + 1 < self.MAX_UPLOAD_ATTEMPTS:
                # transient (an I/O hiccup, a shard raced a drop): requeue
                # behind whatever live drains arrived meanwhile
                self.schedule_upload(app_id, ckpt_id, attempt + 1,
                                     trace=trace)
            else:
                # terminal: the checkpoint stays IN_L2 (still PFS-durable,
                # and keep_l2 retention never trims a non-L3 checkpoint) —
                # but say so instead of leaving only a drain-stats counter
                self.ctl.bus.publish(E.L3_UPLOAD_FAILED, app=app_id,
                                     ckpt=ckpt_id, attempts=attempt + 1,
                                     error=repr(e))
        else:
            with self._lock:
                self._uploading.discard((app_id, ckpt_id))

    def _upload_to_l3_once(self, app_id: AppId, ckpt_id: CkptId) -> None:
        ctl = self.ctl
        l3 = self.l3
        with ctl._lock:
            app = ctl._apps.get(app_id)
            meta = app.checkpoints.get(ckpt_id) if app else None
        if l3 is None or meta is None or meta.status != CkptStatus.IN_L2:
            return
        t0 = ctl.clock.now()
        total = 0
        for name, region in meta.regions.items():
            for part in range(region.partition.num_parts):
                key = ShardKey(app_id, ckpt_id, name, part)
                if l3.has_shard(key):
                    continue
                payload = ctl.pfs.read_shard(key)
                l3.write_shard(key, payload)
                total += len(payload)
        if not l3.checkpoint_complete(meta):
            return              # raced a concurrent drop; stay IN_L2
        ctl.catalog.set_status(meta, CkptStatus.IN_L3)
        l3.write_manifest(meta)
        ctl.bus.publish(E.CKPT_IN_L3, app=app_id, ckpt=ckpt_id, bytes=total,
                        sim_s=max(ctl.clock.now() - t0, 0.0),
                        cost_usd=l3.cost_usd())
        self.run_retention(app_id)

    # ------------------------------------------------------ retention / GC
    def run_retention(self, app_id: AppId) -> None:
        """Keep-last-K per tier: trim PFS copies already safe in L3 beyond
        ``keep_l2``; expire L3 objects beyond ``keep_l3`` (terminal)."""
        ctl = self.ctl
        with ctl._lock:
            app = ctl._apps.get(app_id)
            if app is None:
                return
            metas = sorted(app.checkpoints.values(), key=lambda m: m.ckpt_id)
        if self.keep_l2 > 0:
            # a PFS copy is only droppable once the checkpoint is durable
            # one level further down; the newest keep_l2 durable copies are
            # protected regardless
            durable = [m for m in metas if m.status in _DURABLE]
            protected = {m.ckpt_id for m in durable[-self.keep_l2:]}
            for meta in metas:
                if meta.status != CkptStatus.IN_L3 or meta.pinned \
                        or meta.ckpt_id in protected:
                    continue
                freed = ctl.pfs.drop_checkpoint(app_id, meta.ckpt_id)
                if freed:
                    ctl.bus.publish(E.CKPT_EXPIRED, app=app_id,
                                    ckpt=meta.ckpt_id, tier=ctl.pfs.name,
                                    freed_bytes=freed, terminal=False)
        if self.l3 is not None and self.keep_l3 > 0:
            in_l3 = [m for m in metas
                     if m.status == CkptStatus.IN_L3 and not m.pinned]
            victims = in_l3[:-self.keep_l3]
            victim_ids = {m.ckpt_id for m in victims}
            # q8-delta: a frame referenced by a *surviving* checkpoint's
            # replay chain must outlive it — expiring the keyframe under a
            # retained delta would make that checkpoint unrestorable
            chain_needed = set()
            for m in metas:
                if m.ckpt_id in victim_ids or m.status in (CkptStatus.EXPIRED,
                                                           CkptStatus.FAILED):
                    continue
                for r in m.regions.values():
                    if r.chain:
                        chain_needed.update(r.chain)
            for meta in victims:
                if meta.ckpt_id in chain_needed:
                    continue
                freed = self.l3.drop_checkpoint(app_id, meta.ckpt_id)
                # the L3 copy was the durability floor: scrub the faster
                # tiers too so no unrestorable partial copies linger
                ctl.pfs.drop_checkpoint(app_id, meta.ckpt_id)
                for mgr in ctl.managers():
                    mgr.store.drop_checkpoint(app_id, meta.ckpt_id)
                ctl.catalog.set_status(meta, CkptStatus.EXPIRED)
                ctl.bus.publish(E.CKPT_EXPIRED, app=app_id,
                                ckpt=meta.ckpt_id, tier=self.l3.name,
                                freed_bytes=freed, terminal=True)

    # -------------------------------------------------------------- export
    def stats(self) -> dict:
        with self._lock:
            uploading = len(self._uploading)
        return {
            "watermark_high": self.watermark_high,
            "watermark_low": self.watermark_low,
            "keep_l2": self.keep_l2,
            "keep_l3": self.keep_l3,
            "trickle_to_l3": self.trickle_to_l3,
            "uploads_in_flight": uploading,
        }
