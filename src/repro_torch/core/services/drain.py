"""Orchestrated PFS drains (paper §II: "orchestrate the writing of the
checkpoint data into PFS by minimizing the effect on running applications").

The queue and concurrency bound that used to live inside the Controller are
now a worker pool: ``max_concurrent`` drain workers pull finalized
checkpoints off a queue, so at most that many checkpoints contend for the
shared PFS ingest bandwidth at once — *and* that many genuinely proceed in
parallel (the old single flusher thread serialized everything its semaphore
nominally allowed).

Also owns L1 garbage collection (keep the newest ``keep_l1`` durable
checkpoints resident for fast restarts) and bounded drain retry.

The same worker pool runs the **background lane**: callables submitted via
:meth:`submit_background` (the StorageLifecycleService's L2→L3 trickle).
Background work is strictly lower priority — a worker only picks it up when
no live drain is queued or active, so the trickle never contends with the
latency-sensitive L1→L2 path for workers or PFS bandwidth.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Tuple

from ...obs import trace_id_for
from .. import events as E
from ..types import AppId, CheckpointMeta, CkptStatus, ShardKey


class DrainOrchestrator:
    def __init__(self, ctl, max_concurrent: int = 2, keep_l1: int = 2,
                 max_attempts: int = 2):
        self.ctl = ctl
        self.max_concurrent = max(1, int(max_concurrent))
        self.keep_l1 = keep_l1
        self.max_attempts = max(1, int(max_attempts))
        # queue entries carry the submitter's TraceContext: the drain
        # crosses into a worker thread, so causality rides the tuple
        self._q: "queue.Queue[Tuple[CheckpointMeta, int, object, object]]" = \
            queue.Queue()
        self._bg: "queue.Queue[Tuple[Callable[[], None], object]]" = \
            queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._active = 0
        self._inflight = 0        # submitted but not yet fully processed
        self._bg_inflight = 0     # background jobs submitted, not finished
        self._bg_completed = 0
        self._bg_failed = 0
        self._max_active = 0
        self._completed = 0
        self._failed = 0
        self._stale_dropped = 0   # queue entries fenced off post-recovery
        self._workers: List[threading.Thread] = []

    # ----------------------------------------------------------------- admin
    def start(self) -> None:
        for i in range(self.max_concurrent):
            t = threading.Thread(target=self._loop, daemon=True,
                                 name=f"icheck-drain-{i}")
            self._workers.append(t)
            t.start()

    def close(self) -> None:
        self._stop.set()
        for t in self._workers:
            t.join(timeout=5)

    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": len(self._workers),
                "active": self._active,
                "inflight": self._inflight,
                "max_observed_concurrency": self._max_active,
                "completed": self._completed,
                "failed": self._failed,
                "stale_dropped": self._stale_dropped,
                "queued": self._q.qsize(),
                "background_inflight": self._bg_inflight,
                "background_completed": self._bg_completed,
                "background_failed": self._bg_failed,
            }

    def _epoch(self):
        fence = getattr(self.ctl, "fence", None)
        return fence.current if fence is not None else None

    def _stale(self, epoch) -> bool:
        """True when a queue entry predates a controller recovery — it must
        be dropped, not executed against the post-recovery state."""
        fence = getattr(self.ctl, "fence", None)
        return fence is not None and epoch is not None \
            and epoch != fence.current

    # ------------------------------------------------------------- interface
    def submit(self, meta: CheckpointMeta, attempt: int = 0,
               trace=None) -> None:
        tracer = getattr(self.ctl, "tracer", None)
        if trace is None and tracer is not None:
            trace = tracer.current()
        with self._lock:
            self._inflight += 1
        self._q.put((meta, attempt, trace, self._epoch()))

    def submit_background(self, fn: Callable[[], None]) -> None:
        """Queue low-priority work (L2→L3 trickle) behind all live drains."""
        with self._lock:
            self._bg_inflight += 1
        self._bg.put((fn, self._epoch()))

    def wait_idle(self, timeout: float = 30.0) -> None:
        """Block until the drain queue empties and no drain is in flight."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                inflight = self._inflight
            if inflight == 0:
                return
            time.sleep(0.01)
        raise TimeoutError("drains did not settle")

    def wait_background(self, timeout: float = 30.0) -> None:
        """Block until background work (and the drains gating it) settles."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                pending = self._bg_inflight + self._inflight
            if pending == 0:
                return
            time.sleep(0.01)
        raise TimeoutError("background work did not settle")

    # ------------------------------------------------------------------ guts
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                meta, attempt, trace, epoch = self._q.get(timeout=0.05)
            except queue.Empty:
                self._run_background_one()
                continue
            if self._stale(epoch):
                # queued by a pre-recovery controller: fenced off
                with self._lock:
                    self._inflight -= 1
                    self._stale_dropped += 1
                self.ctl.bus.publish(E.STALE_OP_REJECTED, kind="drain",
                                     app=meta.app_id, ckpt=meta.ckpt_id,
                                     epoch=epoch, current=self._epoch())
                continue
            with self._lock:
                self._active += 1
                self._max_active = max(self._max_active, self._active)
            try:
                self._drain_one(meta, attempt, trace)
            finally:
                with self._lock:
                    self._active -= 1
                    self._inflight -= 1

    def _run_background_one(self) -> None:
        # strict priority: background work only starts while no drain is
        # queued or running, so the trickle never steals PFS bandwidth or a
        # worker slot from the latency-sensitive L1→L2 path
        with self._lock:
            if self._active > 0:
                return
        if not self._q.empty():
            return
        try:
            fn, epoch = self._bg.get_nowait()
        except queue.Empty:
            return
        if self._stale(epoch):
            with self._lock:
                self._bg_inflight -= 1
                self._stale_dropped += 1
            self.ctl.bus.publish(E.STALE_OP_REJECTED, kind="background",
                                 epoch=epoch, current=self._epoch())
            return
        ok = True
        try:
            fn()
        except Exception:   # noqa: BLE001 - lifecycle jobs own their retries
            ok = False
        finally:
            with self._lock:
                self._bg_inflight -= 1
                if ok:
                    self._bg_completed += 1
                else:
                    self._bg_failed += 1

    def _drain_one(self, meta: CheckpointMeta, attempt: int,
                   trace=None) -> None:
        tracer = getattr(self.ctl, "tracer", None)
        if tracer is not None and tracer.enabled:
            with tracer.use(trace), tracer.span(
                    "l2_drain", trace_id_for(meta.app_id, meta.ckpt_id),
                    f"drain/{threading.current_thread().name}",
                    attempt=attempt):
                self._drain_one_inner(meta, attempt, trace)
        else:
            self._drain_one_inner(meta, attempt, trace)

    def _drain_one_inner(self, meta: CheckpointMeta, attempt: int,
                         trace=None) -> None:
        ctl = self.ctl
        t0 = ctl.clock.now()
        with ctl._lock:
            ctl.catalog.set_status(meta, CkptStatus.DRAINING)
            drained_bytes = sum(s.nbytes for k, s in meta.shards.items()
                                if k.replica == 0)
        if ctl.catalog.ec_geometry(meta.app_id) is not None:
            # erasure-coded app: L1 holds only fragments (no replica-0
            # keys), but the PFS stores *whole* shards so manifests,
            # completeness probes and cold restarts stay format-identical
            # to replicated apps — reconstruct each logical shard from any
            # k fragments and write it down
            ok = self._drain_ec(meta)
        else:
            # each agent drains the shards it holds → parallel PFS writers
            futures = []
            for mgr in ctl.managers():
                if not mgr.alive():
                    continue
                for agent in mgr.agents():
                    keys = [k for k in agent.store.keys()
                            if k.app_id == meta.app_id
                            and k.ckpt_id == meta.ckpt_id
                            and k.replica == 0]
                    if keys:
                        futures.append(agent.drain(keys, ctl.pfs))
            ok = True
            for f in futures:
                try:
                    f.result(timeout=60)
                except Exception:
                    ok = False
        if ok and ctl.pfs.checkpoint_complete(meta):
            ctl.pfs.write_manifest(meta)
            ctl.catalog.set_status(meta, CkptStatus.IN_L2)
            with self._lock:
                self._completed += 1
            ctl.bus.publish(E.CKPT_IN_L2, app=meta.app_id, ckpt=meta.ckpt_id,
                            bytes=drained_bytes,
                            sim_s=max(ctl.clock.now() - t0, 0.0))
            self.gc_l1(meta.app_id)
        elif attempt + 1 < self.max_attempts:
            # transient failure (e.g. an agent died mid-drain): give the
            # health monitor a few heartbeats to re-replicate / replace
            # agents before retrying, or the retry races the recovery
            ctl.catalog.set_status(meta, CkptStatus.IN_L1)
            recovery = 4 * getattr(ctl.health, "interval", 0.05)
            self._stop.wait(recovery)
            # re-carry the original context: the retried drain is still part
            # of the same checkpoint's trace, not an orphan
            self.submit(meta, attempt + 1, trace=trace)
        else:
            # still restartable from L1
            ctl.catalog.set_status(meta, CkptStatus.IN_L1)
            with self._lock:
                self._failed += 1
            ctl.bus.publish(E.DRAIN_FAILED, app=meta.app_id, ckpt=meta.ckpt_id)

    def _drain_ec(self, meta: CheckpointMeta) -> bool:
        """Drain an erasure-coded checkpoint: reconstruct every logical
        shard from its L1 fragments (any k suffice) and write the full
        payload to the PFS under the base key."""
        ctl = self.ctl
        ok = True
        for name, region in meta.regions.items():
            for part in range(region.partition.num_parts):
                key = ShardKey(meta.app_id, meta.ckpt_id, name, part)
                if ctl.pfs.has_shard(key):
                    continue          # a retry after a partial first pass
                try:
                    payload = ctl.fetch_shard(meta.app_id, meta.ckpt_id,
                                              name, part)
                    ctl.pfs.write_shard(key, payload)
                except Exception:   # noqa: BLE001 - retried by the caller
                    ok = False
        return ok

    def gc_l1(self, app_id: AppId) -> None:
        """Keep only the newest ``keep_l1`` durable checkpoints in L1."""
        ctl = self.ctl
        with ctl._lock:
            app = ctl._apps.get(app_id)
            if app is None:     # app record gone (e.g. controller crashed)
                return
            durable = sorted((m.ckpt_id for m in app.checkpoints.values()
                              if m.status in (CkptStatus.IN_L2,
                                              CkptStatus.IN_L3)))
        evict = durable[:-self.keep_l1] if self.keep_l1 > 0 else durable
        for ckpt_id in evict:
            for mgr in ctl.managers():
                mgr.store.drop_checkpoint(app_id, ckpt_id)
