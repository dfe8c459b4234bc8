"""Typed event bus — the control-plane spine of the checkpoint service core.

The paper's controller is "a composition of independent services" (§II):
agent placement, orchestrated PFS drains, failure detection, and resize
forewarning.  Those services communicate through this bus instead of through
a monolith's method calls: every subsystem *publishes* typed :class:`Event`s
and anything — the audit log, the elastic trainer's metrics, a future
Prometheus exporter — *subscribes*.

The legacy ``Controller.events`` audit list is re-implemented here as just
another subscriber (:class:`AuditLog`) that renders events into the exact
dict format the old ``Controller._log`` produced, so existing tests and
benchmarks keep working unchanged.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Iterable, List, Mapping, Optional, Tuple

# --------------------------------------------------------------------------
# canonical event names (the audit vocabulary)
# --------------------------------------------------------------------------
NODE_ADDED = "node_added"
NODE_REQUEST_DENIED = "node_request_denied"
NODE_RETAKEN = "node_retaken"
NODE_MIGRATED = "node_migrated"
NODE_FAILED = "node_failed"
NODE_RECOVERED = "node_recovered"
MIGRATION_LOST_SHARD = "migration_lost_shard"

APP_REGISTERED = "app_registered"
CAPACITY_GROW = "capacity_grow"
AGENTS_SCALED_UP = "agents_scaled_up"
AGENTS_SCALED_DOWN = "agents_scaled_down"
AGENT_FAILED = "agent_failed"
AGENT_REPLACED = "agent_replaced"
# the HealthMonitor's poll loop raised: the monitor survives (next tick
# retries) but a repeatedly-failing check means failures are going unseen —
# payload carries the repr'd error, and the obs flight ring is dumped so a
# wedged monitor is diagnosable instead of invisible
MONITOR_ERROR = "monitor_error"

# -- erasure-coded L1 durability (k data + m parity fragments) --------------
# a commit finished scattering one logical shard as an erasure-coded stripe;
# payload carries k/m, the logical bytes and the framed fragment bytes (the
# TelemetryService's EC overhead signal)
EC_STRIPE_COMMITTED = "ec_stripe_committed"
# the HealthMonitor launched a peer rebuild for fragments lost with an
# agent/node: a surviving agent gathers any k fragments over MemBus/NIC,
# GF-decodes the missing ones and re-hosts them
EC_REBUILD_STARTED = "ec_rebuild_started"
# the rebuild landed the regenerated fragment(s); payload carries the
# source ("peer" or the L2/L3 provider fallback), bytes moved and sim s
EC_REBUILD_DONE = "ec_rebuild_done"
# fewer than k fragments survive and no lower tier holds the shard: the
# stripe is lost and the checkpoint is marked failed
EC_REBUILD_FAILED = "ec_rebuild_failed"
# a read had to GF-decode around missing data fragments instead of the
# healthy gather-and-concat path (durability worked, but latency paid)
EC_DEGRADED_READ = "ec_degraded_read"

CKPT_IN_L1 = "ckpt_in_l1"
CKPT_IN_L2 = "ckpt_in_l2"
CKPT_FAILED = "ckpt_failed"
DRAIN_FAILED = "drain_failed"
# commit fully acked in L1, with the client-observed cost attached
# (bytes moved, busiest-NIC sim seconds, straggler retries) — the
# TelemetryService's commit-latency/-cost signal
COMMIT_DONE = "commit_done"
# a restart finished reassembling application state from a checkpoint;
# payload carries the source tier and sim seconds — the TelemetryService's
# restore-latency histogram signal, and the span that closes a trace tree
RESTORE_DONE = "restore_done"

RESIZE_FOREWARNED = "resize_forewarned"

# -- peer-to-peer redistribution (the adapt window) -------------------------
# an adapt-window redistribution began; payload carries via="peer" (agents
# move slices among themselves from pre-staged transfer programs) or
# via="client" (the legacy gather-through-the-client funnel)
REDISTRIBUTION_STARTED = "redistribution_started"
# the redistribution finished; payload carries bytes_moved (wire bytes of
# every slice transfer), peer_hops / cross / intra / tier read counts,
# bytes_through_client (only the parts the local new ranks fetched) and the
# simulated adapt-window seconds — the TelemetryService's resize signal
REDISTRIBUTION_DONE = "redistribution_done"
# the peer engine could not run (unsupported layout, agent death
# mid-transfer, lost source shard): the client funnel takes over so the
# adapt window completes instead of wedging
REDISTRIBUTION_FALLBACK = "redistribution_fallback"
# -- zero-stall (two-phase) resize ------------------------------------------
# phase 1 opened: the base checkpoint is streaming to the new partition in
# the background while the application keeps stepping (and keeps committing
# q8-deltas against the pre-resize chain)
RESIZE_OVERLAP_STARTED = "resize_overlap_started"
# phase 2 finished: tail deltas replayed onto the assembled scratch parts
# (or a keyframe re-hydration when the chain reset mid-window) and the app
# switched to the new partition; payload carries the bounded stall seconds,
# the hidden overlap seconds, commits absorbed during the window, tail frame
# count and whether re-hydration was needed
CUTOVER_DONE = "cutover_done"
CODEC_DEGRADED = "codec_degraded"
SHARD_SPILLED = "shard_spilled"
SHARD_PROMOTED = "shard_promoted"

# -- incremental (q8-delta) commit path -------------------------------------
# a commit's regions were delta/keyframe-encoded on the commit hot path;
# payload carries raw vs encoded (bytes-on-wire) totals, key/delta frame
# counts, changed/total block counts and the host-side encode seconds — the
# TelemetryService's compression-ratio and encode-time signal
CKPT_DELTA_COMMITTED = "ckpt_delta_committed"
# a region's delta chain was invalidated (resize/redistribution, rank or
# node/agent failure, a chain frame demoted or expired, commit failure):
# the next commit of that region must emit a full keyframe
DELTA_CHAIN_RESET = "delta_chain_reset"

# -- storage lifecycle (watermark demotion / L3 trickle / retention) -------
# a shard was pushed down a tier by policy (not by put-time capacity
# pressure): the StorageLifecycleService's watermark demotion
SHARD_DEMOTED = "shard_demoted"
# a requested demotion could not happen (no lower tier, shard not resident,
# lower tier full) — published so lifecycle decisions stay observable
# instead of silently returning False
DEMOTE_FAILED = "demote_failed"
# a node tier crossed its configured high watermark (direction="high") or
# was drained back under the low watermark (direction="low")
WATERMARK_CROSSED = "watermark_crossed"
# a checkpoint finished its background L2→L3 trickle and is durable in the
# remote object store
CKPT_IN_L3 = "ckpt_in_l3"
# the trickle exhausted its retries; the checkpoint stays IN_L2 (still
# durable on the PFS) and retention will not trim it
L3_UPLOAD_FAILED = "l3_upload_failed"
# retention/GC dropped a checkpoint's shards from one tier (payload carries
# ``tier``); a checkpoint expired from its last tier is gone for good
CKPT_EXPIRED = "ckpt_expired"

# an application rank died (injected by tests/benchmarks or reported by the
# RM plugin): the application loses all work since its last checkpoint.
# Feeds the TelemetryService's failure inter-arrival (MTBF) estimate.
APP_RANK_FAILED = "app_rank_failed"
# the IntervalController re-solved an application's checkpoint cadence
# (Young/Daly over telemetry estimates); clients/trainers re-pace on this
INTERVAL_CHANGED = "interval_changed"

# -- crash-consistent control plane (metadata journal + epoch fencing) ------
# the controller finished a warm recovery: journal snapshot+tail replayed
# into a fresh catalog, divergences reconciled against the live tiers, open
# chains/windows conservatively reset; payload carries the new epoch, the
# replay stats and the per-app recovered high-water marks
CONTROLLER_RECOVERED = "controller_recovered"
# an agent inbox op / drain queue entry / RM interaction carried a stale
# controller epoch and was refused — the fencing that stops a zombie
# controller (or its queued work) from corrupting post-recovery state
STALE_OP_REJECTED = "stale_op_rejected"
# a transient-fault retry policy (with_backoff) gave up: the per-op
# deadline would be exceeded — payload carries what/attempts/error; the
# underlying error is still raised to the caller
RETRY_EXHAUSTED = "retry_exhausted"
# Controller.wait_for_drains / wait_for_uploads timed out with work still
# queued; the returned report says what is pending, this event makes the
# silent-timeout hazard observable
WAIT_TIMEOUT = "wait_timeout"

# -- chaos campaigns (repro.chaos) ------------------------------------------
# the chaos injector fired one scheduled action (payload: kind, target,
# params, scheduled at_s) — the audit trail every invariant check can line
# failures up against
CHAOS_INJECTED = "chaos_injected"
# a transient chaos action (NIC degradation/down, straggler, partition,
# L3 outage) recovered at its scheduled end
CHAOS_CLEARED = "chaos_cleared"


@dataclasses.dataclass(frozen=True)
class Event:
    """One control-plane occurrence: a name, a sim timestamp, a payload.

    ``trace`` carries the :class:`~repro.obs.trace.TraceContext` the event
    was published under (None when tracing is off).  It deliberately stays
    *out* of :meth:`as_record` — the audit-dict format is byte-compatible
    with the pre-refactor log; trace identity travels beside it, read by
    the flight recorder, never by the audit consumers.
    """

    name: str
    sim_t: float
    payload: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[Any] = dataclasses.field(default=None, compare=False,
                                             repr=False)

    def as_record(self) -> dict:
        """Render to the legacy audit-dict format (payload keys first)."""
        rec = dict(self.payload)
        rec["event"] = self.name
        rec["sim_t"] = self.sim_t
        return rec


Subscriber = Callable[[Event], None]


class EventBus:
    """Thread-safe publish/subscribe fan-out.

    Subscribers must never take the control plane down: exceptions raised by
    a handler are swallowed (the bus is telemetry, not a transaction log).
    """

    def __init__(self, clock=None):
        self.clock = clock
        # optional TraceCollector: when set, every publish stamps the
        # publisher thread's current trace context onto the event
        self.tracer = None
        self._lock = threading.Lock()
        self._subs: List[Tuple[Optional[frozenset], Subscriber]] = []

    def subscribe(self, handler: Subscriber,
                  events: Optional[Iterable[str]] = None) -> Callable[[], None]:
        """Register ``handler`` for ``events`` (None = all).

        Returns an unsubscribe callable.
        """
        filt = frozenset(events) if events is not None else None
        entry = (filt, handler)
        with self._lock:
            self._subs.append(entry)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._subs.remove(entry)
                except ValueError:
                    pass

        return unsubscribe

    def publish(self, name: str, **payload) -> Event:
        sim_t = self.clock.now() if self.clock is not None else 0.0
        ctx = self.tracer.current() if self.tracer is not None else None
        ev = Event(name=name, sim_t=sim_t, payload=payload, trace=ctx)
        with self._lock:
            subs = list(self._subs)
        for filt, handler in subs:
            if filt is None or name in filt:
                try:
                    handler(ev)
                except Exception:   # noqa: BLE001 - telemetry must not break us
                    pass
        return ev


class AuditLog:
    """The old ``Controller.events`` list, rebuilt as a bus subscriber.

    ``records`` is byte-compatible with what ``Controller._log`` used to
    append: ``{**payload, "event": name, "sim_t": t}`` in that key order.

    Growth is bounded: beyond ``maxlen`` records the oldest are trimmed
    from the front and counted in ``dropped``, so long chaos campaigns
    and multi-app runs stop accumulating O(events) memory.  The default
    is far above what any test or campaign produces, keeping the list
    contiguous (index == publish order) on every short run.
    """

    def __init__(self, maxlen: int = 100_000):
        self._lock = threading.Lock()
        self.maxlen = max(1, int(maxlen))
        self.dropped = 0
        self.records: List[dict] = []

    def __call__(self, ev: Event) -> None:
        rec = ev.as_record()
        with self._lock:
            self.records.append(rec)
            if len(self.records) > self.maxlen:
                excess = len(self.records) - self.maxlen
                del self.records[:excess]
                self.dropped += excess

    def names(self) -> List[str]:
        with self._lock:
            return [r["event"] for r in self.records]
