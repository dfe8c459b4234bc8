"""The iCheck Controller — a thin coordinator over the checkpoint services.

"The controller has a global view and performs the agent and node selection
for connected applications based on the iCheck agent scheduling policies ...
The controller may also request the resource manager for additional resources
based on resource availability.  In addition, the controller will also
orchestrate the writing of the checkpoint data into PFS by minimizing the
effect on running applications." (§II)

The behaviour itself lives in focused subsystems (see ARCHITECTURE.md):

  * :class:`~.services.placement.PlacementService` — policy-driven agent
    placement + ``icheck_probe_agents`` adaptivity (paper §II steps 1-6)
  * :class:`~.services.catalog.CheckpointCatalog` — checkpoint lifecycle
    (PENDING → IN_L1 → DRAINING → IN_L2) and the multi-level read path
  * :class:`~.services.drain.DrainOrchestrator` — bounded-concurrency PFS
    drains + L1 GC (interference control, §II)
  * :class:`~.services.health.HealthMonitor` — heartbeats, re-replication,
    straggler advice, RM node retake/migration (§III-A items 2-3)
  * :class:`~.services.resize.ResizePlanner` — resize forewarning →
    pre-staged redistribution plans (§III-A item 4)
  * :class:`~.services.lifecycle.StorageLifecycleService` — watermark-driven
    L1 demotion, background L2→L3 trickle into the remote object store,
    keep-last-K retention/GC with pinning (beyond paper)

Services communicate through the :class:`~.events.EventBus`; the legacy
``Controller.events`` audit list is an :class:`~.events.AuditLog` subscriber
and stays byte-compatible with the pre-refactor format.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from . import events as E
from . import plan as planlib
from .agent import Agent
from .events import AuditLog, EventBus, NODE_ADDED, NODE_REQUEST_DENIED, \
    APP_REGISTERED, REDISTRIBUTION_FALLBACK as E_REDISTRIBUTION_FALLBACK
from .manager import Manager
from .policies import NodeView, SchedulingPolicy
from .rm import ResourceManager
from .services import (CheckpointCatalog, DrainOrchestrator, EpochFence,
                       HealthMonitor, IntervalController, MetadataJournal,
                       PlacementService, ResizePlanner,
                       StorageLifecycleService, TelemetryService)
from .services.journal import meta_from_ckpt_doc
from .simnet import FaultInjector, SimClock
from .tiers import PFSTier, RemoteObjectTier, region_doc, region_from_doc
from ..obs import FlightRecorder, TraceCollector
from .types import (AppId, AppRecord, AppStatus, CheckpointMeta, CkptId,
                    CkptStatus, ICheckError, NodeSpec, RegionMeta, ShardInfo)


class Controller:
    def __init__(self, rm: ResourceManager, pfs: PFSTier,
                 policy: "str | SchedulingPolicy" = "adaptive",
                 initial_nodes: int = 1, clock: Optional[SimClock] = None,
                 fault: Optional[FaultInjector] = None,
                 keep_l1: int = 2, max_concurrent_drains: int = 2,
                 heartbeat_interval_s: float = 0.05,
                 spill_bytes: int = 0, adaptive_interval: bool = True,
                 default_mtbf_s: float = 3600.0,
                 l3: Optional[RemoteObjectTier] = None,
                 watermark_high: float = 0.85, watermark_low: float = 0.60,
                 keep_l2: int = 0, keep_l3: int = 0,
                 delta_keyframe_every: int = 8,
                 trace: bool = False, trace_path: Optional[str] = None,
                 obs_dir: Optional[str] = None, journal: bool = True):
        self.rm = rm
        self.pfs = pfs
        self.l3 = l3
        self.clock = clock or SimClock()
        self.fault = fault or FaultInjector()
        self.keep_l1 = keep_l1
        self.spill_bytes = int(spill_bytes)
        self._managers: Dict[str, Manager] = {}
        self._apps: Dict[AppId, AppRecord] = {}
        self._regions: Dict[AppId, Dict[str, RegionMeta]] = {}
        self._lock = threading.RLock()

        # control plane: event bus + audit log (legacy ``events`` list)
        self.bus = EventBus(self.clock)
        self.audit = AuditLog()
        self.bus.subscribe(self.audit)

        # observability: tracer (no-op unless trace/trace_path asked for
        # it) + always-on bounded flight recorder; publish stamps the
        # current trace context on every event
        self.trace_path = trace_path
        self.tracer = TraceCollector(clock=self.clock,
                                     enabled=bool(trace) or
                                     trace_path is not None)
        self.bus.tracer = self.tracer
        self.flight = FlightRecorder(clock=self.clock, out_dir=obs_dir)
        self.bus.subscribe(self.flight.on_event)
        self.tracer.add_listener(self.flight.on_span)
        self.bus.subscribe(self._on_fallback,
                           events=(E_REDISTRIBUTION_FALLBACK,))

        # crash-consistent control plane: write-ahead metadata journal on
        # the PFS (a non-``ckpt_*`` sibling, invisible to shard walks) +
        # the epoch fence that recovery bumps to seal out zombie work
        self.journal = MetadataJournal(os.path.join(pfs.root, "_journal"),
                                       clock=self.clock) if journal else None
        self.fence = EpochFence()
        rm.fence = self.fence
        if l3 is not None:
            l3.bus = self.bus      # retry_exhausted telemetry from L3 ops
        # demotions/promotions and EC stripe placement are journaled as
        # audit records (recovery probes the live tiers rather than trust
        # a replayed placement, but the history is in the log)
        if self.journal is not None:
            self.bus.subscribe(self._journal_audit_event,
                               events=(E.SHARD_DEMOTED, E.SHARD_PROMOTED,
                                       E.EC_STRIPE_COMMITTED))

        # service core
        self.placement = PlacementService(self, policy)
        self.catalog = CheckpointCatalog(
            self, delta_keyframe_every=delta_keyframe_every)
        self.drains = DrainOrchestrator(self, max_concurrent=max_concurrent_drains,
                                        keep_l1=keep_l1)
        self.health = HealthMonitor(self, heartbeat_interval_s)
        self.resize = ResizePlanner(self)
        # adaptive loop: telemetry must subscribe before the interval
        # controller so a COMMIT_DONE updates the estimates first and the
        # solver then reads the fresh values (bus fans out in order)
        self.telemetry = TelemetryService(self, default_mtbf_s=default_mtbf_s)
        # shared-tier links feed the same per-hop histograms as node NICs:
        # a drain's PFS ingest or a cold L3 read is a hop like any other
        self.pfs.ingest.on_transfer = self.telemetry.observe_transfer
        if l3 is not None:
            l3.link.on_transfer = self.telemetry.observe_transfer
        self.intervals = IntervalController(self, self.telemetry) \
            if adaptive_interval else None
        # storage lifecycle: watermark demotion acts whenever a node has a
        # lower tier to demote into; the L2→L3 trickle and retention act
        # when an L3 tier is configured
        self.lifecycle = StorageLifecycleService(
            self, l3=l3, watermark_high=watermark_high,
            watermark_low=watermark_low, keep_l2=keep_l2, keep_l3=keep_l3)

        # wire the RM plugin callbacks (§III-A)
        rm.on_retake = self.health.on_rm_retake
        rm.on_migrate = self.health.on_rm_migrate
        rm.on_app_info = self.resize.on_app_info

        for _ in range(initial_nodes):
            spec = rm.request_icheck_node(epoch=self.fence.current)
            if spec is None:
                raise ICheckError("RM has no free nodes for iCheck bootstrap")
            self._add_node(spec)

        self.drains.start()
        self.health.start()

    def _journal_audit_event(self, ev) -> None:
        """Journal tier moves and EC stripe commits (audit records)."""
        p = ev.payload
        if ev.name == E.EC_STRIPE_COMMITTED:
            self.journal.append("ec_stripe", app=p.get("app"),
                                ckpt=p.get("ckpt"), k=p.get("k"),
                                m=p.get("m"), stripes=p.get("stripes"))
        else:
            self.journal.append("tier_move", move=ev.name,
                                key=p.get("key"), src=p.get("src"),
                                dst=p.get("dst"))

    def _on_fallback(self, ev) -> None:
        """A redistribution fell back to the client funnel: something broke
        mid-window — ship the timeline."""
        p = ev.payload
        self.flight.dump(
            f"fallback_{p.get('app', '?')}_{p.get('region', '?')}",
            extra={"event": ev.as_record()})

    # ------------------------------------------------- legacy-compat surface
    @property
    def events(self) -> List[dict]:
        """Audit log (byte-compatible with the pre-service-core format)."""
        return self.audit.records

    @property
    def policy(self) -> SchedulingPolicy:
        return self.placement.policy

    @policy.setter
    def policy(self, p: SchedulingPolicy) -> None:
        self.placement.policy = p

    @property
    def _plans(self):
        return self.resize.plans

    # ================================================================= nodes
    def _add_node(self, spec: NodeSpec) -> Manager:
        mgr = Manager(spec, clock=self.clock, fault=self.fault, bus=self.bus,
                      spill_bytes=self.spill_bytes, fence=self.fence)
        # per-hop transfer observations feed the cluster-level NIC/MemBus
        # latency histograms (peer-hop p99s in snapshot()/prometheus())
        mgr.nic.on_transfer = self.telemetry.observe_transfer
        mgr.membus.on_transfer = self.telemetry.observe_transfer
        with self._lock:
            self._managers[spec.node_id] = mgr
        self.bus.publish(NODE_ADDED, node=spec.node_id)
        return mgr

    def managers(self) -> List[Manager]:
        with self._lock:
            return list(self._managers.values())

    def node_views(self) -> List[NodeView]:
        return [NodeView.of(m) for m in self.managers() if m.alive()]

    def request_more_memory(self) -> bool:
        """Ask the RM for one more iCheck node (paper §III-A interaction 1)."""
        spec = self.rm.request_icheck_node(epoch=self.fence.current)
        if spec is None:
            self.bus.publish(NODE_REQUEST_DENIED)
            return False
        self._add_node(spec)
        return True

    def total_free_memory(self) -> int:
        return sum(m.store.free_bytes for m in self.managers() if m.alive())

    # ================================================================== apps
    def register_app(self, app_id: AppId, ranks: int,
                     ckpt_bytes_estimate: int = 0, ckpt_interval_s: float = 60.0,
                     replication: int = 1, ec=None) -> List[Agent]:
        """Paper §II steps 1-6: register, place agents, hand back handles.

        ``ec=(k, m)`` opts the app into erasure-coded L1 durability: each
        committed shard is scattered as k data + m parity fragments instead
        of ``replication`` whole copies."""
        with self._lock:
            if app_id in self._apps:
                # reconnect (restart path): reuse the existing record
                app = self._apps[app_id]
                app.ranks = ranks
                app.status = AppStatus.CONNECTED
                return self.agents_for(app_id)
            app = AppRecord(app_id=app_id, ranks=ranks,
                            ckpt_bytes_estimate=ckpt_bytes_estimate,
                            ckpt_interval_s=ckpt_interval_s,
                            replication=replication,
                            ec=tuple(ec) if ec else None)
            if self.journal is not None:
                self.journal.append("app", app=app_id, ranks=ranks,
                                    replication=replication,
                                    ec=list(app.ec) if app.ec else None,
                                    interval_s=ckpt_interval_s,
                                    bytes_estimate=ckpt_bytes_estimate)
            self._apps[app_id] = app
            self._regions[app_id] = {}
            self.catalog.open_app(app_id)
        self.rm.register_app(app_id, ranks, epoch=self.fence.current)
        self.placement.ensure_memory(app)
        agents = self.placement.place_app(app)
        with self._lock:
            app.agents = [a.agent_id for a in agents]
            app.status = AppStatus.CONNECTED
        if app.ec is not None:
            # scatter targets must span failure domains, or a single node
            # death takes more than m fragments of every stripe with it
            agents = self.placement.ensure_failure_domains(
                app, sum(app.ec))
        self.bus.publish(APP_REGISTERED, app=app_id,
                         agents=[a.agent_id for a in agents])
        return agents

    def agents_for(self, app_id: AppId) -> List[Agent]:
        with self._lock:
            ids = list(self._apps[app_id].agents)
        out = []
        for aid in ids:
            node_id = aid.split("/")[0]
            mgr = self._managers.get(node_id)
            if mgr is None:
                continue
            a = mgr.agent(aid)
            if a is not None and a.alive():
                out.append(a)
        return out

    def app(self, app_id: AppId) -> AppRecord:
        with self._lock:
            return self._apps[app_id]

    def register_region(self, app_id: AppId, region: RegionMeta) -> None:
        with self._lock:
            old = self._regions[app_id].get(region.name)
            if self.journal is not None:
                self.journal.append("region", app=app_id, name=region.name,
                                    doc=region_doc(region))
            self._regions[app_id][region.name] = region
        if old is not None and old.partition != region.partition:
            # resize/redistribution (grow *or* shrink, or new mesh boxes):
            # previous codes no longer line up part-for-part — mandatory
            # chain reset so the next commit emits a keyframe
            self.catalog.reset_delta_chains(app_id=app_id, region=region.name,
                                            reason="resize")
            # pre-staged plans/programs were computed against the old
            # layout: a later resize to a previously-planned part count
            # must re-plan, never reuse the stale cache
            self.resize.invalidate(app_id, region.name)

    def regions_of(self, app_id: AppId) -> Dict[str, RegionMeta]:
        with self._lock:
            return dict(self._regions.get(app_id, {}))

    def notify_finished(self, app_id: AppId) -> None:
        with self._lock:
            app = self._apps.get(app_id)
            if app:
                app.status = AppStatus.FINISHED
        # release the app's delta-chain state (host codes + device-resident
        # codes_dev arrays) — long-lived controllers see many apps come and
        # go, and a finished app will keyframe anyway if it reconnects
        self.catalog.reset_delta_chains(app_id=app_id, reason="app_finished")
        # likewise the pre-staged resize plans/transfer programs
        self.resize.invalidate(app_id)

    # =================================================== service delegation
    # checkpoints (catalog)
    def new_checkpoint(self, app_id: AppId, step: int,
                       regions: Dict[str, RegionMeta],
                       userdata: bytes = b"") -> CheckpointMeta:
        return self.catalog.new_checkpoint(app_id, step, regions, userdata)

    def record_shard(self, meta: CheckpointMeta, info: ShardInfo) -> None:
        self.catalog.record_shard(meta, info)

    def finalize_checkpoint(self, meta: CheckpointMeta, drain: bool = True) -> None:
        self.catalog.finalize(meta, drain=drain)

    def latest_restartable(self, app_id: AppId) -> Optional[Tuple[CheckpointMeta, str]]:
        return self.catalog.latest_restartable(app_id)

    def fetch_shard(self, app_id: AppId, ckpt_id: CkptId, region: str,
                    part: int) -> bytes:
        return self.catalog.fetch_shard(app_id, ckpt_id, region, part)

    # q8-delta chains (catalog-owned previous-codes state)
    def delta_chain(self, app_id: AppId, region: str, num_parts: int):
        return self.catalog.delta_chain(app_id, region, num_parts)

    def advance_delta_chain(self, app_id: AppId, ckpt_id: CkptId, region: str,
                            states, frame: str):
        return self.catalog.advance_chain(app_id, ckpt_id, region, states,
                                          frame)

    def reset_delta_chains(self, app_id: Optional[AppId] = None,
                           region: Optional[str] = None,
                           reason: str = "") -> int:
        return self.catalog.reset_delta_chains(app_id, region, reason)

    def set_delta_keyframe_every(self, app_id: AppId,
                                 k: Optional[int]) -> None:
        self.catalog.set_keyframe_every(app_id, k)

    # drains
    def wait_for_drains(self, timeout: float = 30.0) -> dict:
        """Block until the drain queue empties.  Always returns a report —
        a timeout is ``{"ok": False, ...}`` with the pending counts (and a
        published ``wait_timeout`` event), never a silent return with work
        still queued."""
        try:
            self.drains.wait_idle(timeout)
        except TimeoutError:
            st = self.drains.stats()
            report = {"ok": False, "timed_out": True, "what": "drains",
                      "pending": st["inflight"], "queued": st["queued"],
                      "active": st["active"], "completed": st["completed"]}
            self.bus.publish(E.WAIT_TIMEOUT, what="drains",
                             timeout_s=timeout, pending=report["pending"],
                             queued=report["queued"], active=report["active"])
            return report
        st = self.drains.stats()
        return {"ok": True, "timed_out": False, "what": "drains",
                "pending": 0, "queued": 0, "active": 0,
                "completed": st["completed"]}

    # storage lifecycle
    def wait_for_uploads(self, timeout: float = 30.0) -> dict:
        """Block until the background L2→L3 trickle (and drains) settle.
        Same report contract as :meth:`wait_for_drains`."""
        try:
            self.lifecycle.wait_uploads(timeout)
        except TimeoutError:
            st = self.drains.stats()
            pending = st["background_inflight"] + st["inflight"]
            report = {"ok": False, "timed_out": True, "what": "uploads",
                      "pending": pending,
                      "background_inflight": st["background_inflight"],
                      "drain_inflight": st["inflight"],
                      "completed": st["background_completed"]}
            self.bus.publish(E.WAIT_TIMEOUT, what="uploads",
                             timeout_s=timeout, pending=pending)
            return report
        st = self.drains.stats()
        return {"ok": True, "timed_out": False, "what": "uploads",
                "pending": 0, "completed": st["background_completed"]}

    def pin_checkpoint(self, app_id: AppId, ckpt_id: CkptId,
                       pinned: bool = True) -> bool:
        """Exempt one checkpoint from retention/GC on every tier."""
        return self.lifecycle.pin(app_id, ckpt_id, pinned)

    # placement / adaptivity
    def handle_capacity_pressure(self, app_id: AppId) -> List[Agent]:
        return self.placement.handle_capacity_pressure(app_id)

    def probe_agents(self, app_id: AppId,
                     last_commit_sim_s: Optional[float] = None) -> List[Agent]:
        return self.placement.probe(app_id, last_commit_sim_s)

    # health / straggler advice
    def transfer_deadline(self, nbytes: int, agent: Agent,
                          factor: float = 4.0, slack: float = 1e-3) -> float:
        return self.health.transfer_deadline(nbytes, agent, factor, slack)

    # redistribution planning / peer execution
    def plan_for_resize(self, app_id: AppId, region_name: str,
                        new_parts: int) -> List[planlib.Move]:
        return self.resize.plan_for_resize(app_id, region_name, new_parts)

    def transfer_programs(self, app_id: AppId, region_name: str,
                          new_parts: int):
        """Pre-staged per-destination transfer programs (None = layout the
        peer path cannot express; use the client funnel)."""
        return self.resize.transfer_programs(app_id, region_name, new_parts)

    def execute_redistribution(self, app_id: AppId, region: RegionMeta,
                               ckpt_id: CkptId, programs):
        """Run transfer programs agent→agent; see
        :meth:`PeerRedistributionEngine.execute`."""
        return self.resize.engine.execute(app_id, region, ckpt_id, programs)

    def release_redistribution(self, results) -> None:
        self.resize.engine.release(results)

    def begin_overlap_redistribution(self, app_id: AppId, region: RegionMeta,
                                     ckpt_id: CkptId, programs):
        """Open a zero-stall resize window: stream the base checkpoint in the
        background while the app keeps stepping; see
        :meth:`PeerRedistributionEngine.begin_overlap`."""
        return self.resize.engine.begin_overlap(app_id, region, ckpt_id,
                                                programs)

    def cutover_redistribution(self, window):
        """Land an overlap window: replay the tail deltas (or re-hydrate)
        and return ``(results, stats, patches)``."""
        return self.resize.engine.cutover(window)

    def abort_overlap_redistribution(self, window) -> None:
        self.resize.engine.abort(window)

    # ================================== crash-consistent control plane
    def maybe_compact_journal(self) -> None:
        """Publish a compacted snapshot once enough WAL records accumulated
        since the last one, keeping replay O(live state)."""
        j = self.journal
        if j is None or not j.compaction_due():
            return
        with self._lock:
            j.write_snapshot(self._snapshot_doc())

    def _snapshot_doc(self) -> dict:
        """Serialize the full control-plane state (call under ``_lock``)."""
        doc: dict = {"epoch": self.fence.current, "apps": {}, "chains": {},
                     "holds": {}}
        with self._lock:
            for app_id, app in self._apps.items():
                doc["apps"][app_id] = {
                    "ranks": app.ranks,
                    "replication": app.replication,
                    "ec": list(app.ec) if app.ec else None,
                    "interval_s": app.ckpt_interval_s,
                    "bytes_estimate": app.ckpt_bytes_estimate,
                    "next_ckpt": max(app.checkpoints, default=-1) + 1,
                    "regions": {n: region_doc(r) for n, r
                                in self._regions.get(app_id, {}).items()},
                    "ckpts": {str(cid): MetadataJournal.ckpt_doc(m)
                              for cid, m in app.checkpoints.items()},
                }
        with self.catalog._chain_lock:
            for (app_id, region), rc in self.catalog._chains.items():
                doc["chains"][f"{app_id}\x00{region}"] = list(rc.chain)
            for (app_id, region), n in self.catalog._holds.items():
                doc["holds"][f"{app_id}\x00{region}"] = int(n)
        return doc

    def crash(self) -> None:
        """Simulate controller process death: every piece of in-memory
        control-plane state vanishes — app records, regions, catalog id
        sequences, delta chains, holds, pre-staged resize plans — with no
        events and no journaling (a crash doesn't get to say goodbye).
        Durable bytes in L1/L2/L3 and the PFS-backed journal survive, and
        agents keep running with whatever they hold."""
        with self._lock:
            self._apps.clear()
            self._regions.clear()
        self.catalog._seq.clear()
        with self.catalog._chain_lock:
            self.catalog._chains.clear()
            self.catalog._holds.clear()
        self.resize.plans.clear()
        self.lifecycle.reset_inflight()

    def recover(self) -> dict:
        """Warm recovery: replay the journal (snapshot + WAL tail) into a
        fresh catalog, bump the epoch fence, then reconcile the replayed
        view against what agents/PFS/L3 actually still hold — downgrading
        any checkpoint whose claimed tier no longer has it and conservatively
        resetting every delta chain or hold open at crash time.  Returns a
        recovery report."""
        j = self.journal
        if j is None:
            raise ICheckError("recovery requires a metadata journal")
        t0 = self.clock.now()
        state = j.replay_state()
        # fence first: queued pre-crash work must already be stale while we
        # rebuild, and the new epoch is the first post-recovery WAL record
        new_epoch = self.fence.bump(at_least=state.epoch + 1)
        j.append("epoch", epoch=new_epoch)

        downgraded: List[dict] = []
        resubmitted = 0
        with self._lock:
            for app_id, doc in state.apps.items():
                app = AppRecord(
                    app_id=app_id, ranks=int(doc.get("ranks", 0)),
                    ckpt_bytes_estimate=int(doc.get("bytes_estimate", 0)),
                    ckpt_interval_s=float(doc.get("interval_s", 60.0)),
                    replication=int(doc.get("replication", 1)),
                    ec=tuple(doc["ec"]) if doc.get("ec") else None)
                self._apps[app_id] = app
                self._regions[app_id] = {
                    name: region_from_doc(name, r)
                    for name, r in doc.get("regions", {}).items()}
                self.catalog.set_seq(app_id, int(doc.get("next_ckpt", 0)))
                for ck in doc.get("ckpts", {}).values():
                    meta = meta_from_ckpt_doc(app_id, ck)
                    app.checkpoints[meta.ckpt_id] = meta
                # app→agent assignment is not journaled (it changes with
                # every placement decision): rebuild it from live managers
                agents: List[str] = []
                for mgr in self.managers():
                    agents.extend(mgr.agent_ids_for(app_id))
                app.agents = agents

        # reconciliation: probe live tiers for every non-terminal
        # checkpoint; the journal says what *should* exist, the probes say
        # what does — believe the probes, downgrade the rest
        for app_id in list(state.apps):
            app = self._apps[app_id]
            for meta in sorted(app.checkpoints.values(),
                               key=lambda m: m.ckpt_id):
                before = meta.status
                if before in (CkptStatus.EXPIRED, CkptStatus.FAILED):
                    continue
                actual = self._reconcile_one(meta)
                if actual is CkptStatus.IN_L1:
                    # L1-only (the drain was cut short): kick it again
                    self.drains.submit(meta)
                    resubmitted += 1
                if actual is not before:
                    downgraded.append({"app": app_id, "ckpt": meta.ckpt_id,
                                       "from": before.value,
                                       "to": actual.value})

        # any chain or hold open at crash time is unrecoverable state (the
        # per-part previous-codes handles died with the process): reset so
        # the next commit keyframes, and zero the journaled hold counts
        for (app_id, region), chain in state.open_chains.items():
            j.append("chain_reset", app=app_id, region=region,
                     reason="controller_recovered")
            self.bus.publish(E.DELTA_CHAIN_RESET, app=app_id, region=region,
                             reason="controller_recovered",
                             chain_len=len(chain))
        for (app_id, region), n in state.holds.items():
            for _ in range(int(n)):
                j.append("chain_release", app=app_id, region=region)

        # the trickle dedup set died with the process; recovered IN_L2
        # checkpoints re-enter the (epoch-fenced) background lane
        self.lifecycle.reset_inflight()
        for app_id in list(state.apps):
            for meta in self._apps[app_id].checkpoints.values():
                if meta.status is CkptStatus.IN_L2 and \
                        self.lifecycle.trickle_to_l3:
                    self.lifecycle.schedule_upload(app_id, meta.ckpt_id)

        # collapse the replayed history into a fresh snapshot so the next
        # recovery replays O(live state), not this one's tail again
        with self._lock:
            j.write_snapshot(self._snapshot_doc())

        report = {
            "epoch": new_epoch,
            "duration_s": max(self.clock.now() - t0, 0.0),
            "replay": state.stats,
            "truth": j.truth(),
            "apps": {app_id: {
                "max_known": max(self._apps[app_id].checkpoints, default=-1),
                "checkpoints": len(self._apps[app_id].checkpoints)}
                for app_id in state.apps},
            "chains_reset": len(state.open_chains),
            "downgraded": downgraded,
            "drains_resubmitted": resubmitted,
        }
        self.bus.publish(E.CONTROLLER_RECOVERED, epoch=new_epoch,
                         apps=len(state.apps),
                         downgraded=len(downgraded),
                         chains_reset=len(state.open_chains),
                         duration_s=report["duration_s"])
        return report

    def _reconcile_one(self, meta: CheckpointMeta) -> CkptStatus:
        """Probe where one recovered checkpoint actually lives and settle
        its status there (WAL-first via ``set_status``).  PENDING at crash
        time means the commit never acked — its transfers died with the
        submitting client call, so it can only be failed."""
        cat, pfs, l3 = self.catalog, self.pfs, self.l3
        if meta.status is CkptStatus.PENDING:
            self.catalog.set_status(meta, CkptStatus.FAILED)
            return CkptStatus.FAILED
        if pfs.checkpoint_complete(meta):
            pfs.write_manifest(meta)        # a crash mid-drain may have
            actual = CkptStatus.IN_L2       # landed bytes but no manifest
        elif l3 is not None and l3.checkpoint_complete(meta):
            actual = CkptStatus.IN_L3
        elif cat.l1_complete(meta):
            actual = CkptStatus.IN_L1
        else:
            actual = CkptStatus.FAILED
        self.catalog.set_status(meta, actual)
        return actual

    # ================================================================== misc
    def close(self) -> None:
        if self.trace_path is not None and self.tracer.enabled:
            try:
                self.tracer.write_chrome_trace(self.trace_path)
            except OSError:
                pass
        self.lifecycle.close()
        self.catalog.close()
        self.drains.close()
        self.health.close()
        if self.intervals is not None:
            self.intervals.close()
        self.telemetry.close()
        if self.journal is not None:
            self.journal.close()
        for mgr in self.managers():
            mgr.close()
