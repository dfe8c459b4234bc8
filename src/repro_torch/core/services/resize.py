"""Resize forewarning → pre-staged plans, and the peer redistribution engine.

Paper §III-A interaction 4: the RM "informs the controller about an
impending resource change of an application so that agents can prepare ...
ahead of time".  Two artifacts are pre-staged per (app, region, new_parts):

  * the *move list* (``plan_for_resize``) — what the legacy client funnel
    and the benchmarks consume;
  * the *transfer programs* (``transfer_programs``) — per-destination-part
    slice reads the agents execute peer-to-peer during the adapt window
    (arXiv:2509.05248 style), so the window only executes, never plans.

Both caches are invalidated when a region's partition changes
(``commit_redistribution`` → ``register_region``): a plan computed against
the old layout must never be reused for the new one.

:class:`PeerRedistributionEngine` (owned by the planner) executes the
programs: it resolves every source shard (live L1 agent, else PFS, else L3),
dispatches one ``assemble`` op per destination part to that part's owning
agent, waits, and reports analytic adapt-window timing — per-node
serialized-at-full-bandwidth sums, exactly the model ``CommitHandle`` uses
for concurrent puts, so concurrency across agent pairs shows up as
wall-clock it actually saves.
"""
from __future__ import annotations

import itertools
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...obs import trace_id_for
from .. import events as E
from .. import plan as planlib
from ..agent import Agent, AssembleSpec, ReplaySpec, SliceFetch
from ..tiers import Q8_EMPTY_DELTA_NBYTES
from ..types import (AppId, ICheckError, NodeSpec, PartitionScheme,
                     RegionMeta, ShardKey)


class OverlapWindow:
    """One zero-stall resize session for one region (two-phase).

    Phase 1 (``streaming`` → ``ready``): the base checkpoint streams to the
    new partition in the background while the application keeps stepping —
    and keeps committing q8-deltas against the held pre-resize chain; the
    window counts those commits and watches for a racing chain reset.

    Phase 2 (``cutover`` → ``done``/``failed``): quiesce, replay the tail
    delta frames that accumulated during the window onto the assembled
    scratch parts (or re-hydrate from the head checkpoint when the chain
    reset or the codec has no replayable tail), switch.  The stall is
    bounded by the tail, not the full stream.
    """

    def __init__(self, engine, app_id: AppId, region: RegionMeta,
                 base_ckpt: int, base_chain: Tuple[int, ...],
                 programs: Dict[int, planlib.TransferProgram],
                 providers: dict, jobs: list):
        self.engine = engine
        self.app_id = app_id
        self.region = region
        self.base_ckpt = base_ckpt
        self.base_chain = base_chain
        self.programs = programs
        self.providers = providers
        self.jobs = jobs
        self.results: Dict[int, Tuple[Agent, ShardKey, int]] = {}
        self.state = "streaming"
        self.overlap_commits = 0
        self.chain_reset_seen = False
        self.rehydrated = False
        self.held = False
        self.t0 = engine.ctl.clock.now()
        self._unsub = engine.ctl.bus.subscribe(
            self._on_event, events=(E.COMMIT_DONE, E.DELTA_CHAIN_RESET))

    def _on_event(self, ev: E.Event) -> None:
        p = ev.payload
        if p.get("app") != self.app_id:
            return
        if ev.name == E.COMMIT_DONE:
            self.overlap_commits += 1
        elif ev.name == E.DELTA_CHAIN_RESET \
                and p.get("region") == self.region.name:
            # a demotion/failure reset raced the window: the tail frames no
            # longer extend the streamed base — cutover must re-hydrate
            self.chain_reset_seen = True

    def ready(self) -> bool:
        """Phase 1 landed (all background assembles resolved — possibly
        with an error, which cutover will surface as a funnel fallback)."""
        if self.state == "streaming" and all(f.done()
                                             for _, _, _, f, _ in self.jobs):
            self.state = "ready"
        return self.state != "streaming"

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for _, _, _, fut, _ in self.jobs:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                fut.exception(timeout=remaining)
            except _FutureTimeout:
                return False
        return self.ready()

    def close(self) -> None:
        """Drop the bus subscription and the chain hold (idempotent)."""
        self._unsub()
        if self.held:
            self.held = False
            self.engine.ctl.catalog.release_chain(self.app_id,
                                                  self.region.name)


class ResizePlanner:
    def __init__(self, ctl):
        self.ctl = ctl
        # (app_id, region_name, new_parts) -> [Move]
        self.plans: Dict[Tuple[AppId, str, int], List[planlib.Move]] = {}
        # (app_id, region_name, new_parts) -> {dst: TransferProgram} | None
        # (None = layout the peer path cannot express; client funnel only)
        self.programs: Dict[Tuple[AppId, str, int],
                            Optional[Dict[int, planlib.TransferProgram]]] = {}
        # forewarnings already staged, keyed (app, region|"", new_parts): a
        # RM that re-announces the same impending resize (periodic
        # heartbeat-style plugins do) must not re-publish RESIZE_FOREWARNED
        # — every publish marks the app's commit-cost estimate stale in
        # telemetry, so duplicates would keep resetting the adaptive loop
        self._forewarned: set = set()
        self.engine = PeerRedistributionEngine(ctl)

    def plan_for_resize(self, app_id: AppId, region_name: str,
                        new_parts: int) -> List[planlib.Move]:
        ctl = self.ctl
        key = (app_id, region_name, new_parts)
        while True:
            with ctl._lock:
                if key in self.plans:
                    return self.plans[key]
                region = ctl._regions[app_id][region_name]
            old = region.partition
            new = old.renumbered(new_parts)
            n = region.shape[old.axis] if old.scheme.value != "replicated" \
                else 1
            moves = planlib.redistribution_moves(n, old, new) \
                if old.scheme.value != "replicated" else []
            # the plan was computed outside the lock: cache it only if the
            # partition did not change mid-compile (a concurrent
            # commit_redistribution + invalidate must never be overwritten
            # by a stale write-back) — otherwise replan against the new one
            with ctl._lock:
                if ctl._regions[app_id][region_name].partition == old:
                    self.plans[key] = moves
                    return moves

    def transfer_programs(self, app_id: AppId, region_name: str,
                          new_parts: int
                          ) -> Optional[Dict[int, planlib.TransferProgram]]:
        """Pre-staged (or compiled on demand) per-destination transfer
        programs; None when the layout needs the client fallback."""
        ctl = self.ctl
        key = (app_id, region_name, new_parts)
        while True:
            with ctl._lock:
                if key in self.programs:
                    return self.programs[key]
                region = ctl._regions[app_id][region_name]
            old = region.partition
            if old.scheme == PartitionScheme.MESH:
                programs = None  # mesh boxes are only known at adapt time
            else:
                programs = planlib.compile_transfer_programs(
                    region.shape[old.axis]
                    if old.scheme.value != "replicated" else 1,
                    old, old.renumbered(new_parts), region.shape)
            # same stale write-back guard as plan_for_resize
            with ctl._lock:
                if ctl._regions[app_id][region_name].partition == old:
                    self.programs[key] = programs
                    return programs

    def invalidate(self, app_id: AppId, region_name: Optional[str] = None
                   ) -> int:
        """Drop cached plans/programs of one region (its partition changed:
        anything computed against the old layout is stale), or of the whole
        app when ``region_name`` is None (app finished — long-lived
        controllers must not accumulate programs across app turnover)."""
        ctl = self.ctl
        with ctl._lock:
            victims = [k for k in self.plans if k[0] == app_id
                       and (region_name is None or k[1] == region_name)]
            for k in victims:
                del self.plans[k]
            pvictims = [k for k in self.programs if k[0] == app_id
                        and (region_name is None or k[1] == region_name)]
            for k in pvictims:
                del self.programs[k]
            # staged-forewarning memo entries computed against the old
            # layout are stale too: the next forewarning must re-stage
            self._forewarned -= {k for k in self._forewarned
                                 if k[0] == app_id
                                 and (region_name is None
                                      or k[1] in (region_name, ""))}
        return len(set(victims) | set(pvictims))

    def on_app_info(self, app_id: str, info: dict) -> None:
        """RM forewarning callback: pre-stage plans AND transfer programs
        for every region, so the adapt window only executes."""
        if info.get("event") != "impending_resize":
            return
        ctl = self.ctl
        new_ranks = int(info["new_ranks"])
        with ctl._lock:
            app = ctl._apps.get(app_id)
            if app is None:
                return
            app.pending_resize = new_ranks
            regions = dict(ctl._regions.get(app_id, {}))
            # memoize per (app, region, new_parts) — plus one app-level key
            # so a region-less (all-MESH) app still dedups: a repeated
            # forewarning for an already-staged target is a no-op, not a
            # recompile + re-publish
            keys = {(app_id, name, new_ranks) for name, region
                    in regions.items()
                    if region.partition.scheme != PartitionScheme.MESH}
            keys.add((app_id, "", new_ranks))
            if keys <= self._forewarned:
                return
            self._forewarned |= keys
        planned = staged = 0
        for name, region in regions.items():
            # MESH regions replan against the *new mesh's* boxes, which only
            # the application knows at adapt time (redistribute_mesh)
            if region.partition.scheme == PartitionScheme.MESH:
                continue
            self.plan_for_resize(app_id, name, new_ranks)
            planned += 1
            if self.transfer_programs(app_id, name, new_ranks) is not None:
                staged += 1
        ctl.bus.publish(E.RESIZE_FOREWARNED, app=app_id, new_ranks=new_ranks,
                        plans=planned, programs=staged)


class PeerRedistributionEngine:
    """Executes pre-staged transfer programs agent→agent during the adapt
    window; the client only dispatches and later fetches its local parts."""

    def __init__(self, ctl):
        self.ctl = ctl
        self._gen = itertools.count()

    # ------------------------------------------------------------ execution
    def execute(self, app_id: AppId, region: RegionMeta, ckpt_id: int,
                programs: Dict[int, planlib.TransferProgram]
                ) -> Tuple[Dict[int, Tuple[Agent, ShardKey, int]], dict]:
        """Run one region's programs (stop-the-world).  Returns
        ``({dst_part: (owning_agent, scratch_key, nbytes)}, stats)``; raises
        :class:`ICheckError` (or the underlying connection error) when a
        source is unreachable or an agent dies mid-transfer — the caller
        falls back to the client funnel.
        """
        ctl = self.ctl
        t0 = ctl.clock.now()
        chain, providers, jobs = self._dispatch(app_id, region, ckpt_id,
                                                programs, keep_state=False)
        itemsize = max(1, np.dtype(region.dtype).itemsize)
        results, reads, _ = self._collect(jobs, providers, itemsize,
                                          len(chain))
        stats = self._stats(results, reads)
        # analytic vs actual: the model says max-lane, the sim clock says
        # what the serialized sleeps actually accumulated — their ratio is
        # the skew gauge CI uses to validate the CommitHandle lane model
        wall = ctl.clock.now() - t0
        stats["wall_sim_s"] = wall
        stats["window_skew"] = stats["sim_s"] / wall if wall > 0 else 1.0
        ctl.tracer.record("redistribute_window",
                          trace_id_for(app_id, ckpt_id), "resize/engine",
                          t0=t0, dur_s=stats["sim_s"], region=region.name,
                          new_parts=len(programs),
                          peer_hops=stats.get("peer_hops", 0))
        return results, stats

    # ------------------------------------------------- zero-stall (two-phase)
    def begin_overlap(self, app_id: AppId, region: RegionMeta, ckpt_id: int,
                      programs: Dict[int, planlib.TransferProgram]
                      ) -> OverlapWindow:
        """Open phase 1: stream the base checkpoint to the new partition in
        the background and hold the region's delta chain so commits issued
        during the window keep extending it (instead of cutting a keyframe
        and orphaning the streamed base)."""
        ctl = self.ctl
        chain, providers, jobs = self._dispatch(
            app_id, region, ckpt_id, programs,
            # retained slice codes are only useful when a tail of q8-delta
            # frames can be XOR-replayed onto them at cutover
            keep_state=(region.codec == "q8-delta"))
        window = OverlapWindow(self, app_id, region, ckpt_id, chain,
                               programs, providers, jobs)
        ctl.catalog.hold_chain(app_id, region.name)
        window.held = True
        ctl.bus.publish(E.RESIZE_OVERLAP_STARTED, app=app_id,
                        region=region.name, new_parts=len(programs),
                        ckpt=ckpt_id, chain_len=len(chain))
        return window

    def cutover(self, window: OverlapWindow
                ) -> Tuple[Dict[int, Tuple[Agent, ShardKey, int]], dict,
                           Optional[Dict[int, list]]]:
        """Phase 2: land the background stream, then catch the scratch parts
        up to the catalog head.

        Three head shapes:

        * head extends the base chain (the common case: only delta commits
          happened during the window) → replay just the tail frames onto the
          retained slice states; the stall is the tail, and the returned
          patches let the client splice the changed spans instead of
          re-fetching whole parts;
        * head diverged (chain reset raced the window, codec without a
          replayable tail, or a rollback) → re-hydrate from the head
          checkpoint into fresh scratch (full stream charged to the stall);
        * head == base (no commit landed) → nothing to catch up.

        Returns ``(results, stats, patches)``; patches is None unless the
        tail-replay path ran.  Raises on any failure — the caller publishes
        the fallback and funnels through the client from the head.
        """
        ctl = self.ctl
        if window.state in ("done", "failed", "aborted"):
            raise ICheckError(f"overlap window already {window.state}")
        window.state = "cutover"
        try:
            itemsize = max(1, np.dtype(window.region.dtype).itemsize)
            results, reads, _ = self._collect(window.jobs, window.providers,
                                              itemsize,
                                              len(window.base_chain))
            window.results = results
            overlap_stats = self._stats(results, reads)
            head_meta, head_region = self._head_region(window)
            patches: Optional[Dict[int, list]] = None
            tail_frames = 0
            stall_stats = {"sim_s": 0.0, "bytes_moved": 0, "peer_hops": 0,
                           "cross_reads": 0, "intra_reads": 0,
                           "tier_reads": 0}
            if head_meta is not None and head_meta.ckpt_id != window.base_ckpt:
                head_chain: Tuple[int, ...] = tuple(head_region.chain) \
                    if head_region.codec == "q8-delta" and head_region.chain \
                    else (head_meta.ckpt_id,)
                nbase = len(window.base_chain)
                extends = (head_region.codec == "q8-delta"
                           and not window.chain_reset_seen
                           and len(head_chain) > nbase
                           and head_chain[:nbase] == window.base_chain)
                if extends:
                    tail = head_chain[nbase:]
                    patches, stall_stats = self._replay_tail(window, tail)
                    tail_frames = len(tail)
                else:
                    window.rehydrated = True
                    stall_stats = self._rehydrate(window, head_meta,
                                                  head_region)
                    results = window.results
            stall = stall_stats["sim_s"]
            stats = {
                "sim_s": overlap_stats["sim_s"] + stall,
                "overlap_sim_s": overlap_stats["sim_s"],
                "stall_sim_s": stall,
                "bytes_moved": overlap_stats["bytes_moved"]
                + stall_stats["bytes_moved"],
                "peer_hops": overlap_stats["peer_hops"]
                + stall_stats["peer_hops"],
                "cross_reads": overlap_stats["cross_reads"]
                + stall_stats["cross_reads"],
                "intra_reads": overlap_stats["intra_reads"]
                + stall_stats["intra_reads"],
                "tier_reads": overlap_stats["tier_reads"]
                + stall_stats["tier_reads"],
                "overlap_commits": window.overlap_commits,
                "tail_frames": tail_frames,
                "rehydrated": window.rehydrated,
            }
            wall = ctl.clock.now() - window.t0
            stats["wall_sim_s"] = wall
            stats["window_skew"] = stats["sim_s"] / wall if wall > 0 else 1.0
            ctl.bus.publish(E.CUTOVER_DONE, app=window.app_id,
                            region=window.region.name,
                            new_parts=len(window.programs),
                            stall_sim_s=stall,
                            overlap_sim_s=overlap_stats["sim_s"],
                            overlap_commits=window.overlap_commits,
                            tail_frames=tail_frames,
                            rehydrated=window.rehydrated)
            window.state = "done"
            return results, stats, patches
        except BaseException:
            window.state = "failed"
            raise
        finally:
            window.close()

    def abort(self, window: OverlapWindow) -> None:
        """Tear an overlap window down without switching: drop the bus
        subscription and chain hold, then release every scratch part —
        deferring stragglers still assembling to their completion."""
        window.close()
        if window.state not in ("done", "failed"):
            window.state = "aborted"
        if window.results:
            self.release(window.results)
        landed = set(window.results)
        for dp, agent, out_key, fut, _ in window.jobs:
            if dp in landed:
                continue
            fut.add_done_callback(
                lambda f, a=agent, k=out_key:
                (self._try_drop_state(a, k), self._drop_quiet(a, k),
                 self._clear_source_memos(window.providers)))

    def _head_region(self, window: OverlapWindow):
        """The catalog head's per-checkpoint meta for the window's region
        (``(None, None)`` when nothing restartable holds the region)."""
        found = self.ctl.catalog.latest_restartable(window.app_id)
        if found is None:
            return None, None
        meta, _ = found
        region = meta.regions.get(window.region.name)
        if region is None:
            return None, None
        return meta, region

    def _changed_tail_pairs(self, window: OverlapWindow,
                            tail: Tuple[int, ...]) -> set:
        """(ckpt_id, src_part) pairs whose tail delta frame can actually
        carry changes.  A part untouched by a commit stores a header-only
        delta frame (``Q8_EMPTY_DELTA_NBYTES``), and every shard's size is
        already in the commit manifest — so the cutover can prune the
        replay's slice reads *from metadata alone*, no data-plane cost.
        Unknown shards (e.g. manifests restored without sizes) stay
        conservative: read them."""
        ctl = self.ctl
        srcs = {op.src for prog in window.programs.values()
                for op in prog.ops}
        changed = set()
        try:
            app = ctl.app(window.app_id)
        except Exception:   # noqa: BLE001 - pruning is an optimisation only
            app = None
        for cid in tail:
            meta = app.checkpoints.get(cid) if app is not None else None
            for src in srcs:
                if meta is None:
                    changed.add((cid, src))
                    continue
                info = meta.shards.get(
                    ShardKey(window.app_id, cid, window.region.name, src))
                if info is None or info.nbytes > Q8_EMPTY_DELTA_NBYTES:
                    changed.add((cid, src))
        return changed

    def _replay_tail(self, window: OverlapWindow, tail: Tuple[int, ...]
                     ) -> Tuple[Dict[int, list], dict]:
        """Dispatch one ``replay`` per assembled destination part: the same
        slice ranges as phase 1, sourced only from the ``tail`` delta frames,
        XOR-applied to the retained slice codes and patched into the scratch
        payload in place.  Returns ``(patches, stall_stats)``.

        Frames that cannot contain changes (header-only deltas, detected
        from manifest shard sizes) are pruned before any read happens —
        with localized churn the stall collapses to the few slices that
        actually moved, not one read per (part, frame)."""
        region = window.region
        changed = self._changed_tail_pairs(window, tail)
        providers = self._resolve_sources(window.app_id, region.name, tail,
                                          window.programs, want=changed)
        jobs = []
        for dp in sorted(window.results):
            agent, out_key, _ = window.results[dp]
            prog = window.programs[dp]
            # fetch list must stay index-aligned with the retained slice
            # states from phase 1: pruned frames become empty source tuples
            # (a no-op replay), never removed entries
            fetches = tuple(
                SliceFetch(vlo=op.src_lo, vhi=op.src_hi, dst_lo=op.dst_lo,
                           codec=region.codec, dtype=region.dtype,
                           sources=tuple(providers[(cid, op.src)]
                                         for cid in tail
                                         if (cid, op.src) in changed))
                for op in prog.ops)
            if not any(f.sources for f in fetches):
                continue          # no tail frame touches this part
            spec = ReplaySpec(out_key=out_key, dtype=region.dtype,
                              fetches=fetches)
            jobs.append((dp, agent, out_key, agent.replay(spec), prog))
        itemsize = max(1, np.dtype(region.dtype).itemsize)
        rres, reads, patches = self._collect(jobs, providers, itemsize,
                                             len(tail))
        return patches, self._stats(rres, reads)

    def _rehydrate(self, window: OverlapWindow, head_meta, head_region
                   ) -> dict:
        """The tail does not extend the streamed base (chain reset raced the
        window, non-delta codec, rollback): assemble the head checkpoint
        from scratch — a full stream, all of it charged to the stall — and
        swap it in for the stale base-version scratch."""
        chain, providers, jobs = self._dispatch(
            window.app_id, head_region, head_meta.ckpt_id, window.programs,
            keep_state=False)
        itemsize = max(1, np.dtype(head_region.dtype).itemsize)
        results, reads, _ = self._collect(jobs, providers, itemsize,
                                          len(chain))
        self.release(window.results)
        window.results = results
        return self._stats(results, reads)

    @staticmethod
    def _try_drop_state(agent: Agent, key: ShardKey) -> None:
        try:
            agent.drop_assembly_state(key)
        except Exception:  # noqa: BLE001 - scratch GC must never raise
            pass

    def _dispatch(self, app_id: AppId, region: RegionMeta, ckpt_id: int,
                  programs: Dict[int, planlib.TransferProgram],
                  keep_state: bool,
                  scratch_region: Optional[str] = None):
        """Resolve sources and launch one assemble per destination part.
        Returns ``(chain, providers, jobs)`` with jobs =
        ``[(dp, agent, out_key, future, prog), ...]``."""
        ctl = self.ctl
        agents = ctl.agents_for(app_id)
        if not agents:
            raise ICheckError(f"no live agents for {app_id}")
        chain: Tuple[int, ...] = tuple(region.chain) \
            if region.codec == "q8-delta" and region.chain else (ckpt_id,)
        providers = self._resolve_sources(app_id, region.name, chain,
                                          programs)
        if scratch_region is None:
            scratch_region = f"{region.name}.redist{next(self._gen)}"
        by_node: Dict[str, List[Agent]] = {}
        for a in agents:
            by_node.setdefault(a.node_id, []).append(a)
        jobs = []
        for dp in sorted(programs):
            prog = programs[dp]
            out_key = ShardKey(app_id, ckpt_id, scratch_region, dp)
            fetches = tuple(
                SliceFetch(vlo=op.src_lo, vhi=op.src_hi, dst_lo=op.dst_lo,
                           codec=region.codec, dtype=region.dtype,
                           sources=tuple(providers[(cid, op.src)]
                                         for cid in chain))
                for op in prog.ops)
            agent = self._place_destination(dp, prog, chain, providers,
                                            agents, by_node)
            spec = AssembleSpec(out_key=out_key, dtype=region.dtype,
                                nvals=prog.nvals, fetches=fetches,
                                keep_state=keep_state)
            jobs.append((dp, agent, out_key, agent.assemble(spec), prog))
        return chain, providers, jobs

    def _collect(self, jobs, providers, itemsize: int, chain_len: int
                 ) -> Tuple[Dict[int, Tuple[Agent, ShardKey, int]],
                            List[dict], Dict[int, list]]:
        """Await dispatched jobs; on any failure, release what landed and
        defer cleanup of stragglers to their completion, then re-raise.
        The third return element maps dst part → value patches for replay
        jobs (empty for assembles)."""
        ctl = self.ctl
        # wall-clock deadline per job: with scaled real sleeps
        # (time_scale > 0) the simulated transfers take real time, so the
        # timeout must scale with the bytes the program moves (the
        # CommitHandle straggler-deadline pattern); 60 s otherwise
        scale = max(ctl.clock.time_scale, 0.0)
        results: Dict[int, Tuple[Agent, ShardKey, int]] = {}
        reads: List[dict] = []
        patches: Dict[int, list] = {}
        error: Optional[BaseException] = None
        try:
            for dp, agent, out_key, fut, prog in jobs:
                if scale > 0:
                    est_sim = prog.moved_vals * itemsize * chain_len / 1e9
                    wall = est_sim * scale * 4.0 + 10.0
                else:
                    wall = 60.0
                try:
                    res = fut.result(timeout=wall)
                except _FutureTimeout:
                    # on 3.10 this is NOT builtin TimeoutError: convert so
                    # the client's fallback except-tuple always catches it
                    error = error or ICheckError(
                        f"assemble of part {dp} timed out on "
                        f"{agent.agent_id}")
                    continue
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    error = error or e
                    continue
                results[dp] = (agent, out_key, res["nbytes"])
                reads.extend(res["reads"])
                if "patches" in res:
                    patches[dp] = res["patches"]
        finally:
            # decoded-payload memos on the source agents are adapt-window
            # scratch too: drop them with the window
            self._clear_source_memos(providers)
        if error is not None:
            self.release(results)
            for dp, agent, out_key, fut, _ in jobs:
                if dp in results:
                    continue
                # a timed-out assemble may still be running on the agent's
                # worker thread and will store its scratch *after* an eager
                # drop (and repopulate source decode memos after the eager
                # clear) — defer both cleanups to the future's completion
                # (runs immediately when the job already failed)
                fut.add_done_callback(
                    lambda f, a=agent, k=out_key:
                    (self._drop_quiet(a, k),
                     self._clear_source_memos(providers)))
            raise error
        return results, reads, patches

    def release(self, results: Dict[int, Tuple[Agent, ShardKey, int]]) -> None:
        """Drop the scratch redistribution shards (after the adapt window),
        along with any retained assembly state on the owning agents."""
        for agent, key, _ in results.values():
            try:
                agent.drop_assembly_state(key)
            except Exception:  # noqa: BLE001 - scratch GC must never raise
                pass
            self._drop_quiet(agent, key)

    @staticmethod
    def _drop_quiet(agent: Agent, key: ShardKey) -> None:
        try:
            agent.store.drop(key)
        except Exception:  # noqa: BLE001 - scratch GC must never raise
            pass

    @staticmethod
    def _clear_source_memos(providers: dict) -> None:
        for provider, _ in providers.values():
            if isinstance(provider, Agent):
                try:
                    provider.clear_peer_cache()
                except Exception:  # noqa: BLE001 - scratch GC must never raise
                    pass

    # ------------------------------------------------------------ internals
    def _place_destination(self, dp: int, prog: planlib.TransferProgram,
                           chain: Tuple[int, ...], providers: dict,
                           agents: List[Agent],
                           by_node: Dict[str, List[Agent]]) -> Agent:
        """Locality-aware owner for one destination part: the node holding
        most of its source bytes assembles it, so the bulk of the slice
        reads ride the memory bus instead of a NIC.  Ties and tier-resident
        sources fall back to round-robin over the app's agents."""
        node_vals: Dict[str, int] = {}
        head = chain[0]                # keyframe carries the bulk
        for op in prog.ops:
            provider, _ = providers[(head, op.src)]
            if isinstance(provider, Agent):
                node_vals[provider.node_id] = \
                    node_vals.get(provider.node_id, 0) + op.nvals
        best = max(node_vals, key=lambda n: (node_vals[n], n), default=None)
        if best is not None and best in by_node:
            locals_ = by_node[best]
            return locals_[dp % len(locals_)]
        return agents[dp % len(agents)]

    def _resolve_sources(self, app_id: AppId, region: str,
                         chain: Tuple[int, ...],
                         programs: Dict[int, planlib.TransferProgram],
                         want: Optional[set] = None) -> dict:
        """(ckpt_id, src_part) → (provider, key) for every needed source
        frame: a live L1 agent holding a replica, else the PFS, else L3.
        ``want`` (optional) restricts resolution to the given
        (ckpt_id, src_part) pairs — pruned frames never need a provider."""
        ctl = self.ctl
        l3 = getattr(ctl, "l3", None)
        needed = sorted({op.src for prog in programs.values()
                         for op in prog.ops})
        providers = {}
        for part in needed:
            for cid in chain:
                if want is not None and (cid, part) not in want:
                    continue
                pair = next(ctl.catalog.agents_with(app_id, cid, region,
                                                    part), None)
                if pair is not None:
                    providers[(cid, part)] = pair
                    continue
                key = ShardKey(app_id, cid, region, part)
                if ctl.pfs.has_shard(key):
                    providers[(cid, part)] = (ctl.pfs, key)
                elif l3 is not None and l3.has_shard(key):
                    providers[(cid, part)] = (l3, key)
                else:
                    raise ICheckError(
                        f"source shard {app_id}/{cid}/{region}/{part} is "
                        f"unreachable on every tier")
        return providers

    def _stats(self, results: dict, reads: List[dict]) -> dict:
        """Analytic adapt-window timing: per-node serialized-at-full-bw sums
        (== fluid-model concurrent completion), window = busiest lane."""
        ctl = self.ctl
        # fallback bandwidths for a node whose manager vanished mid-window:
        # NodeSpec's own defaults, not re-hardcoded literals
        fallback = NodeSpec(node_id="?")
        lanes: Dict[str, float] = {}
        counts = {"cross": 0, "intra": 0, "tier": 0}
        bytes_moved = 0
        for r in reads:
            counts[r["kind"]] += 1
            bytes_moved += r["bytes"]
            node = r["node"]
            if r["kind"] == "cross":
                mgr = ctl._managers.get(node)
                bw = mgr.nic.bandwidth if mgr else fallback.nic_bandwidth
                lat = mgr.nic.latency if mgr else fallback.nic_latency
                lanes[node] = lanes.get(node, 0.0) + r["bytes"] / bw + lat
            elif r["kind"] == "intra":
                mgr = ctl._managers.get(node)
                bw = mgr.spec.mem_bandwidth if mgr \
                    else fallback.mem_bandwidth
                lanes[f"mem-{node}"] = lanes.get(f"mem-{node}", 0.0) \
                    + r["bytes"] / bw
            else:                         # shared tier (PFS/L3 object store)
                bw = ctl.pfs.ingest.bandwidth if node == ctl.pfs.name else \
                    getattr(getattr(ctl, "l3", None), "link",
                            ctl.pfs.ingest).bandwidth
                lanes[node] = lanes.get(node, 0.0) + r["bytes"] / bw
        # assembled parts are written into the owning node's memory
        for agent, _, nbytes in results.values():
            mgr = ctl._managers.get(agent.node_id)
            bw = mgr.spec.mem_bandwidth if mgr else fallback.mem_bandwidth
            lanes[f"mem-{agent.node_id}"] = \
                lanes.get(f"mem-{agent.node_id}", 0.0) + nbytes / bw
        return {
            "sim_s": max(lanes.values(), default=0.0),
            "bytes_moved": bytes_moved,
            "peer_hops": counts["cross"] + counts["intra"],
            "cross_reads": counts["cross"],
            "intra_reads": counts["intra"],
            "tier_reads": counts["tier"],
        }
