"""Failure detection + node lifecycle.

Heartbeat-style monitoring (agent/node death), shard re-replication from
surviving replicas or L2, straggler advice for the client's
first-completion-wins retry, and the RM plugin's node retake / migration
interactions (paper §III-A interactions 2-3).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

from ...obs import trace_id_for
from .. import events as E
from ..agent import Agent, RebuildSpec
from ..manager import Manager
from ..tiers import ec_is_fragment
from ..types import ShardKey


class HealthMonitor:
    def __init__(self, ctl, heartbeat_interval_s: float = 0.05):
        self.ctl = ctl
        self.interval = heartbeat_interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="icheck-monitor")

    def start(self) -> None:
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    # ----------------------------------------------------- straggler advice
    def transfer_deadline(self, nbytes: int, agent: Agent,
                          factor: float = 4.0, slack: float = 1e-3) -> float:
        """Sim-seconds after which a put to ``agent`` counts as straggling."""
        rate = max(1.0, agent.observed_rate())
        return factor * (nbytes / rate) + slack

    # ------------------------------------------------------------ monitoring
    def _loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.interval)
            try:
                self.check()
            except Exception as e:   # noqa: BLE001 - monitor must never die
                # ...but a silently-wedged monitor means failures go unseen:
                # surface every poll error and dump the flight ring so the
                # wedge is diagnosable from the artifacts
                self._report_error(e)

    def _report_error(self, exc: BaseException) -> None:
        ctl = self.ctl
        try:
            ctl.bus.publish(E.MONITOR_ERROR, error=repr(exc))
            flight = getattr(ctl, "flight", None)
            if flight is not None:
                flight.dump("monitor_error", extra={"error": repr(exc)})
        except Exception:   # noqa: BLE001 - reporting must not kill the loop
            pass

    def check(self) -> None:
        ctl = self.ctl
        dead_nodes = [m.node_id for m in ctl.managers() if not m.alive()]
        for node_id in dead_nodes:
            self.handle_node_failure(node_id)
        # single-agent failures (process died, node fine)
        for mgr in ctl.managers():
            if not mgr.alive():
                continue
            for agent in mgr.agents():
                if ctl.fault.agent_dead(agent.agent_id):
                    self.handle_agent_failure(mgr, agent)

    def handle_agent_failure(self, mgr: Manager, agent: Agent) -> None:
        ctl = self.ctl
        ctl.bus.publish(E.AGENT_FAILED, agent=agent.agent_id)
        mgr.stop_agent(agent.agent_id)
        with ctl._lock:
            apps = [a for a in ctl._apps.values() if agent.agent_id in a.agents]
        for app in apps:
            with ctl._lock:
                app.agents.remove(agent.agent_id)
            if mgr.alive() and len(mgr.agents()) < mgr.spec.max_agents:
                na = mgr.launch_agent(app.app_id)    # node memory survived
                with ctl._lock:
                    app.agents.append(na.agent_id)
                ctl.bus.publish(E.AGENT_REPLACED, old=agent.agent_id,
                                new=na.agent_id)

    def handle_node_failure(self, node_id: str) -> None:
        ctl = self.ctl
        with ctl._lock:
            mgr = ctl._managers.pop(node_id, None)
            if mgr is None:
                return
        ctl.bus.publish(E.NODE_FAILED, node=node_id)
        mgr.close()
        # erasure-coded stripes get a peer *rebuild* (a surviving agent
        # regenerates just the lost fragments from any k survivors); whole
        # shards are re-copied from surviving replicas/L2
        lost: List[ShardKey] = mgr.store.keys()
        stripes: Dict[ShardKey, List[int]] = {}
        for key in lost:
            base = key.base()
            if ec_is_fragment(key.replica) \
                    and ctl.catalog.ec_geometry(base.app_id) is not None:
                stripes.setdefault(base, []).append(key.replica)
                continue
            try:
                payload = ctl.catalog.fetch_shard(base.app_id, base.ckpt_id,
                                                  base.region, base.part)
            except KeyError:
                ctl.catalog.mark_failed(base.app_id, base.ckpt_id)
                continue
            # anti-affinity: never land the recovery copy on a node that
            # already holds a replica of the same shard (that would leave
            # the durability loss permanent while looking repaired)
            d = ctl.placement.recovery_destination(base,
                                                   exclude_nodes=(node_id,))
            if d is not None:
                d.store.put(base, payload)
        for base in sorted(stripes, key=str):
            self.rebuild_stripe(base, stripes[base])
        # replace the node's agents
        with ctl._lock:
            apps = list(ctl._apps.values())
        for app in apps:
            gone = [aid for aid in app.agents if aid.split("/")[0] == node_id]
            if not gone:
                continue
            with ctl._lock:
                for aid in gone:
                    app.agents.remove(aid)
            survivors = [m for m in ctl.managers() if m.alive()]
            if not survivors and ctl.request_more_memory():
                survivors = [m for m in ctl.managers() if m.alive()]
            for _ in gone:
                if survivors:
                    d = min(survivors, key=lambda m: len(m.agents()))
                    na = d.launch_agent(app.app_id)
                    with ctl._lock:
                        app.agents.append(na.agent_id)
        ctl.bus.publish(E.NODE_RECOVERED, node=node_id)

    # --------------------------------------------------- erasure rebuilds
    def rebuild_stripe(self, base: ShardKey, lost_replicas: List[int],
                       timeout: float = 30.0) -> bool:
        """Regenerate the lost fragments of one erasure stripe.

        A healthy agent (hosted away from the surviving siblings' nodes)
        gathers any k fragments over MemBus/NIC, GF-decodes the payload and
        re-hosts the lost fragments; when fewer than k peers survive, the
        agent falls back to the PFS/L3 copy of the full shard.  Returns
        True when the stripe is whole again."""
        ctl = self.ctl
        ec = ctl.catalog.ec_geometry(base.app_id)
        if ec is None:
            return False
        k, m = ec
        want = tuple(sorted(set(lost_replicas)))
        sources = tuple(ctl.catalog.fragments_with(
            base.app_id, base.ckpt_id, base.region, base.part))
        agents = [a for a in ctl.agents_for(base.app_id) if a.alive()]
        if not agents:
            ctl.bus.publish(E.EC_REBUILD_FAILED, app=base.app_id,
                            ckpt=base.ckpt_id, region=base.region,
                            part=base.part, error="no live agents")
            self._fail_if_not_durable(base)
            return False
        holder_nodes = {a.node_id for a, _ in sources}
        clean = [a for a in agents if a.node_id not in holder_nodes]
        host = min(clean or agents, key=lambda a: a.store.used_bytes)
        fallback = [(ctl.pfs, base)]
        l3 = getattr(ctl, "l3", None)
        if l3 is not None:
            fallback.append((l3, base))
        spec = RebuildSpec(base_key=base, k=k, m=m, want=want,
                           sources=sources, fallback=tuple(fallback))
        ctl.bus.publish(E.EC_REBUILD_STARTED, app=base.app_id,
                        ckpt=base.ckpt_id, region=base.region,
                        part=base.part, lost=list(want),
                        survivors=len(sources), host=host.agent_id)
        t0 = ctl.clock.now()
        trace_id = trace_id_for(base.app_id, base.ckpt_id)
        try:
            with ctl.tracer.span("ec_rebuild", trace_id, "health/monitor",
                                 region=base.region, part=base.part,
                                 lost=len(want)):
                res = host.rebuild(spec).result(timeout=timeout)
        except Exception as e:  # noqa: BLE001 - a lost stripe, not a crash
            ctl.bus.publish(E.EC_REBUILD_FAILED, app=base.app_id,
                            ckpt=base.ckpt_id, region=base.region,
                            part=base.part, error=repr(e))
            self._fail_if_not_durable(base)
            return False
        ctl.bus.publish(E.EC_REBUILD_DONE, app=base.app_id,
                        ckpt=base.ckpt_id, region=base.region,
                        part=base.part, source=res["source"],
                        degraded=res["degraded"], bytes=res["nbytes"],
                        host=host.agent_id,
                        sim_s=max(ctl.clock.now() - t0, 0.0))
        return True

    def _fail_if_not_durable(self, base: ShardKey) -> None:
        """An unrecoverable L1 stripe only fails the checkpoint when no
        lower tier holds the shard either."""
        ctl = self.ctl
        l3 = getattr(ctl, "l3", None)
        if ctl.pfs.has_shard(base) or (l3 is not None and l3.has_shard(base)):
            return
        ctl.catalog.mark_failed(base.app_id, base.ckpt_id)

    # ------------------------------------------------ RM plugin interactions
    def on_rm_retake(self, node_id: str) -> None:
        """RM pulls a node: migrate its shards to the remaining nodes, move
        its agents, then let the RM have it (paper §III-A interaction 2)."""
        ctl = self.ctl
        with ctl._lock:
            mgr = ctl._managers.get(node_id)
        if mgr is None:
            return
        ctl.bus.publish(E.NODE_RETAKEN, node=node_id)
        others = [m for m in ctl.managers() if m.node_id != node_id and m.alive()]
        if not others:
            if ctl.request_more_memory():
                others = [m for m in ctl.managers()
                          if m.node_id != node_id and m.alive()]
        # migrate shard bytes
        for key in mgr.store.keys():
            payload = mgr.store.get(key, verify=False)
            dst = min(others, key=lambda m: m.store.used_bytes, default=None)
            if dst is None:
                ctl.bus.publish(E.MIGRATION_LOST_SHARD, key=str(key))
                continue
            dst.store.put(key, payload)
        # relocate agents app-by-app
        with ctl._lock:
            apps = list(ctl._apps.values())
        for app in apps:
            moved = [aid for aid in app.agents if aid.split("/")[0] == node_id]
            for aid in moved:
                mgr.stop_agent(aid)
                with ctl._lock:
                    app.agents.remove(aid)
                if others:
                    dst = min(others, key=lambda m: len(m.agents()))
                    na = dst.launch_agent(app.app_id)
                    with ctl._lock:
                        app.agents.append(na.agent_id)
        mgr.close()
        with ctl._lock:
            ctl._managers.pop(node_id, None)

    def on_rm_migrate(self, src: str, dst: str) -> None:
        """RM-directed migration src → dst (paper §III-A interaction 3):
        shard bytes AND the serving agents move, so L1 restart/redistribution
        keeps working from the destination node."""
        ctl = self.ctl
        with ctl._lock:
            src_mgr = ctl._managers.get(src)
            dst_mgr = ctl._managers.get(dst)
        if src_mgr is None or dst_mgr is None:
            return
        for key in src_mgr.store.keys():
            payload = src_mgr.store.get(key, verify=False)
            dst_mgr.store.put(key, payload)
            src_mgr.store.drop(key)
        with ctl._lock:
            apps = list(ctl._apps.values())
        for app in apps:
            moved = [aid for aid in app.agents if aid.split("/")[0] == src]
            for aid in moved:
                src_mgr.stop_agent(aid)
                with ctl._lock:
                    app.agents.remove(aid)
                na = dst_mgr.launch_agent(app.app_id)
                with ctl._lock:
                    app.agents.append(na.agent_id)
        ctl.bus.publish(E.NODE_MIGRATED, src=src, dst=dst)
