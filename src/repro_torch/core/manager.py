"""iCheck Managers.

"The manager manages the node-level activities of the software, such as
launching the agents and monitoring and predicting the node usage parameters
(e.g., memory usage, bandwidth usage)." (§II)

One Manager per iCheck node.  It owns the node's storage tiers — a
``TierPipeline`` of checkpoint RAM (``MemoryTier``, L1) plus an optional
node-local disk spill (``LocalDiskTier``, L0.5) — and NIC (``SimNIC``),
launches/stops agents on request from the controller, and keeps EWMA
predictors of memory and bandwidth usage that the controller's scheduling
policies consume.
"""
from __future__ import annotations

import itertools
import tempfile
import threading
from typing import Dict, List, Optional

from . import events as E
from .agent import Agent
from .simnet import EWMA, FaultInjector, MemBus, SimClock, SimNIC
from .tiers import LocalDiskTier, MemoryTier, TierPipeline
from .types import AgentId, AppId, NodeSpec


class Manager:
    def __init__(self, spec: NodeSpec, clock: Optional[SimClock] = None,
                 fault: Optional[FaultInjector] = None, bus=None,
                 spill_bytes: int = 0, spill_dir: Optional[str] = None,
                 fence=None):
        self.spec = spec
        self.node_id = spec.node_id
        self.clock = clock or SimClock()
        self.fault = fault or FaultInjector()
        self.bus = bus
        # controller epoch fence: agents launched here stamp + validate ops
        self.fence = fence
        tiers = [MemoryTier(spec.memory_bytes)]
        if spill_bytes > 0:
            root = spill_dir or tempfile.mkdtemp(
                prefix=f"icheck-spill-{spec.node_id}-")
            tiers.append(LocalDiskTier(root, spill_bytes))
        self.store = TierPipeline(tiers, bus=bus, node_id=spec.node_id)
        self.nic = SimNIC(f"nic-{spec.node_id}", spec.nic_bandwidth,
                          spec.nic_latency, clock=self.clock)
        # intra-node peer-redistribution copies bypass the NIC on this bus
        self.membus = MemBus(f"mem-{spec.node_id}", spec.mem_bandwidth,
                             clock=self.clock)
        # node death must sever transport, not just liveness: the injector
        # downs both links when kill_node() fires
        self.fault.register_transport(self.node_id, self.nic, self.membus)
        self._agents: Dict[AgentId, Agent] = {}
        self._agent_apps: Dict[AgentId, AppId] = {}
        self._lock = threading.Lock()
        self._agent_seq = itertools.count()
        self.mem_ewma = EWMA(alpha=0.3)
        self.bw_ewma = EWMA(alpha=0.3)
        # adaptive loop: per-app checkpoint duty cycle (commit cost over the
        # solved interval) announced by the IntervalController; the manager
        # folds the duty of the apps *it serves* into its bandwidth
        # prediction so placement steers new agents away from NICs that the
        # retuned cadence is about to keep busy
        self._app_duty: Dict[AppId, float] = {}
        self._unsub_interval = bus.subscribe(
            self._on_interval_changed, events=(E.INTERVAL_CHANGED,)) \
            if bus is not None else None

    # ----------------------------------------------------------------- agents
    def launch_agent(self, app_id: AppId) -> Agent:
        """Paper §II step 4: managers launch agents and notify the controller."""
        with self._lock:
            if len(self._agents) >= self.spec.max_agents:
                raise RuntimeError(f"node {self.node_id} at max_agents")
            agent_id = f"{self.node_id}/a{next(self._agent_seq)}"
            # the bus's TraceCollector (when wired) rides into every agent
            # so inbox ops carry and reinstate the submitter's context
            agent = Agent(agent_id, self.node_id, self.store, self.nic,
                          self.fault, membus=self.membus,
                          tracer=getattr(self.bus, "tracer", None),
                          fence=self.fence, bus=self.bus)
            self._agents[agent_id] = agent
            self._agent_apps[agent_id] = app_id
        return agent

    def stop_agent(self, agent_id: AgentId) -> None:
        with self._lock:
            agent = self._agents.pop(agent_id, None)
            self._agent_apps.pop(agent_id, None)
        if agent is not None:
            agent.stop()

    def agents(self) -> List[Agent]:
        with self._lock:
            return list(self._agents.values())

    def agent(self, agent_id: AgentId) -> Optional[Agent]:
        with self._lock:
            return self._agents.get(agent_id)

    def agent_ids_for(self, app_id: AppId) -> List[AgentId]:
        """Agents on this node currently serving ``app_id`` (recovery uses
        this to rebuild app→agent assignments from live managers)."""
        with self._lock:
            return [aid for aid, app in self._agent_apps.items()
                    if app == app_id]

    # ----------------------------------------------------------------- health
    def alive(self) -> bool:
        return not self.fault.node_dead(self.node_id)

    def heartbeat(self) -> Optional[dict]:
        """Metrics snapshot, or None if the node is dead (missed heartbeat)."""
        if not self.alive():
            return None
        used = self.store.used_bytes
        self.mem_ewma.update(used)
        busy = self.nic.stats()["busy_sim_seconds"]
        self.bw_ewma.update(self.nic.active_streams)
        return {
            "node_id": self.node_id,
            "mem_used": used,
            "mem_free": self.store.free_bytes,
            "mem_pred": self.mem_ewma.predict(),
            "nic_active": self.nic.active_streams,
            "nic_busy_sim_s": busy,
            "n_agents": len(self._agents),
            "ckpt_duty_pred": self.ckpt_duty_pred(),
            "tiers": self.tier_occupancy(),
        }

    def tier_occupancy(self) -> List[dict]:
        """Per-tier fill levels — the watermark policy's per-node signal."""
        rows = []
        for tier in self.store.tiers:
            cap = tier.capacity
            used = tier.used_bytes
            bounded = cap not in (None, 0) and cap != float("inf")
            rows.append({
                "tier": tier.name,
                "used_bytes": used,
                "capacity_bytes": cap if bounded else 0,
                "occupancy": used / cap if bounded else 0.0,
            })
        return rows

    # ------------------------------------------------------- adaptive hints
    def _on_interval_changed(self, ev) -> None:
        p = ev.payload
        interval = max(float(p.get("interval_s", 0.0)), 1e-9)
        with self._lock:
            self._app_duty[p["app"]] = \
                float(p.get("commit_cost_s", 0.0)) / interval

    def ckpt_duty_pred(self) -> float:
        """Predicted NIC duty from the solved cadences of apps served here."""
        with self._lock:
            served = set(self._agent_apps.values())
            return sum(self._app_duty.get(a, 0.0) for a in served)

    # predicted headroom used by policies
    def predicted_free_memory(self) -> float:
        return self.spec.memory_bytes - max(self.store.used_bytes,
                                            self.mem_ewma.predict())

    def predicted_bw_load(self) -> float:
        return self.bw_ewma.predict() + self.ckpt_duty_pred()

    def close(self) -> None:
        if self._unsub_interval is not None:
            self._unsub_interval()
        for a in self.agents():
            a.stop()
        self.store.close()
