"""Agent-scheduling policies.

"The controller ... performs the agent and node selection for connected
applications based on the iCheck agent scheduling policies.  These policies
consider various system metrics (available memory, checkpoint frequency and
size, and bandwidth usage) and can impact the overall checkpointing
performance." (§II)

A policy maps (node states, application requirements) → placement: a list of
(node_id, n_agents).  ``StaticPolicy`` is the non-adaptive baseline the paper
positions itself against (fixed resources, as in SCR/CRAFT-class libraries).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from .manager import Manager
from .types import AppRecord

Placement = List[Tuple[str, int]]           # [(node_id, n_agents)]


@dataclasses.dataclass
class NodeView:
    """What policies are allowed to see about a node."""

    node_id: str
    free_memory: float
    nic_bandwidth: float
    bw_load: float          # predicted concurrent streams
    n_agents: int
    max_agents: int

    @classmethod
    def of(cls, m: Manager) -> "NodeView":
        return cls(node_id=m.node_id,
                   free_memory=m.predicted_free_memory(),
                   nic_bandwidth=m.nic.bandwidth,
                   bw_load=m.predicted_bw_load(),
                   n_agents=len(m.agents()),
                   max_agents=m.spec.max_agents)


class SchedulingPolicy:
    name = "base"

    def place(self, nodes: Sequence[NodeView], app: AppRecord) -> Placement:
        raise NotImplementedError

    # how many agents an app *should* have given its checkpoint demand:
    # enough aggregate NIC bandwidth that a full commit (size × replication)
    # finishes well inside the checkpoint interval.
    @staticmethod
    def target_agent_count(app: AppRecord, nic_bw: float, max_agents: int = 8,
                           headroom: float = 4.0) -> int:
        demand = app.demand_bytes_per_s() * headroom
        if demand <= 0 or nic_bw <= 0:
            return 1
        return max(1, min(max_agents, math.ceil(demand / nic_bw)))


class StaticPolicy(SchedulingPolicy):
    """Non-adaptive baseline: always n agents on the first usable node."""

    name = "static"

    def __init__(self, n_agents: int = 1):
        self.n_agents = n_agents

    def place(self, nodes: Sequence[NodeView], app: AppRecord) -> Placement:
        for nv in nodes:
            if nv.n_agents + self.n_agents <= nv.max_agents:
                return [(nv.node_id, self.n_agents)]
        raise RuntimeError("no node can host agents")


class MemoryAwarePolicy(SchedulingPolicy):
    """Prefer nodes with the most predicted free memory; one node."""

    name = "memory"

    def place(self, nodes: Sequence[NodeView], app: AppRecord) -> Placement:
        need = app.ckpt_bytes_estimate * app.replication
        ranked = sorted(nodes, key=lambda nv: -nv.free_memory)
        n = self.target_agent_count(app, ranked[0].nic_bandwidth)
        placement: Placement = []
        remaining = need if need > 0 else 1
        for nv in ranked:
            if nv.n_agents >= nv.max_agents:
                continue
            k = min(n - sum(c for _, c in placement), nv.max_agents - nv.n_agents)
            if k <= 0:
                break
            placement.append((nv.node_id, k))
            remaining -= nv.free_memory
            if sum(c for _, c in placement) >= n and remaining <= 0:
                break
        if not placement:
            raise RuntimeError("no capacity for app placement")
        return placement


class BandwidthBalancedPolicy(SchedulingPolicy):
    """Spread agents over the least bandwidth-loaded nodes.

    Agents on distinct nodes add NIC capacity (the knee benchmark B1); agents
    sharing a node share its NIC — so spreading maximises aggregate rate.
    """

    name = "bandwidth"

    def place(self, nodes: Sequence[NodeView], app: AppRecord) -> Placement:
        usable = [nv for nv in nodes if nv.n_agents < nv.max_agents]
        if not usable:
            raise RuntimeError("no capacity for app placement")
        n = self.target_agent_count(app, usable[0].nic_bandwidth,
                                    max_agents=2 * len(usable))
        ranked = sorted(usable, key=lambda nv: (nv.bw_load, nv.n_agents))
        placement: Dict[str, int] = {}
        i = 0
        for _ in range(n):
            nv = ranked[i % len(ranked)]
            if placement.get(nv.node_id, 0) + nv.n_agents < nv.max_agents:
                placement[nv.node_id] = placement.get(nv.node_id, 0) + 1
            i += 1
        return list(placement.items()) or [(ranked[0].node_id, 1)]


class AdaptivePolicy(SchedulingPolicy):
    """The composite default: weighs memory fit, bandwidth load and the app's
    checkpoint frequency×size demand (all three metric families from §II)."""

    name = "adaptive"

    def __init__(self, mem_weight: float = 1.0, bw_weight: float = 1.0):
        self.mem_weight = mem_weight
        self.bw_weight = bw_weight

    def place(self, nodes: Sequence[NodeView], app: AppRecord) -> Placement:
        usable = [nv for nv in nodes if nv.n_agents < nv.max_agents]
        if not usable:
            raise RuntimeError("no capacity for app placement")
        need = max(1, app.ckpt_bytes_estimate * app.replication)

        def score(nv: NodeView) -> float:
            mem_fit = min(1.0, nv.free_memory / need)
            bw_fit = 1.0 / (1.0 + nv.bw_load)
            return self.mem_weight * mem_fit + self.bw_weight * bw_fit

        ranked = sorted(usable, key=score, reverse=True)
        n = self.target_agent_count(app, ranked[0].nic_bandwidth,
                                    max_agents=2 * len(usable))
        placement: Dict[str, int] = {}
        # fill best nodes first, at most 2 agents per node before spilling
        per_node_cap = 2
        for nv in ranked:
            while (placement.get(nv.node_id, 0) < per_node_cap
                   and nv.n_agents + placement.get(nv.node_id, 0) < nv.max_agents
                   and sum(placement.values()) < n):
                placement[nv.node_id] = placement.get(nv.node_id, 0) + 1
            if sum(placement.values()) >= n:
                break
        if not placement:
            placement[ranked[0].node_id] = 1
        return list(placement.items())


POLICIES = {p.name: p for p in
            (StaticPolicy(), MemoryAwarePolicy(), BandwidthBalancedPolicy(),
             AdaptivePolicy())}


def get_policy(name: str) -> SchedulingPolicy:
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
    return POLICIES[name]
