"""Policy-driven agent placement + agent-count adaptivity.

Implements paper §II steps 2-6 (node/agent selection via the scheduling
policies) and the ``icheck_probe_agents`` adaptivity loop ("iCheck can
dynamically change the agent count to obtain an optimum checkpoint transfer
rate"), plus capacity-pressure escalation to the RM (§III-A interaction 1).
"""
from __future__ import annotations

from typing import List, Optional

from .. import events as E
from ..agent import Agent
from ..policies import SchedulingPolicy, get_policy
from ..types import AppId, AppRecord


class PlacementService:
    def __init__(self, ctl, policy: "str | SchedulingPolicy" = "adaptive"):
        self.ctl = ctl
        self.policy = get_policy(policy) if isinstance(policy, str) else policy

    # -------------------------------------------------------------- placement
    def place_app(self, app: AppRecord) -> List[Agent]:
        placement = self.policy.place(self.ctl.node_views(), app)
        agents: List[Agent] = []
        for node_id, count in placement:
            mgr = self.ctl._managers[node_id]
            for _ in range(count):
                agents.append(mgr.launch_agent(app.app_id))
        return agents

    def ensure_memory(self, app: AppRecord) -> None:
        ctl = self.ctl
        # (k+m)/k under erasure coding, the replication factor otherwise
        need = int(app.ckpt_bytes_estimate * app.l1_overhead_factor()
                   * max(1, ctl.keep_l1))
        guard = 0
        while ctl.total_free_memory() < need and guard < 16:
            if not ctl.request_more_memory():
                break
            guard += 1

    # ---------------------------------------------- failure-domain spreading
    def ensure_failure_domains(self, app: AppRecord,
                               domains: int) -> List[Agent]:
        """Erasure-coded stripes only survive node loss when the app's
        agents span enough *nodes* — a stripe scattered over k+m agents on
        one node dies with that node.  Launch one agent on additional live
        nodes (freest first) until the app spans ``min(domains, #live
        nodes)`` distinct failure domains."""
        ctl = self.ctl
        used = {a.node_id for a in ctl.agents_for(app.app_id)}
        guard = 0
        while len(used) < domains and guard < 16:
            guard += 1
            spare = sorted((m for m in ctl.managers()
                            if m.alive() and m.node_id not in used
                            and len(m.agents()) < m.spec.max_agents),
                           key=lambda m: m.store.used_bytes)
            if not spare:
                if not ctl.request_more_memory():
                    break               # RM has nothing left: best effort
                continue
            mgr = spare[0]
            agent = mgr.launch_agent(app.app_id)
            with ctl._lock:
                app.agents.append(agent.agent_id)
            used.add(mgr.node_id)
        return ctl.agents_for(app.app_id)

    def stripe_agents(self, app_id: AppId, n: int,
                      rotation: int = 0) -> List[Agent]:
        """``n`` agents for one stripe (or replica set) with failure-domain
        anti-affinity: interleave across nodes so the first ``n`` picks land
        on ``min(n, #nodes)`` distinct nodes — losing any one node costs at
        most ``ceil(n / #nodes)`` fragments.  ``rotation`` rotates the node
        order so consecutive stripes don't all start on the same node."""
        agents = self.ctl.agents_for(app_id)
        if not agents:
            return []
        by_node = {}
        for a in agents:
            by_node.setdefault(a.node_id, []).append(a)
        nodes = sorted(by_node)
        r = rotation % len(nodes)
        nodes = nodes[r:] + nodes[:r]
        order: List[Agent] = []
        depth = 0
        while len(order) < len(agents):
            for node in nodes:
                lane = by_node[node]
                if depth < len(lane):
                    order.append(lane[depth])
            depth += 1
        return [order[i % len(order)] for i in range(n)]

    def recovery_destination(self, base_key, exclude_nodes=()):
        """Where a recovered copy of ``base_key`` should land: the freest
        *live* node that does not already hold any replica or fragment of
        the same logical shard (re-copying onto a node that already has one
        silently voids durability).  Falls back to the freest live node
        when every survivor already holds a copy."""
        ctl = self.ctl
        base = base_key.base()
        holders = set(exclude_nodes)
        live = [m for m in ctl.managers() if m.alive()]
        for mgr in live:
            if any(k.base() == base for k in mgr.store.keys()):
                holders.add(mgr.node_id)
        clean = [m for m in live if m.node_id not in holders]
        pool = clean or live
        if not pool:
            return None
        return min(pool, key=lambda m: m.store.used_bytes)

    def handle_capacity_pressure(self, app_id: AppId) -> List[Agent]:
        """A commit hit a full node (paper §III-A: "when iCheck runs out of
        memory in a node, the controller can request more memory and get
        additional nodes from RM").  Grow by one node if the RM has any;
        either way, give the app an agent on the freest node it doesn't
        already use, and return the refreshed agent set."""
        ctl = self.ctl
        ctl.request_more_memory()
        with ctl._lock:
            have = set(ctl._apps[app_id].agents)
        used_nodes = {aid.split("/")[0] for aid in have}
        views = sorted(ctl.node_views(), key=lambda nv: -nv.free_memory)
        for prefer_new in (True, False):
            for nv in views:
                if prefer_new and nv.node_id in used_nodes:
                    continue
                mgr = ctl._managers[nv.node_id]
                if len(mgr.agents()) < mgr.spec.max_agents:
                    agent = mgr.launch_agent(app_id)
                    with ctl._lock:
                        ctl._apps[app_id].agents.append(agent.agent_id)
                    ctl.bus.publish(E.CAPACITY_GROW, app=app_id,
                                    node=nv.node_id, agent=agent.agent_id)
                    return ctl.agents_for(app_id)
        return ctl.agents_for(app_id)

    # ------------------------------------------------------------ adaptivity
    def probe(self, app_id: AppId,
              last_commit_sim_s: Optional[float] = None) -> List[Agent]:
        """``icheck_probe_agents``: re-tune the agent count for transfer rate.

        Heuristic: a commit should take at most ``target_frac`` of the
        checkpoint interval.  Too slow → add an agent on the least-loaded
        node (requesting a new node from the RM if saturated).  More than 2×
        over-provisioned → drop an agent, freeing resources for other apps.
        """
        ctl = self.ctl
        target_frac = 0.25
        with ctl._lock:
            app = ctl._apps[app_id]
        agents = ctl.agents_for(app_id)
        if last_commit_sim_s is None or app.ckpt_interval_s <= 0 or not agents:
            return agents
        budget = app.ckpt_interval_s * target_frac
        if last_commit_sim_s > budget:
            added = self._scale_up(app, agents)
            if added:
                ctl.bus.publish(E.AGENTS_SCALED_UP, app=app_id,
                                n=len(ctl.agents_for(app_id)))
        elif last_commit_sim_s < budget / 4 and len(agents) > 1:
            victim = agents[-1]
            mgr = ctl._managers[victim.node_id]
            mgr.stop_agent(victim.agent_id)
            with ctl._lock:
                app.agents.remove(victim.agent_id)
            ctl.bus.publish(E.AGENTS_SCALED_DOWN, app=app_id,
                            n=len(ctl.agents_for(app_id)))
        return ctl.agents_for(app_id)

    def _scale_up(self, app: AppRecord, agents: List[Agent]) -> bool:
        ctl = self.ctl
        # prefer a node not yet serving this app (fresh NIC)
        used_nodes = {a.node_id for a in agents}
        candidates = [nv for nv in ctl.node_views()
                      if nv.n_agents < nv.max_agents]
        fresh = [nv for nv in candidates if nv.node_id not in used_nodes]
        if not fresh and not ctl.request_more_memory():
            fresh = candidates     # fall back to sharing a NIC
        else:
            fresh = fresh or [nv for nv in ctl.node_views()
                              if nv.node_id not in used_nodes]
        if not fresh:
            return False
        nv = sorted(fresh, key=lambda v: (v.bw_load, v.n_agents))[0]
        agent = ctl._managers[nv.node_id].launch_agent(app.app_id)
        with ctl._lock:
            app.agents.append(agent.agent_id)
        return True
