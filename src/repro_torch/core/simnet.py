"""Simulated fabric for the RDMA / PFS data paths.

The container this framework is validated in has a single CPU node and no
fabric, so *timing* is simulated while *data movement is real* (bytes really
land in agent stores).  Every NIC is a shared-bandwidth resource: concurrent
streams divide the link.  Durations are computed analytically (deterministic,
what benchmarks report) and optionally realised as scaled wall-clock sleeps so
that the asynchrony of the agent threads is real.

Simulated seconds are the unit reported by all benchmarks; ``time_scale``
maps them to wall seconds (0 = don't sleep at all, for unit tests).
"""
from __future__ import annotations

import threading
import time
from typing import Optional


class SimClock:
    """Virtual clock: sim_seconds = wall_seconds_elapsed / time_scale ... but
    because sleeps are scaled, sim time advances ~1:1 with the simulation."""

    def __init__(self, time_scale: float = 0.0):
        # time_scale: wall seconds slept per simulated second. 0 => no sleeping.
        self.time_scale = float(time_scale)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._sim_offset = 0.0  # accumulated virtual time when time_scale == 0

    def now(self) -> float:
        if self.time_scale > 0:
            return (time.monotonic() - self._t0) / self.time_scale
        with self._lock:
            return self._sim_offset

    def sleep(self, sim_seconds: float) -> None:
        if sim_seconds <= 0:
            return
        if self.time_scale > 0:
            time.sleep(sim_seconds * self.time_scale)
        else:
            with self._lock:
                self._sim_offset += sim_seconds


class SimNIC:
    """A bandwidth-shared link (node NIC, or the PFS ingest aggregate).

    Effective rate for a transfer is ``bandwidth / concurrent_streams``
    sampled at start — a deliberately simple fluid model; good enough to
    reproduce the knee behaviour the paper's agent-count adaptivity relies on.
    """

    def __init__(self, name: str, bandwidth: float, latency: float = 0.0,
                 clock: Optional[SimClock] = None):
        self.name = name
        self.bandwidth = float(bandwidth)
        self.latency = float(latency)
        self.clock = clock or SimClock()
        self._lock = threading.Lock()
        self._active = 0
        self._bytes_total = 0
        self._busy_sim_seconds = 0.0
        # optional per-transfer observer ``(link_name, nbytes, sim_s)`` —
        # the telemetry service's per-hop latency/size histograms
        self.on_transfer = None
        # fault injection
        self._slowdown = 1.0
        self._down = False

    # -- fault / straggler injection -------------------------------------
    def set_slowdown(self, factor: float) -> None:
        with self._lock:
            self._slowdown = max(1.0, float(factor))

    def set_down(self, down: bool) -> None:
        with self._lock:
            self._down = bool(down)

    @property
    def active_streams(self) -> int:
        with self._lock:
            return self._active

    def utilization_estimate(self, window_rate: float = 0.0) -> float:
        """Crude utilisation: fraction of link spoken for right now."""
        with self._lock:
            return min(1.0, self._active / 4.0)

    # -- transfer ----------------------------------------------------------
    def transfer_time(self, nbytes: int, concurrent: Optional[int] = None) -> float:
        """Analytic duration for ``nbytes`` with ``concurrent`` streams."""
        with self._lock:
            streams = max(1, self._active if concurrent is None else concurrent)
            slow = self._slowdown
        rate = self.bandwidth / streams
        return self.latency + (nbytes / rate) * slow

    def transfer(self, nbytes: int) -> float:
        """Run one transfer; returns simulated seconds it took."""
        with self._lock:
            if self._down:
                raise ConnectionError(f"NIC {self.name} is down")
            self._active += 1
            streams = self._active
            slow = self._slowdown
        try:
            rate = self.bandwidth / streams
            dur = self.latency + (nbytes / rate) * slow
            self.clock.sleep(dur)
            with self._lock:
                self._bytes_total += nbytes
                self._busy_sim_seconds += dur
            observer = self.on_transfer
            if observer is not None:
                try:
                    observer(self.name, nbytes, dur)
                except Exception:  # noqa: BLE001 - observers must not break us
                    pass
            return dur
        finally:
            with self._lock:
                self._active -= 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "bytes_total": self._bytes_total,
                "busy_sim_seconds": self._busy_sim_seconds,
                "active_streams": self._active,
            }


class MemBus(SimNIC):
    """Node-local memory channel for intra-node peer copies.

    Peer-to-peer redistribution between two agents on the *same* iCheck node
    never touches the NIC: the bytes move at memory bandwidth with no
    per-message latency.  Modelled with the same fluid shared-bandwidth
    semantics as :class:`SimNIC` so concurrent intra-node copies contend for
    the memory system like concurrent transfers contend for a link.
    """

    def __init__(self, name: str, bandwidth: float = 200e9,
                 clock: Optional[SimClock] = None):
        super().__init__(name, bandwidth, latency=0.0, clock=clock)


class FaultInjector:
    """Central switchboard used by tests/benchmarks to break things on cue."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dead_agents: set = set()
        self._dead_nodes: set = set()
        self._straggler_agents: dict = {}   # agent_id -> slowdown factor
        # node_id -> transports (NIC + MemBus) severed when the node dies
        self._transports: dict = {}
        # unordered node pairs with a partial partition between them
        self._partitions: set = set()

    def register_transport(self, node_id: str, *links: "SimNIC") -> None:
        """Attach a node's links so :meth:`kill_node` can sever them.

        Managers register their NIC and MemBus at construction: a dead node
        must drop transport, not just fail liveness checks — otherwise an
        in-flight ``peer_read`` against one of its agents completes instead
        of raising."""
        with self._lock:
            self._transports.setdefault(node_id, []).extend(links)

    def kill_agent(self, agent_id: str) -> None:
        with self._lock:
            self._dead_agents.add(agent_id)

    def revive_agent(self, agent_id: str) -> None:
        with self._lock:
            self._dead_agents.discard(agent_id)

    def kill_node(self, node_id: str) -> None:
        with self._lock:
            self._dead_nodes.add(node_id)
            links = list(self._transports.get(node_id, ()))
        # sever outside the lock: set_down takes each link's own lock
        for link in links:
            link.set_down(True)

    # -- partial partitions ----------------------------------------------
    def partition_nodes(self, node_a: str, node_b: str) -> None:
        """Block peer traffic between two (live) nodes in both directions."""
        with self._lock:
            self._partitions.add(frozenset((node_a, node_b)))

    def heal_partition(self, node_a: str, node_b: str) -> None:
        with self._lock:
            self._partitions.discard(frozenset((node_a, node_b)))

    def partitioned(self, node_a: str, node_b: str) -> bool:
        if node_a == node_b:
            return False
        with self._lock:
            return frozenset((node_a, node_b)) in self._partitions

    def make_straggler(self, agent_id: str, slowdown: float) -> None:
        with self._lock:
            self._straggler_agents[agent_id] = float(slowdown)

    def clear_straggler(self, agent_id: str) -> None:
        with self._lock:
            self._straggler_agents.pop(agent_id, None)

    def agent_dead(self, agent_id: str) -> bool:
        with self._lock:
            return agent_id in self._dead_agents

    def node_dead(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self._dead_nodes

    def agent_slowdown(self, agent_id: str) -> float:
        with self._lock:
            return self._straggler_agents.get(agent_id, 1.0)


class EWMA:
    """Exponentially-weighted moving average — the managers' predictor for
    node usage parameters (paper §II: "monitoring and predicting the node
    usage parameters (e.g., memory usage, bandwidth usage)")."""

    def __init__(self, alpha: float = 0.3, init: float = 0.0):
        self.alpha = float(alpha)
        self.value = float(init)
        self._seen = False

    def update(self, x: float) -> float:
        if not self._seen:
            self.value = float(x)
            self._seen = True
        else:
            self.value = self.alpha * float(x) + (1 - self.alpha) * self.value
        return self.value

    def predict(self) -> float:
        return self.value
