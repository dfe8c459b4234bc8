"""Convenience assembly of a full iCheck deployment for tests / examples /
benchmarks: RM + controller (service core) + N iCheck nodes + PFS, all on
one simulated fabric clock.

``adaptive_interval`` (default True — adaptivity is the system's headline
behavior): the IntervalController treats each app's registered
``ckpt_interval_s`` as a starting hint and re-solves it (Young/Daly) from
observed commit cost and failure rate, announcing changes as
``interval_changed`` events.  Pass ``adaptive_interval=False`` for
experiments that need the registered interval to stay fixed.

``l3=True`` attaches a :class:`~repro.core.tiers.RemoteObjectTier` (S3/GCS
analogue) behind the PFS: sealed checkpoints trickle L2→L3 in the
background, retention trims the faster tiers (``keep_l2``/``keep_l3``), and
cold restarts fall back to the object store when L1 and L2 are gone.
``watermark_high``/``watermark_low`` drive the proactive L1 demotion policy
on nodes that have a spill tier (``spill_bytes > 0``).

``trace=True`` (or any ``trace_path=``) turns on sim-time checkpoint
tracing: one causal span tree per checkpoint, exported as Chrome/Perfetto
``trace_event`` JSON to ``trace_path`` when the cluster closes.  ``obs_dir``
overrides where flight-recorder crash dumps land (default
``artifacts/obs/``)."""
from __future__ import annotations

import tempfile
from typing import Optional

from .controller import Controller
from .rm import ResourceManager
from .simnet import FaultInjector, SimClock
from .tiers import PFSTier, RemoteObjectTier


class ICheckCluster:
    def __init__(self, n_icheck_nodes: int = 2, n_spare_nodes: int = 2,
                 node_memory: int = 8 << 30, nic_bandwidth: float = 25e9,
                 pfs_bandwidth: float = 40e9, pfs_root: Optional[str] = None,
                 policy: str = "adaptive", time_scale: float = 0.0,
                 keep_l1: int = 2, max_concurrent_drains: int = 2,
                 spill_bytes: int = 0, adaptive_interval: bool = True,
                 default_mtbf_s: float = 3600.0,
                 l3: bool = False, l3_root: Optional[str] = None,
                 l3_bandwidth: float = 5e9, l3_request_latency: float = 0.03,
                 watermark_high: float = 0.85, watermark_low: float = 0.60,
                 keep_l2: int = 0, keep_l3: int = 0,
                 delta_keyframe_every: int = 8,
                 trace: bool = False, trace_path: Optional[str] = None,
                 obs_dir: Optional[str] = None, journal: bool = True):
        self.clock = SimClock(time_scale)
        self.fault = FaultInjector()
        self.rm = ResourceManager()
        for _ in range(n_icheck_nodes + n_spare_nodes):
            self.rm.make_node(memory_bytes=node_memory,
                              nic_bandwidth=nic_bandwidth)
        self._tmp = None
        self._tmp_l3 = None
        if pfs_root is None:
            # ignore_cleanup_errors: a drain/agent thread that outlives its
            # join timeout must not turn teardown into an OSError
            self._tmp = tempfile.TemporaryDirectory(
                prefix="icheck-pfs-", ignore_cleanup_errors=True)
            pfs_root = self._tmp.name
        self.pfs = PFSTier(pfs_root, bandwidth=pfs_bandwidth, clock=self.clock)
        self.l3 = None
        if l3 or l3_root is not None:
            if l3_root is None:
                self._tmp_l3 = tempfile.TemporaryDirectory(
                    prefix="icheck-l3-", ignore_cleanup_errors=True)
                l3_root = self._tmp_l3.name
            self.l3 = RemoteObjectTier(l3_root, bandwidth=l3_bandwidth,
                                       request_latency=l3_request_latency,
                                       clock=self.clock)
        self.controller = Controller(
            self.rm, self.pfs, policy=policy, initial_nodes=n_icheck_nodes,
            clock=self.clock, fault=self.fault, keep_l1=keep_l1,
            max_concurrent_drains=max_concurrent_drains,
            spill_bytes=spill_bytes, adaptive_interval=adaptive_interval,
            default_mtbf_s=default_mtbf_s, l3=self.l3,
            watermark_high=watermark_high, watermark_low=watermark_low,
            keep_l2=keep_l2, keep_l3=keep_l3,
            delta_keyframe_every=delta_keyframe_every,
            trace=trace, trace_path=trace_path, obs_dir=obs_dir,
            journal=journal)

    @property
    def telemetry(self):
        """The controller's TelemetryService (structured + Prometheus)."""
        return self.controller.telemetry

    @property
    def bus(self):
        """The controller's event bus (subscribe for telemetry)."""
        return self.controller.bus

    @property
    def lifecycle(self):
        """The controller's StorageLifecycleService (watermarks/trickle/GC)."""
        return self.controller.lifecycle

    @property
    def tracer(self):
        """The controller's TraceCollector (sim-time checkpoint tracing)."""
        return self.controller.tracer

    @property
    def flight(self):
        """The controller's FlightRecorder (crash-dump ring buffer)."""
        return self.controller.flight

    def close(self) -> None:
        self.controller.close()
        if self._tmp is not None:
            self._tmp.cleanup()
        if self._tmp_l3 is not None:
            self._tmp_l3.cleanup()

    def __enter__(self) -> "ICheckCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
