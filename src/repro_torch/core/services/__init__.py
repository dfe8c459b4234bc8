"""Focused subsystems of the checkpoint-service core.

The paper describes the controller as a composition of independent services
(§II, §III-A); each lives in its own module here and communicates through
the :mod:`repro.core.events` bus:

  * :mod:`placement` — policy-driven agent placement + agent-count adaptivity
  * :mod:`catalog`   — checkpoint lifecycle registry and the restart read path
  * :mod:`drain`     — bounded-concurrency L1→L2 drain orchestration + L1 GC
  * :mod:`health`    — heartbeats, shard re-replication, straggler advice,
                       RM node retake/migration handling
  * :mod:`resize`    — resize forewarning → pre-staged redistribution plans
  * :mod:`telemetry` — bus-fed per-app EWMA estimates (commit cost, drain
                       throughput, failure inter-arrival) + Prometheus export
  * :mod:`interval`  — Young/Daly checkpoint-interval re-solver publishing
                       ``INTERVAL_CHANGED`` events (the adaptive loop)
  * :mod:`lifecycle` — storage lifecycle: watermark demotion, background
                       L2→L3 trickle, keep-last-K retention/GC with pinning
  * :mod:`journal`   — write-ahead metadata journal (CRC-framed WAL +
                       compacted snapshots) and the controller epoch fence
"""
from .catalog import CheckpointCatalog
from .drain import DrainOrchestrator
from .health import HealthMonitor
from .interval import IntervalController, daly_interval, young_interval
from .journal import EpochFence, MetadataJournal, StaleEpochError
from .lifecycle import StorageLifecycleService
from .placement import PlacementService
from .resize import ResizePlanner
from .telemetry import AppTelemetry, TelemetryService

__all__ = ["CheckpointCatalog", "DrainOrchestrator", "HealthMonitor",
           "IntervalController", "PlacementService", "ResizePlanner",
           "StorageLifecycleService", "TelemetryService", "AppTelemetry",
           "EpochFence", "MetadataJournal", "StaleEpochError",
           "daly_interval", "young_interval"]
