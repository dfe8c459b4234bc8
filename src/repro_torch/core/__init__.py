"""iCheck core — the paper's primary contribution.

An adaptive, asynchronous, multi-level, application-level checkpoint
management system with a data-redistribution service for malleable
applications (John & Gerndt, 2022), adapted from MPI clusters to elastic
JAX/TPU training (see DESIGN.md §2).
"""
from .agent import Agent, AgentDead
from .client import CommitHandle, ICheckClient
from .cluster import ICheckCluster
from .controller import Controller
from .events import AuditLog, Event, EventBus
from .malleable import MalleableApp, ProcType
from .manager import Manager
from .plan import (Move, MeshMove, apply_mesh_moves, apply_moves,
                   assemble_array, boxes_to_desc, local_shape, mesh_moves,
                   mesh_part_bounds, partition_intervals,
                   redistribution_moves, split_array)
from .policies import (AdaptivePolicy, BandwidthBalancedPolicy,
                       MemoryAwarePolicy, StaticPolicy, get_policy)
from .rm import ResizeEvent, ResourceManager
from .services import (IntervalController, StorageLifecycleService,
                       TelemetryService, daly_interval, young_interval)
from .simnet import EWMA, FaultInjector, SimClock, SimNIC
from .snapshot import HostSnapshot, restore_pytree, snapshot_pytree
from .tiers import (DeltaState, EncodedRegion, LocalDiskTier, MemoryTier,
                    PFSTier, RemoteObjectTier, StorageTier, TierPipeline,
                    crc32, decode_payload, encode_delta_region,
                    encode_payload, q8_chain_decode, resolve_codec)
from .store import MemoryStore, PFSStore
from .types import (AppRecord, AppStatus, CheckpointMeta, CkptStatus,
                    ICheckError, IntegrityError, CapacityError, NodeSpec,
                    PartitionDesc, PartitionScheme, RegionMeta, RestoreError,
                    ShardInfo, ShardKey)

__all__ = [
    "Agent", "AgentDead", "CommitHandle", "ICheckClient", "ICheckCluster",
    "Controller", "AuditLog", "Event", "EventBus", "MalleableApp",
    "ProcType", "Manager", "Move", "MeshMove",
    "apply_mesh_moves", "apply_moves", "assemble_array", "boxes_to_desc",
    "local_shape", "mesh_moves", "mesh_part_bounds", "partition_intervals",
    "redistribution_moves", "split_array", "AdaptivePolicy",
    "BandwidthBalancedPolicy", "MemoryAwarePolicy", "StaticPolicy",
    "get_policy", "ResizeEvent", "ResourceManager",
    "IntervalController", "StorageLifecycleService", "TelemetryService",
    "daly_interval", "young_interval", "EWMA", "FaultInjector",
    "SimClock", "SimNIC", "HostSnapshot", "restore_pytree", "snapshot_pytree",
    "MemoryStore", "PFSStore", "MemoryTier", "PFSTier", "LocalDiskTier",
    "RemoteObjectTier", "StorageTier", "TierPipeline", "crc32", "encode_payload",
    "decode_payload", "resolve_codec", "DeltaState", "EncodedRegion",
    "encode_delta_region", "q8_chain_decode", "AppRecord", "AppStatus",
    "CheckpointMeta", "CkptStatus", "ICheckError", "IntegrityError",
    "CapacityError", "NodeSpec", "PartitionDesc", "PartitionScheme",
    "RegionMeta", "RestoreError", "ShardInfo", "ShardKey",
]
