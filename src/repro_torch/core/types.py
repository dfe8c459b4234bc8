"""Core datatypes for the iCheck checkpoint-management system.

These mirror the entities in the paper (§II): iCheck *nodes* host *agents*
launched by per-node *managers* under a global *controller*; applications
register *regions* (checkpointable arrays + their distribution mapping, paper
Listing 1 ``icheck_add_adapt``) and commit *checkpoints* that live in agent
memory (L1) and are drained to the PFS (L2).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional

# --------------------------------------------------------------------------
# identifiers
# --------------------------------------------------------------------------
AppId = str
NodeId = str
AgentId = str
CkptId = int


class PartitionScheme(str, enum.Enum):
    """Data-redistribution schemes supported by iCheck (paper §III-B).

    BLOCK / CYCLIC / REPLICATED are the paper's 1-d schemes; MESH is the
    beyond-paper N-d generalisation used for JAX arrays sharded over a
    (pod, data, model) device mesh.
    """

    BLOCK = "block"
    CYCLIC = "cyclic"
    REPLICATED = "replicated"
    MESH = "mesh"


class CkptStatus(str, enum.Enum):
    PENDING = "pending"          # commit issued, transfers in flight
    IN_L1 = "in_l1"              # complete in agent memory
    DRAINING = "draining"        # L1 -> L2 writeback in progress
    IN_L2 = "in_l2"              # durable on the PFS (may also still be in L1)
    IN_L3 = "in_l3"              # durable in the remote object store (and
    #                              possibly still in L2/L1 until retention
    #                              trims those copies)
    EXPIRED = "expired"          # retention dropped it from every tier
    FAILED = "failed"


class AppStatus(str, enum.Enum):
    REGISTERED = "registered"
    CONNECTED = "connected"
    ADAPTING = "adapting"        # inside MPI_Comm_adapt_begin/commit window
    FINISHED = "finished"
    FAILED = "failed"


@dataclasses.dataclass
class NodeSpec:
    """An iCheck node: dedicated memory + NIC the agents on it share."""

    node_id: NodeId
    memory_bytes: int = 64 << 30           # 64 GiB of checkpoint RAM
    nic_bandwidth: float = 25e9            # 25 GB/s (e.g. 200 Gb HDR)
    nic_latency: float = 2e-6              # RDMA one-sided put latency
    mem_bandwidth: float = 200e9           # intra-node copy bandwidth (DDR)
    max_agents: int = 16


@dataclasses.dataclass
class AgentSpec:
    agent_id: AgentId
    node_id: NodeId
    app_id: Optional[AppId] = None         # agents are assigned per application


@dataclasses.dataclass
class PartitionDesc:
    """How a registered region is distributed over application ranks.

    ``axis`` is the distributed axis of the global array; ``num_parts`` the
    number of application ranks holding it.  ``block`` is the cyclic block
    size (paper only needs block/cyclic; block=1 is classic cyclic).
    """

    scheme: PartitionScheme = PartitionScheme.BLOCK
    axis: int = 0
    num_parts: int = 1
    block: int = 1
    # MESH only: per-part bounds, tuple over parts of tuple over dims of
    # (lo, hi) global index ranges.
    bounds: Optional[tuple] = None

    def renumbered(self, new_parts: int) -> "PartitionDesc":
        return dataclasses.replace(self, num_parts=new_parts)


@dataclasses.dataclass
class RegionMeta:
    """One checkpointable array registered via ``icheck_add_adapt``."""

    name: str
    shape: tuple
    dtype: str
    partition: PartitionDesc
    nbytes: int
    # optional codec applied on the transfer path (beyond-paper, TPU-native)
    codec: str = "raw"                     # raw | zstd | q8 | q8-delta
    # q8-delta frame bookkeeping, set on the *per-checkpoint* RegionMeta
    # copies (the add_adapt registry meta keeps both None): ``frame`` says
    # whether this checkpoint's shards are a full q8 keyframe or a sparse
    # XOR-delta against the previous codes, and ``chain`` lists the ckpt ids
    # (keyframe first, this checkpoint last) a restore must replay in order
    frame: Optional[str] = None            # "key" | "delta"
    chain: Optional[tuple] = None          # (keyframe_ckpt, ..., this_ckpt)

    @property
    def itemsize(self) -> int:
        import numpy as np

        return int(np.dtype(self.dtype).itemsize)


@dataclasses.dataclass(frozen=True)
class ShardKey:
    """Key of one stored shard: (app, checkpoint, region, part index)."""

    app_id: AppId
    ckpt_id: CkptId
    region: str
    part: int
    replica: int = 0

    def base(self) -> "ShardKey":
        return ShardKey(self.app_id, self.ckpt_id, self.region, self.part, 0)


@dataclasses.dataclass
class ShardInfo:
    key: ShardKey
    nbytes: int
    crc32: int
    agent_id: Optional[AgentId] = None     # where it currently lives (L1)
    in_l2: bool = False


@dataclasses.dataclass
class CheckpointMeta:
    app_id: AppId
    ckpt_id: CkptId
    step: int
    regions: dict = dataclasses.field(default_factory=dict)   # name -> RegionMeta
    shards: dict = dataclasses.field(default_factory=dict)    # ShardKey -> ShardInfo
    status: CkptStatus = CkptStatus.PENDING
    created_at: float = dataclasses.field(default_factory=time.monotonic)
    completed_at: Optional[float] = None
    # extra payload the application wants back verbatim on restart
    # (step counters, RNG keys, data-iterator cursors, ...)
    userdata: bytes = b""
    # pinned checkpoints are exempt from retention/GC on every tier
    pinned: bool = False

    def expected_shards(self) -> int:
        return sum(m.partition.num_parts for m in self.regions.values())

    def is_complete_in_l1(self) -> bool:
        base = {k.base() for k in self.shards}
        return len(base) >= self.expected_shards()


@dataclasses.dataclass
class AppRecord:
    """Controller-side record of a connected application (paper §II step 1)."""

    app_id: AppId
    ranks: int
    status: AppStatus = AppStatus.REGISTERED
    # checkpoint characteristics used by scheduling policies (paper §II:
    # "available memory, checkpoint frequency and size, and bandwidth usage")
    ckpt_bytes_estimate: int = 0
    ckpt_interval_s: float = 60.0
    replication: int = 1
    # erasure-coded durability: (k, m) stripe geometry, or None for
    # whole-shard replication; EC apps keep replication == 1 (the k data +
    # m parity fragments ARE the redundancy)
    ec: Optional[tuple] = None
    agents: list = dataclasses.field(default_factory=list)    # [AgentId]
    checkpoints: dict = dataclasses.field(default_factory=dict)  # CkptId -> CheckpointMeta
    next_ckpt_id: CkptId = 0
    # resize forewarning from the RM (paper §III-A: "impending resource change")
    pending_resize: Optional[int] = None

    def l1_overhead_factor(self) -> float:
        """L1 bytes per logical byte: (k+m)/k under EC, replication else."""
        if self.ec:
            k, m = self.ec
            return (k + m) / k
        return float(self.replication)

    def demand_bytes_per_s(self) -> float:
        if self.ckpt_interval_s <= 0:
            return 0.0
        return (self.ckpt_bytes_estimate * self.l1_overhead_factor()
                / self.ckpt_interval_s)


@dataclasses.dataclass
class TransferRecord:
    """Accounting for one RDMA-analogue shard transfer."""

    key: ShardKey
    nbytes: int
    agent_id: AgentId
    sim_seconds: float
    ok: bool = True
    retried: bool = False


class ICheckError(RuntimeError):
    pass


class CapacityError(ICheckError):
    pass


class IntegrityError(ICheckError):
    pass


class RestoreError(ICheckError):
    """A checkpoint could not be reconstructed (missing or corrupt delta-chain
    link, truncated frame, ...) — raised instead of decoding garbage."""

