"""iCheck Agents.

"The agent performs the functionality of checkpoint read/write (using
libfabric) and data redistribution (for malleable implementations).  Multiple
agents can be assigned to a single application, and iCheck can dynamically
change the agent count to obtain an optimum checkpoint transfer rate." (§II)

An Agent here is a worker thread bound to an iCheck node's storage tiers
(a ``TierPipeline``: L1 RAM + optional L0.5 local-disk spill) and NIC.
Writes (RDMA puts from the application) and L2 drains run through its
queue; reads for restart/redistribution are served concurrently off the
thread-safe tiers with simulated NIC time.  All payloads are real bytes —
and opaque: with the ``q8``/``q8-delta`` codecs the client ships int8
(sparse-delta) wire frames, so agents, drains and every tier move the
already-compressed bytes and never re-encode.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import trace_id_for
from .retry import with_backoff
from .simnet import EWMA, FaultInjector, MemBus, SimNIC
from .tiers import (PFSTier, SliceState, TierPipeline, decode_payload,
                    decode_slice_frames, ec_decode_shard, ec_encode_shard,
                    ec_parse_fragment, replay_slice_frames, slice_payload)
from .types import (AgentId, ICheckError, IntegrityError, NodeId, RestoreError,
                    ShardKey, TransferRecord)


class AgentDead(ConnectionError):
    pass


@dataclasses.dataclass(frozen=True)
class SliceFetch:
    """One transfer-program op, fully resolved: pull flattened elements
    [vlo, vhi) of a source shard (replaying ``sources`` in chain order for
    ``q8-delta``) and land them at ``dst_lo`` of the assembled buffer.

    Each source is ``(provider, key)`` where the provider is the holding
    :class:`Agent` (peer read over the fabric) or a shared tier with a
    ``read_shard`` method (PFS/L3 fallback, sliced locally after the read).
    """

    vlo: int
    vhi: int
    dst_lo: int
    codec: str
    dtype: str
    sources: Tuple[Tuple[object, ShardKey], ...]


@dataclasses.dataclass(frozen=True)
class AssembleSpec:
    """One destination part of a redistribution: the scratch key the
    assembled payload lands under in this agent's L1, and its slice reads.

    ``keep_state`` retains the per-fetch q8 decode state
    (:class:`~.tiers.SliceState`) after the assembly, so a zero-stall
    cutover can later :meth:`~Agent.replay` tail delta frames onto the
    stored payload instead of re-streaming the keyframe."""

    out_key: ShardKey
    dtype: str
    nvals: int
    fetches: Tuple[SliceFetch, ...]
    keep_state: bool = False


@dataclasses.dataclass(frozen=True)
class RebuildSpec:
    """Peer rebuild of erasure-coded fragments lost with an agent/node.

    This agent gathers any ``k`` surviving fragments of one stripe from the
    ``sources`` (whole-fragment peer reads over MemBus/NIC — a dead or
    partitioned source is skipped, not fatal), GF-decodes the payload,
    re-derives the ``want`` fragments and hosts them in its own L1.  When
    fewer than ``k`` peer fragments survive, the ``fallback`` providers
    (PFS/L3, holding the *full* shard under ``base_key``) supply the payload
    instead, so a rebuild racing further failures degrades to a lower tier
    rather than wedging.
    """

    base_key: ShardKey           # replica-0 identity of the logical shard
    k: int
    m: int
    want: Tuple[int, ...]        # ShardKey.replica values to regenerate here
    sources: Tuple[Tuple["Agent", ShardKey], ...]
    fallback: Tuple[Tuple[object, ShardKey], ...] = ()


@dataclasses.dataclass(frozen=True)
class ReplaySpec:
    """Tail catch-up of one already-assembled destination part: advance the
    retained slice states by the delta frames committed during an overlap
    window and patch the stored scratch payload in place.  ``fetches`` must
    cover the same (vlo, vhi, dst_lo) ranges as the original assemble, with
    ``sources`` listing only the *tail* chain frames."""

    out_key: ShardKey
    dtype: str
    fetches: Tuple[SliceFetch, ...]


class _Op:
    __slots__ = ("kind", "key", "payload", "crc", "future", "pfs", "on_done",
                 "trace", "epoch")

    def __init__(self, kind, key=None, payload=None, crc=None, future=None,
                 pfs=None, on_done=None, trace=None, epoch=None):
        self.kind = kind
        self.key = key
        self.payload = payload
        self.crc = crc
        self.future = future
        self.pfs = pfs
        self.on_done = on_done
        # TraceContext of the submitting thread: the inbox hand-off crosses
        # threads, so causality must ride the op itself
        self.trace = trace
        # controller epoch current when the op was submitted; the dispatch
        # loop refuses ops stamped before a controller recovery
        self.epoch = epoch


class Agent:
    """One checkpoint agent living on an iCheck node."""

    def __init__(self, agent_id: AgentId, node_id: NodeId, store: TierPipeline,
                 nic: SimNIC, fault: Optional[FaultInjector] = None,
                 membus: Optional[MemBus] = None, tracer=None, fence=None,
                 bus=None):
        self.agent_id = agent_id
        self.node_id = node_id
        self.store = store
        self.nic = nic
        self.membus = membus
        self.tracer = tracer
        self.fence = fence          # controller EpochFence (None = unfenced)
        self.bus = bus              # controller EventBus (telemetry only)
        self.fault = fault or FaultInjector()
        self.peer_reads = 0
        self.peer_bytes_out = 0
        # decoded-payload memo (ShardKey → raw bytes): a zstd source shard
        # serves many slice reads during one redistribution — possibly
        # interleaved across shards — so decompress each once per adapt
        # window, not once per TransferOp (other codecs slice the stored
        # bytes directly).  Cleared by the engine when the window ends.
        self._decoded_memo: Dict[ShardKey, bytes] = {}
        # retained q8 decode state of keep_state assemblies (scratch key →
        # per-fetch SliceState), consumed by replay() at zero-stall cutover
        # and dropped with the scratch shard when the window ends
        self._assembly_state: Dict[ShardKey, List[Optional[SliceState]]] = {}
        self._inbox: "queue.Queue[_Op]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=f"agent-{agent_id}",
                                        daemon=True)
        self._lock = threading.Lock()
        self.transfers: List[TransferRecord] = []
        self.rate_ewma = EWMA(alpha=0.4)      # observed bytes/sim-second
        self.bytes_in = 0
        self._thread.start()

    # ------------------------------------------------------------------ RDMA
    def put(self, key: ShardKey, payload: bytes, crc: Optional[int] = None,
            *, epoch: Optional[int] = None) -> Future:
        """Non-blocking RDMA-put analogue.  Returns a Future that resolves to
        a TransferRecord once the shard has landed in L1.

        ``epoch`` overrides the fence stamp (tests and the chaos stale-probe
        use it to impersonate a pre-recovery submitter); by default the op
        carries the epoch current *now*, and the dispatch loop refuses it if
        a recovery happens before it runs."""
        fut: Future = Future()
        self._inbox.put(_Op("put", key=key, payload=payload, crc=crc,
                            future=fut, trace=self._cur_trace(),
                            epoch=self._cur_epoch() if epoch is None
                            else epoch))
        return fut

    def get(self, key: ShardKey) -> bytes:
        """Read a shard back (restart / redistribution path)."""
        self._check_alive()
        payload = self.store.get(key)          # crc-verified
        self.nic.transfer(len(payload))
        return payload

    def has(self, key: ShardKey) -> bool:
        return self.store.has(key)

    # -------------------------------------------------------- redistribution
    def peer_read(self, key: ShardKey, codec: str, dtype: str,
                  vlo: int, vhi: int, requester_node: NodeId) -> bytes:
        """Serve a slice frame for another agent's transfer program.

        Like :meth:`get`, served off the caller's thread (concurrent across
        agent pairs).  Only the sliced bytes move: intra-node requests ride
        the node's memory bus, cross-node requests pay this node's NIC once
        — the client is never in the path.
        """
        self._check_alive()
        if self.fault.partitioned(self.node_id, requester_node):
            raise ConnectionError(
                f"partition between {self.node_id} and {requester_node}")
        if codec == "zstd":
            with self._lock:
                raw = self._decoded_memo.get(key)
            if raw is None:
                raw = decode_payload(self.store.get(key, promote=False),
                                     codec, dtype)
                with self._lock:
                    self._decoded_memo[key] = raw
            blob = slice_payload(raw, "none", dtype, vlo, vhi)
        else:
            payload = self.store.get(key, promote=False)
            blob = slice_payload(payload, codec, dtype, vlo, vhi)
        if requester_node == self.node_id and self.membus is not None:
            self.membus.transfer(len(blob))
        else:
            self.nic.transfer(len(blob))
        self._check_alive()                  # may have died mid-transfer
        with self._lock:
            self.peer_reads += 1
            self.peer_bytes_out += len(blob)
        return blob

    def peer_read_raw(self, key: ShardKey, requester_node: NodeId) -> bytes:
        """Serve one stored blob whole (erasure-fragment rebuild path).

        The framed-fragment twin of :meth:`peer_read`: no codec slicing —
        fragments are opaque stripe rows — but the same fabric accounting
        (MemBus intra-node, NIC cross-node) and the same mid-transfer death
        semantics."""
        self._check_alive()
        if self.fault.partitioned(self.node_id, requester_node):
            raise ConnectionError(
                f"partition between {self.node_id} and {requester_node}")
        blob = self.store.get(key, promote=False)
        if requester_node == self.node_id and self.membus is not None:
            self.membus.transfer(len(blob))
        else:
            self.nic.transfer(len(blob))
        self._check_alive()                  # may have died mid-transfer
        with self._lock:
            self.peer_reads += 1
            self.peer_bytes_out += len(blob)
        return blob

    def clear_peer_cache(self) -> None:
        """Release the decoded-payload memo (end of an adapt window) — the
        decoded shards must not outlive the redistribution that needed
        them."""
        with self._lock:
            self._decoded_memo.clear()

    def assemble(self, spec: AssembleSpec) -> Future:
        """Build one destination part from peer slice reads (asynchronous;
        the assembled payload lands in this agent's L1 under
        ``spec.out_key``).  Resolves to ``{nbytes, reads}`` accounting."""
        fut: Future = Future()
        self._inbox.put(_Op("assemble", payload=spec, future=fut,
                            trace=self._cur_trace(),
                            epoch=self._cur_epoch()))
        return fut

    def replay(self, spec: ReplaySpec) -> Future:
        """Catch an assembled part up with the tail delta frames committed
        during an overlap window (asynchronous; requires the original
        assemble to have run with ``keep_state=True``).  Resolves to
        ``{nbytes, reads, patches}`` where ``patches`` lists the
        ``(dst_offset_vals, value_bytes)`` spans that changed — what the
        client splices into parts it already prefetched."""
        fut: Future = Future()
        self._inbox.put(_Op("replay", payload=spec, future=fut,
                            trace=self._cur_trace(),
                            epoch=self._cur_epoch()))
        return fut

    def drop_assembly_state(self, key: ShardKey) -> None:
        with self._lock:
            self._assembly_state.pop(key, None)

    def rebuild(self, spec: RebuildSpec) -> Future:
        """Regenerate lost erasure fragments onto this agent (asynchronous).
        Resolves to ``{restored, nbytes, reads, source, degraded}``
        accounting; raises ``RestoreError`` when neither k peer fragments
        nor a fallback tier can produce the payload."""
        fut: Future = Future()
        self._inbox.put(_Op("rebuild", payload=spec, future=fut,
                            trace=self._cur_trace(),
                            epoch=self._cur_epoch()))
        return fut

    # ------------------------------------------------------------------ L2
    def drain(self, keys: List[ShardKey], pfs: PFSTier,
              on_done: Optional[Callable] = None) -> Future:
        """Write the given L1 shards to the PFS (asynchronously)."""
        fut: Future = Future()
        self._inbox.put(_Op("drain", key=keys, pfs=pfs, future=fut,
                            on_done=on_done, trace=self._cur_trace(),
                            epoch=self._cur_epoch()))
        return fut

    # ------------------------------------------------------------------ admin
    def alive(self) -> bool:
        return (not self._stop.is_set()
                and not self.fault.agent_dead(self.agent_id)
                and not self.fault.node_dead(self.node_id))

    def stop(self) -> None:
        self._stop.set()
        self._inbox.put(_Op("stop"))
        self._thread.join(timeout=5)

    def observed_rate(self) -> float:
        """Predicted ingest rate (bytes / simulated second)."""
        r = self.rate_ewma.predict()
        return r if r > 0 else self.nic.bandwidth

    def stats(self) -> dict:
        with self._lock:
            return {
                "agent_id": self.agent_id,
                "node_id": self.node_id,
                "bytes_in": self.bytes_in,
                "transfers": len(self.transfers),
                "rate_ewma": self.rate_ewma.predict(),
                "peer_reads": self.peer_reads,
                "peer_bytes_out": self.peer_bytes_out,
                # scratch retained for open adapt windows — both must be 0
                # once every window has closed (the chaos leak invariant)
                "assembly_states": len(self._assembly_state),
                "decoded_memo": len(self._decoded_memo),
            }

    # ------------------------------------------------------------------ guts
    def _check_alive(self) -> None:
        if not self.alive():
            raise AgentDead(f"agent {self.agent_id} on node {self.node_id} is dead")

    def _cur_trace(self):
        """The submitting thread's TraceContext, to ride the op across the
        inbox (None when tracing is off)."""
        return self.tracer.current() if self.tracer is not None else None

    def _cur_epoch(self) -> Optional[int]:
        """The controller epoch to stamp an op with at submit time."""
        return self.fence.current if self.fence is not None else None

    def _check_epoch(self, op: _Op) -> None:
        """Refuse ops stamped before a controller recovery (zombie fencing):
        the submitting controller — or work it queued — predates the
        recovered state and must not mutate it."""
        if self.fence is None or op.epoch is None:
            return
        if op.epoch != self.fence.current:
            if self.bus is not None:
                from . import events as E
                self.bus.publish(E.STALE_OP_REJECTED, kind=op.kind,
                                 agent=self.agent_id, epoch=op.epoch,
                                 current=self.fence.current)
            from .services.journal import StaleEpochError
            raise StaleEpochError(
                f"agent {self.agent_id} refused {op.kind}: stamped epoch "
                f"{op.epoch}, fence at {self.fence.current}")

    def _op_trace_id(self, op: _Op) -> Optional[str]:
        """Trace identity of one op: the carried context's, else derived
        from the shard key — a drain retry resubmitted without context
        still re-joins its checkpoint's tree by id."""
        if op.trace is not None:
            return op.trace.trace_id
        key = op.key
        if op.kind in ("assemble", "replay"):
            key = op.payload.out_key
        elif op.kind == "rebuild":
            key = op.payload.base_key
        elif isinstance(key, list):
            key = key[0] if key else None
        if key is None:
            return None
        return trace_id_for(key.app_id, key.ckpt_id)

    def _run(self) -> None:
        while not self._stop.is_set():
            op = self._inbox.get()
            if op.kind == "stop":
                break
            try:
                self._check_epoch(op)
                tracer = self.tracer
                if tracer is not None and tracer.enabled:
                    trace_id = self._op_trace_id(op)
                    with tracer.use(op.trace):
                        if trace_id is not None:
                            with tracer.span(f"agent_{op.kind}", trace_id,
                                             self.agent_id):
                                self._dispatch(op)
                        else:
                            self._dispatch(op)
                else:
                    self._dispatch(op)
            except BaseException as e:  # noqa: BLE001 - surface through future
                if op.future is not None and not op.future.done():
                    op.future.set_exception(e)

    def _dispatch(self, op: _Op) -> None:
        if op.kind == "put":
            rec = self._do_put(op)
            op.future.set_result(rec)
        elif op.kind == "drain":
            res = self._do_drain(op)
            op.future.set_result(res)
            if op.on_done:
                op.on_done(res)
        elif op.kind == "assemble":
            op.future.set_result(self._do_assemble(op.payload))
        elif op.kind == "replay":
            op.future.set_result(self._do_replay(op.payload))
        elif op.kind == "rebuild":
            op.future.set_result(self._do_rebuild(op.payload))

    def _do_put(self, op: _Op) -> TransferRecord:
        self._check_alive()
        payload = op.payload
        # straggler injection slows this agent's transfers only
        slow = self.fault.agent_slowdown(self.agent_id)
        sim = self.nic.transfer(len(payload))
        if slow > 1.0:
            extra = sim * (slow - 1.0)
            self.nic.clock.sleep(extra)
            sim += extra
        self._check_alive()  # may have died mid-transfer
        self.store.put(op.key, payload, crc=op.crc)
        rec = TransferRecord(key=op.key, nbytes=len(payload),
                             agent_id=self.agent_id, sim_seconds=sim)
        with self._lock:
            self.transfers.append(rec)
            self.bytes_in += len(payload)
            if sim > 0:
                self.rate_ewma.update(len(payload) / sim)
        return rec

    def _do_assemble(self, spec: AssembleSpec) -> dict:
        """Execute one destination part's transfer program.

        Runs on this agent's worker thread; peer reads are direct calls into
        the source agents (served off *this* thread), so assemblies on
        different destination agents proceed concurrently and no agent ever
        waits on another agent's worker loop (no deadlock by construction).
        """
        self._check_alive()
        buf = np.zeros(spec.nvals, dtype=np.dtype(spec.dtype))
        reads: List[dict] = []
        tier_cache: dict = {}       # one whole-object read per shard, not per op
        states: List[Optional[SliceState]] = []
        for f in spec.fetches:
            frames = self._gather_frames(f, reads, tier_cache)
            if spec.keep_state:
                vals, st = decode_slice_frames(frames, f.dtype, f.vlo, f.vhi,
                                               return_state=True)
                states.append(st)
            else:
                vals = decode_slice_frames(frames, f.dtype, f.vlo, f.vhi)
            buf[f.dst_lo:f.dst_lo + vals.size] = vals
        self._check_alive()
        payload = buf.tobytes()
        self.store.put(spec.out_key, payload)
        with self._lock:
            self.bytes_in += len(payload)
            if spec.keep_state:
                self._assembly_state[spec.out_key] = states
        return {"key": spec.out_key, "nbytes": len(payload), "reads": reads}

    def _gather_frames(self, f: SliceFetch, reads: List[dict],
                       tier_cache: dict) -> List[bytes]:
        """Pull one fetch's slice frames (chain order) from its sources:
        live peer agents over the fabric, else a shared tier."""
        frames = []
        for provider, key in f.sources:
            if isinstance(provider, Agent):
                blob = provider.peer_read(key, f.codec, f.dtype,
                                          f.vlo, f.vhi, self.node_id)
                reads.append({
                    "node": provider.node_id, "bytes": len(blob),
                    "kind": "intra" if provider.node_id == self.node_id
                    else "cross"})
            else:
                # shared-tier fallback (PFS/L3): whole-object read, then
                # slice locally — rare, but it keeps a partially-drained
                # source from wedging the adapt window.  The cache holds
                # the *decoded* bytes for zstd so k ops on one source
                # cost one read and one decompress, not k
                cached = tier_cache.get(key)
                if cached is None:
                    # a tier mid-outage recovers within sim-milliseconds;
                    # a short backoff keeps one blip from failing the fetch
                    payload = with_backoff(
                        lambda: provider.read_shard(key), 0.1,
                        clock=self.nic.clock, bus=self.bus,
                        what=f"peer_fallback_read:{key.base()}")
                    reads.append({"node": provider.name,
                                  "bytes": len(payload), "kind": "tier"})
                    if f.codec == "zstd":
                        payload = decode_payload(payload, f.codec,
                                                 f.dtype)
                    cached = tier_cache[key] = payload
                blob = slice_payload(
                    cached, "none" if f.codec == "zstd" else f.codec,
                    f.dtype, f.vlo, f.vhi)
            frames.append(blob)
        return frames

    def _do_replay(self, spec: ReplaySpec) -> dict:
        """Advance a retained assembly by its tail frames and patch the
        stored scratch payload in place (zero-stall cutover, phase 2)."""
        self._check_alive()
        with self._lock:
            states = self._assembly_state.get(spec.out_key)
        if states is None or len(states) != len(spec.fetches):
            raise ICheckError(
                f"no retained assembly state for {spec.out_key} "
                f"(assemble must run with keep_state=True)")
        payload = bytearray(self.store.get(spec.out_key, promote=False))
        buf = np.frombuffer(payload, dtype=np.dtype(spec.dtype))
        reads: List[dict] = []
        tier_cache: dict = {}
        patches: List[Tuple[int, bytes]] = []
        patch_bytes = 0
        for i, f in enumerate(spec.fetches):
            frames = self._gather_frames(f, reads, tier_cache)
            spans, states[i] = replay_slice_frames(states[i], frames,
                                                   f.dtype, f.vlo, f.vhi)
            for off, vals in spans:
                buf[f.dst_lo + off:f.dst_lo + off + vals.size] = vals
                patches.append((f.dst_lo + off, vals.tobytes()))
                patch_bytes += vals.nbytes
        self._check_alive()
        self.store.put(spec.out_key, bytes(payload))
        with self._lock:
            self.bytes_in += patch_bytes
            self._assembly_state[spec.out_key] = states
        return {"key": spec.out_key, "nbytes": patch_bytes, "reads": reads,
                "patches": patches}

    def _do_rebuild(self, spec: RebuildSpec) -> dict:
        """Regenerate lost erasure fragments from surviving peers (or a
        lower tier) and host them in this agent's L1.

        Runs on this agent's worker thread like :meth:`_do_assemble`; the
        peer reads are direct calls into the source agents, so a source
        dying mid-gather raises on *its* side and is skipped here — the
        rebuild keeps draining the remaining sources and only falls back to
        L2/L3 when fewer than k fragments survive."""
        self._check_alive()
        frags: Dict[int, bytes] = {}
        reads: List[dict] = []
        for provider, key in spec.sources:
            if len(frags) >= spec.k:
                break
            try:
                blob = provider.peer_read_raw(key, self.node_id)
                _, _, idx, _, _, _ = ec_parse_fragment(blob)
            except (ConnectionError, KeyError, IntegrityError, ICheckError):
                continue        # source died / dropped / corrupt: next one
            frags[idx] = blob
            reads.append({
                "node": provider.node_id, "bytes": len(blob),
                "kind": "intra" if provider.node_id == self.node_id
                else "cross"})
        source = "peer"
        payload = None
        if len(frags) >= spec.k:
            payload = ec_decode_shard(list(frags.values()))
        else:
            for provider, key in spec.fallback:
                try:
                    payload = provider.read_shard(key)
                except (KeyError, ConnectionError, OSError, ICheckError):
                    continue
                source = getattr(provider, "name", "tier")
                reads.append({"node": source, "bytes": len(payload),
                              "kind": "tier"})
                break
        if payload is None:
            raise RestoreError(
                f"stripe {spec.base_key} unrecoverable: {len(frags)} of "
                f"{spec.k} fragments survive and no lower tier has it")
        # degraded = the decode had to do field math (a data row was among
        # the casualties), as opposed to gather-k-and-concat
        degraded = (source != "peer"
                    or sorted(frags)[:spec.k] != list(range(spec.k)))
        stripe = dict(ec_encode_shard(payload, spec.k, spec.m))
        self._check_alive()
        stored = 0
        restored = []
        for rep in spec.want:
            blob = stripe[rep]
            self.store.put(dataclasses.replace(spec.base_key, replica=rep),
                           blob)
            stored += len(blob)
            restored.append(rep)
        with self._lock:
            self.bytes_in += stored
        return {"key": spec.base_key, "restored": restored, "nbytes": stored,
                "reads": reads, "source": source, "degraded": degraded}

    def _do_drain(self, op: _Op) -> dict:
        self._check_alive()
        written = 0
        sim_total = 0.0
        for key in op.key:
            # read in place: draining a demoted/spilled shard must not pull
            # it back into RAM (that would undo the watermark policy)
            payload = self.store.get(key, promote=False)
            sim_total += op.pfs.write_shard(key, payload)
            written += len(payload)
        return {"bytes": written, "sim_seconds": sim_total, "keys": list(op.key)}
