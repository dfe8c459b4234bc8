"""The iCheck application library (paper Listing 1).

Maps 1:1 to the paper's API:

    icheck_init            -> ICheckClient.init
    icheck_add_adapt       -> ICheckClient.add_adapt / add_adapt_snapshot
    icheck_commit          -> ICheckClient.commit            (non-blocking)
    icheck_restart         -> ICheckClient.restart
    icheck_redistribute    -> ICheckClient.redistribute
    icheck_probe_agents    -> ICheckClient.probe_agents
    icheck_finalize        -> ICheckClient.finalize

"Since the agents use RDMA, the application does not need to block for data
transfer rather it can continue the execution immediately after notifying
the agents about the checkpoints." — ``commit`` therefore returns a
``CommitHandle`` immediately; a background completer thread drives the
transfers, retries stragglers, and finalises the checkpoint with the
controller.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import events as E
from . import plan as planlib
from ..obs import trace_id_for
from .agent import Agent, AgentDead
from .controller import Controller
from .tiers import (EncodedRegion, crc32, decode_payload, ec_encode_shard,
                    encode_delta_region, encode_payload, q8_chain_decode,
                    q8_repack_key, resolve_codec)
from .types import (AppId, CapacityError, CheckpointMeta, ICheckError,
                    PartitionDesc, PartitionScheme, RegionMeta, RestoreError,
                    ShardInfo, ShardKey)


class CommitHandle:
    """In-flight checkpoint: resolves once every shard is acked in L1."""

    def __init__(self, client: "ICheckClient", meta: CheckpointMeta,
                 puts: List[Tuple[ShardKey, bytes, Agent]], drain: bool,
                 trace=None, logical=None):
        self.client = client
        self.meta = meta
        self._puts = puts
        self._drain = drain
        # erasure-coded commits: base ShardKey -> (payload nbytes, crc32) of
        # the *logical* shard each fragment stripe encodes — recorded with
        # the catalog once every fragment is acked (fragments themselves
        # never appear in meta.shards; completeness stays base-key counted)
        self._logical = logical or {}
        # root TraceContext of this checkpoint's trace tree, captured on the
        # application thread and reinstated on the completer thread so the
        # agent puts / finalize / COMMIT_DONE all attach to the commit root
        self.trace = trace
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self.sim_duration = 0.0
        self.retries = 0

    # -- introspection ------------------------------------------------------
    @property
    def ckpt_id(self) -> int:
        return self.meta.ckpt_id

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> "CommitHandle":
        if not self._done.wait(timeout):
            raise TimeoutError(f"commit {self.meta.ckpt_id} still in flight")
        if self._error is not None:
            raise self._error
        return self

    # -- executed on the client's completer thread --------------------------
    def _complete(self) -> None:
        ctl = self.client.controller
        with ctl.tracer.use(self.trace):
            self._complete_traced(ctl)

    def _complete_traced(self, ctl) -> None:
        t0 = ctl.clock.now()
        per_node_sim: Dict[str, float] = {}
        try:
            frag_agent: Dict[ShardKey, str] = {}
            inflight = [(key, payload, agent, agent.put(key, payload))
                        for key, payload, agent in self._puts]
            for key, payload, agent, fut in inflight:
                rec = self._await_with_straggler_retry(key, payload, agent, fut)
                # agents on one node share its NIC: serialized-at-full-bw
                # time summed per NODE equals concurrent shared-bw time
                node = rec.agent_id.split("/")[0]
                per_node_sim[node] = per_node_sim.get(node, 0.0) \
                    + rec.sim_seconds
                if key.replica == 0:
                    ctl.record_shard(self.meta, ShardInfo(
                        key=key, nbytes=rec.nbytes, crc32=crc32(payload),
                        agent_id=rec.agent_id))
                elif key.base() in self._logical:
                    frag_agent.setdefault(key.base(), rec.agent_id)
            # one base-key ShardInfo per erasure stripe, carrying the
            # *logical* payload's size and crc (restores verify against it)
            for base, (nbytes, crc) in self._logical.items():
                ctl.record_shard(self.meta, ShardInfo(
                    key=base, nbytes=nbytes, crc32=crc,
                    agent_id=frag_agent.get(base, "")))
            # commit duration ≈ busiest NIC's total transfer time
            self.sim_duration = max(per_node_sim.values(), default=0.0)
            ctl.tracer.record(
                "l1_store", trace_id_for(self.meta.app_id, self.meta.ckpt_id),
                f"client/{self.meta.app_id}", t0=t0,
                dur_s=self.sim_duration, retries=self.retries)
            ctl.finalize_checkpoint(self.meta, drain=self._drain)
            self.client._last_commit_sim_s = self.sim_duration
            logical_bytes = (
                sum(n for n, _ in self._logical.values())
                + sum(len(p) for k, p, _ in self._puts if k.replica == 0))
            ctl.bus.publish(E.COMMIT_DONE, app=self.meta.app_id,
                            ckpt=self.meta.ckpt_id, step=self.meta.step,
                            bytes=logical_bytes,
                            sim_s=self.sim_duration, retries=self.retries)
        except BaseException as e:  # noqa: BLE001
            self._error = e
            # the catalog may hold delta-chain state referencing this
            # checkpoint's frames; marking it failed publishes CKPT_FAILED,
            # which resets the app's chains (next commit = keyframe)
            try:
                ctl.catalog.mark_failed(self.meta.app_id, self.meta.ckpt_id)
            except Exception:   # noqa: BLE001 - never mask the commit error
                pass
        finally:
            self._done.set()

    def _await_with_straggler_retry(self, key: ShardKey, payload: bytes,
                                    agent: Agent, fut: Future):
        """First-completion-wins re-issue of laggard transfers.

        Deadline comes from the controller's bandwidth prediction; on expiry
        (or agent death) the shard is re-put to the next healthy agent.
        Puts are idempotent, so a late original completing twice is harmless.
        """
        ctl = self.client.controller
        scale = max(ctl.clock.time_scale, 0.0)
        tried = {agent.agent_id}
        for _ in range(8):
            sim_deadline = ctl.transfer_deadline(len(payload), agent)
            wall_timeout = sim_deadline * scale + 2.0 if scale > 0 else 10.0
            try:
                return fut.result(timeout=wall_timeout)
            except AgentDead:
                pass
            except TimeoutError:
                self.retries += 1
            except ConnectionError:
                pass
            except CapacityError:
                # node full: controller asks the RM for another iCheck node
                # (paper SSIII-A), then we re-put to the grown agent set
                ctl.handle_capacity_pressure(key.app_id)
                tried.clear()
                tried.add(agent.agent_id)
            # pick a replacement agent
            candidates = [a for a in ctl.agents_for(key.app_id)
                          if a.agent_id not in tried] or ctl.agents_for(key.app_id)
            if not candidates:
                raise ICheckError(f"no live agents for {key}")
            agent = candidates[0]
            tried.add(agent.agent_id)
            fut = agent.put(key, payload)
        raise ICheckError(f"shard {key} could not be stored after retries")


class ResizeCutoverHandle:
    """Phase-1 handle of a zero-stall redistribution
    (``redistribute(..., overlap=True)``).

    While the handle is held, the application keeps stepping — and keeps
    committing — as the base checkpoint streams to the new partition in the
    background.  ``ready()`` flips once the stream landed and prefetches this
    client's wanted *base* parts (still overlap, not stall); ``cutover()``
    quiesces the window: the tail delta frames that accumulated meanwhile
    are replayed agent-side and only the changed value spans travel to the
    client, so the visible stall is bounded by one delta frame rather than
    the whole stream.

    Every failure shape degrades to the client funnel from the catalog head
    — bit-identical to a stop-the-world redistribution, just slower.
    """

    _FALLBACK_ERRORS = (ICheckError, ConnectionError, TimeoutError, KeyError)

    def __init__(self, client: "ICheckClient", name: str, window,
                 wanted: set, new_parts: int, part_shape, fallback,
                 trace_id: Optional[str] = None):
        self.client = client
        self.name = name
        self.window = window              # None = funnel-only degenerate
        self.trace_id = trace_id          # base checkpoint's trace tree
        self.wanted = set(wanted)
        self.new_parts = new_parts
        self._part_shape = part_shape
        self._fallback = fallback
        self._base: Optional[Dict[int, np.ndarray]] = None
        self._prefetch_s = 0.0
        self._prefetch_bytes = 0
        self._result: Optional[Dict[int, np.ndarray]] = None

    # -- phase 1 ------------------------------------------------------------
    def ready(self) -> bool:
        """True once the background stream resolved (the app may keep
        stepping until then — and after, right up to ``cutover()``)."""
        if self.window is None:
            return True
        if not self.window.ready():
            return False
        self._maybe_prefetch()
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self.window is None:
            return True
        ok = self.window.wait(timeout)
        if ok:
            self._maybe_prefetch()
        return ok

    def _maybe_prefetch(self) -> None:
        """Pull the wanted parts' base payloads while still overlapped: at
        cutover only the replayed spans need to travel through the client."""
        if self._base is not None or self.window is None:
            return
        try:
            base: Dict[int, np.ndarray] = {}
            lane: Dict[str, float] = {}
            dtype = np.dtype(self.window.region.dtype)
            for dp, agent, out_key, fut, _ in self.window.jobs:
                if dp not in self.wanted:
                    continue
                if fut.exception() is not None:
                    return    # cutover will surface it as a funnel fallback
                payload = agent.get(out_key)
                self._prefetch_bytes += len(payload)
                lane[agent.node_id] = lane.get(agent.node_id, 0.0) \
                    + len(payload) / agent.nic.bandwidth + agent.nic.latency
                base[dp] = np.frombuffer(bytearray(payload), dtype=dtype)
            self._prefetch_s = max(lane.values(), default=0.0)
            self._base = base
        except Exception:   # noqa: BLE001 - prefetch is an optimisation only
            self._base = None

    # -- phase 2 ------------------------------------------------------------
    def cutover(self) -> Dict[int, np.ndarray]:
        """Quiesce-and-switch: returns the wanted parts at the catalog head.
        Idempotent; call after the last pre-switch commit has been acked."""
        if self._result is not None:
            return self._result
        client = self.client
        ctl = client.controller
        if self.window is None:
            self._result = self._fallback()
            return self._result
        try:
            results, stats, patches = ctl.cutover_redistribution(self.window)
        except self._FALLBACK_ERRORS as e:
            ctl.bus.publish(E.REDISTRIBUTION_FALLBACK, app=client.app_id,
                            region=self.name, reason=repr(e))
            ctl.abort_overlap_redistribution(self.window)
            self._result = self._fallback()
            return self._result
        try:
            out, stall_fetch_s, bytes_client = self._apply(results, stats,
                                                           patches)
        except self._FALLBACK_ERRORS as e:
            ctl.release_redistribution(results)
            ctl.bus.publish(E.REDISTRIBUTION_FALLBACK, app=client.app_id,
                            region=self.name, reason=repr(e))
            self._result = self._fallback()
            return self._result
        ctl.release_redistribution(results)
        overlap_s = stats["overlap_sim_s"] + self._prefetch_s
        stall_s = stats["stall_sim_s"] + stall_fetch_s
        if self.trace_id is not None:
            ctl.tracer.record("cutover", self.trace_id,
                              f"client/{client.app_id}", dur_s=stall_s,
                              region=self.name, overlap_s=overlap_s,
                              tail_frames=stats["tail_frames"],
                              rehydrated=stats["rehydrated"])
        client._publish_redistribution_done(
            self.name, self.new_parts, "peer", overlap_s + stall_s,
            bytes_client + self._prefetch_bytes, stats,
            overlap_sim_s=overlap_s, stall_s=stall_s,
            overlap_commits=stats["overlap_commits"],
            tail_frames=stats["tail_frames"],
            rehydrated=stats["rehydrated"],
            wall_sim_s=stats["wall_sim_s"],
            window_skew=stats["window_skew"])
        self._result = out
        return out

    def _apply(self, results, stats, patches
               ) -> Tuple[Dict[int, np.ndarray], float, int]:
        """Turn the caught-up scratch parts into the wanted arrays.  With a
        prefetched base and a tail replay, only the patch spans travel (the
        stall); a re-hydration — or a cutover without a prior ``ready()`` —
        fetches the parts whole."""
        dtype = np.dtype(self.window.region.dtype)
        fetch_lane: Dict[str, float] = {}
        bytes_client = 0
        out: Dict[int, np.ndarray] = {}
        if self._base is not None and not stats["rehydrated"]:
            for p in sorted(self.wanted):
                arr = self._base[p]
                agent, _, _ = results[p]
                for off, valbytes in (patches or {}).get(p, []):
                    vals = np.frombuffer(valbytes, dtype=dtype)
                    arr[off:off + vals.size] = vals
                    bytes_client += len(valbytes)
                    fetch_lane[agent.node_id] = \
                        fetch_lane.get(agent.node_id, 0.0) \
                        + len(valbytes) / agent.nic.bandwidth \
                        + agent.nic.latency
                out[p] = arr.reshape(self._part_shape(p))
        else:
            for p in sorted(self.wanted):
                agent, key, _ = results[p]
                payload = agent.get(key)
                bytes_client += len(payload)
                fetch_lane[agent.node_id] = \
                    fetch_lane.get(agent.node_id, 0.0) \
                    + len(payload) / agent.nic.bandwidth + agent.nic.latency
                out[p] = np.frombuffer(bytearray(payload), dtype=dtype) \
                    .reshape(self._part_shape(p))
        return out, max(fetch_lane.values(), default=0.0), bytes_client

    def cancel(self) -> None:
        """Abandon the window without switching (scratch is released; the
        app stays on its old partition)."""
        if self.window is not None and self._result is None:
            self.client.controller.abort_overlap_redistribution(self.window)


class ICheckClient:
    def __init__(self, app_id: AppId, controller: Controller, ranks: int = 1,
                 replication: int = 1, codec: str = "raw",
                 ckpt_interval_s: float = 60.0,
                 keyframe_every: Optional[int] = None,
                 durability: str = "replicate", ec_k: int = 4, ec_m: int = 1):
        if durability not in ("replicate", "ec"):
            raise ICheckError(
                f"durability must be 'replicate' or 'ec', got {durability!r}")
        self.app_id = app_id
        self.controller = controller
        self.ranks = ranks
        self.replication = max(1, replication)
        # erasure-coded L1 durability: each committed shard is scattered as
        # k data + m parity fragments with node anti-affinity instead of
        # whole-shard copies — any m losses survive at (k+m)/k memory.
        # Replication is forced to 1: the stripe IS the redundancy.
        self.ec: Optional[Tuple[int, int]] = None
        if durability == "ec":
            if ec_k < 1 or ec_m < 1:
                raise ICheckError(f"ec needs k >= 1 and m >= 1, got "
                                  f"k={ec_k} m={ec_m}")
            self.ec = (int(ec_k), int(ec_m))
            self.replication = 1
        # q8-delta keyframe cadence override (None = controller default):
        # a full q8 keyframe every K commits bounds restart replay length
        self.keyframe_every = keyframe_every
        # codec resolution is part of the tier pipeline now: a requested
        # codec this process can't run (e.g. zstd without zstandard) degrades
        # to "none" with an audit event instead of mis-labelling shards
        self.codec = resolve_codec(codec, on_degrade=lambda req, actual:
                                   controller.bus.publish(
                                       E.CODEC_DEGRADED, app=app_id,
                                       requested=req, actual=actual))
        self.ckpt_interval_s = ckpt_interval_s
        # adaptive loop: the IntervalController re-solves our cadence from
        # observed commit cost + failure rate; track its announcements so
        # application-side pacing (`ckpt_interval_s`) follows the solution
        self._unsub_interval = controller.bus.subscribe(
            self._on_interval_changed, events=(E.INTERVAL_CHANGED,))
        self.agents: List[Agent] = []
        self.regions: Dict[str, RegionMeta] = {}
        self._rr = 0
        self._last_commit_sim_s: Optional[float] = None
        self._commit_q: "queue.Queue[Optional[CommitHandle]]" = queue.Queue()
        self._completer = threading.Thread(target=self._completer_loop,
                                           daemon=True,
                                           name=f"icheck-client-{app_id}")
        self._completer.start()
        self._initialized = False

    # ------------------------------------------------------------- lifecycle
    def init(self, ckpt_bytes_estimate: int = 0) -> "ICheckClient":
        """icheck_init(): register with the controller, connect to agents."""
        self.agents = self.controller.register_app(
            self.app_id, self.ranks, ckpt_bytes_estimate=ckpt_bytes_estimate,
            ckpt_interval_s=self.ckpt_interval_s, replication=self.replication,
            ec=self.ec)
        if self.keyframe_every is not None:
            self.controller.set_delta_keyframe_every(self.app_id,
                                                     self.keyframe_every)
        self._initialized = True
        return self

    def _on_interval_changed(self, ev: E.Event) -> None:
        if ev.payload.get("app") == self.app_id:
            self.ckpt_interval_s = float(ev.payload["interval_s"])

    def finalize(self) -> None:
        """icheck_finalize()."""
        self._commit_q.put(None)
        self._completer.join(timeout=10)
        self._unsub_interval()
        self.controller.notify_finished(self.app_id)

    # ----------------------------------------------------------- add_adapt
    def add_adapt(self, name: str, shape: Sequence[int], dtype: str,
                  scheme: PartitionScheme = PartitionScheme.BLOCK,
                  axis: int = 0, num_parts: Optional[int] = None,
                  block: int = 1,
                  bounds: Optional[tuple] = None) -> RegionMeta:
        """icheck_add_adapt(): register a checkpointable array + its
        distribution mapping (used later for redistribution)."""
        shape = tuple(int(s) for s in shape)
        desc = PartitionDesc(scheme=scheme, axis=axis,
                             num_parts=num_parts or self.ranks, block=block,
                             bounds=bounds)
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize if shape else \
            np.dtype(dtype).itemsize
        meta = RegionMeta(name=name, shape=shape, dtype=str(np.dtype(dtype)),
                          partition=desc, nbytes=nbytes, codec=self.codec)
        self.regions[name] = meta
        self.controller.register_region(self.app_id, meta)
        return meta

    def add_adapt_snapshot(self, snap) -> None:
        """Register every region of a ``HostSnapshot`` (JAX pytree path)."""
        for name, sr in snap.regions.items():
            meta = sr.meta
            meta.codec = self.codec
            self.regions[name] = meta
            self.controller.register_region(self.app_id, meta)

    # ---------------------------------------------------------------- commit
    def commit(self, step: int,
               parts_by_region: Dict[str, Dict[int, np.ndarray]],
               userdata: bytes = b"", blocking: bool = False,
               drain: bool = True,
               encoded: Optional[Dict[str, EncodedRegion]] = None
               ) -> CommitHandle:
        """icheck_commit(): notify agents, return immediately.

        ``parts_by_region[name][part]`` is the local array of that part
        (what each application rank holds).  ``encoded`` carries regions
        whose wire frames were already produced device-side
        (:func:`repro.core.snapshot.snapshot_pytree` with a q8 codec) — the
        commit path then only threads chain bookkeeping, no re-encode.

        With ``codec="q8-delta"`` each float region travels as a sparse
        XOR-delta frame against the catalog's previous-codes state (full
        keyframe every K commits, after a chain reset, or when churn makes
        the delta no smaller than a keyframe).
        """
        if not self._initialized:
            raise ICheckError("call init() first")
        encoded = dict(encoded or {})
        overlap = set(encoded) & set(parts_by_region)
        if overlap:
            raise ICheckError(f"regions {sorted(overlap)} passed both raw "
                              f"and pre-encoded")
        ctl = self.controller
        metas: Dict[str, RegionMeta] = {}
        for name in (*parts_by_region, *encoded):
            if name not in self.regions:
                raise ICheckError(f"region {name!r} was not add_adapt()ed")
            meta = self.regions[name]
            n_given = len(parts_by_region[name]) if name in parts_by_region \
                else len(encoded[name].blobs)
            if n_given != meta.partition.num_parts:
                raise ICheckError(
                    f"region {name!r}: got {n_given} parts, expected "
                    f"{meta.partition.num_parts}")
            # a region restored from a manifest may carry a codec this
            # process can't run (e.g. zstd without zstandard): degrade it
            # here so the new shards and manifest stay self-consistent
            meta.codec = resolve_codec(
                meta.codec, on_degrade=lambda req, actual, name=name:
                ctl.bus.publish(E.CODEC_DEGRADED, app=self.app_id,
                                region=name, requested=req, actual=actual))
            if meta.codec == "q8-delta" or name in encoded:
                # per-commit copy: frame/chain bookkeeping belongs to this
                # checkpoint's manifest, not the shared registry meta
                metas[name] = dataclasses.replace(meta, frame=None,
                                                  chain=None)
            else:
                metas[name] = meta
        ckpt = ctl.new_checkpoint(self.app_id, step, metas, userdata=userdata)
        agents = ctl.agents_for(self.app_id)
        if not agents:
            raise ICheckError("no agents assigned")

        # root of this checkpoint's trace tree: every later phase (agent
        # puts, L2 drain, L3 trickle, a restore hours later) attaches here
        trace_id = trace_id_for(self.app_id, ckpt.ckpt_id)
        root_ctx = ctl.tracer.record("commit", trace_id,
                                     f"client/{self.app_id}", root=True,
                                     step=step, drain=drain)

        t_enc = time.monotonic()
        stats = {"raw": 0, "enc": 0, "key": 0, "delta": 0,
                 "encode_s": 0.0, "publish": False}
        payloads: Dict[str, Dict[int, bytes]] = {}
        try:
            for name, parts in parts_by_region.items():
                meta = metas[name]
                raw = {part: np.ascontiguousarray(arr).tobytes()
                       for part, arr in parts.items()}
                if meta.codec == "q8-delta":
                    payloads[name] = self._encode_delta_host(
                        ckpt.ckpt_id, meta, raw, stats)
                else:
                    blobs = {
                        part: encode_payload(data, meta.codec, meta.dtype)
                        for part, data in raw.items()}
                    if meta.codec == "q8":
                        # plain q8 feeds the same codec gauges (its ~4x
                        # ratio must not read as "codec did nothing")
                        stats["raw"] += sum(len(b) for b in raw.values())
                        stats["enc"] += sum(len(b) for b in blobs.values())
                        stats["publish"] = True
                    payloads[name] = blobs
            for name, enc in encoded.items():
                payloads[name] = self._adopt_encoded(ckpt.ckpt_id,
                                                     metas[name], enc, stats)
        except BaseException:
            # some chains may already reference this checkpoint's frames,
            # which will never be stored — reset so the next commit keyframes
            ctl.reset_delta_chains(self.app_id, reason="commit_encode_failed")
            raise
        stats["encode_s"] += time.monotonic() - t_enc
        ctl.tracer.record("encode", trace_id, f"client/{self.app_id}",
                          dur_s=stats["encode_s"], parent=root_ctx,
                          raw_bytes=stats["raw"],
                          encoded_bytes=stats["enc"])

        puts: List[Tuple[ShardKey, bytes, Agent]] = []
        logical: Dict[ShardKey, Tuple[int, int]] = {}
        if self.ec:
            k, m = self.ec
            ec_raw = 0
            ec_wire = 0
            for name, blobs in payloads.items():
                for part, payload in blobs.items():
                    frags = ec_encode_shard(payload, k, m)
                    # failure-domain anti-affinity: fragments of one stripe
                    # interleave across nodes, so any m agent/node losses
                    # leave >= k fragments standing
                    spread = ctl.placement.stripe_agents(
                        self.app_id, len(frags), rotation=self._rr)
                    for (rep, blob), agent in zip(frags, spread):
                        key = ShardKey(self.app_id, ckpt.ckpt_id, name,
                                       part, rep)
                        puts.append((key, blob, agent))
                    base = ShardKey(self.app_id, ckpt.ckpt_id, name, part)
                    logical[base] = (len(payload), crc32(payload))
                    ec_raw += len(payload)
                    ec_wire += sum(len(b) for _, b in frags)
                    self._rr += 1
            ctl.bus.publish(E.EC_STRIPE_COMMITTED, app=self.app_id,
                            ckpt=ckpt.ckpt_id, k=k, m=m, stripes=len(logical),
                            logical_bytes=ec_raw, fragment_bytes=ec_wire)
        else:
            for name, blobs in payloads.items():
                for part, payload in blobs.items():
                    for rep in range(self.replication):
                        key = ShardKey(self.app_id, ckpt.ckpt_id, name, part,
                                       rep)
                        agent = agents[(self._rr + rep) % len(agents)]
                        puts.append((key, payload, agent))
                    self._rr += 1
        if stats["publish"]:
            ctl.bus.publish(E.CKPT_DELTA_COMMITTED, app=self.app_id,
                            ckpt=ckpt.ckpt_id, raw_bytes=stats["raw"],
                            encoded_bytes=stats["enc"],
                            key_frames=stats["key"],
                            delta_frames=stats["delta"],
                            encode_s=stats["encode_s"])
        handle = CommitHandle(self, ckpt, puts, drain=drain, trace=root_ctx,
                              logical=logical)
        self._commit_q.put(handle)
        if blocking:
            handle.wait(timeout=120)
        return handle

    def _encode_delta_host(self, ckpt_id: int, meta: RegionMeta,
                           raw: Dict[int, bytes], stats: dict
                           ) -> Dict[int, bytes]:
        """Host-side q8-delta encode of one region + chain advance."""
        ctl = self.controller
        rc = ctl.delta_chain(self.app_id, meta.name,
                             meta.partition.num_parts)
        blobs, states, frame = encode_delta_region(
            raw, meta.dtype, rc.parts if rc is not None else None)
        blobs, meta.frame, meta.chain = self._advance_or_keyframe(
            ckpt_id, meta.name, blobs, states, frame)
        stats["raw"] += sum(len(b) for b in raw.values())
        stats["enc"] += sum(len(b) for b in blobs.values())
        stats[meta.frame] += 1
        stats["publish"] = True
        return blobs

    def _advance_or_keyframe(self, ckpt_id: int, name: str,
                             blobs: Dict[int, bytes], states, frame: str):
        """Advance the catalog chain; if a background reset (demotion,
        failure, resize) raced the encode and the chain is gone, re-frame
        the carried codes as a self-contained keyframe instead of failing
        the commit."""
        ctl = self.controller
        if frame == "delta":
            try:
                chain = ctl.advance_delta_chain(self.app_id, ckpt_id, name,
                                                states, "delta")
                return blobs, "delta", chain
            except ICheckError:
                blobs = q8_repack_key(states)
                frame = "key"
        chain = ctl.advance_delta_chain(self.app_id, ckpt_id, name, states,
                                        frame)
        return blobs, frame, chain

    def _adopt_encoded(self, ckpt_id: int, meta: RegionMeta,
                       enc: EncodedRegion, stats: dict) -> Dict[int, bytes]:
        """Thread a device-encoded region's frames into this commit."""
        ctl = self.controller
        if enc.codec != meta.codec:
            raise ICheckError(
                f"region {meta.name!r}: encoded as {enc.codec!r} but "
                f"registered codec is {meta.codec!r}")
        if enc.codec == "q8-delta":
            blobs, frame = enc.blobs, enc.frame
            if frame == "delta":
                rc = ctl.delta_chain(self.app_id, meta.name,
                                     meta.partition.num_parts)
                if rc is None or (enc.parent_chain is not None
                                  and rc.chain != enc.parent_chain):
                    # the chain moved or reset between snapshot-encode and
                    # commit (e.g. a resize registered new boxes): the delta
                    # frames are useless, but the carried states hold the
                    # full codes — re-frame as a self-contained keyframe
                    blobs, frame = q8_repack_key(enc.states), "key"
            blobs, meta.frame, meta.chain = self._advance_or_keyframe(
                ckpt_id, meta.name, blobs, enc.states, frame)
            stats[meta.frame] += 1
            enc = dataclasses.replace(enc, blobs=blobs, frame=meta.frame)
        # q8 and q8-delta both feed the codec gauges (device path included)
        stats["publish"] = True
        stats["raw"] += enc.raw_nbytes
        stats["enc"] += sum(len(b) for b in enc.blobs.values())
        stats["encode_s"] += enc.encode_s
        return enc.blobs

    def commit_snapshot(self, snap, extra_parts: Optional[Dict] = None,
                        userdata: bytes = b"", blocking: bool = False,
                        drain: bool = True) -> CommitHandle:
        """Commit a :class:`~repro.core.snapshot.HostSnapshot` whose regions
        were encoded *on device* (``snapshot_pytree(codec=...)``): the
        client→agent fabric and every storage tier move the int8 frames the
        D2H copy already produced.  ``extra_parts`` adds plain host-side
        regions (e.g. a data-iterator cursor)."""
        self.add_adapt_snapshot(snap)
        encoded = {name: sr.encoded for name, sr in snap.regions.items()
                   if sr.encoded is not None}
        parts = {name: sr.parts for name, sr in snap.regions.items()
                 if sr.encoded is None}
        parts.update(extra_parts or {})
        return self.commit(snap.step, parts, userdata=userdata,
                           blocking=blocking, drain=drain, encoded=encoded)

    def delta_chain_lookup(self, name: str, num_parts: int):
        """Previous-codes state for a device-side delta encode (or None when
        the next frame of ``name`` must be a keyframe)."""
        return self.controller.delta_chain(self.app_id, name, num_parts)

    def _completer_loop(self) -> None:
        while True:
            handle = self._commit_q.get()
            if handle is None:
                return
            handle._complete()

    # --------------------------------------------------------------- restart
    def _fetch_decoded(self, region: RegionMeta, ckpt_id: int, part: int,
                       stats: Optional[dict] = None) -> bytes:
        """Fetch + decode one region part, replaying the delta chain
        (keyframe → deltas) for ``q8-delta`` regions.  ``stats`` (when
        given) accumulates the wire bytes that flowed through this client —
        the redistribution funnel's bytes-through-client accounting."""
        if region.codec != "q8-delta":
            blob = self.controller.fetch_shard(self.app_id, ckpt_id,
                                               region.name, part)
            if stats is not None:
                stats["wire_bytes"] += len(blob)
            return decode_payload(blob, region.codec, region.dtype)
        chain = region.chain or (ckpt_id,)
        blobs = []
        for cid in chain:
            try:
                blobs.append(self.controller.fetch_shard(
                    self.app_id, cid, region.name, part))
            except KeyError as e:
                raise RestoreError(
                    f"delta chain of {region.name!r} part {part} is broken: "
                    f"frame ckpt={cid} is gone (chain {chain})") from e
            if stats is not None:
                stats["wire_bytes"] += len(blobs[-1])
        return q8_chain_decode(blobs, region.dtype)

    def _ckpt_region(self, ckpt_id: int, name: str) -> RegionMeta:
        """The per-checkpoint RegionMeta (carries frame/chain) when known;
        falls back to the registry meta."""
        try:
            app = self.controller.app(self.app_id)
            meta = app.checkpoints.get(ckpt_id)
            if meta is not None and name in meta.regions:
                return meta.regions[name]
        except KeyError:
            pass
        return self.regions[name]

    def restart(self) -> Optional[Tuple[CheckpointMeta, Dict[str, Dict[int, np.ndarray]], str]]:
        """icheck_restart(): newest usable checkpoint → (meta, parts, level).

        Returns None when no checkpoint exists (fresh start, paper line 7-9).
        ``q8-delta`` checkpoints replay keyframe + deltas — bit-identical to
        restoring a full q8 frame of the same commit; a missing or corrupt
        chain link raises :class:`RestoreError` instead of decoding garbage.
        """
        found = self.controller.latest_restartable(self.app_id)
        if found is None:
            return None
        meta, level = found
        ctl = self.controller
        t0 = ctl.clock.now()
        out: Dict[str, Dict[int, np.ndarray]] = {}
        # the restore span re-joins the checkpoint's trace tree by id alone
        # (the commit may be hours old; no context survived to here)
        with ctl.tracer.span("restore",
                             trace_id_for(self.app_id, meta.ckpt_id),
                             f"client/{self.app_id}", tier=level):
            for name, region in meta.regions.items():
                parts: Dict[int, np.ndarray] = {}
                for part in range(region.partition.num_parts):
                    payload = self._fetch_decoded(region, meta.ckpt_id, part)
                    arr = np.frombuffer(bytearray(payload),
                                        dtype=np.dtype(region.dtype))
                    parts[part] = arr.reshape(self._part_shape(region, part))
                out[name] = parts
                # refresh the client-side region registry from the manifest
                # (scrubbed of this checkpoint's frame/chain bookkeeping)
                registry = dataclasses.replace(region, frame=None, chain=None)
                self.regions[name] = registry
                self.controller.register_region(self.app_id, registry)
            ctl.bus.publish(E.RESTORE_DONE, app=self.app_id,
                            ckpt=meta.ckpt_id, tier=level,
                            sim_s=max(ctl.clock.now() - t0, 0.0))
        return meta, out, level

    def _part_shape(self, region: RegionMeta, part: int) -> Tuple[int, ...]:
        desc = region.partition
        if desc.scheme == PartitionScheme.MESH:
            return tuple(hi - lo for lo, hi in desc.bounds[part])
        return planlib.local_shape(region.shape, desc, part)

    # ---------------------------------------------------------- redistribute
    def _resolve_redistribution_ckpt(self, ckpt_id: Optional[int]) -> int:
        if ckpt_id is not None:
            return ckpt_id
        found = self.controller.latest_restartable(self.app_id)
        if found is None:
            raise ICheckError("nothing to redistribute from")
        return found[0].ckpt_id

    def _fetch_source_parts(self, name: str, ckpt_id: int,
                            parts: Sequence[int],
                            stats: Optional[dict] = None
                            ) -> Dict[int, np.ndarray]:
        """Shared fetch+decode+reshape block of the client-funnel paths
        (1-d and mesh): pull whole source shards through this client."""
        region = self.regions[name]
        ckpt_region = self._ckpt_region(ckpt_id, name)
        src_parts: Dict[int, np.ndarray] = {}
        for sp in parts:
            payload = self._fetch_decoded(ckpt_region, ckpt_id, sp, stats)
            src_parts[sp] = np.frombuffer(bytearray(payload),
                                          dtype=np.dtype(region.dtype)) \
                .reshape(self._part_shape(region, sp))
        return src_parts

    def _publish_redistribution_done(self, name: str, new_parts: int,
                                     via: str, sim_s: float,
                                     bytes_through_client: int,
                                     stats: Optional[dict] = None,
                                     **extra) -> None:
        """``extra`` carries the zero-stall payload (overlap_sim_s, stall_s,
        overlap_commits, tail_frames, rehydrated, wall/skew) when the
        window ran two-phase."""
        stats = stats or {}
        self.controller.bus.publish(
            E.REDISTRIBUTION_DONE, app=self.app_id, region=name,
            new_parts=new_parts, via=via, sim_s=sim_s,
            bytes_moved=stats.get("bytes_moved", bytes_through_client),
            bytes_through_client=bytes_through_client,
            peer_hops=stats.get("peer_hops", 0),
            cross_reads=stats.get("cross_reads", 0),
            intra_reads=stats.get("intra_reads", 0),
            tier_reads=stats.get("tier_reads", 0), **extra)

    def _try_peer(self, name: str, ckpt_id: int, programs_fn, wanted: set,
                  new_parts: int, part_shape
                  ) -> Optional[Dict[int, np.ndarray]]:
        """Shared peer attempt of both redistribution flavours: compile (or
        look up) the programs and run them agent→agent.  Returns None —
        after publishing ``redistribution_fallback`` — when the client
        funnel must take over (unsupported layout, agent death
        mid-transfer, lost source shard)."""
        ctl = self.controller
        try:
            programs = programs_fn()
            if programs is None or len(programs) <= 1:
                # a single destination part (e.g. gathering onto one
                # replicated box) has no peer concurrency to exploit —
                # assembling it on an agent and re-fetching it would only
                # add a round trip on top of the funnel
                ctl.bus.publish(E.REDISTRIBUTION_FALLBACK, app=self.app_id,
                                region=name,
                                reason="unsupported_layout"
                                if programs is None
                                else "single_destination")
                return None
            return self._peer_redistribute(name, ckpt_id, programs, wanted,
                                           new_parts, part_shape)
        except (ICheckError, ConnectionError, TimeoutError, KeyError) as e:
            ctl.bus.publish(E.REDISTRIBUTION_FALLBACK, app=self.app_id,
                            region=name, reason=repr(e))
            return None

    def _peer_redistribute(self, name: str, ckpt_id: int, programs,
                           wanted: set, new_parts: int,
                           part_shape) -> Dict[int, np.ndarray]:
        """Peer path: agents execute the pre-staged transfer programs among
        themselves; this client only dispatches, then fetches the parts its
        local new ranks own.  The adapt-window time is the engine's analytic
        transfer window plus the (concurrent-across-ranks, so max-per-node)
        fetch of the wanted parts."""
        ctl = self.controller
        region = self._ckpt_region(ckpt_id, name)
        t0 = ctl.clock.now()
        results, stats = ctl.execute_redistribution(self.app_id, region,
                                                    ckpt_id, programs)
        try:
            out: Dict[int, np.ndarray] = {}
            fetch_lane: Dict[str, float] = {}
            bytes_client = 0
            for p in sorted(wanted):
                agent, key, _ = results[p]
                payload = agent.get(key)
                bytes_client += len(payload)
                fetch_lane[agent.node_id] = fetch_lane.get(agent.node_id, 0.0) \
                    + len(payload) / agent.nic.bandwidth + agent.nic.latency
                out[p] = np.frombuffer(bytearray(payload),
                                       dtype=np.dtype(region.dtype)) \
                    .reshape(part_shape(p))
        finally:
            ctl.release_redistribution(results)
        sim_s = stats["sim_s"] + max(fetch_lane.values(), default=0.0)
        ctl.tracer.record("redistribute_peer",
                          trace_id_for(self.app_id, ckpt_id),
                          f"client/{self.app_id}", t0=t0, dur_s=sim_s,
                          region=name, new_parts=new_parts)
        self._publish_redistribution_done(
            name, new_parts, "peer", sim_s, bytes_client, stats,
            wall_sim_s=stats.get("wall_sim_s", 0.0),
            window_skew=stats.get("window_skew", 1.0))
        return out

    def _funnel_1d(self, name: str, new_num_parts: int, wanted: set,
                   ckpt_id: Optional[int] = None) -> Dict[int, np.ndarray]:
        """The legacy gather-through-the-client funnel for 1-d (BLOCK/
        CYCLIC) regions.  ``ckpt_id=None`` resolves the catalog head at call
        time — the overlap fallback path relies on that, because by cutover
        time the head has moved past the base the window streamed."""
        ctl = self.controller
        region = self.regions[name]
        old = region.partition
        new = old.renumbered(new_num_parts)
        moves = ctl.plan_for_resize(self.app_id, name, new_num_parts)
        ckpt_id = self._resolve_redistribution_ckpt(ckpt_id)
        t0 = ctl.clock.now()
        stats = {"wire_bytes": 0}
        sub_moves = [mv for mv in moves if mv.dst in wanted]
        needed_src = sorted({mv.src for mv in sub_moves})
        src_parts = self._fetch_source_parts(name, ckpt_id, needed_src,
                                             stats)
        dst = planlib.apply_moves(src_parts, sub_moves, old, new,
                                  region.shape)
        result = {p: dst[p] for p in wanted}
        ctl.tracer.record("redistribute_funnel",
                          trace_id_for(self.app_id, ckpt_id),
                          f"client/{self.app_id}", t0=t0,
                          dur_s=ctl.clock.now() - t0, region=name,
                          new_parts=new_num_parts)
        self._publish_redistribution_done(name, new_num_parts, "client",
                                          ctl.clock.now() - t0,
                                          stats["wire_bytes"])
        return result

    def _begin_overlap(self, name: str, ckpt_id: int, programs_fn,
                       wanted: set, new_parts: int, part_shape,
                       fallback) -> ResizeCutoverHandle:
        """Open phase 1 of a zero-stall redistribution and wrap it in a
        :class:`ResizeCutoverHandle`.  Unlike the stop-the-world peer path,
        a single-destination program is still worth overlapping — its extra
        round trip hides inside the window instead of stretching it."""
        ctl = self.controller
        region = self._ckpt_region(ckpt_id, name)
        trace_id = trace_id_for(self.app_id, ckpt_id)
        window = None
        try:
            programs = programs_fn()
            if programs is None:
                ctl.bus.publish(E.REDISTRIBUTION_FALLBACK, app=self.app_id,
                                region=name, reason="unsupported_layout")
            else:
                window = ctl.begin_overlap_redistribution(
                    self.app_id, region, ckpt_id, programs)
                ctl.tracer.record("overlap_open", trace_id,
                                  f"client/{self.app_id}", region=name,
                                  new_parts=new_parts)
        except ResizeCutoverHandle._FALLBACK_ERRORS as e:
            ctl.bus.publish(E.REDISTRIBUTION_FALLBACK, app=self.app_id,
                            region=name, reason=repr(e))
        return ResizeCutoverHandle(self, name, window, wanted, new_parts,
                                   part_shape, fallback, trace_id=trace_id)

    def redistribute(self, name: str, new_num_parts: int,
                     ckpt_id: Optional[int] = None,
                     parts_needed: Optional[Sequence[int]] = None,
                     via: str = "peer", overlap: bool = False):
        """icheck_redistribute(): build the *new* distribution's parts from
        the latest checkpoint, moving only the slices each new part needs
        (paper §III-B; BLOCK/CYCLIC preserved, part count changes).

        ``via="peer"`` (default) executes the pre-staged transfer programs
        agent→agent — only the parts in ``parts_needed`` (the local new
        ranks') flow through this client.  ``via="client"`` forces the
        legacy gather-through-the-client funnel, which is also the automatic
        fallback when the peer engine cannot run (unsupported layout, agent
        death mid-transfer, lost source shard).

        ``overlap=True`` (peer only) returns a :class:`ResizeCutoverHandle`
        immediately instead of blocking for the adapt window: the base
        checkpoint streams in the background while the caller keeps
        stepping/committing, and ``handle.cutover()`` later returns the
        wanted parts caught up to the catalog head.
        """
        if via not in ("peer", "client"):
            raise ICheckError(f"unknown redistribution path via={via!r}")
        if overlap and via != "peer":
            raise ICheckError("overlap resize requires via='peer'")
        region = self.regions[name]
        old = region.partition
        if old.scheme == PartitionScheme.MESH:
            raise ICheckError("use redistribute_mesh for mesh regions")
        new = old.renumbered(new_num_parts)
        self.controller.plan_for_resize(self.app_id, name, new_num_parts)
        ckpt_id = self._resolve_redistribution_ckpt(ckpt_id)
        wanted = set(parts_needed) if parts_needed is not None \
            else set(range(new_num_parts))
        ctl = self.controller
        ctl.bus.publish(E.REDISTRIBUTION_STARTED, app=self.app_id,
                        region=name, new_parts=new_num_parts, ckpt=ckpt_id,
                        via=via, overlap=overlap)
        part_shape = lambda p: planlib.local_shape(region.shape, new, p)  # noqa: E731
        programs_fn = lambda: ctl.transfer_programs(self.app_id, name,  # noqa: E731
                                                    new_num_parts)
        if overlap:
            return self._begin_overlap(
                name, ckpt_id, programs_fn, wanted, new_num_parts,
                part_shape,
                fallback=lambda: self._funnel_1d(name, new_num_parts,
                                                 wanted))
        if via == "peer":
            out = self._try_peer(name, ckpt_id, programs_fn, wanted,
                                 new_num_parts, part_shape)
            if out is not None:
                return out
        # client funnel (forced, unsupported layout, or peer failure)
        return self._funnel_1d(name, new_num_parts, wanted, ckpt_id)

    def commit_redistribution(self, name: str, new_num_parts: int) -> None:
        """MPI_Comm_adapt_commit side-effect: region now has the new mapping.

        Registers a *new* RegionMeta (the registry may alias the
        controller's copy — mutating in place would hide the partition
        change from the catalog's mandatory delta-chain reset and from the
        resize planner's plan/program cache invalidation)."""
        old = self.regions[name]
        region = dataclasses.replace(
            old, partition=old.partition.renumbered(new_num_parts))
        self.regions[name] = region
        self.controller.register_region(self.app_id, region)

    def _funnel_mesh(self, name: str, new_boxes: tuple, wanted: set,
                     ckpt_id: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Client funnel for mesh regions (``ckpt_id=None`` = catalog head
        at call time, see :meth:`_funnel_1d`)."""
        ctl = self.controller
        region = self.regions[name]
        moves = planlib.mesh_moves(region.partition.bounds, new_boxes)
        ckpt_id = self._resolve_redistribution_ckpt(ckpt_id)
        t0 = ctl.clock.now()
        stats = {"wire_bytes": 0}
        sub_moves = [mv for mv in moves if mv.dst in wanted]
        needed_src = sorted({mv.src for mv in sub_moves})
        src_parts = self._fetch_source_parts(name, ckpt_id, needed_src,
                                             stats)
        dst = planlib.apply_mesh_moves(src_parts, sub_moves, new_boxes,
                                       np.dtype(region.dtype))
        result = {p: dst[p] for p in wanted}
        ctl.tracer.record("redistribute_funnel",
                          trace_id_for(self.app_id, ckpt_id),
                          f"client/{self.app_id}", t0=t0,
                          dur_s=ctl.clock.now() - t0, region=name,
                          new_parts=len(new_boxes))
        self._publish_redistribution_done(name, len(new_boxes), "client",
                                          ctl.clock.now() - t0,
                                          stats["wire_bytes"])
        return result

    def redistribute_mesh(self, name: str, new_boxes: Sequence[planlib.Box],
                          ckpt_id: Optional[int] = None,
                          parts_needed: Optional[Sequence[int]] = None,
                          via: str = "peer", overlap: bool = False):
        """Mesh-sharded (JAX) variant: old boxes from the region registry,
        new boxes from the target sharding.  Same peer-first execution as
        :meth:`redistribute` — pass ``parts_needed`` (the local new ranks'
        shard indices) so only those parts flow through this client; mesh
        programs are compiled at adapt time because only the application
        knows the new mesh's boxes.  ``overlap=True`` returns a
        :class:`ResizeCutoverHandle` (see :meth:`redistribute`)."""
        if via not in ("peer", "client"):
            raise ICheckError(f"unknown redistribution path via={via!r}")
        if overlap and via != "peer":
            raise ICheckError("overlap resize requires via='peer'")
        region = self.regions[name]
        if region.partition.scheme != PartitionScheme.MESH:
            raise ICheckError(f"{name} is not a mesh region")
        old_boxes = region.partition.bounds
        new_boxes = tuple(new_boxes)
        ckpt_id = self._resolve_redistribution_ckpt(ckpt_id)
        wanted = set(parts_needed) if parts_needed is not None \
            else set(range(len(new_boxes)))
        ctl = self.controller
        ctl.bus.publish(E.REDISTRIBUTION_STARTED, app=self.app_id,
                        region=name, new_parts=len(new_boxes), ckpt=ckpt_id,
                        via=via, overlap=overlap)
        part_shape = lambda p: tuple(hi - lo for lo, hi in new_boxes[p])  # noqa: E731
        programs_fn = lambda: planlib.compile_mesh_transfer_programs(  # noqa: E731
            old_boxes, new_boxes)
        if overlap:
            return self._begin_overlap(
                name, ckpt_id, programs_fn, wanted, len(new_boxes),
                part_shape,
                fallback=lambda: self._funnel_mesh(name, new_boxes, wanted))
        if via == "peer":
            out = self._try_peer(name, ckpt_id, programs_fn, wanted,
                                 len(new_boxes), part_shape)
            if out is not None:
                return out
        return self._funnel_mesh(name, new_boxes, wanted, ckpt_id)

    # ---------------------------------------------------------- probe_agents
    def probe_agents(self) -> List[Agent]:
        """icheck_probe_agents(): let the controller re-tune our agent set."""
        self.agents = self.controller.probe_agents(self.app_id,
                                                   self._last_commit_sim_s)
        return self.agents
