"""ElasticTrainer: paper Listing 1 driven over a PyTorch TrainState, the
twin of ``repro/train/elastic.py``.

Control flow is the paper's malleable-app skeleton:

    MPI_Init_adapt            -> MalleableApp.init_adapt
    icheck_init               -> ICheckClient.init
    icheck_add_adapt          -> add_adapt_snapshot (every TrainState leaf +
                                 data-iterator state become iCheck regions)
    icheck_restart            -> restart()  (fresh start if no checkpoint)
    loop:
        MPI_Probe_adapt       -> probe_adapt
        [MPI_Comm_adapt_begin -> adapt_begin
         icheck_redistribute  -> redistribute_mesh per region
         MPI_Comm_adapt_commit-> adapt_commit]
        train_step
        icheck_commit         -> commit (non-blocking, async agents)
        icheck_probe_agents   -> probe_agents

Ranks are logical on one device, as the reference's ``default_make_mesh``
makes them on one device (``repro/train/elastic.py:49-53``): every rank's
box is the whole array, so a resize moves the state through the agents
and back into the same tensors.  The state is updated in place
throughout (train step, restart, resize), so the device never holds two
copies of it.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core import ICheckClient, ICheckCluster, MalleableApp
from ..core import events as icheck_events
from ..core import plan as planlib
from ..core.snapshot import (_flatten, _leaf_name, describe_pytree,
                             load_leaf_, load_pytree_, snapshot_pytree)
from ..core.types import PartitionDesc, PartitionScheme
from ..data import SyntheticLMData
from ..optim import AdamWConfig, warmup_cosine
from .state import make_train_state
from .step import make_train_step

DATA_REGION = "data_state"


class _WholeBox:
    """A sharding that places the whole array on the one device (what
    ``plan.mesh_part_bounds`` reads, ``core/plan.py:216``)."""

    def devices_indices_map(self, shape):
        return {0: tuple(slice(None) for _ in shape)}


class LogicalMesh:
    """``ranks`` logical data-parallel ranks on one device."""

    def __init__(self, ranks: int):
        self.ranks = ranks

    def replicated(self) -> _WholeBox:
        return _WholeBox()


class ElasticTrainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 cluster: ICheckCluster, app_id: str = "train",
                 ranks: int = 1, seed: int = 0,
                 opt_cfg: Optional[AdamWConfig] = None,
                 commit_every: int = 10, probe_every: int = 100,
                 global_batch: Optional[int] = None, codec: str = "raw",
                 replication: int = 1, total_steps: int = 1000,
                 adaptive_interval: bool = False, step_sim_s: float = 0.0,
                 overlap_resize: bool = False, device="cuda"):
        self.cfg = cfg
        self.shape = shape
        self.device = torch.device(device)
        self.app = MalleableApp(app_id, cluster.rm, ranks)
        self.proc_type = self.app.init_adapt()
        self.client = ICheckClient(app_id, cluster.controller, ranks=ranks,
                                   codec=codec, replication=replication)
        self.mesh = LogicalMesh(ranks)
        self.commit_every = commit_every
        self.probe_every = probe_every
        self.global_batch = global_batch or shape.global_batch
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.schedule = warmup_cosine(self.opt_cfg.lr, warmup=20,
                                      total=total_steps)
        self.data = SyntheticLMData(cfg, shape, seed=seed)
        self.metrics_log: list = []
        self.resizes = 0
        self._pending_commits: list = []
        # zero-stall resize: on a resize, open overlap windows per region
        # and keep training while the base checkpoint streams
        self.overlap_resize = overlap_resize
        self._adapt_handles: Optional[Dict[str, object]] = None
        self._adapt_ctx: Optional[dict] = None
        self.steps_during_resize = 0
        # adaptive checkpoint pacing: commits follow the client's solved
        # ``ckpt_interval_s`` (re-announced by INTERVAL_CHANGED events) on
        # the cluster's sim clock instead of ``commit_every``; each step
        # advances that clock by ``step_sim_s``
        self.adaptive_interval = adaptive_interval
        self.step_sim_s = float(step_sim_s)
        self._clock = cluster.controller.clock
        if adaptive_interval and self.step_sim_s <= 0 \
                and self._clock.time_scale == 0:
            # nothing would advance the cadence clock between commits: the
            # trainer would never checkpoint
            raise ValueError(
                "adaptive_interval=True needs step_sim_s > 0 (or a cluster "
                "with time_scale > 0) so sim time advances between steps")
        self._last_commit_t = self._clock.now()
        self.interval_changes = 0
        self.ckpt_events: list = []
        # the bus holds the trainer weakly: a trainer dropped without
        # ``finalize`` (a crash) releases its state, and its subscription
        # goes with it
        handler = weakref.WeakMethod(self._on_ckpt_event)

        def on_event(ev) -> None:
            h = handler()
            if h is not None:
                h(ev)

        self._unsubscribe = weakref.finalize(
            self, cluster.controller.bus.subscribe(
                on_event,
                events=(icheck_events.CKPT_IN_L1, icheck_events.CKPT_IN_L2,
                        icheck_events.DRAIN_FAILED,
                        icheck_events.CODEC_DEGRADED,
                        icheck_events.RESIZE_FOREWARNED,
                        icheck_events.INTERVAL_CHANGED)))

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = make_train_state(cfg, gen, self.opt_cfg, self.device)
        self._step = make_train_step(cfg, self.opt_cfg, self.schedule)

        # icheck_init + add_adapt + (maybe) restart -- paper lines 5..9
        est = sum(t.numel() * t.element_size()
                  for _, t in _flatten(self.state))
        self.client.init(ckpt_bytes_estimate=int(est))
        self._register_regions()
        self.restarted = self.restart_if_available()

    def _on_ckpt_event(self, ev) -> None:
        self.ckpt_events.append(ev.as_record())
        if ev.name == icheck_events.INTERVAL_CHANGED \
                and ev.payload.get("app") == self.client.app_id:
            # the client has already taken the new ``ckpt_interval_s``
            self.interval_changes += 1

    def _commit_due(self, step: int) -> bool:
        if self.adaptive_interval:
            return (self._clock.now() - self._last_commit_t
                    >= self.client.ckpt_interval_s)
        return self.commit_every > 0 and step % self.commit_every == 0

    def _register_regions(self):
        self.client.add_adapt_snapshot(
            describe_pytree(self.state, step=int(self.state.step)))
        self.client.add_adapt(DATA_REGION, (2,), "int64", num_parts=1)

    # ----------------------------------------------------------- checkpoints
    def commit(self, blocking: bool = False):
        """icheck_commit: snapshot -> agents (paper line 26).

        With a q8 codec the snapshot quantizes on the device (q8-delta: XOR
        against the catalog's previous codes) before the copy to the host,
        and ``commit_snapshot`` ships those frames as they are."""
        step = int(self.state.step)
        data_parts = {DATA_REGION: {0: self.data.state_array()}}
        if self.client.codec in ("q8", "q8-delta"):
            snap = snapshot_pytree(self.state, step=step,
                                   codec=self.client.codec,
                                   chain_lookup=self.client.delta_chain_lookup)
            h = self.client.commit_snapshot(snap, extra_parts=data_parts,
                                            blocking=blocking)
        else:
            snap = snapshot_pytree(self.state, step=step)
            self.client.add_adapt_snapshot(snap)   # refresh region boxes
            parts = {name: r.parts for name, r in snap.regions.items()}
            parts.update(data_parts)
            h = self.client.commit(step, parts, blocking=blocking)
        # a finished handle still holds its commit's wire frames: keep
        # only the unfinished ones (the ones ``finalize`` waits for)
        self._pending_commits = [c for c in self._pending_commits
                                 if not c.done()]
        self._pending_commits.append(h)
        self._last_commit_t = self._clock.now()
        return h

    def restart_if_available(self) -> bool:
        """icheck_restart: newest complete checkpoint -> TrainState, copied
        into the live tensors leaf by leaf."""
        found = self.client.restart()
        if found is None:
            return False
        meta, regions, level = found
        data_parts = regions.pop(DATA_REGION)
        self.data.restore(data_parts[0])
        region_meta = {name: meta.regions[name] for name in regions}
        load_pytree_(self.state, regions, region_meta)
        return True

    # ---------------------------------------------------------------- resize
    def _new_boxes(self, new_mesh: LogicalMesh) -> Dict[str, tuple]:
        rep = new_mesh.replicated()
        return {_leaf_name(path): planlib.mesh_part_bounds(leaf.shape, rep)
                for path, leaf in _flatten(self.state)}

    def _load_parts(self, parts_of: Callable[[str], Dict[int, np.ndarray]],
                    boxes: Dict[str, tuple]) -> None:
        """Write every leaf's redistributed parts, placed by their new
        boxes, into the live state, one leaf at a time."""
        for path, leaf in _flatten(self.state):
            name = _leaf_name(path)
            meta = dataclasses.replace(
                self.client.regions[name],
                partition=PartitionDesc(scheme=PartitionScheme.MESH,
                                        num_parts=len(boxes[name]),
                                        bounds=tuple(boxes[name])))
            load_leaf_(name, leaf, meta, parts_of(name))

    def _redistribute(self, new_ranks: int):
        """Agent-side slice redistribution onto the new ranks (paper
        SSIII-B): commit (blocking) first, then pull the slices each new
        part needs from the agents."""
        self.commit(blocking=True)
        new_mesh = LogicalMesh(new_ranks)
        boxes = self._new_boxes(new_mesh)
        self._load_parts(
            lambda name: self.client.redistribute_mesh(name, boxes[name]),
            boxes)
        self.mesh = new_mesh

    def _begin_overlap_adapt(self, new_ranks: int) -> None:
        """Phase 1: commit a base checkpoint, then open one overlap window
        per TrainState leaf; training continues on the old ranks while the
        streams run."""
        self.commit(blocking=True)
        new_mesh = LogicalMesh(new_ranks)
        boxes = self._new_boxes(new_mesh)
        self._adapt_handles = {
            name: self.client.redistribute_mesh(name, b, overlap=True)
            for name, b in boxes.items()}
        self._adapt_ctx = {"new_mesh": new_mesh, "boxes": boxes}

    def _finish_overlap_adapt(self) -> None:
        """Phase 2: quiesce (one last commit, the only frames the cutover
        still replays), switch partitions, load the caught-up parts."""
        ctx = self._adapt_ctx
        window = self.app.adapt_begin()
        self.commit(blocking=True)
        self._load_parts(lambda name: self._adapt_handles[name].cutover(),
                         ctx["boxes"])
        self.mesh = ctx["new_mesh"]
        self.app.adapt_commit()
        self.client.ranks = window.new_ranks
        self.resizes += 1
        self._adapt_handles = None
        self._adapt_ctx = None

    def wait_resize_streams(self, timeout: Optional[float] = None) -> bool:
        """Block until every background stream of an open overlap resize
        has landed (True) or ``timeout`` seconds pass (False); True at once
        when no overlap window is open.  The resize itself completes at the
        next step's ``maybe_adapt``."""
        if self._adapt_handles is None:
            return True
        deadline = None if timeout is None else time.monotonic() + timeout
        for h in self._adapt_handles.values():
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if not h.wait(left):
                return False
        return True

    def maybe_adapt(self) -> bool:
        """MPI_Probe_adapt + adapt window (paper lines 17-23); two-phase
        with ``overlap_resize``."""
        if self._adapt_handles is not None:
            if all(h.ready() for h in self._adapt_handles.values()):
                self._finish_overlap_adapt()
                return True
            return False
        ev = self.app.probe_adapt()
        if ev is None:
            return False
        if self.overlap_resize:
            self._begin_overlap_adapt(ev.new_ranks)
            return False
        window = self.app.adapt_begin()
        self._redistribute(window.new_ranks)
        self.app.adapt_commit()
        self.client.ranks = window.new_ranks
        self.resizes += 1
        return True

    # ------------------------------------------------------------------ run
    def _device_batch(self) -> Dict[str, torch.Tensor]:
        batch = self.data.next_batch(self.global_batch)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def run(self, steps: int) -> Dict:
        t0 = time.monotonic()
        for _ in range(steps):
            self.maybe_adapt()
            batch = self._device_batch()
            self.state, metrics = self._step(self.state, batch)
            step = int(self.state.step)
            if self._adapt_handles is not None:
                self.steps_during_resize += 1
            self.metrics_log.append(
                {"step": step, "loss": float(metrics["loss"])})
            if self.step_sim_s > 0:
                self._clock.sleep(self.step_sim_s)
            if self._commit_due(step):
                self.commit()
            if self.probe_every and step % self.probe_every == 0:
                self.client.probe_agents()
        return {"steps": steps, "wall_s": time.monotonic() - t0,
                "final_loss": self.metrics_log[-1]["loss"],
                "resizes": self.resizes,
                "steps_during_resize": self.steps_during_resize,
                "interval_changes": self.interval_changes,
                "ckpt_interval_s": self.client.ckpt_interval_s}

    def finalize(self):
        if self._adapt_handles is not None:
            for h in self._adapt_handles.values():
                h.cancel()
            self._adapt_handles = None
            self._adapt_ctx = None
        for h in self._pending_commits:
            if not h.done():
                h.wait(timeout=60)
        self.client.finalize()
        self._unsubscribe()
