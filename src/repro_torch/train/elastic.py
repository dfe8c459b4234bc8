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

A "rank" is a data-parallel slice of a ``DeviceMesh`` over the process
world (``sharding.make_mesh``, the counterpart of the reference's
``default_make_mesh``).  Every rank of the world runs the trainer: the
TrainState is replicated over the mesh's "data" axis, each rank takes its
slice of the global batch, and the step all-reduces the gradients
(``step.py``).  The RM, the app and the iCheck client live in rank 0, as
the reference's single controller holds them: rank 0 probes for resizes
and decides when to commit, and each step broadcasts both decisions to
every rank.  A commit snapshots the state as DTensors of the mesh
(``core/snapshot.py``: with replicated leaves rank 0 holds every box, so
nothing is gathered); a resize commits, makes the new mesh, and rank 0
pulls from the agents the boxes of the new mesh's ``NamedSharding(mesh,
P())`` and sends each rank of the new mesh its box.  A rank outside the
mesh holds no state and waits at the broadcasts; a resize that takes it
in gives it the state, a resize that leaves it out frees its state.

Without an initialised process group the trainer runs on one device with
logical ranks, as the reference's ``default_make_mesh`` does on one
device (``repro/train/elastic.py:49-53``): every rank's box is the whole
array, so a resize moves the state through the agents and back into the
same tensors.  The state is updated in place throughout (train step,
restart, resize), so the device never holds two copies of it.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig, ShapeConfig
from ..core import ICheckClient, ICheckCluster, MalleableApp
from ..core import events as icheck_events
from ..core import plan as planlib
from ..core.snapshot import (_flatten, _leaf_name, _unflatten,
                             describe_pytree, load_leaf_, snapshot_pytree)
from ..core.types import PartitionDesc, PartitionScheme
from ..data import SyntheticLMData
from ..optim import AdamWConfig, warmup_cosine
from ..sharding import NamedSharding, P, get_rules, use_rules
from ..sharding import mesh as meshlib
from .state import make_train_state
from .step import make_train_step

DATA_REGION = "data_state"


class ElasticTrainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 cluster: Optional[ICheckCluster], app_id: str = "train",
                 ranks: int = 1, seed: int = 0,
                 opt_cfg: Optional[AdamWConfig] = None,
                 commit_every: int = 10, probe_every: int = 100,
                 global_batch: Optional[int] = None,
                 make_mesh: Optional[Callable] = None, codec: str = "raw",
                 replication: int = 1, total_steps: int = 1000,
                 adaptive_interval: bool = False, step_sim_s: float = 0.0,
                 overlap_resize: bool = False, device="cuda"):
        """``cluster`` is rank 0's (other ranks of a process world pass
        None).  ``make_mesh(ranks)`` makes the mesh of a rank count
        (default ``sharding.make_mesh`` under a process group)."""
        self.cfg = cfg
        self.shape = shape
        self.device = torch.device(device)
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.world = dist.get_world_size() if self.distributed else 1
        self.is_root = self.rank == 0
        if self.distributed and \
                self.device.type != meshlib.world_device_type():
            raise ValueError(f"state on {self.device} under a "
                             f"{dist.get_backend()} world")
        self.make_mesh = make_mesh or (
            meshlib.make_mesh if self.distributed else (lambda n: None))
        self.rules = get_rules(cfg.rules)
        self.codec = codec
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
        # and keep training while the base checkpoint streams (the handles
        # are rank 0's, the new mesh and its boxes every rank's)
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
        self.interval_changes = 0
        self.ckpt_events: list = []
        self.app = self.client = self._clock = None
        self._unsubscribe = lambda: None
        if self.is_root:
            self._init_controller(cluster, app_id, ranks, codec, replication)

        self.mesh = self.make_mesh(ranks)
        # the state's structure, shapes and dtypes, allocating nothing: a
        # rank that joins the mesh allocates its state from it
        self._template = make_train_state(cfg, None, self.opt_cfg, "meta")
        self.state = None
        if self._in_mesh():
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.state = make_train_state(cfg, gen, self.opt_cfg, self.device)
        self._make_step()

        # icheck_init + add_adapt + (maybe) restart -- paper lines 5..9
        if self.is_root:
            est = sum(t.numel() * t.element_size()
                      for _, t in _flatten(self.state))
            self.client.init(ckpt_bytes_estimate=int(est))
            self._register_regions()
        self.restarted = self.restart_if_available()

    def _init_controller(self, cluster, app_id, ranks, codec, replication):
        """Rank 0's half: the app, the iCheck client, the cadence clock
        and the event subscription."""
        self.app = MalleableApp(app_id, cluster.rm, ranks)
        self.proc_type = self.app.init_adapt()
        self.client = ICheckClient(app_id, cluster.controller, ranks=ranks,
                                   codec=codec, replication=replication)
        self._clock = cluster.controller.clock
        if self.adaptive_interval and self.step_sim_s <= 0 \
                and self._clock.time_scale == 0:
            # nothing would advance the cadence clock between commits: the
            # trainer would never checkpoint
            raise ValueError(
                "adaptive_interval=True needs step_sim_s > 0 (or a cluster "
                "with time_scale > 0) so sim time advances between steps")
        self._last_commit_t = self._clock.now()
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

    def _on_ckpt_event(self, ev) -> None:
        self.ckpt_events.append(ev.as_record())
        if ev.name == icheck_events.INTERVAL_CHANGED \
                and ev.payload.get("app") == self.client.app_id:
            # the client has already taken the new ``ckpt_interval_s``
            self.interval_changes += 1

    # ------------------------------------------------------------ the world
    def _in_mesh(self, mesh=None) -> bool:
        mesh = self.mesh if mesh is None else mesh
        return mesh is None or mesh.get_coordinate() is not None

    def _bcast(self, obj):
        """Rank 0's ``obj`` on every rank of the world."""
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _make_step(self) -> None:
        group = None if self.mesh is None or not self._in_mesh() \
            else self.mesh.get_group(0)
        self._step = make_train_step(self.cfg, self.opt_cfg, self.schedule,
                                     group=group)

    def _sharded(self, mesh=None):
        """The state's leaves as DTensors replicated over ``mesh``'s (by
        default the trainer's) "data" axis, views of the same tensors; the
        state itself on one device."""
        mesh = self.mesh if mesh is None else mesh
        if mesh is None:
            return self.state
        from torch.distributed.tensor import DTensor, Replicate

        return _unflatten(self.state, lambda name, t: DTensor.from_local(
            t, mesh, [Replicate()], run_check=False))

    def _commit_due(self, step: int) -> bool:
        if self.adaptive_interval:
            return (self._clock.now() - self._last_commit_t
                    >= self.client.ckpt_interval_s)
        return self.commit_every > 0 and step % self.commit_every == 0

    def _register_regions(self):
        self.client.add_adapt_snapshot(
            describe_pytree(self._sharded(), step=int(self.state.step)))
        self.client.add_adapt(DATA_REGION, (2,), "int64", num_parts=1)

    # ----------------------------------------------------------- checkpoints
    def commit(self, blocking: bool = False):
        """icheck_commit: snapshot -> agents (paper line 26).  Every rank
        of the mesh calls it; the commit is rank 0's, which returns its
        handle (the others None).

        With a q8 codec the snapshot quantizes on the device (q8-delta: XOR
        against the catalog's previous codes) before the copy to the host,
        and ``commit_snapshot`` ships those frames as they are."""
        step = int(self.state.step)
        codec = self.codec
        if codec in ("q8", "q8-delta"):
            snap = snapshot_pytree(
                self._sharded(), step=step, codec=codec,
                chain_lookup=self.client.delta_chain_lookup
                if self.is_root else None)
        else:
            snap = snapshot_pytree(self._sharded(), step=step)
        if not self.is_root:
            return None
        data_parts = {DATA_REGION: {0: self.data.state_array()}}
        if codec in ("q8", "q8-delta"):
            h = self.client.commit_snapshot(snap, extra_parts=data_parts,
                                            blocking=blocking)
        else:
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
        into the live tensors leaf by leaf (rank 0 sends the others their
        boxes)."""
        found = self.client.restart() if self.is_root else None
        if not self._bcast(found is not None):
            return False
        regions = region_meta = None
        data_state = None
        if self.is_root:
            meta, regions, level = found
            data_state = regions.pop(DATA_REGION)[0]
            region_meta = {name: meta.regions[name] for name in regions}
        self.data.restore(self._bcast(data_state))
        if self._in_mesh():
            for path, leaf in _flatten(self._sharded()):
                name = _leaf_name(path)
                load_leaf_(name, leaf,
                           region_meta[name] if self.is_root else None,
                           regions.pop(name) if self.is_root else None)
        return True

    # ---------------------------------------------------------------- resize
    def _new_boxes(self, new_mesh) -> Dict[str, tuple]:
        """Each leaf's boxes on ``new_mesh``, DP-replicated: one box, the
        whole leaf (``repro/train/elastic.py:222-238``)."""
        rep = NamedSharding(new_mesh, P())
        return {_leaf_name(path): planlib.mesh_part_bounds(leaf.shape, rep)
                for path, leaf in _flatten(self._template)}

    def _load_parts(self, parts_of: Callable[[str], Dict[int, np.ndarray]],
                    boxes: Dict[str, tuple], new_mesh) -> None:
        """Write every leaf's redistributed parts, placed by their new
        boxes, into the state on ``new_mesh``, one leaf at a time: rank 0
        fetches them (``parts_of``) and sends each rank its box.  A rank
        that joins allocates its state first; one that leaves frees it."""
        if not self._in_mesh(new_mesh):
            self.state = None
            return
        if self.state is None:
            self.state = _unflatten(
                self._template, lambda name, t: torch.empty(
                    t.shape, dtype=t.dtype, device=self.device))
        for path, leaf in _flatten(self._sharded(mesh=new_mesh)):
            name = _leaf_name(path)
            meta = parts = None
            if self.is_root:
                meta = dataclasses.replace(
                    self.client.regions[name],
                    partition=PartitionDesc(
                        scheme=PartitionScheme.MESH,
                        num_parts=len(boxes[name]),
                        bounds=tuple(boxes[name])))
                parts = parts_of(name)
            load_leaf_(name, leaf, meta, parts)

    def _switch_mesh(self, new_mesh, new_ranks: int) -> None:
        """After the parts have landed: the new mesh, its step, the data
        iterator's state on every rank, and rank 0's bookkeeping."""
        self.mesh = new_mesh
        self._make_step()
        if self.world > 1:
            self.data.restore(self._bcast(
                self.data.state_array() if self.is_root else None))
        if self.is_root:
            self.app.adapt_commit()
            self.client.ranks = new_ranks
        self.resizes += 1

    def _redistribute(self, new_ranks: int):
        """Agent-side slice redistribution onto the new ranks (paper
        SSIII-B): commit (blocking) first, then pull the slices each new
        part needs from the agents."""
        if self.state is not None:
            self.commit(blocking=True)
        new_mesh = self.make_mesh(new_ranks)
        boxes = self._new_boxes(new_mesh)
        self._load_parts(
            lambda name: self.client.redistribute_mesh(name, boxes[name]),
            boxes, new_mesh)
        self._switch_mesh(new_mesh, new_ranks)

    def _begin_overlap_adapt(self, new_ranks: int) -> None:
        """Phase 1: commit a base checkpoint, then open one overlap window
        per TrainState leaf; training continues on the old ranks while the
        streams run."""
        if self.state is not None:
            self.commit(blocking=True)
        new_mesh = self.make_mesh(new_ranks)
        boxes = self._new_boxes(new_mesh)
        if self.is_root:
            self._adapt_handles = {
                name: self.client.redistribute_mesh(name, b, overlap=True)
                for name, b in boxes.items()}
        self._adapt_ctx = {"new_mesh": new_mesh, "boxes": boxes,
                           "new_ranks": new_ranks}

    def _finish_overlap_adapt(self) -> None:
        """Phase 2: quiesce (one last commit, the only frames the cutover
        still replays), switch partitions, load the caught-up parts."""
        ctx = self._adapt_ctx
        new_ranks = ctx["new_ranks"]
        if self.is_root:
            new_ranks = self.app.adapt_begin().new_ranks
        if self.state is not None:
            self.commit(blocking=True)
        self._load_parts(lambda name: self._adapt_handles[name].cutover(),
                         ctx["boxes"], ctx["new_mesh"])
        self._switch_mesh(ctx["new_mesh"], new_ranks)
        self._adapt_handles = None
        self._adapt_ctx = None

    def wait_resize_streams(self, timeout: Optional[float] = None) -> bool:
        """Block until every background stream of an open overlap resize
        has landed (True) or ``timeout`` seconds pass (False); True at once
        when no overlap window is open.  The resize itself completes at the
        next step's ``maybe_adapt``.  Rank 0's."""
        if self._adapt_handles is None:
            return True
        deadline = None if timeout is None else time.monotonic() + timeout
        for h in self._adapt_handles.values():
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if not h.wait(left):
                return False
        return True

    def _adapt_decision(self):
        """Rank 0's probe: ("resize", n), ("begin", n), ("finish",) or
        None."""
        if self._adapt_handles is not None:
            if all(h.ready() for h in self._adapt_handles.values()):
                return ("finish",)
            return None
        ev = self.app.probe_adapt()
        if ev is None:
            return None
        if self.overlap_resize:
            return ("begin", ev.new_ranks)
        return ("resize", self.app.adapt_begin().new_ranks)

    def maybe_adapt(self) -> bool:
        """MPI_Probe_adapt + adapt window (paper lines 17-23); two-phase
        with ``overlap_resize``.  Every rank of the world calls it: rank
        0 probes and the others follow."""
        decision = self._bcast(self._adapt_decision() if self.is_root
                               else None)
        if decision is None:
            return False
        if decision[0] == "begin":
            self._begin_overlap_adapt(decision[1])
            return False
        if decision[0] == "finish":
            self._finish_overlap_adapt()
        else:
            self._redistribute(decision[1])
        return True

    # ------------------------------------------------------------------ run
    def _device_batch(self) -> Dict[str, torch.Tensor]:
        """This rank's slice of the step's global batch."""
        hosts, host_id = 1, 0
        if self.mesh is not None:
            hosts, host_id = self.mesh.size(), self.mesh.get_local_rank(0)
        batch = self.data.next_batch(self.global_batch, hosts=hosts,
                                     host_id=host_id)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def run(self, steps: int) -> Dict:
        t0 = time.monotonic()
        for _ in range(steps):
            self.maybe_adapt()
            step = None
            if self.state is not None:
                batch = self._device_batch()
                with use_rules(self.mesh, self.rules):
                    self.state, metrics = self._step(self.state, batch)
                step = int(self.state.step)
                if self._adapt_ctx is not None:
                    self.steps_during_resize += 1
                self.metrics_log.append(
                    {"step": step, "loss": float(metrics["loss"])})
            else:
                self.data.state.step += 1      # the batch the mesh took
            due = None
            if self.is_root:
                if self.step_sim_s > 0:
                    self._clock.sleep(self.step_sim_s)
                due = self._commit_due(step)
            if self._bcast(due) and self.state is not None:
                self.commit()
            if self.is_root and self.probe_every \
                    and step % self.probe_every == 0:
                self.client.probe_agents()
        out = {"steps": steps, "wall_s": time.monotonic() - t0,
               "final_loss": self.metrics_log[-1]["loss"]
               if self.metrics_log else None,
               "resizes": self.resizes,
               "steps_during_resize": self.steps_during_resize}
        if self.is_root:
            out.update(interval_changes=self.interval_changes,
                       ckpt_interval_s=self.client.ckpt_interval_s)
        return out

    def finalize(self):
        if not self.is_root:
            return
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
