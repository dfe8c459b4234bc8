"""Malleable resource manager (the paper's extended-Slurm analogue, §III-A).

Supports the four interactions of the iCheck-aware scheduling plugin:
  1. RM can *give* nodes to iCheck on request ("when iCheck runs out of
     memory in a node, the controller can request more memory and get
     additional nodes").
  2. RM can *retake* nodes from iCheck (priority jobs / power corridors).
  3. RM can ask the controller to *migrate* resources to another iCheck node.
  4. RM can pass *application-specific information* to the controller —
     forewarning of an impending resource change so agents can pre-stage
     data redistribution.

It also drives application malleability itself: ``schedule_resize`` queues a
rank-count change that the application observes via ``probe_adapt`` (the
``MPI_Probe_adapt`` analogue in core/malleable.py).
"""
from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, Optional

from .types import AppId, NodeId, NodeSpec


class ResizeEvent:
    def __init__(self, app_id: AppId, new_ranks: int, reason: str = "rm"):
        self.app_id = app_id
        self.new_ranks = new_ranks
        self.reason = reason

    def __repr__(self) -> str:
        return f"ResizeEvent({self.app_id} -> {self.new_ranks} ranks, {self.reason})"


class ResourceManager:
    def __init__(self, free_nodes: Optional[List[NodeSpec]] = None):
        self._lock = threading.Lock()
        self._free: List[NodeSpec] = list(free_nodes or [])
        self._icheck_nodes: Dict[NodeId, NodeSpec] = {}
        self._app_ranks: Dict[AppId, int] = {}
        self._pending_resize: Dict[AppId, ResizeEvent] = {}
        self._seq = itertools.count()
        # callbacks into the iCheck controller (the "plugin" interface)
        self.on_retake: Optional[Callable[[NodeId], None]] = None
        self.on_migrate: Optional[Callable[[NodeId, NodeId], None]] = None
        self.on_app_info: Optional[Callable[[AppId, dict], None]] = None
        # controller epoch fence (set by the controller).  Mutating calls
        # carry the caller's epoch; a zombie controller from before a
        # recovery must not move nodes or queue resizes.
        self.fence = None

    def _check_epoch(self, epoch, what: str) -> None:
        if self.fence is not None and epoch is not None:
            self.fence.check(epoch, what)

    # ------------------------------------------------------------- node pool
    def add_free_node(self, spec: NodeSpec) -> None:
        with self._lock:
            self._free.append(spec)

    def make_node(self, memory_bytes: int = 64 << 30, nic_bandwidth: float = 25e9) -> NodeSpec:
        with self._lock:
            spec = NodeSpec(node_id=f"icn{next(self._seq)}",
                            memory_bytes=memory_bytes, nic_bandwidth=nic_bandwidth)
            self._free.append(spec)
            return spec

    def free_node_count(self) -> int:
        with self._lock:
            return len(self._free)

    # ---------------------------------------------------- interaction 1: give
    def request_icheck_node(self, *, epoch=None) -> Optional[NodeSpec]:
        """Controller asks for one more iCheck node; None if unavailable."""
        self._check_epoch(epoch, "request_icheck_node")
        with self._lock:
            if not self._free:
                return None
            spec = self._free.pop(0)
            self._icheck_nodes[spec.node_id] = spec
            return spec

    # -------------------------------------------------- interaction 2: retake
    def retake_icheck_node(self, node_id: NodeId, *, epoch=None) -> bool:
        """RM pulls a node back (e.g. priority job).  The controller is told
        first so it can migrate shards off the node."""
        self._check_epoch(epoch, "retake_icheck_node")
        with self._lock:
            spec = self._icheck_nodes.get(node_id)
        if spec is None:
            return False
        if self.on_retake is not None:
            self.on_retake(node_id)           # controller migrates + releases
        with self._lock:
            self._icheck_nodes.pop(node_id, None)
            self._free.append(spec)
        return True

    def release_icheck_node(self, node_id: NodeId, *, epoch=None) -> None:
        """Controller voluntarily returns a node."""
        self._check_epoch(epoch, "release_icheck_node")
        with self._lock:
            spec = self._icheck_nodes.pop(node_id, None)
            if spec is not None:
                self._free.append(spec)

    # ------------------------------------------------- interaction 3: migrate
    def request_migration(self, src: NodeId, dst: NodeId) -> None:
        if self.on_migrate is not None:
            self.on_migrate(src, dst)

    # ------------------------------------------------ interaction 4: app info
    def register_app(self, app_id: AppId, ranks: int, *, epoch=None) -> None:
        self._check_epoch(epoch, "register_app")
        with self._lock:
            self._app_ranks[app_id] = ranks

    def schedule_resize(self, app_id: AppId, new_ranks: int,
                        reason: str = "rm", *, epoch=None) -> None:
        """Queue a malleability event for the app AND forewarn iCheck
        (paper: "inform the controller about an impending resource change of
        an application so that agents can prepare ... ahead of time")."""
        self._check_epoch(epoch, "schedule_resize")
        ev = ResizeEvent(app_id, new_ranks, reason)
        with self._lock:
            self._pending_resize[app_id] = ev
        if self.on_app_info is not None:
            self.on_app_info(app_id, {"event": "impending_resize",
                                      "new_ranks": new_ranks, "reason": reason})

    def probe_resize(self, app_id: AppId) -> Optional[ResizeEvent]:
        """MPI_Probe_adapt analogue: application polls for a resource change."""
        with self._lock:
            return self._pending_resize.get(app_id)

    def complete_resize(self, app_id: AppId, *, epoch=None) -> None:
        """MPI_Comm_adapt_commit analogue: resize finished."""
        self._check_epoch(epoch, "complete_resize")
        with self._lock:
            ev = self._pending_resize.pop(app_id, None)
            if ev is not None:
                self._app_ranks[app_id] = ev.new_ranks

    def app_ranks(self, app_id: AppId) -> int:
        with self._lock:
            return self._app_ranks.get(app_id, 0)
