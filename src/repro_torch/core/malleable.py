"""Malleable-application runtime shim (InvasIC-MPI analogue, paper §III-B).

Mirrors the four malleable MPI routines the paper's infrastructure adds to
MPICH, so that synthetic applications, examples and tests can be written with
the exact control flow of paper Listing 1:

    MPI_Init_adapt         -> MalleableApp.init_adapt    (returns proc type)
    MPI_Probe_adapt        -> MalleableApp.probe_adapt
    MPI_Comm_adapt_begin   -> MalleableApp.adapt_begin
    MPI_Comm_adapt_commit  -> MalleableApp.adapt_commit

In the JAX adaptation an "application rank" is a slice of the device mesh;
the elastic trainer (repro.train.elastic) drives the same state machine with
mesh epochs instead of MPI process groups.
"""
from __future__ import annotations

import enum
from typing import Optional

from .rm import ResizeEvent, ResourceManager
from .types import AppId


class ProcType(str, enum.Enum):
    INITIAL = "initial"    # created at application launch
    JOINING = "joining"    # created during an expansion


class AdaptWindow:
    """The region between adapt_begin and adapt_commit where initial and
    joining processes exchange data (redistribution happens here)."""

    def __init__(self, app: "MalleableApp", event: ResizeEvent):
        self.app = app
        self.event = event
        self.old_ranks = app.ranks
        self.new_ranks = event.new_ranks

    def commit(self) -> None:
        self.app._commit_adapt(self)


class MalleableApp:
    def __init__(self, app_id: AppId, rm: ResourceManager, ranks: int,
                 proc_type: ProcType = ProcType.INITIAL):
        self.app_id = app_id
        self.rm = rm
        self.ranks = ranks
        self.proc_type = proc_type
        self._window: Optional[AdaptWindow] = None
        self.adaptations = 0

    # ----------------------------------------------------------------- MPI_*
    def init_adapt(self) -> ProcType:
        """Register with the RM; returns whether we are initial or joining."""
        if self.proc_type == ProcType.INITIAL:
            self.rm.register_app(self.app_id, self.ranks)
        return self.proc_type

    def probe_adapt(self) -> Optional[ResizeEvent]:
        """Non-blocking check for an RM-triggered resource change."""
        return self.rm.probe_resize(self.app_id)

    def adapt_begin(self) -> AdaptWindow:
        ev = self.rm.probe_resize(self.app_id)
        if ev is None and self.proc_type == ProcType.JOINING:
            # joining processes call adapt_begin unconditionally and wait
            ev = ResizeEvent(self.app_id, self.ranks, reason="join")
        if ev is None:
            raise RuntimeError("adapt_begin without a pending resize")
        self._window = AdaptWindow(self, ev)
        return self._window

    def adapt_commit(self) -> None:
        if self._window is None:
            raise RuntimeError("adapt_commit without adapt_begin")
        self._window.commit()

    # ------------------------------------------------------------------ guts
    def _commit_adapt(self, window: AdaptWindow) -> None:
        self.ranks = window.new_ranks
        self.rm.complete_resize(self.app_id)
        self.proc_type = ProcType.INITIAL     # joiners become initial
        self.adaptations += 1
        self._window = None
