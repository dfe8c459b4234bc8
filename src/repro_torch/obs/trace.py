"""Sim-time distributed tracing for the checkpoint service core.

One checkpoint's life — client commit → device/host encode → L1 puts →
L2 drain → L3 trickle → restore or redistribution — crosses the client
thread, every agent inbox worker, the drain pool and its background lane,
and (for a zero-stall resize) an overlap window.  This module stitches
those hops into a single causal span tree per ``trace_id``:

* ``TraceContext`` — an immutable ``(trace_id, span_id, parent_id)``
  triple.  The *current* context is thread-local; queue hand-offs
  (agent ``_Op``s, drain submissions, background-lane closures) carry it
  explicitly and reinstate it with :meth:`TraceCollector.use` on the
  consuming thread.
* ``trace_id`` convention: ``"{app}/c{ckpt_id}"`` — derivable from any
  event payload that names the app and checkpoint, so late phases
  (drain retries, the L3 trickle, a restore hours later) re-join the
  tree without having had the context threaded to them: a span started
  with a ``trace_id`` but no parent attaches to that trace's root span.
* Spans live in **sim time** (the :class:`~repro.core.simnet.SimClock`);
  durations are the analytic sim seconds the operation accounted for.
* Export is Chrome/Perfetto ``trace_event`` JSON
  (:meth:`TraceCollector.to_chrome_trace`): one *process* per track
  prefix (node, client, service), one *thread* per full track name, so
  ``chrome://tracing`` / https://ui.perfetto.dev render one lane per
  node/agent/service.

Disabled collectors (the default) are no-ops on the hot path: ``record``
returns ``None`` immediately and ``span``/``use`` yield without touching
the thread-local, so tracing costs nothing unless asked for.
"""

from __future__ import annotations

import itertools
import json
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class TraceContext:
    """Propagated identity of one span: where new child spans attach."""

    trace_id: str
    span_id: int
    parent_id: Optional[int] = None


@dataclass
class Span:
    """One completed operation on one track, in sim time."""

    name: str
    trace_id: str
    span_id: int
    parent_id: Optional[int]
    track: str
    t0: float
    dur_s: float
    args: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "track": self.track,
            "t0": self.t0,
            "dur_s": self.dur_s,
            "args": dict(self.args),
        }


def trace_id_for(app_id: str, ckpt_id) -> str:
    """The canonical trace id of one checkpoint's life."""
    return f"{app_id}/c{ckpt_id}"


class TraceCollector:
    """Bounded, thread-safe span sink with Chrome trace export.

    ``enabled=False`` (default) keeps every entry point a near-free no-op
    so the tracer can be wired unconditionally through the core.
    """

    def __init__(self, clock=None, enabled: bool = False,
                 max_spans: int = 200_000):
        self.clock = clock
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        # trace_id -> root span_id: parentless spans of a known trace
        # attach here, which is what keeps cross-thread phases (drain,
        # trickle, restore) connected without explicit context plumbing
        self._roots: Dict[str, int] = {}
        self._tls = threading.local()
        # listeners observe completed spans (the flight recorder's ring)
        self._listeners: List[Any] = []

    # ------------------------------------------------------------ context
    def current(self) -> Optional[TraceContext]:
        if not self.enabled:
            return None
        return getattr(self._tls, "ctx", None)

    @contextmanager
    def use(self, ctx: Optional[TraceContext]):
        """Reinstate a handed-off context on the consuming thread."""
        if not self.enabled or ctx is None:
            yield
            return
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = ctx
        try:
            yield
        finally:
            self._tls.ctx = prev

    # ------------------------------------------------------------ recording
    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    def _resolve_parent(self, trace_id: str,
                        parent: Optional[TraceContext]) -> Optional[int]:
        if parent is not None and parent.trace_id == trace_id:
            return parent.span_id
        cur = self.current()
        if cur is not None and cur.trace_id == trace_id:
            return cur.span_id
        return self._roots.get(trace_id)

    def record(self, name: str, trace_id: str, track: str,
               t0: Optional[float] = None, dur_s: float = 0.0,
               parent: Optional[TraceContext] = None,
               root: bool = False, **args) -> Optional[TraceContext]:
        """Append one completed span with an analytic sim duration.

        Returns the span's :class:`TraceContext` (for hand-off to child
        operations), or ``None`` when the collector is disabled.
        """
        if not self.enabled:
            return None
        span_id = next(self._ids)
        with self._lock:
            parent_id = None if root else self._resolve_parent(trace_id,
                                                               parent)
            if root and trace_id not in self._roots:
                self._roots[trace_id] = span_id
            span = Span(name=name, trace_id=trace_id, span_id=span_id,
                        parent_id=parent_id, track=track,
                        t0=self._now() if t0 is None else float(t0),
                        dur_s=max(0.0, float(dur_s)), args=dict(args))
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
            else:
                self._spans.append(span)
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(span)
            except Exception:  # noqa: BLE001 - observers must not break us
                pass
        return TraceContext(trace_id=trace_id, span_id=span_id,
                            parent_id=parent_id)

    @contextmanager
    def span(self, name: str, trace_id: str, track: str,
             parent: Optional[TraceContext] = None, root: bool = False,
             **args):
        """Context-managed span: duration is the sim-clock delta across the
        body, and the body runs with the new span as the current context
        (children started inside attach to it)."""
        if not self.enabled:
            yield None
            return
        t0 = self._now()
        span_id = next(self._ids)
        with self._lock:
            parent_id = None if root else self._resolve_parent(trace_id,
                                                               parent)
            if root and trace_id not in self._roots:
                self._roots[trace_id] = span_id
        ctx = TraceContext(trace_id=trace_id, span_id=span_id,
                           parent_id=parent_id)
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = ctx
        try:
            yield ctx
        finally:
            self._tls.ctx = prev
            span = Span(name=name, trace_id=trace_id, span_id=span_id,
                        parent_id=parent_id, track=track, t0=t0,
                        dur_s=max(0.0, self._now() - t0), args=dict(args))
            with self._lock:
                if len(self._spans) >= self.max_spans:
                    self.dropped += 1
                else:
                    self._spans.append(span)
                listeners = list(self._listeners)
            for listener in listeners:
                try:
                    listener(span)
                except Exception:  # noqa: BLE001
                    pass

    def add_listener(self, listener) -> None:
        with self._lock:
            self._listeners.append(listener)

    # ------------------------------------------------------------ inspection
    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            if trace_id is None:
                return list(self._spans)
            return [s for s in self._spans if s.trace_id == trace_id]

    def trace_ids(self) -> List[str]:
        with self._lock:
            seen: Dict[str, None] = {}
            for s in self._spans:
                seen.setdefault(s.trace_id, None)
            return list(seen)

    def root_of(self, trace_id: str) -> Optional[int]:
        with self._lock:
            return self._roots.get(trace_id)

    # ------------------------------------------------------------ export
    def _track_ids(self, spans: List[Span]) -> Dict[str, Tuple[int, int]]:
        """Stable (pid, tid) per track: pid per prefix before the first
        '/', tid per full track name — one Perfetto lane per agent/lane."""
        pids: Dict[str, int] = {}
        tids: Dict[str, int] = {}
        out: Dict[str, Tuple[int, int]] = {}
        for s in spans:
            if s.track in out:
                continue
            proc = s.track.split("/", 1)[0]
            pid = pids.setdefault(proc, len(pids) + 1)
            tid = tids.setdefault(s.track, len(tids) + 1)
            out[s.track] = (pid, tid)
        return out

    def to_chrome_trace(self) -> dict:
        """Render every collected span as Chrome ``trace_event`` JSON
        (the dict form: load the file in chrome://tracing or Perfetto)."""
        spans = self.spans()
        tracks = self._track_ids(spans)
        events: List[dict] = []
        procs_done = set()
        for track, (pid, tid) in tracks.items():
            proc = track.split("/", 1)[0]
            if pid not in procs_done:
                procs_done.add(pid)
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": proc}})
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tid,
                           "args": {"name": track}})
        for s in spans:
            pid, tid = tracks[s.track]
            events.append({
                "ph": "X",
                "name": s.name,
                "cat": "ckpt",
                "ts": s.t0 * 1e6,          # trace_event wants microseconds
                "dur": s.dur_s * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {**s.args, "trace_id": s.trace_id,
                         "span_id": s.span_id, "parent_id": s.parent_id},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"clock": "sim", "dropped_spans": self.dropped}}

    def write_chrome_trace(self, path: str) -> str:
        import os

        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1, sort_keys=True)
        return os.path.abspath(path)
