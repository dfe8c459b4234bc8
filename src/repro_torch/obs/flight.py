"""Crash-dump flight recorder: the last N events + spans, always on.

A bounded ring per controller keeps the most recent bus events (audit
record shape, plus the trace context they were published under) and the
most recent completed spans — cheap enough to run unconditionally.  When
something goes red (an invariant at WARN/CRIT, a ``redistribution_fallback``,
a red chaos seed), :meth:`FlightRecorder.dump` writes the ring to
``artifacts/obs/`` so every failure ships its own timeline, the way a red
chaos seed already ships its schedule.

Dumps are deduplicated by ``reason`` key: one red invariant triggers
exactly one dump no matter how many layers notice the same failure.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Dict, List, Optional

DEFAULT_DIR = os.path.join("artifacts", "obs")


class FlightRecorder:
    """Bounded event+span ring with deduplicated crash dumps."""

    def __init__(self, clock=None, out_dir: Optional[str] = None,
                 max_events: int = 2048, max_spans: int = 2048):
        self.clock = clock
        self.out_dir = out_dir or DEFAULT_DIR
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=int(max_events))
        self._spans: collections.deque = collections.deque(
            maxlen=int(max_spans))
        self.events_seen = 0
        self.spans_seen = 0
        self.dumps: Dict[str, str] = {}        # reason key -> dump path

    # ------------------------------------------------------------ feeding
    def on_event(self, ev) -> None:
        """Bus subscriber: ring-append the audit record + trace ids."""
        rec = ev.as_record()
        ctx = getattr(ev, "trace", None)
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
            rec["span_id"] = ctx.span_id
        with self._lock:
            self._events.append(rec)
            self.events_seen += 1

    def on_span(self, span) -> None:
        """Trace-collector listener: ring-append the completed span."""
        with self._lock:
            self._spans.append(span.as_dict())
            self.spans_seen += 1

    # ------------------------------------------------------------ dumping
    def _safe_key(self, reason: str) -> str:
        return "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in reason)[:120]

    def dump(self, reason: str,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the ring to ``<out_dir>/flight_<reason>.json``.

        Idempotent per ``reason``: a repeat trigger returns the existing
        dump path without rewriting (exactly one dump per red cause).
        """
        key = self._safe_key(reason)
        with self._lock:
            if key in self.dumps:
                return self.dumps[key]
            events = list(self._events)
            spans = list(self._spans)
            payload = {
                "reason": reason,
                "sim_t": self.clock.now() if self.clock is not None else 0.0,
                "events_seen": self.events_seen,
                "spans_seen": self.spans_seen,
                "events": events,
                "spans": spans,
            }
            if extra:
                payload["extra"] = extra
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.abspath(
                os.path.join(self.out_dir, f"flight_{key}.json"))
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True, default=str)
            self.dumps[key] = path
            return path

    # ------------------------------------------------------------ reading
    def recent_events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def recent_spans(self) -> List[dict]:
        with self._lock:
            return list(self._spans)
