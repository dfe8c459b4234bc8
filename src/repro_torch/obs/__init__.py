"""Observability substrate: sim-time tracing, histograms, flight recorder.

See ARCHITECTURE.md "Observability" for the span taxonomy and the
``trace_id`` convention.
"""

from .flight import FlightRecorder
from .hist import LogHistogram
from .trace import Span, TraceCollector, TraceContext, trace_id_for

__all__ = [
    "FlightRecorder",
    "LogHistogram",
    "Span",
    "TraceCollector",
    "TraceContext",
    "trace_id_for",
]
