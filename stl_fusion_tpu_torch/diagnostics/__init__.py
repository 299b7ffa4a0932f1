"""Diagnostics the wave path records into: tracing spans and cause ids,
the flight recorder, the metrics registry and the per-wave profiler.

``core.computed`` imports this package at module scope, so nothing here
may import ``core`` at module scope."""
from .flight_recorder import RECORDER
from .metrics import WaveProfiler, global_metrics, next_wave_seq
from .tracing import CAUSE_PREFIX, current_cause_id, current_span, span_cause_id

__all__ = [
    "RECORDER", "WaveProfiler", "global_metrics", "next_wave_seq",
    "CAUSE_PREFIX", "current_cause_id", "current_span", "span_cause_id",
]
