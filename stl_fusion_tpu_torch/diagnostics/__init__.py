"""Diagnostics the wave path records into: tracing spans and cause ids,
the flight recorder, the metrics registry and the per-wave profiler, the
hot-key sketches the RPC fan-out feeds and the cross-host clock offsets
its delivery timestamps map through. The monitor, auditor, explain,
invariants, mesh telemetry and SLOs are not ported yet (ROADMAP A.8).

``core.computed`` imports this package at module scope, so nothing here
may import ``core`` at module scope."""
from .flight_recorder import RECORDER, FlightRecorder, global_recorder
from .hotkeys import HOTKEY_DOMAINS, HotKeyBoard, SpaceSavingSketch, global_hotkeys
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WaveProfiler,
    global_metrics,
    next_wave_seq,
)
from .tracing import (
    CAUSE_PREFIX,
    ActivitySource,
    Span,
    add_listener,
    clear_recent,
    current_cause_id,
    current_span,
    get_activity_source,
    recent_spans,
    remove_listener,
    span_cause_id,
)

__all__ = [
    "FlightRecorder", "RECORDER", "global_recorder",
    "HOTKEY_DOMAINS", "HotKeyBoard", "SpaceSavingSketch", "global_hotkeys",
    "ActivitySource", "Span", "add_listener", "clear_recent", "current_cause_id",
    "current_span", "get_activity_source", "recent_spans", "remove_listener",
    "span_cause_id", "CAUSE_PREFIX",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "WaveProfiler", "global_metrics",
    "next_wave_seq",
]
