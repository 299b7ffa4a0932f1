"""Diagnostics: registry monitoring and hit-ratio reports, activity-style
tracing spans and cause ids, explicit graph-invariant sweeps, the causal
flight recorder and ``explain()`` introspection, the online consistency
auditor, the hot-key sketches the RPC fan-out feeds, the cross-host clock
offsets its delivery timestamps map through, the mesh telemetry plane and
the SLO engine.

``core.computed`` imports this package at module scope (the flight-recorder
hot-path hooks), so nothing here may import ``core``/``rpc`` at module scope
— ``explain``/``auditor`` keep those imports function-local.
"""
from .auditor import ConsistencyAuditor
from .explain import (
    explain,
    explain_client,
    explain_remote,
    explain_with_fallback,
    install_explain,
)
from .flight_recorder import RECORDER, FlightRecorder, global_recorder
from .hotkeys import HOTKEY_DOMAINS, HotKeyBoard, SpaceSavingSketch, global_hotkeys
from .invariants import InvariantReport, InvariantViolation, validate_hub, validate_mirror
from .mesh_telemetry import (
    MeshTelemetryAggregator,
    MeshTelemetryPublisher,
    MeshTelemetryService,
    MeshTraceStore,
    WaveSegment,
    global_mesh_trace,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WaveProfiler,
    global_metrics,
    next_wave_seq,
)
from .monitor import FusionMonitor
from .slo import (
    SloEngine,
    SloSpec,
    default_slos,
    global_slo_engine,
    merge_verdicts,
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
    "FusionMonitor",
    "ConsistencyAuditor",
    "FlightRecorder",
    "RECORDER",
    "global_recorder",
    "explain",
    "explain_client",
    "explain_remote",
    "explain_with_fallback",
    "install_explain",
    "MeshTelemetryAggregator",
    "MeshTelemetryPublisher",
    "MeshTelemetryService",
    "MeshTraceStore",
    "WaveSegment",
    "global_mesh_trace",
    "InvariantReport",
    "InvariantViolation",
    "validate_hub",
    "validate_mirror",
    "ActivitySource",
    "Span",
    "add_listener",
    "clear_recent",
    "current_cause_id",
    "current_span",
    "get_activity_source",
    "recent_spans",
    "remove_listener",
    "span_cause_id",
    "CAUSE_PREFIX",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "WaveProfiler",
    "global_metrics",
    "next_wave_seq",
    "HOTKEY_DOMAINS",
    "HotKeyBoard",
    "SpaceSavingSketch",
    "global_hotkeys",
    "SloEngine",
    "SloSpec",
    "default_slos",
    "global_slo_engine",
    "merge_verdicts",
]
