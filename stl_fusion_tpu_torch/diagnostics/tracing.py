"""Activity-style tracing (SURVEY §5.1; src/Stl/Diagnostics/).

The reference hangs a ``System.Diagnostics.ActivitySource`` off every
component (registry prune spans, op-log reader reads, invalidation replays,
RPC inbound calls). Here a module-level ``ActivitySource`` registry produces
``Span`` context managers that record (name, tags, duration, error) into a
bounded in-process buffer and notify listeners; exporters (logging, test
assertions) subscribe via ``add_listener``.

Spans nest via a contextvar, so a trace tree can be reconstructed from
``parent_id`` — the analogue of Activity.Current parenting.
"""
from __future__ import annotations

import contextvars
import itertools
import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

log = logging.getLogger("stl_fusion_tpu_torch.tracing")

__all__ = [
    "Span",
    "ActivitySource",
    "get_activity_source",
    "add_listener",
    "remove_listener",
    "recent_spans",
    "clear_recent",
    "span_cause_id",
    "current_cause_id",
    "find_span_by_cause",
]

#: process-unique cause-id prefix (shared with graph/backend.py wave ids):
#: two hosts minting "wave#1" must not collide when their frames meet in
#: one client's telemetry. pid ALONE is not unique across hosts — two
#: containers both running as pid 1 would mint byte-identical ids — so a
#: random suffix minted once at import disambiguates them (4 bytes: a
#: 2-byte suffix birthday-collides past ~300 same-pid containers)
CAUSE_PREFIX = f"{os.getpid():x}-{int.from_bytes(os.urandom(4), 'big'):08x}"

_span_ids = itertools.count(1)
_current_span: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "fusion_current_span", default=None
)
_listeners: List[Callable[["Span"], None]] = []
_recent: Deque["Span"] = deque(maxlen=2048)
_sources: Dict[str, "ActivitySource"] = {}


@dataclass
class Span:
    source: str
    name: str
    tags: Dict[str, Any] = field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None
    started_at: float = 0.0
    duration: Optional[float] = None
    # error is recorded as (type name, message) — keeping the live exception
    # here would pin its traceback frames in the span buffer
    error_type: Optional[str] = None
    error_message: Optional[str] = None
    _token: Any = None

    @property
    def failed(self) -> bool:
        return self.error_type is not None

    def set_tag(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe span view (the ``/trace`` gateway route ships these)."""
        return {
            "source": self.source,
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "duration_ms": (
                round(self.duration * 1e3, 4) if self.duration is not None else None
            ),
            "error_type": self.error_type,
            "error_message": self.error_message,
            "tags": {k: repr(v) if not isinstance(v, (int, float, str, bool, type(None))) else v
                     for k, v in self.tags.items()},
        }

    def __enter__(self) -> "Span":
        self.span_id = next(_span_ids)
        parent = _current_span.get()
        self.parent_id = parent.span_id if parent is not None else None
        self.started_at = time.perf_counter()
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration = time.perf_counter() - self.started_at
        if exc is not None:
            self.error_type = type(exc).__name__
            self.error_message = str(exc)
        _current_span.reset(self._token)
        _recent.append(self)
        for listener in list(_listeners):
            try:
                listener(self)
            except Exception:  # noqa: BLE001 — listeners never break traced code
                log.exception("trace listener failed")


class ActivitySource:
    def __init__(self, name: str):
        self.name = name

    def span(self, name: str, **tags: Any) -> Span:
        return Span(self.name, name, tags)


def get_activity_source(name: str) -> ActivitySource:
    source = _sources.get(name)
    if source is None:
        source = _sources[name] = ActivitySource(name)
    return source


def current_span() -> Optional[Span]:
    return _current_span.get()


def span_cause_id(span: Span) -> str:
    """The canonical cause-id form of a span — the SAME format
    ``TpuGraphBackend._begin_wave`` stamps into ``$sys-c`` frames, so a
    host-led invalidation under an open span joins the trace machinery
    exactly like a device wave does."""
    return f"{CAUSE_PREFIX}/{span.source}:{span.name}#{span.span_id}"


def current_cause_id() -> Optional[str]:
    """Cause id of the currently open span, or None outside any span."""
    span = _current_span.get()
    return span_cause_id(span) if span is not None else None


def wave_shaped_cause(seq: int) -> str:
    """A wave-shaped cause id (``<prefix>/wave#<seq>``) for wave work no
    backend span began — the routed graph driven directly by a perf
    worker still keys its mesh trace segments in the ONE cause-id format,
    so stitch/explain join them like any backend wave."""
    return f"{CAUSE_PREFIX}/wave#{seq}"


def find_span_by_cause(cause: str) -> Optional[Span]:
    """Resolve a span-shaped cause id back to its recorded span (None for
    wave-shaped causes, foreign-process causes, or evicted spans)."""
    prefix, sep, rest = cause.partition("/")
    if not sep or prefix != CAUSE_PREFIX or "#" not in rest:
        return None
    name_part, _, id_part = rest.rpartition("#")
    if ":" not in name_part:
        # wave-shaped rest ("wave#N"): span-shaped causes are always
        # "<source>:<name>#<id>" — without the colon this would parse N as
        # a span id and resolve to an unrelated span
        return None
    try:
        span_id = int(id_part)
    except ValueError:
        return None
    # snapshot (one C-level copy) before iterating: a worker thread closing
    # a span appends to _recent, and a bare Python-level iteration racing
    # that append raises "deque mutated during iteration" mid-explain()
    for s in reversed(list(_recent)):
        if s.span_id == span_id:
            return s
    return None


def add_listener(listener: Callable[[Span], None]) -> None:
    _listeners.append(listener)


def remove_listener(listener: Callable[[Span], None]) -> None:
    if listener in _listeners:
        _listeners.remove(listener)


def recent_spans(source: Optional[str] = None, name: Optional[str] = None) -> List[Span]:
    return [
        s
        for s in list(_recent)  # snapshot: appends from other threads race
        if (source is None or s.source == source) and (name is None or s.name == name)
    ]


def clear_recent() -> None:
    """Drop the recorded span buffer. The buffer (and the listener list)
    are module-level state that would otherwise LEAK across tests — a span
    recorded by one test shows up in the next test's ``recent_spans()``.
    ``tests/conftest.py`` calls this per test (and snapshots/restores the
    listener list) so span assertions are hermetic."""
    _recent.clear()
