"""FlightRecorder — the causal flight journal.

The metrics make invalidation *latency* observable; this ring answers the
operator's second question — *why*: a bounded, lock-cheap journal of node
lifecycle events (registered / computed / invalidated / pruned / wave /
client-fenced / oplog-replayed), each stamped with its cause id plus
— when the feeding layer knows them — the wave sequence number and the
oplog index. ``explain.py`` joins this ring against the wave-profiler
ring, the tracing span buffer and the CSR mirror to assemble a causal
chain ("X invalidated by wave W, caused by command C via oplog entry E,
fenced N clients").

Design rules, matching the metrics registry's:

- **Lock-cheap hot path**: one ``enabled`` check, a dict build, and ONE
  uncontended lock acquisition covering the ring append + the exact
  per-kind counters. The append stays INSIDE the lock on purpose:
  invalidation is multi-thread-safe, so a bare deque iteration racing a
  worker-thread append would raise "deque mutated during iteration"
  mid-``explain()``, and bare counter read-modify-writes would undercount.
  No I/O, no registry hop. Feeding sites additionally guard with
  ``if RECORDER.enabled:`` so a disabled recorder costs one attribute
  read — the same gate discipline as ``WaveProfiler.enabled``
  (``LIVE_RECORDER=0`` is the live-path A/B knob).
- **Bounded memory**: the ring holds ``capacity`` events (default 4096);
  a 100k-event storm keeps the newest 4096 and exact per-kind counters.
  Totals survive eviction, so the summary stays whole-run honest.
- **Context stamping without plumbing**: the graph backend publishes the
  wave seq it is currently applying (``current_wave``) and the oplog
  reader the record index it is currently replaying (``current_oplog``);
  ``note()`` auto-stamps both, so a ``Computed.invalidate_local`` deep in
  wave application never needs to thread identifiers through its callers.

Events are plain JSON-safe dicts — they travel verbatim through
``FusionMonitor.report()["recorder"]``, ``GET /explain`` and the
``$sys-d.explain`` cross-peer hop.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "RECORDER",
    "global_recorder",
    "call_key",
    "method_key_fragment",
]


def method_key_fragment(method: str, args) -> str:
    """The method+args tail of a call-shaped journal key — the fragment
    the ``$sys-d`` string fallback matches against SERVER-side keys (whose
    class-name prefix differs from the RPC service name)."""
    return f".{method}{tuple(args)!r}"


def call_key(service: str, method: str, args) -> str:
    """THE call-shaped journal key: producer (client fence events in
    compute_call.py) and consumer (explain()'s key join) must build it
    through this one helper — byte-identical output is what makes
    ``for_key()`` find the events at all."""
    return f"{service}{method_key_fragment(method, args)}"

#: both stamping contexts are contextvars (like tracing spans), NOT plain
#: attributes: the oplog reader holds its stamp across awaits (an attribute
#: would mis-stamp events from OTHER tasks interleaved on the loop), and
#: wave application — though synchronous — can run while a WORKER THREAD
#: host-invalidates an unrelated node (invalidation is multi-thread-safe);
#: contextvars are per-thread/per-task, so neither ever sees the other's
#: stamp and explain() never attributes an event to a wave that did not
#: touch it
_current_oplog: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "fusion_current_oplog", default=None
)
_current_wave: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "fusion_current_wave", default=None
)


class FlightRecorder:
    def __init__(self, capacity: int = 4096):
        #: master gate — feeding sites check this BEFORE building the event
        self.enabled = True
        self.capacity = capacity
        self._ring: Deque[dict] = deque(maxlen=capacity)
        self._seq = itertools.count(1)
        #: per-kind totals; survive ring eviction (the 100k-storm contract).
        #: Guarded by a lock: invalidation is multi-thread-safe (per-node
        #: locks in core/computed.py), and a bare dict read-modify-write
        #: would lose increments across a GIL switch — "exact" means exact.
        #: Uncontended acquisition is ~100ns next to the ~2µs event build.
        self.counts: Dict[str, int] = {}
        self.events_recorded = 0
        self._count_lock = threading.Lock()

    # ------------------------------------------------------------------ context
    @property
    def current_wave(self) -> Optional[int]:
        """Wave seq the CURRENT THREAD/TASK is applying (contextvar-scoped:
        a worker thread's concurrent host-led invalidation must never be
        stamped with the loop thread's in-flight wave)."""
        return _current_wave.get()

    @current_wave.setter
    def current_wave(self, value: Optional[int]) -> None:
        _current_wave.set(value)

    @property
    def current_oplog(self) -> Optional[int]:
        """Oplog index the CURRENT TASK is replaying (contextvar-scoped —
        the reader holds it across awaits, so other tasks' events are
        never mis-stamped with an unrelated oplog index)."""
        return _current_oplog.get()

    @current_oplog.setter
    def current_oplog(self, value: Optional[int]) -> None:
        _current_oplog.set(value)

    # ------------------------------------------------------------------ feed
    def note(
        self,
        kind: str,
        key: Optional[str] = None,
        cause: Optional[str] = None,
        detail: Optional[str] = None,
        wave: Optional[int] = None,
        oplog: Optional[int] = None,
        count: Optional[int] = None,
    ) -> None:
        """Record one lifecycle event. Cheap by construction: dict build +
        deque append; callers gate on ``RECORDER.enabled`` so the disabled
        cost is a single attribute read at the call site. ``count`` is the
        structured multiplicity of the event (e.g. subscriptions fenced) —
        consumers must read it, never parse ``detail`` prose."""
        if not self.enabled:
            return
        ev: dict = {
            "seq": next(self._seq),
            "at": time.time(),
            "kind": kind,
            "key": key,
            "cause": cause,
        }
        wave = wave if wave is not None else _current_wave.get()
        if wave is not None:
            ev["wave"] = wave
        oplog = oplog if oplog is not None else _current_oplog.get()
        if oplog is not None:
            ev["oplog"] = oplog
        if count is not None:
            ev["count"] = count
        if detail is not None:
            ev["detail"] = detail
        with self._count_lock:
            # append under the same lock the query methods snapshot with:
            # a bare deque iteration racing a worker-thread append raises
            # "deque mutated during iteration" mid-explain()
            self._ring.append(ev)
            self.events_recorded += 1
            self.counts[kind] = self.counts.get(kind, 0) + 1

    # ------------------------------------------------------------------ query
    def _snapshot(self) -> List[dict]:
        """Stable copy of the ring for iteration — appends from another
        thread mid-query would otherwise raise "deque mutated during
        iteration" exactly when the system is busy."""
        with self._count_lock:
            return list(self._ring)

    def recent(self, n: Optional[int] = None, kind: Optional[str] = None) -> List[dict]:
        out = [e for e in self._snapshot() if kind is None or e["kind"] == kind]
        return out[-n:] if n is not None else out

    def for_key(self, key: str, limit: Optional[int] = None) -> List[dict]:
        """Events whose key matches exactly (chronological order)."""
        out = [e for e in self._snapshot() if e["key"] == key]
        return out[-limit:] if limit is not None else out

    def for_cause(self, cause: str, kind: Optional[str] = None) -> List[dict]:
        return [
            e
            for e in self._snapshot()
            if e["cause"] == cause and (kind is None or e["kind"] == kind)
        ]

    def keys_matching(self, fragment: str, limit: int = 32) -> List[str]:
        """Distinct recorded keys containing ``fragment`` (newest first) —
        the fallback resolver for ``GET /explain?key=`` string lookups."""
        seen: List[str] = []
        for e in reversed(self._snapshot()):
            k = e["key"]
            if k and fragment in k and k not in seen:
                seen.append(k)
                if len(seen) >= limit:
                    break
        return seen

    def summary(self) -> dict:
        with self._count_lock:  # consistent reads against worker-thread feeds
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "depth": len(self._ring),
                "events_recorded": self.events_recorded,
                "counts": dict(self.counts),
            }

    def report(self, recent: int = 32) -> dict:
        return {**self.summary(), "recent": self.recent(recent)}

    def clear(self) -> None:
        """Drop events, counters and context stamps (tests — mirrors
        ``tracing.clear_recent``; the conftest fixture isolates per test)."""
        with self._count_lock:
            self._ring.clear()
            self.counts.clear()
            self.events_recorded = 0
        _current_wave.set(None)
        _current_oplog.set(None)


#: the process-wide recorder: hot paths reference this singleton directly
#: (``if RECORDER.enabled: RECORDER.note(...)``) — never swapped, so the
#: bound references in core/graph/rpc stay valid for the process lifetime
RECORDER = FlightRecorder()


def global_recorder() -> FlightRecorder:
    """The process-wide flight recorder — same contract as
    ``metrics.global_metrics()`` / ``resilience.events.global_events()``."""
    return RECORDER
