"""ResilienceEvents — the shared degradation-event ledger.

Every resilience component (breaker transitions, watchdog fallbacks, oplog
quarantines) records into one of these; ``diagnostics.FusionMonitor.report()``
exports the counters so a single stats dump answers "did anything degrade,
and how often". Bounded: counters are a dict, the event tail a deque — a
flapping peer can transition forever without growing memory.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

__all__ = ["DegradationEvent", "ResilienceEvents", "global_events"]


@dataclass(frozen=True)
class DegradationEvent:
    kind: str  # e.g. "breaker_open", "wave_fallback", "oplog_corrupt"
    detail: str = ""
    at: float = field(default_factory=time.monotonic)


class ResilienceEvents:
    """Counter + bounded-tail registry for degradation events."""

    def __init__(self, capacity: int = 256):
        self.counters: Dict[str, int] = {}
        self.recent: Deque[DegradationEvent] = deque(maxlen=capacity)

    def record(self, kind: str, detail: str = "") -> DegradationEvent:
        self.counters[kind] = self.counters.get(kind, 0) + 1
        ev = DegradationEvent(kind, detail)
        self.recent.append(ev)
        return ev

    def count(self, kind: str) -> int:
        return self.counters.get(kind, 0)

    def total(self) -> int:
        return sum(self.counters.values())

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counters)

    def recent_of(self, kind: str, limit: Optional[int] = None) -> List[DegradationEvent]:
        out = [e for e in self.recent if e.kind == kind]
        return out[-limit:] if limit is not None else out

    def clear(self) -> None:
        self.counters.clear()
        self.recent.clear()


#: the process-wide default ledger: components that aren't handed an explicit
#: registry record here, so FusionMonitor.report() sees them with no wiring
_GLOBAL = ResilienceEvents()
_METRICS_REGISTERED = False


def global_events() -> ResilienceEvents:
    # lazily expose the ledger's counters through the process metrics
    # registry (/metrics route): one collector, registered the
    # first time anything touches the ledger
    global _METRICS_REGISTERED
    if not _METRICS_REGISTERED:
        _METRICS_REGISTERED = True
        from ..diagnostics.metrics import global_metrics

        global_metrics().register_collector(
            _GLOBAL,
            lambda ev: {
                f"fusion_resilience_{k}_total": v for k, v in ev.counters.items()
            },
        )
    return _GLOBAL
