"""Resilience: the shared :class:`ResilienceEvents` registry (degradation
events and breaker transitions) that the op-log reader and the checkpoint
manager record into. Chaos injection, the peer circuit breakers and the
wave watchdog are not ported yet (ROADMAP A.8)."""
from .events import DegradationEvent, ResilienceEvents, global_events

__all__ = ["DegradationEvent", "ResilienceEvents", "global_events"]
