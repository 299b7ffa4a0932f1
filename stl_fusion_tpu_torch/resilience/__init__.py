"""Resilience subsystem — chaos injection, peer circuit breakers, wave
watchdog (the burst path and the RPC layer exercised together under failure).

The pieces compose around one shared :class:`ResilienceEvents` registry
(degradation events + breaker transitions, exported through
``diagnostics.FusionMonitor.report()``):

- :mod:`.chaos` — seeded, deterministic fault injection (drop / duplicate /
  delay / reorder, timed partitions, peer-kill schedules) pluggable into the
  twisted test channels AND the real middleware chains, plus a scenario
  runner that replays named fault scripts;
- :mod:`.breaker` — per-peer circuit breakers (closed/open/half-open) fed by
  ``connection_state``, quarantining flapping peers so reconnect re-send
  storms can't amplify;
- :mod:`.watchdog` — deadline + fault enforcement on device wave dispatches:
  a fused burst that blows its deadline or raises degrades to the split host
  loop, and the first wave after re-engaging the fused path is verified
  against an independent host-BFS oracle.
"""
from .events import DegradationEvent, ResilienceEvents, global_events
from .chaos import (
    SCENARIOS,
    ChaosActions,
    ChaosPolicy,
    ChaosScenarioRunner,
    chaos_middleware,
    wrap_chaos_pair,
)
from .breaker import BreakerState, PeerCircuitBreaker
from .watchdog import WaveWatchdog

__all__ = [
    "BreakerState",
    "ChaosActions",
    "ChaosPolicy",
    "ChaosScenarioRunner",
    "DegradationEvent",
    "PeerCircuitBreaker",
    "ResilienceEvents",
    "SCENARIOS",
    "WaveWatchdog",
    "chaos_middleware",
    "global_events",
    "wrap_chaos_pair",
]
