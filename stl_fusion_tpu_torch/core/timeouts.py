"""Timeouts — shared keep-alive + delayed-invalidation timer wheels.

Re-expression of src/Stl.Fusion/Internal/Timeouts.cs:3-34: two shared
``ConcurrentTimerSet``s. The keep-alive set holds a STRONG reference to each
computed until its ``min_cache_duration`` passes (that's the whole point —
without it, an unreferenced memoized node would be GC'd instantly); the
invalidate set fires ``computed.invalidate()`` for auto/delayed/transient-
error invalidation.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..utils.moment import MomentClock
from ..utils.timer_set import ConcurrentTimerSet

if TYPE_CHECKING:
    from .computed import Computed

__all__ = ["Timeouts"]


class Timeouts:
    def __init__(self, clock: MomentClock, quanta: float = 0.05):
        self.clock = clock
        # keep-alive: handler is a no-op — expiring just drops the strong ref
        self._keep_alive: ConcurrentTimerSet = ConcurrentTimerSet(
            lambda computed: None, quanta=quanta, clock=clock, name="keep-alive"
        )
        self._invalidate: ConcurrentTimerSet = ConcurrentTimerSet(
            lambda computed: computed.invalidate(immediately=True),
            quanta=quanta,
            clock=clock,
            name="invalidate",
        )

    def keep_alive(self, computed: "Computed", duration: float, now: Optional[float] = None) -> None:
        if now is None:
            now = self.clock.now()
        self._keep_alive.add_or_update_to_later(
            computed, now + duration, grid=duration / 64.0
        )

    def schedule_invalidate(self, computed: "Computed", delay: float) -> None:
        self._invalidate.add_or_update(computed, self.clock.now() + delay)

    def cancel(self, computed: "Computed") -> None:
        self._keep_alive.remove(computed)
        self._invalidate.remove(computed)

    def fire_all_due(self) -> None:
        """Synchronous tick for TestClock-driven tests."""
        self._invalidate.fire_all_due()
        self._keep_alive.fire_all_due()

    async def stop(self) -> None:
        await self._keep_alive.stop()
        await self._invalidate.stop()
