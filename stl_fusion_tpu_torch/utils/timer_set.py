"""ConcurrentTimerSet — quantized bulk timers over a min-heap.

Re-expression of the reference's ``ConcurrentTimerSet<TTimer>``
(src/Stl/Time/ConcurrentTimerSet.cs:12-38) over ``TimerSet`` +
``RadixHeapSet`` (src/Stl/Collections/RadixHeapSet.cs). Fusion uses two of
these for keep-alive and auto-invalidation (Fusion/Internal/Timeouts.cs:3-34)
with 0.2 s quanta — timers fire in batches on quantum ticks, so millions of
computed nodes share one background task instead of one timer each.

Python build: a single asyncio task per set, a heapq keyed by fire-time, and
a dict for O(1) add-or-update/remove. Clock-aware so TestClock drives it.
"""
from __future__ import annotations

import asyncio
import heapq
import itertools
from typing import Callable, Dict, Generic, Hashable, List, Optional, Tuple, TypeVar

from .moment import CpuClock, MomentClock

T = TypeVar("T", bound=Hashable)

__all__ = ["ConcurrentTimerSet"]


class ConcurrentTimerSet(Generic[T]):
    """Bulk timer set: ``add_or_update(item, fire_at)``; fires ``handler(item)``.

    Items are hashable; re-adding an item moves its deadline (stale heap
    entries are skipped via a sequence check, the standard lazy-deletion
    heap pattern).
    """

    def __init__(
        self,
        handler: Callable[[T], None],
        quanta: float = 0.05,
        clock: Optional[MomentClock] = None,
        name: str = "timers",
    ):
        self._handler = handler
        self._quanta = quanta
        self._clock = clock or CpuClock()
        self._name = name
        self._heap: List[Tuple[float, int, T]] = []
        self._entries: Dict[T, Tuple[int, float]] = {}  # item -> (latest seq, fire_at)
        self._seq = itertools.count()
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._stopped = False

    def __len__(self) -> int:
        return len(self._entries)

    # -- mutation ----------------------------------------------------------
    def add_or_update(self, item: T, fire_at: float) -> None:
        seq = next(self._seq)
        self._entries[item] = (seq, fire_at)
        was_empty = not self._heap
        heapq.heappush(self._heap, (fire_at, seq, item))
        self._ensure_running()
        # the loop ticks every quantum while the heap is non-empty; a wake
        # is only needed to un-park it from the empty-heap idle wait
        if was_empty and self._wake is not None:
            self._wake.set()

    def add_or_update_to_later(self, item: T, fire_at: float, grid: float = 0.0) -> None:
        """Only move the deadline forward (keep-alive renewal semantics).

        Deadlines snap up to a grid — at least the quantum, or the caller's
        coarser ``grid`` — so renewals inside one grid cell are a dict probe
        + compare with no heap churn (the reference's ConcurrentTimer
        quantum dedup, ConcurrentTimerSet.cs:12-38). Keep-alive callers pass
        ``grid = duration/64``: firing up to ~1.6% late is invisible there,
        and it caps heap pushes at 64 per item per lifetime.
        """
        q = self._quanta if grid < self._quanta else grid
        fire_at = (fire_at // q + 1.0) * q
        cur = self._entries.get(item)
        if cur is None or fire_at > cur[1]:
            self.add_or_update(item, fire_at)

    def remove(self, item: T) -> bool:
        return self._entries.pop(item, None) is not None

    # -- loop --------------------------------------------------------------
    def _ensure_running(self) -> None:
        if self._task is None or self._task.done():
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return  # no loop: timers fire via fire_all_due() or on next in-loop add
            self._wake = asyncio.Event()
            self._stopped = False
            self._task = loop.create_task(self._run(), name=f"timer-set:{self._name}")

    async def _run(self) -> None:
        assert self._wake is not None
        while not self._stopped:
            self._fire_due()
            if not self._heap:
                # idle: park until a timer is added
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    if not self._heap:
                        return  # park the task entirely; restarted on next add
                continue
            await self._clock.delay(self._quanta)

    def _fire_due(self) -> None:
        now = self._clock.now()
        while self._heap and self._heap[0][0] <= now:
            _, seq, item = heapq.heappop(self._heap)
            entry = self._entries.get(item)
            if entry is None or entry[0] != seq:
                continue  # stale (updated or removed)
            del self._entries[item]
            try:
                self._handler(item)
            except Exception:  # noqa: BLE001 — timer handlers must not kill the wheel
                pass

    def fire_all_due(self) -> None:
        """Synchronous tick — lets tests drive the wheel with a TestClock."""
        self._fire_due()

    async def stop(self) -> None:
        self._stopped = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
