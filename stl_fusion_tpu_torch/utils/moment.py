"""Moments and clocks.

Re-expression of the reference's ``Moment`` / ``IMomentClock`` / ``CpuClock`` /
``TestClock`` (src/Stl/Time/, src/Stl/Time/Testing/). A Moment is a plain
float of seconds; clocks are swappable so tests control time (the reference's
``UseTestClock`` pattern, tests/Stl.Tests/RpcTestBase.cs:25).
"""
from __future__ import annotations

import asyncio
import time
from typing import Optional

__all__ = ["Moment", "MomentClock", "SystemClock", "CpuClock", "TestClock", "MomentClockSet"]

Moment = float  # seconds


class MomentClock:
    """Abstract clock: now + cancellable async delay."""

    def now(self) -> Moment:
        raise NotImplementedError

    async def delay(self, seconds: float) -> None:
        if seconds > 0:
            await asyncio.sleep(seconds)


class SystemClock(MomentClock):
    """Wall clock (epoch seconds)."""

    def now(self) -> Moment:
        return time.time()


class CpuClock(MomentClock):
    """Monotonic clock — the default for timeouts and timer wheels."""

    def now(self) -> Moment:
        return time.monotonic()


class TestClock(MomentClock):
    """Controllable clock: offset + speed multiplier over the real clock.

    ``advance(dt)`` jumps time forward; pending ``delay`` calls re-check on a
    short real-time quantum so advanced time releases them promptly.
    """

    __test__ = False  # not a pytest class

    def __init__(self, offset: float = 0.0, speed: float = 1.0):
        self._origin = time.monotonic()
        self.offset = offset
        self.speed = speed

    def now(self) -> Moment:
        return (time.monotonic() - self._origin) * self.speed + self.offset

    def advance(self, seconds: float) -> None:
        self.offset += seconds

    async def delay(self, seconds: float) -> None:
        target = self.now() + seconds
        while self.now() < target:
            await asyncio.sleep(min(0.005, max(0.0, (target - self.now()) / max(self.speed, 1e-9))))


class MomentClockSet:
    """The bundle of clocks a hub runs on (system/cpu/ui); swap for tests."""

    def __init__(
        self,
        system: Optional[MomentClock] = None,
        cpu: Optional[MomentClock] = None,
    ):
        self.system = system or SystemClock()
        self.cpu = cpu or CpuClock()

    @staticmethod
    def for_tests(test_clock: Optional[TestClock] = None) -> "MomentClockSet":
        c = test_clock or TestClock()
        return MomentClockSet(system=c, cpu=c)
