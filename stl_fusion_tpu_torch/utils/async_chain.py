"""AsyncChain + WorkerBase — composable background-work lifecycles.

Re-expression of the reference's ``AsyncChain`` (src/Stl/Async/AsyncChain.cs,
AsyncChainExt.cs) and ``WorkerBase``/``ProcessorBase``
(src/Stl/Async/WorkerBase.cs, ProcessorBase.cs). Every background worker in
the reference — graph pruner, op-log reader, RPC peers — is an AsyncChain of
named steps with retry/cycle/delay combinators, hosted by a WorkerBase with
a cancellation-scoped lifetime. Same shape here on asyncio.
"""
from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass, replace
from typing import Awaitable, Callable, Optional, Sequence

__all__ = ["AsyncChain", "RetryDelaySeq", "WorkerBase"]

log = logging.getLogger("stl_fusion_tpu_torch")


@dataclass(frozen=True)
class RetryDelaySeq:
    """Jittered exponential backoff sequence (src/Stl/Time/RetryDelaySeq.cs)."""

    min_delay: float = 0.5
    max_delay: float = 10.0
    spread: float = 0.1
    multiplier: float = 1.41421356  # sqrt(2), the reference default

    def __getitem__(self, failed_try_count: int) -> float:
        if failed_try_count <= 0:
            return 0.0
        d = self.min_delay * (self.multiplier ** (failed_try_count - 1))
        d = min(d, self.max_delay)
        return max(0.0, d * (1.0 + random.uniform(-self.spread, self.spread)))


@dataclass(frozen=True)
class AsyncChain:
    """A named async step; combinators return new chains (immutable)."""

    name: str
    start: Callable[[], Awaitable[None]]

    async def run(self) -> None:
        await self.start()

    def append_delay(self, delay: float) -> "AsyncChain":
        async def _run() -> None:
            await self.start()
            await asyncio.sleep(delay)

        return replace(self, name=f"{self.name}+delay({delay})", start=_run)

    def retry_forever(self, delays: Optional[RetryDelaySeq] = None) -> "AsyncChain":
        seq = delays or RetryDelaySeq()

        async def _run() -> None:
            failures = 0
            while True:
                try:
                    await self.start()
                    return
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    delay = seq[failures]
                    log.debug("%s failed (%s), retry #%d in %.2fs", self.name, e, failures, delay)
                    await asyncio.sleep(delay)

        return replace(self, name=f"{self.name}.retry_forever", start=_run)

    def cycle_forever(self) -> "AsyncChain":
        async def _run() -> None:
            while True:
                await self.start()

        return replace(self, name=f"{self.name}.cycle_forever", start=_run)

    def log_boundary(self, logger: Optional[logging.Logger] = None) -> "AsyncChain":
        lg = logger or log

        async def _run() -> None:
            lg.debug("%s: started", self.name)
            try:
                await self.start()
                lg.debug("%s: completed", self.name)
            except asyncio.CancelledError:
                lg.debug("%s: cancelled", self.name)
                raise
            except Exception:
                lg.exception("%s: failed", self.name)
                raise

        return replace(self, start=_run)

    @staticmethod
    def from_steps(name: str, steps: Sequence["AsyncChain"]) -> "AsyncChain":
        async def _run() -> None:
            await asyncio.gather(*(s.start() for s in steps))

        return AsyncChain(name, _run)


class WorkerBase:
    """Start/stop lifecycle around one background task.

    Subclasses implement ``on_run``; ``start()`` is idempotent; ``stop()``
    cancels and awaits. ``when_stopped()`` exposes completion.
    """

    def __init__(self, name: Optional[str] = None):
        self._worker_name = name or type(self).__name__
        self._task: Optional[asyncio.Task] = None
        self._stop_requested = False

    @property
    def is_running(self) -> bool:
        return self._task is not None and not self._task.done()

    def start(self) -> "WorkerBase":
        if self._task is None or self._task.done():
            self._stop_requested = False
            loop = asyncio.get_event_loop()
            self._task = loop.create_task(self._run_guarded(), name=self._worker_name)
        return self

    async def _run_guarded(self) -> None:
        try:
            await self.on_run()
        except asyncio.CancelledError:
            pass
        except Exception:  # noqa: BLE001
            log.exception("worker %s crashed", self._worker_name)

    async def on_run(self) -> None:
        raise NotImplementedError

    async def stop(self) -> None:
        self._stop_requested = True
        task = self._task
        if task is None:
            return
        # cancel-until-dead: on py ≤ 3.11, asyncio.wait_for SWALLOWS a
        # cancellation when its inner future completes in the same event-loop
        # step (the bpo-42130 family) — a worker parked in wait_for whose
        # wake-up fired exactly at stop() time absorbs the cancel and runs
        # forever, deadlocking the stop() awaiter (observed as a rare hang of
        # the op-log reader restart under chaos). Re-cancel until the task is
        # actually done; asyncio.wait never raises, and _run_guarded consumes
        # the task's own CancelledError, so nothing leaks. _task stays set
        # until the task is REALLY dead — is_running/when_stopped/start must
        # not observe "stopped" while on_run still executes.
        grace = 0.2
        while not task.done():
            task.cancel()
            await asyncio.wait([task], timeout=grace)
            # first re-cancel covers the swallow; after that, escalate the
            # grace so a worker legitimately mid-async-cleanup isn't hammered
            # with a fresh CancelledError every 200 ms
            grace = 1.0
        if self._task is task:
            self._task = None

    async def when_stopped(self) -> None:
        if self._task is not None:
            try:
                await asyncio.shield(self._task)
            except asyncio.CancelledError:
                pass
