"""ComputedState<T> — a self-updating state with a background update cycle.

Re-expression of src/Stl.Fusion/State/ComputedState.cs:24-132: a worker loops
``await invalidation → await delayer.delay(retry_count) → update()``. This is
the engine under every live UI fragment (the Blazor ComputedStateComponent in
the reference; LiveView-style components in the JAX package's ``ui``).
"""
from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Generic, Optional, TypeVar

from ..core.hub import FusionHub
from ..core.options import ComputedOptions
from ..utils.async_chain import WorkerBase
from .delayer import FixedDelayer, UpdateDelayer
from .state import State

T = TypeVar("T")

__all__ = ["ComputedState"]


class ComputedState(State, WorkerBase, Generic[T]):
    __slots__ = ("_computer", "update_delayer", "_worker_name", "_task", "_stop_requested")

    def __init__(
        self,
        computer: Callable[[], Awaitable[T]],
        hub: Optional[FusionHub] = None,
        options: Optional[ComputedOptions] = None,
        update_delayer: Optional[UpdateDelayer] = None,
        name: str = "computed-state",
    ):
        State.__init__(self, hub, options, name)
        WorkerBase.__init__(self, f"computed-state:{name}")
        self._computer = computer
        self.update_delayer = update_delayer or FixedDelayer.ZERO_UNSAFE

    async def compute(self) -> T:
        return await self._computer()

    # ------------------------------------------------------------------ cycle
    async def on_run(self) -> None:
        """The UpdateCycle (reference ComputedState.cs:89-110)."""
        computed = await self.update()
        while True:
            await computed.when_invalidated()
            retry_count = self.snapshot.retry_count
            await self.update_delayer.delay(retry_count)
            computed = await self.update()

    async def when_first_value(self):
        """Await the initial snapshot (started states compute eagerly)."""
        while self._snapshot is None:
            await asyncio.sleep(0.001)
        return self.snapshot

    async def dispose(self) -> None:
        await self.stop()
