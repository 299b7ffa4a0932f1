"""UpdateDelayer / FixedDelayer — debounce + retry backoff for state updates.

Re-expression of src/Stl.Fusion/State/UpdateDelayer.cs:10-79 and
FixedDelayer.cs. The delay between "invalidated" and "recompute" is the
reactive system's batching knob; a UIActionTracker can cut it short right
after a user action (the instant-update window).
"""
from __future__ import annotations

import asyncio
from typing import Optional

from ..utils.async_chain import RetryDelaySeq

__all__ = ["UpdateDelayer", "FixedDelayer"]


class UpdateDelayer:
    def __init__(
        self,
        update_delay: float = 0.0,
        retry_delays: Optional[RetryDelaySeq] = None,
        ui_action_tracker=None,
    ):
        self.update_delay = update_delay
        self.retry_delays = retry_delays or RetryDelaySeq(min_delay=0.5, max_delay=10.0)
        self.ui_action_tracker = ui_action_tracker

    async def delay(self, retry_count: int) -> None:
        d = self.update_delay if retry_count <= 0 else max(self.update_delay, self.retry_delays[retry_count])
        if d <= 0:
            await asyncio.sleep(0)
            return
        tracker = self.ui_action_tracker
        if tracker is None:
            await asyncio.sleep(d)
            return
        # an incoming UI action cancels the remaining delay (instant updates)
        cut = asyncio.ensure_future(tracker.when_action())
        sleep = asyncio.ensure_future(asyncio.sleep(d))
        try:
            await asyncio.wait({cut, sleep}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            cut.cancel()
            sleep.cancel()


class FixedDelayer(UpdateDelayer):
    """Fixed debounce; ``FixedDelayer.ZERO_UNSAFE`` = no delay at all."""

    ZERO_UNSAFE: "FixedDelayer"

    def __init__(self, update_delay: float):
        super().__init__(update_delay=update_delay)


FixedDelayer.ZERO_UNSAFE = FixedDelayer(0.0)
