"""UIActionTracker + UICommander — instant-update windows after user actions.

Re-expression of src/Stl.Fusion/UI/ — UIActionTracker.cs:3-60 and
UICommander.cs: when the user triggers a command, states watching through an
UpdateDelayer skip their debounce (the "instant updates right after my own
action" UX rule). The tracker counts running actions and exposes awaitable
action/result events.
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Optional

from ..utils.async_utils import AsyncEvent

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["UIActionTracker", "UICommander", "UIActionFailureTracker"]


class UIActionTracker:
    def __init__(self, instant_update_period: float = 0.3):
        self.instant_update_period = instant_update_period
        self.running_action_count = 0
        self._action_event: AsyncEvent = AsyncEvent(None)
        self._result_event: AsyncEvent = AsyncEvent(None)
        self._last_action_at: float = 0.0
        #: sync listeners ``(command, error) -> None`` fired on completion
        self.on_completed: list = []

    @property
    def are_instant_updates_enabled(self) -> bool:
        if self.running_action_count > 0:
            return True
        return (time.monotonic() - self._last_action_at) < self.instant_update_period

    def action_started(self, command: Any) -> None:
        self.running_action_count += 1
        self._last_action_at = time.monotonic()
        self._action_event = self._action_event.latest().create_next(command)

    def action_completed(self, command: Any, error: Optional[BaseException]) -> None:
        self.running_action_count = max(0, self.running_action_count - 1)
        self._last_action_at = time.monotonic()
        self._result_event = self._result_event.latest().create_next((command, error))
        for listener in list(self.on_completed):
            # a raising listener must not mask the command's real outcome
            # (action_completed runs in UICommander.call's finally) or
            # starve the remaining listeners
            try:
                listener(command, error)
            except Exception:
                log.exception("on_completed listener failed")

    async def when_action(self) -> Any:
        return (await self._action_event.latest().when_next()).value

    async def when_result(self) -> Any:
        return (await self._result_event.latest().when_next()).value


class UICommander:
    """Commander facade that reports into the action tracker."""

    def __init__(self, commander, tracker: Optional[UIActionTracker] = None):
        self.commander = commander
        self.tracker = tracker or UIActionTracker()

    async def call(self, command: Any) -> Any:
        self.tracker.action_started(command)
        error: Optional[BaseException] = None
        try:
            return await self.commander.call(command)
        except BaseException as e:
            error = e
            raise
        finally:
            self.tracker.action_completed(command, error)


class UIActionFailureTracker:
    """Bounded list of recent failed UI actions (≈ UI/UIActionFailureTracker
    in the reference): UIs bind it to render error toasts/banners; entries
    clear individually (user dismissed) or wholesale (navigation)."""

    def __init__(self, tracker: UIActionTracker, max_failures: int = 16):
        self.tracker = tracker
        self.max_failures = max_failures
        self.failures: list = []  # (command, error) newest-last
        self._listeners: list = []
        tracker.on_completed.append(self._on_completed)

    def _on_completed(self, command, error) -> None:
        if error is None:
            return
        self.failures.append((command, error))
        del self.failures[: max(0, len(self.failures) - self.max_failures)]
        for listener in list(self._listeners):
            try:
                listener(command, error)
            except Exception:
                log.exception("on_failure listener failed")

    def on_failure(self, listener) -> None:
        self._listeners.append(listener)

    def dismiss(self, index: int) -> None:
        if 0 <= index < len(self.failures):
            del self.failures[index]

    def clear(self) -> None:
        self.failures.clear()

    def __len__(self) -> int:
        return len(self.failures)
