"""LiveComponent — the ComputedStateComponent analogue for Python UIs.

Re-expression of src/Stl.Fusion.Blazor/Components/ —
StatefulComponentBase / ComputedStateComponent.cs:27-132 /
MixedStateComponent.cs, re-targeted from Blazor render trees to any Python
UI surface (server-rendered HTML over the RPC push channel, a TUI, a
websocket frontend): a component owns a ComputedState whose recomputations
drive ``render()``; parameter changes recompute only when the parameters
actually differ (the ParameterComparer rule).
"""
from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

from ..core.hub import FusionHub
from ..core.options import ComputedOptions
from ..state.computed_state import ComputedState
from ..state.delayer import FixedDelayer, UpdateDelayer
from ..state.mutable import MutableState

T = TypeVar("T")
log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["LiveComponent", "MixedStateComponent"]


class LiveComponent(Generic[T]):
    """Owns a ComputedState; re-renders on every consistent update.

    Subclasses implement ``compute_state()`` (the reactive read) and
    ``render(value)`` (the output side-effect: send HTML patch, redraw,
    notify websocket...).
    """

    def __init__(
        self,
        hub: Optional[FusionHub] = None,
        update_delayer: Optional[UpdateDelayer] = None,
        options: Optional[ComputedOptions] = None,
        name: Optional[str] = None,
    ):
        self._hub = hub
        self._delayer = update_delayer or FixedDelayer.ZERO_UNSAFE
        self._options = options
        self._name = name or type(self).__name__
        self.state: Optional[ComputedState] = None
        self.render_count = 0
        self.parameters: Dict[str, Any] = {}
        self._render_task: Optional[asyncio.Task] = None

    # -- lifecycle ---------------------------------------------------------
    def mount(self) -> "LiveComponent":
        self.state = ComputedState(
            self.compute_state,
            self._hub,
            self._options,
            self._delayer,
            name=f"component:{self._name}",
        )
        self.state.updated_handlers.append(self._on_updated)
        self.state.start()
        return self

    async def unmount(self) -> None:
        if self.state is not None:
            await self.state.dispose()
            self.state = None

    # -- parameters (ParameterComparer semantics) -------------------------
    async def set_parameters(self, **params: Any) -> None:
        """Recompute ONLY if a parameter actually changed
        (≈ ComponentInfo.ShouldSetParameters)."""
        changed = any(self.parameters.get(k) != v for k, v in params.items())
        self.parameters.update(params)
        if changed and self.state is not None:
            await self.state.recompute()

    # -- reactive read + render -------------------------------------------
    async def compute_state(self) -> T:
        raise NotImplementedError

    def render(self, value: T) -> None:
        raise NotImplementedError

    def render_error(self, error: BaseException) -> None:
        log.debug("%s render error: %s", self._name, error)

    def _on_updated(self, state) -> None:
        self.render_count += 1
        out = state.snapshot.computed._output
        if out is None:
            return
        try:
            if out.has_error:
                self.render_error(out.error)
            else:
                self.render(out.value)
        except Exception:  # noqa: BLE001
            log.exception("%s render failed", self._name)

    async def when_rendered(self, min_count: int = 1, timeout: float = 5.0) -> None:
        async def wait():
            while self.render_count < min_count:
                await asyncio.sleep(0.005)

        await asyncio.wait_for(wait(), timeout)


class MixedStateComponent(LiveComponent[T]):
    """LiveComponent + a MutableState input (≈ MixedStateComponent.cs):
    local user input that recomputes the view state when set."""

    def __init__(self, initial_input: Any = None, **kwargs):
        super().__init__(**kwargs)
        self.mutable_state: MutableState = MutableState(initial_input, kwargs.get("hub"))

    def set_input(self, value: Any) -> None:
        self.mutable_state.set(value)
