"""StateFactory — hub-bound construction of states
(≈ src/Stl.Fusion/State/StateFactory.cs, registered FusionBuilder.cs:68-72)."""
from __future__ import annotations

from typing import Awaitable, Callable, Optional, TypeVar, Union

from ..core.hub import FusionHub, default_hub
from ..core.options import ComputedOptions
from ..utils.result import Result
from .computed_state import ComputedState
from .delayer import UpdateDelayer
from .mutable import MutableState

T = TypeVar("T")

__all__ = ["StateFactory"]


class StateFactory:
    def __init__(self, hub: Optional[FusionHub] = None):
        self.hub = hub or default_hub()

    def new_mutable(
        self,
        initial: Union[T, Result] = None,
        options: Optional[ComputedOptions] = None,
        name: str = "mutable",
    ) -> MutableState:
        return MutableState(initial, self.hub, options, name)

    def new_computed(
        self,
        computer: Callable[[], Awaitable[T]],
        options: Optional[ComputedOptions] = None,
        update_delayer: Optional[UpdateDelayer] = None,
        name: str = "computed-state",
        start: bool = True,
    ) -> ComputedState:
        state = ComputedState(computer, self.hub, options, update_delayer, name)
        if start:
            state.start()
        return state
