"""Reactive state containers (SURVEY.md §2.1 State rows)."""
from .computed_state import ComputedState
from .delayer import FixedDelayer, UpdateDelayer
from .factory import StateFactory
from .mutable import MutableState
from .state import State, StateBoundComputed, StateSnapshot

__all__ = [
    "ComputedState",
    "FixedDelayer",
    "UpdateDelayer",
    "StateFactory",
    "MutableState",
    "State",
    "StateBoundComputed",
    "StateSnapshot",
]
