"""MutableState<T> — a settable leaf/source node of the dependency graph.

Re-expression of src/Stl.Fusion/State/MutableState.cs:14-175: ``set`` stores
the next output and invalidates the current computed; recomputation completes
synchronously (the new value is already known), so ``state.value`` is correct
immediately after ``set`` — the reference's "Update must complete
synchronously" rule (MutableState.cs:107-117).
"""
from __future__ import annotations

import threading
from typing import Generic, Optional, TypeVar, Union

from ..core.hub import FusionHub
from ..core.options import ComputedOptions
from ..utils.result import Result
from .state import State, StateBoundComputed

T = TypeVar("T")

__all__ = ["MutableState"]


class MutableState(State, Generic[T]):
    __slots__ = ("_next_output", "_set_lock")

    def __init__(
        self,
        initial: Union[T, Result] = None,
        hub: Optional[FusionHub] = None,
        options: Optional[ComputedOptions] = None,
        name: str = "mutable",
    ):
        super().__init__(hub, options, name)
        self._set_lock = threading.Lock()
        self._next_output: Result = initial if isinstance(initial, Result) else Result.ok(initial)
        self._produce_sync()  # initial snapshot exists immediately

    async def compute(self) -> T:
        return self._next_output.value

    # ------------------------------------------------------------------ set
    def set(self, value: Union[T, Result]) -> None:
        """Store the next output and swap the computed synchronously;
        the invalidation wave through dependents fires inside this call."""
        output = value if isinstance(value, Result) else Result.ok(value)
        with self._set_lock:
            self._next_output = output
            old = self._snapshot.computed if self._snapshot is not None else None
            self._produce_sync()
        if old is not None:
            old.invalidate(immediately=True)

    def set_error(self, exc: BaseException) -> None:
        self.set(Result.err(exc))

    def _produce_sync(self) -> None:
        fn = self._function
        hub = fn.hub
        prev = self._snapshot.computed if self._snapshot is not None else None
        version = hub.version_generator.next(prev.version if prev is not None else None)
        computed = StateBoundComputed(self, version, fn.options)
        computed.try_set_output(self._next_output)
        hub.registry.register(computed)
        computed.renew_timeouts(True)
        self._apply_new_computed(computed)
