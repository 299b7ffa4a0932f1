"""State<T> — a named slot producing versioned snapshots over time.

Re-expression of src/Stl.Fusion/State/State.cs:38-358 + StateSnapshot.cs +
StateBoundComputed.cs. A State is simultaneously a ComputedInput (its own
cache key) and the function that computes it; each (re)computation yields a
``StateBoundComputed`` the state pins strongly in its current
``StateSnapshot``. Snapshots count updates/errors/retries and expose
``last_non_error_computed`` so UIs can keep showing the last good value
through transient failures.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Callable, Generic, List, Optional, TypeVar

from ..core.computed import Computed
from ..core.context import ComputeContext, get_current
from ..core.function import FunctionBase
from ..core.hub import FusionHub, default_hub
from ..core.inputs import ComputedInput
from ..core.options import ComputedOptions
from ..utils.async_utils import AsyncEvent
from ..utils.result import Result

T = TypeVar("T")
log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["State", "StateSnapshot", "StateBoundComputed"]


class StateBoundComputed(Computed, Generic[T]):
    """A computed owned by a State; invalidation pings the state
    (reference: State/StateBoundComputed.cs)."""

    __slots__ = ("state",)

    def __init__(self, state: "State", version, options):
        super().__init__(state, version, options)
        self.state = state
        self.on_invalidated(state._on_computed_invalidated)


class StateSnapshot(Generic[T]):
    """(computed, counters) — one observed version of the state
    (reference: State/StateSnapshot.cs:27-90)."""

    __slots__ = ("computed", "update_count", "error_count", "retry_count", "last_non_error_computed")

    def __init__(
        self,
        computed: Computed,
        prev: Optional["StateSnapshot"] = None,
    ):
        self.computed = computed
        if prev is None:
            self.update_count = 0
            self.error_count = 1 if computed.output.has_error else 0
            self.retry_count = 1 if computed.output.has_error else 0
            self.last_non_error_computed = computed if not computed.output.has_error else None
        else:
            has_error = computed.output.has_error
            self.update_count = prev.update_count + 1
            self.error_count = prev.error_count + (1 if has_error else 0)
            self.retry_count = prev.retry_count + 1 if has_error else 0
            self.last_non_error_computed = (
                computed if not has_error else prev.last_non_error_computed
            )

    @property
    def is_initial(self) -> bool:
        return self.update_count == 0

    def __repr__(self) -> str:
        return f"StateSnapshot(#{self.update_count}, {self.computed!r})"


class _StateFunction(FunctionBase):
    def __init__(self, hub: FusionHub, state: "State", options: Optional[ComputedOptions]):
        super().__init__(hub, options)
        self.state = state

    def create_computed(self, input, version):
        return StateBoundComputed(self.state, version, self.options)

    async def produce_value(self, input, computed):
        return await self.state.compute()

    def _use_new(self, computed, context, used_by):
        self.state._apply_new_computed(computed)
        super()._use_new(computed, context, used_by)


class State(ComputedInput, Generic[T]):
    """Abstract state; subclasses implement ``compute``."""

    __slots__ = (
        "_function",
        "_snapshot",
        "_snapshot_event",
        "name",
        "invalidated_handlers",
        "updated_handlers",
    )

    def __init__(
        self,
        hub: Optional[FusionHub] = None,
        options: Optional[ComputedOptions] = None,
        name: str = "state",
    ):
        self.name = name
        self._function = _StateFunction(hub or default_hub(), self, options)
        self._snapshot: Optional[StateSnapshot] = None
        self._snapshot_event: Optional[AsyncEvent[StateSnapshot]] = None
        self.invalidated_handlers: List[Callable[["State"], None]] = []
        self.updated_handlers: List[Callable[["State"], None]] = []
        self._hash = hash((id(self), name))

    # -- ComputedInput -----------------------------------------------------
    @property
    def function(self) -> FunctionBase:
        return self._function

    def __eq__(self, other: object) -> bool:
        return other is self

    def __hash__(self) -> int:
        return self._hash

    # -- user computation --------------------------------------------------
    async def compute(self) -> T:
        raise NotImplementedError

    # -- snapshot plumbing -------------------------------------------------
    def _apply_new_computed(self, computed: Computed) -> None:
        prev = self._snapshot
        snap = StateSnapshot(computed, prev)
        self._snapshot = snap
        if self._snapshot_event is None:
            self._snapshot_event = AsyncEvent(snap)
        else:
            self._snapshot_event = self._snapshot_event.create_next(snap)
        for h in self.updated_handlers:
            try:
                h(self)
            except Exception:  # noqa: BLE001
                log.exception("state updated handler failed")

    def _on_computed_invalidated(self, computed: Computed) -> None:
        if self._snapshot is not None and self._snapshot.computed is computed:
            for h in self.invalidated_handlers:
                try:
                    h(self)
                except Exception:  # noqa: BLE001
                    log.exception("state invalidated handler failed")

    # -- accessors ---------------------------------------------------------
    @property
    def snapshot(self) -> StateSnapshot:
        if self._snapshot is None:
            raise RuntimeError(f"State {self.name!r} has no snapshot yet — await update() first")
        return self._snapshot

    @property
    def computed(self) -> Computed:
        return self.snapshot.computed

    @property
    def value(self) -> T:
        return self.snapshot.computed.output.value

    @property
    def value_or_default(self) -> Optional[T]:
        out = self.snapshot.computed._output
        return out.value_or_default if out is not None else None

    @property
    def error(self) -> Optional[BaseException]:
        return self.snapshot.computed.error

    @property
    def last_non_error_value(self) -> Optional[T]:
        lc = self.snapshot.last_non_error_computed
        return lc.output.value if lc is not None else None

    # -- operations --------------------------------------------------------
    async def update(self) -> Computed:
        """Latest consistent computed (recompute if invalidated)."""
        return await self._function.invoke(self, used_by=None, context=ComputeContext.DEFAULT)

    async def recompute(self) -> Computed:
        c = self._snapshot.computed if self._snapshot is not None else None
        if c is not None and c.is_consistent:
            c.invalidate(immediately=True)
        return await self.update()

    async def use(self) -> T:
        """Value with dependency registration — states compose into compute
        methods like any other node."""
        computed = await self._function.invoke(self, used_by=get_current(), context=ComputeContext.current())
        return computed.output.value

    async def when_invalidated(self) -> None:
        c = (await self.update())
        await c.when_invalidated()

    async def when_updated(self) -> StateSnapshot:
        ev = self._snapshot_event
        if ev is None:
            await self.update()
            return self.snapshot
        nxt = await ev.latest().when_next()
        return nxt.value

    async def when(self, predicate: Callable[[T], bool]) -> Computed:
        computed = await self.update()
        return await computed.when(predicate)

    async def changes(self) -> AsyncIterator[Computed]:
        computed = await self.update()
        async for c in computed.changes():
            yield c

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"
