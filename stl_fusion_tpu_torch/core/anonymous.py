"""AnonymousComputedSource — lambda-backed computed values, no service needed.

Re-expression of src/Stl.Fusion/AnonymousComputedSource.cs:13-80: the source
is simultaneously the ComputedInput (its own cache key) and the function that
computes it. Used directly and as the building block for State<T>.
"""
from __future__ import annotations

from typing import Awaitable, Callable, Generic, Optional, TypeVar

from .computed import Computed
from .context import ComputeContext, get_current
from .function import FunctionBase
from .hub import FusionHub, default_hub
from .inputs import ComputedInput
from .options import ComputedOptions

T = TypeVar("T")

__all__ = ["AnonymousComputedSource"]


class AnonymousComputedSource(ComputedInput, Generic[T]):
    __slots__ = ("_function", "computer", "name")

    def __init__(
        self,
        computer: Callable[["AnonymousComputedSource"], Awaitable[T]],
        hub: Optional[FusionHub] = None,
        options: Optional[ComputedOptions] = None,
        name: str = "anonymous",
    ):
        self.computer = computer
        self.name = name
        self._function = _AnonymousFunction(hub or default_hub(), self, options)
        self._hash = hash((id(self), name))

    @property
    def function(self) -> "FunctionBase":
        return self._function

    # identity key: each source is its own slot
    def __eq__(self, other: object) -> bool:
        return other is self

    def __hash__(self) -> int:
        return self._hash

    async def use(self) -> T:
        """Value with dependency registration on the ambient computing node."""
        computed = await self._function.invoke(self, used_by=get_current(), context=ComputeContext.current())
        return computed.output.value

    async def update(self) -> Computed[T]:
        return await self._function.invoke(self, used_by=None, context=ComputeContext.DEFAULT)

    @property
    def computed(self) -> Optional[Computed[T]]:
        return self.get_existing_computed()

    def invalidate(self) -> None:
        c = self.get_existing_computed()
        if c is not None:
            c.invalidate(immediately=True)

    def __repr__(self) -> str:
        return f"AnonymousComputedSource({self.name})"


class _AnonymousFunction(FunctionBase):
    def __init__(self, hub: FusionHub, source: AnonymousComputedSource, options: Optional[ComputedOptions]):
        super().__init__(hub, options)
        self.source = source

    async def produce_value(self, input, computed):
        return await self.source.computer(self.source)
