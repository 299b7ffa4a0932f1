"""ComputedInput — the cache key of a computed node.

Re-expression of src/Stl.Fusion/ComputedInput.cs:5-40 and
Interception/ComputeMethodInput.cs. An input identifies one memoization
slot: (function, service instance, normalized arguments). Inputs are
hashable, compare by value, and resolve their live node through the
registry (``get_existing_computed``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional, Tuple

if TYPE_CHECKING:
    from .computed import Computed
    from .function import FunctionBase

__all__ = ["ComputedInput", "ComputeMethodInput", "KwArgsTail"]


class KwArgsTail:
    """Canonical keyword-argument tail of a cache key. Methods whose
    signature cannot be replayed positionally (keyword-only params, ``*``/
    ``**`` catch-alls) normalize to ``(*positional, KwArgsTail(sorted
    kwargs))`` — hashable, order-canonical, and replayable by
    :meth:`ComputeMethodInput.invoke_original` (a flat positional tuple
    would TypeError on replay)."""

    __slots__ = ("items",)

    def __init__(self, items: Tuple):
        self.items = tuple(items)

    def __eq__(self, other: object) -> bool:
        return type(other) is KwArgsTail and self.items == other.items

    def __hash__(self) -> int:
        return hash(self.items)

    def __repr__(self) -> str:
        return f"**{dict(self.items)!r}"


class ComputedInput:
    """Abstract cache key; subclasses define equality/hash."""

    __slots__ = ("_hash",)

    @property
    def function(self) -> "FunctionBase":
        raise NotImplementedError

    def get_existing_computed(self) -> Optional["Computed"]:
        return self.function.hub.registry.get(self)

    def __hash__(self) -> int:
        return self._hash


class ComputeMethodInput(ComputedInput):
    """(method, service instance, args) — equality skips nothing because the
    decorator already strips non-key args (reference skips CancellationToken,
    ComputeMethodInput.cs:20-23)."""

    __slots__ = ("method_def", "service", "args", "_function")

    def __init__(self, method_def, service: Any, args: Tuple, function=None):
        self.method_def = method_def
        self.service = service
        self.args = args
        self._hash = hash((id(method_def), id(service), args))
        self._function = function

    @property
    def function(self) -> "FunctionBase":
        fn = self._function
        if fn is None:
            fn = self._function = self.method_def.get_function(self.service)
        return fn

    async def invoke_original(self):
        """Call the user's method body (≈ InvokeOriginalFunction,
        ComputeMethodInput.cs:32-45). A :class:`KwArgsTail` key tail —
        produced by bind_args for signatures that cannot be replayed
        positionally — is expanded back into keyword arguments."""
        args = self.args
        if args and type(args[-1]) is KwArgsTail:
            return await self.method_def.original(
                self.service, *args[:-1], **dict(args[-1].items)
            )
        return await self.method_def.original(self.service, *args)

    def __eq__(self, other: object) -> bool:
        return (
            type(other) is ComputeMethodInput
            and self.method_def is other.method_def  # type: ignore[union-attr]
            and self.service is other.service  # type: ignore[union-attr]
            and self.args == other.args  # type: ignore[union-attr]
        )

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        name = getattr(self.method_def, "name", "?")
        return f"{type(self.service).__name__}.{name}{self.args!r}"


def _register_kwargs_tail_wire() -> None:
    """KwArgsTail keys appear inside checkpointed node args (checkpoint/
    stores ``input.args`` verbatim), so they must round-trip the wire."""
    from ..utils.serialization import deep_tuple, register_wire_type

    register_wire_type(
        KwArgsTail,
        "KwArgsTail",
        to_dict=lambda v: {"i": [list(item) for item in v.items]},
        # key values must re-tuple DEEPLY or the restored key is
        # unhashable
        from_dict=lambda d: KwArgsTail((k, deep_tuple(val)) for k, val in d["i"]),
    )


_register_kwargs_tail_wire()
