"""Handler/filter declaration + resolution.

Re-expression of src/Stl.CommandR/Configuration/ — ``[CommandHandler]`` /
``[CommandFilter]`` attributes, priority-sorted chains, and
``CommandHandlerResolver``. Handlers attach to command types; filters wrap
them ordered by priority (higher runs earlier). The operations framework
registers its pipeline as filters at the reference's priority constants
(Operations/Internal/FusionOperationsCommandHandlerPriority.cs).
"""
from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Type

__all__ = [
    "command_handler",
    "command_filter",
    "HandlerRegistry",
    "CommandHandler",
]


@dataclass(frozen=True)
class CommandHandler:
    command_type: Type
    fn: Callable  # async (command, context) -> result
    priority: int = 0
    is_filter: bool = False
    name: str = ""


def command_handler(fn: Optional[Callable] = None, *, priority: int = 0):
    """Marks an async method as the final handler for its command type.

    The command type is taken from the first parameter annotation:

        @command_handler
        async def edit(self, command: EditCommand): ...
    """

    def decorate(func: Callable) -> Callable:
        func.__command_handler__ = {"priority": priority, "is_filter": False}  # type: ignore[attr-defined]
        return func

    return decorate(fn) if fn is not None else decorate


def command_filter(fn: Optional[Callable] = None, *, priority: int = 0):
    """Marks an async method as a filter: it receives (command, context) and
    must call ``await context.invoke_remaining_handlers()`` to continue."""

    def decorate(func: Callable) -> Callable:
        func.__command_handler__ = {"priority": priority, "is_filter": True}  # type: ignore[attr-defined]
        return func

    return decorate(fn) if fn is not None else decorate


def _command_type_of(fn: Callable) -> Type:
    sig = inspect.signature(fn)
    params = [p for p in sig.parameters.values() if p.name not in ("self", "context", "ctx")]
    if not params:
        raise TypeError(f"{fn.__qualname__}: command handlers need a command parameter")
    ann = params[0].annotation
    if isinstance(ann, str):
        # `from __future__ import annotations` stringifies annotations
        import typing

        try:
            hints = typing.get_type_hints(fn)
            ann = hints.get(params[0].name, ann)
        except Exception:  # noqa: BLE001
            pass
    if ann is inspect.Parameter.empty or not isinstance(ann, type):
        raise TypeError(
            f"{fn.__qualname__}: the command parameter must be annotated with the command type"
        )
    return ann


class HandlerRegistry:
    """command type → sorted handler chain (filters desc by priority, then
    the single final handler)."""

    def __init__(self):
        self._handlers: Dict[Type, List[CommandHandler]] = {}
        self._generic_filters: List[CommandHandler] = []

    def add(self, handler: CommandHandler) -> None:
        if handler.command_type is object and handler.is_filter:
            self._generic_filters.append(handler)
        else:
            self._handlers.setdefault(handler.command_type, []).append(handler)

    def add_function(
        self,
        fn: Callable,
        command_type: Optional[Type] = None,
        priority: int = 0,
        is_filter: bool = False,
    ) -> None:
        ct = command_type or _command_type_of(fn)
        self.add(CommandHandler(ct, fn, priority, is_filter, getattr(fn, "__qualname__", str(fn))))

    def add_service(self, service: Any) -> List[CommandHandler]:
        """Scan a service instance for @command_handler/@command_filter
        methods (≈ attribute-scanning handler registration)."""
        added = []
        for name in dir(type(service)):
            attr = getattr(type(service), name, None)
            meta = getattr(attr, "__command_handler__", None)
            if meta is None:
                continue
            bound = getattr(service, name)
            ct = _command_type_of(attr)
            h = CommandHandler(ct, _adapt(bound), meta["priority"], meta["is_filter"], attr.__qualname__)
            self.add(h)
            added.append(h)
        return added

    def resolve(self, command: Any) -> List[CommandHandler]:
        """Full chain for a command: filters (priority desc) then the final
        handler. Raises if zero or multiple final handlers match."""
        matching: List[CommandHandler] = list(self._generic_filters)
        for klass in type(command).__mro__:
            matching.extend(self._handlers.get(klass, ()))
        filters = sorted((h for h in matching if h.is_filter), key=lambda h: -h.priority)
        finals = [h for h in matching if not h.is_filter]
        if not finals:
            raise LookupError(f"no handler registered for {type(command).__name__}")
        if len(finals) > 1:
            finals.sort(key=lambda h: -h.priority)
            finals = finals[:1]
        return filters + finals


def _adapt(bound: Callable) -> Callable:
    """Let handlers declare (command) or (command, context)."""
    sig = inspect.signature(bound)
    takes_context = len(sig.parameters) >= 2

    @functools.wraps(bound)
    async def call(command, context):
        if takes_context:
            return await bound(command, context)
        return await bound(command)

    return call
