"""CommandContext — per-invocation execution state of the command pipeline.

Re-expression of src/Stl.CommandR/CommandContext.cs:6-80: nested contexts
(outer/outermost), the remaining-handler chain (ExecutionState), an Items
bag filters communicate through, and ambient access via contextvar (the
reference's AsyncLocal).
"""
from __future__ import annotations

import contextvars
from typing import TYPE_CHECKING, Any, Callable, List, Optional

from ..utils.collections import OptionSet

if TYPE_CHECKING:
    from .commander import Commander

__all__ = ["CommandContext", "current_command_context"]

_current: contextvars.ContextVar[Optional["CommandContext"]] = contextvars.ContextVar(
    "fusion_command_context", default=None
)


def current_command_context() -> Optional["CommandContext"]:
    return _current.get()


class CommandContext:
    __slots__ = ("command", "commander", "outer", "items", "_chain", "_index", "result", "_token")

    def __init__(self, command: Any, commander: "Commander", chain: List[Callable]):
        self.command = command
        self.commander = commander
        self.outer = _current.get()
        self.items: OptionSet = OptionSet()
        self._chain = chain
        self._index = 0
        self.result: Any = None
        self._token = None

    @property
    def is_outermost(self) -> bool:
        return self.outer is None

    @property
    def outermost(self) -> "CommandContext":
        ctx = self
        while ctx.outer is not None:
            ctx = ctx.outer
        return ctx

    async def invoke_remaining_handlers(self) -> Any:
        """Run the rest of the chain; a filter calls this to continue
        (≈ ExecutionState advance, Internal/Commander.cs:18-95)."""
        if self._index >= len(self._chain):
            return self.result
        handler = self._chain[self._index]
        self._index += 1
        self.result = await handler(self.command, self)
        return self.result

    def __enter__(self):
        self._token = _current.set(self)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        return False

    def __repr__(self) -> str:
        return f"CommandContext({type(self.command).__name__}, outermost={self.is_outermost})"
