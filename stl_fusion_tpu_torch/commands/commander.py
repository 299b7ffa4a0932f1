"""Commander — resolves a command's handler chain and runs it.

Re-expression of src/Stl.CommandR/Internal/Commander.cs:18-95 + the
CommanderBuilder wiring. The operations pipeline (stl_fusion_tpu_torch.operations)
installs itself as filters on this commander, so every top-level command
automatically becomes a completed operation whose replay drives invalidation.
"""
from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Any, Callable, List, Optional, Type

from .context import CommandContext
from .handlers import HandlerRegistry, _adapt

if TYPE_CHECKING:
    from ..core.hub import FusionHub

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["Commander", "LocalCommand"]


class Commander:
    def __init__(self, hub: "FusionHub"):
        self.hub = hub
        self.registry = HandlerRegistry()
        self._operations_attached = False
        # local lambda commands need no registration
        self.registry.add_function(
            _run_local_command, command_type=LocalCommand, is_filter=False
        )

    # -- registration ------------------------------------------------------
    def add_service(self, service: Any) -> Any:
        self.registry.add_service(service)
        return service

    def add_handler(
        self,
        fn: Callable,
        command_type: Optional[Type] = None,
        priority: int = 0,
        is_filter: bool = False,
    ) -> None:
        self.registry.add_function(_adapt(fn), command_type, priority, is_filter)

    def attach_operations_pipeline(self) -> None:
        """Install the operations framework filters (idempotent)."""
        if self._operations_attached:
            return
        from ..operations.pipeline import attach_operations

        attach_operations(self)
        self._operations_attached = True

    # -- execution ---------------------------------------------------------
    async def call(self, command: Any) -> Any:
        """Run a command through filters + final handler and return its result
        (≈ Commander.Call / RunCommand, Internal/Commander.cs:30)."""
        chain = [h.fn for h in self.registry.resolve(command)]
        context = CommandContext(command, self, chain)
        with context:
            return await context.invoke_remaining_handlers()

    async def run(self, command: Any) -> CommandContext:
        chain = [h.fn for h in self.registry.resolve(command)]
        context = CommandContext(command, self, chain)
        with context:
            await context.invoke_remaining_handlers()
        return context


class LocalCommand:
    """A lambda command (≈ src/Stl.CommandR/Commands/LocalCommand.cs)."""

    def __init__(self, fn, name: str = "local"):
        self.fn = fn
        self.name = name

    def __repr__(self) -> str:
        return f"LocalCommand({self.name})"


async def _run_local_command(command: LocalCommand, context: CommandContext):
    return await command.fn()
