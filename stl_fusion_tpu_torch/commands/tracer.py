"""CommandTracer — tracing filter for the command pipeline.

Re-expression of src/Stl.CommandR/Diagnostics/CommandTracer.cs: a high-
priority command filter that wraps the rest of the handler chain in an
activity span tagged with the command type, records duration, and logs
errors for top-level commands.
"""
from __future__ import annotations

import logging
from typing import TYPE_CHECKING

from ..diagnostics.tracing import get_activity_source

if TYPE_CHECKING:
    from .commander import Commander

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["CommandTracer", "attach_command_tracer"]

# runs outside every operations-framework filter (they sit in the 1000s,
# matching FusionOperationsCommandHandlerPriority's ordering)
COMMAND_TRACER_PRIORITY = 100_000


class CommandTracer:
    def __init__(self, error_log_level: int = logging.ERROR):
        self.source = get_activity_source("stl_fusion_tpu_torch.commands")
        self.error_log_level = error_log_level

    async def __call__(self, command, context):
        name = f"run:{type(command).__name__}"
        with self.source.span(name, command=repr(command)[:200], top_level=context.outer is None) as span:
            try:
                return await context.invoke_remaining_handlers()
            except Exception as e:
                span.set_tag("error_type", type(e).__name__)
                if context.outer is None:
                    log.log(self.error_log_level, "command %s failed: %s", type(command).__name__, e)
                raise


def attach_command_tracer(commander: "Commander", tracer: CommandTracer = None) -> CommandTracer:
    tracer = tracer or CommandTracer()
    commander.add_handler(tracer, command_type=object, priority=COMMAND_TRACER_PRIORITY, is_filter=True)
    return tracer
