"""CommandR — the CQRS command pipeline (SURVEY.md §2.3)."""
from .cluster_commander import (
    ClusterCommander,
    ClusterCommanderFacade,
    CommandEnvelope,
    expose_cluster_commander,
)
from .commander import Commander, LocalCommand
from .context import CommandContext, current_command_context
from .handlers import CommandHandler, HandlerRegistry, command_filter, command_handler
from .rpc_bridge import COMMANDER_SERVICE, CommanderFacade, bridge_commands, expose_commander
from .tracer import CommandTracer, attach_command_tracer

__all__ = [
    "COMMANDER_SERVICE",
    "ClusterCommander",
    "ClusterCommanderFacade",
    "CommandEnvelope",
    "expose_cluster_commander",
    "CommanderFacade",
    "bridge_commands",
    "expose_commander",
    "CommandTracer",
    "attach_command_tracer",
    "Commander",
    "LocalCommand",
    "CommandContext",
    "current_command_context",
    "CommandHandler",
    "HandlerRegistry",
    "command_filter",
    "command_handler",
]
