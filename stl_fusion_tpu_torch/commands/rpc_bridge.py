"""Command calls over RPC — the client-side commander bridge.

Re-expression of the reference's command/RPC bridging: on the client, a
command type can be *bridged* so `commander.call(cmd)` forwards the command
over an RPC peer to the server's commander, which runs the full filter
pipeline there (operation scope → completion → invalidation replay). On the
wire this is a plain RPC call to a commander facade service; the reference
reaches the same shape via client proxies whose `[CommandHandler]` methods
are RPC calls plus `RpcOutboundCommandCallMiddleware`
(src/Stl.CommandR/Rpc/RpcOutboundCommandCallMiddleware.cs, client-mode
service registration FusionBuilder.cs:222-320). Keeping the local commander
as the single entry point preserves the reference idiom: samples call
`commander.Call(new Chat_Post(...))` identically on client and server
(samples/MiniRpc/Program.cs:52-56).
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Type

__all__ = ["COMMANDER_SERVICE", "CommanderFacade", "expose_commander", "bridge_commands"]

COMMANDER_SERVICE = "$commander"


class CommanderFacade:
    """Server-side RPC target: one method, `call(command)` → commander."""

    def __init__(self, commander):
        self.commander = commander

    async def call(self, command: Any) -> Any:
        return await self.commander.call(command)


def expose_commander(rpc_hub, commander, service: str = COMMANDER_SERVICE) -> CommanderFacade:
    """Publish a commander over RPC so remote clients can run commands."""
    facade = CommanderFacade(commander)
    rpc_hub.add_service(service, facade)
    return facade


def bridge_commands(
    commander,
    rpc_hub,
    command_types: Iterable[Type],
    peer_ref: Optional[str] = "default",
    service: str = COMMANDER_SERVICE,
    router=None,
) -> None:
    """Register final handlers forwarding the given command types over RPC.

    ``peer_ref=None`` routes each forwarded command through the hub's
    ``call_router`` (per-command sharding, as in the MultiServerRpc sample).
    Filters registered on the local commander (retry, tracing…) still wrap
    the forwarded call; only the final handler is remote.

    A forwarded command that comes back with a ``ShardMovedError`` applies
    the carried shard map to the router BEFORE the error surfaces (the
    same healing rule the batched read path follows): the
    pinned-peer path bypasses the hub's routed-retry healing entirely, so
    without this the caller's retry would land on the SAME stale owner.
    Counted as ``fusion_cmd_shard_retries_total``; ``router`` defaults to
    the hub's ``call_router`` when it knows how to ``note_moved``.
    """
    proxy = rpc_hub.client(service, peer_ref)
    if router is None:
        candidate = getattr(rpc_hub, "call_router", None)
        if hasattr(candidate, "note_moved"):
            router = candidate

    async def forward(command):
        from ..cluster.shard_map import ShardMovedError
        from ..diagnostics.metrics import global_metrics

        try:
            return await proxy.call(command)
        except ShardMovedError as e:
            if router is not None:
                router.note_moved(e)  # heal: the retry routes to the new owner
            global_metrics().counter(
                "fusion_cmd_shard_retries_total",
                help="bridged commands bounced by a moved shard whose carried "
                "map was applied before surfacing (retry lands on the new "
                "owner first try)",
            ).inc()
            raise

    for command_type in command_types:
        commander.add_handler(forward, command_type=command_type)
