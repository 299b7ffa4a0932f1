"""ShardMapRouter — epoch-stamped call routing + the server-side fence.

The client half and the server half of one protocol:

- :class:`ShardMapRouter` installs as ``RpcHub.call_router`` (it is
  callable with the classic ``(service, method, args) -> ref`` signature)
  and additionally exposes ``route()`` — the header-stamping variant the
  hub/client layers prefer: every routed call carries ``@shard`` (the
  key's virtual shard) and ``@epoch`` (the client's map epoch), plus
  ``@failover`` when a read was deliberately sent to the shard's replica
  because the owner is unreachable (breaker open, dial backoff, or
  terminated). Commands/mutations NEVER fail over — a write accepted by a
  non-owner is a split brain; they fail fast with
  :class:`~.shard_map.ShardMovedError` instead.
- :func:`install_cluster_guard` appends an inbound middleware on a member's
  hub that REJECTS calls whose ``@shard`` this member does not own under
  its current map (``@failover`` widens acceptance to the replica). The
  rejection is a normal ``$sys.error`` reply carrying a ``ShardMovedError``
  with the member's current map — the client applies it and retries once
  (bounded), which is the client's lazy map-sync path: no subscription
  needed, staleness self-corrects on first contact. A client stamping a
  NEWER epoch than ours is let through: it routed here per a map we have
  not learned yet, and per that map we are the owner.

Routing keys: the shard of a call is derived from ``repr(args[key_arg])``
(matching the historic ``consistent_hash_router`` contract); command
envelopes route by their payload's ``shard_key()``/first field when the
argument is a registered command (see ``key_for``).
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

from ..diagnostics.hotkeys import global_hotkeys
from ..diagnostics.metrics import global_metrics
from ..rpc.message import (
    COMPUTE_SYSTEM_SERVICE,
    DIAG_SYSTEM_SERVICE,
    MEMBER_SYSTEM_SERVICE,
    SYSTEM_SERVICE,
    TABLE_SYSTEM_SERVICE,
    RpcMessage,
)
from ..utils.errors import ExceptionInfo
from ..utils.serialization import dumps
from .shard_map import ShardMap, ShardMovedError

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "SHARD_HEADER",
    "EPOCH_HEADER",
    "FAILOVER_HEADER",
    "ShardMapRouter",
    "install_cluster_guard",
    "install_cluster_client",
]

SHARD_HEADER = "@shard"
EPOCH_HEADER = "@epoch"
FAILOVER_HEADER = "@failover"

#: the command-bridge RPC service name (commands/rpc_bridge.py) — imported
#: as a literal to keep this module cycle-free; commands always fail fast
#: on an unreachable owner instead of failing over
DEFAULT_COMMAND_SERVICES = ("$commander",)

_SYSTEM_SERVICES = frozenset(
    {
        SYSTEM_SERVICE,
        COMPUTE_SYSTEM_SERVICE,
        TABLE_SYSTEM_SERVICE,
        DIAG_SYSTEM_SERVICE,
        MEMBER_SYSTEM_SERVICE,
    }
)


class ShardMapRouter:
    """key → virtual shard → owner member, against a live epoch-versioned
    :class:`ShardMap`. Installable anywhere an ``RpcCallRouter`` fits."""

    def __init__(
        self,
        rpc_hub,
        members: Optional[List[str]] = None,
        shard_map: Optional[ShardMap] = None,
        key_arg: int = 0,
        n_shards: int = 256,
        command_services: Tuple[str, ...] = DEFAULT_COMMAND_SERVICES,
        key_fn: Optional[Callable[[str, str, tuple], str]] = None,
        failover_ttl: float = 2.0,
    ):
        if shard_map is None:
            if not members:
                raise ValueError("ShardMapRouter needs members or an explicit shard_map")
            shard_map = ShardMap.initial(members, n_shards=n_shards)
        self.rpc_hub = rpc_hub
        self.shard_map = shard_map
        self.key_arg = key_arg
        self.command_services = frozenset(command_services)
        self.key_fn = key_fn
        #: lifetime of a failover-served computed. The replica's ``$sys-c``
        #: subscription cannot see the owner's writes, and an owner that
        #: recovers WITHOUT an epoch change (outage shorter than the
        #: failure timeout) fences nothing — so failover reads must expire
        #: on a clock: the client layer schedules an invalidation this many
        #: seconds after serving one, and the re-read routes back to the
        #: owner. Sized to the membership failure timeout: outages longer
        #: than that evict the owner, and the reshard fence takes over.
        self.failover_ttl = failover_ttl
        #: callbacks ``(old_map, new_map)`` fired on every applied epoch —
        #: the rebalancer's trigger (cluster/rebalancer.py)
        self.on_map_change: List[Callable[[ShardMap, ShardMap], None]] = []
        # -- counters (collector-exported; report()["cluster"]) -----------
        self.routed_calls: Dict[str, int] = {}
        self.failover_reads = 0
        self.maps_applied = 0
        self.moved_rejections_seen = 0  # ShardMovedErrors whose map we applied
        global_metrics().register_collector(self, ShardMapRouter._collect_metrics)
        global_metrics().set_aggregation("fusion_shard_map_epoch", "max")

    def _collect_metrics(self) -> dict:
        out = {
            "fusion_shard_map_epoch": self.shard_map.epoch,
            "fusion_failover_reads_total": self.failover_reads,
            "fusion_shard_maps_applied_total": self.maps_applied,
            "fusion_routed_calls_total": sum(self.routed_calls.values()),
        }
        for peer, n in self.routed_calls.items():
            out[f'fusion_routed_calls_total{{peer="{peer}"}}'] = n
        return out

    # ------------------------------------------------------------------ keys
    def key_for(self, service: str, method: str, args: tuple) -> str:
        if self.key_fn is not None:
            return self.key_fn(service, method, args)
        if len(args) > self.key_arg:
            arg = args[self.key_arg]
            # command envelopes (the bridge forwards the command object as
            # arg0): route by the command's own shard key when it names one
            shard_key = getattr(arg, "shard_key", None)
            if callable(shard_key):
                return repr(shard_key())
            return repr(arg)
        return service

    def shard_for(self, service: str, method: str, args: tuple) -> int:
        return self.shard_map.shard_of(self.key_for(service, method, args))

    # ------------------------------------------------------------------ routing
    def _down(self, ref: str) -> bool:
        """Is the member unreachable RIGHT NOW, by signals the process
        already tracks: an open circuit breaker, a terminated peer, or a
        client peer sitting in dial-retry backoff (``reconnects_at`` is
        only ever set while the last dial has failed)."""
        peer = self.rpc_hub.peers.get(ref)
        if peer is None:
            return False  # never dialed: optimistically up
        breaker = getattr(peer, "breaker", None)
        if breaker is not None and breaker.state == "open":
            return True
        if peer.connection_state.latest().value.is_terminated:
            return True
        return getattr(peer, "reconnects_at", None) is not None

    def route(self, service: str, method: str, args: tuple) -> Tuple[str, tuple]:
        """``(peer_ref, headers)`` for one call. Raises ``ShardMovedError``
        for a command whose owner is unreachable (fail fast — never
        split-brain a write onto a replica)."""
        smap = self.shard_map
        shard = smap.shard_of(self.key_for(service, method, args))
        # attribution: per-shard routing pressure, plus the
        # shard|method sketch the straggler table joins against ("the
        # slow shard's hottest keys")
        board = global_hotkeys()
        board.offer("routed_shards", str(shard))
        board.offer("shard_keys", f"{shard}|{service}.{method}")
        # owner from the cached assignment table (O(1)); the rendezvous
        # re-sort in owners_for_shard stays off this per-call path
        owner = smap.owner_of_shard(shard)
        if owner is None:
            raise ShardMovedError(f"shard map epoch {smap.epoch} has no members")
        headers = ((SHARD_HEADER, str(shard)), (EPOCH_HEADER, str(smap.epoch)))
        if self._down(owner):
            if service in self.command_services:
                raise ShardMovedError(
                    f"owner {owner} of shard {shard} is unreachable; "
                    f"commands fail fast (no split-brain failover)",
                    shard_map=smap,
                )
            replica = smap.replica_of_shard(shard)
            if replica is not None and not self._down(replica):
                self.failover_reads += 1
                self.routed_calls[replica] = self.routed_calls.get(replica, 0) + 1
                return replica, headers + ((FAILOVER_HEADER, "1"),)
        self.routed_calls[owner] = self.routed_calls.get(owner, 0) + 1
        return owner, headers

    def headers_for(
        self, service: str, method: str, args: tuple, peer_ref: Optional[str] = None
    ) -> tuple:
        """Stamp headers for a call whose peer was ALREADY chosen (the
        per-peer FusionClients a RoutingComputeProxy caches): same shard +
        epoch stamp, plus ``@failover`` when the chosen peer is not the
        owner — the guard then accepts the replica."""
        smap = self.shard_map
        shard = smap.shard_of(self.key_for(service, method, args))
        headers = [(SHARD_HEADER, str(shard)), (EPOCH_HEADER, str(smap.epoch))]
        if peer_ref is not None and peer_ref != smap.owner_of_shard(shard):
            headers.append((FAILOVER_HEADER, "1"))
        return tuple(headers)

    def __call__(self, service: str, method: str, args: tuple) -> str:
        return self.route(service, method, args)[0]

    # ------------------------------------------------------------------ maps
    def apply_map(self, new_map: ShardMap) -> bool:
        """Adopt a newer epoch (older/equal epochs are ignored — epochs
        totally order maps). Fires ``on_map_change`` callbacks."""
        old = self.shard_map
        if new_map.epoch <= old.epoch:
            return False
        self.shard_map = new_map
        self.maps_applied += 1
        for cb in list(self.on_map_change):
            try:
                cb(old, new_map)
            except Exception:  # noqa: BLE001 — one bad listener never blocks the map
                log.exception("shard-map change callback failed")
        return True

    def apply_wire_map(self, wire: Optional[dict]) -> bool:
        if not wire:
            return False
        try:
            new_map = ShardMap.from_wire(wire)
        except (KeyError, ValueError, TypeError):
            return False
        return self.apply_map(new_map)

    def note_moved(self, error: ShardMovedError) -> bool:
        """Apply the map a rejection carried (the client's lazy sync)."""
        self.moved_rejections_seen += 1
        return self.apply_wire_map(error.map_wire)

    def snapshot(self) -> dict:
        smap = self.shard_map
        return {
            "epoch": smap.epoch,
            "members": list(smap.members),
            "n_shards": smap.n_shards,
            "coordinator": smap.coordinator,
            "routed_calls": dict(self.routed_calls),
            "failover_reads": self.failover_reads,
            "maps_applied": self.maps_applied,
            "moved_rejections_seen": self.moved_rejections_seen,
        }


# ---------------------------------------------------------------------- server


def install_cluster_guard(rpc_hub, member) -> Callable:
    """Append the shard-fence middleware on a member's hub: calls stamped
    with a ``@shard`` this member does not own (under ITS current map) are
    answered with a ``$sys.error`` carrying a ``ShardMovedError`` + the
    current map, and never dispatched. Unstamped calls and system frames
    pass through untouched (wire compat with cluster-unaware clients).
    Returns the middleware (callers may remove it to uninstall)."""

    async def guard(peer, message: RpcMessage, nxt):
        shard_h = message.header(SHARD_HEADER)
        if shard_h is None or message.service in _SYSTEM_SERVICES:
            await nxt(message)
            return
        smap = member.shard_map
        epoch_h = message.header(EPOCH_HEADER)
        try:
            shard = int(shard_h)
            client_epoch = int(epoch_h) if epoch_h is not None else -1
        except ValueError:
            await nxt(message)  # malformed stamp: treat as unstamped
            return
        if client_epoch > smap.epoch:
            # the client learned a map we have not: per THAT map it chose
            # us, and honoring it avoids a reject-retry livelock while the
            # coordinator's broadcast is in flight
            await nxt(message)
            return
        if client_epoch == smap.epoch:
            width = 2 if message.header(FAILOVER_HEADER) else 1
            if member.member_id in smap.owners_for_shard(shard, width):
                await nxt(message)
                return
        # stale epoch (client_epoch < ours) is rejected OUTRIGHT, even when
        # the stale map happens to agree on this shard's owner: the reject-
        # apply-retry round trip is the client's ONLY guaranteed map sync
        # (a client that connected after the last epoch change has nobody
        # pushing maps to it until the next change) — one bounded retry
        # buys every later call a correct stamp. Same-epoch disagreement
        # (possible only under a split coordinator) also lands here: loud
        # rejection, never a silently-wrong owner.
        member.stale_rejections += 1
        err = ShardMovedError(
            f"shard {shard} is owned by {smap.owner_of_shard(shard)} at epoch "
            f"{smap.epoch}, not {member.member_id} (caller stamped epoch "
            f"{client_epoch})",
            shard_map=smap,
        )
        if message.call_id:
            await peer.send(
                RpcMessage(
                    message.call_type_id,
                    message.call_id,
                    SYSTEM_SERVICE,
                    "error",
                    dumps(ExceptionInfo.capture(err)),
                )
            )

    rpc_hub.inbound_middlewares.append(guard)
    return guard


# ---------------------------------------------------------------------- client


def install_cluster_client(rpc_hub, router: ShardMapRouter):
    """Wire a CLIENT hub into the control plane: ``$sys-m.map`` pushes from
    any connected member apply to the router (which fires the rebalancer's
    fencing). Returns the router for chaining. The other client sync path —
    ``ShardMovedError`` rejections — needs no installation; the hub/client
    layers apply those maps wherever they catch the error."""
    from ..utils.serialization import loads

    def handler(peer, message: RpcMessage):
        if message.method == "map":
            (wire,) = loads(message.argument_data)
            if isinstance(wire, ShardMap):  # wire-typed payload decodes directly
                router.apply_map(wire)
            elif isinstance(wire, dict):
                router.apply_wire_map(wire)

    rpc_hub.member_system_handler = handler
    return router
