"""RpcHub — root of the RPC stack + client proxies + call routing.

Re-expression of src/Stl.Rpc/RpcHub.cs:7-93 (peer registry, lazy peer
start), Configuration/RpcDefaultDelegates.cs (the ``RpcCallRouter`` — THE
sharding/routing point: route a call to a peer by key, e.g. consistent
hash over a server pool, samples/MultiServerRpc/Program.cs:58-76), and
Infrastructure/RpcClientInterceptor.cs (proxy → outbound call, with local
fallback when the router returns None — the basis of Router/Distributed
service modes, FusionBuilder.cs:222-320).
"""
from __future__ import annotations

import itertools
import logging
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional, Sequence

from ..diagnostics.metrics import global_metrics
from ..utils.async_utils import ChannelPair, TaskSet
from .calls import RpcCallTypeRegistry, RpcOutboundCall
from .message import RpcMessage
from .peer import RpcClientPeer, RpcPeer, RpcServerPeer
from .registry import RpcServiceRegistry

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["RpcHub", "RpcClientProxy", "RpcConfigurationError", "consistent_hash_router"]

#: router: (service, method, args) -> peer ref (str) or None for local
RpcCallRouter = Callable[[str, str, tuple], Optional[str]]


class RpcConfigurationError(RuntimeError):
    """A peer cannot ever connect because the hub is misconfigured (no
    client connector, unknown peer ref, ...). The default
    ``unrecoverable_error_detector`` treats exactly this class (plus the
    ``LookupError`` connectors raise for unknown refs) as terminal — a
    transient transport failure surfacing as a broad builtin such as
    ``RuntimeError`` keeps the reconnect loop alive, matching the
    reference's narrow connection-unrecoverable set
    (Configuration/RpcDefaultDelegates.cs)."""


class RpcHub:
    def __init__(self, name: str = "rpc"):
        self.name = name
        self.service_registry = RpcServiceRegistry()
        self.call_types = RpcCallTypeRegistry()
        self.peers: Dict[str, RpcPeer] = {}
        #: hub-lifetime outbound call id sequence, shared by every peer
        #: (see RpcPeer._call_id_counter for why per-peer counters are a
        #: stale-read bug after peer re-creation)
        self._outbound_call_ids = itertools.count(1)
        #: transport factory for client peers: async (peer) -> ChannelPair
        self.client_connector: Optional[Callable[[RpcClientPeer], Awaitable[ChannelPair]]] = None
        #: hub-lifecycle owner for fire-and-forget side tasks (cache
        #: synchronize, etc. — the fusionlint FL003 contract): strong refs
        #: until settled, cancelled at stop()
        self.side_tasks = TaskSet(name=f"rpc-hub:{name}")
        self.call_router: RpcCallRouter = lambda service, method, args: "default"
        #: 0 = unlimited; n ≥ 1 serializes non-system inbound calls per peer
        #: through an n-permit gate (≈ InboundConcurrencyLevel, RpcPeer.cs:20)
        self.inbound_concurrency_level: int = 0
        self.max_connect_attempts = 10_000
        #: connect errors this returns True for abort the reconnect loop at
        #: once instead of backing off (≈ RpcUnrecoverableErrorDetector,
        #: Configuration/RpcDefaultDelegates.cs; RpcPeer.cs:268-274).
        #: Default: ONLY declared configuration errors are terminal —
        #: RpcConfigurationError ("no client connector") and the
        #: LookupError connectors raise for unknown peer refs
        #: (websocket_multi_connector). Everything else, including
        #: RuntimeError/ValueError bubbling out of third-party transport
        #: internals, is treated as transient and retried with backoff.
        self.unrecoverable_error_detector: Callable[[BaseException], bool] = (
            lambda e: isinstance(e, (RpcConfigurationError, LookupError))
            and not isinstance(e, (ConnectionError, OSError, TimeoutError))
        )
        #: $sys-c dispatch hook, installed by the fusion client layer
        self.compute_system_handler: Optional[Callable[[RpcPeer, RpcMessage], None]] = None
        #: True (default): server-side invalidation pushes coalesce through
        #: each peer's outbox into one ``$sys-c.invalidate_batch`` frame per
        #: drain tick (version-deduped). False: the original one-frame-per-
        #: key ``$sys-c.invalidate`` path — kept for wire compat with old
        #: clients and as the A/B baseline (perf/fanout_path.py). Clients
        #: always understand BOTH frame kinds regardless of this flag.
        self.coalesce_invalidations: bool = True
        #: optional ComputeFanoutIndex (rpc/fanout.py): lets a device
        #: wave's newly-mask drain straight into per-peer batches
        self.compute_fanout: Optional[Any] = None
        #: optional WaveValuePublisher (rpc/fanout.py):
        #: SERVER side of the publish-on-wave value plane — keys with a
        #: standing publish registration answer wave fences with pushed
        #: ``$sys-c.value_block`` frames instead of plain invalidations
        self.value_publisher: Optional[Any] = None
        #: CLIENT side of the value plane (the EdgeNode installs itself):
        #: routes inbound ``value_block`` frames + fallback fences for
        #: retired publish-mode calls (``on_value_block`` /
        #: ``on_block_fence``)
        self.value_plane_client: Optional[Any] = None
        #: $sys-t dispatch hook (per-table row fences + subscriptions),
        #: installed by client/remote_table.py on both ends
        self.table_system_handler: Optional[Callable[[RpcPeer, RpcMessage], None]] = None
        #: $sys-d dispatch hook (cross-peer explain/introspection), installed
        #: by diagnostics.explain.install_explain on both ends; may be an
        #: ASYNC callable (the server side awaits a registry peek + a reply
        #: send) — the peer dispatch awaits coroutine results
        self.diag_system_handler: Optional[Callable[[RpcPeer, RpcMessage], Any]] = None
        #: $sys-m dispatch hook (cluster membership: heartbeats, suspicions,
        #: shard-map pushes), installed by cluster.membership.ClusterMember
        #: on members and cluster.router.install_cluster_client on clients;
        #: may be async (map replies) — dispatched like $sys-d
        self.member_system_handler: Optional[Callable[[RpcPeer, RpcMessage], Any]] = None
        #: composable middleware chains (≈ RpcInboundMiddleware /
        #: RpcOutboundMiddleware, Stl.Rpc/Infrastructure/): each entry is
        #: ``async (peer, message, nxt)`` where ``await nxt(message)``
        #: continues the chain (pass a modified message to rewrite).
        #: Inbound runs around message dispatch; outbound around ``send``
        #: (first sends only — reconnect re-sends replay the original call
        #: messages without re-running the chain).
        self.inbound_middlewares: List[Callable] = []
        self.outbound_middlewares: List[Callable] = []
        #: dial gates: each is ``async (peer) -> None``, awaited before every
        #: client dial. A gate that parks is a quarantine — the peer circuit
        #: breaker (resilience/breaker.py) holds flapping peers here so
        #: reconnect re-send storms can't amplify
        self.connect_gates: List[Callable[[RpcClientPeer], Awaitable[None]]] = []
        #: local service fallback for routing proxies
        self.local_services: Dict[str, Any] = {}
        # /metrics exposure: weak-registered pull-time collector — counters
        # stay plain attributes on the hot paths; the registry sums across
        # every live hub only when someone actually scrapes
        global_metrics().register_collector(self, RpcHub._collect_metrics)
        # non-additive: the worst pending age across hubs, never the sum
        global_metrics().set_aggregation("fusion_outbox_pending_age_ms", "max")

    def _collect_metrics(self) -> dict:
        s = self.fanout_stats()
        out = {
            "fusion_outbox_queued": s["queued"],
            "fusion_outbox_pending_invalidations": s["pending_invalidations"],
            "fusion_outbox_messages_sent_total": s["messages_sent"],
            "fusion_invalidations_posted_total": s["invalidations_posted"],
            "fusion_invalidations_coalesced_total": s["invalidations_coalesced"],
            "fusion_batch_frames_sent_total": s["batch_frames_sent"],
            "fusion_batch_keys_sent_total": s["batch_keys_sent"],
            "fusion_outbox_pending_dropped_total": s["pending_dropped"],
            "fusion_outbox_drain_faults_total": s["drain_faults"],
            "fusion_rpc_peers": len(self.peers),
        }
        fi = s.get("fanout_index")
        if fi is not None:
            out["fusion_fanout_subscriptions"] = fi["subscriptions"]
            out["fusion_fanout_drained_total"] = fi["drained_total"]
            out["fusion_fanout_waves_seen_total"] = fi["waves_seen"]
        # flush-tick lag gauge: how long the OLDEST pending invalidation has
        # sat coalescing (0 when nothing is pending). The shipped-frame lag
        # distribution is the fusion_outbox_flush_lag_ms histogram.
        oldest = None
        for peer in self.peers.values():
            ob = peer._outbox
            if ob is not None and ob._pending_since is not None:
                if oldest is None or ob._pending_since < oldest:
                    oldest = ob._pending_since
        out["fusion_outbox_pending_age_ms"] = (
            (time.perf_counter() - oldest) * 1e3 if oldest is not None else 0.0
        )
        return out

    # ------------------------------------------------------------------ server side
    def add_service(self, name: str, implementation: Any):
        """Expose a service to inbound calls."""
        self.service_registry.add(name, implementation)
        self.local_services[name] = implementation
        return implementation

    def server_peer(self, ref: str) -> RpcServerPeer:
        peer = self.peers.get(ref)
        if peer is None:
            peer = RpcServerPeer(self, ref)
            self.peers[ref] = peer
        return peer  # type: ignore[return-value]

    # ------------------------------------------------------------------ client side
    def client_peer(self, ref: str = "default") -> RpcClientPeer:
        peer = self.peers.get(ref)
        if peer is None:
            peer = RpcClientPeer(self, ref)
            self.peers[ref] = peer
            peer.start()
        return peer  # type: ignore[return-value]

    async def connect_client(self, peer: RpcClientPeer) -> ChannelPair:
        if self.client_connector is None:
            raise RpcConfigurationError(
                f"hub {self.name!r} has no client connector configured"
            )
        for gate in self.connect_gates:
            await gate(peer)
        return await self.client_connector(peer)

    def client(self, service_name: str, peer_ref: Optional[str] = None) -> "RpcClientProxy":
        """A call proxy for a remote service; without an explicit peer the
        call router picks one per call (routing proxy)."""
        return RpcClientProxy(self, service_name, peer_ref)

    # ------------------------------------------------------------------ calls
    async def call(
        self,
        service: str,
        method: str,
        args: tuple,
        peer_ref: Optional[str] = None,
        call_type_id: int = 0,
        no_wait: bool = False,
    ) -> Any:
        attempts = 0
        while True:
            attempts += 1
            router = self.call_router
            headers: tuple = ()
            if peer_ref is not None:
                # an explicit pin opts OUT of cluster routing — no shard
                # stamp, so the guard never second-guesses the caller
                ref = peer_ref
            elif hasattr(router, "route"):
                # shard-map router: the routing decision carries its own
                # @shard/@epoch stamp (cluster/router.py); a command whose
                # owner is down fails fast RIGHT HERE (never retried below)
                ref, headers = router.route(service, method, args)
            else:
                ref = router(service, method, args)
            if ref is None:
                # router says local (≈ RpcClientInterceptor local fallback)
                local = self.local_services.get(service)
                if local is None:
                    raise LookupError(f"no local implementation for {service!r}")
                return await getattr(local, method)(*args)
            peer = self.client_peer(ref)
            await peer.when_connected()
            outbound_cls = self.call_types.outbound(call_type_id)
            call = outbound_cls(peer, service, method, args, no_wait=no_wait, headers=headers)
            try:
                return await call.invoke()
            except Exception as e:  # noqa: BLE001 — only ShardMovedError is special
                from ..cluster.shard_map import ShardMovedError

                if (
                    not isinstance(e, ShardMovedError)
                    or peer_ref is not None
                    or attempts >= 2
                ):
                    raise
                # the rejection carries the server's current map: apply it
                # and retry ONCE against the new owner (bounded — a second
                # rejection surfaces to the caller)
                if hasattr(router, "note_moved"):
                    router.note_moved(e)

    async def stop(self) -> None:
        # cancel in-flight side tasks, then re-arm: stop() means "stop the
        # current work", and tests reuse a stopped hub for a fresh connect
        await self.side_tasks.aclose()
        self.side_tasks = TaskSet(name=f"rpc-hub:{self.name}")
        for peer in list(self.peers.values()):
            await peer.stop()

    # ------------------------------------------------------------------ diagnostics
    def fanout_stats(self) -> dict:
        """Aggregate outbox/coalescer counters over every peer (plus the
        fanout index's, when installed) — exported through
        ``FusionMonitor.report()`` so the fan-out path is observable."""
        totals = {
            "messages_sent": 0,
            "invalidations_posted": 0,
            "invalidations_coalesced": 0,
            "batch_frames_sent": 0,
            "batch_keys_sent": 0,
            "pending_dropped": 0,
            "drain_faults": 0,
            "queued": 0,
            "pending_invalidations": 0,
        }
        for peer in self.peers.values():
            ob = peer._outbox
            if ob is None:
                continue
            for k, v in ob.stats().items():
                totals[k] += v
        if self.compute_fanout is not None:
            totals["fanout_index"] = self.compute_fanout.stats()
        return totals


class RpcClientProxy:
    """Dynamic proxy: attribute access → remote (or routed) call."""

    def __init__(self, hub: RpcHub, service: str, peer_ref: Optional[str] = None):
        self._hub = hub
        self._service = service
        self._peer_ref = peer_ref

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)

        async def call(*args):
            return await self._hub.call(self._service, method, args, peer_ref=self._peer_ref)

        call.__name__ = method
        return call

    def __repr__(self) -> str:
        return f"RpcClientProxy({self._service} @ {self._peer_ref or '<routed>'})"


def consistent_hash_router(
    peer_refs: Sequence[str], key_arg: int = 0
) -> RpcCallRouter:
    """Shard calls over a peer pool by hashing an argument — the reference's
    MultiServerRpc routing pattern (Program.cs:58-76).

    This is a thin shim over the cluster's
    :class:`~stl_fusion_tpu_torch.cluster.shard_map.ShardMap` with a STATIC
    member list: same public name and signature, but routing goes
    key → virtual shard → rendezvous owner instead of sha1-mod-N, so
    removing one member from the pool moves only that member's shards
    (~V/N keys) rather than remapping ~(N-1)/N of everything. Routes stay
    sha1-stable across process restarts (never the salted builtin
    ``hash()``). For an ELASTIC pool — membership, epochs, failover,
    fencing — install a ``cluster.ShardMapRouter`` instead."""
    from ..cluster.shard_map import ShardMap

    shard_map = ShardMap.initial(peer_refs)

    def route(service: str, method: str, args: tuple) -> str:
        key = repr(args[key_arg]) if len(args) > key_arg else service
        return shard_map.owner_of(key)

    route.shard_map = shard_map  # introspectable by tests/diagnostics
    return route
