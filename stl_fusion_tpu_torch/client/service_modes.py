"""Service modes — how a compute service participates in distribution.

Re-expression of src/Stl.Rpc/RpcServiceMode.cs:3-11 and FusionBuilder's mode
dispatch (FusionBuilder.cs:222-320):

- LOCAL: plain local compute service (AddService).
- SERVER: local compute service, also exposed over RPC (AddServer).
- CLIENT: pure invalidation-aware RPC client proxy (AddClient).
- ROUTER: per-call routing proxy — the hub's call router picks a peer ref
  per (service, method, args); ``None``/empty routes to the local service
  (AddRouter; RpcRoutingInterceptor.cs:30-36).
- ROUTING_SERVER: SERVER whose locally-registered implementation is the
  real service, returning a routing proxy for callers (AddRoutingServer).
- SERVING_ROUTER: a router that is ITSELF exposed over RPC — a gateway
  node forwarding calls to the shard that owns them (AddServingRouter).

Remote legs are ``FusionClient``s, so routed results still memoize into
the caller's computed graph and invalidate on server push.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, Optional

from ..core.hub import FusionHub
from .cache import ClientComputedCache
from .client_function import FusionClient

__all__ = ["RpcServiceMode", "RoutingComputeProxy", "add_fusion_service"]


class RpcServiceMode(enum.Enum):
    LOCAL = "local"
    SERVER = "server"
    CLIENT = "client"
    ROUTER = "router"
    ROUTING_SERVER = "routing_server"
    SERVING_ROUTER = "serving_router"


class RoutingComputeProxy:
    """Per-call dispatch between a local service and per-peer fusion
    clients (≈ FusionProxies.NewRoutingProxy + RpcRoutingInterceptor)."""

    __rpc_dynamic__ = True  # methods materialize via __getattr__ when served

    def __init__(
        self,
        service_name: str,
        rpc_hub,
        fusion_hub: Optional[FusionHub] = None,
        local_service: Any = None,
        cache: Optional[ClientComputedCache] = None,
    ):
        self.service_name = service_name
        self.rpc_hub = rpc_hub
        self.fusion_hub = fusion_hub
        self.local_service = local_service
        self.cache = cache
        self._clients: Dict[str, FusionClient] = {}

    def client_for(self, peer_ref: str) -> FusionClient:
        client = self._clients.get(peer_ref)
        if client is None:
            client = FusionClient(
                self.service_name, self.rpc_hub, self.fusion_hub, peer_ref, self.cache,
                cluster_routed=True,
            )
            self._clients[peer_ref] = client
        return client

    def evict_peer(self, peer_ref: str) -> Optional[FusionClient]:
        """Drop (and return) the cached per-peer client. Before the shard map, these
        were cached FOREVER: a peer that left the pool kept a live
        FusionClient (and its cache) routing into a dead socket. The
        cluster rebalancer calls this for every departed member; callers
        running a static pool can call it directly on membership edits."""
        return self._clients.pop(peer_ref, None)

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)

        async def call(*args):
            attempts = 0
            while True:
                attempts += 1
                router = self.rpc_hub.call_router
                ref = router(self.service_name, method, args)
                if not ref:  # router says local (RpcClientInterceptor local fallback)
                    if self.local_service is None:
                        raise LookupError(
                            f"router returned local for {self.service_name}.{method} "
                            f"but no local service is registered"
                        )
                    return await getattr(self.local_service, method)(*args)
                try:
                    return await getattr(self.client_for(ref), method)(*args)
                except Exception as e:  # noqa: BLE001 — reshard retry only
                    # a shard-map rejection (the per-peer client already
                    # applied the carried map) or a retired peer: THIS is
                    # the layer that owns the routing decision, so re-route
                    # once against the current map. Static routers keep the
                    # historic raise-through behavior.
                    from ..cluster.shard_map import ShardMovedError

                    retriable = isinstance(e, ShardMovedError) or (
                        isinstance(e, ConnectionError) and hasattr(router, "route")
                    )
                    if not retriable or attempts >= 2:
                        raise

        call.__name__ = method
        call.__fusion_remote_proxy__ = self  # invalidation replay is the owner's job
        return call

    def __repr__(self) -> str:
        return f"RoutingComputeProxy({self.service_name}, local={self.local_service is not None})"


def add_fusion_service(
    mode: RpcServiceMode,
    service_name: str,
    rpc_hub,
    fusion_hub: Optional[FusionHub] = None,
    local_service: Any = None,
    peer_ref: str = "default",
    cache: Optional[ClientComputedCache] = None,
) -> Any:
    """Register a compute service in the given mode; returns the object
    callers should invoke (the local service, a client, or a router)."""
    if mode is RpcServiceMode.LOCAL:
        if local_service is None:
            raise ValueError("LOCAL mode needs local_service")
        return local_service
    if mode is RpcServiceMode.SERVER:
        if local_service is None:
            raise ValueError("SERVER mode needs local_service")
        rpc_hub.add_service(service_name, local_service)
        return local_service
    if mode is RpcServiceMode.CLIENT:
        return FusionClient(service_name, rpc_hub, fusion_hub, peer_ref, cache)
    if mode is RpcServiceMode.ROUTER:
        return RoutingComputeProxy(service_name, rpc_hub, fusion_hub, local_service, cache)
    if mode is RpcServiceMode.ROUTING_SERVER:
        if local_service is None:
            raise ValueError("ROUTING_SERVER mode needs local_service")
        rpc_hub.add_service(service_name, local_service)
        return RoutingComputeProxy(service_name, rpc_hub, fusion_hub, local_service, cache)
    if mode is RpcServiceMode.SERVING_ROUTER:
        router = RoutingComputeProxy(service_name, rpc_hub, fusion_hub, local_service, cache)
        rpc_hub.add_service(service_name, router)
        return router
    raise ValueError(f"unknown mode {mode}")
