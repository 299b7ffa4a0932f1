"""Client-side compute functions: cache-or-remote with invalidation binding.

Re-expression of src/Stl.Fusion/Client/Interception/ —
ClientComputeMethodFunction (:20-234), ClientComputed (:16-89) and the proxy
wiring (Internal/FusionProxies.cs). A client proxy's methods are REAL
compute methods on the client's own graph: results intern into the client
registry, participate in dependency capture (a client ComputedState can
depend on remote values), and invalidate when the server pushes
``$sys-c.invalidate`` — re-entering the local cascade.

Paths, mirroring the reference:
- REMOTE: send a compute call, bind the resulting ClientComputed to the
  call's invalidation future; if the result lands already-invalidated
  (server invalidated between result and subscription), retry ≤3
  (ClientComputeMethodFunction.cs:99-126);
- CACHED: if a client cache holds bytes for the key, return a cache-based
  computed IMMEDIATELY and race the true RPC in the background with
  dependency capture suppressed (:59-85); when the true result arrives,
  reuse the cached node if bytes match, else invalidate + replace
  (:128-151); ``when_synchronized()`` gates consumers that need confirmed
  values.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, Optional, Tuple

from ..core.computed import Computed
from ..core.context import ComputeContext, suspend_dependency_capture
from ..core.function import FunctionBase
from ..core.hub import FusionHub, default_hub
from ..core.inputs import ComputedInput
from ..core.options import ComputedOptions
from ..utils.ltag import LTag
from ..utils.result import Result
from ..utils.serialization import dumps, loads
from .cache import ClientComputedCache, RpcCacheKey
from .compute_call import ResultMissedError, RpcOutboundComputeCall

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["ClientComputed", "ClientComputeMethodFunction", "FusionClient", "compute_client"]


# cluster/router.py FAILOVER_HEADER as a literal: client_function loads
# before (and without) the cluster package
_FAILOVER_HEADER = "@failover"


def _is_shard_moved(e: BaseException) -> bool:
    """Function-local cluster import: client_function loads before (and
    without) the cluster package; the check must never create the cycle."""
    try:
        from ..cluster.shard_map import ShardMovedError
    except ImportError:  # pragma: no cover — cluster ships with the package
        return False
    return isinstance(e, ShardMovedError)


class ClientComputeMethodInput(ComputedInput):
    __slots__ = ("function_ref", "method", "args")

    def __init__(self, function_ref: "ClientComputeMethodFunction", method: str, args: tuple):
        self.function_ref = function_ref
        self.method = method
        self.args = args
        self._hash = hash((id(function_ref), method, args))

    @property
    def function(self) -> "FunctionBase":
        return self.function_ref

    def cache_key(self) -> RpcCacheKey:
        return RpcCacheKey(self.function_ref.service, self.method, dumps(list(self.args)))

    def __eq__(self, other):
        return (
            type(other) is ClientComputeMethodInput
            and self.function_ref is other.function_ref
            and self.method == other.method
            and self.args == other.args
        )

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"{self.function_ref.service}.{self.method}{self.args!r} (client)"


class ClientComputed(Computed):
    """A computed whose source of truth is a remote node."""

    __slots__ = ("call", "_synchronized")

    def __init__(self, input, version, options, call: Optional[RpcOutboundComputeCall]):
        super().__init__(input, version, options)
        self.call = call
        self._synchronized: Optional[asyncio.Future] = None
        if call is not None:
            self._bind_to_call(call)

    def _bind_to_call(self, call: RpcOutboundComputeCall) -> None:
        # sync callback, not a when_invalidated done_callback: the node
        # invalidates IN the dispatch that applied the $sys-c frame (a
        # done_callback defers by one loop hop per subscription — at
        # fan-out scale those hops dominated the staleness window). An
        # ALREADY-invalidated call (race with the result) keeps the
        # deferred path: binding happens before the node's output is set,
        # and an inline invalidate there would invert the output/invalidate
        # order the retry logic expects.
        if call.when_invalidated.done():
            call.when_invalidated.add_done_callback(
                lambda _f: self.invalidate(immediately=True)
            )
        else:
            call.invalidated_callbacks.append(
                lambda: self.invalidate(immediately=True)
            )
        self.on_invalidated(lambda _c: call.unregister())

    @property
    def invalidation_cause(self):
        """Cause id of the server-side wave/span that invalidated this node
        (carried in the ``$sys-c`` frame) — the client end of the
        cross-peer trace link; None while consistent or for cache-only
        nodes. Falls back to the locally-stamped cause (a client-side graph
        backend's wave) when no call delivered one."""
        call_cause = self.call.invalidation_cause if self.call is not None else None
        return call_cause or self._invalidation_cause

    @property
    def invalidation_origin_ts(self):
        """Server-side wave-apply timestamp the fence carried (perf_counter
        epoch, same-host trust caveat as ``fusion_e2e_delivery_ms``) —
        what lets the edge tier measure fence → edge → session
        delivery end to end; None while consistent, for cache-only nodes,
        or when the server predates timestamp stamping."""
        return self.call.invalidation_origin_ts if self.call is not None else None

    # -- cache synchronization gate ---------------------------------------
    @property
    def is_synchronized(self) -> bool:
        return self.call is not None or self._synchronized is None or self._synchronized.done()

    def when_synchronized(self) -> asyncio.Future:
        if self._synchronized is None:
            self._synchronized = asyncio.get_event_loop().create_future()
            if self.call is not None:
                self._synchronized.set_result(None)
        return self._synchronized

    def _mark_synchronized(self) -> None:
        if self._synchronized is not None and not self._synchronized.done():
            self._synchronized.set_result(None)


class ClientComputeMethodFunction(FunctionBase):
    def __init__(
        self,
        hub: FusionHub,
        rpc_hub,
        service: str,
        peer_ref: Optional[str],
        cache: Optional[ClientComputedCache] = None,
        options: Optional[ComputedOptions] = None,
        cluster_routed: bool = False,
    ):
        super().__init__(hub, options or ComputedOptions.CLIENT_DEFAULT)
        self.rpc_hub = rpc_hub
        self.service = service
        self.peer_ref = peer_ref
        self.cache = cache
        #: True for the per-peer clients a RoutingComputeProxy caches: the
        #: peer was chosen by the hub's shard router, so calls stamp the
        #: router's @shard/@epoch headers even though peer_ref is fixed
        #: (cluster/router.py headers_for). A user-pinned CLIENT-mode proxy
        #: stays unstamped — pinning opts out of cluster routing.
        self.cluster_routed = cluster_routed

    # ------------------------------------------------------------------ compute
    async def compute(self, input: ClientComputeMethodInput, existing: Optional[Computed]) -> Computed:
        if self.cache is not None and existing is None:
            cached = self.cache.get(input.cache_key())
            if cached is not None:
                return self._cached_compute(input, cached)
        return await self._remote_compute(input, existing)

    def _cached_compute(self, input, cached_bytes: bytes) -> "ClientComputed":
        """Serve from cache NOW, confirm over RPC in the background."""
        version = self.hub.version_generator.next()
        computed = ClientComputed(input, version, self.options, call=None)
        computed.when_synchronized()  # arm the gate before consumers can ask
        computed.try_set_output(Result.ok(loads(cached_bytes)))
        self.hub.registry.register(computed)

        async def synchronize():
            with suspend_dependency_capture():
                try:
                    real = await self._remote_compute(input, None, register=False)
                except Exception:  # noqa: BLE001 — confirm failed; cache stays
                    log.exception("cache synchronization for %r failed", input)
                    return
            real_bytes = dumps(real._output.value_or_default)
            if real_bytes == cached_bytes and real.call is not None:
                # cached value confirmed: rebind THIS node to the live call
                computed.call = real.call
                computed._bind_to_call(real.call)
                computed._mark_synchronized()
            else:
                self.cache.set(input.cache_key(), real_bytes)
                self.hub.registry.register(real)
                computed._mark_synchronized()
                computed.invalidate(immediately=True)  # dependents re-pull the real node

        # owned by the rpc hub's side-task set: a cache-sync still in
        # flight when the hub stops is cancelled, not leaked (FL003)
        try:
            self.rpc_hub.side_tasks.spawn(synchronize())
        except RuntimeError:
            # hub mid-stop: serve the cached value unsynchronized — the
            # cache-hit path must never raise for a teardown race
            pass
        return computed

    async def _remote_compute(
        self, input, existing: Optional[Computed], register: bool = True
    ) -> "ClientComputed":
        tries = 0
        while True:
            tries += 1
            router = self.rpc_hub.call_router
            headers: tuple = ()
            if self.peer_ref is None and hasattr(router, "route"):
                # shard-map routing: the decision carries its @shard/@epoch
                # stamp (and @failover when the owner is unreachable)
                peer_ref, headers = router.route(self.service, input.method, input.args)
            else:
                peer_ref = self.peer_ref or router(self.service, input.method, input.args)
                if self.cluster_routed and hasattr(router, "headers_for"):
                    headers = router.headers_for(
                        self.service, input.method, input.args, peer_ref=peer_ref
                    )
            peer = self.rpc_hub.client_peer(peer_ref or "default")
            await peer.when_connected()
            call = RpcOutboundComputeCall(
                peer, self.service, input.method, input.args, headers=headers
            )
            try:
                value = await call.invoke()
                output = Result.ok(value)
            except asyncio.CancelledError:
                raise
            except ResultMissedError as e:
                # invalidation overtook the result (reconnect interleaving /
                # invalidate-only restart answer): just re-issue the call —
                # UNLESS the fence was a reshard: this peer no longer owns
                # the key, so re-issuing here would loop against a non-owner
                # (or park on a retired peer). Surface ShardMovedError so
                # the routing layer re-routes against the new map.
                cause = call.invalidation_cause
                if cause is not None and cause.startswith("reshard:"):
                    if self.peer_ref is None and tries <= 3:
                        continue  # we route per call: next try uses the new map
                    from ..cluster.shard_map import ShardMovedError

                    raise ShardMovedError(f"call fenced by {cause}") from e
                if tries <= 3:
                    continue
                output = Result.err(e)
            except Exception as e:  # noqa: BLE001 — errors are memoized
                if _is_shard_moved(e):
                    # never memoize a routing rejection: apply the carried
                    # map and either re-route (per-call routing) or hand the
                    # error to whoever owns the routing decision
                    if hasattr(router, "note_moved"):
                        router.note_moved(e)
                    if self.peer_ref is None and tries <= 3:
                        continue
                    raise
                output = Result.err(e)
            version = call.result_version or self.hub.version_generator.next()
            computed = ClientComputed(input, LTag(version), self.options, call)
            computed.try_set_output(output)
            # result arrived already invalidated ⇒ retry (≤3)
            if call.when_invalidated.done() and not output.has_error and tries <= 3:
                continue
            if register:
                self.hub.registry.register(computed)
            if self.cache is not None and not output.has_error:
                self.cache.set(input.cache_key(), dumps(value))
            if not output.has_error and any(k == _FAILOVER_HEADER for k, _ in headers):
                # a failover read is served by the REPLICA, whose $sys-c
                # subscription never sees the owner's writes — and an owner
                # that recovers without an epoch change fences nothing. So
                # the computed expires on the router's clock: the re-read
                # routes back to the recovered owner (or to the replica
                # again while the outage lasts, bounded thrash).
                ttl = getattr(router, "failover_ttl", 0.0)
                if ttl and ttl > 0:
                    self.hub.timeouts.schedule_invalidate(computed, ttl)
            return computed

    # ------------------------------------------------------------------ batch
    async def compute_batch(self, requests):
        """Batched remote compute: ``requests`` is a
        list of ``(method, args, publish)`` triples, all bound for THIS
        function's pinned peer; every entry becomes a real registered
        outbound compute call (reconnect re-send and redelivery dedup are
        the per-key machinery, untouched) but ONE
        ``$sys-c.recompute_batch`` frame carries them all and ONE
        ``recompute_batch_r`` frame answers — the RPC/codec/loop-hop
        envelope is paid once per burst instead of once per key.

        Returns one result per request, positionally: a registered
        :class:`ClientComputed` on success, or the Exception that entry
        died with (``ResultMissedError``/``ShardMovedError``/server
        errors) — the CALLER owns the per-key fallback ladder; this
        method never silently degrades, so fallbacks stay countable.
        Versions are the server computed's own LTags — oracle-exact with
        the per-key path."""
        if not requests:
            return []
        router = self.rpc_hub.call_router
        peer_ref = self.peer_ref or "default"
        peer = self.rpc_hub.client_peer(peer_ref)
        await peer.when_connected()
        from ..rpc.message import COMPUTE_SYSTEM_SERVICE, RpcMessage

        calls, entries = [], []
        for method, args, publish in requests:
            args = tuple(args)
            headers: tuple = ()
            if self.cluster_routed and hasattr(router, "headers_for"):
                headers = router.headers_for(
                    self.service, method, args, peer_ref=peer_ref
                )
            call = RpcOutboundComputeCall(
                peer, self.service, method, args, headers=headers
            )
            peer.outbound_calls[call.call_id] = call
            calls.append(call)
            entries.append(
                [
                    call.call_id,
                    self.service,
                    method,
                    list(args),
                    bool(publish),
                    [list(h) for h in headers],
                ]
            )
        message = RpcMessage(
            call_type_id=calls[0].call_type_id,
            call_id=0,
            service=COMPUTE_SYSTEM_SERVICE,
            method="recompute_batch",
            argument_data=dumps([entries]),
        )
        try:
            await peer.send(message)
        except Exception:  # noqa: BLE001 — not connected: the calls stay
            # registered and the reconnect re-send replays them per-key
            pass
        outcomes = await asyncio.gather(
            *(c.future for c in calls), return_exceptions=True
        )
        results = []
        for (method, args, _publish), call, outcome in zip(requests, calls, outcomes):
            if isinstance(outcome, BaseException):
                if _is_shard_moved(outcome) and hasattr(router, "note_moved"):
                    # apply the rejection's carried map BEFORE handing the
                    # error back (the per-key path's contract): the
                    # caller's retry re-routes against the new owner
                    # instead of spinning on the retired one
                    router.note_moved(outcome)
                call.unregister()
                results.append(outcome)
                continue
            if call.when_invalidated.done():
                # result arrived already invalidated: the per-key path's
                # bounded retry loop owns this shape — surface retriable
                results.append(
                    ResultMissedError(
                        f"batch entry {call.call_id} arrived already invalidated"
                    )
                )
                continue
            input = ClientComputeMethodInput(self, method, tuple(args))
            version = call.result_version or self.hub.version_generator.next()
            computed = ClientComputed(input, LTag(version), self.options, call)
            computed.try_set_output(Result.ok(outcome))
            self.hub.registry.register(computed)
            if self.cache is not None:
                self.cache.set(input.cache_key(), dumps(outcome))
            results.append(computed)
        return results


class FusionClient:
    """The client proxy: attribute access → client compute method.

    ≈ FusionProxies.NewClientProxy — an RPC client proxy wrapped by the
    client-compute interceptor."""

    def __init__(
        self,
        service: str,
        rpc_hub,
        fusion_hub: Optional[FusionHub] = None,
        peer_ref: Optional[str] = "default",
        cache: Optional[ClientComputedCache] = None,
        options: Optional[ComputedOptions] = None,
        cluster_routed: bool = False,
    ):
        self._function = ClientComputeMethodFunction(
            fusion_hub or default_hub(), rpc_hub, service, peer_ref, cache, options,
            cluster_routed=cluster_routed,
        )

    def capture_batch(self, requests):
        """Batched twin of ``capture(lambda: client.method(*args))`` × N
       : ``requests`` = ``[(method, args, publish), ...]`` →
        one ``recompute_batch`` frame; returns per-request
        ``ClientComputed`` or Exception (see
        :meth:`ClientComputeMethodFunction.compute_batch`)."""
        return self._function.compute_batch(requests)

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        function = self._function

        async def call(*args):
            from ..core.context import OPT_INVALIDATE_BIT, get_current

            input = ClientComputeMethodInput(function, method, args)
            context = ComputeContext.current()
            used_by = None if context.call_options & OPT_INVALIDATE_BIT else get_current()
            return await function.invoke_and_strip(input, used_by, context)

        call.__name__ = method
        call.__fusion_remote_proxy__ = self  # invalidation replay is the owner's job
        return call


def compute_client(
    service: str,
    rpc_hub,
    fusion_hub: Optional[FusionHub] = None,
    peer_ref: Optional[str] = "default",
    cache: Optional[ClientComputedCache] = None,
) -> FusionClient:
    """Create an invalidation-aware client for a remote compute service."""
    return FusionClient(service, rpc_hub, fusion_hub, peer_ref, cache)
