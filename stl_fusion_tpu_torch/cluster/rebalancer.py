"""ClusterRebalancer — cache fencing on shard-map epoch changes.

The correctness half of live resharding. When a key moves shards, only the
OLD owner knows the key's subscribers — the new owner has never seen them.
Without fencing, every client-cached computed for a moved key stays
"consistent" forever: its ``$sys-c`` subscription points at a server that
will never invalidate it again (the old owner no longer takes the writes),
which is exactly the silent-staleness failure the fence exists to prevent.

So, on every applied epoch (wired to ``ShardMapRouter.on_map_change``):

- **fence**: every registered outbound compute call whose key's shard is in
  ``ShardMap.diff(old, new)`` is invalidated through the EXISTING client
  invalidation path — ``RpcOutboundComputeCall.set_invalidated`` with a
  ``reshard:<epoch>`` cause id, so the bound ClientComputed re-enters the
  local cascade, dependents re-pull, the next read routes to the NEW owner
  and re-subscribes there, and ``explain()`` names the reshard end to end.
  Calls on unmoved shards keep their live subscriptions untouched.
- **retire departed peers**: a member that left the map has its per-peer
  ``FusionClient`` evicted from every attached ``RoutingComputeProxy``
  (the ``_clients`` leak fix — a departed peer used to keep a live
  client + cache routing into a dead socket forever), its pending calls
  failed, its breaker disposed, and the client peer stopped with a
  TERMINATED state so anything parked in ``when_connected()`` raises
  instead of waiting for a reconnect that can never come.

Everything here runs CLIENT-side (routers and routing proxies); servers
need no rebalancer — their data stays valid, the guard just stops them
serving shards they no longer own.
"""
from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from ..diagnostics.flight_recorder import RECORDER, call_key
from ..diagnostics.metrics import global_metrics
from ..resilience.events import ResilienceEvents, global_events
from .router import ShardMapRouter
from .shard_map import ShardMap

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["ClusterRebalancer"]


class ClusterRebalancer:
    def __init__(
        self,
        rpc_hub,
        router: ShardMapRouter,
        events: Optional[ResilienceEvents] = None,
    ):
        self.rpc_hub = rpc_hub
        self.router = router
        self.events = events if events is not None else global_events()
        #: RoutingComputeProxy instances whose per-peer FusionClients this
        #: rebalancer evicts when their peer departs
        self._proxies: List = []
        #: TpuGraphBackends with mesh routing enabled: an applied epoch
        #: MOVES their device shards (the rebalancer relocates
        #: the graph slice itself, not just the cached calls)
        self._backends: List = []
        self.device_shards_moved = 0
        self.resharded_keys = 0
        self.peers_retired = 0
        self.rebalances = 0
        self._retire_tasks: set = set()
        router.on_map_change.append(self.on_map_change)
        global_metrics().register_collector(self, ClusterRebalancer._collect_metrics)

    def _collect_metrics(self) -> dict:
        return {
            "fusion_resharded_keys_total": self.resharded_keys,
            "fusion_cluster_peers_retired_total": self.peers_retired,
            "fusion_rebalances_total": self.rebalances,
            "fusion_mesh_rebalancer_shards_moved_total": self.device_shards_moved,
        }

    def attach_proxy(self, proxy) -> "ClusterRebalancer":
        """Register a ``RoutingComputeProxy`` for departed-peer eviction."""
        self._proxies.append(proxy)
        return self

    def attach_backend(self, backend) -> "ClusterRebalancer":
        """Register a mesh-routing ``TpuGraphBackend``: every applied epoch
        then moves the reassigned DEVICE SHARDS on the mesh (state blocks
        transfer on-device, exchange routes re-pack) in the same change
        that fences the moved keys' client caches — the cache-fencing +
        shard-moving pair the routed mesh requires."""
        self._backends.append(backend)
        return self

    def dispose(self) -> None:
        try:
            self.router.on_map_change.remove(self.on_map_change)
        except ValueError:
            pass
        global_metrics().unregister_collector(self)

    # ------------------------------------------------------------------ fence
    def on_map_change(self, old: ShardMap, new: ShardMap) -> None:
        from ..client.compute_call import RpcOutboundComputeCall

        moved = frozenset(ShardMap.diff(old, new))
        cause = f"reshard:{new.epoch}"
        fenced = 0
        if moved:
            # only calls subscribed on CLUSTER members are governed by the
            # shard map — a pinned non-cluster service sharing this hub
            # (e.g. a plain CLIENT-mode FusionClient on "default") keeps its
            # subscriptions across epochs; its keys hashing into a moved
            # shard is coincidence, not ownership
            cluster_refs = set(old.members) | set(new.members)
            for ref, peer in list(self.rpc_hub.peers.items()):
                if ref not in cluster_refs:
                    continue
                for call in list(peer.outbound_calls.values()):
                    if not isinstance(call, RpcOutboundComputeCall):
                        continue
                    shard = self.router.shard_for(call.service, call.method, call.args)
                    if shard not in moved:
                        continue  # owner unchanged: the subscription stays live
                    if RECORDER.enabled:
                        RECORDER.note(
                            "resharded",
                            key=call_key(call.service, call.method, call.args),
                            cause=cause,
                            count=1,
                            detail=(
                                f"shard {shard} owner "
                                f"{old.owner_of_shard(shard)} -> {new.owner_of_shard(shard)}"
                            ),
                        )
                    call.set_invalidated(cause=cause)
                    fenced += 1
        self.resharded_keys += fenced
        self.rebalances += 1
        for backend in self._backends:
            try:
                self.device_shards_moved += backend.apply_mesh_reshard(new)
            except Exception:  # noqa: BLE001 — a mesh move must never block the map
                log.exception("mesh device-shard move failed; mirror will rebuild")
        departed = set(old.members) - set(new.members)
        for ref in departed:
            self._retire_peer(ref)
        if RECORDER.enabled:
            RECORDER.note(
                "resharded",
                key=None,
                cause=cause,
                count=fenced,
                detail=(
                    f"epoch {old.epoch}->{new.epoch}: {len(moved)} shard(s) moved, "
                    f"{fenced} client key(s) fenced, {len(departed)} peer(s) departed"
                ),
            )
        self.events.record(
            "cluster_rebalance", f"epoch {new.epoch}: {fenced} fenced, {sorted(departed)} departed"
        )

    # ------------------------------------------------------------------ retire
    def _retire_peer(self, ref: str) -> None:
        """Drain + dispose everything holding a departed member alive: the
        routing proxies' cached FusionClients (the leak), pending
        calls, the breaker, the peer worker itself."""
        for proxy in self._proxies:
            evict = getattr(proxy, "evict_peer", None)
            if evict is not None:
                evict(ref)
        peer = self.rpc_hub.peers.pop(ref, None)
        if peer is None:
            return
        self.peers_retired += 1
        err = ConnectionError(f"peer {ref} left the cluster")
        # TERMINATED first: when_connected() waiters must raise NOW, not
        # park behind a reconnect loop that can never succeed again
        peer._set_state("terminated", err)
        for call in list(peer.outbound_calls.values()):
            # compute calls were fenced above (their shards moved by
            # definition when the owner departed); anything left is a plain
            # call that can only error
            call.set_error(err)

        async def _stop() -> None:
            breaker = getattr(peer, "breaker", None)
            if breaker is not None:
                await breaker.dispose()
            await peer.stop()

        try:
            task = asyncio.get_event_loop().create_task(_stop())
        except RuntimeError:  # no loop (sync teardown): best-effort only
            return
        self._retire_tasks.add(task)
        task.add_done_callback(self._retire_tasks.discard)

    def snapshot(self) -> dict:
        return {
            "resharded_keys": self.resharded_keys,
            "peers_retired": self.peers_retired,
            "rebalances": self.rebalances,
            "device_shards_moved": self.device_shards_moved,
        }
