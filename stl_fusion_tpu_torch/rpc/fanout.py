"""ComputeFanoutIndex — newly-mask → subscribed-key extraction.

The missing half of the coalesced fan-out: the burst
path already ships its newly-invalid set as a device-packed 1-bit/node
mask (graph/backend.py ``_apply_newly_mask``); this index maps backend
node ids to live ``$sys-c`` subscriptions so a wave's mask drains STRAIGHT
into per-peer pending invalidation sets (``PeerOutbox.post_invalidation``)
— one vectorized intersection per wave, no per-subscription watch-task
wakeup on the burst path.

The per-computed watch task (``RpcInboundComputeCall._watch_invalidation``)
stays as the correctness backstop: host-led invalidations cascade through
the host graph, not through a device wave, so only the watch task sees
them. Both paths post into the same per-peer pending map, which dedups —
a subscription fenced by the mask AND its watch task ships once per flush.

Install with :func:`install_compute_fanout` on the SERVER rpc hub whose
fusion hub has a :class:`~stl_fusion_tpu_torch.graph.TpuGraphBackend` attached.

The :class:`WaveValuePublisher` is — the SERVER half of the
publish-on-wave value plane (level 2 of the upstream value plane). A key
with a STANDING publish registration (armed by a ``recompute_batch``
entry, client/compute_call.py) answers a wave fence not with a plain
invalidation but with the recomputed VALUE: after the wave's apply the
publisher recomputes the burst's fenced hot-set once per key, serializes
each value ONCE, and ships each subscribed edge ONE columnar
``$sys-c.value_block`` frame — ``(call_id, version, seq, cause, t0,
offset, bytes)`` columns over a shared payload blob — through the same
per-peer outbox drain the invalidation batches ride. The subscribed edge
then serves the whole fence burst with ZERO per-key upstream RPCs. Every
degradation falls back to the plain invalidation fence (counted, never
silent): host-led invalidations (reshards, manual fences), recompute
errors, dead links mid-block, per-round key/byte budget overflows.
"""
from __future__ import annotations

import asyncio
import itertools
import logging
import time
import weakref
from typing import TYPE_CHECKING, Dict, Optional, Set, Tuple

import numpy as np

from ..diagnostics.flight_recorder import RECORDER
from ..diagnostics.hotkeys import global_hotkeys
from ..utils.serialization import dumps
from .message import CALL_TYPE_COMPUTE, COMPUTE_SYSTEM_SERVICE, RpcMessage

if TYPE_CHECKING:
    from ..graph.backend import TpuGraphBackend
    from .hub import RpcHub
    from .peer import RpcPeer

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "ComputeFanoutIndex",
    "WaveValuePublisher",
    "install_compute_fanout",
    "install_value_publisher",
]


class ComputeFanoutIndex:
    def __init__(self, rpc_hub: "RpcHub", backend: "TpuGraphBackend"):
        self.rpc_hub = rpc_hub
        self.backend = backend
        #: nid → {(id(peer), call_id): (weakref(peer), version,
        #: weakref(inbound call) | None)} — weak so a dead peer/call never
        #: pins its connection machinery through the index
        self._by_nid: Dict[
            int, Dict[Tuple[int, int], Tuple[object, Optional[str], Optional[object]]]
        ] = {}
        self._nid_arr: Optional[np.ndarray] = None  # cache of _by_nid keys
        backend.newly_hooks.append(self._on_newly)
        self.subscriptions = 0  # live entries
        self.registered_total = 0
        self.drained_total = 0  # subscriptions fenced via the mask path
        #: fences drained INSIDE a WavePipeline overlap window — i.e. the
        #: host shipped wave N-1's invalidations into per-peer outboxes
        #: while wave N executed on device; zero means
        #: the fan-out still serializes with device execution
        self.drained_overlapped = 0
        self.waves_seen = 0
        #: Relay scoping. Members co-located on this process's
        #: mesh observe cross-shard frontiers through the collectives —
        #: a per-key relay post to one of them means the mesh path
        #: DISENGAGED (the CI mesh smoke fails on it). Members NOT on the
        #: mesh are cross-host: the relay is their legitimate DCN
        #: fallback, counted separately. Everything else is an ordinary
        #: external client subscription (the system's edge).
        self.mesh_members: frozenset = frozenset()
        self.cluster_members: frozenset = frozenset()
        self.mesh_member_relays = 0  # must stay 0 while the mesh path serves
        self.dcn_fallback_relays = 0  # cross-host members: expected
        #: wave fences taken over by the WaveValuePublisher:
        #: these shipped as value-block entries, not plain invalidations
        self.published_diverted = 0
        self._disposed = False

    def dispose(self) -> None:
        """Detach from the backend's wave hooks and the hub (idempotent) —
        the same contract FusionMonitor.dispose() has: without it every
        constructed index keeps itself (and its hub) alive through the
        backend's hook list forever."""
        if self._disposed:
            return
        self._disposed = True
        try:
            self.backend.newly_hooks.remove(self._on_newly)
        except ValueError:
            pass
        if self.rpc_hub.compute_fanout is self:
            self.rpc_hub.compute_fanout = None
        from ..diagnostics.metrics import global_metrics

        global_metrics().unregister_collector(self)
        self._by_nid.clear()
        self._nid_arr = None
        self.subscriptions = 0

    # ------------------------------------------------------------------ registry
    def register(
        self,
        nid: int,
        peer: "RpcPeer",
        call_id: int,
        version: Optional[str],
        call=None,
    ) -> None:
        """Index one live subscription. ``call`` (the inbound compute call)
        lets the drain stamp ``_invalidation_pushed`` so the per-computed
        watch task doesn't send the same invalidation a second time."""
        subs = self._by_nid.get(nid)
        if subs is None:
            subs = self._by_nid[nid] = {}
            self._nid_arr = None
        subs[(id(peer), call_id)] = (
            weakref.ref(peer),
            version,
            weakref.ref(call) if call is not None else None,
        )
        self.subscriptions += 1
        self.registered_total += 1

    def unregister(self, nid: int, peer: "RpcPeer", call_id: int) -> None:
        subs = self._by_nid.get(nid)
        if subs is None:
            return
        if subs.pop((id(peer), call_id), None) is not None:
            self.subscriptions -= 1
        if not subs:
            del self._by_nid[nid]
            self._nid_arr = None

    # ------------------------------------------------------------------ drain
    def _subscribed_nids(self) -> np.ndarray:
        if self._nid_arr is None:
            self._nid_arr = np.fromiter(
                self._by_nid.keys(), dtype=np.int64, count=len(self._by_nid)
            )
        return self._nid_arr

    def _on_newly(self, newly) -> None:
        """Wave-application hook: intersect the newly-invalid set with the
        subscribed nids (vectorized) and post each hit's (call_id, version)
        into its peer's outbox pending map (the outbox marshals posts from
        off-loop callers onto its home loop). Runs inside wave application
        — O(subscribed) + one mask gather, never O(wave)."""
        if not self._by_nid:
            return
        if not getattr(self.rpc_hub, "coalesce_invalidations", True):
            # wire-compat mode flipped ON after registrations were made:
            # leave delivery to the per-key invalidation handlers (the
            # pushed-flag is never set, so nothing is lost)
            return
        self.waves_seen += 1
        # the wave's identity + apply timestamp: stamped into every posted
        # entry so the client fence links back to this wave and the e2e
        # delivery histogram measures from the apply moment
        cause = getattr(self.backend, "last_cause_id", None)
        origin_ts = getattr(self.backend, "last_wave_applied_ts", None)
        nids = self._subscribed_nids()
        if isinstance(newly, np.ndarray) and newly.dtype == np.bool_:
            n = len(newly)
            in_range = nids[nids < n]
            hits = in_range[newly[in_range]]
        else:
            newly_ids = np.asarray(newly)
            if newly_ids.size == 0:
                return
            hits = nids[np.isin(nids, newly_ids)]
        # entries batch PER PEER and post under one outbox kick each (the
        # overlap drain shape: a wave's whole fence set for a peer is one
        # wake-up, not one per subscription)
        publisher = getattr(self.rpc_hub, "value_publisher", None)
        publish_nids: Dict[int, Tuple[Optional[str], Optional[float]]] = {}
        per_peer: Dict[int, Tuple[object, list]] = {}
        total_posted = 0
        hotkeys = global_hotkeys()
        for nid in hits.tolist():
            # attribution: one offer per subscribed node the
            # wave invalidated — the sketch that lets /hotkeys and
            # explain() name the keys a hot workload keeps re-fencing
            hotkeys.offer("wave_invalidations", str(nid))
            subs = self._by_nid.pop(nid, None)
            if subs is None:
                continue
            self._nid_arr = None
            self.subscriptions -= len(subs)
            self.drained_total += len(subs)
            posted = 0
            for (_pid, call_id), (peer_ref, version, call_ref) in subs.items():
                peer = peer_ref()
                if peer is None:
                    continue
                if publisher is not None:
                    standing = publisher.peek(_pid, call_id)
                    if standing is not None:
                        # publish-on-wave takeover: this
                        # subscription answers with the recomputed VALUE —
                        # the publisher posts the block (or the counted
                        # fallback fence); no plain invalidation here
                        standing.wave_pending = True
                        publish_nids[nid] = (cause, origin_ts)
                        self.published_diverted += 1
                        if call_ref is not None:
                            call = call_ref()
                            if call is not None:
                                call._invalidation_pushed = True
                        continue
                if call_ref is not None:
                    call = call_ref()
                    if call is not None:
                        # the watch-task backstop will still wake (the
                        # computed invalidates host-side too) but must not
                        # ship this subscription a second time
                        call._invalidation_pushed = True
                entry = per_peer.get(id(peer))
                if entry is None:
                    entry = per_peer[id(peer)] = (peer, [])
                entry[1].append((call_id, version, cause, origin_ts))
                posted += 1
                ref = getattr(peer, "ref", None)
                if ref in self.mesh_members:
                    self.mesh_member_relays += 1
                elif ref in self.cluster_members:
                    self.dcn_fallback_relays += 1
            total_posted += posted
            if posted and RECORDER.enabled:
                # one event per fenced KEY (never per subscription), with
                # the count of fences actually POSTED — dead peers skipped
                # above must not inflate explain()'s "fenced N clients"
                c = self.backend.computed_for(nid)
                RECORDER.note(
                    "client_fenced",
                    key=repr(c.input) if c is not None else f"nid:{nid}",
                    cause=cause,
                    count=posted,
                    detail=f"{posted} subscription(s) via mask drain",
                )
        for peer, entries in per_peer.values():
            peer.outbox.post_invalidations(entries)
        if publish_nids:
            publisher.schedule(publish_nids)
        if total_posted and getattr(self.backend, "overlap_active", False):
            # this drain ran inside a pipeline harvest with the next chain
            # already executing on device — the pipeline overlap in action
            self.drained_overlapped += total_posted

    def set_mesh_scope(self, mesh_members, cluster_members=None) -> None:
        """Name the members co-located on this process's mesh (their
        cross-shard traffic must ride the collectives, never this relay)
        and, optionally, the full cluster membership (members off the mesh
        are counted as DCN fallback rather than plain client fan-out)."""
        from ..diagnostics.metrics import global_metrics

        self.mesh_members = frozenset(mesh_members)
        self.cluster_members = frozenset(
            cluster_members if cluster_members is not None else mesh_members
        )
        reg = global_metrics()
        reg.unregister_collector(self)  # idempotent re-scope
        reg.register_collector(self, ComputeFanoutIndex._collect_mesh_metrics)

    def _collect_mesh_metrics(self) -> dict:
        return {
            "fusion_mesh_member_relays_total": self.mesh_member_relays,
            "fusion_mesh_dcn_fallback_total": self.dcn_fallback_relays,
        }

    def stats(self) -> dict:
        return {
            "subscriptions": self.subscriptions,
            "registered_total": self.registered_total,
            "drained_total": self.drained_total,
            "drained_overlapped": self.drained_overlapped,
            "waves_seen": self.waves_seen,
            "mesh_member_relays": self.mesh_member_relays,
            "dcn_fallback_relays": self.dcn_fallback_relays,
            "published_diverted": self.published_diverted,
        }


def install_compute_fanout(rpc_hub: "RpcHub", backend: "TpuGraphBackend") -> ComputeFanoutIndex:
    """Wire the burst newly-mask to the hub's ``$sys-c`` subscriptions.
    Idempotent per (hub, backend) pairing; returns the index."""
    existing = rpc_hub.compute_fanout
    if existing is not None:
        if existing.backend is backend:
            return existing
        raise ValueError("this hub already has a fanout index on another backend")
    index = ComputeFanoutIndex(rpc_hub, backend)
    rpc_hub.compute_fanout = index
    return index


# ======================================================================
# publish-on-wave value plane — the SERVER half
# ======================================================================


class _StandingSub:
    """One standing publish subscription: (peer, call_id) → key spec.
    Survives the wave fences that retire ordinary ``$sys-c``
    subscriptions — the publisher re-binds it to each recomputed node."""

    __slots__ = (
        "pid", "call_id", "peer_ref", "service", "method", "args",
        "nid", "version", "seq", "wave_pending",
    )

    def __init__(self, peer, call_id, service, method, args, nid, version):
        self.pid = id(peer)
        self.call_id = call_id
        self.peer_ref = weakref.ref(peer)
        self.service = service
        self.method = method
        self.args = args
        self.nid = nid
        self.version = version
        #: last published block seq (the edge's monotonic gate)
        self.seq = 0
        #: set by the fanout drain when a wave fenced this key and the
        #: publisher owns the answer; cleared by the publish round. The
        #: host-led invalidation handler skips pending subs — the wave
        #: path, not it, decides between block and fallback fence.
        self.wave_pending = False


class WaveValuePublisher:
    """Publish-on-wave value blocks (the serialize-once
    thesis one hop upstream): after a wave's apply, recompute the fenced
    hot-set ONCE per key, serialize each value ONCE, and push each
    subscribed edge ONE columnar ``$sys-c.value_block`` frame through its
    outbox — the edge then serves the whole burst with zero per-key
    upstream RPCs.

    The fallback ladder is always a plain invalidation fence (counted,
    never silent): host-led invalidations (reshard fences, manual
    invalidates), recompute errors, non-graph-resident recomputes, links
    that die mid-block, and per-round budget overflows all post the
    ordinary ``invalidate_batch`` entry, which the edge answers with its
    batched re-read (level 1)."""

    def __init__(
        self,
        rpc_hub: "RpcHub",
        max_keys_per_round: int = 8192,
        max_block_bytes: int = 4 << 20,
    ):
        self.rpc_hub = rpc_hub
        #: per-round distinct-key bound: excess keys fence plain (counted)
        self.max_keys_per_round = max_keys_per_round
        #: per-frame payload bound: bigger rounds chunk into several frames
        self.max_block_bytes = max_block_bytes
        self._standing: Dict[Tuple[int, int], _StandingSub] = {}
        self._by_nid: Dict[int, Set[_StandingSub]] = {}
        #: nid → (cause, origin_ts) — the wave fences awaiting a publish
        #: round (latest-wins per nid: two waves before one round = one
        #: recompute at the newest state)
        self._pending: Dict[int, Tuple[Optional[str], Optional[float]]] = {}
        self._seq = itertools.count(1)
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        try:
            self._home_loop: Optional[asyncio.AbstractEventLoop] = (
                asyncio.get_event_loop()
            )
        except RuntimeError:
            self._home_loop = None
        self._disposed = False
        # -- counters (collector-exported as fusion_value_*) --------------
        self.standing_registered_total = 0
        self.rounds = 0
        self.recomputes = 0
        self.blocks_sent = 0
        self.block_keys_sent = 0
        self.block_bytes_sent = 0
        self.values_serialized = 0  # ONE per (key, version), shared by peers
        self.fallback_fences = 0  # plain invalidations posted by the ladder
        self.overflow_fallbacks = 0  # of which: round-budget overflow
        self.loop_faults = 0  # publisher loop crashes (FL002: counted, alertable)
        self.recompute_errors = 0  # service retired / registry miss mid-publish
        self.block_send_failures = 0  # value_block sends lost to a dead link
        from ..diagnostics.metrics import global_metrics

        # publish pressure is non-additive: two half-loaded publishers
        # are half loaded, not fully loaded
        global_metrics().set_aggregation("fusion_value_publish_pressure", "max")
        global_metrics().register_collector(
            self, WaveValuePublisher._collect_metrics
        )

    def _collect_metrics(self) -> dict:
        return {
            "fusion_value_standing_subs": len(self._standing),
            "fusion_value_blocks_sent_total": self.blocks_sent,
            "fusion_value_block_keys_total": self.block_keys_sent,
            "fusion_value_block_bytes_total": self.block_bytes_sent,
            "fusion_value_serialized_total": self.values_serialized,
            "fusion_value_publish_rounds_total": self.rounds,
            "fusion_value_fallback_fences_total": self.fallback_fences,
            "fusion_value_publisher_faults_total": self.loop_faults,
            "fusion_value_recompute_errors_total": self.recompute_errors,
            "fusion_value_block_send_failures_total": self.block_send_failures,
            "fusion_value_publish_pressure": round(self.pressure(), 4),
        }

    def pressure(self) -> float:
        """Publish-plane load, 0..1: fenced keys waiting for
        a publish round against the round budget. An edge-side admission
        controller (or the traffic harness's SLO gates) can read this —
        a backlog at the VALUE plane means fences are about to arrive
        late no matter how fast the edges fan, so shedding should start
        upstream of the fan, not after it."""
        return min(1.0, len(self._pending) / max(1, self.max_keys_per_round))

    # ------------------------------------------------------------------ registry
    def register_standing(
        self, peer: "RpcPeer", call_id: int, service: str, method: str,
        args, computed,
    ) -> bool:
        """Arm one standing publish subscription (a ``recompute_batch``
        entry asked for it). Returns False — publish mode declined — when
        the captured node is not graph-resident (a wave can never fence
        it, so there is nothing to publish on)."""
        if self._disposed:
            return False
        nid = getattr(computed, "_backend_nid", None)
        if nid is None:
            return False
        from ..utils.serialization import deep_tuple

        sub = _StandingSub(
            peer, call_id, service, method, deep_tuple(tuple(args)), int(nid),
            computed.version.format(),
        )
        old = self._standing.get((sub.pid, call_id))
        if old is not None:
            self._discard(old)
        # an edge holds exactly ONE subscription per key: another standing
        # sub for the SAME (peer, nid) under a different call id is a
        # superseded subscription (the edge re-read and re-armed — e.g.
        # after a reconnect or a block-budget eviction). Retire it here,
        # or every later wave would keep recomputing and shipping block
        # entries for a call id the edge only counts as orphans.
        bucket = self._by_nid.get(sub.nid)
        if bucket is not None:
            fanout = self.rpc_hub.compute_fanout
            for stale in [
                s for s in bucket
                if s.pid == sub.pid and s.call_id != call_id
            ]:
                self._discard(stale)
                if fanout is not None:
                    stale_peer = stale.peer_ref()
                    if stale_peer is not None:
                        fanout.unregister(stale.nid, stale_peer, stale.call_id)
        self._standing[(sub.pid, call_id)] = sub
        self._by_nid.setdefault(sub.nid, set()).add(sub)
        self.standing_registered_total += 1
        return True

    def peek(self, pid: int, call_id: int) -> Optional[_StandingSub]:
        return self._standing.get((pid, call_id))

    def drop_standing(self, peer: "RpcPeer", call_id: int) -> None:
        sub = self._standing.get((id(peer), call_id))
        if sub is not None:
            self._discard(sub)

    def _discard(self, sub: _StandingSub) -> None:
        self._standing.pop((sub.pid, sub.call_id), None)
        bucket = self._by_nid.get(sub.nid)
        if bucket is not None:
            bucket.discard(sub)
            if not bucket:
                self._by_nid.pop(sub.nid, None)

    def _drop_and_fence(
        self, sub: _StandingSub, cause: Optional[str], origin_ts: Optional[float],
    ) -> None:
        """The fallback rung: retire the standing registration and post
        the plain invalidation fence — the edge re-reads (batched) and
        re-arms. Counted, never silent."""
        self._discard(sub)
        self.fallback_fences += 1
        peer = sub.peer_ref()
        if peer is None:
            return
        fanout = self.rpc_hub.compute_fanout
        if fanout is not None:
            fanout.unregister(sub.nid, peer, sub.call_id)
        try:
            peer.outbox.post_invalidation(
                sub.call_id, sub.version, cause=cause,
                origin_ts=origin_ts if origin_ts is not None else time.perf_counter(),
            )
        except RuntimeError:  # no running loop: no live link to fence
            pass

    # ------------------------------------------------------------------ schedule
    def schedule(self, nids: Dict[int, Tuple[Optional[str], Optional[float]]]) -> None:
        """Fanout-drain handoff: these nids' standing subs answer this
        wave with a value block. Latest-wins per nid; safe from off-loop
        callers — the MERGE itself marshals to the home loop (not just
        the kick): an off-loop update racing the round's dict swap could
        land entries in a dict nobody reads, and a lost publish round
        here is a silently-stale edge (the drain already suppressed the
        plain invalidation for these subs)."""
        if self._disposed:
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            if self._home_loop is not None and not self._home_loop.is_closed():
                try:
                    self._home_loop.call_soon_threadsafe(
                        self._schedule_on_loop, dict(nids)
                    )
                except RuntimeError:
                    pass  # loop closed: the publisher is going away
            return
        self._schedule_on_loop(nids)

    def _schedule_on_loop(
        self, nids: Dict[int, Tuple[Optional[str], Optional[float]]]
    ) -> None:
        if self._disposed:
            return
        self._pending.update(nids)
        self._kick_on_loop()

    def _kick_on_loop(self) -> None:
        if self._disposed:
            return
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())
        self._wake.set()

    async def _run(self) -> None:
        try:
            while not self._disposed:
                await self._wake.wait()
                self._wake.clear()
                while self._pending and not self._disposed:
                    batch, self._pending = self._pending, {}
                    await self._publish_round(batch)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — the publisher must never die silently
            # counted, not just logged: a dead publisher is every standing
            # sub silently stale (the exact class FL002 exists to catch) —
            # operators alert on this counter, and the next schedule()
            # re-spawns the loop
            self.loop_faults += 1
            log.exception("value publisher loop failed")

    # ------------------------------------------------------------------ publish
    async def _recompute(self, service: str, method: str, args: tuple):
        from ..core.context import suspend_dependency_capture, try_capture

        try:
            service_def = self.rpc_hub.service_registry.require(service)
            fn = service_def.method(method).fn
        except Exception:  # noqa: BLE001 — service retired mid-flight:
            # counted; the caller's fallback fence handles the key
            self.recompute_errors += 1
            return None
        self.recomputes += 1
        with suspend_dependency_capture():
            return await try_capture(lambda: fn(*args))

    def _invalidation_handler_for(self, nid: int):
        """Armed on each recomputed node: a HOST-LED invalidation (not a
        wave the drain diverted) retires the nid's standing subs through
        the fallback fence. Wave-pending subs are the publish round's."""

        def handler(computed) -> None:
            subs = self._by_nid.get(nid)
            if not subs:
                return
            cause = getattr(computed, "_invalidation_cause", None)
            now = time.perf_counter()
            for sub in list(subs):
                if sub.wave_pending:
                    continue
                self._drop_and_fence(sub, cause, now)

        return handler

    async def _publish_round(
        self, batch: Dict[int, Tuple[Optional[str], Optional[float]]]
    ) -> None:
        self.rounds += 1
        items = list(batch.items())
        overflow = items[self.max_keys_per_round:]
        items = items[: self.max_keys_per_round]
        for nid, (cause, t0) in overflow:
            for sub in list(self._by_nid.get(nid, ())):
                sub.wave_pending = False
                self._drop_and_fence(sub, cause, t0)
                self.overflow_fallbacks += 1
        fanout = self.rpc_hub.compute_fanout
        #: id(peer) -> (peer, [(sub, version, cause, t0, value_bytes)])
        blocks: Dict[int, Tuple[object, list]] = {}
        for nid, (cause, t0) in items:
            subs = self._by_nid.get(nid)
            if not subs:
                continue
            spec = next(iter(subs))
            computed = await self._recompute(spec.service, spec.method, spec.args)
            out = computed._output if computed is not None else None
            new_nid = (
                getattr(computed, "_backend_nid", None)
                if computed is not None
                else None
            )
            if computed is not None and computed.is_invalidated and nid in self._pending:
                # the recompute raced a NEWER wave whose drain already
                # re-scheduled this nid: the next round owns the fence —
                # publishing the superseded value would only be churn
                continue
            if (
                computed is None
                or computed.is_invalidated
                or out is None
                or out.has_error
                or new_nid is None
            ):
                # recompute failed / host-led invalidation mid-round /
                # left the graph: fence plain — the edge's batched re-read
                # owns the recovery (and re-arms publish)
                for sub in list(subs):
                    sub.wave_pending = False
                    self._drop_and_fence(sub, cause, t0)
                continue
            version = computed.version.format()
            value_bytes = dumps(out.value)  # ONCE per (key, version) —
            # every subscribed edge's block shares these bytes
            self.values_serialized += 1
            for sub in list(subs):
                sub.wave_pending = False
                peer = sub.peer_ref()
                if peer is None:
                    self._discard(sub)
                    continue
                if int(new_nid) != sub.nid:
                    # the key's row moved (rebuild): re-key the standing sub
                    bucket = self._by_nid.get(sub.nid)
                    if bucket is not None:
                        bucket.discard(sub)
                        if not bucket:
                            self._by_nid.pop(sub.nid, None)
                    sub.nid = int(new_nid)
                    self._by_nid.setdefault(sub.nid, set()).add(sub)
                sub.version = version
                sub.seq = next(self._seq)
                if fanout is not None:
                    # re-register so the NEXT wave's drain finds (and
                    # diverts) this subscription — the single-upstream
                    # count recovers without any client round trip
                    fanout.register(sub.nid, peer, sub.call_id, version, call=None)
                entry = blocks.get(id(peer))
                if entry is None:
                    entry = blocks[id(peer)] = (peer, [])
                entry[1].append((sub, version, cause, t0, value_bytes))
            computed.on_invalidated(self._invalidation_handler_for(int(new_nid)))
            if RECORDER.enabled:
                RECORDER.note(
                    "block_published",
                    key=repr(computed.input),
                    cause=cause,
                    count=len(subs),
                    detail=f"{len(value_bytes)}B to {len(subs)} edge sub(s)",
                )
        for peer, entries in blocks.values():
            await self._send_blocks(peer, entries)

    async def _send_blocks(self, peer, entries) -> None:
        """Ship one peer's round as columnar ``value_block`` frame(s):
        parallel (call_id, version, seq, cause, t0, offset) columns over
        ONE shared payload blob; chunked at ``max_block_bytes``."""
        i = 0
        n = len(entries)
        while i < n:
            cids, vers, seqs, causes, t0s = [], [], [], [], []
            offsets = [0]
            chunks = []
            size = 0
            while i < n and (not cids or size < self.max_block_bytes):
                sub, version, cause, t0, value_bytes = entries[i]
                cids.append(sub.call_id)
                vers.append(version)
                seqs.append(sub.seq)
                causes.append(cause)
                t0s.append(t0)
                chunks.append(value_bytes)
                size += len(value_bytes)
                offsets.append(offsets[-1] + len(value_bytes))
                i += 1
            message = RpcMessage(
                call_type_id=CALL_TYPE_COMPUTE,
                call_id=0,
                service=COMPUTE_SYSTEM_SERVICE,
                method="value_block",
                argument_data=dumps(
                    [cids, vers, seqs, causes, t0s, offsets, b"".join(chunks)]
                ),
            )
            try:
                await peer.send(message)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — link died mid-block: fence
                # plain; the pending invalidations ride the outbox across
                # the reconnect and the edge's re-read re-arms publish.
                # The send failure itself is counted UNCONDITIONALLY — the
                # per-sub fence below only fires for subs still standing,
                # so a flapping link could otherwise drop blocks silently
                self.block_send_failures += 1
                for cid, cause, t0 in zip(cids, causes, t0s):
                    sub = self._standing.get((id(peer), cid))
                    if sub is not None:
                        self._drop_and_fence(sub, cause, t0)
                continue
            self.blocks_sent += 1
            self.block_keys_sent += len(cids)
            self.block_bytes_sent += size

    # ------------------------------------------------------------------ lifecycle
    def dispose(self) -> None:
        if self._disposed:
            return
        self._disposed = True
        if self._task is not None and not self._task.done():
            self._task.cancel()
        if self.rpc_hub.value_publisher is self:
            self.rpc_hub.value_publisher = None
        from ..diagnostics.metrics import global_metrics

        global_metrics().unregister_collector(self)
        self._standing.clear()
        self._by_nid.clear()
        self._pending.clear()

    def stats(self) -> dict:
        return {
            "standing_subs": len(self._standing),
            "standing_registered_total": self.standing_registered_total,
            "rounds": self.rounds,
            "recomputes": self.recomputes,
            "blocks_sent": self.blocks_sent,
            "block_keys_sent": self.block_keys_sent,
            "block_bytes_sent": self.block_bytes_sent,
            "values_serialized": self.values_serialized,
            "fallback_fences": self.fallback_fences,
            "overflow_fallbacks": self.overflow_fallbacks,
            "pending_nids": len(self._pending),
            "pressure": round(self.pressure(), 4),
        }


def install_value_publisher(
    rpc_hub: "RpcHub",
    max_keys_per_round: int = 8192,
    max_block_bytes: int = 4 << 20,
) -> WaveValuePublisher:
    """Install the publish-on-wave value plane on a SERVING hub
    (idempotent). Pair with :func:`install_compute_fanout` — the wave
    drain is what hands fences to the publisher."""
    existing = rpc_hub.value_publisher
    if existing is not None:
        return existing
    publisher = WaveValuePublisher(
        rpc_hub, max_keys_per_round=max_keys_per_round,
        max_block_bytes=max_block_bytes,
    )
    rpc_hub.value_publisher = publisher
    return publisher
