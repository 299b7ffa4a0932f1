"""EdgeNode — the live-query edge gateway.

The missing analogue of the reference's UI tier at scale: where a Blazor
circuit holds one ComputedState per component and SignalR pushes each
re-render, an :class:`EdgeNode` turns server-fenced computeds into live
queries for END-USER sessions — thousands to hundreds of thousands of
SSE/WebSocket subscribers per edge process — without the server ever
seeing more than ONE subscription per distinct key per edge:

- **single-upstream coalescing**: the first session to ask for a key
  creates one ``_KeySub`` — one :class:`~..client.FusionClient` compute
  call whose invalidation rides the coalesced ``$sys-c`` batch frames
  (the server's fan-out cost is per-EDGE, not per-user). Every later
  session for that key attaches to the same sub. The invariant the CI
  smoke asserts: upstream subscriptions == distinct keys, never
  sessions × keys.
- **hierarchical re-fan**: each upstream fence re-reads the key once and
  re-fans the new value to the sub's sessions through per-session bounded
  outboxes (edge/session.py) — latest-wins per key, slow-consumer
  eviction with resume tokens, heartbeats. The shape is Tascade's
  asynchronous reduction tree (PAPERS.md) run in reverse: a wave reaches
  N·M browsers through N edge subscriptions.
- **shard-map-aware affinity**: with a cluster
  :class:`~..cluster.router.ShardMapRouter` installed, each key's
  upstream subscription pins at the key's OWNER member (same rendezvous
  placement the servers use), and an applied ``reshard:<epoch>`` — via
  gossip (``$sys-m.map``), a carried ``ShardMovedError`` map, or the
  owner's own reshard fence — re-subscribes exactly the moved keys at
  their new owner WITHOUT touching downstream sessions: a browser never
  reconnects because the cluster rebalanced.
- **observable end to end**: ``fusion_edge_*`` metrics (sessions, subs,
  frames, coalesced frames, evictions, the fence→client-visible delivery
  histogram), flight-recorder ``edge_fenced`` events carrying the
  originating wave's cause id (``explain()`` spans server wave → edge →
  session), and ``snapshot()`` for ``FusionMonitor.report()["edge"]``.

Scale notes: sessions and frames are slotted/tuple-shaped (the
1M-subscriber simulation in ``stl_fusion_tpu_torch/edge_path.py`` runs in one process);
sink-flavor sessions deliver synchronously with no per-session task, so
a million subscribers cost memory, not scheduler load.
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

from ..client.client_function import FusionClient
from ..core.context import capture
from ..diagnostics.flight_recorder import RECORDER, call_key
from ..diagnostics.metrics import global_metrics
from ..utils.async_utils import TaskSet
from .admission import (
    LANE_ANONYMOUS,
    LANE_RESUME,
    AdmissionDecision,
    AdmissionRejected,
)
from .session import EdgeSession, EncodedFrame, Frame, KeyedMailbox

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["EdgeNode", "KeySpec", "DRAIN_KEY"]

#: the pseudo-key of drain hint frames: EdgeNode.drain() ships
#: one per live session — ``value`` carries the session's resume token,
#: ``cause`` the ``drain:<edge-name>`` family explain() understands. It is
#: not a subscribable key; sinks/transports route on it.
DRAIN_KEY = "$edge/drain"


def _is_shard_moved(e: BaseException) -> bool:
    """Function-local cluster import (client_function.py's rule): the edge
    loads without the cluster package; the check must never cycle."""
    try:
        from ..cluster.shard_map import ShardMovedError
    except ImportError:  # pragma: no cover — cluster ships with the package
        return False
    return isinstance(e, ShardMovedError)

#: a key is named by (method, *args) on the edge's upstream service —
#: e.g. ``("node", 17)`` subscribes ``dag.node(17)``
KeySpec = Union[Tuple[Any, ...], List[Any]]


class _KeySub:
    """One distinct key's upstream subscription + downstream fan list.

    Sessions are PARTITIONED into the node's fan shards (``shards[w]`` is
    the set of attached sessions whose ``session.shard == w``), so the
    hottest key's fan-out is drained by W parallel workers instead of one
    sequential loop. ``sessions`` is the compat union view —
    iteration/len only; membership mutations go through the shard sets.
    """

    __slots__ = (
        "key_str",
        "method",
        "args",
        "version",
        "last_frame",
        "shards",
        "task",
        "peer_ref",
        "closed",
        "parked_refs",
        "pins",
        "repin_cause",
        "_wake",
        "node",
        "needs_reread",
        "pending_fence",
        "backoff",
        "upstream_version",
        "block_mode",
        "block_call_id",
        "block_seq",
        "block_pending",
        "block_size",
        "last_src",
    )

    def __init__(
        self, key_str: str, method: str, args: tuple, n_shards: int = 1,
        backoff: float = 0.05,
    ):
        self.key_str = key_str
        self.method = method
        self.args = args
        #: monotonic per-key version — the resume ordering (Last-Event-ID
        #: style): bumped once per fanned frame, never reused
        self.version = 0
        self.last_frame: Optional[Frame] = None
        self.shards: List[Set[EdgeSession]] = [set() for _ in range(n_shards)]
        self.task: Optional[asyncio.Task] = None
        self.peer_ref: Optional[str] = None
        self.closed = False
        #: parked (evicted/disconnected) sessions holding this key — the
        #: sub must outlive its live sessions while a resume could return
        self.parked_refs = 0
        #: sessionless holds (EdgeNode.acquire_keys — the worker pool's
        #: remote sessions): the sub must outlive local sessions while a
        #: delivery-plane worker still serves the key
        self.pins = 0
        #: set when a shard-map change moved this key's owner: the watch
        #: loop re-subscribes there and stamps the next frame's cause
        self.repin_cause: Optional[str] = None
        #: the watch loop's wake event: repins, value-block arrivals and
        #: fallback fences all signal it (one event, not one side-task per
        #: wake source per cycle)
        self._wake = asyncio.Event()
        #: the current upstream ClientComputed (None while block-fed: the
        #: value plane retires the local node once blocks own the key)
        self.node = None
        #: set by fallback fences / block evictions / reconnects: the next
        #: serve cycle must go upstream (batched re-read)
        self.needs_reread = False
        #: (cause, origin_ts) carried by a fallback fence, stamped onto
        #: the re-read's fanned frame
        self.pending_fence: Optional[Tuple[Optional[str], Optional[float]]] = None
        #: per-sub exponential error backoff (reset on a healthy read)
        self.backoff = backoff
        #: last upstream LTag observed (diagnostics/tests — oracle checks)
        self.upstream_version: Optional[str] = None
        #: True once the server armed a standing publish registration for
        #: this key: fences arrive as value-block pushes, zero per-key RPCs
        self.block_mode = False
        self.block_call_id: Optional[int] = None
        #: last applied block seq — the monotonic stale-entry gate
        self.block_seq = 0
        #: latest unserved block entry (seq, version, value, cause, t0) —
        #: latest-wins: a newer entry replaces an unserved older one
        self.block_pending: Optional[tuple] = None
        self.block_size = 0  # pending entry's payload bytes (budget share)
        #: how the latest fanned frame's value was served ("wave block" /
        #: "batched re-read" / "per-key re-read") — explain() names it
        self.last_src: Optional[str] = None

    @property
    def sessions(self) -> Set[EdgeSession]:
        """Union view over the shard partitions (tests/operators; the hot
        paths use the shard sets and :attr:`session_count` directly)."""
        if len(self.shards) == 1:
            return self.shards[0]
        out: Set[EdgeSession] = set()
        for bucket in self.shards:
            out |= bucket
        return out

    @property
    def session_count(self) -> int:
        return sum(len(bucket) for bucket in self.shards)

    def add_session(self, session: EdgeSession) -> None:
        self.shards[session.shard].add(session)

    def discard_session(self, session: EdgeSession) -> None:
        self.shards[session.shard].discard(session)

    @property
    def unreferenced(self) -> bool:
        return (
            self.session_count == 0 and self.parked_refs <= 0 and self.pins <= 0
        )

    def repin(self, cause: str) -> None:
        self.repin_cause = cause
        self._wake.set()


class _FanShard:
    """One fan worker: a latest-wins (per key) queue of encoded frames +
    the drain task that walks ITS partition of each sub's sessions. The
    watch loop posts once per shard instead of walking every session
    itself, so W shards drain the hottest key concurrently and a fence
    for another key never queues behind a 250k-session fan."""

    __slots__ = ("node", "index", "_pending", "_event", "task",
                 "busy_ms", "delivered", "drains", "coalesced")

    def __init__(self, node: "EdgeNode", index: int):
        self.node = node
        self.index = index
        #: key_str -> (sub, frame, encoded) — latest-wins: a newer version
        #: posted before the drain REPLACES the older one (those sessions
        #: could never have seen it; counted as coalesced)
        self._pending: Dict[str, tuple] = {}
        self._event = asyncio.Event()
        self.task: Optional[asyncio.Task] = None
        self.busy_ms = 0.0
        self.delivered = 0
        self.drains = 0
        self.coalesced = 0

    def post(self, sub: _KeySub, frame: Frame, encoded: EncodedFrame) -> None:
        if sub.key_str in self._pending:
            self.coalesced += 1
        self._pending[sub.key_str] = (sub, frame, encoded)
        self._event.set()
        if self.task is None or self.task.done():
            self.task = asyncio.get_event_loop().create_task(self._run())

    def snapshot(self) -> dict:
        return {
            "busy_ms": round(self.busy_ms, 3),
            "delivered": self.delivered,
            "drains": self.drains,
            "coalesced": self.coalesced,
            "pending": len(self._pending),
        }

    async def _run(self) -> None:
        try:
            while True:
                while not self._pending:
                    self._event.clear()
                    await self._event.wait()
                self._event.clear()
                batch = list(self._pending.values())
                self._pending.clear()
                t0 = time.perf_counter()
                for sub, frame, encoded in batch:
                    self.node._fan_shard_deliver(self, sub, frame, encoded)
                self.busy_ms += (time.perf_counter() - t0) * 1e3
                self.drains += 1
                # yield between drains: siblings (and the watch loops) get
                # the loop even while one shard stays hot
                await asyncio.sleep(0)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a fan shard must never die silently
            log.exception(
                "edge %s: fan shard %d failed", self.node.name, self.index
            )


class _RereadBatcher:
    """The upstream value plane's LEVEL 1: fence-burst re-reads
    coalesce into ONE ``$sys-c.recompute_batch`` RPC per owner peer. A
    ``$sys-c`` batch frame wakes every fenced key's watch loop in the same
    event-loop ticks; each loop submits here and awaits its own entry, and
    the batcher flushes the owner's bucket after ``reread_batch_window``
    (or at ``reread_batch_max`` keys) — the per-key capture still runs on
    the server, but the RPC/codec/loop-hop envelope is paid once per burst
    instead of once per key (the ~2 ms/key storm tail of the per-key path)."""

    __slots__ = ("node", "_pending", "_timers", "_flights")

    def __init__(self, node: "EdgeNode"):
        self.node = node
        #: owner peer ref -> [(sub, future)] awaiting the next flush
        self._pending: Dict[str, list] = {}
        self._timers: Dict[str, Any] = {}
        #: in-flight flush tasks — a lifecycle owner, not a fire-and-forget
        #: spawn: a flush mid-RPC when the node closes must be cancelled or
        #: it races the teardown's future sweep (fusionlint FL003)
        self._flights = TaskSet(name=f"edge-reread-flush")

    def submit(self, owner: str, sub: _KeySub) -> "asyncio.Future":
        loop = asyncio.get_event_loop()
        future = loop.create_future()
        bucket = self._pending.setdefault(owner, [])
        bucket.append((sub, future))
        if len(bucket) >= self.node.reread_batch_max:
            self._fire(owner)
        elif owner not in self._timers:
            # pressure-widened: under load the window grows so
            # each upstream frame amortizes more keys; it snaps back to
            # the configured base as soon as the pressure sources drop
            window = self.node.effective_reread_window()
            if window > 0:
                self._timers[owner] = loop.call_later(window, self._fire, owner)
            else:
                self._timers[owner] = loop.call_soon(self._fire, owner)
        return future

    def _fire(self, owner: str) -> None:
        timer = self._timers.pop(owner, None)
        if timer is not None:
            timer.cancel()
        batch = self._pending.pop(owner, None)
        if not batch:
            return
        if self._flights.closed:  # node closed between timer arm and fire
            for _sub, future in batch:
                if not future.done():
                    future.cancel()
            return
        self._flights.spawn(self._flush(owner, batch))

    async def _flush(self, owner: str, batch: list) -> None:
        node = self.node
        client = node._client_for(owner)
        node.reread_batches += 1
        node.upstream_rpcs += 1
        node.reread_batch_keys += len(batch)
        node._batch_size_hist.record(len(batch))
        requests = [
            (sub.method, sub.args, node.value_blocks) for sub, _f in batch
        ]
        try:
            results = await client.capture_batch(requests)
        except asyncio.CancelledError:
            for _sub, future in batch:
                if not future.done():
                    future.cancel()
            raise
        except Exception as e:  # noqa: BLE001 — whole-frame failure: every
            # entry falls back per-key in its own watch loop (counted there)
            for _sub, future in batch:
                if not future.done():
                    future.set_exception(e)
            return
        for (_sub, future), result in zip(batch, results):
            if future.done():
                continue
            if isinstance(result, BaseException):
                future.set_exception(result)
            else:
                future.set_result(result)

    def cancel_all(self) -> None:
        for timer in self._timers.values():
            timer.cancel()
        self._timers.clear()
        self._flights.cancel()
        pending, self._pending = self._pending, {}
        for bucket in pending.values():
            for _sub, future in bucket:
                if not future.done():
                    future.cancel()


class EdgeNode:
    """One edge gateway process: holds exactly one upstream subscription
    per distinct key and re-fans each fence to its downstream sessions.

    ``rpc_hub`` is the edge's OWN client hub (dialing the server tier);
    ``fusion_hub`` its own computed graph (ClientComputeds intern there).
    ``router`` (optional) is a cluster ``ShardMapRouter`` — when present
    it is installed as the hub's call router, upstream subscriptions pin
    at each key's owner, and epoch changes re-pin moved keys."""

    def __init__(
        self,
        service: str,
        rpc_hub,
        fusion_hub=None,
        router=None,
        default_peer: str = "default",
        name: str = "edge",
        resume_ttl: float = 60.0,
        max_pending: int = 4096,
        error_backoff: float = 0.05,
        error_backoff_max: float = 1.0,
        allowed_methods=None,
        max_keys_per_session: int = 1024,
        fan_workers: int = 1,
        reread_batch: bool = True,
        reread_batch_window: float = 0.002,
        reread_batch_max: int = 512,
        value_blocks: bool = True,
        block_budget_bytes: int = 64 << 20,
        admission=None,
        pressure_widen: float = 4.0,
        pressure_fan_depth: int = 1024,
    ):
        from ..core.hub import FusionHub

        self.service = service
        self.rpc_hub = rpc_hub
        self.fusion_hub = fusion_hub or FusionHub()
        self.router = router
        self.default_peer = default_peer
        self.name = name
        self.resume_ttl = resume_ttl
        self.max_pending = max_pending
        self.error_backoff = error_backoff
        #: exponential-backoff cap for the watch loops' upstream retry
        #: paths (errors AND shard-move transients): a flapping upstream
        #: key backs off per-sub instead of hot-spinning 512 loops
        self.error_backoff_max = max(error_backoff, error_backoff_max)
        #: value plane level 1: coalesce fence-burst re-reads into ONE
        #: recompute_batch RPC per owner (False = the per-key A/B shape)
        self.reread_batch = reread_batch
        self.reread_batch_window = reread_batch_window
        self.reread_batch_max = max(1, int(reread_batch_max))
        #: value plane level 2: ask the serving member for publish-on-wave
        #: value blocks — fences then arrive WITH the recomputed value and
        #: a block-warm burst costs zero per-key upstream RPCs
        self.value_blocks = value_blocks
        #: bound on UNSERVED pending block-entry bytes across keys; an
        #: entry over budget is dropped (counted) and its key falls back
        #: to the batched re-read — never silent, never unbounded
        self.block_budget_bytes = block_budget_bytes
        #: method allowlist for key specs. The edge transports forward
        #: client-supplied (method, args) into upstream compute calls, so
        #: a node behind a PUBLIC EdgeHttpServer/EdgeWebSocketServer
        #: should name exactly its live-query read methods here; None
        #: (the in-process/trusted default) allows any public method —
        #: EDGE.md documents the trust boundary.
        self.allowed_methods = (
            frozenset(allowed_methods) if allowed_methods is not None else None
        )
        #: distinct keys one session may subscribe: bounds the upstream
        #: subscription state a single connection can mint
        self.max_keys_per_session = max_keys_per_session
        #: the overload-safety plane: an AdmissionController
        #: consulted by attach()/resume() (unless the transport already
        #: admitted) and by both transports; None = no admission control
        #: (the in-process/benchmark default — existing behavior)
        self.admission = admission
        #: how far the upstream re-read batching window widens under
        #: pressure: effective = base * (1 + pressure_widen * pressure).
        #: Overload then degrades to bigger (cheaper per key) upstream
        #: batches — higher latency — before it degrades to evictions.
        self.pressure_widen = pressure_widen
        #: fan-shard queue depth (pending distinct keys across shards) at
        #: which the fan plane reports FULL pressure (1.0)
        self.pressure_fan_depth = max(1, int(pressure_fan_depth))
        if admission is not None:
            admission.add_pressure_source(
                f"{name}:fan_shards", self._fan_pressure
            )
        #: fan shards: sessions partition round-robin over W
        #: parallel fan workers; each upstream fence posts ONE encoded
        #: frame per shard instead of walking every session in the watch
        #: loop
        self.fan_workers = max(1, int(fan_workers))
        self._fan_shards = [_FanShard(self, w) for w in range(self.fan_workers)]
        self._shard_rr = 0
        #: version-keyed serialize-once cache: key_str -> the
        #: latest fanned frame's EncodedFrame; every downstream transport
        #: writes the same immutable bytes. Bounded by live distinct keys
        #: (entries drop with their sub's teardown — the parked-session
        #: sweep path included).
        self._encoded: Dict[str, EncodedFrame] = {}
        #: delivery-plane broadcast hooks (the multi-process worker pool):
        #: called once per fanned frame with (key_str, frame, encoded)
        self._broadcasts: List = []
        #: attached EdgeWorkerPool (set by EdgeWorkerPool.start) — owned
        #: by the caller unless attached, then close() stops it
        self.worker_pool = None
        if router is not None:
            # affinity + gossip: route through the cluster map, and re-pin
            # moved keys on every applied epoch (membership pushes /
            # ShardMovedError-carried maps both land in apply_map)
            rpc_hub.call_router = router
            router.on_map_change.append(self._on_map_change)
        self._subs: Dict[str, _KeySub] = {}
        self._clients: Dict[str, FusionClient] = {}
        #: the level-1 batcher (one per node; buckets per owner peer)
        self._batcher = _RereadBatcher(self)
        #: publish-mode routing: upstream call_id -> its sub (the block
        #: frames and fallback fences address subscriptions by call id)
        self._block_calls: Dict[int, _KeySub] = {}
        #: total UNSERVED pending block bytes (the block_budget_bytes gauge)
        self._block_pending_bytes = 0
        #: per-owner reconnect monitor tasks (block-fed keys have no
        #: registered outbound call to ride the reconnect re-send, so the
        #: node itself re-reads them when an upstream link returns)
        self._monitor_tasks: List[asyncio.Task] = []
        if value_blocks:
            # route inbound $sys-c value_block frames + fallback fences
            # for retired publish-mode calls to this node. One value-plane
            # client per rpc hub: a second node on the SAME hub keeps the
            # plain re-read ladder (counted path, never silently wrong).
            if getattr(rpc_hub, "value_plane_client", None) is None:
                rpc_hub.value_plane_client = self
            else:
                log.warning(
                    "edge %s: rpc hub %s already has a value-plane client; "
                    "value blocks disabled on this node", name, rpc_hub.name,
                )
                self.value_blocks = False
        self._sessions: Set[EdgeSession] = set()
        #: token → (key specs, delivered-version map, expiry deadline)
        self._parked: Dict[str, Tuple[tuple, Dict[str, int], float]] = {}
        #: next full expiry sweep (monotonic): the purge amortizes — a
        #: full scan per detach would make a reconnect storm O(parked²)
        self._next_purge = 0.0
        #: timer for the QUIESCENT sweep: with no attach/detach traffic
        #: nothing else calls the purge, and the last disconnectors'
        #: parked refs would pin their subs (and upstream subscriptions)
        #: past resume_ttl forever
        self._sweep_handle = None
        self._closed = False
        #: set by drain(): no new admissions, live sessions hinted +
        #: parked; the node keeps serving resumes of OTHER nodes' state
        #: only through import_parked on a fresh node
        self._draining = False
        # -- counters (collector-exported as fusion_edge_*) ---------------
        self.frames_fanned = 0
        self.coalesced_frames = 0  # latest-wins drops inside session mailboxes
        #: distinct (key, version) wire payloads actually serialized — the
        #: amortization numerator: deliveries / encodes is the serialize-
        #: once win (CI gates encodes ≈ fenced pairs ≪ deliveries)
        self.frames_encoded = 0
        #: encodes that fell back to repr for a non-JSON payload —
        #: detected ONCE at encode time, never silently per session
        self.frames_lossy = 0
        #: client-visible session deliveries (sink returns + transport-
        #: accepted pump batches); the amortization denominator
        self.deliveries = 0
        self.evictions = 0
        self.resumes = 0
        self.resumes_expired = 0  # resume() hit an expired-unswept token
        self.resubscribes = 0  # upstream re-pins after a shard move
        # -- overload safety -----------------------------------
        self.drains = 0  # drain() invocations (fusion_edge_drains_total)
        self.sessions_drained = 0  # sessions hinted + parked by drains
        #: shed counts when NO AdmissionController is installed (the
        #: transports' unified rejection path still counts); with a
        #: controller, sheds ride its per-reason counters instead
        self._shed_local: Dict[str, int] = {}
        self.upstream_fences = 0
        self.upstream_errors = 0
        self.sessions_attached_total = 0
        # -- the upstream value plane --------------------------
        #: upstream RPC round trips: batch frames + per-key captures — the
        #: CI gate's numerator (block-warm bursts must keep this flat)
        self.upstream_rpcs = 0
        self.per_key_rereads = 0  # per-key capture round trips
        self.reread_batches = 0  # recompute_batch frames sent
        self.reread_batch_keys = 0  # keys those frames carried
        self.reread_fallbacks = 0  # batch entries that fell back per-key
        self.upstream_backoffs = 0  # error/transient backoff sleeps
        self.block_hits = 0  # fans served from a wave value block (0 RPCs)
        self.block_entries = 0  # block entries received
        self.block_stale = 0  # entries dropped by the seq gate
        self.block_evictions = 0  # entries dropped by the byte budget
        self.block_fences = 0  # fallback fences for block-fed keys
        self.block_reshard_drops = 0  # pending entries dropped by repins
        self.block_orphans = 0  # entries for unknown/closed call ids
        self.reconnect_rereads = 0  # block-fed keys re-read on reconnect
        self._delivery_hist = global_metrics().histogram(
            "fusion_edge_delivery_ms",
            help="server fence (wave apply) -> edge session client-visible",
        )
        # attribution: per-key delivery offers into the
        # process hot-key board — /hotkeys and explain() name the keys
        # that dominate the edge fan
        from ..diagnostics.hotkeys import global_hotkeys

        self._hotkeys = global_hotkeys()
        self._batch_size_hist = global_metrics().histogram(
            "fusion_edge_reread_batch_size",
            help="keys per recompute_batch upstream frame",
        )
        # the effective window is non-additive: N nodes at 2 ms are at
        # 2 ms, not 2N ms (fusion_edge_draining stays summed — the count
        # of currently-draining nodes in the process IS the operator
        # signal during a rolling deploy)
        global_metrics().set_aggregation("fusion_edge_reread_window_ms", "max")
        global_metrics().register_collector(self, EdgeNode._collect_metrics)

    # ------------------------------------------------------------------ metrics
    def _collect_metrics(self) -> dict:
        out = {
            "fusion_edge_sessions": len(self._sessions),
            "fusion_edge_parked_sessions": len(self._parked),
            "fusion_edge_upstream_subscriptions": len(self._subs),
            "fusion_edge_frames_sent_total": self.frames_fanned,
            "fusion_edge_coalesced_frames_total": self.coalesced_frames,
            "fusion_edge_frames_encoded_total": self.frames_encoded,
            "fusion_edge_frames_lossy_total": self.frames_lossy,
            "fusion_edge_deliveries_total": self.deliveries,
            "fusion_edge_fan_shard_busy_ms": round(
                sum(s.busy_ms for s in self._fan_shards), 3
            ),
            "fusion_edge_fan_workers": self.fan_workers,
            "fusion_edge_evictions_total": self.evictions,
            "fusion_edge_resumes_total": self.resumes,
            "fusion_edge_resumes_expired_total": self.resumes_expired,
            "fusion_edge_resubscribes_total": self.resubscribes,
            "fusion_edge_drains_total": self.drains,
            "fusion_edge_sessions_drained_total": self.sessions_drained,
            "fusion_edge_draining": 1 if self._draining else 0,
            "fusion_edge_reread_window_ms": round(
                self.effective_reread_window() * 1e3, 3
            ),
            "fusion_edge_upstream_fences_total": self.upstream_fences,
            "fusion_edge_upstream_errors_total": self.upstream_errors,
            "fusion_edge_upstream_rpcs_total": self.upstream_rpcs,
            "fusion_edge_per_key_rereads_total": self.per_key_rereads,
            "fusion_edge_reread_batches_total": self.reread_batches,
            "fusion_edge_reread_batch_keys_total": self.reread_batch_keys,
            "fusion_edge_reread_fallbacks_total": self.reread_fallbacks,
            "fusion_edge_upstream_backoffs_total": self.upstream_backoffs,
            "fusion_edge_value_block_hits_total": self.block_hits,
            "fusion_edge_value_block_entries_total": self.block_entries,
            "fusion_edge_value_block_stale_total": self.block_stale,
            "fusion_edge_value_block_evictions_total": self.block_evictions,
            "fusion_edge_value_block_fences_total": self.block_fences,
            "fusion_edge_value_block_pending_bytes": self._block_pending_bytes,
        }
        if self.admission is None:
            for reason, count in self._shed_local.items():
                out[f'fusion_edge_shed_total{{reason="{reason}"}}'] = count
        pool = self.worker_pool
        if pool is not None:
            # last-pulled worker aggregates (the pool's stats() refreshes
            # them; collectors must stay sync)
            out["fusion_edge_workers"] = pool.n_workers
            out["fusion_edge_worker_deliveries_total"] = pool.deliveries_seen
        return out

    def snapshot(self) -> dict:
        """Operator view (FusionMonitor.report()["edge"], GET /shards-style
        merges): counts + upstream placement."""
        owners: Dict[str, int] = {}
        for sub in self._subs.values():
            if sub.peer_ref is not None:
                owners[sub.peer_ref] = owners.get(sub.peer_ref, 0) + 1
        pool = self.worker_pool
        out = {
            "name": self.name,
            "service": self.service,
            "sessions": len(self._sessions),
            "parked_sessions": len(self._parked),
            "upstream_subscriptions": len(self._subs),
            "upstream_by_owner": owners,
            "frames_fanned": self.frames_fanned,
            "coalesced_frames": self.coalesced_frames,
            "frames_encoded": self.frames_encoded,
            "frames_lossy": self.frames_lossy,
            "deliveries": self.deliveries,
            # deliveries per encode — the serialize-once amortization
            # ratio an operator reads first; worker-pool
            # deliveries ride the SAME encodes, so they count
            "encode_ratio": round(
                (
                    self.deliveries
                    + (pool.deliveries_seen if pool is not None else 0)
                )
                / self.frames_encoded,
                1,
            )
            if self.frames_encoded
            else None,
            "fan_workers": self.fan_workers,
            "fan_shards": [s.snapshot() for s in self._fan_shards],
            "evictions": self.evictions,
            "resumes": self.resumes,
            "resumes_expired": self.resumes_expired,
            "resubscribes": self.resubscribes,
            "upstream_fences": self.upstream_fences,
            "upstream_errors": self.upstream_errors,
            # overload safety: drain + admission state — an
            # operator mid-deploy reads draining/drained first
            "draining": self._draining,
            "drains": self.drains,
            "sessions_drained": self.sessions_drained,
            "admission": (
                self.admission.snapshot() if self.admission is not None
                else {"shed": dict(self._shed_local)}
            ),
            "reread_window_ms": round(self.effective_reread_window() * 1e3, 3),
            # the upstream value plane: how this node's fences
            # were actually served — an operator reads block_hit_ratio
            # first (1.0 = zero per-key upstream RPCs on warm bursts)
            "value_plane": {
                "reread_batch": self.reread_batch,
                "value_blocks": self.value_blocks,
                "upstream_rpcs": self.upstream_rpcs,
                "per_key_rereads": self.per_key_rereads,
                "reread_batches": self.reread_batches,
                "reread_batch_keys": self.reread_batch_keys,
                "reread_fallbacks": self.reread_fallbacks,
                "block_hits": self.block_hits,
                "block_entries": self.block_entries,
                "block_stale": self.block_stale,
                "block_evictions": self.block_evictions,
                "block_fences": self.block_fences,
                "block_fed_keys": sum(
                    1 for s in self._subs.values() if s.block_mode
                ),
                "block_hit_ratio": round(
                    self.block_hits / self.upstream_fences, 3
                )
                if self.upstream_fences
                else None,
                "upstream_backoffs": self.upstream_backoffs,
            },
            # the delivery histogram is ONE process-wide registry metric
            # (every in-process edge node records into it) — named so a
            # multi-node report is never misread as this node's own
            # distribution; per-node triage uses the counters above
            "delivery_ms_process": self._delivery_hist.snapshot(),
        }
        if pool is not None:
            out["worker_pool"] = pool.snapshot()
        return out

    # ------------------------------------------------------------------ keys
    def _normalize(self, spec: KeySpec) -> Tuple[str, tuple]:
        if isinstance(spec, str):
            raise TypeError(
                f"key spec must be (method, *args), got string {spec!r} — "
                f"the HTTP layer parses wire keys before attach()"
            )
        method, *args = tuple(spec)
        method = str(method)
        if method.startswith("_") or (
            self.allowed_methods is not None and method not in self.allowed_methods
        ):
            raise ValueError(f"method {method!r} is not subscribable on this edge")
        return method, tuple(args)

    def key_str(self, spec: KeySpec) -> str:
        method, args = self._normalize(spec)
        # the SAME call-shaped journal key the rpc client stamps its fence
        # events with — what lets explain() join server wave → edge hop
        return call_key(self.service, method, args)

    def _owner_of(self, method: str, args: tuple) -> str:
        router = self.router
        if router is not None:
            owner = router.shard_map.owner_of(
                router.key_for(self.service, method, args)
            )
            if owner is not None:
                return owner
        return self.default_peer

    def _client_for(self, peer_ref: str) -> FusionClient:
        client = self._clients.get(peer_ref)
        if client is None:
            client = FusionClient(
                self.service,
                self.rpc_hub,
                self.fusion_hub,
                peer_ref,
                cluster_routed=self.router is not None,
            )
            self._clients[peer_ref] = client
            if self.value_blocks:
                # block-fed keys hold no registered outbound call, so the
                # reconnect re-send machinery cannot heal them — this
                # monitor re-reads them when the owner's link returns
                # (one task per OWNER peer, never per key)
                try:
                    self._monitor_tasks.append(
                        asyncio.get_event_loop().create_task(
                            self._reconnect_monitor(peer_ref)
                        )
                    )
                except RuntimeError:  # no loop (sync construction in tests)
                    pass
        return client

    async def _reconnect_monitor(self, peer_ref: str) -> None:
        """Watch one owner peer's connection state: every reconnect marks
        that owner's BLOCK-FED subs for a (batched) re-read — a block or
        fallback fence lost with the dead link must not strand a key on a
        stale value forever. Terminated peers are the repin machinery's."""
        try:
            peer = self.rpc_hub.client_peer(peer_ref)
            ev = peer.connection_state.latest()
            while not self._closed:
                ev = await ev.when(lambda s: s.is_connected or s.is_terminated)
                if ev.value.is_terminated or self._closed:
                    return
                ev = await ev.when(lambda s: not s.is_connected)
                if ev.value.is_terminated or self._closed:
                    return
                # the link dropped; when it returns, re-read block-fed keys
                ev = await ev.when(lambda s: s.is_connected or s.is_terminated)
                if ev.value.is_terminated or self._closed:
                    return
                for sub in self._subs.values():
                    if sub.block_mode and sub.peer_ref == peer_ref:
                        sub.needs_reread = True
                        self.reconnect_rereads += 1
                        sub._wake.set()
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a monitor must never die silently
            log.exception(
                "edge %s: reconnect monitor for %s failed", self.name, peer_ref
            )

    # ------------------------------------------------------------------ attach
    def attach(
        self,
        keys: Sequence[KeySpec],
        sink=None,
        mailbox: Optional[KeyedMailbox] = None,
        track_versions: bool = True,
        replay_current: bool = True,
        tenant: str = "",
        lane: Optional[str] = None,
        admitted=None,
    ) -> EdgeSession:
        """Register one downstream session over ``keys``. Exactly one of
        ``sink`` (synchronous delivery) / ``mailbox`` (pump-drained) —
        see :class:`~.session.EdgeSession`. Each key's upstream
        subscription is created on FIRST use and shared by every later
        session (the single-upstream invariant). With ``replay_current``
        the session immediately receives each key's latest known frame.

        With an :class:`~.admission.AdmissionController` installed the
        attach is ADMITTED OR SHED first (``tenant``/``lane`` feed the
        decision; a shed raises :class:`AdmissionRejected`, counted) —
        unless the transport already admitted and passes its decision as
        ``admitted``. Without a controller only a drain refuses."""
        if self._closed:
            raise RuntimeError(f"edge node {self.name} is closed")
        if self._draining:
            # checked FIRST (even for pre-admitted/transport calls, and
            # with no controller installed): a draining node answers a
            # counted shed the transports turn into a 503 — never an
            # uncounted exception that drops the socket
            raise self._drain_rejection(lane)
        if self.admission is not None and admitted is None:
            decision = self.admission.admit(
                tenant_id=tenant, lane=lane, keys=len(keys)
            )
            if not decision.admitted:
                self._note_shed_event(decision.reason, lane=decision.lane)
                raise AdmissionRejected(decision)
        if len(keys) > self.max_keys_per_session:
            raise ValueError(
                f"session asks for {len(keys)} keys; this edge caps at "
                f"{self.max_keys_per_session} per session"
            )
        specs = [self._normalize(k) for k in keys]
        key_strs = tuple(call_key(self.service, m, a) for m, a in specs)
        session = EdgeSession(
            key_strs, sink=sink, mailbox=mailbox, track_versions=track_versions
        )
        self._assign_shard(session)
        self._sessions.add(session)
        self.sessions_attached_total += 1
        for (method, args), ks in zip(specs, key_strs):
            sub = self._sub_for(ks, method, args)
            sub.add_session(session)
        if replay_current:
            # replay AFTER the session joined every sub: a replay that
            # evicts (broken sink, overflow) has detached the session from
            # all of them — adding it to later subs afterwards would leave
            # a ghost that pins the sub forever
            for ks in key_strs:
                if session.evicted:
                    break
                sub = self._subs.get(ks)
                if sub is not None and sub.last_frame is not None:
                    self._deliver_contained(session, sub.last_frame)
        return session

    def _deliver_contained(self, session: EdgeSession, frame: Frame) -> None:
        """Replay-path delivery with the same broken-consumer containment
        as the fan loop: a sink that raises (or a mailbox that overflows)
        evicts THAT session instead of bubbling into attach()/resume().

        The replayed frame ships WITHOUT the fence's origin timestamp: the
        fence happened while this session was absent, so recording (or
        letting the client record) now-minus-then as "delivery latency"
        would poison the fence→client-visible histogram with reconnect
        gaps. The cause id stays — causality is still true."""
        if frame[4] is not None:
            frame = (frame[0], frame[1], frame[2], frame[3], None, frame[5])
        try:
            ok = session.deliver(frame)
        except Exception:  # noqa: BLE001
            log.exception("edge %s: session sink failed on replay; evicting", self.name)
            ok = False
        if not ok and not session.evicted:
            self.evict(session, reason="replay delivery failed")

    def _assign_shard(self, session: EdgeSession) -> None:
        """Round-robin fan-shard placement by attach ordinal — sessions
        partition evenly over the W fan workers."""
        session.shard = self._shard_rr % self.fan_workers
        self._shard_rr += 1

    def _sub_for(self, key_str: str, method: str, args: tuple) -> _KeySub:
        sub = self._subs.get(key_str)
        if sub is None:
            sub = self._subs[key_str] = _KeySub(
                key_str, method, args, n_shards=self.fan_workers,
                backoff=self.error_backoff,
            )
            sub.task = asyncio.get_event_loop().create_task(self._watch(sub))
        return sub

    # ------------------------------------------------------------------ pinning
    def acquire_keys(self, keys: Sequence[KeySpec]) -> List[str]:
        """Hold upstream subscriptions WITHOUT a local session (the
        multi-process delivery plane: workers own the sockets, this node
        owns the upstream subs). Each acquired key's sub stays alive until
        the matching :meth:`release_keys`. Returns the key_strs (the
        broadcast identity). Validation (allowlist, underscore methods)
        applies exactly as for attach()."""
        if self._closed:
            raise RuntimeError(f"edge node {self.name} is closed")
        specs = [self._normalize(k) for k in keys]
        key_strs = [call_key(self.service, m, a) for m, a in specs]
        for (method, args), ks in zip(specs, key_strs):
            sub = self._sub_for(ks, method, args)
            sub.pins += 1
        return key_strs

    def release_keys(self, key_strs: Sequence[str]) -> None:
        """Release :meth:`acquire_keys` holds; a sub with no sessions, no
        parked refs and no pins tears down (and its encoded-cache entry
        drops with it)."""
        for ks in key_strs:
            sub = self._subs.get(ks)
            if sub is None:
                continue
            sub.pins -= 1
            if sub.unreferenced:
                self._teardown_sub(sub)

    # ------------------------------------------------------------------ encode
    def encode_frame(self, frame: Frame) -> EncodedFrame:
        """The serialize-once cache: ONE wire encode per
        (key, version), shared by every downstream session's pump, the
        fan shards and the worker-pool broadcast. A cache hit is a dict
        probe; the cache holds the LATEST version per key (latest-wins
        delivery means older versions can only be asked for by a pump
        that raced a newer fence — encoded then, but never cached over a
        newer entry)."""
        key, version = frame[0], frame[1]
        has_t0 = frame[4] is not None
        cached = self._encoded.get(key)
        if cached is not None and cached.version == version:
            if cached.has_t0 == has_t0:
                return cached
            # the t0-stripped replay twin (attach/resume replays must not
            # ship the stale fence timestamp): encoded once, cached on
            # the canonical entry
            variant = cached.replay_variant
            if variant is not None and variant.has_t0 == has_t0:
                return variant
            variant = EncodedFrame(frame)
            self.frames_encoded += 1
            if variant.lossy:
                self.frames_lossy += 1
            cached.replay_variant = variant
            return variant
        encoded = EncodedFrame(frame)
        self.frames_encoded += 1
        if encoded.lossy:
            self.frames_lossy += 1
        if cached is None or version > cached.version:
            self._encoded[key] = encoded
        return encoded

    def detach(self, session: EdgeSession, park: bool = True) -> Optional[str]:
        """Remove a session. With ``park`` (the disconnect default) its
        delivered-version map is kept for ``resume_ttl`` seconds under the
        session's token, so a reconnect resumes exactly where it left off;
        returns the token (None when not parked). An upstream sub whose
        last live AND parked reference is gone tears down — the server
        subscription count follows the distinct-key demand."""
        if session not in self._sessions:
            return None
        self._sessions.discard(session)
        session.evicted = True
        token: Optional[str] = None
        if park:
            self._purge_parked()
            self._parked[session.token] = (
                session.keys,
                session.resume_state(),
                time.monotonic() + self.resume_ttl,
            )
            token = session.token
            self._arm_sweep()
        for ks in session.keys:
            sub = self._subs.get(ks)
            if sub is None:
                continue
            sub.discard_session(session)
            if park:
                sub.parked_refs += 1
            if sub.unreferenced:
                self._teardown_sub(sub)
        return token

    def resume(
        self, token: str, sink=None, mailbox=None, tenant: str = "",
        admitted=None,
    ) -> EdgeSession:
        """Re-attach a parked session by its resume token (query param or
        SSE ``Last-Event-ID`` — every event carries the token as its id).
        Replays each key whose CURRENT version is newer than the last one
        this session saw (latest-wins: intermediates are gone by design —
        the monotonic versions say *whether* it missed, the live frame
        says *what is true now*). Raises ``KeyError`` on unknown/expired
        tokens: the client falls back to a fresh attach. With an
        admission controller installed, resumes ride the RESERVED resume
        lane (admitted ahead of cold attaches; shed only by a full gate,
        the resume-rate bucket, or a drain)."""
        if (sink is None) == (mailbox is None):
            # validate BEFORE consuming the parked entry: a bad call must
            # not destroy the token's resume state or strand parked_refs
            raise ValueError("resume needs exactly one of sink= or mailbox=")
        if self._draining:
            # a hinted session must resume on the SUCCESSOR, not back
            # here: re-attaching to a draining node would strand it with
            # no hint when the caller closes the node (the drain hints
            # each session exactly once) — shed, counted
            raise self._drain_rejection(LANE_RESUME)
        if self.admission is not None and admitted is None:
            decision = self.admission.admit(tenant_id=tenant, lane=LANE_RESUME)
            if not decision.admitted:
                self._note_shed_event(decision.reason, lane=LANE_RESUME)
                raise AdmissionRejected(decision)
        self._purge_parked()
        entry = self._parked.pop(token, None)
        if entry is None:
            raise KeyError(f"unknown or expired resume token {token!r}")
        key_strs, versions, deadline = entry
        if deadline < time.monotonic():
            # expired but not yet swept (the sweep is amortized): release
            # the entry's parked refs IMMEDIATELY — a mass-reconnect storm
            # of expired tokens must not pin upstream subscriptions until
            # the next timer sweep
            self.resumes_expired += 1
            self._drop_parked_refs(key_strs)
            self._arm_sweep()
            raise KeyError(f"unknown or expired resume token {token!r}")
        session = EdgeSession(key_strs, sink=sink, mailbox=mailbox, token=token)
        if session.versions is not None:
            session.versions.update(versions)
        self._assign_shard(session)
        self._sessions.add(session)
        self.resumes += 1
        for ks in key_strs:
            sub = self._subs.get(ks)
            if sub is None:  # torn down while parked (should not happen —
                continue  # parked_refs pins it — but never KeyError a resume)
            sub.parked_refs -= 1
            sub.add_session(session)
        for ks in key_strs:  # replay after joining every sub (see attach)
            if session.evicted:
                break
            sub = self._subs.get(ks)
            if (
                sub is not None
                and sub.last_frame is not None
                and sub.version > versions.get(ks, 0)
            ):
                self._deliver_contained(session, sub.last_frame)
        return session

    def _purge_parked(self) -> None:
        """Amortized expiry sweep: a full scan runs at most every
        resume_ttl/4 seconds — per-detach full scans would cost O(parked²)
        across a reconnect storm. An expired-but-unswept token is also
        rejected at :meth:`resume` time (deadline check there)."""
        now = time.monotonic()
        if now < self._next_purge:
            return
        self._next_purge = now + max(1.0, self.resume_ttl / 4)
        expired = [t for t, (_k, _v, dl) in self._parked.items() if dl < now]
        for t in expired:
            key_strs, _versions, _dl = self._parked.pop(t)
            self._drop_parked_refs(key_strs)

    def _arm_sweep(self) -> None:
        """Schedule the quiescent expiry sweep: the ONLY caller of the
        purge when no connection churn drives it. Re-arms while anything
        stays parked; idle + empty means no timer."""
        if self._sweep_handle is not None or self._closed:
            return
        try:
            loop = asyncio.get_event_loop()
        except RuntimeError:  # no loop (sync teardown): nothing to sweep for
            return
        self._sweep_handle = loop.call_later(
            max(1.0, self.resume_ttl / 2), self._sweep
        )

    def _sweep(self) -> None:
        self._sweep_handle = None
        self._next_purge = 0.0  # the timer IS the amortization: force
        self._purge_parked()
        if self._parked:
            self._arm_sweep()

    def _drop_parked_refs(self, key_strs) -> None:
        for ks in key_strs:
            sub = self._subs.get(ks)
            if sub is None:
                continue
            sub.parked_refs -= 1
            if sub.unreferenced:
                self._teardown_sub(sub)

    def evict(self, session: EdgeSession, reason: str = "stalled") -> Optional[str]:
        """Drop a slow consumer WITH a resume token (the pump's timeout
        path, the mailbox-overflow path and broken-sink containment all
        land here). Counted; the flight recorder notes it so an operator
        can see who got cut. The session's ``on_evicted`` transport hook
        runs LAST, so an eviction that did not originate in the transport
        pump still aborts the peer's connection. Idempotent: racing
        eviction paths (overflow in the fan loop vs the pump's send
        timeout) count — and fire the transport hook — exactly once."""
        if session not in self._sessions:
            return None  # already detached/evicted
        token = self.detach(session, park=True)
        self.evictions += 1
        if RECORDER.enabled:
            RECORDER.note(
                "edge_evicted",
                key=session.keys[0] if session.keys else None,
                detail=f"edge={self.name} reason={reason} token={token}",
            )
        if session.on_evicted is not None:
            try:
                session.on_evicted()
            except Exception:  # noqa: BLE001 — shutdown hooks must not bubble
                log.exception("edge %s: on_evicted hook failed", self.name)
        return token

    # ------------------------------------------------------------------ overload
    def _fan_pressure(self) -> float:
        """Fan-plane load signal, 0..1: pending distinct keys queued
        across the fan shards against the configured depth. Registered as
        an admission pressure source at construction."""
        pending = sum(len(s._pending) for s in self._fan_shards)
        return min(1.0, pending / self.pressure_fan_depth)

    def effective_reread_window(self) -> float:
        """The upstream re-read batching window, WIDENED under pressure:
        overload buys bigger recompute_batch frames — more
        keys amortized per upstream RPC, higher latency — instead of
        deeper queues and evictions. Returns to the configured baseline
        the moment the pressure sources drop (pull-time, no hysteresis
        state to get stuck)."""
        base = self.reread_batch_window
        adm = self.admission
        if adm is None or base <= 0:
            return base
        p = adm.pressure()
        if p <= 0.0:
            return base
        return base * (1.0 + self.pressure_widen * p)

    def _note_shed_event(
        self, reason: str, lane: Optional[str] = None, key: Optional[str] = None,
    ) -> None:
        """Journal one shed (the counter already moved — admission's
        per-reason map, or count_shed's local fallback): explain()/an
        operator can see WHO was turned away and why."""
        if RECORDER.enabled:
            RECORDER.note(
                "edge_shed",
                key=key,
                detail=f"edge={self.name} reason={reason}"
                + (f" lane={lane}" if lane else ""),
            )

    def _drain_rejection(self, lane: Optional[str] = None) -> AdmissionRejected:
        """A COUNTED draining shed (attach/resume on a draining node —
        with or without a controller installed): the transports turn the
        carried decision into a 503 + Retry-After, in-process callers get
        the typed exception."""
        decision = AdmissionDecision(
            False,
            lane or LANE_ANONYMOUS,
            "",
            reason="draining",
            retry_after=(
                self.admission.retry_after
                if self.admission is not None
                else 1.0
            ),
        )
        self.count_shed("draining", lane=decision.lane)
        return AdmissionRejected(decision)

    def count_shed(
        self, reason: str, lane: Optional[str] = None, key: Optional[str] = None,
    ) -> None:
        """The transports' unified rejection counter: admission rejections, key-allowlist 400s,
        replay-evicted 409s and dropped worker handoffs all land here —
        counted in ``fusion_edge_shed_total{reason=}`` (through the
        controller when installed, a node-local map otherwise) and
        journaled. Never silent."""
        if self.admission is not None:
            self.admission.note_shed(reason)
        else:
            self._shed_local[reason] = self._shed_local.get(reason, 0) + 1
        self._note_shed_event(reason, lane=lane, key=key)

    async def drain(self, retry_after: Optional[float] = None) -> dict:
        """Graceful drain for rolling deploys: stop admitting
        (the controller sheds ``draining``), ship every live session ONE
        ``reconnect`` hint frame carrying its resume token (transports
        forward it as an SSE ``event: reconnect`` / WS hint and close the
        stream CLEANLY), park each session's delivered-version state, and
        return the parked-state export a successor node adopts via
        :meth:`import_parked`. Zero deliveries are lost across the
        handoff: resume replay covers the gap (latest-wins — the
        reconnected session sees the newest value of anything it missed).
        Idempotent; the caller closes the node (and hands its listener
        off) afterwards."""
        export = None
        if not self._draining:
            self._draining = True
            if self.admission is not None:
                self.admission.begin_drain()
            self.drains += 1
            cause = f"drain:{self.name}"
            pool = self.worker_pool
            if pool is not None:
                # the delivery plane first: worker-held SSE sessions get
                # their reconnect hints + clean closes too (a pooled
                # deployment's sessions are not the parent's _sessions)
                try:
                    self.sessions_drained += await pool.drain()
                except Exception:  # noqa: BLE001 — a wedged pool must
                    # not stop the parent-side drain
                    log.exception(
                        "edge %s: worker pool drain failed", self.name
                    )
            sessions = list(self._sessions)
            for session in sessions:
                hint: Frame = (
                    DRAIN_KEY,
                    0,
                    {"resume": session.token, "retry_after": retry_after},
                    cause,
                    None,
                    None,
                )
                try:
                    if session.on_drain is not None:
                        # transport hook: write the reconnect event and
                        # wind the connection down cleanly (not abort —
                        # the hint must reach the peer)
                        session.on_drain(hint)
                    else:
                        session.deliver(hint)
                except Exception:  # noqa: BLE001 — one broken consumer
                    # must not stop the drain for its siblings
                    log.exception(
                        "edge %s: drain hint failed for a session", self.name
                    )
                self.detach(session, park=True)
                self.sessions_drained += 1
            if RECORDER.enabled:
                RECORDER.note(
                    "edge_drained",
                    key=None,
                    count=len(sessions),
                    detail=(
                        f"edge={self.name} sessions={len(sessions)} parked "
                        f"for resume (rolling deploy)"
                    ),
                )
            # one loop tick: transports flush their reconnect hints before
            # the caller tears the listener/process down
            await asyncio.sleep(0)
        export = self.export_parked()
        return export

    def export_parked(self) -> dict:
        """The drain handoff payload: every parked token with its key
        SPECS (method + args — a successor node must be able to re-mint
        the subscriptions) and remaining TTL. Wire-serializable (JSON)."""
        now = time.monotonic()
        parked = []
        for token, (key_strs, versions, deadline) in self._parked.items():
            specs = []
            for ks in key_strs:
                sub = self._subs.get(ks)
                specs.append(
                    [sub.method, list(sub.args)] if sub is not None else None
                )
            parked.append(
                {
                    "token": token,
                    "specs": specs,
                    "ttl": max(0.0, deadline - now),
                }
            )
        return {"name": self.name, "service": self.service, "parked": parked}

    def import_parked(self, state: dict) -> int:
        """Adopt a drained sibling's parked sessions (the rolling-restart
        successor): each token's keys are re-pinned here (parked refs mint
        the upstream subscriptions, so the successor is already watching
        before anyone resumes) and the delivered-version maps reset to
        ZERO — this node's per-key versions restart, so a resume replays
        every key: correct (latest-wins hands the newest value), just not
        minimal, which is exactly what zero-loss across a restart needs.
        Keys that fail this node's allowlist are skipped (counted as a
        shed — a drain export is still client-named key state). Returns
        the number of tokens adopted."""
        now = time.monotonic()
        adopted = 0
        for entry in state.get("parked", []):
            token = entry.get("token")
            if not token or token in self._parked:
                continue
            # honor the EXPORTED remaining TTL (capped at this node's
            # resume_ttl): an entry that was a second from expiry on the
            # exporter must not get a fresh full lease here — on a mass
            # drain that would re-pin the whole parked population's
            # upstream subs for clients that will never return. Already-
            # expired entries are not adopted at all.
            ttl = min(float(entry.get("ttl", 0.0)), self.resume_ttl)
            if ttl <= 0.0:
                continue
            key_strs = []
            for spec in entry.get("specs", []):
                if not spec:
                    continue
                try:
                    method, args = self._normalize(
                        (spec[0], *tuple(spec[1]))
                    )
                except (ValueError, TypeError):
                    self.count_shed("import_rejected")
                    continue
                ks = call_key(self.service, method, args)
                sub = self._sub_for(ks, method, args)
                sub.parked_refs += 1
                key_strs.append(ks)
            self._parked[token] = (tuple(key_strs), {}, now + ttl)
            adopted += 1
        if adopted:
            self._arm_sweep()
        return adopted

    @property
    def draining(self) -> bool:
        return self._draining

    def _teardown_sub(self, sub: _KeySub) -> None:
        sub.closed = True
        sub._wake.set()  # unblock a parked watch loop so it exits
        self._subs.pop(sub.key_str, None)
        self._drop_block_state(sub)
        # the serialize-once cache entry dies with the sub (this is the
        # eviction path the parked-session sweep drives: last parked ref
        # expires -> sub tears down -> cached bytes are released)
        self._encoded.pop(sub.key_str, None)
        if sub.task is not None and not sub.task.done():
            sub.task.cancel()

    # ------------------------------------------------------------------ upstream
    async def _watch(self, sub: _KeySub) -> None:
        """The key's single upstream loop, now a three-rung value plane.
        Serve order per cycle:

        1. **repin** — the key's owner moved: drop local + block state,
           re-read at the new owner (batched);
        2. **value block** — a publish-on-wave entry is pending: fan it
           directly, ZERO upstream RPCs (the local node retires — the
           block stream is the subscription's truth now);
        3. **re-read** — the node fenced / a fallback fence or eviction
           marked the key: ONE ``recompute_batch`` entry shared with every
           other key this burst fenced (per-key capture only as the
           counted fallback rung).

        Latest-wins at every rung: fences landing mid-read collapse into
        the next cycle; a newer block entry replaces an unserved one.
        Errors and shard-move transients re-arm with per-sub exponential
        backoff (capped, counted) — a flapping upstream key cannot
        hot-spin the node's watch loops."""
        pending_cause: Optional[str] = None
        pending_t0: Optional[float] = None
        try:
            while not sub.closed and not self._closed:
                # ---- rung 0: owner moved (repin precedes everything —
                # a pending block entry from the OLD owner dies with it)
                if sub.repin_cause is not None:
                    repin_cause, sub.repin_cause = sub.repin_cause, None
                    node = sub.node
                    if (
                        node is not None
                        and not node.is_invalidated
                        and sub.block_pending is None
                        and not sub.needs_reread
                        and sub.peer_ref == self._owner_of(sub.method, sub.args)
                    ):
                        pass  # already pinned at the new owner: absorb
                    else:
                        pending_cause = repin_cause
                        self.resubscribes += 1
                        self._drop_block_state(sub, reshard=True)
                        self._retire_node(sub)
                        sub.needs_reread = True
                # ---- rung 1: publish-on-wave value block (zero RPCs)
                entry = sub.block_pending
                if entry is not None:
                    _seq, version, value, cause, t0 = entry
                    sub.block_pending = None
                    self._block_pending_bytes -= sub.block_size
                    sub.block_size = 0
                    sub.upstream_version = version
                    self.upstream_fences += 1
                    self.block_hits += 1
                    # the value plane owns this key now: the local node is
                    # a stale shadow — retire it (once) so nothing on this
                    # edge's graph can read the superseded value
                    self._retire_node(sub)
                    self._fan(sub, value, cause, t0, None, src="wave block")
                    pending_cause = pending_t0 = None
                # ---- rung 2: upstream (re)read — batched, per-key fallback
                elif (
                    sub.needs_reread
                    or sub.node is None
                    or sub.node.is_invalidated
                ):
                    if sub.pending_fence is not None:
                        fence_cause, fence_t0 = sub.pending_fence
                        sub.pending_fence = None
                        if fence_cause is not None:
                            pending_cause = fence_cause
                        if fence_t0 is not None:
                            pending_t0 = fence_t0
                    sub.needs_reread = False
                    node, err, src = await self._reread(sub)
                    if sub.closed or self._closed:
                        return
                    if node is None and err is None:
                        # routing transient: the reshard raced our map sync
                        # and the rejection's carried map was already
                        # applied (client_function note_moved) — retry at
                        # the new owner without fanning a phantom error
                        # frame to every session
                        sub.needs_reread = True
                        await self._backoff_sleep(sub)
                        continue
                    if err is not None:
                        self.upstream_errors += 1
                        self._fan(sub, None, pending_cause, pending_t0, err, src=src)
                        pending_cause = pending_t0 = None
                        sub.needs_reread = True
                        await self._backoff_sleep(sub)
                        continue
                    sub.backoff = self.error_backoff  # healthy: reset
                    out = node._output
                    self._fan(
                        sub, out.value if out is not None else None,
                        pending_cause, pending_t0, None, src=src,
                    )
                    pending_cause = pending_t0 = None
                # ---- wait for the next fence / block / repin
                while True:
                    sub._wake.clear()
                    node = sub.node
                    if (
                        sub.repin_cause is None
                        and sub.block_pending is None
                        and not sub.needs_reread
                        and (node is None or not node.is_invalidated)
                    ):
                        if node is None:
                            # block-fed: the wake event is the only signal
                            await sub._wake.wait()
                        elif self.router is None and not sub.block_mode:
                            # plain single-server sub: nothing ever calls
                            # repin()/wake — wait on the fence alone (the
                            # side-task pair is measurable per-cycle
                            # overhead across a 512-key fence storm)
                            await node.when_invalidated()
                        else:
                            inval = node.when_invalidated()
                            wake_task = asyncio.get_event_loop().create_task(
                                sub._wake.wait()
                            )
                            try:
                                await asyncio.wait(
                                    {inval, wake_task},
                                    return_when=asyncio.FIRST_COMPLETED,
                                )
                            finally:
                                wake_task.cancel()
                    if sub.closed or self._closed:
                        return
                    if (
                        sub.repin_cause is not None
                        or sub.block_pending is not None
                        or sub.needs_reread
                    ):
                        break  # the serve rungs above decide
                    node = sub.node
                    if node is not None and node.is_invalidated:
                        self.upstream_fences += 1
                        pending_cause = node.invalidation_cause
                        pending_t0 = node.invalidation_origin_ts
                        if pending_cause is not None and pending_cause.startswith(
                            "reshard:"
                        ):
                            # fenced BY the reshard itself (gossip not yet
                            # applied here): the re-capture re-routes via
                            # the map the ShardMovedError retry carries
                            self.resubscribes += 1
                        break
                    # stray wake (absorbed repin / cancelled waiter): rearm
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a watch loop must never die silently
            log.exception("edge %s: watch loop for %s failed", self.name, sub.key_str)

    async def _reread(self, sub: _KeySub):
        """One upstream read: the batched rung when enabled (ONE
        ``recompute_batch`` frame per owner per burst window), the per-key
        capture as the counted fallback. Returns ``(node, err, src)`` —
        ``(None, None, _)`` is the shard-moved transient (caller re-arms
        with backoff). A healthy result also (re)arms publish mode from
        the server's echo."""
        owner = self._owner_of(sub.method, sub.args)
        src = "batched re-read"
        node = None
        if self.reread_batch:
            try:
                node = await self._batcher.submit(owner, sub)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — entry-level failure
                if _is_shard_moved(e):
                    return None, None, src
                self.reread_fallbacks += 1
                node = None
        if node is None:
            src = "per-key re-read"
            client = self._client_for(owner)
            self.per_key_rereads += 1
            self.upstream_rpcs += 1
            try:
                node = await capture(
                    lambda: getattr(client, sub.method)(*sub.args)
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — routing/link failures
                if _is_shard_moved(e):
                    return None, None, src
                return None, f"{type(e).__name__}: {e}", src
        if sub.node is not None and sub.node is not node:
            # a still-live node superseded by this re-read (reconnect
            # re-read, block budget eviction, undecodable entry): retire
            # it so its outbound call never leaks in peer.outbound_calls
            self._retire_node(sub)
        sub.peer_ref = owner
        sub.node = node
        sub.upstream_version = node.version.format()
        self._arm_block_mode(sub, node)
        out = node._output
        if out is not None and out.has_error:
            return None, f"{type(out.error).__name__}: {out.error}", src
        return node, None, src

    async def _backoff_sleep(self, sub: _KeySub) -> None:
        """Per-sub exponential backoff with a cap and a counter: the
        re-read error/transient paths re-arm through here, so a flapping
        upstream key costs one bounded retry cadence, never a hot spin
        across every watch loop."""
        delay = sub.backoff
        sub.backoff = min(self.error_backoff_max, delay * 2)
        self.upstream_backoffs += 1
        await asyncio.sleep(delay)

    def _retire_node(self, sub: _KeySub) -> None:
        """Retire the sub's local ClientComputed (block mode took over, or
        a repin dropped the old owner's subscription): invalidating it
        unregisters the outbound call and keeps this edge's own computed
        graph honest — the value plane, not the node, carries the truth."""
        node, sub.node = sub.node, None
        if node is not None and not node.is_invalidated:
            node.invalidate(immediately=True)

    def _arm_block_mode(self, sub: _KeySub, node) -> None:
        """Adopt the server's publish echo for this sub's NEW upstream
        call: block frames and fallback fences address subscriptions by
        call id, so the routing entry follows the live call exactly."""
        old_cid = sub.block_call_id
        if old_cid is not None and self._block_calls.get(old_cid) is sub:
            self._block_calls.pop(old_cid, None)
        sub.block_call_id = None
        call = getattr(node, "call", None)
        armed = (
            self.value_blocks
            and call is not None
            and getattr(call, "publish_armed", False)
        )
        sub.block_mode = bool(armed)
        if armed:
            sub.block_call_id = call.call_id
            self._block_calls[call.call_id] = sub
            # the seq gate's scope is ONE call's block stream (frames are
            # routed by call id; a late frame for the old call is an
            # orphan): a new owner's publisher counts from its own epoch,
            # so carrying the old high-water mark would drop every fresh
            # entry as stale — silently-stale forever, since the server
            # diverted the plain fence into the block
            sub.block_seq = 0

    def _drop_block_state(self, sub: _KeySub, reshard: bool = False) -> None:
        """Clear a sub's value-plane state (teardown / repin): the pending
        entry — minted under the OLD owner — is invalidated, and the call
        routing entry dies so a late block for it counts as an orphan."""
        if sub.block_pending is not None:
            sub.block_pending = None
            self._block_pending_bytes -= sub.block_size
            sub.block_size = 0
            if reshard:
                self.block_reshard_drops += 1
        cid = sub.block_call_id
        if cid is not None and self._block_calls.get(cid) is sub:
            self._block_calls.pop(cid, None)
        sub.block_call_id = None
        sub.block_mode = False

    # ------------------------------------------------------------------ value plane
    def on_value_block(self, peer, message) -> None:
        """Inbound ``$sys-c.value_block`` frame (the publish-on-wave push,
        value plane level 2): columnar ``(call_id, version, seq, cause, t0,
        offset)`` over one shared payload blob. Each entry is gated by the
        per-sub monotonic seq (a stale/duplicate entry is dropped,
        counted), budgeted (an entry over ``block_budget_bytes`` falls
        back to the batched re-read, counted), decoded ONCE, and parked
        latest-wins for the key's watch loop."""
        from ..diagnostics.clocksync import global_clock_sync
        from ..utils.serialization import loads as wire_loads

        try:
            cids, vers, seqs, causes, t0s, offsets, payload = wire_loads(
                message.argument_data
            )
        except Exception:  # noqa: BLE001 — a malformed frame must not kill
            # the receive pump; the keys heal through their fence fallbacks
            log.exception("edge %s: bad value_block frame", self.name)
            return
        sync = global_clock_sync()
        peer_ref = getattr(peer, "ref", None)
        for i, cid in enumerate(cids):
            sub = self._block_calls.get(cid)
            if sub is None or sub.closed or not sub.block_mode:
                self.block_orphans += 1
                continue
            seq = int(seqs[i])
            if seq <= sub.block_seq:
                self.block_stale += 1
                continue
            raw = payload[offsets[i]: offsets[i + 1]]
            size = len(raw)
            if (
                self._block_pending_bytes - sub.block_size + size
                > self.block_budget_bytes
            ):
                # over budget: drop the entry AND any unserved older one
                # (latest-wins — fanning the superseded value before the
                # corrective re-read would hand every session stale
                # data), fall back to the batched re-read — counted, and
                # the fence is never lost
                self.block_evictions += 1
                if sub.block_pending is not None:
                    sub.block_pending = None
                    self._block_pending_bytes -= sub.block_size
                    sub.block_size = 0
                sub.block_seq = seq
                sub.needs_reread = True
                sub.pending_fence = (
                    causes[i],
                    sync.to_local(peer_ref, t0s[i]) if t0s[i] is not None else None,
                )
                sub._wake.set()
                continue
            try:
                value = wire_loads(raw)
            except Exception:  # noqa: BLE001 — undecodable entry: re-read
                log.exception(
                    "edge %s: undecodable value_block entry for %s",
                    self.name, sub.key_str,
                )
                sub.block_seq = seq
                sub.needs_reread = True
                sub._wake.set()
                continue
            t0 = sync.to_local(peer_ref, t0s[i]) if t0s[i] is not None else None
            self.block_entries += 1
            self._block_pending_bytes += size - sub.block_size
            sub.block_size = size
            sub.block_seq = seq
            # latest-wins: an unserved older entry is superseded (those
            # sessions could never have seen it)
            if sub.block_pending is not None:
                self.coalesced_frames += 1
            sub.block_pending = (seq, vers[i], value, causes[i], t0)
            sub._wake.set()

    def on_block_fence(
        self, peer, call_id: int, cause: Optional[str], origin_ts: Optional[float],
    ) -> None:
        """A plain invalidation addressed to a RETIRED publish-mode call
        (the publisher's fallback ladder: recompute error, reshard,
        overflow, dead-link block). The key leaves block mode and
        re-reads — batched — carrying the fence's cause and timestamp."""
        sub = self._block_calls.get(call_id)
        if sub is None or sub.closed:
            return
        from ..diagnostics.clocksync import global_clock_sync

        self.block_fences += 1
        self.upstream_fences += 1
        t0 = (
            global_clock_sync().to_local(getattr(peer, "ref", None), origin_ts)
            if origin_ts is not None
            else None
        )
        sub.pending_fence = (cause, t0)
        sub.block_mode = False  # the server dropped the standing sub;
        # the re-read's publish echo re-arms it
        sub.needs_reread = True
        if cause is not None and cause.startswith("reshard:"):
            self.resubscribes += 1
        sub._wake.set()

    def _fan(
        self,
        sub: _KeySub,
        value: Any,
        cause: Optional[str],
        origin_ts: Optional[float],
        err: Optional[str],
        src: Optional[str] = None,
    ) -> None:
        """Fan one upstream frame: serialize the wire payload ONCE (the
        version-keyed encode cache), hand the shared bytes to the
        delivery-plane broadcasts (worker pool), and post one entry per
        fan shard — the shard workers walk their session partitions
        concurrently instead of this watch loop walking every session
        sequentially. ``src`` names the value-plane rung
        that produced the value (recorder detail → explain())."""
        sub.last_src = src
        sub.version += 1
        frame: Frame = (sub.key_str, sub.version, value, cause, origin_ts, err)
        sub.last_frame = frame
        # encode-once, eagerly: one dumps per fanned (key, version) makes
        # the amortization ratio exact and the shared bytes ready before
        # any pump or worker asks
        encoded = self.encode_frame(frame)
        sessions = sum(len(bucket) for bucket in sub.shards)
        if sessions:
            # one offer per fanned frame, weighted by its session count —
            # the sketch sees "this key reached N downstreams" without a
            # per-session hop inside the delivery loops
            self._hotkeys.offer("edge_deliveries", sub.key_str, sessions)
        if self._broadcasts:
            for hook in self._broadcasts:
                try:
                    hook(sub.key_str, frame, encoded)
                except Exception:  # noqa: BLE001 — a broken delivery plane
                    # must not kill the key's watch loop
                    log.exception(
                        "edge %s: broadcast hook failed for %s",
                        self.name, sub.key_str,
                    )
        for bucket, shard in zip(sub.shards, self._fan_shards):
            if bucket:
                shard.post(sub, frame, encoded)

    def _fan_shard_deliver(
        self, shard: _FanShard, sub: _KeySub, frame: Frame,
        encoded: EncodedFrame,
    ) -> None:
        """One fan shard's delivery walk over ITS partition of the sub's
        sessions. Sessions whose bounded mailbox overflowed (or whose
        sink raised) are evicted (with resume tokens) AFTER the loop — a
        slow consumer never stalls its siblings, it just stops being a
        consumer."""
        bucket = sub.shards[shard.index]
        if not bucket:
            return
        cause, origin_ts = frame[3], frame[4]
        err = frame[5]
        dead: Optional[List[Tuple[EdgeSession, str]]] = None
        n = 0
        sinks = 0
        for session in bucket:
            mailbox = session.mailbox
            was_coalesced = mailbox.coalesced if mailbox is not None else 0
            try:
                ok = session.deliver(frame)
            except Exception:  # noqa: BLE001 — ONE broken consumer sink
                # must never kill the fan for its siblings: contain it as
                # an eviction (parked; a fixed consumer can resume from
                # its token)
                log.exception(
                    "edge %s: session sink failed for %s; evicting",
                    self.name, sub.key_str,
                )
                ok = False
                if dead is None:
                    dead = []
                dead.append((session, "sink raised"))
            else:
                if not ok:
                    if dead is None:
                        dead = []
                    dead.append((session, "mailbox overflow"))
            if ok and mailbox is None:
                sinks += 1  # counted in THIS loop — the fan over the
                # hottest zipf key must not pay a second O(sessions) pass
            if mailbox is not None:
                self.coalesced_frames += mailbox.coalesced - was_coalesced
            n += 1
        if dead:
            # evict BEFORE the counters/histogram below: a failed delivery
            # must not ride the fan total, the recorder count, or the
            # delivery distribution as if a client saw it
            for session, reason in dead:
                self.evict(session, reason=reason)
            n -= len(dead)
        self.frames_fanned += n
        self.deliveries += sinks  # sink sessions are client-visible NOW;
        # mailbox sessions count at record_delivery (transport-accepted)
        shard.delivered += n
        if origin_ts is not None:
            # sink-flavor sessions became client-visible in this drain —
            # one timestamp after the loop bounds them all, INCLUDING the
            # shard-queue wait (fence → visible, honestly). Mailbox
            # sessions record at pump-send time instead (the pump calls
            # record_delivery per drained frame).
            delta_ms = (time.perf_counter() - origin_ts) * 1e3
            if 0.0 <= delta_ms < 3.6e6 and sinks:  # range guard as $sys-c e2e
                self._delivery_hist.record_many(delta_ms, sinks, cause=cause)
        if (cause is not None or err is not None) and RECORDER.enabled and n > 0:
            # the edge hop of the causal chain: explain() joins this to
            # the client-side "fenced" event (same call-shaped key, same
            # cause) and SUMS per-shard counts into "edge re-fanned to N
            # session(s)"; causeless initial-value fans stay un-journaled
            # (they are attach mechanics, not invalidation causality),
            # error fans are journaled so an operator sees who saw the
            # failure
            RECORDER.note(
                "edge_fenced",
                key=sub.key_str,
                cause=cause,
                count=n,
                detail=(
                    f"edge={self.name} v{frame[1]} shard={shard.index} "
                    f"owner={sub.peer_ref}"
                    + (
                        f" value served from {sub.last_src}"
                        if sub.last_src is not None
                        else ""
                    )
                ),
            )

    def record_delivery(self, frame: Frame) -> None:
        """Pump callback: a mailbox frame reached its peer — count the
        client-visible delivery and record the fence→client-visible
        sample (the transport half of the histogram sink-flavor sessions
        record inline)."""
        self.deliveries += 1
        origin_ts = frame[4]
        if origin_ts is None:
            return
        delta_ms = (time.perf_counter() - origin_ts) * 1e3
        if 0.0 <= delta_ms < 3.6e6:
            self._delivery_hist.record(delta_ms, cause=frame[3])

    # ------------------------------------------------------------------ plane
    def attach_broadcast(self, hook) -> None:
        """Register a delivery-plane broadcast: ``hook(key_str, frame,
        encoded)`` runs once per fanned frame with the SHARED encoded
        bytes (the worker pool's feed)."""
        self._broadcasts.append(hook)

    def detach_broadcast(self, hook) -> None:
        try:
            self._broadcasts.remove(hook)
        except ValueError:
            pass

    # ------------------------------------------------------------------ reshard
    def _on_map_change(self, old, new) -> None:
        """Router callback on every applied epoch: re-pin exactly the subs
        whose key's owner moved. Downstream sessions notice nothing — the
        next frame just says ``cause=reshard:<epoch>``."""
        from ..cluster.shard_map import ShardMap

        moved = set(ShardMap.diff(old, new))
        if not moved:
            return
        cause = f"reshard:{new.epoch}"
        for sub in self._subs.values():
            shard = new.shard_of(
                self.router.key_for(self.service, sub.method, sub.args)
            )
            if shard in moved:
                sub.repin(cause)

    def apply_map(self, new_map) -> bool:
        """Adopt a shard map directly (tests / static deployments without
        a gossip feed)."""
        if self.router is None:
            raise RuntimeError("edge node has no shard-map router")
        return self.router.apply_map(new_map)

    # ------------------------------------------------------------------ lifecycle
    async def close(self) -> None:
        """Stop every watch loop and drop session state (the rpc/fusion
        hubs are the caller's to stop — they may be shared)."""
        self._closed = True
        pool, self.worker_pool = self.worker_pool, None
        if pool is not None:
            try:
                await pool.stop()
            except Exception:  # noqa: BLE001 — teardown must not bubble
                log.exception("edge %s: worker pool stop failed", self.name)
        if self.rpc_hub is not None and getattr(
            self.rpc_hub, "value_plane_client", None
        ) is self:
            self.rpc_hub.value_plane_client = None
        self._batcher.cancel_all()
        for task in self._monitor_tasks:
            if not task.done():
                task.cancel()
        self._monitor_tasks.clear()
        self._block_calls.clear()
        subs = list(self._subs.values())
        self._subs.clear()
        self._encoded.clear()
        for sub in subs:
            sub.closed = True
            sub._wake.set()
            if sub.task is not None and not sub.task.done():
                sub.task.cancel()
        for sub in subs:
            if sub.task is not None:
                try:
                    await sub.task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
        for shard in self._fan_shards:
            if shard.task is not None and not shard.task.done():
                shard.task.cancel()
        for shard in self._fan_shards:
            if shard.task is not None:
                try:
                    await shard.task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
        self._sessions.clear()
        self._parked.clear()
        if self._sweep_handle is not None:
            self._sweep_handle.cancel()
            self._sweep_handle = None
        if self.router is not None:
            try:
                self.router.on_map_change.remove(self._on_map_change)
            except ValueError:
                pass
        if self.admission is not None:
            # a SHARED controller must stop reading this node's fan
            # shards: close() leaves their _pending populated, so a stale
            # bound-method source would report phantom pressure (and pin
            # the node graph) forever
            self.admission.clear_pressure(f"{self.name}:fan_shards")
        global_metrics().unregister_collector(self)
