"""ClusterCommander — the cluster-native command plane.

The reference's whole point is that *writes* drive the reactive graph: a
command completes, its operation is journaled, and completion triggers the
invalidation cascade (PAPER.md §L1b). This module makes that write path
cluster-native:

- **Routing** — every command routes to its owning shard's member via the
  :class:`~..cluster.router.ShardMapRouter` truth (key → virtual shard →
  rendezvous owner). A cross-host owner rides the exercised RPC legs
  (in-memory test transport, websocket, or the ``rpc/tcp.py`` DCN socket)
  as a :class:`CommandEnvelope` carrying the operation id.
- **Journal-then-complete** — execution runs under the operations pipeline
  (scope provider → commit listeners → completion), so the oplog row is
  durable BEFORE completion fans out; completion's invalidation replay is
  collected (``batch_cascade_scope``) and submitted through the
  nonblocking :class:`~..graph.nonblocking.WavePipeline`, so command-minted
  waves fuse into the resident super-round — zero extra dispatches when a
  chain is already in flight, zero eager-fallback rounds attributable to
  commands.
- **Exactly-once across failure** — every command carries an operation id
  (minted once, pinned across retries via ``pinned_operation_scope``).
  Replays dedup against the result memo and the journal
  (``fusion_cmd_dedup_total``); a ``ShardMovedError`` — reshard, owner
  kill, stale map — retries against the new owner with counted bounded
  backoff (``fusion_cmd_retries_total``). Never a silent double-apply
  (the owner-side ownership re-check bounces mid-flight movers), never a
  lost write (retries are bounded but counted, and exhaustion raises).
- **Attribution** — the command span's cause id is pinned into the
  operation (→ oplog, both directions) and the harvested wave ticket's
  cause is labeled in the :func:`~..diagnostics.mesh_telemetry.global_mesh_trace`
  store, so ``explain()`` and ``stitch()`` name the originating command
  end to end ("invalidated by command X on member h1 → wave seq N →
  delivered").
"""
from __future__ import annotations

import asyncio
import logging
import time
import uuid
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from ..diagnostics.metrics import global_metrics
from ..diagnostics.tracing import get_activity_source, span_cause_id
from ..utils.collections import RecentlySeenMap
from ..utils.serialization import wire_type
from .rpc_bridge import COMMANDER_SERVICE

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "CommandEnvelope",
    "ClusterCommander",
    "ClusterCommanderFacade",
    "expose_cluster_commander",
]

#: bounded backoff for owner retries (reshard windows resolve in tens of
#: milliseconds; a host kill needs the membership failure timeout)
DEFAULT_MAX_RETRIES = 8
BACKOFF_BASE_S = 0.02
BACKOFF_CAP_S = 0.5
#: per-attempt forward deadline. A call in flight to a peer that dies
#: mid-send never errors — the reply simply never comes — so every forward
#: carries its own deadline; the pinned operation id makes the retry after
#: an ambiguous timeout safe (the owner dedups, never double-applies).
CALL_TIMEOUT_S = 2.0


@wire_type("CmdEnvelope")
@dataclass(frozen=True)
class CommandEnvelope:
    """A routed command on the wire: the command itself plus the operation
    id that makes its application idempotent. ``shard_key()`` delegates to
    the inner command so the router and the owner-side re-check agree on
    the shard no matter which object they key on."""

    command: Any
    operation_id: str

    def shard_key(self) -> Any:
        inner = getattr(self.command, "shard_key", None)
        if callable(inner):
            return inner()
        return repr(self.command)


class ClusterCommander:
    """Routes each command to its owning shard's member and executes it
    exactly-once under the operations pipeline (module docstring has the
    full contract). Install one per member (plus one on each pure client
    with a ``member_id`` no map will ever own)."""

    def __init__(
        self,
        commander,
        router=None,
        member_id: Optional[str] = None,
        rpc_hub=None,
        service: str = COMMANDER_SERVICE,
        log_store=None,
        member=None,
        max_retries: int = DEFAULT_MAX_RETRIES,
        backoff_base_s: float = BACKOFF_BASE_S,
        backoff_cap_s: float = BACKOFF_CAP_S,
        call_timeout_s: float = CALL_TIMEOUT_S,
    ):
        self.commander = commander
        self.router = router
        self.member_id = member_id
        self.rpc_hub = rpc_hub
        self.service = service
        #: the durable journal replays dedup against (falls back to the
        #: in-process memo when no log is attached)
        self.log_store = log_store
        #: the owning ClusterMember, when this commander runs ON a member —
        #: its map (not the router's) is the authoritative ownership truth
        #: for the pre-apply re-check
        self.member = member
        self.max_retries = max(int(max_retries), 0)
        self.call_timeout_s = call_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        #: operation id -> (result,) memo: a duplicate send returns the
        #: FIRST application's result instead of re-applying
        self._memo = RecentlySeenMap(capacity=100_000, max_age=600.0)
        #: (ticket, op_id, label, t0) of submitted-but-unharvested waves;
        #: reconcile() labels their causes + records visible latency
        self._pending: List[Tuple[Any, str, str, float]] = []

    # ------------------------------------------------------------------ keys
    def _key_of(self, command: Any, operation_id: str) -> str:
        """The routing key, EXACTLY as ``ShardMapRouter.key_for`` derives it
        from the envelope this command travels as."""
        return repr(CommandEnvelope(command, operation_id).shard_key())

    def _shard_map(self):
        if self.member is not None:
            return self.member.shard_map
        return self.router.shard_map if self.router is not None else None

    def _owner_of(self, command: Any, operation_id: str) -> Optional[str]:
        smap = self.router.shard_map if self.router is not None else self._shard_map()
        if smap is None:
            return None
        return smap.owner_of(self._key_of(command, operation_id))

    def _pipeline(self):
        backend = getattr(self.commander.hub, "graph_backend", None)
        return getattr(backend, "pipeline", None) if backend is not None else None

    @staticmethod
    def _label(command: Any, operation_id: str, member_id: Optional[str]) -> str:
        return (
            f"{type(command).__name__} (op {operation_id[:8]}, "
            f"member {member_id or '?'})"
        )

    # ------------------------------------------------------------------ call
    async def call(self, command: Any, operation_id: Optional[str] = None) -> Any:
        """Route + execute one command. The operation id is minted HERE
        (or supplied by a client that wants its own idempotency token) and
        pinned across every retry — that constant is what makes the whole
        retry ladder exactly-once."""
        from ..cluster.shard_map import ShardMovedError

        op_id = operation_id or uuid.uuid4().hex
        attempts = 0
        while True:
            try:
                owner = self._owner_of(command, op_id)
                if (
                    owner is None
                    or self.rpc_hub is None
                    or owner == self.member_id
                ):
                    return await self.execute_local(command, op_id)
                return await self._forward(command, op_id, owner)
            except (ShardMovedError, ConnectionError, OSError, asyncio.TimeoutError) as e:
                attempts += 1
                advanced = False
                if isinstance(e, ShardMovedError) and self.router is not None:
                    # the client's lazy map sync: the rejection carried the
                    # rejecting side's CURRENT map — apply it so the next
                    # attempt routes to the new owner first try
                    advanced = self.router.note_moved(e)
                if (
                    isinstance(e, ShardMovedError)
                    and not advanced
                    and self.router is not None
                    and self.rpc_hub is not None
                ):
                    # the rejection carried no news (typically the router's
                    # OWN stale map, fail-fasting on a dead owner forever):
                    # probe any reachable member with the pinned envelope —
                    # a non-owner bounces with the AUTHORITATIVE map (which
                    # we adopt), and the actual new owner simply applies
                    probed = await self._resync_probe(command, op_id, attempts)
                    if probed is not None:
                        return probed[0]
                if attempts > self.max_retries:
                    global_metrics().counter(
                        "fusion_cmd_errors_total",
                        "commands failed after exhausting bounded owner retries",
                    ).inc()
                    raise
                global_metrics().counter(
                    "fusion_cmd_retries_total",
                    "command retries against a new shard owner (reshard, "
                    "owner kill, stale map) — bounded, never silent",
                ).inc()
                await asyncio.sleep(
                    min(self.backoff_base_s * (2 ** (attempts - 1)), self.backoff_cap_s)
                )

    async def _resync_probe(
        self, command: Any, op_id: str, attempt: int
    ) -> Optional[Tuple[Any]]:
        """Map re-sync for a commands-only client nobody pushes epochs to:
        send the pinned envelope to SOME reachable member. Three outcomes —
        it owns the shard now (returns the result, wrapped so ``None``
        results stay distinguishable), it bounces with its current map
        (adopted here; returns None so the caller re-routes), or it is
        unreachable too (returns None; bounded backoff rides on)."""
        from ..cluster.shard_map import ShardMovedError

        smap = self.router.shard_map
        down = getattr(self.router, "_down", lambda ref: False)
        candidates = [
            m for m in smap.members if m != self.member_id and not down(m)
        ]
        if not candidates:
            return None
        target = candidates[(attempt - 1) % len(candidates)]
        envelope = CommandEnvelope(command=command, operation_id=op_id)
        try:
            result = await asyncio.wait_for(
                self.rpc_hub.call(
                    self.service, "call", (envelope,), peer_ref=target
                ),
                self.call_timeout_s,
            )
            return (result,)
        except ShardMovedError as e:
            self.router.note_moved(e)  # the probe's whole point
            return None
        except (ConnectionError, OSError, asyncio.TimeoutError):
            return None

    async def _forward(self, command: Any, op_id: str, owner: str) -> Any:
        envelope = CommandEnvelope(command=command, operation_id=op_id)
        global_metrics().counter(
            "fusion_cmd_forwarded_total",
            "commands forwarded to a remote shard owner over RPC",
        ).inc()
        if getattr(self.rpc_hub, "call_router", None) is not None:
            # routed path: the hub stamps @shard/@epoch headers and the
            # router fails fast (ShardMovedError) on an unreachable owner —
            # commands never fail over to a replica. The deadline covers the
            # peer that dies with the call in flight (no reply, no error).
            return await asyncio.wait_for(
                self.rpc_hub.call(self.service, "call", (envelope,)),
                self.call_timeout_s,
            )
        return await asyncio.wait_for(
            self.rpc_hub.call(self.service, "call", (envelope,), peer_ref=owner),
            self.call_timeout_s,
        )

    # ------------------------------------------------------------- execution
    async def execute_local(self, command: Any, operation_id: str) -> Any:
        """Apply a command on THIS member: ownership re-check → replay
        dedup → journaled execution under a pinned operation scope →
        completion wave through the nonblocking pipeline."""
        from ..cluster.shard_map import ShardMovedError
        from ..diagnostics.mesh_telemetry import global_mesh_trace
        from ..operations.pipeline import batch_cascade_scope, pinned_operation_scope

        smap = self._shard_map()
        if smap is not None and self.member_id is not None:
            owner = smap.owner_of(self._key_of(command, operation_id))
            if owner is not None and owner != self.member_id:
                # the shard moved while this command was in flight: bounce
                # with OUR map instead of double-applying — the retry (here
                # or on the sending client) lands on the new owner
                raise ShardMovedError(
                    f"shard for {type(command).__name__} moved to {owner}; "
                    f"{self.member_id} refuses a non-owned write",
                    shard_map=smap,
                )
        memo = self._memo.get(operation_id)
        if memo is None and self.log_store is not None:
            try:
                journaled = self.log_store.contains(operation_id)
            except Exception:  # noqa: BLE001 — a failing store must not turn
                # dedup into an outage; the memo still covers the common case
                journaled = False
            if journaled:
                memo = (None,)  # applied by a previous incarnation; result gone
        if memo is not None:
            global_metrics().counter(
                "fusion_cmd_dedup_total",
                "duplicate operation-id replays absorbed by the journal/memo "
                "(exactly-once applications)",
            ).inc()
            return memo[0]

        label = self._label(command, operation_id, self.member_id)
        pipeline = self._pipeline()
        groups: List[Optional[list]] = []
        t0 = time.perf_counter()
        with get_activity_source("commands").span(
            f"cmd:{type(command).__name__}",
            member=self.member_id or "?",
            op=operation_id,
        ) as span:
            cause = span_cause_id(span)
            global_mesh_trace().note_command(cause, label)
            with pinned_operation_scope(operation_id, cause):
                if pipeline is not None:
                    # completion's invalidation replay COLLECTS its hits
                    # instead of cascading host-side; the collected seeds
                    # ride the nonblocking pipeline below and fuse into
                    # whatever chain/super-round is already in flight
                    with batch_cascade_scope(groups.append):
                        result = await self.commander.call(command)
                else:
                    result = await self.commander.call(command)
        self._memo.try_add(operation_id, (result,))
        global_metrics().counter(
            "fusion_cmd_local_total",
            "commands applied on this member (owner-local executions)",
        ).inc()
        seeds = [c for g in groups if g for c in g]
        if pipeline is not None and seeds:
            ticket = pipeline.submit(seeds)
            self._pending.append((ticket, operation_id, label, t0))
        else:
            # host-side cascade already applied: the write is visible now
            global_metrics().histogram(
                "fusion_cmd_visible_ms",
                help="command acceptance → client-visible invalidation",
                unit="ms",
            ).record((time.perf_counter() - t0) * 1e3)
        return result

    # ------------------------------------------------------------- reconcile
    def reconcile(self) -> int:
        """Label harvested command waves in the mesh trace store (the
        command → wave-cause join explain()/stitch() read) and record their
        command→visible latency. Returns how many tickets resolved."""
        from ..diagnostics.mesh_telemetry import global_mesh_trace

        if not self._pending:
            return 0
        now = time.perf_counter()
        hist = global_metrics().histogram(
            "fusion_cmd_visible_ms",
            help="command acceptance → client-visible invalidation",
            unit="ms",
        )
        trace = global_mesh_trace()
        still: List[Tuple[Any, str, str, float]] = []
        done = 0
        for ticket, op_id, label, t0 in self._pending:
            if ticket is not None and not ticket.done:
                still.append((ticket, op_id, label, t0))
                continue
            if ticket is not None and ticket.cause:
                trace.note_command(ticket.cause, label)
            hist.record((now - t0) * 1e3)
            done += 1
        self._pending = still
        return done

    def drain(self) -> int:
        """The write-path barrier: flush + harvest the nonblocking pipeline
        (which also drains any resident super-round) and reconcile every
        command ticket. Returns the newly-invalidated count."""
        pipeline = self._pipeline()
        newly = pipeline.drain() if pipeline is not None else 0
        self.reconcile()
        return newly


class ClusterCommanderFacade:
    """Owner-side RPC target for routed command envelopes: unwraps the
    envelope and applies it under the member's exactly-once contract. A
    bare (un-enveloped) command from a cluster-unaware client still runs —
    it just mints its own operation id (no cross-send idempotency)."""

    def __init__(self, cluster_commander: ClusterCommander):
        self.cluster_commander = cluster_commander

    async def call(self, command: Any) -> Any:
        if isinstance(command, CommandEnvelope):
            return await self.cluster_commander.execute_local(
                command.command, command.operation_id
            )
        return await self.cluster_commander.call(command)


def expose_cluster_commander(
    rpc_hub, cluster_commander: ClusterCommander, service: str = COMMANDER_SERVICE
) -> ClusterCommanderFacade:
    """Publish a member's cluster commander over RPC (the ``$commander``
    service the router's command fail-fast rule keys on)."""
    facade = ClusterCommanderFacade(cluster_commander)
    rpc_hub.add_service(service, facade)
    return facade
