"""RpcPeer — the per-connection worker.

Re-expression of src/Stl.Rpc/RpcPeer.cs:6-319: a peer owns one logical link
(surviving physical reconnects), a connection-state AsyncEvent chain, the
outbound/inbound call trackers, and the message pump. On every (re)connect
it RE-SENDS all registered outbound calls (RpcPeer.cs:116-119) — the server
side dedups via registered inbound calls — which is the whole reliability
story: calls survive connection loss without user code noticing.

``RpcClientPeer`` dials with jittered backoff (RpcClientPeerReconnectDelayer);
``RpcServerPeer`` awaits connection handoffs from a listener/transport.
"""
from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

from ..utils.async_chain import RetryDelaySeq, WorkerBase
from ..utils.async_utils import AsyncEvent, Channel, ChannelClosedError, ChannelPair
from ..utils.collections import RecentlySeenMap
from ..utils.errors import ExceptionInfo
from ..utils.serialization import dumps, loads
from .message import (
    COMPUTE_SYSTEM_SERVICE,
    DIAG_SYSTEM_SERVICE,
    MEMBER_SYSTEM_SERVICE,
    SYSTEM_SERVICE,
    TABLE_SYSTEM_SERVICE,
    RpcMessage,
)

if TYPE_CHECKING:
    from .hub import RpcHub
    from .outbox import PeerOutbox

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["RpcPeer", "RpcClientPeer", "RpcServerPeer", "ConnectionState"]


async def _run_middlewares(mws, peer, message, terminal) -> None:
    """Run a middleware chain (≈ RpcInbound/OutboundMiddleware,
    Stl.Rpc/Infrastructure/): each middleware is ``async (peer, message,
    nxt)`` and continues with ``await nxt(message)`` — passing a different
    message rewrites it for the rest of the chain."""

    async def run_from(i: int, msg: RpcMessage) -> None:
        if i == len(mws):
            await terminal(msg)
        else:
            await mws[i](peer, msg, lambda m, _i=i: run_from(_i + 1, m))

    await run_from(0, message)


class ConnectionState:
    DISCONNECTED = "disconnected"
    CONNECTED = "connected"
    #: terminal: the peer gave up (unrecoverable connect error or attempt
    #: cap); waiters re-raise the error instead of parking forever
    TERMINATED = "terminated"

    def __init__(self, kind: str, error: Optional[BaseException] = None):
        self.kind = kind
        self.error = error

    @property
    def is_connected(self) -> bool:
        return self.kind == ConnectionState.CONNECTED

    @property
    def is_terminated(self) -> bool:
        return self.kind == ConnectionState.TERMINATED

    def __repr__(self) -> str:
        return f"ConnectionState({self.kind})"


class RpcPeer(WorkerBase):
    def __init__(self, hub: "RpcHub", ref: str):
        super().__init__(f"rpc-peer:{ref}")
        self.hub = hub
        self.ref = ref
        self.connection_state: AsyncEvent[ConnectionState] = AsyncEvent(
            ConnectionState(ConnectionState.DISCONNECTED)
        )
        # 0 = unlimited; n ≥ 1 gates non-system inbound calls through a
        # semaphore of n permits (≈ InboundConcurrencyLevel, RpcPeer.cs:20,
        # 100-110); configured per hub before its peers are created
        level = hub.inbound_concurrency_level
        self.inbound_semaphore: Optional[asyncio.Semaphore] = (
            asyncio.Semaphore(level) if level > 0 else None
        )
        self.outbound_calls: Dict[int, Any] = {}
        self.inbound_calls: Dict[int, Any] = {}
        self._completed_inbound = RecentlySeenMap(capacity=10_000, max_age=600.0)
        # call ids come from the HUB, not this peer object: a peer that is
        # torn down (breaker quarantine, retire) and later re-created for
        # the same ref must NOT restart at 1 — the server keeps completed
        # compute calls registered per client ref so $sys-c pushes survive
        # reconnects, and a reused id makes _process_inbound restart() the
        # OLD subscription, re-sending the old call's result to the new
        # call (a silent cross-wired read that never heals)
        self._call_id_counter = hub._outbound_call_ids
        self._conn: Optional[ChannelPair] = None
        self._resend_failures = 0  # consecutive connect-then-die-on-resend
        self._outbox: Optional["PeerOutbox"] = None
        # strong refs to in-flight $sys-d handler tasks: the event loop
        # holds tasks only weakly, and a collected task silently never
        # sends its explain reply
        self._diag_tasks: set = set()

    # ------------------------------------------------------------------ id/state
    def allocate_call_id(self) -> int:
        return next(self._call_id_counter)

    @property
    def is_connected(self) -> bool:
        return self._conn is not None

    def _set_state(self, kind: str, error: Optional[BaseException] = None) -> None:
        self.connection_state = self.connection_state.latest().create_next(
            ConnectionState(kind, error)
        )

    async def when_connected(self) -> None:
        ev = self.connection_state.latest()
        if not ev.value.is_connected:
            self.start()
            ev = await ev.when(lambda s: s.is_connected or s.is_terminated)
            if ev.value.is_terminated:
                raise ev.value.error or ConnectionError(
                    f"peer {self.ref} terminated without a connection"
                )

    # ------------------------------------------------------------------ transport
    async def acquire_connection(self) -> ChannelPair:
        """Client: dial (with backoff); server: await handoff."""
        raise NotImplementedError

    # ------------------------------------------------------------------ main loop
    async def on_run(self) -> None:
        while True:
            try:
                conn = await self.acquire_connection()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — unrecoverable connect error
                log.debug("peer %s: terminal connect failure: %s", self.ref, e)
                # fail everything parked on this peer: when_connected waiters
                # re-raise via the TERMINATED state; registered calls error out
                self._set_state(ConnectionState.TERMINATED, e)
                for call in list(self.outbound_calls.values()):
                    call.set_error(e)
                return
            self._conn = conn
            self._set_state(ConnectionState.CONNECTED)
            # reliability: re-send every registered outbound call. A
            # transport failure here means the fresh link is already dead —
            # falling into receive() would park the UNSENT calls until some
            # unrelated event dropped the link, so it
            # forces a reconnect (which re-sends the whole batch again). A
            # non-transport failure (e.g. a call that can't serialize) is
            # that call's own error and must not wedge the peer.
            resend_failure: Optional[BaseException] = None
            for call in list(self.outbound_calls.values()):
                try:
                    # through send(), not _send_raw: outbound middlewares
                    # (auth tokens, session replacement) must rewrite a
                    # redelivered call exactly like the original send
                    await self.send(call.to_message())
                except asyncio.CancelledError:
                    conn.close()
                    raise
                except (ChannelClosedError, ConnectionError, OSError) as e:
                    resend_failure = e
                    break
                except Exception as e:  # noqa: BLE001 — per-call poison
                    call.set_error(e)
            if resend_failure is not None:
                self._conn = None
                conn.close(resend_failure)
                self._set_state(ConnectionState.DISCONNECTED, resend_failure)
                # connect-then-immediate-death bypasses the dial backoff
                # (the successful connect reset it) — bound the redial rate
                self._resend_failures += 1
                await asyncio.sleep(min(0.05 * (2 ** (self._resend_failures - 1)), 2.0))
                continue
            self._resend_failures = 0
            try:
                # one clock probe per (re)connect: delivery histograms can
                # then map this peer's origin_ts stamps onto the local
                # timeline (cross-host clock-safe timestamps).
                # The PREVIOUS connection's sample is dropped first: a
                # peer-host reboot resets its perf_counter epoch, and a
                # pinned min-RTT sample from the old epoch would be wildly
                # wrong forever (offsets are per-connection truths).
                # Best-effort: a link that dies here dies in receive() too.
                from ..diagnostics.clocksync import global_clock_sync

                global_clock_sync().forget(self.ref)
                await self.probe_clock()
            except asyncio.CancelledError:
                conn.close()
                raise
            except Exception:  # noqa: BLE001 — telemetry must not wedge the pump
                pass
            try:
                while True:
                    message = await conn.reader.receive()
                    await self.process_message(message)
            except asyncio.CancelledError:
                conn.close()
                raise
            except (ChannelClosedError, ConnectionError, OSError) as e:
                self._conn = None
                self._set_state(ConnectionState.DISCONNECTED, e)
                continue  # reconnect loop

    # ------------------------------------------------------------------ send
    @staticmethod
    def _not_connected(ref: str) -> ConnectionError:
        e = ConnectionError(f"peer {ref} is not connected")
        e._transport_death = True  # see _send_raw
        return e

    @property
    def outbox(self) -> "PeerOutbox":
        """The per-peer outbound drain queue + invalidation coalescer
        (created lazily — a peer that never sends never pays for it)."""
        if self._outbox is None:
            from .outbox import PeerOutbox

            self._outbox = PeerOutbox(self)
        return self._outbox

    async def send(self, message: RpcMessage) -> None:
        """Deliver one message, in per-peer FIFO order.

        Routed through the outbox drain queue: concurrent senders no longer
        interleave on the raw channel (order is the queue's, surviving
        whatever order the loop wakes tasks in), and a sender behind a slow
        frame is parked in the queue instead of on the channel. The error
        contract is unchanged — this resolves when the message hit the
        channel and raises what the channel write raised. The no-backlog
        fast path below keeps a lone send at its pre-outbox cost (one
        awaited channel write, no queue hop)."""
        if self._conn is None:
            raise self._not_connected(self.ref)
        outbox = self._outbox
        if outbox is None or outbox.can_bypass():
            ob = outbox if outbox is not None else self.outbox
            ob._in_flight = True
            try:
                await self._send_now(message)
                ob.messages_sent += 1
            finally:
                ob._in_flight = False
                if ob._fifo or ob._pending_inval:
                    ob._kick()
            return
        await outbox.send(message)

    async def _send_now(self, message: RpcMessage) -> None:
        """The raw delivery step (middlewares + channel write) — only the
        outbox drain and its bypass fast path may call this; everything
        else goes through :meth:`send` so FIFO order holds."""
        mws = self.hub.outbound_middlewares
        if mws:
            await _run_middlewares(mws, self, message, self._send_raw)
        else:
            await self._send_raw(message)

    async def _send_raw(self, message: RpcMessage) -> None:
        conn = self._conn
        if conn is None:
            raise self._not_connected(self.ref)
        try:
            await conn.writer.send(message)
        except asyncio.CancelledError:
            raise
        except (ChannelClosedError, ConnectionError, OSError) as e:
            # a failed SEND means the link is dead even when the reader
            # still hangs (the half-open shape): tear the connection down
            # so the pump notices and reconnects — otherwise a parked
            # registered call waits for a reconnect that never comes.
            # Guarded: a STALE sender waking up after a reconnect must not
            # tear down the fresh healthy connection that replaced its own.
            # EVERY genuine transport failure is tagged on the exception at
            # its raise site: delivery paths classify by this tag (race-
            # free), never by peeking at the shared mutable _conn — an
            # OSError-shaped exception WITHOUT the tag is a middleware
            # failure in disguise.
            e._transport_death = True
            if self._conn is conn:
                await self.disconnect(e)
            raise

    async def send_system(self, method: str, args: list, call_id: int = 0, headers: tuple = ()) -> None:
        await self.send(
            RpcMessage(0, call_id, SYSTEM_SERVICE, method, dumps(args), headers)
        )

    # ------------------------------------------------------------------ dispatch
    async def process_message(self, message: RpcMessage) -> None:
        """Dispatch one inbound message through the middleware chain.

        Failures are isolated PER MESSAGE: a middleware that rejects a call
        (auth raising PermissionError — an OSError subclass the pump would
        misread as a transport death) or a buggy middleware must neither
        tear down a healthy connection nor crash the pump; the caller gets
        a ``$sys.error`` reply instead of hanging."""
        try:
            mws = self.hub.inbound_middlewares
            if mws:
                await _run_middlewares(mws, self, message, self._dispatch_message)
            else:
                await self._dispatch_message(message)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            # counted (FL002): every degraded branch below is a fallback —
            # an error-rate spike must be scrapeable, not only in the logs
            from ..diagnostics.metrics import global_metrics

            global_metrics().counter(
                "fusion_rpc_process_failures_total",
                help="inbound messages whose processing raised (per-branch recovery below)",
            ).inc()
            log.exception(
                "peer %s: processing %s.%s #%d failed",
                self.ref, message.service, message.method, message.call_id,
            )
            if message.service == SYSTEM_SERVICE:
                # a completion ($sys.ok/.error) that failed to process must
                # not leave the awaiting caller parked forever on a healthy-
                # looking link — surface the failure to the call itself
                call = self.outbound_calls.get(message.call_id)
                if call is not None:
                    call.set_error(e)
            elif message.service in (COMPUTE_SYSTEM_SERVICE, TABLE_SYSTEM_SERVICE):
                # a dropped invalidation/fence push would mean stale-forever;
                # tear the link down so the reconnect re-send/re-register (or
                # invalidate-all-and-resubscribe) cycle restores consistency
                await self.disconnect(e)
            elif message.call_id:
                try:
                    await self.send(
                        RpcMessage(
                            message.call_type_id,
                            message.call_id,
                            SYSTEM_SERVICE,
                            "error",
                            dumps(ExceptionInfo.capture(e)),
                        )
                    )
                except Exception:  # noqa: BLE001 — the pump must survive
                    pass

    async def _dispatch_message(self, message: RpcMessage) -> None:
        if message.service == SYSTEM_SERVICE:
            self._process_system(message)
        elif message.service == COMPUTE_SYSTEM_SERVICE:
            handler = self.hub.compute_system_handler
            if handler is not None:
                handler(self, message)
        elif message.service == TABLE_SYSTEM_SERVICE:
            handler = self.hub.table_system_handler
            if handler is not None:
                handler(self, message)
        elif message.service == DIAG_SYSTEM_SERVICE:
            handler = self.hub.diag_system_handler
            if handler is not None:
                result = handler(self, message)
                if asyncio.iscoroutine(result):
                    # spawned, never awaited inline: diagnostics traffic
                    # must not head-of-line-block the receive pump — a slow
                    # explain resolution would otherwise delay the $sys-c
                    # invalidation frames queued behind it on this link. A
                    # hub with no handler silently drops the frame
                    # (introspection is additive, never load-bearing).
                    task = asyncio.get_event_loop().create_task(result)
                    self._diag_tasks.add(task)
                    task.add_done_callback(self._on_diag_done)
        elif message.service == MEMBER_SYSTEM_SERVICE:
            handler = self.hub.member_system_handler
            if handler is not None:
                result = handler(self, message)
                if asyncio.iscoroutine(result):
                    # same discipline as $sys-d: membership bookkeeping may
                    # need to SEND (a map reply to a heartbeat), and that
                    # awaited send must not head-of-line-block this link's
                    # receive pump. A hub with no handler drops the frame —
                    # a cluster-unaware peer ignores the control plane.
                    task = asyncio.get_event_loop().create_task(result)
                    self._diag_tasks.add(task)
                    task.add_done_callback(self._on_diag_done)
        else:
            self._process_inbound(message)

    def track_side_task(self, task: "asyncio.Task") -> "asyncio.Task":
        """Adopt a fire-and-forget task into this peer's lifecycle (the
        fusionlint FL003 contract): a strong ref until it settles — the
        loop holds tasks weakly — and cancellation at ``stop()``. Failures
        ride the ``_on_diag_done`` swallow: side traffic (resends,
        invalidation pushes, explain replies) times out at the asker and
        must never surface as an unhandled-task error on the serving loop."""
        self._diag_tasks.add(task)
        task.add_done_callback(self._on_diag_done)
        return task

    def _on_diag_done(self, task: "asyncio.Task") -> None:
        self._diag_tasks.discard(task)
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            # swallowed deliberately: a failed explain reply (dead link,
            # serialization hiccup) times out at the asker; it must never
            # surface as an unhandled-task error on the serving loop
            log.debug("diagnostics handler failed: %s", exc)

    async def probe_clock(self) -> None:
        """Send one NTP-style clock probe (cross-host
        clock-safe delivery timestamps). The ``clock-r`` reply lands the
        ``(t_send, t_remote, t_recv)`` sample in the process-wide
        :class:`~stl_fusion_tpu_torch.diagnostics.clocksync.ClockSync`, keyed by
        this peer's ref; delivery histograms then map the peer's
        ``origin_ts`` stamps onto the local timeline."""
        import time as _time

        await self.send_system("clock", [_time.perf_counter()])

    def _process_system(self, message: RpcMessage) -> None:
        """$sys: ok / error / cancel / not-found (RpcSystemCalls.cs:6-71)
        + clock/clock-r (the clock offset probe)."""
        method = message.method
        if method == "clock":
            import time as _time

            (t_send,) = loads(message.argument_data)
            reply = self.send_system("clock-r", [t_send, _time.perf_counter()])
            # fire-and-forget on the pump's loop: a probe reply must never
            # block message processing (same discipline as $sys-d)
            task = asyncio.get_event_loop().create_task(reply)
            self._diag_tasks.add(task)
            task.add_done_callback(self._on_diag_done)
            return
        if method == "clock-r":
            import time as _time

            from ..diagnostics.clocksync import global_clock_sync

            t_send, t_remote = loads(message.argument_data)
            global_clock_sync().note_sample(
                self.ref, float(t_send), float(t_remote), _time.perf_counter()
            )
            return
        if method == "ok":
            call = self.outbound_calls.get(message.call_id)
            if call is not None:
                call.set_result(loads(message.argument_data), message)
        elif method == "error":
            call = self.outbound_calls.get(message.call_id)
            if call is not None:
                info: ExceptionInfo = loads(message.argument_data)
                call.set_error(info.to_exception())
        elif method == "cancel":
            (call_id,) = loads(message.argument_data)
            inbound = self.inbound_calls.get(call_id)
            if inbound is not None:
                inbound.cancel()
        elif method == "not-found":
            call = self.outbound_calls.get(message.call_id)
            if call is not None:
                call.set_error(LookupError("remote endpoint not found"))

    def _process_inbound(self, message: RpcMessage) -> None:
        existing = self.inbound_calls.get(message.call_id)
        if existing is not None:
            existing.restart()  # duplicate delivery after reconnect
            return
        if message.call_id in self._completed_inbound:
            return  # already served and pruned
        inbound_cls = self.hub.call_types.inbound(message.call_type_id)
        inbound_cls(self, message).start()

    def note_inbound_completed(self, call_id: int) -> None:
        # keep the entry for redelivery dedup; prune via recently-seen window
        self._completed_inbound.try_add(call_id)

    # ------------------------------------------------------------------ disconnect
    async def disconnect(self, error: Optional[BaseException] = None) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close(error)
            # surface the drop immediately — the pump notices asynchronously
            self._set_state(ConnectionState.DISCONNECTED, error)

    async def stop(self) -> None:
        await self.disconnect()
        if self._outbox is not None:
            self._outbox.stop()
        for task in list(self._diag_tasks):
            # in-flight explain replies die with the peer — left pending
            # they surface as "Task was destroyed but it is pending!" at
            # loop close (the asker's timeout covers the lost reply)
            task.cancel()
        await super().stop()


class RpcClientPeer(RpcPeer):
    """Dials via the hub's client connector with jittered backoff
    (≈ RpcClientPeer.cs:6-55 + RpcClientPeerReconnectDelayer)."""

    def __init__(self, hub: "RpcHub", ref: str, reconnect_delays: Optional[RetryDelaySeq] = None):
        super().__init__(hub, ref)
        self.reconnect_delays = reconnect_delays or RetryDelaySeq(min_delay=0.05, max_delay=5.0)
        self.reconnects_at: Optional[float] = None

    async def acquire_connection(self) -> ChannelPair:
        failures = 0
        while True:
            try:
                conn = await self.hub.connect_client(self)
                self.reconnects_at = None
                return conn
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                if self.hub.unrecoverable_error_detector(e):
                    # config/programming error — retrying can never succeed
                    # (≈ RpcUnrecoverableErrorDetector, RpcPeer.cs:268-274)
                    raise
                failures += 1
                if failures > self.hub.max_connect_attempts:
                    raise
                delay = self.reconnect_delays[failures]
                self.reconnects_at = asyncio.get_event_loop().time() + delay
                log.debug("peer %s reconnect #%d in %.2fs (%s)", self.ref, failures, delay, e)
                await asyncio.sleep(delay)


class RpcServerPeer(RpcPeer):
    """Receives connections from a listener (≈ RpcServerPeer.cs)."""

    def __init__(self, hub: "RpcHub", ref: str):
        super().__init__(hub, ref)
        self._handoff: "asyncio.Queue[ChannelPair]" = asyncio.Queue()

    def connect(self, conn: ChannelPair) -> None:
        """Hand a fresh transport to this peer (new physical connection)."""
        old, self._conn = self._conn, None
        if old is not None:
            old.close()
        self._handoff.put_nowait(conn)
        self.start()

    async def acquire_connection(self) -> ChannelPair:
        return await self._handoff.get()
