"""Compute-call RPC type: calls that carry invalidation subscriptions.

Re-expression of src/Stl.Fusion/Client/Internal/ — RpcOutboundComputeCall
(:11-109), RpcInboundComputeCall (:20-106), RpcComputeSystemCalls (:11-27):

- the server runs the target under dependency capture, attaches the
  computed's version as the ``@version`` header, sends the result, then
  **keeps the call registered and awaits the computed's invalidation**;
  when it fires, it pushes a ``$sys-c.invalidate`` (fire-and-forget) tagged
  with the call id and only then completes;
- the client resolves the pushed invalidation to the outbound call, which
  invalidates its bound ClientComputed — re-entering the local cascade.

This is THE mechanism that makes a remote cache coherent: every remote read
is implicitly a subscription.

The BATCHED flavor of the same contract (the upstream value
plane's level 1): ``$sys-c.recompute_batch`` carries a whole fence-burst's
worth of per-key compute calls in ONE frame — each entry is a real
client-allocated outbound call (so reconnect re-send, redelivery dedup and
the invalidation subscription machinery are IDENTICAL to the per-key
path), but the RPC/codec/loop-hop envelope is paid once per burst instead
of once per key. The server answers every successfully-captured entry in
ONE ``recompute_batch_r`` frame; per-entry failures are answered through
the ordinary per-call ``$sys.error`` wire shape so the client's routing /
retry semantics (ShardMovedError, ResultMissedError) stay byte-identical
with the per-key path. Entries may additionally request PUBLISH mode
(level 2): the serving member then keeps a standing registration
(rpc/fanout.py ``WaveValuePublisher``) and answers later wave fences with
pushed ``value_block`` frames instead of plain invalidations.
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING, Any, Optional

from ..core.context import try_capture
from ..diagnostics.flight_recorder import RECORDER, call_key
from ..diagnostics.metrics import global_metrics
from ..utils.errors import ExceptionInfo
from ..utils.ltag import LTag
from ..utils.serialization import dumps, loads
from ..rpc.calls import RpcInboundCall, RpcOutboundCall
from ..rpc.message import (
    CALL_TYPE_COMPUTE,
    COMPUTE_SYSTEM_SERVICE,
    SYSTEM_SERVICE,
    VERSION_HEADER,
    RpcMessage,
)

if TYPE_CHECKING:
    from ..rpc.hub import RpcHub
    from ..rpc.peer import RpcPeer

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "ResultMissedError",
    "RpcOutboundComputeCall",
    "RpcInboundComputeCall",
    "install_compute_call_type",
]


class ResultMissedError(Exception):
    """An invalidation arrived while the call's result was still pending —
    no result is coming (e.g. the server answered a re-sent call with
    invalidate-only). Retriable: the client just re-issues the call."""


#: cached delivery histogram: set_invalidated runs once per applied key in
#: a fan-out burst, and a registry get-or-create there (name sanitize +
#: lock) would tax the exact path the outbox optimized. Cached once; a test that
#: clears the global registry mid-run keeps recording into the detached
#: instance (nothing in-repo does that).
_delivery_hist = None


def _record_delivery(delta_ms: float, cause: Optional[str] = None) -> None:
    global _delivery_hist
    h = _delivery_hist
    if h is None:
        h = _delivery_hist = global_metrics().histogram(
            "fusion_e2e_delivery_ms",
            help="server wave apply -> client invalidation apply",
        )
    # cause rides into the histogram's exemplar ring: a tail
    # delivery sample keeps the wave id that produced it, so an alert on
    # this histogram links to GET /trace?cause= in one hop
    h.record(delta_ms, cause=cause)


class RpcOutboundComputeCall(RpcOutboundCall):
    call_type_id = CALL_TYPE_COMPUTE

    def __init__(self, peer, service, method, args, no_wait=False, headers=()):
        super().__init__(peer, service, method, args, no_wait, headers)
        self.result_version: Optional[LTag] = None
        #: cause id of the server-side wave/span whose invalidation fenced
        #: this call; None until invalidated or
        #: when the server predates cause stamping
        self.invalidation_cause: Optional[str] = None
        #: server-side wave-apply timestamp the fence carried (perf_counter
        #: epoch — trustworthy same-host only, like the delivery histogram).
        #: Kept so a DOWNSTREAM tier (the edge gateway) can extend
        #: the delivery measurement one more hop: fence → edge → session.
        self.invalidation_origin_ts: Optional[float] = None
        self.when_invalidated: asyncio.Future = asyncio.get_event_loop().create_future()
        #: True when this call rode a ``recompute_batch`` entry that asked
        #: for publish mode AND the server armed a standing registration —
        #: later fences for this key arrive as ``value_block`` pushes, not
        #: plain invalidations (the edge's zero-RPC path)
        self.publish_armed = False
        #: sync callbacks run INSIDE set_invalidated — the bound
        #: ClientComputed invalidates in the same dispatch that applied the
        #: frame instead of one call_soon hop later; at fan-out scale those
        #: hops were a measurable share of the staleness window
        self.invalidated_callbacks: list = []

    def set_result(self, value: Any, message: RpcMessage) -> None:
        v = message.header(VERSION_HEADER)
        version = LTag.parse(v) if v else None
        if self.future is not None and self.future.done():
            # a REDELIVERED result (reconnect re-send): the original answer
            # was already consumed. A version that moved on means the server
            # recomputed while the link was down — and the invalidation for
            # OUR version died with the old link (sent into a buffer the
            # link took down with it). Without this check the bound computed
            # stays consistent-but-stale FOREVER (≈ the reference's
            # version-mismatch handling, RpcOutboundComputeCall.cs:71-109).
            if (
                version is not None
                and self.result_version is not None
                and version != self.result_version
            ):
                self.set_invalidated()
            return
        self.result_version = version
        # compute calls STAY registered — the invalidation push arrives later
        if self.future is not None:
            self.future.set_result(value)

    def set_error(self, error: BaseException) -> None:
        super().set_error(error)
        self.set_invalidated()  # an errored call can't deliver invalidations

    def set_invalidated(self, cause: Optional[str] = None, origin_ts: Optional[float] = None) -> None:
        """Single-connection delivery is ordered (result, then invalidate —
        the reference leans on that, RpcOutboundComputeCall.cs:71-83), but
        two of our paths deliver an invalidate while the result future is
        still pending: the reconnect-riding invalidation sender racing a
        re-sent result, and the server's restart() answering a re-sent call
        with invalidate-ONLY when its computed is already stale. No result
        can be counted on after that, so a pending future fails with the
        retriable ``ResultMissedError`` (the client's already-invalidated
        retry loop handles it) instead of parking the caller forever.

        ``cause``/``origin_ts`` arrive from the ``$sys-c`` frame: the cause
        links this fence to its originating server wave; the origin
        timestamp yields the end-to-end delivery sample recorded into the
        process histogram (``fusion_e2e_delivery_ms``). The timestamp is
        the sender's ``perf_counter`` value; it is mapped
        onto the local timeline through the peer's probed clock offset
        (diagnostics/clocksync.py — one NTP-style probe per connect, so
        cross-host samples are accurate to ~RTT/2 instead of meaningless).
        Never-probed peers keep the identity mapping, which is exact for
        the in-process / same-host stacks. The range guard below remains
        the belt for unprobed cross-host epochs."""
        if cause is not None:
            self.invalidation_cause = cause
        if RECORDER.enabled:
            # the client end of the causal chain: explain() on this process
            # reads these to say WHO fenced the key (and the cause joins
            # back to the server's wave/span over the $sys-d hop)
            RECORDER.note(
                "fenced",
                key=call_key(self.service, self.method, self.args),
                cause=cause,
                detail=f"call#{self.call_id} peer={getattr(self.peer, 'ref', '?')}",
            )
        if origin_ts is not None:
            # map the sender's perf_counter stamp onto the LOCAL timeline
            # through the peer's probed clock offset (cross-host
            # clock-safe delivery timestamps — identity for never-probed
            # same-clock stacks, so in-process transports keep the exact
            # old behavior). The corrected value is what we STORE, so the
            # edge tier's delivery hop inherits the correction for free.
            from ..diagnostics.clocksync import global_clock_sync

            origin_ts = global_clock_sync().to_local(
                getattr(self.peer, "ref", None), origin_ts
            )
            self.invalidation_origin_ts = origin_ts
            delta_ms = (time.perf_counter() - origin_ts) * 1e3
            if 0.0 <= delta_ms < 3.6e6:  # range guard, NOT skew detection
                _record_delivery(delta_ms, cause=cause)
        if self.future is not None and not self.future.done():
            self.future.set_exception(
                ResultMissedError(f"invalidation overtook the result of call {self.call_id}")
            )
        if not self.when_invalidated.done():
            self.when_invalidated.set_result(None)
            callbacks, self.invalidated_callbacks = self.invalidated_callbacks, []
            for cb in callbacks:
                cb()
        self.peer.outbound_calls.pop(self.call_id, None)

    def set_batch_result(self, version: Optional[str], value: Any, publish_armed: bool = False) -> None:
        """Result delivery through a ``recompute_batch_r`` frame entry —
        the batched twin of :meth:`set_result` (version rides inline in
        the entry instead of as a ``@version`` header). The redelivered-
        result version-mismatch rule applies unchanged: a done future with
        a moved-on version means the invalidation for OUR version died
        with an old link."""
        v = LTag.parse(version) if version else None
        if self.future is not None and self.future.done():
            if (
                v is not None
                and self.result_version is not None
                and v != self.result_version
            ):
                self.set_invalidated()
            return
        self.publish_armed = bool(publish_armed)
        self.result_version = v
        if self.future is not None:
            self.future.set_result(value)

    def unregister(self) -> None:
        self.peer.outbound_calls.pop(self.call_id, None)


class RpcInboundComputeCall(RpcInboundCall):
    def __init__(self, peer, message):
        super().__init__(peer, message)
        self.computed = None
        self._fanout_nid = None  # registered in the hub's ComputeFanoutIndex
        #: set by the fanout index when a wave drain already shipped this
        #: subscription's invalidation — the watch task must not re-send
        self._invalidation_pushed = False

    async def _run(self) -> None:
        try:
            computed = await self._capture_target()
        except asyncio.CancelledError:
            self.peer.inbound_calls.pop(self.call_id, None)
            raise
        except Exception as e:  # noqa: BLE001 — capture failed outright
            await self.send_error(e)
            self.peer.inbound_calls.pop(self.call_id, None)
            return
        self.computed = computed
        headers = ((VERSION_HEADER, computed.version.format()),)
        out = computed._output
        if out is not None and out.has_error:
            await self.send_error(out.error)  # errors carry no subscription
            self.peer.inbound_calls.pop(self.call_id, None)
            return
        try:
            # send_ok's delivery swallows TRANSPORT failures itself
            # (restart() re-sends); what reaches here is a serialization
            # or middleware failure — the client must error, not hang
            await self.send_ok(out.value if out is not None else None, headers=headers)
        except asyncio.CancelledError:
            self.peer.inbound_calls.pop(self.call_id, None)
            raise
        except Exception as e:  # noqa: BLE001
            try:
                await self.send_error(e)
            except Exception:  # noqa: BLE001
                pass
            self.peer.inbound_calls.pop(self.call_id, None)
            return
        self._arm_subscription(computed)

    def _arm_subscription(self, computed) -> None:
        """Stay registered; push $sys-c when the computed dies. The push is
        armed as a SYNC on_invalidated handler, not a parked watch task:
        under coalescing the push is a dict insert into the peer outbox
        (flushed as one $sys-c.invalidate_batch per tick), so a burst
        fencing 10k subscriptions costs 10k inserts + N frames — not 10k
        task wakeups + 10k awaited sends. Graph-resident computeds ALSO
        index into the hub's fanout index (rpc/fanout.py) so a device
        burst's newly-mask drains them during wave application; the
        handler then just cleans up (``_invalidation_pushed``).
        (index registration honors the wire-compat flag: a hub serving
        per-key frames must not let the mask drain ship batch frames)"""
        fanout = getattr(self.peer.hub, "compute_fanout", None)
        nid = getattr(computed, "_backend_nid", None)
        if (
            fanout is not None
            and nid is not None
            and getattr(self.peer.hub, "coalesce_invalidations", True)
        ):
            self._fanout_nid = nid
            fanout.register(
                nid, self.peer, self.call_id, computed.version.format(), call=self
            )
        computed.on_invalidated(self._on_computed_invalidated)

    async def serve_inline(self, publish: bool = False):
        """Batch-entry flavor of :meth:`_run` (``recompute_batch``): capture + arm the subscription exactly like a per-key call,
        but RETURN the response entry ``[call_id, version, value,
        publish_armed]`` for the caller to fold into ONE
        ``recompute_batch_r`` frame instead of sending a per-call reply.
        Failures (capture errors AND memoized compute errors) are answered
        through the ordinary per-call ``$sys.error`` wire shape — the
        client's per-key fallback ladder owns them — and return None.

        With ``publish`` (and a :class:`~..rpc.fanout.WaveValuePublisher`
        installed on the hub) the captured computed additionally registers
        a STANDING publish subscription: later wave fences ship a pushed
        ``value_block`` entry instead of a plain invalidation."""
        self.peer.inbound_calls[self.call_id] = self
        try:
            computed = await self._capture_target()
        except asyncio.CancelledError:
            self.peer.inbound_calls.pop(self.call_id, None)
            raise
        except Exception as e:  # noqa: BLE001 — capture failed outright
            self.peer.inbound_calls.pop(self.call_id, None)
            await self._send_entry_error(e)
            return None
        self.computed = computed
        out = computed._output
        if out is not None and out.has_error:
            self.peer.inbound_calls.pop(self.call_id, None)
            await self._send_entry_error(out.error)
            return None
        armed = False
        if publish:
            publisher = getattr(self.peer.hub, "value_publisher", None)
            if publisher is not None:
                armed = publisher.register_standing(
                    self.peer,
                    self.call_id,
                    self.message.service,
                    self.message.method,
                    loads(self.message.argument_data),
                    computed,
                )
        self._arm_subscription(computed)
        return [
            self.call_id,
            computed.version.format(),
            out.value if out is not None else None,
            armed,
        ]

    async def _send_entry_error(self, error: BaseException) -> None:
        """Per-entry error reply for the batch path — the per-key wire
        shape ($sys.error with this entry's call id), so the client's
        existing completion/ShardMoved handling applies untouched. A
        transport death is swallowed: the client's reconnect re-send
        replays the entry as an ordinary per-key call."""
        try:
            await self.peer.send(self._error_message(error))
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — link died; reconnect re-serves
            pass

    def restart(self) -> None:
        """Re-delivery after reconnect: if our computed already died, the
        result is stale — push the invalidation instead (≈ version-mismatch
        handling, RpcInboundCall.Restart + RpcOutboundComputeCall version
        checks). A batch-served call (``serve_inline``) stored no
        result_message — rebuild the per-key OK reply from the live
        computed so the client's re-sent call never hangs."""
        if self.computed is not None and self.computed.is_invalidated:
            self.peer.track_side_task(
                asyncio.get_event_loop().create_task(self._send_invalidation())
            )
        elif self.result_message is None and self.computed is not None:
            out = self.computed._output
            headers = ((VERSION_HEADER, self.computed.version.format()),)
            try:
                if out is not None and out.has_error:
                    self._build_error(out.error)
                else:
                    self._build_ok(
                        out.value if out is not None else None, headers=headers
                    )
            except Exception:  # noqa: BLE001 — unserializable: invalidate
                self.peer.track_side_task(
                    asyncio.get_event_loop().create_task(self._send_invalidation())
                )
                return
            super().restart()
        else:
            super().restart()

    async def _capture_target(self):
        from ..core.context import suspend_dependency_capture

        args = loads(self.message.argument_data)
        service_def = self.peer.hub.service_registry.require(self.message.service)
        method = service_def.method(self.message.method)
        with suspend_dependency_capture():  # RPC boundary: no cross-wire edges
            computed = await try_capture(lambda: method.fn(*args))
        if computed is None:
            raise RuntimeError(
                f"{self.message.service}.{self.message.method} is not a compute method "
                f"(nothing was captured)"
            )
        return computed

    def _on_computed_invalidated(self, computed) -> None:
        """Sync invalidation handler: unindex, unregister, push. Runs inside
        the invalidation (host-led cascade or the wave's eager apply)."""
        if self._fanout_nid is not None:
            fanout = getattr(self.peer.hub, "compute_fanout", None)
            if fanout is not None:
                fanout.unregister(self._fanout_nid, self.peer, self.call_id)
            self._fanout_nid = None
        self.peer.inbound_calls.pop(self.call_id, None)
        if self._invalidation_pushed:
            return  # the wave drain already batched this subscription
        # a HOST-LED invalidation (reshard fence, manual invalidate — not a
        # wave the publisher intercepted): a standing publish registration
        # must not outlive it — the plain invalidation below tells the edge
        # to re-read and re-arm, and a stale standing record would keep
        # publishing values for a subscription the client already replaced
        publisher = getattr(self.peer.hub, "value_publisher", None)
        if publisher is not None:
            publisher.drop_standing(self.peer, self.call_id)
        pushed = False
        if getattr(self.peer.hub, "coalesce_invalidations", True):
            self._invalidation_pushed = True
            version = computed.version.format() if computed is not None else None
            try:
                self.peer.outbox.post_invalidation(
                    self.call_id,
                    version,
                    cause=getattr(computed, "_invalidation_cause", None),
                    origin_ts=time.perf_counter(),
                )
            except RuntimeError:  # no running loop: no live link to push to
                pass
            else:
                pushed = True
        else:
            # per-key wire shape: the send awaits the channel — needs a task
            def _spawn():
                self.peer.track_side_task(
                    asyncio.get_event_loop().create_task(self._send_invalidation())
                )

            try:
                _spawn()
                pushed = True
            except RuntimeError:
                # invalidation applied from an off-loop thread: marshal the
                # spawn onto the peer's home loop (parity with the old
                # watch task's threadsafe wakeup)
                home = self.peer.outbox._home_loop
                if home is not None and not home.is_closed():
                    try:
                        home.call_soon_threadsafe(_spawn)
                        pushed = True
                    except RuntimeError:
                        pass  # loop closed: peer is gone
        if pushed and RECORDER.enabled:
            # server side of the fence, journaled AFTER the push was
            # actually enqueued — a swallowed no-loop failure must not read
            # as "client was notified" in explain() (the mask-drain path
            # notes its own in rpc/fanout.py)
            RECORDER.note(
                "client_fenced",
                key=repr(computed.input) if computed is not None else None,
                cause=getattr(computed, "_invalidation_cause", None),
                count=1,
                detail=f"call#{self.call_id} peer={self.peer.ref}",
            )

    async def _send_invalidation(self, max_attempts: int = 100) -> None:
        """Deliver this subscription's invalidation.

        Default path: POST into the peer's outbox coalescer — synchronous,
        no awaited channel write per subscription; the outbox flushes one
        ``$sys-c.invalidate_batch`` frame per drain tick (version-deduped)
        and itself rides out reconnects (pending entries survive a link
        flap). ``hub.coalesce_invalidations = False`` selects the original
        one-frame-per-key wire shape below, kept for wire compat and as the
        fan-out A/B baseline.

        Callers: the per-key send task the invalidation handler spawns, and
        ``restart()`` (a re-sent call means the client's state is unknown —
        re-push unconditionally; ``_invalidation_pushed`` never gates here,
        duplicate delivery is a client-side no-op)."""
        cause = getattr(self.computed, "_invalidation_cause", None)
        if getattr(self.peer.hub, "coalesce_invalidations", True):
            version = (
                self.computed.version.format() if self.computed is not None else None
            )
            self.peer.outbox.post_invalidation(
                self.call_id, version, cause=cause, origin_ts=time.perf_counter()
            )
            return
        headers = [("@t0", repr(time.perf_counter()))]
        if cause is not None:
            headers.append(("@cause", cause))
        message = RpcMessage(
            call_type_id=CALL_TYPE_COMPUTE,
            call_id=self.call_id,
            service=COMPUTE_SYSTEM_SERVICE,
            method="invalidate",
            argument_data=dumps([self.call_id]),
            headers=tuple(headers),
        )
        for _ in range(max_attempts):
            try:
                await self.peer.send(message)
                return
            except Exception:  # noqa: BLE001 — wait for the link to return
                ev = self.peer.connection_state.latest()
                if ev.value.is_connected:
                    await asyncio.sleep(0.05)
                else:
                    try:
                        await asyncio.wait_for(ev.when(lambda s: s.is_connected), 30.0)
                    except asyncio.TimeoutError:
                        return  # client is gone; it will resubscribe on return

    def on_completed(self) -> None:
        pass  # compute calls manage their own registration lifetime


async def _serve_recompute_batch(peer: "RpcPeer", message: RpcMessage) -> None:
    """Server side of ``$sys-c.recompute_batch``: ONE
    inbound frame carries a whole fence-burst's per-key compute calls —
    ``[[call_id, service, method, args, publish, headers], ...]`` — and
    ONE ``recompute_batch_r`` frame answers every entry that captured
    cleanly. Each entry is dispatched as its own synthetic per-key message
    THROUGH the hub's inbound middleware chain, so the cluster shard guard
    (and any auth middleware) sees exactly the per-key wire shape: a
    stale-epoch entry is rejected with the carried map via the normal
    per-call ``$sys.error`` path and simply doesn't appear in the batch
    answer. The recompute itself still runs per key through the capture
    machinery — what this batches is the RPC/codec/loop-hop ENVELOPE."""
    from ..rpc.peer import _run_middlewares

    (entries,) = loads(message.argument_data)
    hub = peer.hub

    async def _serve_entry(entry):
        call_id = entry[0]
        service, method = entry[1], entry[2]
        args = entry[3]
        publish = bool(entry[4]) if len(entry) > 4 else False
        headers = (
            tuple((str(k), str(v)) for k, v in entry[5]) if len(entry) > 5 else ()
        )
        existing = peer.inbound_calls.get(call_id)
        if existing is not None:
            existing.restart()  # duplicate delivery after reconnect
            return None
        if call_id in peer._completed_inbound:
            return None  # already served and pruned
        sub_msg = RpcMessage(
            call_type_id=CALL_TYPE_COMPUTE,
            call_id=call_id,
            service=service,
            method=method,
            argument_data=dumps(list(args)),
            headers=headers,
        )
        served: dict = {}

        async def _terminal(msg: RpcMessage) -> None:
            inbound = RpcInboundComputeCall(peer, msg)
            result = await inbound.serve_inline(publish=publish)
            if result is not None:
                served["entry"] = result

        try:
            mws = hub.inbound_middlewares
            if mws:
                await _run_middlewares(mws, peer, sub_msg, _terminal)
            else:
                await _terminal(sub_msg)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — one entry's failure must
            # never poison its batch siblings: answer it per-key
            try:
                await peer.send(
                    RpcMessage(
                        CALL_TYPE_COMPUTE,
                        call_id,
                        SYSTEM_SERVICE,
                        "error",
                        dumps(ExceptionInfo.capture(e)),
                    )
                )
            except Exception:  # noqa: BLE001 — link died; reconnect re-serves
                pass
            return None
        return served.get("entry")

    # entries capture CONCURRENTLY (registry single-flight dedups shared
    # keys): one slow recompute must not head-of-line-block its batch
    # siblings — the per-key path ran each inbound call as its own task,
    # and the reply frame matches entries by call id, so order is free
    results = await asyncio.gather(
        *(_serve_entry(entry) for entry in entries), return_exceptions=True
    )
    ok_entries = []
    for result in results:
        if isinstance(result, asyncio.CancelledError):
            raise result
        if isinstance(result, BaseException):
            log.exception("recompute_batch entry failed", exc_info=result)
            continue
        if result is not None:
            ok_entries.append(result)
    if ok_entries:
        await peer.send(
            RpcMessage(
                call_type_id=CALL_TYPE_COMPUTE,
                call_id=0,
                service=COMPUTE_SYSTEM_SERVICE,
                method="recompute_batch_r",
                argument_data=dumps([ok_entries]),
            )
        )


def install_compute_call_type(rpc_hub: "RpcHub") -> None:
    """Register call type 1 + the $sys-c dispatcher on an RPC hub
    (≈ RpcComputeCallType.cs registration)."""
    rpc_hub.call_types.register(CALL_TYPE_COMPUTE, RpcOutboundComputeCall, RpcInboundComputeCall)

    def handle_compute_system(peer: "RpcPeer", message: RpcMessage) -> None:
        if message.method == "invalidate":
            (call_id,) = loads(message.argument_data)
            call = peer.outbound_calls.get(call_id)
            if isinstance(call, RpcOutboundComputeCall):
                t0 = message.header("@t0")
                call.set_invalidated(
                    cause=message.header("@cause"),
                    origin_ts=float(t0) if t0 else None,
                )
            else:
                # a publish-mode key's client call retires once the value
                # plane takes over (the edge invalidated its local node) —
                # a FALLBACK fence for it routes to the value-plane client
                vpc = getattr(peer.hub, "value_plane_client", None)
                if vpc is not None:
                    t0 = message.header("@t0")
                    vpc.on_block_fence(
                        peer, call_id, message.header("@cause"),
                        float(t0) if t0 else None,
                    )
        elif message.method == "invalidate_batch":
            # one frame, many subscriptions: [[call_id, version|None], ...].
            # Application is per-entry identical to a per-key invalidate —
            # invalidation is monotone, so the entry's version never gates
            # it (an entry for a version the client never saw still means
            # "your value is stale"; the version-mismatch rule in
            # set_result covers the redelivered-result interaction, and a
            # dup/reordered batch finds the call already unregistered and
            # no-ops). The version rides for dedup at the sender and
            # diagnostics here.
            (entries,) = loads(message.argument_data)
            vpc = None
            for entry in entries:
                call = peer.outbound_calls.get(entry[0])
                if isinstance(call, RpcOutboundComputeCall):
                    # wire compat: older senders ship [cid, ver];
                    # current senders [cid, ver, cause, origin_ts]
                    call.set_invalidated(
                        cause=entry[2] if len(entry) > 2 else None,
                        origin_ts=entry[3] if len(entry) > 3 else None,
                    )
                else:
                    if vpc is None:
                        vpc = getattr(peer.hub, "value_plane_client", None)
                    if vpc is not None:
                        vpc.on_block_fence(
                            peer,
                            entry[0],
                            entry[2] if len(entry) > 2 else None,
                            entry[3] if len(entry) > 3 else None,
                        )
        elif message.method == "recompute_batch":
            # a whole fence-burst's re-reads in one
            # frame. Async (capture) — spawned, never awaited inline, the
            # same discipline as $sys-d: a slow recompute must not
            # head-of-line-block this link's invalidation frames
            task = asyncio.get_event_loop().create_task(
                _serve_recompute_batch(peer, message)
            )
            peer._diag_tasks.add(task)
            task.add_done_callback(peer._on_diag_done)
        elif message.method == "recompute_batch_r":
            (entries,) = loads(message.argument_data)
            for entry in entries:
                call = peer.outbound_calls.get(entry[0])
                if isinstance(call, RpcOutboundComputeCall):
                    call.set_batch_result(
                        entry[1], entry[2],
                        bool(entry[3]) if len(entry) > 3 else False,
                    )
        elif message.method == "value_block":
            # a wave's recomputed hot-set pushed as ONE
            # columnar frame — routed to whoever installed the value-plane
            # client on this hub (the EdgeNode)
            vpc = getattr(peer.hub, "value_plane_client", None)
            if vpc is not None:
                vpc.on_value_block(peer, message)

    rpc_hub.compute_system_handler = handle_compute_system
