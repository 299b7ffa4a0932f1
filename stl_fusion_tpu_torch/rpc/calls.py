"""Outbound/inbound call machinery.

Re-expression of src/Stl.Rpc/Infrastructure/RpcOutboundCall.cs:7-162 and
RpcInboundCall.cs:8-243:

- an OUTBOUND call registers itself with its peer (so reconnect can re-send
  it, RpcPeer.cs:116-119), serializes its arguments, sends, and awaits a
  ``$sys`` completion (Ok / Error / Cancel); awaiter cancellation pushes a
  ``$sys.cancel`` to the server;
- an INBOUND call dedups by (peer, call_id) — a re-sent call after reconnect
  finds the registered call and just re-sends its result (``Restart``,
  RpcInboundCall.cs:160-173) — invokes the target, and reports via ``$sys``.

Call *types* (plain vs compute) come from a small registry so the Fusion
client layer can swap in call classes that carry invalidation subscriptions
(Client/Internal/RpcComputeCallType.cs) without the peer knowing.
"""
from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple, Type

from ..utils.async_utils import ChannelClosedError
from ..utils.errors import ExceptionInfo
from ..utils.serialization import dumps, loads
from .message import CALL_TYPE_PLAIN, SYSTEM_SERVICE, RpcMessage

if TYPE_CHECKING:
    from .peer import RpcPeer

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["RpcOutboundCall", "RpcInboundCall", "RpcCallTypeRegistry"]


class RpcOutboundCall:
    """One client-side call bound to a peer."""

    call_type_id = CALL_TYPE_PLAIN

    def __init__(
        self,
        peer: "RpcPeer",
        service: str,
        method: str,
        args: tuple,
        no_wait: bool = False,
        headers: tuple = (),
    ):
        self.peer = peer
        self.service = service
        self.method = method
        self.args = args
        self.no_wait = no_wait
        #: extra wire headers stamped on the call message (the cluster
        #: router's ``@shard``/``@epoch``/``@failover`` stamps ride here);
        #: fixed at call creation, so a reconnect re-send replays the SAME
        #: stamp — a re-sent call with a stale epoch is rejected with the
        #: current map, which is exactly the sync the client needs
        self.headers = headers
        self.call_id = peer.allocate_call_id()
        self.future: Optional[asyncio.Future] = None if no_wait else asyncio.get_event_loop().create_future()

    # -- wire --------------------------------------------------------------
    def to_message(self) -> RpcMessage:
        return RpcMessage(
            call_type_id=self.call_type_id,
            call_id=self.call_id,
            service=self.service,
            method=self.method,
            argument_data=dumps(list(self.args)),
            headers=self.headers,
        )

    # -- lifecycle ---------------------------------------------------------
    async def invoke(self) -> Any:
        """Register → send → await completion (with cancel propagation)."""
        if not self.no_wait:
            self.peer.outbound_calls[self.call_id] = self
        try:
            await self.peer.send(self.to_message())
        except Exception:
            # not connected yet: stay registered; reconnect re-sends us
            if self.no_wait:
                raise
        if self.no_wait:
            return None
        try:
            return await self.future
        except asyncio.CancelledError:
            self.peer.outbound_calls.pop(self.call_id, None)
            try:
                await self.peer.send_system("cancel", [self.call_id])
            except Exception:  # noqa: BLE001 — best-effort cancel
                pass
            raise

    # -- completion (from $sys) -------------------------------------------
    def set_result(self, value: Any, message: RpcMessage) -> None:
        self.peer.outbound_calls.pop(self.call_id, None)
        if self.future is not None and not self.future.done():
            self.future.set_result(value)

    def set_error(self, error: BaseException) -> None:
        self.peer.outbound_calls.pop(self.call_id, None)
        if self.future is not None and not self.future.done():
            self.future.set_exception(error)


class RpcInboundCall:
    """One server-side call; registered for reconnect dedup."""

    def __init__(self, peer: "RpcPeer", message: RpcMessage):
        self.peer = peer
        self.message = message
        self.call_id = message.call_id
        self.result_message: Optional[RpcMessage] = None
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self.peer.inbound_calls[self.call_id] = self
        self._task = asyncio.get_event_loop().create_task(self._run_gated())

    async def _run_gated(self) -> None:
        # per-peer inbound concurrency limit (system calls never come through
        # here, so they are exempt — reference RpcPeer.cs:100-110)
        semaphore = self.peer.inbound_semaphore
        if semaphore is None:
            await self._run()
            return
        try:
            await semaphore.acquire()
        except asyncio.CancelledError:
            # cancelled while QUEUED: _run never starts, so its cleanup
            # never runs — unregister here or the stale entry swallows any
            # post-reconnect re-send of this call id forever
            self.peer.inbound_calls.pop(self.call_id, None)
            raise
        try:
            await self._run()
        finally:
            semaphore.release()

    def restart(self) -> None:
        """Duplicate delivery (client re-sent after reconnect): re-send the
        result if we have one; otherwise the original task is still running
        and will send it."""
        if self.result_message is not None:
            self.peer.track_side_task(
                asyncio.get_event_loop().create_task(self._resend_result())
            )

    async def _resend_result(self) -> None:
        # a non-transport redelivery failure answers with a one-shot error
        # (completing the client's re-sent call with it) while the STORED
        # result stays the true one — a transient middleware failure is
        # surfaced as that one call's error, never memoized as the result
        await self._deliver_or_error()

    async def _run(self) -> None:
        # Phase 1 — produce the result MESSAGE. A target failure OR a
        # result-serialization failure is the call's result (an error the
        # client must see); ExceptionInfo itself is always wire-safe.
        try:
            result = await self.invoke_target()
            self._build_ok(result)
        except asyncio.CancelledError:
            self.peer.inbound_calls.pop(self.call_id, None)
            raise
        except Exception as e:  # noqa: BLE001
            self._build_error(e)
        # Phase 2 — deliver it. TRANSPORT death is NOT a call error: the
        # stored result_message survives and the post-reconnect redelivery
        # (restart) re-sends it — overwriting it with the transport
        # exception (the pre-soak behavior) served the client a RemoteError
        # for a call that actually succeeded. A NON-transport delivery
        # failure (e.g. a middleware deterministically rejecting the
        # message) falls back to a last-resort error reply so the client
        # errors instead of hanging.
        try:
            await self._deliver_or_error()
        except asyncio.CancelledError:
            self.peer.inbound_calls.pop(self.call_id, None)
            raise
        self.on_completed()

    async def invoke_target(self) -> Any:
        args = loads(self.message.argument_data)
        # the RPC boundary is a dependency-capture boundary: this task may
        # have inherited a computing node's contextvars from whatever task
        # transitively started the peer (single-process client+server), and
        # capturing server nodes into a CLIENT computed would short-circuit
        # the graph across the "wire"
        from ..core.context import ComputeContext, suspend_dependency_capture

        with suspend_dependency_capture(), ComputeContext.DEFAULT.activate():
            return await self.peer.hub.service_registry.invoke(
                self.message.service, self.message.method, args
            )

    def _build_ok(self, result: Any, headers: tuple = ()) -> None:
        """Serialize + store the OK reply (serialization errors propagate —
        they are CALL errors, the link is fine)."""
        self.result_message = RpcMessage(
            call_type_id=self.message.call_type_id,
            call_id=self.call_id,
            service=SYSTEM_SERVICE,
            method="ok",
            argument_data=dumps(result),
            headers=headers,
        )

    def _error_message(self, error: BaseException) -> RpcMessage:
        return RpcMessage(
            call_type_id=self.message.call_type_id,
            call_id=self.call_id,
            service=SYSTEM_SERVICE,
            method="error",
            argument_data=dumps(ExceptionInfo.capture(error)),
        )

    def _build_error(self, error: BaseException) -> None:
        self.result_message = self._error_message(error)

    async def _deliver(self) -> None:
        """Send the stored result; TRANSPORT failures are swallowed — the
        post-reconnect redelivery re-sends. Anything else propagates.

        Classification is by the ``_transport_death`` tag the peer stamps
        on every genuine transport failure AT ITS RAISE SITE (race-free —
        never by peeking at the peer's mutable connection slot, which a
        reconnect can refresh before this except clause runs). An
        OSError-shaped exception WITHOUT the tag is a middleware failure
        in disguise (PermissionError from an auth middleware IS an OSError
        subclass) — swallow it and nothing would ever re-send: the client
        hangs on a healthy connection. Those re-raise for the error-reply
        fallback."""
        try:
            await self.peer.send(self.result_message)
        except asyncio.CancelledError:
            raise
        except (ChannelClosedError, ConnectionError, OSError) as e:
            if not getattr(e, "_transport_death", False):
                raise

    async def _deliver_or_error(self) -> None:
        """Deliver the result; a NON-transport failure is answered with a
        ONE-SHOT error reply so the client errors instead of hanging —
        WITHOUT overwriting the stored result_message, which must stay the
        call's true result for any later redelivery."""
        try:
            await self._deliver()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            try:
                await self.peer.send(self._error_message(e))
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — nothing more we can do
                pass

    async def send_ok(self, result: Any, headers: tuple = ()) -> None:
        self._build_ok(result, headers)
        await self._deliver()

    async def send_error(self, error: BaseException) -> None:
        self._build_error(error)
        await self._deliver()

    def on_completed(self) -> None:
        """Plain calls stay registered for redelivery dedup; the peer prunes
        completed entries with a recently-seen window."""
        self.peer.note_inbound_completed(self.call_id)

    def cancel(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()


class RpcCallTypeRegistry:
    """(call_type_id) → (outbound class, inbound class); slot 0 = plain
    calls (≈ RpcCallTypeRegistry.cs:7-40)."""

    def __init__(self):
        self._types: Dict[int, Tuple[Type[RpcOutboundCall], Type[RpcInboundCall]]] = {
            CALL_TYPE_PLAIN: (RpcOutboundCall, RpcInboundCall)
        }

    def register(self, type_id: int, outbound: Type[RpcOutboundCall], inbound: Type[RpcInboundCall]):
        self._types[type_id] = (outbound, inbound)

    def outbound(self, type_id: int) -> Type[RpcOutboundCall]:
        return self._types[type_id][0]

    def inbound(self, type_id: int) -> Type[RpcInboundCall]:
        return self._types[type_id][1]
