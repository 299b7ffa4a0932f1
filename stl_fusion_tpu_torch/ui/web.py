"""LiveViewServer — LiveComponent renders pushed to real browsers.

The browser-facing end of the UI layer: where the
reference mounts ComputedStateComponent in a Blazor circuit and lets
SignalR ship render-tree patches (samples/TodoApp/UI,
src/Stl.Fusion.Blazor/Components/ComputedStateComponent.cs:27-132), here a
plain browser opens a websocket and receives each component render as a
JSON payload ``{"html": ...}`` (or whatever the component's ``render``
pushes). The reactive machinery is identical — a ComputedState recomputes
on invalidation and drives ``render()`` — only the transport differs:
JSON-over-websocket instead of a Blazor circuit, because there is no .NET
runtime in the browser to host one.

One component instance exists PER CONNECTION (the Blazor circuit scoping
rule): the factory receives a ``push(payload)`` callable bound to that
socket and returns an UNMOUNTED LiveComponent; the server mounts it on
connect and unmounts it on disconnect, so a closed tab stops consuming
invalidations.
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Callable, Optional

from ..edge.session import LatestWinsMailbox, pump_payloads
from ..utils.async_utils import TaskSet
from .live_component import LiveComponent

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["LiveViewServer", "HtmlComponent"]


class HtmlComponent(LiveComponent):
    """LiveComponent whose renders push ``{"html": ...}`` to one browser
    socket. Subclasses implement ``compute_state()`` (the reactive read)
    and ``to_html(value)``."""

    def __init__(self, push: Callable[[Any], None], **kwargs):
        super().__init__(**kwargs)
        self.push = push

    def to_html(self, value: Any) -> str:
        raise NotImplementedError

    def render(self, value: Any) -> None:
        self.push({"html": self.to_html(value)})

    def render_error(self, error: BaseException) -> None:
        self.push({"error": f"{type(error).__name__}: {error}"})


#: the per-connection latest-wins mailbox now lives in the shared edge
#: session core (the UI layer rides the same bounded-
#: outbox machinery as the edge gateway's SSE/WebSocket sessions); the
#: historic name stays importable — behavior is byte-identical
_RenderSlot = LatestWinsMailbox


class LiveViewServer:
    """Hosts per-connection LiveComponents over plain-JSON websockets.

    Delivery rides the shared edge session core (edge/session.py):
    latest-wins per connection (see :class:`LatestWinsMailbox`);
    ``min_send_interval`` optionally rate-limits pushes (the newest payload
    at the end of the interval is what ships); ``heartbeat_interval``
    keeps idle connections alive with ``{"ping": t}`` frames (off by
    default — historic wire behavior); and a send that can't make
    progress for ``send_timeout`` seconds — a browser that stopped reading
    while the transport buffer is full — EVICTS the connection, unmounting
    its component so it stops consuming invalidations."""

    def __init__(
        self,
        component_factory: Callable[[Callable[[Any], None]], LiveComponent],
        host: str = "127.0.0.1",
        port: int = 0,
        min_send_interval: float = 0.0,
        send_timeout: Optional[float] = 30.0,
        heartbeat_interval: Optional[float] = None,
    ):
        self.component_factory = component_factory
        self.host = host
        self.port = port
        self.min_send_interval = min_send_interval
        self.send_timeout = send_timeout
        self.heartbeat_interval = heartbeat_interval
        self.connections = 0
        self.evictions = 0  # observability: slow clients closed mid-send
        self._server = None
        #: eviction-close side tasks, owned so stop() cancels a close still
        #: in flight instead of leaking it (fusionlint FL003)
        self._side_tasks = TaskSet(name="live-view-side")

    async def start(self) -> "LiveViewServer":
        from websockets.asyncio.server import serve

        self._server = await serve(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def url(self) -> str:
        return f"ws://{self.host}:{self.port}/live"

    async def _handle(self, ws) -> None:
        # renders may fire from any task; the slot decouples them from the
        # socket writer so a slow browser never blocks the compute loop —
        # and, latest-wins, never accumulates stale intermediate renders
        slot = _RenderSlot()
        component = self.component_factory(slot.push)
        component.mount()
        self.connections += 1
        loop = asyncio.get_running_loop()

        async def send(payload) -> None:
            await ws.send(json.dumps(payload))

        async def heartbeat() -> None:
            await ws.send(json.dumps({"ping": loop.time()}))

        def on_evict() -> None:
            # the browser stopped draining: evict it rather than letting a
            # dead tab pin the component forever. Abort — a graceful close
            # would wait close_timeout for a close handshake the dead peer
            # will never answer, through the very buffer that is already
            # full
            self.evictions += 1
            transport = getattr(ws, "transport", None)
            if transport is not None:
                transport.abort()
            else:
                try:
                    self._side_tasks.spawn(ws.close())
                except RuntimeError:  # server stopped: socket dies with it
                    pass

        pump_task = asyncio.ensure_future(
            pump_payloads(
                slot,
                send,
                min_send_interval=self.min_send_interval,
                send_timeout=self.send_timeout,
                heartbeat_interval=self.heartbeat_interval,
                heartbeat=heartbeat,
                on_evict=on_evict,
            )
        )
        try:
            # hold until the browser goes away; inbound messages reach the
            # component's optional on_message (local-input hook, ≈ the
            # MixedStateComponent input path)
            async for raw in ws:
                handler = getattr(component, "on_message", None)
                if handler is not None:
                    await handler(raw)
        except Exception:  # noqa: BLE001 — a dying socket is a normal exit
            pass
        finally:
            self.connections -= 1
            pump_task.cancel()
            await component.unmount()

    async def stop(self) -> None:
        await self._side_tasks.aclose()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
