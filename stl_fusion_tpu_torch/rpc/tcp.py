"""Plain-TCP RPC transport — the stdlib DCN leg.

The websocket transport (rpc/websocket.py) needs the optional
``websockets`` dependency; the multi-host mesh's cross-process relay must
not. This module hosts an :class:`~.hub.RpcHub` over raw asyncio TCP
streams with the same wire contract: length-prefixed wire-serialized
:class:`~.message.RpcMessage` frames, a stable ``clientId`` handshake so a
re-dialed connection lands on the SAME server peer (reconnect dedup /
re-send work across physical connections), and reader/writer adapters
matching the peer's channel protocol.

This is what makes ``fusion_mesh_dcn_fallback_total`` an EXERCISED path:
a frontier fence for a key owned by an off-mesh member rides this socket
between real OS processes (perf/mesh_multihost.py drives it; the tier1
multihost smoke gates on the frames actually arriving).

Framing: ``<I`` length prefix per message, handshake = one line
``clientId\\n`` sent by the client before the first frame. The server
peer's ref is ``<prefix><clientId>`` — mesh workers pass ``ref_prefix=""``
so a member process's peer ref IS its member name (the fan-out index's
DCN classification keys on it).
"""
from __future__ import annotations

import asyncio
import logging
import random
import secrets
import struct
from typing import Optional

from ..utils.serialization import dumps, loads
from .hub import RpcHub
from .message import RpcMessage
from .peer import RpcClientPeer

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["RpcTcpServer", "tcp_client_connector"]

_MAX_FRAME = 64 * 1024 * 1024
_MAX_HELLO = 256
#: dial retry ladder: bounded, jittered — a refused dial during
#: a mesh re-form window is expected weather, not an instant failure, but
#: it must stay COUNTED (``tcp_dial_retry``) and bounded (the breaker owns
#: long-horizon gating; this ladder only rides out sub-second races)
_DIAL_ATTEMPTS = 4
_DIAL_BACKOFF_BASE_S = 0.05
_DIAL_BACKOFF_CAP_S = 0.5


def _record_event(kind: str, detail: str) -> None:
    """Journal a transport event into the resilience ledger (deferred
    import — rpc must stay importable without the resilience package
    initialized, the middleware.py convention)."""
    from ..resilience.events import global_events

    global_events().record(kind, detail)


class _TcpAdapter:
    """Adapts one asyncio TCP stream to the peer's reader/writer protocol.

    Sends are serialized under a lock (a partially-written length-prefixed
    frame interleaved with a sibling's would desync the whole stream) and each ``send()`` resolves or raises with
    its own transport outcome, so the peer's re-send / failure
    disambiguation is unchanged."""

    class _Reader:
        def __init__(self, reader: asyncio.StreamReader):
            self._reader = reader

        async def receive(self) -> RpcMessage:
            try:
                head = await self._reader.readexactly(4)
                (length,) = struct.unpack("<I", head)
                if length > _MAX_FRAME:
                    raise ValueError(f"frame of {length}B exceeds cap")
                return loads(await self._reader.readexactly(length))
            except ConnectionError as e:
                _record_event("tcp_link_death", f"recv: {e}")
                raise
            except asyncio.IncompleteReadError as e:
                # EOF mid-frame: the link died under us — counted, then
                # surfaced as ConnectionError so the peer's run loop tears
                # the connection down and reconnects
                _record_event("tcp_link_death", "recv: eof mid-frame")
                raise ConnectionError(str(e)) from e
            except Exception as e:  # noqa: BLE001 — closed/aborted/corrupt
                # a malformed or truncated frame is a TRANSPORT failure:
                # surface it as ConnectionError so the peer's run loop
                # tears the connection down and reconnects
                _record_event("tcp_link_death", f"recv: {type(e).__name__}")
                raise ConnectionError(str(e)) from e

    class _Writer:
        def __init__(self, writer: asyncio.StreamWriter):
            self._writer = writer
            self._lock = asyncio.Lock()

        async def send(self, message: RpcMessage) -> None:
            data = dumps(message)
            async with self._lock:
                try:
                    self._writer.write(struct.pack("<I", len(data)) + data)
                    await self._writer.drain()
                except Exception as e:  # noqa: BLE001 — link died mid-send
                    _record_event("tcp_link_death", f"send: {type(e).__name__}")
                    raise ConnectionError(str(e)) from e

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = _TcpAdapter._Reader(reader)
        self.writer = _TcpAdapter._Writer(writer)
        self._stream_writer = writer
        self.close_races = 0

    def close(self, error: Optional[BaseException] = None) -> None:
        try:
            self._stream_writer.close()
        except Exception:  # noqa: BLE001 — already closed / loop gone; the
            # peer state machine has recorded the connection outcome
            self.close_races += 1


class RpcTcpServer:
    """Hosts an RpcHub over plain TCP (the stdlib counterpart of
    :class:`~.websocket.RpcWebSocketServer`)."""

    def __init__(
        self,
        hub: RpcHub,
        host: str = "127.0.0.1",
        port: int = 0,
        ref_prefix: str = "tcp:",
    ):
        self.hub = hub
        self.host = host
        self.port = port
        self.ref_prefix = ref_prefix
        self._server: Optional[asyncio.base_events.Server] = None
        #: dials that died before a valid hello (probes, port scans) and
        #: handler teardown races — operator stats, never silent exits
        self.hello_failures = 0
        self.handler_races = 0
        #: the open connections' writers, closed by :meth:`stop`
        self._writers: set = set()

    async def start(self) -> "RpcTcpServer":
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.debug("rpc tcp server on %s:%d", self.host, self.port)
        return self

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            hello = await asyncio.wait_for(
                reader.readline(), timeout=10.0
            )
        except Exception:  # noqa: BLE001 — probe/dead dial before hello: a
            # normal exit, not an RPC failure (a health probe
            # is not a call), but still visible in the server stats
            self.hello_failures += 1
            writer.close()
            return
        client_id = hello.decode("utf-8", "replace").strip()
        if not client_id or len(client_id) > _MAX_HELLO:
            self.hello_failures += 1
            writer.close()
            return
        peer = self.hub.server_peer(f"{self.ref_prefix}{client_id}")
        adapter = _TcpAdapter(reader, writer)
        peer.connect(adapter)
        # hold the handler open until the socket dies (start_server cancels
        # handlers at close; the peer's run loop owns frame processing)
        self._writers.add(writer)
        try:
            await writer.wait_closed()
        except Exception:  # noqa: BLE001 — peer torn down first; the
            # connection state machine already recorded the outcome
            self.handler_races += 1
        finally:
            self._writers.discard(writer)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Server.wait_closed() waits for every open connection (Python
            # 3.12.1 on), and a handler waits for its socket: close them
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None


def tcp_client_connector(host: str, port: int, client_id: Optional[str] = None):
    """Client connector factory:
    ``hub.client_connector = tcp_client_connector(host, port)``.

    The generated clientId is stable per connector, so reconnects resume
    the same server peer (reconnect dedup). Pass an explicit ``client_id``
    (e.g. the member name) to pin the server-side peer ref — the mesh
    workers do, so the fan-out DCN classification sees the member.

    Dial failures retry on a bounded jittered backoff ladder
    (``_DIAL_ATTEMPTS`` tries, each counted as ``tcp_dial_retry`` in the
    resilience ledger) — a refused connection during a mesh re-form window
    rides out the race instead of failing the peer, but the ladder is
    BOUNDED: past it, the failure surfaces and the circuit breaker owns
    the long-horizon gating. Nothing is swallowed silently."""
    cid = client_id or f"c-{secrets.token_hex(8)}"

    async def connect(peer: RpcClientPeer) -> _TcpAdapter:
        last: Optional[BaseException] = None
        for attempt in range(_DIAL_ATTEMPTS):
            if attempt:
                delay = min(
                    _DIAL_BACKOFF_BASE_S * (2 ** (attempt - 1)),
                    _DIAL_BACKOFF_CAP_S,
                ) * (0.5 + random.random())
                _record_event(
                    "tcp_dial_retry",
                    f"{host}:{port} attempt={attempt + 1} "
                    f"after {type(last).__name__}",
                )
                await asyncio.sleep(delay)
            try:
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(cid.encode() + b"\n")
                await writer.drain()
                return _TcpAdapter(reader, writer)
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                last = e
        raise ConnectionError(
            f"dial {host}:{port} failed after {_DIAL_ATTEMPTS} attempts: {last}"
        ) from last

    return connect
