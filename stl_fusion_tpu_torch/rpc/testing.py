"""In-memory RPC transport for protocol tests.

Re-expression of src/Stl.Rpc/Testing/RpcTestClient.cs:7-73 +
RpcTestConnection.cs: client peers connect over twisted in-memory channel
pairs instead of sockets, with scripted ``disconnect()`` / ``reconnect()``
so reliability behavior (re-send, dedup, invalidation-after-reconnect) is
testable without any network. SURVEY.md §4 calls this out as the first
transport to build.
"""
from __future__ import annotations

import asyncio
from typing import Dict, Optional

from ..utils.async_utils import ChannelClosedError, ChannelPair, create_twisted_pair
from .hub import RpcHub
from .peer import RpcClientPeer, RpcServerPeer


class _FlakySendWriter:
    """Writer that dies after N sends WITHOUT closing the pair — the
    half-open-TCP shape: sends fail while the reader hangs silently. Used
    to kill the link mid-re-send-batch."""

    def __init__(self, pair: ChannelPair, fail_after: int):
        self._pair = pair
        self._left = fail_after

    async def send(self, message) -> None:
        if self._left <= 0:
            raise ChannelClosedError("flaky link died mid-send")
        self._left -= 1
        await self._pair.writer.send(message)


class _FlakyPair:
    def __init__(self, pair: ChannelPair, fail_after: int):
        self._pair = pair
        self.reader = pair.reader
        self.writer = _FlakySendWriter(pair, fail_after)

    def close(self, error: Optional[BaseException] = None) -> None:
        self._pair.close(error)


class _CodecChannel:
    """One direction of a codec-faithful link: send serializes the whole
    message (envelope included), receive deserializes."""

    def __init__(self, inner, encode: bool):
        self._inner = inner
        self._encode = encode

    async def send(self, message) -> None:
        from ..utils.serialization import dumps

        await self._inner.send(dumps(message) if self._encode else message)

    async def receive(self):
        from ..utils.serialization import loads

        item = await self._inner.receive()
        return loads(item) if not self._encode else item

    def close(self, error: Optional[BaseException] = None) -> None:
        self._inner.close(error)


class _CodecPair:
    """Codec-faithful endpoint wrapper: every frame pays full envelope
    serialization both ways, like a real socket transport (the raw twisted
    channels pass Python objects, which understates per-frame cost — a
    fan-out benchmark over them would flatter the per-key baseline)."""

    def __init__(self, pair: ChannelPair):
        self._pair = pair
        self.writer = _CodecChannel(pair.writer, encode=True)
        self.reader = _CodecChannel(pair.reader, encode=False)

    def close(self, error: Optional[BaseException] = None) -> None:
        self._pair.close(error)

__all__ = ["RpcTestTransportBase", "RpcTestTransport", "RpcMultiServerTestTransport"]


class RpcTestTransportBase:
    """Channel-pair transport plumbing shared by the single- and
    multi-server variants; subclasses pick the server hub per peer ref."""

    def __init__(self, client_hub: RpcHub, wire_codec: bool = False,
                 client_name: Optional[str] = None):
        self.client_hub = client_hub
        self.connect_count: Dict[str, int] = {}
        self._blocked = False
        self._fail_next_after: Optional[int] = None
        self._chaos = None
        #: True → every frame is dumps()ed on send and loads()ed on receive
        #: (both directions, both ends) — the serialization cost a real
        #: socket transport pays per frame
        self.wire_codec = wire_codec
        #: distinguishes this client hub in the SERVER-side peer ref. The
        #: historic ref shape ``client:{target_ref}`` collides when several
        #: client hubs dial the same server (each .connect() displaces the
        #: previous link) — a cluster mesh (N members + M clients all
        #: dialing each other, cluster/) needs one server peer PER dialer.
        self.client_name = client_name
        client_hub.client_connector = self._connect

    def _server_for(self, peer_ref: str) -> RpcHub:
        raise NotImplementedError

    def server_peer_ref(self, target_ref: str) -> str:
        """The ref the target server hub knows this client hub's link by."""
        if self.client_name is not None:
            return f"client:{self.client_name}@{target_ref}"
        return f"client:{target_ref}"

    async def _connect(self, peer: RpcClientPeer) -> ChannelPair:
        if self._blocked:
            raise ConnectionError("test transport is blocked")
        server_hub = self._server_for(peer.ref)
        client_end, server_end = create_twisted_pair()
        if self.wire_codec:
            client_end = _CodecPair(client_end)
            server_end = _CodecPair(server_end)
        if self._chaos is not None:
            from ..resilience.chaos import wrap_chaos_pair

            client_end = wrap_chaos_pair(client_end, self._chaos)
            server_end = wrap_chaos_pair(server_end, self._chaos)
        server_hub.server_peer(self.server_peer_ref(peer.ref)).connect(server_end)
        self.connect_count[peer.ref] = self.connect_count.get(peer.ref, 0) + 1
        if self._fail_next_after is not None:
            fail_after, self._fail_next_after = self._fail_next_after, None
            return _FlakyPair(client_end, fail_after)
        return client_end

    # -- fault injection ---------------------------------------------------
    async def disconnect(self, peer_ref: str = "default") -> None:
        """Drop the physical link; the client peer will auto-reconnect."""
        peer = self.client_hub.peers.get(peer_ref)
        if peer is not None:
            await peer.disconnect(ConnectionError("test disconnect"))

    def block_reconnects(self, blocked: bool = True) -> None:
        self._blocked = blocked

    def fail_next_connection_after(self, sends: int) -> None:
        """The NEXT connection's writer dies after ``sends`` sends (reader
        keeps hanging) — kills the link mid-re-send-batch."""
        self._fail_next_after = sends

    def set_chaos(self, policy) -> None:
        """Apply a ``resilience.ChaosPolicy`` to every connection made from
        now on (both directions): per-message drop/duplicate/delay/reorder
        on the twisted channels. ``None`` disables for future connections
        (existing links keep their wrappers until they die)."""
        self._chaos = policy

    async def wait_connected(self, peer_ref: str = "default", timeout: float = 5.0) -> None:
        peer = self.client_hub.client_peer(peer_ref)
        await asyncio.wait_for(peer.when_connected(), timeout)


class RpcTestTransport(RpcTestTransportBase):
    """Wires a client hub to a server hub through channel pairs."""

    def __init__(self, client_hub: RpcHub, server_hub: RpcHub, wire_codec: bool = False,
                 client_name: Optional[str] = None):
        super().__init__(client_hub, wire_codec=wire_codec, client_name=client_name)
        self.server_hub = server_hub

    def _server_for(self, peer_ref: str) -> RpcHub:
        return self.server_hub


class RpcMultiServerTestTransport(RpcTestTransportBase):
    """Wires one client hub to MANY server hubs, selected by peer ref —
    the in-memory analogue of the MultiServerRpc sample's server pool
    (samples/MultiServerRpc/Program.cs:58-76): peer ref = pool member."""

    def __init__(self, client_hub: RpcHub, servers: Dict[str, RpcHub], wire_codec: bool = False,
                 client_name: Optional[str] = None):
        super().__init__(client_hub, wire_codec=wire_codec, client_name=client_name)
        self.servers = dict(servers)

    def _server_for(self, peer_ref: str) -> RpcHub:
        server_hub = self.servers.get(peer_ref)
        if server_hub is None:
            raise ConnectionError(f"no server for peer ref {peer_ref!r}")
        return server_hub
