"""RpcPeerStateMonitor — connection state as a reactive state.

Re-expression of src/Stl.Fusion/Extensions/RpcPeerStateMonitor.cs:6-70:
exposes a peer's connection state (+ reconnects-at) as a MutableState so
UIs can render "reconnecting in 3s…" banners that live-update.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional

from ..core.hub import FusionHub
from ..rpc.peer import RpcClientPeer
from ..state.mutable import MutableState
from ..utils.async_chain import WorkerBase

__all__ = ["RpcPeerState", "RpcPeerStateMonitor"]


@dataclass(frozen=True)
class RpcPeerState:
    is_connected: bool
    error: Optional[str] = None
    reconnects_at: Optional[float] = None
    #: the peer gave up (unrecoverable connect error): no reconnect is
    #: coming, so UIs should render a hard failure, not a retry banner
    is_terminated: bool = False
    #: circuit-breaker state ("closed"/"open"/"half-open") when a
    #: resilience.PeerCircuitBreaker is installed on the peer, else None —
    #: "open" means the peer is QUARANTINED (dials parked), which UIs should
    #: render differently from an ordinary reconnect countdown
    breaker: Optional[str] = None


class RpcPeerStateMonitor(WorkerBase):
    def __init__(self, peer: RpcClientPeer, hub: Optional[FusionHub] = None):
        super().__init__(f"peer-monitor:{peer.ref}")
        self.peer = peer
        self.state: MutableState = MutableState(
            RpcPeerState(is_connected=False), hub, name=f"peer-state:{peer.ref}"
        )

    async def on_run(self) -> None:
        ev = self.peer.connection_state
        while True:
            s = ev.value
            breaker = getattr(self.peer, "breaker", None)
            self.state.set(
                RpcPeerState(
                    is_connected=s.is_connected,
                    error=str(s.error) if s.error else None,
                    # a terminated peer never retries: suppress any stale
                    # retry timestamp so UIs don't render a reconnect banner
                    reconnects_at=(
                        None if s.is_terminated else getattr(self.peer, "reconnects_at", None)
                    ),
                    is_terminated=s.is_terminated,
                    breaker=breaker.state if breaker is not None else None,
                )
            )
            if breaker is None:
                ev = await ev.when_next()
                continue
            # a breaker transitions WITHOUT a connection event too (open →
            # half-open in the dial gate, half-open → closed on probe-stable
            # timeout) — wake on whichever chain moves first so a recovered
            # peer is never rendered as quarantined until its next disconnect
            conn_next = asyncio.ensure_future(ev.when_next())
            brk_next = asyncio.ensure_future(breaker.changes.latest().when_next())
            try:
                done, _pending = await asyncio.wait(
                    {conn_next, brk_next}, return_when=asyncio.FIRST_COMPLETED
                )
            finally:
                # asyncio.wait never cancels its children — without this, a
                # monitor stopped while parked here leaks both waiter tasks
                # ("Task was destroyed but it is pending!" at loop close)
                for p in (conn_next, brk_next):
                    if not p.done():
                        p.cancel()
            if conn_next in done:
                ev = conn_next.result()
