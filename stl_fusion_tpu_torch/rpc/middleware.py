"""Bundled RPC middlewares for the composable peer pipeline.

Re-expression of src/Stl.Rpc/Infrastructure/RpcInboundMiddleware.cs /
RpcOutboundMiddleware.cs (the chains live on ``RpcHub.inbound_middlewares``
/ ``outbound_middlewares``; each middleware is ``async (peer, message,
nxt)``) plus two concrete members of the family:

- :func:`call_logging_middleware` ≈ the call-activity/logging middleware
  (RpcInboundCallActivityMiddleware.cs + ``CallLogLevel``, RpcPeer.cs:26);
- :func:`default_session_replacer_middleware` ≈
  Fusion.Server/Rpc/DefaultSessionReplacerRpcMiddleware.cs — inbound calls
  carrying the default-session placeholder get the CONNECTION's bound
  session substituted before dispatch, so clients never learn or send real
  session ids.

Adding cross-cutting behavior (auth, tracing, rate limits) is appending to
the hub lists — peers are not edited.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

from ..ext.session import Session, SessionResolver, replace_default_sessions
from ..utils.serialization import dumps, loads
from .message import COMPUTE_SYSTEM_SERVICE, SYSTEM_SERVICE, TABLE_SYSTEM_SERVICE, RpcMessage
from .peer import RpcPeer

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "call_logging_middleware",
    "chaos_middleware",
    "default_session_replacer_middleware",
    "bind_peer_session",
    "peer_session",
]


def chaos_middleware(policy, events=None) -> Callable:
    """Fault-injection stage (resilience/chaos.py): drop / duplicate /
    delay sampled per message from a seeded policy — the production-shaped
    chaos injection point (append to ``inbound_middlewares`` /
    ``outbound_middlewares`` like any other stage)."""
    from ..resilience.chaos import chaos_middleware as _impl

    return _impl(policy, events)


def call_logging_middleware(logger=None, level: int = logging.DEBUG) -> Callable:
    """Log every message passing the chain (attach to inbound and/or
    outbound)."""
    logger = logger or log

    async def middleware(peer: RpcPeer, message: RpcMessage, nxt):
        logger.log(
            level,
            "rpc %s: %s.%s #%d (%d bytes)",
            peer.ref,
            message.service,
            message.method,
            message.call_id,
            len(message.argument_data or b""),
        )
        await nxt(message)

    return middleware


def bind_peer_session(peer: RpcPeer, session: Session) -> None:
    """Bind a real session to a (server) peer connection
    (≈ SessionBoundRpcConnectionFactory)."""
    peer.bound_session = session  # type: ignore[attr-defined]


def peer_session(peer: RpcPeer) -> Session:
    """The peer's bound session, issued on first use."""
    session = getattr(peer, "bound_session", None)
    if session is None:
        session = Session.new()
        bind_peer_session(peer, session)
    return session


def default_session_replacer_middleware(
    resolver_for_peer: Optional[Callable[[RpcPeer], SessionResolver]] = None,
) -> Callable:
    """Inbound middleware replacing default-placeholder Session arguments
    with the connection's bound session (issued per peer on first use
    unless ``resolver_for_peer`` supplies one)."""

    async def middleware(peer: RpcPeer, message: RpcMessage, nxt):
        if message.service in (SYSTEM_SERVICE, COMPUTE_SYSTEM_SERVICE, TABLE_SYSTEM_SERVICE):
            return await nxt(message)
        # byte-level pre-check: the placeholder serializes as the literal
        # "~" — most calls carry no Session at all and must not pay a full
        # deserialize here on top of dispatch's own (false positives just
        # fall through to the real check below)
        if b'"~"' not in (message.argument_data or b""):
            return await nxt(message)
        try:
            args = loads(message.argument_data)
        except Exception:  # noqa: BLE001 — not arg-shaped; let dispatch decide
            return await nxt(message)
        if isinstance(args, list) and any(
            isinstance(a, Session) and a.is_default for a in args
        ):
            if resolver_for_peer is not None:
                real = resolver_for_peer(peer).session
            else:
                real = peer_session(peer)
            args = replace_default_sessions(args, real)
            message = RpcMessage(
                message.call_type_id,
                message.call_id,
                message.service,
                message.method,
                dumps(args),
                message.headers,
            )
        await nxt(message)

    return middleware
