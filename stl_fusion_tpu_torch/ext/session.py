"""Session — opaque client identity flowing through calls.

Re-expression of src/Stl.Fusion/Session/ — Session.cs:14-60 (min 8 chars,
``~`` default placeholder, ``@tenantId`` suffix), SessionResolver, and the
server-side default-session replacement middleware
(Fusion.Server/Rpc/DefaultSessionReplacerRpcMiddleware.cs): clients send the
placeholder, the connection substitutes its real bound session.
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional

from ..utils.serialization import register_wire_type

__all__ = ["Session", "SessionResolver", "replace_default_sessions"]

DEFAULT_PLACEHOLDER = "~"
MIN_ID_LENGTH = 8


@dataclass(frozen=True)
class Session:
    id: str

    def __post_init__(self):
        if self.id != DEFAULT_PLACEHOLDER and len(self.id) < MIN_ID_LENGTH:
            raise ValueError(f"session id must be ≥{MIN_ID_LENGTH} chars")

    @property
    def is_default(self) -> bool:
        return self.id == DEFAULT_PLACEHOLDER

    @property
    def tenant_id(self) -> str:
        _, sep, tenant = self.id.partition("@")
        return tenant if sep else ""

    @staticmethod
    def default() -> "Session":
        return Session(DEFAULT_PLACEHOLDER)

    @staticmethod
    def new(tenant_id: str = "") -> "Session":
        sid = secrets.token_urlsafe(15)
        return Session(f"{sid}@{tenant_id}" if tenant_id else sid)

    def __repr__(self) -> str:
        return f"Session({self.id[:8]}…)" if not self.is_default else "Session(~)"


register_wire_type(Session, "Session", lambda s: {"id": s.id}, lambda d: Session(d["id"]))


def replace_default_sessions(args: list, session: Session, session_cls: type = Session) -> list:
    """THE default-session substitution: swap every default-placeholder
    Session in an args list for the caller-bound real one. Shared by the
    HTTP session middleware, the RPC inbound middleware, and resolver-based
    flows so the replacement semantics can never drift apart
    (≈ DefaultSessionReplacerRpcMiddleware.cs)."""
    return [session if isinstance(a, session_cls) and a.is_default else a for a in args]


class SessionResolver:
    """Holds the ambient session for a connection/scope; replaces the
    default placeholder in inbound calls (≈ SessionMiddleware +
    DefaultSessionReplacerRpcMiddleware)."""

    def __init__(self, session: Optional[Session] = None):
        self._session = session

    @property
    def has_session(self) -> bool:
        return self._session is not None

    @property
    def session(self) -> Session:
        if self._session is None:
            self._session = Session.new()
        return self._session

    def resolve(self, incoming: Session) -> Session:
        """Default placeholder → this connection's real session."""
        return self.session if incoming.is_default else incoming
