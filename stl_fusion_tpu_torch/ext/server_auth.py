"""ServerAuthHelper — transport auth state ⇄ fusion auth sync.

Re-expression of src/Stl.Fusion.Server/Authentication/ServerAuthHelper.cs:9-213:
per request, compare the TRANSPORT's authentication principal (in ASP.NET,
``HttpContext.User`` filled by the cookie/OAuth middleware; here, a
principal extracted from trusted reverse-proxy headers — the
``X-Auth-Request-*`` pattern — or injected by tests) against the fusion
session's user, and reconcile by issuing the SAME commands a user-driven
flow would:

- session row missing / moved networks / presence stale → ``SetupSession``
  (ServerAuthHelper.cs:87-95);
- transport authenticated but fusion user differs → ``SignIn`` with a user
  built from the principal's claims (:98-104, CreateOrUpdateUser :180-204);
- transport anonymous but fusion user present (and not ``keep_signed_in``)
  → ``SignOut`` (:105-107);
- always: presence update, after the important work (:109-112).

Because reconciliation is commands-through-the-commander, every sync rides
the full operations pipeline: invalidations replay, the op log records it,
other hosts see it — a cookie-authenticated page load updates live UIs
everywhere, which is the whole point of the reference class.
"""
from __future__ import annotations

import time
from typing import Awaitable, Callable, Dict, Optional, Tuple

from .auth import SetupSessionCommand, SignInCommand, SignOutCommand, User
from .session import Session

__all__ = ["Principal", "ServerAuthHelper", "principal_from_headers"]


class Principal:
    """The transport's view of 'who is making this request'
    (≈ ClaimsPrincipal reduced to what the sync needs)."""

    __slots__ = ("schema", "id", "name", "claims")

    def __init__(self, schema: str, id: str, name: str = "", claims: Tuple = ()):
        self.schema = schema
        self.id = id
        self.name = name or id
        self.claims = tuple(claims)


#: Trusted reverse-proxy headers (the oauth2-proxy convention) — the
#: in-image stand-in for ASP.NET's authentication middleware output. ONLY
#: meaningful behind a proxy that strips client-supplied copies.
HEADER_ID = "x-auth-request-user"
HEADER_NAME = "x-auth-request-preferred-username"
HEADER_SCHEMA = "x-auth-request-schema"


def principal_from_headers(headers: Dict[str, str]) -> Optional[Principal]:
    uid = headers.get(HEADER_ID, "")
    if not uid:
        return None
    return Principal(
        schema=headers.get(HEADER_SCHEMA, "proxy"),
        id=uid,
        name=headers.get(HEADER_NAME, uid),
    )


class ServerAuthHelper:
    def __init__(
        self,
        auth,
        commander,
        session_info_update_period: float = 30.0,
        keep_signed_in: bool = False,
        clock: Callable[[], float] = time.time,
    ):
        self.auth = auth
        self.commander = commander
        self.session_info_update_period = session_info_update_period
        self.keep_signed_in = keep_signed_in
        self.clock = clock

    async def update_auth_state(
        self,
        session: Session,
        principal: Optional[Principal],
        ip_address: str = "",
        user_agent: str = "",
        principal_authoritative: bool = True,
    ) -> None:
        """The reconciliation decision tree (ServerAuthHelper.cs:73-113)."""
        info = await self.auth.get_session_info(session)
        # empty incoming ip/user_agent means "transport didn't report one",
        # mirroring SetupSessionCommand's empty-means-keep write semantics —
        # comparing it against a stored non-empty value would flag must_setup
        # on EVERY request while the keep-semantics write never converges
        # (ADVICE r2), flooding the shared op log
        must_setup = (
            info is None
            or (bool(ip_address) and info.ip_address != ip_address)
            or (bool(user_agent) and info.user_agent != user_agent)
            or info.last_seen_at + self.session_info_update_period < self.clock()
        )
        if must_setup:
            await self.commander.call(
                SetupSessionCommand(session, ip_address, user_agent)
            )
        if not principal_authoritative:
            # the transport could not vouch for who is calling (untrusted
            # peer): neither sign in NOR sign out — an unauthenticated
            # direct request must not revoke a signed-in session. Session
            # setup/presence above still ran; they carry no identity.
            await self._update_presence(session)
            return
        user = await self.auth.get_user(session)
        try:
            if principal is not None:
                if await self.auth.is_sign_out_forced(session):
                    # a force-closed session stays signed out no matter what
                    # the transport says — attempting SignIn would raise
                    # PermissionError on EVERY request (the service rejects
                    # forced sessions) and 500 the whole API
                    pass
                elif not self._is_same_user(user, principal):
                    await self.commander.call(
                        SignInCommand(session, self._create_or_update_user(user, principal))
                    )
            elif user is not None and not self.keep_signed_in:
                await self.commander.call(SignOutCommand(session))
        finally:
            # presence last, once the important things are done (:109-112)
            await self._update_presence(session)

    # -- protected surface (the reference's virtual methods) ---------------
    def _is_same_user(self, user: Optional[User], principal: Principal) -> bool:
        if user is None:
            return False
        identity = ("identity", f"{principal.schema}/{principal.id}")
        return identity in user.claims

    def _create_or_update_user(self, user: Optional[User], principal: Principal) -> User:
        """≈ CreateOrUpdateUser (:180-204): build a fusion User from the
        principal; an existing user keeps its id and extra claims, only the
        authenticated identity is (re)stamped."""
        identity = ("identity", f"{principal.schema}/{principal.id}")
        if user is None:
            return User(principal.id, principal.name, (identity,) + principal.claims)
        claims = tuple(c for c in user.claims if c[0] != "identity") + (identity,)
        return User(user.id, user.name, claims)

    async def _update_presence(self, session: Session) -> None:
        """Bump last_seen_at — throttled, because presence here is a
        command that rides the op log (the reference's UpdatePresence
        no-ops internally when fresh; unthrottled per-request presence
        would flood the shared log)."""
        info = await self.auth.get_session_info(session)
        if (
            info is not None
            and info.last_seen_at + self.session_info_update_period / 4 >= self.clock()
        ):
            return
        # empty ip/agent = "keep stored values": only last_seen_at moves
        await self.commander.call(SetupSessionCommand(session))
