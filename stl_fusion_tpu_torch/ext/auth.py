"""Auth — session-keyed authentication as a compute service.

Re-expression of src/Stl.Fusion.Ext.Contracts/Authentication/IAuth.cs +
Ext.Services InMemoryAuthService: ``get_user``/``get_session_info`` are
compute methods (so UIs LIVE-update on sign-in/out anywhere in the cluster),
sign-in/sign-out/edit are commands whose replay invalidates exactly the
affected session/user reads.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from ..commands.handlers import command_handler
from ..core.context import is_invalidating
from ..core.hub import FusionHub
from ..core.service import ComputeService, compute_method
from ..utils.serialization import wire_type
from .session import Session

__all__ = [
    "User",
    "SessionInfo",
    "SetupSessionCommand",
    "SignInCommand",
    "SignOutCommand",
    "EditUserCommand",
    "InvalidateUserSessionsCommand",
    "InMemoryAuthService",
    "SqliteAuthService",
]


@wire_type("AuthUser")
@dataclasses.dataclass(frozen=True)
class User:
    id: str
    name: str
    claims: tuple = ()  # ((key, value), ...)

    @property
    def is_authenticated(self) -> bool:
        return bool(self.id)


@wire_type("SessionInfo")
@dataclasses.dataclass(frozen=True)
class SessionInfo:
    session_id: str
    user_id: str = ""
    created_at: float = 0.0
    last_seen_at: float = 0.0
    # where the session lives (≈ SessionInfo.IPAddress/UserAgent): set by
    # SetupSession from the transport, drives ServerAuthHelper's
    # "must re-setup" check when a session moves networks/browsers
    ip_address: str = ""
    user_agent: str = ""
    # forced sign-out is a flag ON the session row, exactly like the
    # reference (DbSessionInfo.IsSignOutForced): the row survives sign-out,
    # sign-in throws while it's set, sign-out no-ops while it's set
    # (DbAuthService.cs:84-92, DbAuthService.Backend.cs:42-43)
    is_sign_out_forced: bool = False

    @property
    def is_authenticated(self) -> bool:
        return bool(self.user_id)


@wire_type("SetupSession")
@dataclasses.dataclass(frozen=True)
class SetupSessionCommand:
    """Create/refresh the session row with transport facts
    (≈ AuthBackend_SetupSession). Empty ip/user_agent mean "keep current"
    — which is how presence updates ride the same command."""

    session: Session
    ip_address: str = ""
    user_agent: str = ""


@wire_type("SignIn")
@dataclasses.dataclass(frozen=True)
class SignInCommand:
    session: Session
    user: User


@wire_type("SignOut")
@dataclasses.dataclass(frozen=True)
class SignOutCommand:
    session: Session
    force: bool = False


@wire_type("EditUser")
@dataclasses.dataclass(frozen=True)
class EditUserCommand:
    session: Session
    name: str


@wire_type("InvalidateUserSessions")
@dataclasses.dataclass(frozen=True)
class InvalidateUserSessionsCommand:
    """Replay-only marker stashed into the enclosing Operation's items when
    a command changes which user a session belongs to: the pre-command
    user_id is captured at execution time (the reference captures the old
    SessionInfo via Operation Items, DbAuthService.cs:54-58) so the
    invalidation replay can reach ``get_user_sessions(old_user_id)`` after
    the session row no longer mentions that user. Execution branch is a
    no-op; it also rides the op log, so other hosts invalidate too."""

    user_id: str


class InMemoryAuthService(ComputeService):
    """IAuth + IAuthBackend in one service. In-memory by default; the
    storage hooks are the override surface for durable backends
    (`SqliteAuthService` ≈ DbAuthService)."""

    def __init__(self, hub: Optional[FusionHub] = None):
        super().__init__(hub)
        self._sessions: Dict[str, SessionInfo] = {}
        self._users: Dict[str, User] = {}
        #: injectable timestamps (≈ MomentClockSet): ServerAuthHelper's
        #: staleness checks and this service's last_seen stamps must share
        #: one clock, or tests with a fake clock diverge from reality
        self.clock = time.time

    # ---------------------------------------------------------- storage hooks
    def _load_session(self, session_id: str) -> Optional[SessionInfo]:
        return self._sessions.get(session_id)

    def _store_session(self, info: SessionInfo) -> None:
        self._sessions[info.session_id] = info

    def _load_user(self, user_id: str) -> Optional[User]:
        return self._users.get(user_id)

    def _store_user(self, user: User) -> None:
        self._users[user.id] = user

    def _session_ids_of(self, user_id: str) -> tuple:
        return tuple(
            sorted(sid for sid, i in self._sessions.items() if user_id and i.user_id == user_id)
        )

    # ------------------------------------------------------------------ reads (IAuth)
    @compute_method
    async def get_session_info(self, session: Session) -> Optional[SessionInfo]:
        return self._load_session(session.id)

    @compute_method
    async def get_user(self, session: Session) -> Optional[User]:
        info = await self.get_session_info(session)
        if info is None or not info.user_id:
            return None
        return self._load_user(info.user_id)

    @compute_method
    async def is_sign_out_forced(self, session: Session) -> bool:
        info = self._load_session(session.id)
        return info is not None and info.is_sign_out_forced

    @compute_method
    async def get_user_sessions(self, user_id: str) -> tuple:
        return self._session_ids_of(user_id)

    # ------------------------------------------------------------------ commands
    @command_handler
    async def setup_session(self, command: SetupSessionCommand):
        """Create or refresh the session row with transport facts
        (≈ AuthBackend_SetupSession in DbAuthService.Backend.cs): user
        binding and the forced flag are preserved; empty ip/agent keep the
        stored values (the presence-update shape)."""
        if is_invalidating():
            await self._invalidate_session(command.session)
            return
        now = self.clock()
        existing = self._load_session(command.session.id)
        base = existing if existing is not None else SessionInfo(
            command.session.id, created_at=now
        )
        self._store_session(
            dataclasses.replace(
                base,
                last_seen_at=now,
                ip_address=command.ip_address or base.ip_address,
                user_agent=command.user_agent or base.user_agent,
            )
        )

    @command_handler
    async def sign_in(self, command: SignInCommand):
        if is_invalidating():
            await self._invalidate_session(command.session)
            await self.get_user_sessions(command.user.id)
            return
        now = self.clock()
        existing = self._load_session(command.session.id)
        if existing is not None and existing.is_sign_out_forced:
            # a force-signed-out session is permanently unavailable
            # (DbAuthService.Backend.cs:42-43, Errors.SessionUnavailable)
            raise PermissionError("session is unavailable (forced sign-out)")
        if existing is not None and existing.user_id and existing.user_id != command.user.id:
            # the session is being reassigned: the OLD user's session list
            # changes too — capture their id for the replay
            self._capture_user_sessions_invalidation(existing.user_id)
        self._store_user(command.user)
        base = existing if existing is not None else SessionInfo(
            command.session.id, created_at=now
        )
        self._store_session(
            dataclasses.replace(base, user_id=command.user.id, last_seen_at=now)
        )

    @command_handler
    async def sign_out(self, command: SignOutCommand):
        if is_invalidating():
            await self._invalidate_session(command.session)
            return
        info = self._load_session(command.session.id)
        if info is not None and info.is_sign_out_forced:
            return  # already forced out — no-op (DbAuthService.cs:84-85)
        if info is not None and info.user_id:
            # the replay can't recover the old user_id from the (by then
            # rewritten) session row — capture it now, like the reference's
            # SignOut invalidating GetUserSessions via the operation-captured
            # SessionInfo (DbAuthService.cs:54-58)
            self._capture_user_sessions_invalidation(info.user_id)
        now = self.clock()
        base = info if info is not None else SessionInfo(command.session.id, created_at=now)
        self._store_session(
            dataclasses.replace(
                base, user_id="", last_seen_at=now, is_sign_out_forced=command.force
            )
        )

    @command_handler
    async def edit_user(self, command: EditUserCommand):
        if is_invalidating():
            await self._invalidate_session(command.session)
            return
        info = self._load_session(command.session.id)
        if info is None or not info.user_id:
            raise PermissionError("not signed in")
        user = self._load_user(info.user_id)
        self._store_user(dataclasses.replace(user, name=command.name))

    @command_handler
    async def _invalidate_user_sessions(self, command: InvalidateUserSessionsCommand):
        if is_invalidating():
            await self.get_user_sessions(command.user_id)
        # execution branch: nothing to do — the marker only exists to be
        # replayed (it enters the pipeline via Operation.items, not call())

    def _capture_user_sessions_invalidation(self, user_id: str) -> None:
        from ..operations.pipeline import current_operation

        op = current_operation()
        if op is not None:
            op.items.append(InvalidateUserSessionsCommand(user_id))

    async def _invalidate_session(self, session: Session) -> None:
        await self.get_session_info(session)
        await self.get_user(session)
        await self.is_sign_out_forced(session)


class SqliteAuthService(InMemoryAuthService):
    """Durable auth over stdlib sqlite (≈ DbAuthService,
    Ext.Services/Authentication/Services/DbAuthService.cs — store-agnostic
    because no external DB exists in-image). Sessions and users survive
    restarts; the compute/command surface and invalidation semantics are
    inherited unchanged — only the storage hooks differ."""

    def __init__(self, path: str, hub: Optional[FusionHub] = None):
        import json
        import sqlite3

        super().__init__(hub)
        self._json = json
        self._db = sqlite3.connect(path)
        self._db.executescript(
            "CREATE TABLE IF NOT EXISTS auth_users ("
            " id TEXT PRIMARY KEY, name TEXT, claims TEXT);"
            "CREATE TABLE IF NOT EXISTS auth_sessions ("
            " session_id TEXT PRIMARY KEY, user_id TEXT,"
            " created_at REAL, last_seen_at REAL, is_sign_out_forced INTEGER,"
            " ip_address TEXT DEFAULT '', user_agent TEXT DEFAULT '');"
        )
        # migrate pre-r2 databases lacking the transport columns
        cols = {r[1] for r in self._db.execute("PRAGMA table_info(auth_sessions)")}
        for col in ("ip_address", "user_agent"):
            if col not in cols:
                self._db.execute(
                    f"ALTER TABLE auth_sessions ADD COLUMN {col} TEXT DEFAULT ''"
                )
        self._db.commit()

    def _load_session(self, session_id: str) -> Optional[SessionInfo]:
        row = self._db.execute(
            "SELECT session_id, user_id, created_at, last_seen_at, is_sign_out_forced,"
            " ip_address, user_agent"
            " FROM auth_sessions WHERE session_id=?",
            (session_id,),
        ).fetchone()
        if row is None:
            return None
        return SessionInfo(
            row[0], row[1], row[2], row[3],
            is_sign_out_forced=bool(row[4]), ip_address=row[5], user_agent=row[6],
        )

    def _store_session(self, info: SessionInfo) -> None:
        # full-row upsert in ONE statement: the session row (incl. the
        # forced flag) can never be torn by a crash between writes
        self._db.execute(
            "INSERT OR REPLACE INTO auth_sessions VALUES (?,?,?,?,?,?,?)",
            (
                info.session_id,
                info.user_id,
                info.created_at,
                info.last_seen_at,
                int(info.is_sign_out_forced),
                info.ip_address,
                info.user_agent,
            ),
        )
        self._db.commit()

    def _load_user(self, user_id: str) -> Optional[User]:
        row = self._db.execute(
            "SELECT id, name, claims FROM auth_users WHERE id=?", (user_id,)
        ).fetchone()
        if row is None:
            return None
        claims = tuple(tuple(c) for c in self._json.loads(row[2] or "[]"))
        return User(row[0], row[1], claims)

    def _store_user(self, user: User) -> None:
        self._db.execute(
            "INSERT INTO auth_users VALUES (?,?,?) ON CONFLICT(id) DO UPDATE SET"
            " name=excluded.name, claims=excluded.claims",
            (user.id, user.name, self._json.dumps([list(c) for c in user.claims])),
        )
        self._db.commit()

    def _session_ids_of(self, user_id: str) -> tuple:
        if not user_id:
            return ()
        rows = self._db.execute(
            "SELECT session_id FROM auth_sessions WHERE user_id=? ORDER BY session_id",
            (user_id,),
        ).fetchall()
        return tuple(r[0] for r in rows)

    def close(self) -> None:
        self._db.close()
