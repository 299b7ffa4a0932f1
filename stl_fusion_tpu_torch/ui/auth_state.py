"""AuthStateProvider — live authentication state for UI surfaces.

Re-expression of src/Stl.Fusion.Blazor.Authentication/AuthStateProvider.cs
(+ AuthState.cs): a ComputedState over ``(auth.get_user(session),
auth.is_sign_out_forced(session))`` whose updates notify the UI — so a
sign-in/out ANYWHERE (this process, another host via the op log, a cookie
page-load reconciled by ServerAuthHelper) re-renders every component that
watches it. Where the reference plugs into Blazor's
``AuthenticationStateProvider`` cascade, here components either await
``use()`` inside their own ``compute_state`` (the dependency edge makes
them recompute on auth changes — the CascadingAuthState analogue) or
subscribe to ``changed_handlers``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from ..core.hub import FusionHub
from ..state.computed_state import ComputedState

__all__ = ["AuthState", "AuthStateProvider"]


@dataclasses.dataclass(frozen=True)
class AuthState:
    """≈ AuthState.cs: the user (None = anonymous) + whether the session
    was force-closed (drives the 'you were signed out' UX)."""

    user: Optional[object] = None
    is_sign_out_forced: bool = False

    @property
    def is_authenticated(self) -> bool:
        return self.user is not None


class AuthStateProvider:
    def __init__(self, auth, session, hub: Optional[FusionHub] = None):
        self.auth = auth
        self.session = session
        self.changed_handlers: List[Callable[[AuthState], None]] = []
        self.state: ComputedState = ComputedState(
            self._compute, hub, name=f"auth-state:{session.id[:8]}"
        )
        self.state.updated_handlers.append(self._on_updated)
        self.state.start()

    async def _compute(self) -> AuthState:
        user = await self.auth.get_user(self.session)
        forced = await self.auth.is_sign_out_forced(self.session)
        return AuthState(user, forced)

    def _on_updated(self, state) -> None:
        out = state.snapshot.computed._output
        if out is None or out.has_error:
            return
        for handler in self.changed_handlers:
            handler(out.value)

    async def use(self) -> AuthState:
        """Read the auth state INSIDE a compute (a LiveComponent's
        ``compute_state``): the ambient node gains a dependency edge and
        recomputes whenever the auth state changes — the
        CascadingAuthState pattern."""
        return await self.state.use()

    async def get(self) -> AuthState:
        await self.state.update()
        return self.state.value

    async def dispose(self) -> None:
        await self.state.dispose()
