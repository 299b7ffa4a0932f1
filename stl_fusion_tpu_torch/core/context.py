"""ComputeContext / CallOptions — ambient call modes + dependency capture.

Re-expression of src/Stl.Fusion/ComputeContext.cs:6-91, CallOptions.cs and
the ``Computed`` statics (Computed.Static.cs:13-191). The reference flows
these through AsyncLocal; here they ride contextvars, which propagate across
``await`` exactly like AsyncLocal flows across continuations.

Two ambient slots:
- the **current context** — flags saying how compute-method calls behave
  (normal / peek-existing / invalidate / capture);
- the **current computed** — the node being computed right now, i.e. the
  root every nested compute-method call attaches a dependency edge to.

The ``invalidating()`` scope is the reference's ``using Computed.Invalidate()``
idiom: inside it, calling a compute method invalidates its cached node
instead of computing (the command-replay mechanism of the operations
framework rides on this).
"""
from __future__ import annotations

import contextlib
import contextvars
import enum
from typing import TYPE_CHECKING, Any, Awaitable, Callable, Optional, TypeVar

if TYPE_CHECKING:
    from .computed import Computed

T = TypeVar("T")

__all__ = [
    "CallOptions",
    "ComputeContext",
    "get_current",
    "change_current",
    "is_invalidating",
    "invalidating",
    "suspend_dependency_capture",
    "capture",
    "try_capture",
    "get_existing",
]


class CallOptions(enum.IntFlag):
    NONE = 0
    GET_EXISTING = 1
    INVALIDATE = 3  # implies GET_EXISTING (same bit layout as CallOptions.cs)
    CAPTURE = 4


# plain-int mirrors of the flag bits for the hot path — IntFlag's operator
# dispatch costs ~1 µs per `&`, which dominates the memoized-hit read
OPT_GET_EXISTING = 1
OPT_INVALIDATE_BIT = 2  # the bit that distinguishes INVALIDATE from GET_EXISTING
OPT_CAPTURE = 4


class ComputeContext:
    """Flags + a capture slot. Flyweight DEFAULT for the common case.

    ``call_options`` is stored as a plain ``int`` (not the IntFlag) so flag
    tests on the hot read path are single int ops.
    """

    __slots__ = ("call_options", "_captured", "invalidation_sink")

    DEFAULT: "ComputeContext"

    def __init__(self, call_options: CallOptions = CallOptions.NONE, invalidation_sink=None):
        self.call_options = int(call_options)
        #: when set (batch replay), INVALIDATE-mode hits are COLLECTED here
        #: instead of cascading host-side immediately — the caller applies
        #: them as one device lane burst (oplog/reader.py)
        self.invalidation_sink = invalidation_sink
        self._captured: Optional["Computed"] = None

    # -- capture ----------------------------------------------------------
    def try_capture(self, computed: "Computed") -> None:
        if self.call_options & OPT_CAPTURE and self._captured is None:
            self._captured = computed

    @property
    def captured(self) -> Optional["Computed"]:
        return self._captured

    # -- ambient access ---------------------------------------------------
    @staticmethod
    def current() -> "ComputeContext":
        return _current_context.get()

    @contextlib.contextmanager
    def activate(self):
        token = _current_context.set(self)
        try:
            yield self
        finally:
            _current_context.reset(token)

    def __repr__(self) -> str:
        return f"ComputeContext({CallOptions(self.call_options)!r})"


ComputeContext.DEFAULT = ComputeContext()

_current_context: contextvars.ContextVar[ComputeContext] = contextvars.ContextVar(
    "fusion_compute_context", default=ComputeContext.DEFAULT
)
_current_computed: contextvars.ContextVar[Optional["Computed"]] = contextvars.ContextVar(
    "fusion_current_computed", default=None
)


def get_current() -> Optional["Computed"]:
    """The node currently being computed — the dependency-capture root."""
    return _current_computed.get()


@contextlib.contextmanager
def change_current(computed: Optional["Computed"]):
    """Scope with a different (or no) dependency-capture root.

    Entering a compute body sets its node current AND resets the context to
    DEFAULT, so outer call modes (invalidate/capture) don't leak into nested
    calls (reference: ComputeMethodFunctionBase.cs:19-53).
    """
    t1 = _current_computed.set(computed)
    t2 = _current_context.set(ComputeContext.DEFAULT)
    try:
        yield
    finally:
        _current_context.reset(t2)
        _current_computed.reset(t1)


@contextlib.contextmanager
def suspend_dependency_capture():
    """Run a block without attaching dependencies to the current computed.

    ≈ the reference's ExecutionContext.SuppressFlow points
    (e.g. ClientComputeMethodFunction.cs:82).
    """
    token = _current_computed.set(None)
    try:
        yield
    finally:
        _current_computed.reset(token)


def is_invalidating() -> bool:
    return bool(_current_context.get().call_options & OPT_INVALIDATE_BIT)


class _InvalidatingScope:
    __slots__ = ("_ctx", "_cm", "_sink")

    def __init__(self, sink=None):
        self._sink = sink

    def __enter__(self):
        self._ctx = ComputeContext(CallOptions.INVALIDATE, invalidation_sink=self._sink)
        self._cm = self._ctx.activate()
        self._cm.__enter__()
        return self._ctx

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def invalidating(sink=None) -> _InvalidatingScope:
    """``with invalidating(): await service.get(x)`` invalidates the cached
    node for ``get(x)`` instead of computing it.

    ``sink``: a list — INVALIDATE-mode hits are APPENDED instead of
    cascading immediately; the caller owns applying the collected group
    (e.g. as one lane of a device burst). Used by the op-log reader to
    lane-pack a batch of external operations' replays."""
    return _InvalidatingScope(sink)


async def capture(fn: Callable[[], Awaitable[T]]) -> "Computed":
    """Run ``fn`` in capture mode and return the Computed it produced/hit.

    ≈ ``Computed.Capture`` (Computed.Static.cs). Raises if nothing was
    captured (fn made no compute-method call).
    """
    ctx = ComputeContext(CallOptions.CAPTURE)
    with ctx.activate():
        await fn()
    if ctx.captured is None:
        raise RuntimeError("no computed was captured — did fn call a compute method?")
    return ctx.captured


async def try_capture(fn: Callable[[], Awaitable[Any]]) -> Optional["Computed"]:
    ctx = ComputeContext(CallOptions.CAPTURE)
    with ctx.activate():
        try:
            await fn()
        except Exception:  # noqa: BLE001 — errors are memoized; captured node carries them
            pass
    return ctx.captured


async def get_existing(fn: Callable[[], Awaitable[Any]]) -> Optional["Computed"]:
    """Peek the cached Computed for a call without computing (maybe stale).

    ≈ ``Computed.GetExisting`` (Computed.Static.cs).
    """
    ctx = ComputeContext(CallOptions.GET_EXISTING | CallOptions.CAPTURE)
    with ctx.activate():
        await fn()
    return ctx.captured
