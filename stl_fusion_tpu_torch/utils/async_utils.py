"""Async primitives: AsyncEvent chains, keyed lock sets, channels.

TPU-native re-expression of the reference's L0 async toolkit:
- ``AsyncEvent<T>`` (src/Stl/Async/AsyncEvent.cs) — an immutable linked list of
  versions, each awaitable for the next; used for connection-state streams.
- ``AsyncLockSet<TKey>`` (src/Stl/Locking/AsyncLockSet.cs:8-31) — striped
  per-key async locks with reentry checking; the single-flight gate of the
  compute pipeline.
- ``ChannelPair`` / ``create_twisted`` (src/Stl/Channels/ChannelPair.cs) — the
  in-memory duplex transport the RPC test harness runs on.
"""
from __future__ import annotations

import asyncio
import contextvars
import logging
from typing import Any, AsyncIterator, Generic, Hashable, Optional, Tuple, TypeVar

log = logging.getLogger("stl_fusion_tpu_torch")

T = TypeVar("T")

__all__ = [
    "AsyncEvent",
    "AsyncLockSet",
    "LockReentryError",
    "Channel",
    "ChannelClosedError",
    "ChannelPair",
    "TaskSet",
    "create_twisted_pair",
]


class TaskSet:
    """Lifecycle owner for fire-and-forget tasks (the fusionlint FL003
    contract): ``spawn()`` keeps a strong reference until the task settles
    — the event loop holds tasks weakly, so a bare ``create_task(...)``
    can be garbage-collected mid-flight — and teardown has one handle to
    cancel every in-flight side task instead of leaking them past their
    owner's close (ghost sessions, leaked pins).

    A failed task is logged by default (the bare-``create_task`` shape at
    least produced asyncio's never-retrieved traceback; owning the task
    must not make failures QUIETER) — pass ``on_error=`` to count or
    contain instead. Spawning after ``cancel()`` raises ``RuntimeError``
    so a closed owner can't quietly restart its side work.
    """

    __slots__ = ("_tasks", "_name", "_closed", "_on_error")

    def __init__(self, name: str = "task-set", on_error=None):
        self._tasks: set = set()
        self._name = name
        self._closed = False
        self._on_error = on_error

    def __len__(self) -> int:
        return len(self._tasks)

    @property
    def closed(self) -> bool:
        return self._closed

    def spawn(self, coro, name: Optional[str] = None) -> "asyncio.Task":
        if self._closed:
            coro.close()  # don't leave a never-awaited coroutine warning
            raise RuntimeError(f"TaskSet {self._name!r} is closed")
        task = asyncio.get_event_loop().create_task(
            coro, name=name or f"{self._name}:task"
        )
        self._tasks.add(task)
        task.add_done_callback(self._reap)
        return task

    def _reap(self, task: "asyncio.Task") -> None:
        self._tasks.discard(task)
        if task.cancelled():
            return
        exc = task.exception()
        if exc is None:
            return
        if self._on_error is not None:
            try:
                self._on_error(task, exc)
            except Exception:
                pass  # a raising error hook inside a done-callback must not escape
        else:
            log.error(
                "task-set %s: task %s failed", self._name, task.get_name(),
                exc_info=exc,
            )

    def cancel(self) -> int:
        """Cancel every in-flight task and close the set. Returns how many
        were still running (teardown accounting)."""
        self._closed = True
        pending = [t for t in self._tasks if not t.done()]
        for t in pending:
            t.cancel()
        return len(pending)

    async def aclose(self) -> None:
        """``cancel()`` then await the stragglers' completion."""
        self.cancel()
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)


class AsyncEvent(Generic[T]):
    """One immutable version in an awaitable chain.

    ``latest()`` walks to the newest version; ``when_next()`` awaits the
    successor; a producer appends with ``create_next(value)``. Consumers can
    therefore never miss a transition — they replay the chain at their own
    pace, exactly like the reference's connection-state sequence
    (RpcPeer.cs:240-302).
    """

    __slots__ = ("value", "_next", "_next_ready")

    def __init__(self, value: T):
        self.value = value
        self._next: Optional["AsyncEvent[T]"] = None
        self._next_ready: asyncio.Event = asyncio.Event()

    @property
    def is_latest(self) -> bool:
        return self._next is None

    def next_or_none(self) -> Optional["AsyncEvent[T]"]:
        return self._next

    def latest(self) -> "AsyncEvent[T]":
        node = self
        while node._next is not None:
            node = node._next
        return node

    def create_next(self, value: T) -> "AsyncEvent[T]":
        """Append a new version after the LATEST node and return it."""
        tail = self.latest()
        nxt = AsyncEvent(value)
        tail._next = nxt
        tail._next_ready.set()
        return nxt

    async def when_next(self) -> "AsyncEvent[T]":
        await self._next_ready.wait()
        assert self._next is not None
        return self._next

    async def changes(self) -> AsyncIterator[T]:
        node = self
        while True:
            yield node.value
            node = await node.when_next()

    async def when(self, predicate) -> "AsyncEvent[T]":
        node = self
        while not predicate(node.value):
            node = await node.when_next()
        return node

    def __repr__(self) -> str:
        return f"AsyncEvent({self.value!r}, latest={self.is_latest})"


class LockReentryError(RuntimeError):
    """Raised when a task re-acquires a key it already holds (CheckedFail)."""


_held_keys: contextvars.ContextVar[frozenset] = contextvars.ContextVar(
    "stl_fusion_tpu_held_lock_keys", default=frozenset()
)


class AsyncLockSet:
    """Per-key asyncio locks, created on demand and dropped when uncontended.

    Reentry from the same task context raises LockReentryError — mirroring the
    reference's ``LockReentryMode.CheckedFail`` used by the compute
    single-flight path (ComputedRegistry.cs:31,47).
    """

    def __init__(self, name: str = "locks"):
        self._name = name
        self._locks: dict[Hashable, Tuple[asyncio.Lock, int]] = {}

    def __len__(self) -> int:
        return len(self._locks)

    def lock(self, key: Hashable) -> "_LockScope":
        return _LockScope(self, key)

    def _acquire_entry(self, key: Hashable) -> asyncio.Lock:
        entry = self._locks.get(key)
        if entry is None:
            lock = asyncio.Lock()
            self._locks[key] = (lock, 1)
            return lock
        lock, refs = entry
        self._locks[key] = (lock, refs + 1)
        return lock

    def _release_entry(self, key: Hashable) -> None:
        lock, refs = self._locks[key]
        if refs <= 1:
            del self._locks[key]
        else:
            self._locks[key] = (lock, refs - 1)


class _LockScope:
    __slots__ = ("_set", "_key", "_lock", "_token")

    def __init__(self, lock_set: AsyncLockSet, key: Hashable):
        self._set = lock_set
        self._key = key
        self._lock: Optional[asyncio.Lock] = None
        self._token = None

    async def __aenter__(self):
        held = _held_keys.get()
        marker = (id(self._set), self._key)
        if marker in held:
            raise LockReentryError(
                f"reentrant acquisition of {self._key!r} in lock set {self._set._name!r}"
            )
        self._lock = self._set._acquire_entry(self._key)
        try:
            await self._lock.acquire()
        except BaseException:
            self._set._release_entry(self._key)
            self._lock = None
            raise
        self._token = _held_keys.set(held | {marker})
        return self

    async def __aexit__(self, *exc):
        if self._token is not None:
            _held_keys.reset(self._token)
            self._token = None
        if self._lock is not None:
            self._lock.release()
            self._set._release_entry(self._key)
            self._lock = None
        return False


class ChannelClosedError(Exception):
    pass


class Channel(Generic[T]):
    """Bounded async channel with explicit close (≈ System.Threading.Channels)."""

    def __init__(self, maxsize: int = 0):
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._closed = False
        self._close_error: Optional[BaseException] = None

    @property
    def is_closed(self) -> bool:
        return self._closed

    async def send(self, item: T) -> None:
        if self._closed:
            raise ChannelClosedError(str(self._close_error or "channel closed"))
        await self._queue.put(item)

    def try_send(self, item: T) -> bool:
        if self._closed:
            return False
        try:
            self._queue.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def receive(self) -> T:
        while True:
            if self._closed:
                try:
                    item = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    raise ChannelClosedError(str(self._close_error or "channel closed"))
            else:
                get = asyncio.ensure_future(self._queue.get())
                try:
                    item = await get
                except asyncio.CancelledError:
                    get.cancel()
                    raise
            if item is _CLOSED_SENTINEL:
                # propagate the wake-up to other blocked receivers, then report closed
                try:
                    self._queue.put_nowait(_CLOSED_SENTINEL)
                except asyncio.QueueFull:
                    pass
                raise ChannelClosedError(str(self._close_error or "channel closed"))
            return item

    def close(self, error: Optional[BaseException] = None) -> None:
        self._closed = True
        self._close_error = error
        # wake any blocked receiver
        try:
            self._queue.put_nowait(_CLOSED_SENTINEL)
        except asyncio.QueueFull:
            pass

    async def __aiter__(self) -> AsyncIterator[T]:
        while True:
            try:
                yield await self.receive()
            except ChannelClosedError:
                return


_CLOSED_SENTINEL: Any = object()


class ChannelPair(Generic[T]):
    """A reader/writer pair of channels forming one endpoint of a duplex link."""

    def __init__(self, reader: Channel, writer: Channel):
        self.reader = reader
        self.writer = writer

    def close(self, error: Optional[BaseException] = None) -> None:
        self.reader.close(error)
        self.writer.close(error)


def create_twisted_pair(maxsize: int = 128) -> Tuple[ChannelPair, ChannelPair]:
    """Two endpoints wired so one side's writer is the other side's reader.

    The in-memory transport for RPC protocol tests (ChannelPair.CreateTwisted,
    src/Stl/Channels/ChannelPair.cs; used by Stl.Rpc/Testing/RpcTestClient.cs).
    """
    a_to_b: Channel = Channel(maxsize)
    b_to_a: Channel = Channel(maxsize)
    return ChannelPair(reader=b_to_a, writer=a_to_b), ChannelPair(reader=a_to_b, writer=b_to_a)
