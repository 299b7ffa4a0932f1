"""Typed messaging helpers over a pluggable broker (Stl.Redis analogue).

Re-expression of src/Stl.Redis/ (RedisDb, RedisPub/RedisSub, RedisQueue,
RedisStreamer, RedisSequenceSet) without binding to a Redis server: the
broker surface is the small abstract ``MessageBroker`` (publish/subscribe
byte channels + atomic counters), with a process-local ``InMemoryBroker``
default; a real Redis/network-backed broker plugs in by implementing the
same surface. All typed helpers serialize via the framework wire format,
mirroring how the reference routes RedisDb values through its serializers.

``BrokerChangeNotifier`` adapts a pub/sub channel to the operation-log
reader's wake-up protocol — the analogue of
Redis/Operations/RedisOperationLogChangeNotifier.cs (SURVEY §2.6).
"""
from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Callable, Dict, Generic, List, Optional, TypeVar

from ..utils.serialization import decode, dumps, encode, loads

T = TypeVar("T")

__all__ = [
    "MessageBroker",
    "InMemoryBroker",
    "PubSub",
    "TypedQueue",
    "Streamer",
    "SequenceSet",
    "BrokerChangeNotifier",
]


class MessageBroker:
    """Minimal broker surface: named byte channels, work queues, counters."""

    def publish(self, channel: str, payload: bytes) -> None:
        raise NotImplementedError

    def subscribe(self, channel: str, handler: Callable[[bytes], None]) -> Callable[[], None]:
        """Register a handler; returns an unsubscribe callable."""
        raise NotImplementedError

    def queue_push(self, name: str, payload: bytes) -> None:
        """Append to a broker-resident work queue (each item popped once)."""
        raise NotImplementedError

    async def queue_pop(self, name: str) -> bytes:
        raise NotImplementedError

    def next_value(self, key: str, at_least: int = 0) -> int:
        """Atomic monotone counter (≈ RedisSequenceSet.Next)."""
        raise NotImplementedError

    def reset_value(self, key: str, value: int = 0) -> None:
        raise NotImplementedError


class InMemoryBroker(MessageBroker):
    def __init__(self):
        self._subscribers: Dict[str, List[Callable[[bytes], None]]] = {}
        self._queues: Dict[str, "asyncio.Queue[bytes]"] = {}
        self._counters: Dict[str, int] = {}

    def publish(self, channel: str, payload: bytes) -> None:
        for handler in list(self._subscribers.get(channel, ())):
            handler(payload)

    def subscribe(self, channel: str, handler: Callable[[bytes], None]) -> Callable[[], None]:
        self._subscribers.setdefault(channel, []).append(handler)

        def unsubscribe() -> None:
            handlers = self._subscribers.get(channel, [])
            if handler in handlers:
                handlers.remove(handler)

        return unsubscribe

    def _queue(self, name: str) -> "asyncio.Queue[bytes]":
        q = self._queues.get(name)
        if q is None:
            q = self._queues[name] = asyncio.Queue()
        return q

    def queue_push(self, name: str, payload: bytes) -> None:
        self._queue(name).put_nowait(payload)

    async def queue_pop(self, name: str) -> bytes:
        return await self._queue(name).get()

    def next_value(self, key: str, at_least: int = 0) -> int:
        value = max(self._counters.get(key, 0), at_least) + 1
        self._counters[key] = value
        return value

    def reset_value(self, key: str, value: int = 0) -> None:
        self._counters[key] = value


class PubSub(Generic[T]):
    """Typed pub/sub channel (≈ RedisPub/RedisSub)."""

    def __init__(self, broker: MessageBroker, channel: str):
        self.broker = broker
        self.channel = channel

    def publish(self, value: T) -> None:
        self.broker.publish(self.channel, encode(dumps(value)))

    def subscribe(self, handler: Callable[[T], None]) -> Callable[[], None]:
        return self.broker.subscribe(self.channel, lambda raw: handler(loads(decode(raw))))

    def stream(self) -> "asyncio.Queue[T]":
        """Subscribe into an asyncio queue (reader cancels by unsubscribing
        via ``queue.unsubscribe()``)."""
        queue: "asyncio.Queue[T]" = asyncio.Queue()
        loop = asyncio.get_event_loop()
        unsubscribe = self.subscribe(lambda v: loop.call_soon_threadsafe(queue.put_nowait, v))
        queue.unsubscribe = unsubscribe  # type: ignore[attr-defined]
        return queue


class TypedQueue(Generic[T]):
    """Typed work queue (≈ RedisQueue). The item buffer lives in the
    BROKER, not the instance, so concurrent consumers — even separate
    TypedQueue instances over the same broker+name — each pop distinct
    items (the multi-worker setup the Redis analogue implies)."""

    def __init__(self, broker: MessageBroker, name: str):
        self.broker = broker
        self.name = name

    def enqueue(self, value: T) -> None:
        self.broker.queue_push(f"queue:{self.name}", encode(dumps(value)))

    async def dequeue(self, timeout: Optional[float] = None) -> T:
        pop = self.broker.queue_pop(f"queue:{self.name}")
        raw = await (pop if timeout is None else asyncio.wait_for(pop, timeout))
        return loads(decode(raw))

    def close(self) -> None:
        pass  # nothing instance-local to release; kept for API symmetry


class Streamer(Generic[T]):
    """Replayable typed stream (≈ RedisStreamer): items are appended with
    monotone positions; late readers replay the backlog then follow live."""

    def __init__(self, broker: MessageBroker, name: str, max_backlog: int = 4096):
        self.broker = broker
        self.name = name
        self.max_backlog = max_backlog
        self._backlog: List[T] = []
        self._base = 0  # absolute stream position of _backlog[0]
        self._events: List[asyncio.Event] = []
        self._done = False
        self._unsubscribe = broker.subscribe(f"stream:{name}", self._on_raw)

    def _on_raw(self, raw: bytes) -> None:
        kind, value = loads(decode(raw))
        if kind == "end":
            self._done = True
        else:
            self._backlog.append(value)
            excess = len(self._backlog) - self.max_backlog
            if excess > 0:
                del self._backlog[:excess]
                self._base += excess  # readers track absolute positions
        for e in self._events:
            e.set()

    def append(self, value: T) -> None:
        self.broker.publish(f"stream:{self.name}", encode(dumps(("item", value))))

    def complete(self) -> None:
        self.broker.publish(f"stream:{self.name}", encode(dumps(("end", None))))

    async def read(self, from_start: bool = True) -> AsyncIterator[T]:
        """Replay the retained backlog (items older than ``max_backlog``
        are gone — a slow reader skips forward rather than mis-indexing),
        then follow live until ``complete()``. Positions are absolute."""
        pos = self._base if from_start else self._base + len(self._backlog)
        event = asyncio.Event()
        self._events.append(event)
        try:
            while True:
                while True:
                    # re-clamp EVERY iteration: the producer may trim while
                    # this reader's consumer is suspended at the yield
                    pos = max(pos, self._base)
                    if pos >= self._base + len(self._backlog):
                        break
                    item = self._backlog[pos - self._base]
                    pos += 1
                    yield item
                if self._done:
                    return
                event.clear()
                await event.wait()
        finally:
            self._events.remove(event)

    def close(self) -> None:
        self._unsubscribe()


class SequenceSet:
    """Monotone named sequences (≈ RedisSequenceSet): ``next`` never
    repeats and can be bumped past an externally-observed value."""

    def __init__(self, broker: MessageBroker, prefix: str = "seq"):
        self.broker = broker
        self.prefix = prefix

    def next(self, key: str, at_least: int = 0) -> int:
        return self.broker.next_value(f"{self.prefix}:{key}", at_least)

    def reset(self, key: str, value: int = 0) -> None:
        self.broker.reset_value(f"{self.prefix}:{key}", value)


class BrokerChangeNotifier:
    """Operation-log wake-up over a broker channel (≈ Redis op-log change
    notifier): hosts publish after committing; readers' events wake."""

    def __init__(self, broker: MessageBroker, channel: str = "oplog-changed"):
        self.broker = broker
        self.channel = channel
        self._events: List[asyncio.Event] = []
        self._unsubscribe = broker.subscribe(channel, self._on_message)

    def _on_message(self, _raw: bytes) -> None:
        for e in self._events:
            e.set()

    def subscribe(self) -> asyncio.Event:
        e = asyncio.Event()
        self._events.append(e)
        return e

    def unsubscribe(self, event: asyncio.Event) -> None:
        if event in self._events:
            self._events.remove(event)

    def notify(self) -> None:
        self.broker.publish(self.channel, b"\x01")

    def close(self) -> None:
        self._events.clear()
        self._unsubscribe()
