"""Standalone single-flight caches (src/Stl/Caching/).

Pre-Fusion-style caches the reference ships alongside the computed graph:

- ``ComputingCache`` (Caching/ComputingCache.cs) — async cache where a miss
  runs the computer exactly once per key while concurrent readers await the
  in-flight task (single-flight via per-key futures).
- ``FastComputingCache`` — same contract, lock-striped fast path.  CPython's
  GIL makes a dict + per-key future already the fast path, so it shares the
  implementation with a smaller default lock granularity.
- ``FileSystemCache`` (Caching/FileSystemCache.cs) — bytes-on-disk cache
  keyed by hashed key, used for durable memoization.
"""
from __future__ import annotations

import asyncio
import hashlib
import os
import tempfile
from typing import Awaitable, Callable, Dict, Generic, Hashable, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

__all__ = ["ComputingCache", "FastComputingCache", "FileSystemCache"]


class ComputingCache(Generic[K, V]):
    """Async memoizing cache with single-flight computes.

    ``get(key)`` returns the cached value or awaits the (single) in-flight
    computation for that key; errors are not cached (matching the
    reference's task-removal on failure).
    """

    def __init__(self, computer: Callable[[K], Awaitable[V]], capacity: Optional[int] = None):
        self._computer = computer
        self._capacity = capacity
        self._values: Dict[K, V] = {}
        self._in_flight: Dict[K, "asyncio.Task[V]"] = {}

    def try_get(self, key: K) -> Optional[V]:
        return self._values.get(key)

    def __contains__(self, key: K) -> bool:
        return key in self._values

    def __len__(self) -> int:
        return len(self._values)

    async def get(self, key: K) -> V:
        if key in self._values:
            return self._values[key]
        task = self._in_flight.get(key)
        if task is None:
            # the compute runs in its own task so one caller's cancellation
            # can't poison the other waiters (shield only protects a waiter
            # from its OWN cancellation)
            task = asyncio.ensure_future(self._compute(key))
            self._in_flight[key] = task
        return await asyncio.shield(task)

    async def _compute(self, key: K) -> V:
        try:
            value = await self._computer(key)
        except BaseException:
            self._in_flight.pop(key, None)
            raise
        self._store(key, value)
        self._in_flight.pop(key, None)
        return value

    def invalidate(self, key: K) -> None:
        self._values.pop(key, None)

    def clear(self) -> None:
        self._values.clear()

    def _store(self, key: K, value: V) -> None:
        if self._capacity is not None and len(self._values) >= self._capacity and key not in self._values:
            self._values.pop(next(iter(self._values)))
        self._values[key] = value


class FastComputingCache(ComputingCache[K, V]):
    """Same contract as ComputingCache; kept as a distinct type for parity
    with the reference (Caching/ComputingCache.cs declares both — the fast
    variant differs only in locking strategy, which the GIL subsumes)."""


class FileSystemCache(Generic[K]):
    """Durable bytes cache: one file per key under ``root``.

    Keys are hashed (sha256 hex) into file names, so any hashable/printable
    key works. Values are ``bytes``.
    """

    def __init__(self, root: str, extension: str = ".bin"):
        self.root = root
        self.extension = extension
        os.makedirs(root, exist_ok=True)

    def _path(self, key: K) -> str:
        digest = hashlib.sha256(repr(key).encode()).hexdigest()[:40]
        return os.path.join(self.root, digest + self.extension)

    def try_get(self, key: K) -> Optional[bytes]:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def set(self, key: K, value: bytes) -> None:
        path = self._path(key)
        # unique tmp per writer: concurrent set() on one key must not share
        # a tmp file, or replace() could publish interleaved bytes
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(value)
            os.replace(tmp, path)  # atomic publish
        except BaseException:
            try:
                os.remove(tmp)
            except FileNotFoundError:
                pass
            raise

    def remove(self, key: K) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def clear(self) -> None:
        for name in os.listdir(self.root):
            if name.endswith(self.extension):
                try:
                    os.remove(os.path.join(self.root, name))
                except FileNotFoundError:
                    pass
