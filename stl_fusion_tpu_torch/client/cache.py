"""Client computed caches — boot-from-cache for remote results.

Re-expression of src/Stl.Fusion/Client/Caching/ + Rpc/Caching/RpcCacheKey.cs:
a persistent map ``(service, method, argument-bytes) → result-bytes`` that
survives restarts, letting a client render instantly from cached RPC results
and then synchronize (ClientComputedCache.cs:10-49). A version key flushes
the whole cache when the API generation changes.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["RpcCacheKey", "ClientComputedCache", "InMemoryClientComputedCache", "FileClientComputedCache"]


@dataclass(frozen=True)
class RpcCacheKey:
    service: str
    method: str
    arg_data: bytes

    def __repr__(self) -> str:
        return f"RpcCacheKey({self.service}.{self.method}, {len(self.arg_data)}B)"


class ClientComputedCache:
    """Abstract cache; values are serialized result bytes."""

    def get(self, key: RpcCacheKey) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: RpcCacheKey, value: bytes) -> None:
        raise NotImplementedError

    def remove(self, key: RpcCacheKey) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError


class InMemoryClientComputedCache(ClientComputedCache):
    def __init__(self):
        self._map: Dict[RpcCacheKey, bytes] = {}

    def get(self, key):
        return self._map.get(key)

    def set(self, key, value):
        self._map[key] = value

    def remove(self, key):
        self._map.pop(key, None)

    def clear(self):
        self._map.clear()

    def __len__(self):
        return len(self._map)


class FileClientComputedCache(ClientComputedCache):
    """Flushing file-backed cache (≈ FlushingClientComputedCache): writes
    batch on a flush call or at a dirty-entry threshold; version-key flush
    on generation mismatch."""

    def __init__(self, path: str, version: str = "1", flush_threshold: int = 64):
        self.path = path
        self.version = version
        self.flush_threshold = flush_threshold
        self._map: Dict[Tuple[str, str, str], str] = {}
        self._dirty = 0
        self._lock = threading.Lock()
        self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                data = json.load(f)
            if data.get("version") != self.version:
                return  # generation changed: start empty (version-key flush)
            self._map = {tuple(k.split("\x00", 2)): v for k, v in data.get("entries", {}).items()}
        except Exception:  # noqa: BLE001 — corrupt cache: start empty
            self._map = {}

    def flush(self) -> None:
        with self._lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "version": self.version,
                        "entries": {"\x00".join(k): v for k, v in self._map.items()},
                    },
                    f,
                )
            os.replace(tmp, self.path)
            self._dirty = 0

    def _k(self, key: RpcCacheKey):
        return (key.service, key.method, key.arg_data.decode("utf-8", "replace"))

    def get(self, key):
        v = self._map.get(self._k(key))
        return v.encode("utf-8") if v is not None else None

    def set(self, key, value):
        self._map[self._k(key)] = value.decode("utf-8", "replace")
        self._dirty += 1
        if self._dirty >= self.flush_threshold:
            self.flush()

    def remove(self, key):
        self._map.pop(self._k(key), None)
        self._dirty += 1

    def clear(self):
        self._map.clear()
        self.flush()
