"""KeyValueStore — invalidation-aware KV storage.

Re-expression of src/Stl.Fusion.Ext.Services/Extensions/ — IKeyValueStore /
DbKeyValueStore / SandboxedKeyValueStore: reads are compute methods, writes
are commands whose completion invalidates exactly the touched keys (+ the
affected prefix listings), with optional expiration handled by a trimmer.
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

__all__ = [
    "KeyValueStore",
    "SqliteKeyValueStore",
    "SandboxedKeyValueStore",
    "SetCommand",
    "RemoveCommand",
]


@wire_type("KvSet")
@dataclasses.dataclass(frozen=True)
class SetCommand:
    key: str
    value: str
    expires_at: Optional[float] = None


@wire_type("KvRemove")
@dataclasses.dataclass(frozen=True)
class RemoveCommand:
    key: str


class KeyValueStore(ComputeService):
    """In-memory by default; subclasses swap the storage hooks for durable
    backends (`SqliteKeyValueStore` ≈ the reference's DbKeyValueStore)."""

    def __init__(self, hub: Optional[FusionHub] = None):
        super().__init__(hub)
        self._data: Dict[str, Tuple[str, Optional[float]]] = {}

    # ---------------------------------------------------------- storage hooks
    def _load(self, key: str) -> Optional[Tuple[str, Optional[float]]]:
        return self._data.get(key)

    def _store(self, key: str, value: str, expires_at: Optional[float]) -> None:
        self._data[key] = (value, expires_at)

    def _delete(self, key: str) -> None:
        self._data.pop(key, None)

    def _all_keys(self) -> Tuple[str, ...]:
        return tuple(self._data.keys())

    def _expired_keys(self, now: float) -> Tuple[str, ...]:
        return tuple(
            k for k, (_v, exp) in self._data.items() if exp is not None and exp <= now
        )

    # ------------------------------------------------------------------ reads
    @compute_method
    async def get(self, key: str) -> Optional[str]:
        entry = self._load(key)
        if entry is None:
            return None
        value, expires_at = entry
        if expires_at is not None and expires_at <= time.time():
            return None
        return value

    @compute_method
    async def count_by_prefix(self, prefix: str) -> int:
        return sum(1 for k in self._all_keys() if k.startswith(prefix))

    @compute_method
    async def list_key_suffixes(self, prefix: str) -> tuple:
        return tuple(sorted(k[len(prefix):] for k in self._all_keys() if k.startswith(prefix)))

    # ------------------------------------------------------------------ writes
    @command_handler
    async def set(self, command: SetCommand):
        if is_invalidating():
            await self._invalidate_key(command.key)
            return
        self._store(command.key, command.value, command.expires_at)

    @command_handler
    async def remove(self, command: RemoveCommand):
        if is_invalidating():
            await self._invalidate_key(command.key)
            return
        self._delete(command.key)

    async def _invalidate_key(self, key: str) -> None:
        await self.get(key)
        # prefix listings that could include this key
        for i in range(len(key) + 1):
            await self.count_by_prefix(key[:i])
            await self.list_key_suffixes(key[:i])

    # ------------------------------------------------------------------ trimmer
    async def trim_expired(self) -> int:
        """Expiration sweep (≈ DbKeyValueStore's trimmer worker)."""
        expired = self._expired_keys(time.time())
        from ..core.context import invalidating

        for k in expired:
            self._delete(k)
            with invalidating():
                await self._invalidate_key(k)
        return len(expired)


class SqliteKeyValueStore(KeyValueStore):
    """Durable KV store over stdlib sqlite (≈ DbKeyValueStore,
    Ext.Services/Extensions/Services/DbKeyValueStore.cs — store-agnostic
    here because no external DB exists in-image). Same compute/command
    surface; only the storage hooks differ, so invalidation semantics are
    inherited unchanged."""

    def __init__(self, path: str, hub: Optional[FusionHub] = None):
        import sqlite3

        super().__init__(hub)
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv (key TEXT PRIMARY KEY, value TEXT, expires_at REAL)"
        )
        self._db.commit()

    def _load(self, key: str) -> Optional[Tuple[str, Optional[float]]]:
        row = self._db.execute("SELECT value, expires_at FROM kv WHERE key=?", (key,)).fetchone()
        return (row[0], row[1]) if row is not None else None

    def _store(self, key: str, value: str, expires_at: Optional[float]) -> None:
        self._db.execute(
            "INSERT INTO kv VALUES (?,?,?) ON CONFLICT(key) DO UPDATE SET value=excluded.value, "
            "expires_at=excluded.expires_at",
            (key, value, expires_at),
        )
        self._db.commit()

    def _delete(self, key: str) -> None:
        self._db.execute("DELETE FROM kv WHERE key=?", (key,))
        self._db.commit()

    def _all_keys(self) -> Tuple[str, ...]:
        return tuple(r[0] for r in self._db.execute("SELECT key FROM kv"))

    def _expired_keys(self, now: float) -> Tuple[str, ...]:
        rows = self._db.execute(
            "SELECT key FROM kv WHERE expires_at IS NOT NULL AND expires_at <= ?", (now,)
        ).fetchall()
        return tuple(r[0] for r in rows)

    def close(self) -> None:
        self._db.close()


class SandboxedKeyValueStore:
    """Session-scoped view of a KeyValueStore: every key maps under the
    session's private prefix, so one session cannot read or clobber
    another's keys (≈ SandboxedKeyValueStore,
    Ext.Services/Extensions/Services/SandboxedKeyValueStore.cs). Delegates
    to the underlying store's compute methods, so dependency capture and
    invalidation flow through unchanged."""

    def __init__(self, store: KeyValueStore, session):
        from urllib.parse import quote

        self.store = store
        # the session id is URL-encoded (no unescaped '/') so a crafted id
        # like "a/b" cannot alias session "a"'s sandbox with key "b/..."
        # — the reference formats keys the same way
        # (SandboxedKeyValueStore.cs key formatting)
        self.prefix = f"@sandbox/{quote(session.id, safe='')}/"

    def _k(self, key: str) -> str:
        return self.prefix + key

    async def get(self, key: str) -> Optional[str]:
        return await self.store.get(self._k(key))

    async def count(self) -> int:
        return await self.store.count_by_prefix(self.prefix)

    async def list_keys(self) -> tuple:
        return await self.store.list_key_suffixes(self.prefix)

    async def set(self, key: str, value: str, expires_at: Optional[float] = None):
        return await self._commander().call(SetCommand(self._k(key), value, expires_at))

    async def remove(self, key: str):
        return await self._commander().call(RemoveCommand(self._k(key)))

    def _commander(self):
        from ..core.service import hub_of

        return hub_of(self.store).commander
