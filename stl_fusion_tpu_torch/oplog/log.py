"""Durable operation log — the multi-host invalidation backbone.

Re-expression of src/Stl.Fusion.EntityFramework/Operations/ (DbOperation,
IDbOperationLog, DbOperationScope): every completed command is appended as a
durable record (id, agent, commit time, serialized command + nested items);
other hosts tail the log and replay external operations as invalidations
(reader.py). Store-agnostic per SURVEY §7 step 7: a sqlite implementation
(stdlib — the durable default) and an in-memory one for tests.

This is also the checkpoint/resume story (SURVEY §5.4): a restarted host
re-reads from its commit-time watermark, so invalidation truth survives
restarts.
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, List, Optional

from ..utils.serialization import decode, encode

__all__ = [
    "CorruptRecord",
    "OperationRecord",
    "OperationLog",
    "SqliteOperationLog",
    "InMemoryOperationLog",
    "ensure_operations_schema",
    "insert_operation_row",
]


def ensure_operations_schema(conn: sqlite3.Connection) -> None:
    """Create the operations table (shared between SqliteOperationLog and
    the atomic SqliteOperationScope, which writes the row inside the SAME
    transaction as the command's DAL writes — oplog/scope.py)."""
    conn.execute(
        """CREATE TABLE IF NOT EXISTS operations (
            idx INTEGER PRIMARY KEY AUTOINCREMENT,
            id TEXT UNIQUE,
            agent_id TEXT,
            commit_time REAL,
            command_json TEXT,
            items_json TEXT,
            cause_id TEXT
        )"""
    )
    # older databases lack the cause column; migrate in place (the
    # column is nullable, so old rows read back with cause=None)
    cols = {row[1] for row in conn.execute("PRAGMA table_info(operations)")}
    if "cause_id" not in cols:
        conn.execute("ALTER TABLE operations ADD COLUMN cause_id TEXT")
    conn.execute(
        "CREATE INDEX IF NOT EXISTS ix_operations_commit ON operations(commit_time)"
    )


def insert_operation_row(conn: sqlite3.Connection, record: "OperationRecord"):
    """INSERT the record (id-deduped) WITHOUT committing — the caller owns
    the transaction."""
    return conn.execute(
        "INSERT OR IGNORE INTO operations"
        " (id, agent_id, commit_time, command_json, items_json, cause_id)"
        " VALUES (?, ?, ?, ?, ?, ?)",
        (
            record.id,
            record.agent_id,
            record.commit_time,
            json.dumps(encode(record.command)),
            json.dumps(encode(list(record.items))),
            record.cause,
        ),
    )


@dataclass(frozen=True)
class OperationRecord:
    id: str
    agent_id: str
    commit_time: float
    command: Any
    items: tuple  # nested commands
    index: int = 0  # log position (store-assigned)
    #: originating span/wave cause id: rides the log BOTH
    #: directions so a remote replay's stitched wave timeline attributes
    #: back to the command that minted the operation
    cause: Optional[str] = None


@dataclass(frozen=True)
class CorruptRecord:
    """A log row that exists but cannot be decoded (truncated/garbled
    payload — a torn write, a partial disk, a bad migration). Stores
    surface these instead of RAISING from ``read_after``: one poisoned row
    must not halt every reader forever (reader.py quarantines it and
    resumes at the next good watermark). ``commit_time`` is kept when the
    column itself survived — the trimmer uses it to never trim past a
    quarantined range."""

    index: int
    commit_time: Optional[float]
    error: str


class OperationLog:
    """Abstract durable operation log."""

    def append(self, record: OperationRecord) -> OperationRecord:
        raise NotImplementedError

    def read_after(self, index: int, limit: int = 1024) -> List[OperationRecord]:
        """Records with position > index, oldest first. A row that exists
        but cannot be decoded comes back as a :class:`CorruptRecord` in
        position — never an exception (reader.py quarantines and
        resumes)."""
        raise NotImplementedError

    def last_index(self) -> int:
        raise NotImplementedError

    def contains(self, operation_id: str) -> bool:
        """Is an operation with this id already journaled? The cluster
        commander's replay dedup: a retried command whose first
        attempt committed must NOT re-apply."""
        raise NotImplementedError

    def trim_before(self, commit_time: float) -> int:
        """Drop old records (≈ DbOperationLogTrimmer). Returns removed count."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryOperationLog(OperationLog):
    def __init__(self):
        self._records: List[OperationRecord] = []
        self._ids: dict = {}  # operation id -> record (the INSERT OR IGNORE analog)
        self._lock = threading.Lock()

    def append(self, record: OperationRecord) -> OperationRecord:
        with self._lock:
            # id-dedup mirrors the sqlite INSERT OR IGNORE: a replayed
            # operation (same id) journals once, never twice
            existing = self._ids.get(record.id)
            if existing is not None:
                return existing
            rec = OperationRecord(
                record.id, record.agent_id, record.commit_time, record.command,
                record.items, index=len(self._records) + 1, cause=record.cause,
            )
            self._records.append(rec)
            self._ids[rec.id] = rec
            return rec

    def read_after(self, index: int, limit: int = 1024) -> List[OperationRecord]:
        with self._lock:
            return [r for r in self._records if r.index > index][:limit]

    def last_index(self) -> int:
        with self._lock:
            return self._records[-1].index if self._records else 0

    def contains(self, operation_id: str) -> bool:
        with self._lock:
            return operation_id in self._ids

    def trim_before(self, commit_time: float) -> int:
        with self._lock:
            keep = [r for r in self._records if r.commit_time >= commit_time]
            removed = len(self._records) - len(keep)
            self._records = keep
            self._ids = {r.id: r for r in keep}
            return removed


class SqliteOperationLog(OperationLog):
    """Durable log in sqlite — the shared-DB pattern the reference's
    multi-host samples run on (two hosts, one database file)."""

    def __init__(
        self,
        path: str,
        busy_timeout_s: float = 30.0,
        synchronous: Optional[str] = None,
    ):
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(
            path, check_same_thread=False, timeout=busy_timeout_s
        )
        if synchronous is None:
            synchronous = os.environ.get("FUSION_OPLOG_SYNC", "NORMAL")
        if synchronous.upper() not in ("OFF", "NORMAL", "FULL", "EXTRA"):
            raise ValueError(f"invalid synchronous level: {synchronous!r}")
        # WAL lets a snapshotting READER (another process/instance tailing
        # or checkpointing this log) run concurrently with an appending
        # WRITER — under the default rollback journal the reader takes a
        # shared lock that makes a loaded writer throw `database is
        # locked`. busy_timeout is the in-engine wait (sqlite3's `timeout`
        # arg only covers the connection-level retry loop; the pragma also
        # guards statements issued after the connection was handed out).
        # Both are best-effort: ":memory:" and some network filesystems
        # refuse WAL, and the log still works in rollback mode there.
        self.journal_mode = None
        try:
            self._conn.execute(f"PRAGMA busy_timeout={int(busy_timeout_s * 1000)}")
            row = self._conn.execute("PRAGMA journal_mode=WAL").fetchone()
            self.journal_mode = row[0] if row else None
            # NORMAL removes the per-commit fsync stall that made append the
            # fan-out bottleneck under load, but a power loss can drop acked
            # rows from an unsynced WAL — which breaks the warm-rejoin
            # contract that snapshot watermark + surviving tail covers every
            # committed write. Deployments relying on exact-tail replay
            # across power loss should run FULL (constructor arg or
            # FUSION_OPLOG_SYNC=FULL); see DURABILITY.md "Trim safety".
            self._conn.execute(f"PRAGMA synchronous={synchronous.upper()}")
        except sqlite3.Error:  # pragma unsupported: keep default journaling
            pass
        ensure_operations_schema(self._conn)
        self._conn.commit()

    def append(self, record: OperationRecord) -> OperationRecord:
        with self._lock:
            cur = insert_operation_row(self._conn, record)
            self._conn.commit()
            idx = cur.lastrowid or 0
            return OperationRecord(
                record.id, record.agent_id, record.commit_time, record.command,
                record.items, index=idx, cause=record.cause,
            )

    def read_after(self, index: int, limit: int = 1024) -> List[OperationRecord]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT idx, id, agent_id, commit_time, command_json, items_json,"
                " cause_id FROM operations WHERE idx > ? ORDER BY idx LIMIT ?",
                (index, limit),
            ).fetchall()
        out: List[OperationRecord] = []
        for r in rows:
            try:
                out.append(
                    OperationRecord(
                        id=r[1],
                        agent_id=r[2],
                        commit_time=r[3],
                        command=decode(json.loads(r[4])),
                        items=tuple(decode(json.loads(r[5]))),
                        index=r[0],
                        cause=r[6],
                    )
                )
            except Exception as e:  # noqa: BLE001 — torn/garbled row: surface,
                # don't raise (one poisoned row must not halt every reader)
                commit_time = r[3] if isinstance(r[3], (int, float)) else None
                out.append(CorruptRecord(index=r[0], commit_time=commit_time, error=repr(e)))
        return out

    def last_index(self) -> int:
        with self._lock:
            row = self._conn.execute("SELECT MAX(idx) FROM operations").fetchone()
            return row[0] or 0

    def contains(self, operation_id: str) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM operations WHERE id = ? LIMIT 1", (operation_id,)
            ).fetchone()
            return row is not None

    def trim_before(self, commit_time: float) -> int:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM operations WHERE commit_time < ?", (commit_time,)
            )
            self._conn.commit()
            return cur.rowcount

    def close(self) -> None:
        self._conn.close()
