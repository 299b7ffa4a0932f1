"""Atomic operation scope — the exactly-once invalidation guarantee.

Re-expression of src/Stl.Fusion.EntityFramework/DbOperationScope.cs:25-130
(+ Operations/DbOperationScopeProvider.cs): ONE sqlite transaction owns both
the command's DAL writes and the operation record. Committed separately
(the DAL autocommitting, the op log appended afterwards), a crash in between
would silently lose the invalidation record and other hosts would serve
stale values forever. With the scope:

- the scope opens ``BEGIN IMMEDIATE`` on the shared sqlite file;
- DAL handles built on :class:`ScopedSqliteDb` transparently enroll — their
  statements ride the scope's connection whenever a scope is ambient
  (≈ DbOperationScope enrolling every DbContext on the master connection);
- at success the operation row is inserted and the transaction commits
  ONCE — the op record and the business writes become durable atomically
  (op exists XOR writes absent is impossible);
- a failed commit is VERIFIED against a fresh connection: if the op row is
  durable the commit actually landed (the reference's commit-verification
  error path, DbOperationScope.cs error handling).

The scope provider installs as a commander filter between the transient
operation scope (which creates the Operation and drives completion) and the
nested-command logger — the reference's ordering
(FusionOperationsCommandHandlerPriority: DbOperationScopeProvider inside
TransientOperationScopeProvider).
"""
from __future__ import annotations

import contextvars
import logging
import os
import sqlite3
import time
from typing import TYPE_CHECKING, Any, Optional

from ..core.context import is_invalidating
from ..operations.operation import Completion, Operation
from .log import OperationRecord, ensure_operations_schema, insert_operation_row

if TYPE_CHECKING:
    from ..commands.commander import Commander
    from ..commands.context import CommandContext

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "SqliteOperationScope",
    "ScopedSqliteDb",
    "current_operation_scope",
    "attach_db_operation_scope",
]

#: priority slot between the transient scope provider (90) and the nested
#: command logger (80) — see operations/pipeline.py
PRIORITY_DB_SCOPE_PROVIDER = 85

_current_scope: contextvars.ContextVar[Optional["SqliteOperationScope"]] = (
    contextvars.ContextVar("fusion_db_operation_scope", default=None)
)


def current_operation_scope() -> Optional["SqliteOperationScope"]:
    """The ambient scope, if a command with DB operations is executing."""
    return _current_scope.get()


class SqliteOperationScope:
    """One transaction for one operation (≈ DbOperationScope.cs:25-130)."""

    def __init__(self, path: str, operation: Operation, ensure_schema: bool = True):
        # realpath: enrollment matches by path (ScopedSqliteDb.conn), so
        # './db' vs its absolute spelling must compare equal — a mismatch
        # would silently void the atomicity guarantee
        self.path = os.path.realpath(path)
        self.operation = operation
        self.committed = False
        self.closed = False
        self.conn = sqlite3.connect(self.path, timeout=30.0)
        if ensure_schema:
            # WAL: readers (other hosts' log tails) never block the writer
            self.conn.execute("PRAGMA journal_mode=WAL")
            ensure_operations_schema(self.conn)
            self.conn.commit()
        self.conn.execute("BEGIN IMMEDIATE")

    # -- lifecycle ---------------------------------------------------------
    def commit(self) -> None:
        """Write the operation row and commit EVERYTHING at once."""
        op = self.operation
        if op.commit_time is None:
            op.commit_time = time.time()
        insert_operation_row(
            self.conn,
            OperationRecord(
                id=op.id,
                agent_id=op.agent_id,
                commit_time=op.commit_time,
                command=op.command,
                items=tuple(op.items),
            ),
        )
        try:
            self.conn.commit()
        except Exception:
            # ambiguous failure: the commit may or may not have landed —
            # verify against a FRESH connection (reference commit
            # verification, DbOperationScope.cs error path)
            if not self.verify_committed():
                raise
            log.warning("operation %s: commit reported failure but is durable", op.id)
        self.committed = True

    def rollback(self) -> None:
        try:
            self.conn.rollback()
        except Exception:  # noqa: BLE001
            log.exception("operation %s rollback failed", self.operation.id)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.conn.close()

    def verify_committed(self) -> bool:
        """Is the operation row durable? (fresh connection, fresh snapshot)"""
        check = sqlite3.connect(self.path, timeout=30.0)
        try:
            row = check.execute(
                "SELECT 1 FROM operations WHERE id=?", (self.operation.id,)
            ).fetchone()
            return row is not None
        finally:
            check.close()


class ScopedSqliteDb:
    """A DAL connection handle that transparently enrolls in the ambient
    operation scope: inside a command, statements ride the scope's
    transaction (and the scope commits once, together with the op record);
    outside, a private autocommitting connection is used. The analogue of a
    DbContext created through DbHub inside DbOperationScope."""

    def __init__(self, path: str):
        self.path = os.path.realpath(path)
        self._own = sqlite3.connect(self.path, timeout=30.0)
        self._own.execute("PRAGMA journal_mode=WAL")
        self._own.commit()

    @property
    def conn(self) -> sqlite3.Connection:
        scope = _current_scope.get()
        if scope is not None and scope.path == self.path and not scope.closed:
            return scope.conn
        return self._own

    @property
    def in_scope(self) -> bool:
        scope = _current_scope.get()
        return scope is not None and scope.path == self.path and not scope.closed

    def execute(self, sql: str, params=()):
        return self.conn.execute(sql, params)

    def executescript(self, script: str):
        # DDL must not ride (and implicitly commit) an operation scope
        assert not self.in_scope, "run schema DDL outside command scopes"
        return self._own.executescript(script)

    def commit(self) -> None:
        """Commit ONLY when no scope is active — the scope owns the real
        commit, which is what makes the op record atomic with the writes."""
        if not self.in_scope:
            self._own.commit()

    def close(self) -> None:
        self._own.close()


def attach_db_operation_scope(commander: "Commander", db_path: str) -> None:
    """Install the scope-provider filter: every top-level mutating command
    gets ONE transaction spanning its DAL writes and its operation record
    (≈ DbOperationScopeProvider.cs)."""
    commander.attach_operations_pipeline()
    db_path = os.path.realpath(db_path)
    # schema + WAL are set up ONCE here, not per command
    setup = sqlite3.connect(db_path, timeout=30.0)
    setup.execute("PRAGMA journal_mode=WAL")
    ensure_operations_schema(setup)
    setup.commit()
    setup.close()

    async def db_operation_scope_provider(command: Any, context: "CommandContext"):
        operation = context.items.get(Operation)
        if (
            operation is None  # nested command: rides the outer scope
            or isinstance(command, Completion)
            or is_invalidating()
        ):
            return await context.invoke_remaining_handlers()
        scope = SqliteOperationScope(db_path, operation, ensure_schema=False)
        context.items.set(scope, key=SqliteOperationScope)
        token = _current_scope.set(scope)
        try:
            result = await context.invoke_remaining_handlers()
            scope.commit()
            return result
        except BaseException:
            if not scope.committed:
                scope.rollback()
            raise
        finally:
            _current_scope.reset(token)
            scope.close()

    commander.registry.add_function(
        db_operation_scope_provider,
        command_type=object,
        priority=PRIORITY_DB_SCOPE_PROVIDER,
        is_filter=True,
    )
