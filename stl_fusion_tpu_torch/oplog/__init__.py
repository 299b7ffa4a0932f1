"""Durable operation log + multi-host invalidation (SURVEY.md §2.6)."""
from .entity_resolver import EntityResolver
from .log import (
    CorruptRecord,
    InMemoryOperationLog,
    OperationLog,
    OperationRecord,
    SqliteOperationLog,
)
from .trimmer import OperationLogTrimmer
from .scope import (
    ScopedSqliteDb,
    SqliteOperationScope,
    attach_db_operation_scope,
    current_operation_scope,
)
from .reader import (
    FileChangeNotifier,
    LocalChangeNotifier,
    OperationLogReader,
    QuarantinedRange,
    attach_operation_log,
)

__all__ = [
    "CorruptRecord",
    "EntityResolver",
    "InMemoryOperationLog",
    "OperationLog",
    "OperationRecord",
    "SqliteOperationLog",
    "FileChangeNotifier",
    "LocalChangeNotifier",
    "OperationLogReader",
    "OperationLogTrimmer",
    "QuarantinedRange",
    "attach_operation_log",
    "ScopedSqliteDb",
    "SqliteOperationScope",
    "attach_db_operation_scope",
    "current_operation_scope",
]
