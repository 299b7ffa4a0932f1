"""Operation records + completion commands.

Re-expression of src/Stl.Fusion/Operations/ IOperation/TransientOperation
(Id, AgentId, StartTime/CommitTime, Command, Items = nested-command log) and
``Completion`` — the command that re-enters the pipeline after an operation
commits, locally or from another host via the operation log.
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, List, Optional

__all__ = ["Operation", "Completion", "AgentInfo"]


@dataclass(frozen=True)
class AgentInfo:
    """Unique per-process identity — distinguishes local vs external
    operations (reference: Operations/AgentInfo.cs)."""

    id: str = field(default_factory=lambda: f"agent-{uuid.uuid4().hex[:12]}")


@dataclass
class Operation:
    command: Any
    agent_id: str
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    start_time: float = field(default_factory=time.time)
    commit_time: Optional[float] = None
    #: nested commands executed inside this operation (replayed on invalidation)
    items: List[Any] = field(default_factory=list)
    #: originating span/wave cause id — stamped by the cluster
    #: commander so a journaled operation can be joined back to the command
    #: span that minted it (and, both directions over the oplog, so remote
    #: replays attribute their stitched wave timelines to the command)
    cause_id: Optional[str] = None

    @property
    def is_committed(self) -> bool:
        return self.commit_time is not None


@dataclass(frozen=True)
class Completion:
    """``Completion.New(operation)`` — same code path for local and external
    (other-host) operations (reference: Operations/Internal/CompletionProducer.cs:29-51)."""

    operation: Operation

    @property
    def command(self) -> Any:
        return self.operation.command
