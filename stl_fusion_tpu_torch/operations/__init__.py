"""Operations framework — invalidation-from-commands (SURVEY.md §2.2)."""
from .operation import AgentInfo, Completion, Operation
from .pipeline import OperationsHost, attach_operations

__all__ = ["AgentInfo", "Completion", "Operation", "OperationsHost", "attach_operations"]
