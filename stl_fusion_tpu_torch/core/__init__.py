"""L1 — the computed-graph runtime (the heart).

Versioned memoized nodes, transparent dependency capture, cascading
invalidation. See SURVEY.md §2.1 for the reference component map this layer
re-expresses (src/Stl.Fusion)."""
from .anonymous import AnonymousComputedSource
from .computed import Computed
from .consistency import ConsistencyState
from .context import (
    CallOptions,
    ComputeContext,
    capture,
    change_current,
    get_current,
    get_existing,
    invalidating,
    is_invalidating,
    suspend_dependency_capture,
    try_capture,
)
from .function import ComputeMethodFunction, FunctionBase
from .hub import FusionHub, default_hub, set_default_hub
from .inputs import ComputedInput, ComputeMethodInput
from .options import ComputedOptions
from .pruner import ComputedGraphPruner
from .registry import ComputedRegistry
from .service import (
    ComputeMethodDef,
    ComputeService,
    InternKeyCodec,
    TableBacking,
    compute_method,
    hub_of,
    memo_table_of,
)
from .timeouts import Timeouts

__all__ = [
    "AnonymousComputedSource",
    "Computed",
    "ConsistencyState",
    "CallOptions",
    "ComputeContext",
    "capture",
    "change_current",
    "get_current",
    "get_existing",
    "invalidating",
    "is_invalidating",
    "suspend_dependency_capture",
    "try_capture",
    "ComputeMethodFunction",
    "FunctionBase",
    "FusionHub",
    "default_hub",
    "set_default_hub",
    "ComputedInput",
    "ComputeMethodInput",
    "ComputedOptions",
    "ComputedGraphPruner",
    "ComputedRegistry",
    "ComputeMethodDef",
    "ComputeService",
    "InternKeyCodec",
    "TableBacking",
    "compute_method",
    "memo_table_of",
    "hub_of",
    "Timeouts",
]
