"""ConsistencyState — the 3-state computed lifecycle.

Re-expression of src/Stl.Fusion/ConsistencyState.cs:
Computing → Consistent → Invalidated, strictly forward.
The numeric values double as the node-state lane in the device CSR mirror
(stl_fusion_tpu.graph), so keep them stable.
"""
from __future__ import annotations

import enum

__all__ = ["ConsistencyState"]


class ConsistencyState(enum.IntEnum):
    COMPUTING = 0
    CONSISTENT = 1
    INVALIDATED = 2
