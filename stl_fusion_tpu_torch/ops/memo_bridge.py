"""MemoTableBridge — scalar-graph dependencies on MemoTable rows.

Connects the columnar read path (ops/memo_table.py) to the host `Computed`
graph so both memoization worlds cascade together: a `@compute_method` that
aggregates over table rows declares its dependency via this bridge, and
`table.invalidate(ids)` then invalidates exactly the scalar nodes that used
those rows — which in turn fan out through the object graph / device wave
like any other invalidation.

Granularity is the caller's choice (the same trade every columnar system
makes):

- ``use_table()`` — one coarse leaf for the whole table; any row
  invalidation cascades. Right for whole-table aggregates.
- ``use_rows(ids)`` — per-row leaf states, created lazily; only those rows'
  invalidations cascade. Right for reads of a few hot keys. Rows that never
  had a scalar dependent cost nothing (the invalidation handler only
  touches leaves that exist).

Leaves are `MutableState` nodes carrying the table/row version — the same
settable-source machinery the reference uses for graph inputs
(State/MutableState.cs:14-175), so no new node mechanics are introduced.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from ..core.hub import FusionHub, default_hub
from ..state.mutable import MutableState
from .memo_table import MemoTable

__all__ = ["MemoTableBridge"]


class MemoTableBridge:
    def __init__(self, table: MemoTable, hub: Optional[FusionHub] = None, name: str = "memo"):
        self.table = table
        self.hub = hub or default_hub()
        self.name = name
        self._table_state: Optional[MutableState] = None
        self._row_states: Dict[int, MutableState] = {}
        table.on_invalidate.append(self._on_invalidate)
        self._attached = True

    def detach(self) -> None:
        """Unsubscribe from the table and drop the leaf states. A bridge
        that outlives its consumers must be detached, or every
        ``table.invalidate`` keeps cascading into a graph nobody reads."""
        if self._attached:
            self._attached = False
            try:
                self.table.on_invalidate.remove(self._on_invalidate)
            except ValueError:
                pass
            self._row_states.clear()
            self._table_state = None

    # ------------------------------------------------------------------ deps
    async def use_table(self) -> int:
        """Register a whole-table dependency on the ambient computing node;
        returns the table version."""
        if self._table_state is None:
            self._table_state = MutableState(
                self.table.version, self.hub, name=f"{self.name}-table"
            )
        return await self._table_state.use()

    async def use_rows(self, ids: Iterable[int]) -> None:
        """Register per-row dependencies on the ambient computing node."""
        for i in ids:
            i = int(i)
            state = self._row_states.get(i)
            if state is None:
                state = self._row_states[i] = MutableState(
                    self.table.version, self.hub, name=f"{self.name}-row{i}"
                )
            await state.use()

    # ------------------------------------------------------------------ cascade
    def _on_invalidate(self, ids: np.ndarray) -> None:
        version = self.table.version
        if self._table_state is not None:
            self._table_state.set(version)
        row_states = self._row_states
        if row_states:
            if len(ids) < len(row_states):
                hits = (row_states.get(int(i)) for i in ids)
            else:
                id_set = set(int(i) for i in ids)
                hits = (s for i, s in row_states.items() if i in id_set)
            for state in hits:
                if state is not None:
                    state.set(version)

    def live_row_leaves(self) -> int:
        return len(self._row_states)
