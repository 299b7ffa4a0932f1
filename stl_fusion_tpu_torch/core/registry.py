"""ComputedRegistry — THE graph store: weak interning map input → node.

Re-expression of src/Stl.Fusion/ComputedRegistry.cs:10-231. Holds a weak
reference per input (nodes die when nothing uses them — keep-alive timers and
dependents hold the strong refs), the per-input async locks that make
computation single-flight, and access/register events that feed diagnostics
(FusionMonitor) and the device-graph mirror.

The reference prunes dead GCHandles stochastically on an op counter; here
weakref callbacks remove entries eagerly, and ``prune()`` remains for edge
pruning sweeps (ComputedGraphPruner).
"""
from __future__ import annotations

import threading
import weakref
from typing import TYPE_CHECKING, Callable, List, Optional

from ..utils.async_utils import AsyncLockSet

if TYPE_CHECKING:
    from .computed import Computed
    from .inputs import ComputedInput

__all__ = ["ComputedRegistry"]


class ComputedRegistry:
    def __init__(self):
        self._map: dict = {}
        self._lock = threading.Lock()
        #: per-input single-flight compute locks (≈ InputLocks, ComputedRegistry.cs:31)
        self.input_locks = AsyncLockSet("compute")
        self.on_register: List[Callable[["Computed"], None]] = []
        self.on_unregister: List[Callable[["Computed"], None]] = []
        self.on_access: List[Callable[["ComputedInput"], None]] = []
        #: amortized count of memoized-hit FAST-path reads (the per-service
        #: hot cache bypasses ``get``/``on_access`` entirely; it bumps this
        #: by 16 on every 16th hit — the renewal cadence — so monitors keep
        #: a truthful access total without putting a hook on the hot path)
        self.fast_hits = 0

    def __len__(self) -> int:
        return len(self._map)

    def get(self, input: "ComputedInput") -> Optional["Computed"]:
        ref = self._map.get(input)
        computed = ref() if ref is not None else None
        for h in self.on_access:
            h(input)
        return computed

    def peek(self, input: "ComputedInput") -> Optional["Computed"]:
        """``get`` without the on_access hooks — internal bookkeeping probes
        (the hot-cache population after a miss, the under-lock RETRY-READ,
        the wrapper's pre-invoke check) must not multi-count one logical
        access in monitors."""
        ref = self._map.get(input)
        return ref() if ref is not None else None

    def count_access(self, input: "ComputedInput") -> None:
        """Fire the on_access hooks for an access served from a peek."""
        for h in self.on_access:
            h(input)

    def register(self, computed: "Computed") -> None:
        """Intern ``computed``; a displaced live entry is invalidated
        (reference Register, ComputedRegistry.cs:72-105)."""
        input = computed.input
        displaced: Optional["Computed"] = None
        with self._lock:
            old_ref = self._map.get(input)
            old = old_ref() if old_ref is not None else None
            if old is not None and old is not computed:
                displaced = old

            def _on_dead(ref, _input=input, _self=self):
                with _self._lock:
                    if _self._map.get(_input) is ref:
                        del _self._map[_input]

            self._map[input] = weakref.ref(computed, _on_dead)
        if displaced is not None and not displaced.is_invalidated:
            displaced.invalidate(immediately=True)
        for h in self.on_register:
            h(computed)

    def unregister(self, computed: "Computed") -> bool:
        with self._lock:
            ref = self._map.get(computed.input)
            if ref is None or ref() is not computed:
                return False
            del self._map[computed.input]
        for h in self.on_unregister:
            h(computed)
        return True

    def invalidate_everything(self) -> None:
        """(reference InvalidateEverything, ComputedRegistry.cs:142-147)"""
        with self._lock:
            refs = list(self._map.values())
        for ref in refs:
            c = ref()
            if c is not None:
                c.invalidate(immediately=True)

    def prune(self) -> int:
        """Drop dead refs + prune stale _usedBy edges of live nodes; returns
        edges removed (reference Prune, ComputedRegistry.cs:149-158 +
        ComputedGraphPruner sweep)."""
        with self._lock:
            items = list(self._map.items())
        removed_edges = 0
        for input, ref in items:
            c = ref()
            if c is None:
                with self._lock:
                    if self._map.get(input) is ref:
                        del self._map[input]
            else:
                removed_edges += c.prune_used_by()
        return removed_edges

    def live_computeds(self) -> List["Computed"]:
        with self._lock:
            return [c for ref in self._map.values() if (c := ref()) is not None]
