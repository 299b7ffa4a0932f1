"""Small collection utilities: RecentlySeenMap, OptionSet.

Re-expressions of src/Stl/Collections/RecentlySeenMap.cs (dedup with
age+count bounds — the operation-completion dedup window) and
src/Stl/Collections/OptionSet.cs (typed per-context property bag used by
CommandContext.Items).

The reference's RefHashSetSlim1-4 inline-storage sets exist to avoid
allocation for tiny edge sets; CPython's ``set`` already pools small tables,
so graph edges here use plain sets — the device-side CSR mirror is where the
real edge-storage optimization lives (stl_fusion_tpu_torch.graph).
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, Generic, Hashable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

__all__ = ["RecentlySeenMap", "OptionSet"]


class RecentlySeenMap(Generic[T]):
    """Bounded has-this-been-seen map: capacity + max-age eviction."""

    def __init__(self, capacity: int = 10_000, max_age: float = 600.0, clock=None):
        self.capacity = capacity
        self.max_age = max_age
        self._clock = clock
        self._entries: "collections.OrderedDict[Hashable, Tuple[float, T]]" = collections.OrderedDict()

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else time.monotonic()

    def try_add(self, key: Hashable, value: T = None) -> bool:  # type: ignore[assignment]
        """True if key was new (and is now recorded); False if recently seen."""
        self._prune()
        if key in self._entries:
            return False
        self._entries[key] = (self._now(), value)
        return True

    def get(self, key: Hashable) -> Optional[T]:
        entry = self._entries.get(key)
        return entry[1] if entry is not None else None

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def _prune(self) -> None:
        now = self._now()
        cutoff = now - self.max_age
        while self._entries:
            key, (ts, _) = next(iter(self._entries.items()))
            if ts < cutoff or len(self._entries) >= self.capacity:
                self._entries.popitem(last=False)
            else:
                break


class OptionSet:
    """Typed property bag: one slot per key (usually a type)."""

    def __init__(self):
        self._items: Dict[Any, Any] = {}

    def get(self, key: Type[T]) -> Optional[T]:
        return self._items.get(key)

    def set(self, value: Any, key: Any = None) -> None:
        self._items[key if key is not None else type(value)] = value

    def remove(self, key: Any) -> None:
        self._items.pop(key, None)

    def __contains__(self, key: Any) -> bool:
        return key in self._items

    def __len__(self) -> int:
        return len(self._items)

    def keys(self):
        return self._items.keys()
