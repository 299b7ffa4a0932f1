"""ComputedOptions — per-method caching/invalidation knobs.

Re-expression of src/Stl.Fusion/ComputedOptions.cs:5-66:
- ``min_cache_duration``: keep a strong reference to the node this long after
  each access (keep-alive timer), so it survives GC even with no dependents;
- ``auto_invalidation_delay``: invalidate automatically this long after each
  successful compute (the "time as a dependency" device, e.g. FusionTime);
- ``invalidation_delay``: debounce — an invalidate() call schedules the real
  invalidation after this delay instead of firing immediately;
- ``transient_error_invalidation_delay``: errors are memoized too, but only
  this long (default 1 s) so transient failures self-heal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional

__all__ = ["ComputedOptions"]

_INF = float("inf")


@dataclass(frozen=True)
class ComputedOptions:
    # The reference leaves MinCacheDuration=0 and relies on .NET's lazy GC to
    # keep hot nodes alive between accesses; CPython refcounting frees them
    # instantly, so a nonzero default keep-alive is required for memoization
    # to exist at all. Explicit 0 restores pure-weak semantics.
    min_cache_duration: float = 60.0
    auto_invalidation_delay: float = _INF  # inf = never
    invalidation_delay: float = 0.0
    transient_error_invalidation_delay: float = 1.0

    DEFAULT: ClassVar["ComputedOptions"]
    # Client-side default mirrors the reference's 1-minute ClientDefault
    # (ComputedOptions.cs:8-11)
    CLIENT_DEFAULT: ClassVar["ComputedOptions"]

    @property
    def has_auto_invalidation(self) -> bool:
        return self.auto_invalidation_delay != _INF

    @staticmethod
    def new(
        min_cache_duration: Optional[float] = None,
        auto_invalidation_delay: Optional[float] = None,
        invalidation_delay: Optional[float] = None,
        transient_error_invalidation_delay: Optional[float] = None,
        base: Optional["ComputedOptions"] = None,
    ) -> "ComputedOptions":
        b = base or ComputedOptions.DEFAULT
        return ComputedOptions(
            min_cache_duration if min_cache_duration is not None else b.min_cache_duration,
            auto_invalidation_delay if auto_invalidation_delay is not None else b.auto_invalidation_delay,
            invalidation_delay if invalidation_delay is not None else b.invalidation_delay,
            transient_error_invalidation_delay
            if transient_error_invalidation_delay is not None
            else b.transient_error_invalidation_delay,
        )


ComputedOptions.DEFAULT = ComputedOptions()
ComputedOptions.CLIENT_DEFAULT = ComputedOptions(min_cache_duration=60.0)
