"""FusionTime — time as a dependency.

Re-expression of src/Stl.Fusion/Extensions/IFusionTime.cs +
Internal/FusionTime.cs: compute methods returning the current time that
auto-invalidate, so anything depending on them re-renders as time passes —
the canonical demonstration that ANY changing input can be a graph node.
"""
from __future__ import annotations

import time
from typing import Optional

from ..core.hub import FusionHub
from ..core.service import ComputeService, compute_method

__all__ = ["FusionTime"]


class FusionTime(ComputeService):
    def __init__(self, hub: Optional[FusionHub] = None, update_period: float = 1.0):
        super().__init__(hub)
        self.update_period = update_period

    @compute_method(auto_invalidation_delay=1.0)
    async def get_utc_now(self) -> float:
        """Epoch seconds; auto-invalidates every update period."""
        return time.time()

    @compute_method(auto_invalidation_delay=1.0)
    async def get_moments_ago(self, moment: float) -> str:
        """Human '5 seconds ago' string that keeps itself fresh."""
        delta = max(time.time() - moment, 0.0)
        for unit, size in (("day", 86400.0), ("hour", 3600.0), ("minute", 60.0)):
            if delta >= size:
                n = int(delta // size)
                return f"{n} {unit}{'s' if n != 1 else ''} ago"
        n = int(delta)
        return f"{n} second{'s' if n != 1 else ''} ago"
