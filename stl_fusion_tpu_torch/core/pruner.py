"""ComputedGraphPruner — background stale-edge sweep.

Re-expression of src/Stl.Fusion/Internal/ComputedGraphPruner.cs:5-111:
periodically walks the registry, drops dead weak entries, and prunes
``_used_by`` edges whose dependents no longer resolve to the recorded
version. Keeps the host graph (and therefore the device CSR mirror, which
rebuilds from it) from accumulating garbage under churn.
"""
from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from ..utils.async_chain import WorkerBase

if TYPE_CHECKING:
    from .hub import FusionHub

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["ComputedGraphPruner"]


class ComputedGraphPruner(WorkerBase):
    def __init__(self, hub: "FusionHub", check_period: float = 600.0, batch_size: int = 4096):
        super().__init__("computed-graph-pruner")
        self.hub = hub
        self.check_period = check_period
        self.batch_size = batch_size
        self.pruned_edges_total = 0

    async def on_run(self) -> None:
        while True:
            await self.hub.clocks.cpu.delay(self.check_period)
            removed = await self.prune_once()
            if removed:
                log.debug("graph pruner removed %d stale edges", removed)

    async def prune_once(self) -> int:
        """One full sweep, yielding between batches to stay off the hot path."""
        live = self.hub.registry.live_computeds()
        removed = 0
        for i, computed in enumerate(live):
            removed += computed.prune_used_by()
            if i % self.batch_size == self.batch_size - 1:
                await asyncio.sleep(0)
        removed += 0 if live else self.hub.registry.prune()
        self.pruned_edges_total += removed
        if removed:
            from ..diagnostics.flight_recorder import RECORDER

            if RECORDER.enabled:
                # one event per sweep, not per edge — the flight journal
                # answers "did pruning run, how much did it drop"
                RECORDER.note(
                    "pruned",
                    key="registry",
                    detail=f"{removed} stale used_by edges over {len(live)} nodes",
                )
        return removed
