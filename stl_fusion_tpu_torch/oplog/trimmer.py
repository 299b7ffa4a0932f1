"""OperationLogTrimmer — background op-log GC.

Re-expression of src/Stl.Fusion.EntityFramework/Operations/
DbOperationLogTrimmer.cs: a periodic worker that drops operation records
older than ``max_age`` so the durable log stays bounded. Readers keep
commit-time watermarks (reader.py), so trimming behind every host's
watermark is safe; ``max_age`` should exceed the reader's max commit age.

Two guards clamp the cutoff, and the trim respects the MIN of both:

- ``quarantine_guard`` — never trim past a quarantined corrupt row
  (the evidence must outlive GC).
- ``snapshot_guard`` — never trim the replay tail above a
  retained snapshot's watermark: a warm rejoin restores the snapshot and
  replays exactly the entries above it; trimming them strands the member
  with a permanently stale warm state. Anything exposing
  ``snapshot_floor() -> Optional[float]`` fits (CheckpointManager does).
"""
from __future__ import annotations

import logging
import time
from typing import Optional

from ..utils.async_chain import WorkerBase
from ..utils.moment import MomentClock
from .log import OperationLog

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["OperationLogTrimmer"]


class OperationLogTrimmer(WorkerBase):
    def __init__(
        self,
        log_store: OperationLog,
        max_age: float = 600.0,
        check_period: float = 60.0,
        clock: Optional[MomentClock] = None,
        quarantine_guard=None,
        snapshot_guard=None,
    ):
        super().__init__(name="oplog-trimmer")
        self.log_store = log_store
        self.max_age = max_age
        self.check_period = check_period
        self.clock = clock
        #: an OperationLogReader (or anything with ``quarantine_floor() ->
        #: Optional[float]``): the trimmer never trims past a quarantined
        #: range — the evidence of a torn/corrupt row must outlive the GC
        #: so operators can inspect it and cold-boot readers can replay a
        #: repaired row
        self.quarantine_guard = quarantine_guard
        #: a CheckpointManager (or anything with ``snapshot_floor() ->
        #: Optional[float]``): the trimmer never trims the replay tail a
        #: retained snapshot's warm rejoin still needs
        self.snapshot_guard = snapshot_guard
        self.trimmed_total = 0
        self.clamped_trims = 0
        self.snapshot_clamped_trims = 0

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else time.time()

    def trim_once(self) -> int:
        cutoff = self._now() - self.max_age
        if self.quarantine_guard is not None:
            floor = self.quarantine_guard.quarantine_floor()
            if floor is not None and floor < cutoff:
                cutoff = floor
                self.clamped_trims += 1
        if self.snapshot_guard is not None:
            floor = self.snapshot_guard.snapshot_floor()
            if floor is not None and floor < cutoff:
                cutoff = floor
                self.snapshot_clamped_trims += 1
        removed = self.log_store.trim_before(cutoff)
        self.trimmed_total += removed
        if removed:
            log.debug("oplog trimmer removed %d records", removed)
        return removed

    async def on_run(self) -> None:
        import asyncio

        while True:
            self.trim_once()
            if self.clock is not None:
                await self.clock.delay(self.check_period)  # TestClock-drivable
            else:
                await asyncio.sleep(self.check_period)
