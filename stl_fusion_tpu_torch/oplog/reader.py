"""Operation-log reader + change notifiers — cross-host invalidation.

Re-expression of src/Stl.Fusion.EntityFramework/Operations/
DbOperationLogReader.cs:7-128 and the change-notifier family (Npgsql NOTIFY,
Redis pub/sub, file watcher — §2.6): each host runs a reader that tails the
shared log from a position watermark, filters out its OWN operations
(agent_id match, :85-92), and feeds external ones into the local
OperationCompletionNotifier — whose CompletionProducer →
PostCompletionInvalidator pipeline replays them as invalidations, exactly
like local completions.

Notifiers wake the reader without polling; the in-process ``LocalChangeNotifier``
is the test/fan-out default, ``FileChangeNotifier`` watches a touch-file
(≈ FileBasedDbOperationLogChangeNotifier) for cross-process setups.
"""
from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import TYPE_CHECKING, Callable, List, Optional, Tuple

import contextlib

from dataclasses import dataclass

from ..diagnostics.flight_recorder import RECORDER
from ..diagnostics.tracing import get_activity_source
from ..operations.operation import Operation
from ..operations.pipeline import batch_cascade_scope
from ..resilience.events import ResilienceEvents, global_events
from ..utils.async_chain import WorkerBase
from .log import CorruptRecord, OperationLog, OperationRecord

if TYPE_CHECKING:
    from ..operations.pipeline import OperationsHost

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "OperationLogReader",
    "LocalChangeNotifier",
    "FileChangeNotifier",
    "QuarantinedRange",
    "attach_operation_log",
]


@dataclass(frozen=True)
class QuarantinedRange:
    """A log index range the reader skipped instead of halting on: a
    corrupt/truncated row, or a gap in the index sequence (rows that
    vanished mid-log — a torn write or external deletion). ``commit_floor``
    is the newest commit time known to be ≤ the range. ``clamps_trimmer``
    marks ranges with something left to PROTECT: a corrupt row is evidence
    a repaired cold boot can still replay, so the trimmer refuses to trim
    past it; a gap's rows are already gone (and commit-time/idx ordering
    skew can make a routine trim look like a mid-batch gap), so gaps are
    recorded as telemetry but never block GC."""

    first_index: int
    last_index: int
    commit_floor: Optional[float]
    reason: str
    clamps_trimmer: bool = True


class LocalChangeNotifier:
    """In-process wakeup fan-out (multi-"host" single-process tests)."""

    def __init__(self):
        self._events: List[asyncio.Event] = []

    def subscribe(self) -> asyncio.Event:
        ev = asyncio.Event()
        self._events.append(ev)
        return ev

    def notify(self) -> None:
        for ev in self._events:
            ev.set()


class FileChangeNotifier:
    """Touch-file wakeup for cross-process hosts sharing a log file."""

    def __init__(self, path: str):
        self.path = path
        self._local = LocalChangeNotifier()
        self._last_token: Tuple[float, int] = (0.0, -1)

    def subscribe(self) -> asyncio.Event:
        return self._local.subscribe()

    def notify(self) -> None:
        # the appended byte makes the file SIZE a shared monotonic token:
        # two notifies inside one clock tick (coarse-granularity filesystems
        # tick ~10ms here), or from two processes with skewed clocks, would
        # collide on mtime alone and silently drop a cross-process wakeup.
        # Growth is one byte per commit notification — negligible next to
        # the operation log it accompanies (and truncating the file is safe:
        # a size DECREASE also changes the token).
        with open(self.path, "a") as f:
            f.write(".")
        os.utime(self.path, None)
        self._local.notify()

    def poll(self) -> bool:
        try:
            st = os.stat(self.path)
        except OSError:
            return False
        token = (st.st_mtime, st.st_size)
        if token != self._last_token:
            self._last_token = token
            self._local.notify()
            return True
        return False


class OperationLogReader(WorkerBase):
    def __init__(
        self,
        log_store: OperationLog,
        operations: "OperationsHost",
        notifier=None,
        poll_period: float = 0.25,
        start_from_end: bool = True,
        batch_size: int = 1024,
        start_position: Optional[int] = None,
        mesh=None,
        events: Optional[ResilienceEvents] = None,
    ):
        super().__init__("oplog-reader")
        self.log_store = log_store
        self.operations = operations
        self.notifier = notifier
        self.poll_period = poll_period
        self.batch_size = batch_size
        self.events = events if events is not None else global_events()
        #: ranges skipped instead of halting on (corrupt rows, index gaps);
        #: the trimmer's quarantine guard reads quarantine_floor() off this
        self.quarantined: List[QuarantinedRange] = []
        self.corrupt_seen = 0
        self.gaps_seen = 0
        self._last_commit_time: Optional[float] = None
        #: optional :func:`~..parallel.mesh.graph_mesh`: external-operation
        #: lane replay runs on the mesh (invalidate_cascade_batch_lanes_sharded)
        #: — N external commands cost one packed mesh wave
        self.mesh = mesh
        # explicit position (checkpoint resume) > tail-from-end > full replay
        if start_position is not None:
            self.watermark = start_position
        else:
            self.watermark = log_store.last_index() if start_from_end else 0
        self.external_seen = 0
        # reader-lag gauge for /metrics: how far this reader's
        # watermark trails the writer's last index — THE cross-host
        # staleness number. Weak-registered; a dead reader drops out.
        from ..diagnostics.metrics import global_metrics

        global_metrics().register_collector(self, OperationLogReader._collect_metrics)
        # non-additive: the WORST reader's lag, never the sum over readers
        global_metrics().set_aggregation("fusion_oplog_reader_lag", "max")

    def _collect_metrics(self) -> dict:
        try:
            lag = max(self.log_store.last_index() - self.watermark, 0)
        except Exception:  # noqa: BLE001 — a failing store must not kill a scrape
            lag = -1
        return {
            "fusion_oplog_reader_lag": lag,
            "fusion_oplog_external_seen_total": self.external_seen,
            "fusion_oplog_corrupt_seen_total": self.corrupt_seen,
            "fusion_oplog_gaps_seen_total": self.gaps_seen,
        }

    async def on_run(self) -> None:
        wake = self.notifier.subscribe() if self.notifier is not None else None
        # file-backed notifiers only learn about OTHER processes' commits by
        # polling the touch-file mtime, so they poll at poll_period; purely
        # local notifiers wake on the event and keep a 4x safety poll only
        pollable = hasattr(self.notifier, "poll")
        while True:
            await self.read_new()
            if wake is not None:
                timeout = self.poll_period if pollable else self.poll_period * 4
                try:
                    await asyncio.wait_for(wake.wait(), timeout)
                except asyncio.TimeoutError:
                    pass  # safety poll: progress even on missed notifications
                wake.clear()
                if pollable:
                    self.notifier.poll()
            else:
                await asyncio.sleep(self.poll_period)

    async def read_new(self) -> int:
        """Tail from the watermark; feed EXTERNAL operations to completion.

        When the hub has a device graph backend, a batch of external
        operations lane-packs: each operation's replay COLLECTS its
        directly-invalidated computeds (``invalidating(sink=...)``) as one
        group, and the whole batch cascades in one device lane burst
        (``invalidate_cascade_batch_lanes``) — the production consumer of
        the lane path: N external commands cost one mirror sweep, not N
        host cascades. Without a backend the replay cascades host-side per
        operation, exactly as before."""
        handled = 0
        backend = getattr(self.operations.commander.hub, "graph_backend", None)
        while True:
            records = self.log_store.read_after(self.watermark, self.batch_size)
            if not records:
                return handled
            groups: List[List] = []
            scope = (
                batch_cascade_scope(groups.append)
                if backend is not None
                else contextlib.nullcontext()
            )
            # a gap is only trustworthy INSIDE one read batch (the store
            # returned rows on both sides of a hole in ONE query): rows
            # missing ACROSS batches — or before the first record — may have
            # been legitimately trimmed while this reader lagged, and a
            # false gap would clamp the trimmer at its commit floor forever
            prev_index: Optional[int] = None
            try:
                with scope:
                    for rec in records:
                        if prev_index is not None and rec.index > prev_index + 1:
                            self.gaps_seen += 1
                            self._quarantine(
                                prev_index + 1, rec.index - 1,
                                self._last_commit_time,
                                "index gap", "oplog_gap",
                                clamps_trimmer=False,
                            )
                        prev_index = rec.index
                        self.watermark = max(self.watermark, rec.index)
                        if isinstance(rec, CorruptRecord):
                            # torn/garbled row: quarantine + RESUME at the
                            # next good watermark instead of halting the
                            # whole invalidation fan-out on one bad write
                            self._quarantine(
                                rec.index, rec.index,
                                rec.commit_time or self._last_commit_time,
                                f"corrupt: {rec.error}", "oplog_corrupt",
                            )
                            self.corrupt_seen += 1
                            continue
                        self._last_commit_time = rec.commit_time
                        if rec.agent_id == self.operations.agent.id:
                            continue  # our own operation: already completed locally
                        self.external_seen += 1
                        operation = Operation(
                            command=rec.command,
                            agent_id=rec.agent_id,
                            id=rec.id,
                            commit_time=rec.commit_time,
                            items=list(rec.items),
                            cause_id=rec.cause,
                        )
                        if rec.cause:
                            # cross-host command attribution: the origin
                            # member journaled the command span's cause id;
                            # teaching the local trace store the label lets
                            # stitch()/explain() on THIS host name the
                            # originating command too
                            from ..diagnostics.mesh_telemetry import global_mesh_trace

                            global_mesh_trace().note_command(
                                rec.cause,
                                f"{type(rec.command).__name__} "
                                f"(op {rec.id[:8]}, agent {rec.agent_id})",
                            )
                        if RECORDER.enabled:
                            # the flight-journal join point for cross-host
                            # causality: explain() resolves "via oplog entry
                            # E on host H" from these
                            RECORDER.note(
                                "oplog_replayed",
                                key=f"oplog:{rec.agent_id}",
                                oplog=rec.index,
                                detail=type(rec.command).__name__,
                            )
                        # replay under a span: host-led invalidations this
                        # completion cascades stamp a cause id naming the
                        # originating oplog record (computed.py stamps from
                        # the open span); recorder events auto-carry the
                        # index via current_oplog
                        prev_oplog = RECORDER.current_oplog
                        RECORDER.current_oplog = rec.index
                        try:
                            with get_activity_source("oplog").span(
                                "replay", index=rec.index, agent=rec.agent_id
                            ):
                                await self.operations.notify_completed(
                                    operation, is_local=False
                                )
                        finally:
                            RECORDER.current_oplog = prev_oplog
                        handled += 1
            finally:
                # the watermark has already advanced past collected records —
                # a cancellation mid-batch (reader.stop()) must still apply
                # what was collected, or those operations' invalidations
                # would be lost forever (replay never revisits them)
                if groups and any(groups):
                    # the burst covers every record of this batch; the span
                    # names the range so lane-wave causes resolve to it
                    with get_activity_source("oplog").span(
                        "batch", upto=self.watermark, groups=len(groups)
                    ):
                        if self.mesh is not None:
                            backend.invalidate_cascade_batch_lanes_sharded(
                                groups, mesh=self.mesh
                            )
                        else:
                            backend.invalidate_cascade_batch_lanes(groups)

    # ------------------------------------------------------------------ quarantine
    def _quarantine(
        self,
        first: int,
        last: int,
        commit_floor: Optional[float],
        reason: str,
        kind: str,
        clamps_trimmer: bool = True,
    ) -> None:
        rng = QuarantinedRange(first, last, commit_floor, reason, clamps_trimmer)
        self.quarantined.append(rng)
        self.events.record(kind, f"[{first}, {last}] {reason}")
        log.warning("oplog reader quarantined [%d, %d]: %s", first, last, reason)

    def quarantine_floor(self) -> Optional[float]:
        """Oldest commit time the trimmer must PRESERVE: the minimum commit
        floor across trimmer-clamping quarantined ranges (None when nothing
        clamps; 0.0 — trim nothing — when a clamping range couldn't be
        dated). Gap ranges never clamp: their rows are already gone, and a
        false gap (trim vs commit-time/idx skew) must not disable GC."""
        floors = [r.commit_floor for r in self.quarantined if r.clamps_trimmer]
        if not floors:
            return None
        return 0.0 if any(f is None for f in floors) else min(floors)

    def clear_quarantine(self) -> int:
        """Operator reset after inspecting (or repairing) quarantined rows:
        forget the ranges so the trimmer resumes normal GC. Returns the
        number of ranges dropped."""
        n = len(self.quarantined)
        self.quarantined.clear()
        return n


def attach_operation_log(
    commander,
    log_store: OperationLog,
    notifier=None,
    start_reader: bool = True,
    start_position: Optional[int] = None,
    mesh=None,
) -> OperationLogReader:
    """Wire a commander's operations pipeline to a durable log:
    - local completions append to the log (+ notify),
    - a reader replays external completions from other hosts
      (``mesh=`` routes the lane replay over the device mesh).
    """
    commander.attach_operations_pipeline()
    operations = commander.operations

    async def persist(operation) -> None:
        self_rec = OperationRecord(
            id=operation.id,
            agent_id=operation.agent_id,
            commit_time=operation.commit_time or time.time(),
            command=operation.command,
            items=tuple(operation.items),
            cause=getattr(operation, "cause_id", None),
        )
        log_store.append(self_rec)
        if notifier is not None:
            notifier.notify()

    operations.commit_listeners.append(persist)
    reader = OperationLogReader(
        log_store, operations, notifier, start_position=start_position, mesh=mesh
    )
    if start_reader:
        reader.start()
    return reader
