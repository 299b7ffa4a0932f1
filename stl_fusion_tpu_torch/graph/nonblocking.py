"""WavePipeline — GraphBLAS-style nonblocking wave execution.

Port of ``stl_fusion_tpu/graph/nonblocking.py``. Every dispatched wave pays
a host round trip (the readback, then the host-side fence fan-out
serialised behind it); this pipeline, modeled on nonblocking GraphBLAS
execution and Tascade's asynchronous reduction trees (PAPERS.md), fuses
consecutive waves and overlaps the fan-out with device execution:

- **Lazy seed accumulation** — ``submit()`` enqueues a logical wave (one
  invalidation intent's seed set) instead of minting a device dispatch
  per call. ``Computed.invalidate_eventually`` and
  ``FusionHub.enable_nonblocking`` are the entry points.
- **Wave-chain fusion** — at dispatch, the accumulated logical waves
  compile into ONE loop-carried device chain
  (``DeviceGraph.dispatch_waves_lanes_chain``, on the card one CUDA graph
  replay per 8 waves): wave ``i`` cascades against the state waves ``< i``
  left, exactly as if each had been dispatched alone.
- **Dispatch/drain overlap** — ``dispatch()`` returns without reading
  anything back. The NEXT dispatch (or an explicit ``drain()``) harvests
  the previous chain: while chain N executes on device, the host unpacks
  chain N-1's per-wave newly-masks and drains them into the RPC fan-out
  (per-peer outbox batches), so fence fan-out no longer serializes with
  device execution. ``backend.overlap_active`` is raised around the
  overlapped apply — the fan-out index counts fences drained inside the
  window, and ``overlap_occupancy()`` reports the fraction of host apply
  time that ran concurrently with device execution.

An attached watchdog (``backend.watchdog``, a ``WaveWatchdog``) takes part
as the fallbacks below say: its armed fault fails the next dispatch, a chain
that raises at dispatch or at harvest degrades it, and while it is degraded
dispatches run its split host loop. With mesh routing on
(``backend.enable_mesh_routing``) the chain is the routed union chain
(``RoutedShardedGraph.dispatch_union_chain``): cross-shard frontiers resolve
on the device inside the dispatch, never through the per-key host relay.

**Consistency contract** (the nonblocking-mode tradeoff, stated plainly):
between ``submit()`` and the harvest of its chain, the submitted seeds'
transitive dependents still read CONSISTENT — the wave has not been
applied anywhere. ``drain()`` is the barrier; burst-style callers
(command completion storms, the live bench loop) drain before dependent
reads. Per-logical-wave identity survives fusion: every wave keeps its
own seq (the dispatch stamps a contiguous span), recorder events during
its apply carry that seq, and the profiler record notes ``fused_depth`` —
``explain(key)`` names the logical wave inside the chain.

**Fallbacks** (never silent — counted and observable):
- a mirror that cannot serve the fused path (invalid, or carrying more
  sweep passes than the one-dispatch programs cover) routes the chain to
  EAGER per-wave dispatch (``eager_waves`` counter; the CI live smoke
  asserts the fused histogram engaged, so a silent regression to eager
  fails the build);
- a chain dispatch or harvest that RAISES is contained exactly like the
  watchdog's fused bursts: the waves re-run on the split host loop
  (dense per-wave BFS — invalidation is idempotent, a partially-applied
  chain is absorbed), the attached ``WaveWatchdog`` (if any) degrades,
  and ``chain_faults`` counts the incident;
- while a watchdog is degraded (``mode == "host"``) dispatches run the
  host loop directly and count toward its recovery window.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import TYPE_CHECKING, Deque, List, Optional, Sequence

from ..diagnostics.metrics import global_metrics
from .program_cache import NotFusible

if TYPE_CHECKING:
    from ..core.computed import Computed
    from .backend import RowBlock, TpuGraphBackend

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["WavePipeline", "WaveTicket"]


class WaveTicket:
    """One logical wave riding the pipeline: its seed set at submit time,
    and — once its chain is harvested — the newly-invalidated count and
    the wave seq the fused dispatch stamped for it."""

    __slots__ = ("seeds", "count", "seq", "fallback", "done", "cause")

    def __init__(self, seeds: List[int], fallback: int = 0):
        self.seeds = seeds
        self.fallback = fallback  # computeds invalidated host-side at submit
        self.count: Optional[int] = None
        self.seq: Optional[int] = None
        self.done = False
        #: the fused chain's cause id, stamped at harvest — the command →
        #: wave join point: a cluster commander labels this cause in the
        #: mesh trace store so explain()/stitch() name the command
        self.cause: Optional[str] = None

    def _resolve(self, count: int, seq: Optional[int]) -> None:
        self.count = count + self.fallback
        self.seq = seq
        self.done = True


class WavePipeline:
    #: dispatched-but-unharvested chains kept in flight; 1 = the harvest of
    #: chain N-1 always runs while chain N executes (the overlap stage)
    MAX_INFLIGHT = 1

    def __init__(
        self,
        backend: "TpuGraphBackend",
        fuse_depth: int = 8,
        max_words: int = 16,
    ):
        if backend.pipeline is not None and backend.pipeline is not self:
            raise ValueError("backend already has a WavePipeline attached")
        self.backend = backend
        #: auto-dispatch threshold: accumulated logical waves per fused
        #: chain (submit() dispatches when the accumulator reaches it; an
        #: explicit dispatch()/drain() flushes a shorter chain)
        self.fuse_depth = max(int(fuse_depth), 1)
        self.max_words = max_words
        self._pending: List[WaveTicket] = []
        self._inflight: Deque[dict] = deque()
        # -- counters (stats() / metrics collector) --
        self.waves_submitted = 0
        self.fused_dispatches = 0
        self.eager_waves = 0  # waves served by per-wave fallback dispatch
        self.chain_faults = 0  # chains contained to the split host loop
        self.harvests = 0
        self.overlap_harvests = 0  # harvests applied with a chain in flight
        self.apply_s_total = 0.0
        self.overlap_apply_s = 0.0  # host apply seconds inside the window
        self._disposed = False
        backend.pipeline = self
        global_metrics().register_collector(self, WavePipeline._collect_metrics)

    def _collect_metrics(self) -> dict:
        return {
            "fusion_pipeline_waves_total": self.waves_submitted,
            "fusion_pipeline_dispatches_total": self.fused_dispatches,
            "fusion_pipeline_eager_waves_total": self.eager_waves,
            "fusion_pipeline_chain_faults_total": self.chain_faults,
            "fusion_pipeline_pending_waves": len(self._pending),
            "fusion_pipeline_inflight_chains": len(self._inflight),
            "fusion_pipeline_overlap_occupancy": self.overlap_occupancy(),
        }

    # ------------------------------------------------------------------ submit
    def submit(self, computeds: Sequence["Computed"]) -> WaveTicket:
        """Accumulate one logical wave whose seeds are these computeds'
        mirror nodes. Computeds unknown to the mirror invalidate host-side
        immediately (the same fallback every burst path applies) and count
        in the ticket. Dispatches automatically once ``fuse_depth`` waves
        are pending."""
        seeds: List[int] = []
        fallback = 0
        backend = self.backend
        for c in computeds:
            nid = backend._id_by_input.get(c.input)
            if nid is None:
                c.invalidate(immediately=True)
                fallback += 1
            else:
                seeds.append(nid)
        return self._enqueue(WaveTicket(seeds, fallback))

    def submit_seeds(self, nids: Sequence[int]) -> WaveTicket:
        """Accumulate one logical wave of raw backend node ids."""
        return self._enqueue(WaveTicket([int(i) for i in nids]))

    def submit_rows(self, block: "RowBlock", rows) -> WaveTicket:
        """Accumulate one logical wave seeded by a bound table's rows."""
        nids = block.base + self.backend._check_rows(block, rows)
        return self._enqueue(WaveTicket(nids.tolist()))

    def _enqueue(self, ticket: WaveTicket) -> WaveTicket:
        if self._disposed:
            raise RuntimeError("pipeline is disposed")
        self.waves_submitted += 1
        if not ticket.seeds:
            ticket._resolve(0, None)  # nothing device-side to cascade
            return ticket
        self._pending.append(ticket)
        if len(self._pending) >= self.fuse_depth:
            self.dispatch()
        return ticket

    # ------------------------------------------------------------------ dispatch
    def dispatch(self) -> None:
        """Fuse the accumulated waves into one device chain and ENQUEUE it
        (no readback). Harvests any chain beyond the in-flight window —
        i.e. applying wave N-1's masks while wave N runs on device."""
        if not self._pending:
            return
        waves, self._pending = self._pending, []
        backend = self.backend
        if backend._journal:
            # flush() with a chain in flight would read (run_icasc's
            # was_clear) and clear invalid state through the STALE host
            # mirror — the exact hazard the refresh-chain ticket documents.
            # A non-empty journal forces the harvest first — of BOTH
            # nonblocking planes: an in-flight SUPER-ROUND's device
            # advance is just as unharvested as this pipeline's own
            # chains. The common pure-pipeline cadence (no journal
            # between dispatches) keeps the full overlap.
            self.harvest_inflight()
            sr = backend.super_rounds
            if sr is not None and not sr._disposed:
                sr._harvest_all()
        backend.flush()
        cause, seqs = backend._begin_wave_span(len(waves))
        wd = backend.watchdog
        if wd is not None and wd.mode == wd.MODE_HOST:
            self._run_host(waves, seqs, cause, degraded=True)
            return
        t0 = time.perf_counter()
        try:
            if wd is not None:
                # the chaos hook: an armed injection IS a chain fault, and
                # must not be mistaken for the fusibility fallback below
                wd._check_injected()
        except Exception as e:  # noqa: BLE001
            self._on_chain_fault(e, waves, seqs, cause)
            return
        try:
            if backend.mesh_routing_active():
                # the frontier exchange composed into the loop-carried
                # chain: cross-shard frontiers resolve on the mesh INSIDE
                # the fused dispatch, never via the per-key host relay
                pending = backend.dispatch_waves_routed_chain(
                    [w.seeds for w in waves]
                )
                harvest = backend.harvest_waves_routed_chain
            else:
                pending = backend.graph.dispatch_waves_lanes_chain(
                    [[w.seeds] for w in waves], max_words=self.max_words
                )
                harvest = backend.graph.harvest_waves_lanes_chain
        except (NotFusible, ValueError):
            # not a fault: the mirror cannot serve the fused path right
            # now (invalid, multi-pass, out-of-contract seeds) — eager
            # per-wave dispatch, counted so the regression is observable.
            # Any other RuntimeError (a failed CUDA launch, a device-side
            # error) is a chain fault and takes the branch below
            self._run_eager(waves, seqs, cause)
            return
        except Exception as e:  # noqa: BLE001 — chain fault: contain + degrade
            self._on_chain_fault(e, waves, seqs, cause)
            return
        self._inflight.append(
            {"pending": pending, "waves": waves, "seqs": seqs,
             "cause": cause, "t0": t0, "harvest": harvest}
        )
        while len(self._inflight) > self.MAX_INFLIGHT:
            self._harvest(self._inflight.popleft())

    def harvest_inflight(self) -> None:
        """Harvest every dispatched-but-unharvested chain WITHOUT
        dispatching pending accumulations — the flush-hazard half of
        drain(), also called by the SuperRoundProgram's own guard so
        either plane's dispatch quiesces the other before flushing."""
        while self._inflight:
            self._harvest(self._inflight.popleft())

    def drain(self) -> int:
        """The nonblocking-mode barrier: dispatch anything accumulated and
        harvest every in-flight chain — INCLUDING any super-rounds the
        backend's resident SuperRoundProgram has in flight, so
        one barrier covers both nonblocking planes. Returns the total
        newly-invalidated count of the waves resolved by this call."""
        before = self.backend.device_invalidations
        self.dispatch()
        while self._inflight:
            self._harvest(self._inflight.popleft())
        sr = self.backend.super_rounds
        if sr is not None and not sr._disposed:
            sr.drain()
        return self.backend.device_invalidations - before

    # ------------------------------------------------------------------ harvest
    def _harvest(self, ticket: dict) -> None:
        backend = self.backend
        waves: List[WaveTicket] = ticket["waves"]
        seqs = ticket["seqs"]
        try:
            stage_counts, stage_masks = ticket["harvest"](ticket["pending"])
        except Exception as e:  # noqa: BLE001 — harvest fault: contain + degrade
            self._on_chain_fault(e, waves, seqs, ticket["cause"])
            return
        t_ready = time.perf_counter()
        self.harvests += 1
        overlap = len(self._inflight) > 0
        if overlap:
            self.overlap_harvests += 1
        backend.overlap_active = overlap
        backend.last_cause_id = ticket["cause"]
        total = 0
        t_apply0 = time.perf_counter()
        try:
            for i, wave in enumerate(waves):
                backend.last_wave_seq = seqs[i]
                backend._apply_newly(stage_masks[i])
                count = int(stage_counts[i].sum())
                wave.cause = ticket["cause"]
                wave._resolve(count, seqs[i])
                total += count
        finally:
            backend.overlap_active = False
            backend.last_wave_seq = seqs[0]
        dt_apply = time.perf_counter() - t_apply0
        self.apply_s_total += dt_apply
        if overlap:
            self.overlap_apply_s += dt_apply
        backend.waves_run += len(waves)
        backend.device_invalidations += total
        backend._profile_wave(
            "pipeline", sum(len(w.seeds) for w in waves), ticket["cause"],
            ticket["t0"], t_ready, total, seqs[0], groups=len(waves),
            fused_depth=len(waves), seq_span=(seqs[0], seqs[-1]),
            dispatches=ticket["pending"]["dispatches"],
        )
        self.fused_dispatches += ticket["pending"]["dispatches"]

    # ------------------------------------------------------------------ fallbacks
    def _run_eager(self, waves, seqs, cause) -> None:
        """Per-wave dispatch on the general union path (mirror when it can,
        dense otherwise) — the NON-fused regime the pipeline degrades to
        when the chain is unavailable. Counted; never silent."""
        self._run_waves_one_by_one(waves, seqs, cause, mirror="auto")
        self.eager_waves += len(waves)

    def _on_chain_fault(self, e: BaseException, waves, seqs, cause) -> None:
        """A fused chain raised (dispatch or harvest): re-run every wave on
        the SPLIT HOST LOOP (dense per-wave BFS — shares nothing with the
        path that failed; invalidation is idempotent so a partial chain is
        absorbed) and degrade the attached watchdog. A harvest fault means
        the dispatched chain may ALREADY have advanced the device invalid
        state — the host mirror re-syncs from the device before the re-run
        so it can never read stale (the re-run's per-wave counts then
        reflect the post-chain state: containment preserves the SET, not
        the counts)."""
        self.chain_faults += 1
        log.warning("wave pipeline: chain fault contained (%r)", e)
        backend = self.backend
        dg = backend.graph
        if dg._g is not None and not dg._dirty:
            # whatever the chain DID commit device-side still gets the full
            # two-tier host apply (pending bits, eager watched nodes, fence
            # fan-out) — attributed to the chain head's seq, since per-stage
            # attribution died with the readback
            pre = dg._h_invalid.copy()
            dg._sync_invalid_back()
            committed = dg._h_invalid & ~pre
            if committed.any():
                backend.last_cause_id = cause
                backend.last_wave_seq = seqs[0]
                backend._apply_newly(committed)
        wd = backend.watchdog
        if wd is not None:
            wd._on_fault(e)
        self._run_waves_one_by_one(waves, seqs, cause, mirror="off")
        if wd is not None:
            wd._after_host_burst()

    def _run_host(self, waves, seqs, cause, degraded: bool) -> None:
        """Degraded-mode execution under a host-mode watchdog: the split
        host loop, counting toward the watchdog's recovery window."""
        self._run_waves_one_by_one(waves, seqs, cause, mirror="off")
        self.eager_waves += len(waves)
        wd = self.backend.watchdog
        if degraded and wd is not None:
            wd._after_host_burst()

    def _run_waves_one_by_one(self, waves, seqs, cause, mirror: str) -> None:
        backend = self.backend
        backend.last_cause_id = cause
        total = 0
        t0 = time.perf_counter()
        try:
            for i, wave in enumerate(waves):
                backend.last_wave_seq = seqs[i]
                count, ids = backend.graph.run_waves_union(
                    [wave.seeds], mirror=mirror
                )
                backend._apply_newly(ids)
                wave.cause = cause
                wave._resolve(int(count), seqs[i])
                total += int(count)
        finally:
            backend.last_wave_seq = seqs[0]
        t1 = time.perf_counter()
        backend.waves_run += len(waves)
        backend.device_invalidations += total
        backend._profile_wave(
            "pipeline_host" if mirror == "off" else "pipeline_eager",
            sum(len(w.seeds) for w in waves), cause, t0, t1, total,
            seqs[0], groups=len(waves),
            seq_span=(seqs[0], seqs[-1]),
        )

    # ------------------------------------------------------------------ stats
    def overlap_occupancy(self) -> float:
        """Fraction of host wave-apply time (mask unpack, two-tier apply,
        fence fan-out drain) that ran WHILE a fused chain executed on
        device — the overlap-occupancy number. 0.0 when nothing
        has been applied yet."""
        if self.apply_s_total <= 0.0:
            return 0.0
        return self.overlap_apply_s / self.apply_s_total

    def stats(self) -> dict:
        return {
            "fuse_depth": self.fuse_depth,
            "waves_submitted": self.waves_submitted,
            "fused_dispatches": self.fused_dispatches,
            "eager_waves": self.eager_waves,
            "chain_faults": self.chain_faults,
            "harvests": self.harvests,
            "overlap_harvests": self.overlap_harvests,
            "pending_waves": len(self._pending),
            "inflight_chains": len(self._inflight),
            "apply_s_total": round(self.apply_s_total, 4),
            "overlap_apply_s": round(self.overlap_apply_s, 4),
            "overlap_occupancy": round(self.overlap_occupancy(), 4),
        }

    def dispose(self) -> None:
        """Drain outstanding work and detach from the backend
        (idempotent)."""
        if self._disposed:
            return
        self.drain()
        self._disposed = True
        if self.backend.pipeline is self:
            self.backend.pipeline = None
        global_metrics().unregister_collector(self)
