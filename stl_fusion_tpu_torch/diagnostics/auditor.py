"""ConsistencyAuditor — the online correctness sentinel.

``validate_hub``/``validate_mirror`` alone have no callers outside tests —
the correctness story would never RUN on a live process. This auditor
closes that gap: a background task that, each cycle,

1. runs a **sampled** ``validate_hub`` sweep (I1-I5 structural invariants
   over a random fraction of the registry — the full sweep amortizes over
   cycles instead of stalling a live loop on one O(graph) pass);
2. cross-checks the device CSR mirror against host truth
   (``validate_mirror``, M1-M2) when a graph backend is attached;
3. probes a **canary key**: a private compute method is invalidated and
   re-read through the full invalidate→recompute machinery; the observed
   freshness latency records into ``fusion_canary_staleness_ms`` and a
   stale read-back (the value did not advance) is itself a violation —
   the sentinel that catches "invalidation stopped propagating" even when
   the structure still validates.

Violations export as the ``fusion_invariant_violations`` counter, trip a
``ResilienceEvents`` ledger event (so breaker dashboards see correctness
degradation next to connectivity degradation) and land in the flight
recorder — ``explain``/``/trace`` show them in context.

Surfaced via ``FusionMonitor.report()["audit"]`` and started with
``monitor.start_auditor()`` beside ``start_reporter()``.

Imports from ``core`` are lazy (``diagnostics`` is imported by
``core.computed`` at module scope — this module must not close the cycle).
"""
from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Optional

from .flight_recorder import RECORDER
from .invariants import validate_hub, validate_mirror
from .metrics import global_metrics

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["ConsistencyAuditor"]


def _make_canary(hub):
    """A private single-key compute service — the staleness sentinel rides
    the REAL invalidate/recompute machinery, not a synthetic timer."""
    from ..core.service import ComputeService, compute_method

    class _CanaryService(ComputeService):
        def __init__(self, h):
            super().__init__(h)
            self.value = 0

        @compute_method
        async def canary(self) -> int:
            return self.value

    return _CanaryService(hub)


class ConsistencyAuditor:
    def __init__(
        self,
        hub,
        backend=None,
        period: float = 30.0,
        sample: float = 0.25,
        canary: bool = True,
        metrics=None,
        events=None,
        recorder=None,
        seed: Optional[int] = None,
    ):
        self.hub = hub
        #: TpuGraphBackend whose mirror each cycle cross-checks; defaults
        #: to the hub's attached backend (None skips the mirror sweep)
        self.backend = backend if backend is not None else hub.graph_backend
        self.period = period
        self.sample = sample
        self.canary_enabled = canary
        self.metrics = metrics if metrics is not None else global_metrics()
        if events is None:
            from ..resilience.events import global_events

            events = global_events()
        self.events = events
        self.recorder = recorder if recorder is not None else RECORDER
        self._rng = random.Random(seed)
        self._canary_svc = None
        self._task: Optional[asyncio.Task] = None
        self._disposed = False
        # -- counters (collector-fed; weak-registered like every component)
        self.sweeps = 0
        self.violations_total = 0
        self.canary_probes = 0
        self.canary_failures = 0
        self.last_report: Optional[dict] = None
        self.metrics.register_collector(self, ConsistencyAuditor._collect_metrics)

    def _collect_metrics(self) -> dict:
        return {
            "fusion_invariant_violations": self.violations_total,
            "fusion_audit_sweeps_total": self.sweeps,
            "fusion_canary_probes_total": self.canary_probes,
            "fusion_canary_failures_total": self.canary_failures,
        }

    # ------------------------------------------------------------------ cycle
    async def audit_once(self) -> dict:
        """One audit cycle. Returns (and retains as ``last_report``) a
        JSON-safe dict; violations are counted, ledgered and journaled."""
        t0 = time.perf_counter()
        hub_report = validate_hub(self.hub, sample=self.sample, rng=self._rng)
        mirror_report = None
        if self.backend is not None:
            mirror_report = validate_mirror(
                self.backend, sample=self.sample, rng=self._rng
            )
        canary_ms = None
        canary_ok = True
        if self.canary_enabled:
            canary_ms, canary_ok = await self._canary_probe()

        violations = list(hub_report.violations)
        if mirror_report is not None:
            violations.extend(mirror_report.violations)
        if not canary_ok:
            violations.append("C1: canary key served a stale value after invalidation")
        if violations:
            self.violations_total += len(violations)
            self.events.record(
                "invariant_violation",
                f"{len(violations)} violation(s), first: {violations[0]}",
            )
            if self.recorder.enabled:
                self.recorder.note(
                    "invariant_violation",
                    key="auditor",
                    detail=violations[0],
                )
            log.warning("auditor found %d invariant violation(s): %s",
                        len(violations), violations[0])
        self.sweeps += 1
        self.last_report = {
            "at": time.time(),
            "sweeps": self.sweeps,
            "sample": self.sample,
            "checked_nodes": hub_report.checked_nodes
            + (mirror_report.checked_nodes if mirror_report is not None else 0),
            "checked_edges": hub_report.checked_edges,
            "violations": violations[:20],
            "violations_total": self.violations_total,
            "canary_staleness_ms": canary_ms,
            "canary_ok": canary_ok,
            "audit_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }
        return self.last_report

    async def _canary_probe(self) -> tuple:
        """Invalidate + re-read the canary through the real machinery;
        the invalidate→fresh-read latency is the staleness sample."""
        from ..core.context import invalidating

        if self._canary_svc is None:
            self._canary_svc = _make_canary(self.hub)
        svc = self._canary_svc
        svc.value += 1
        want = svc.value
        t0 = time.perf_counter()
        with invalidating():
            await svc.canary()
        got = await svc.canary()
        ms = (time.perf_counter() - t0) * 1e3
        self.canary_probes += 1
        ok = got == want
        if not ok:
            self.canary_failures += 1
        self.metrics.histogram(
            "fusion_canary_staleness_ms",
            help="auditor canary: invalidation -> fresh recompute observed",
        ).record(ms)
        return round(ms, 4), ok

    # ------------------------------------------------------------------ lifecycle
    def start(self, period: Optional[float] = None) -> asyncio.Task:
        """Run :meth:`audit_once` every ``period`` seconds from a background
        task. Idempotent while running; stopped by :meth:`dispose`."""
        if self._disposed:
            raise RuntimeError("auditor is disposed")
        if period is not None:
            # applied BEFORE the running-task early return: restarting with
            # a new period must retime the live loop (it re-reads
            # self.period each cycle), not be silently dropped
            self.period = period
        if self._task is not None and not self._task.done():
            return self._task

        async def _loop() -> None:
            # first sweep IMMEDIATELY: an operator starting the auditor
            # mid-incident must get an "audit" section on the first scrape,
            # not after a full period of silence
            while True:
                try:
                    await self.audit_once()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — the sentinel must outlive one bad sweep
                    log.exception("auditor cycle failed")
                await asyncio.sleep(self.period)

        self._task = asyncio.get_event_loop().create_task(_loop())
        return self._task

    def dispose(self) -> None:
        """Stop the loop and detach the metrics collector (idempotent)."""
        if self._disposed:
            return
        self._disposed = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.metrics.unregister_collector(self)
