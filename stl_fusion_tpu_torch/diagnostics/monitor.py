"""FusionMonitor — registry access sampling + periodic stats.

Re-expression of src/Stl.Fusion/Diagnostics/FusionMonitor.cs:7-100: samples
ComputedRegistry events (access = reads, register = computes) and reports
hit ratios; the number the reference's benchmark brags about is exactly
``hits / accesses``.
"""
from __future__ import annotations

import logging
import time
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from ..core.hub import FusionHub

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["FusionMonitor"]


class FusionMonitor:
    def __init__(
        self,
        hub: "FusionHub",
        report_period: float = 60.0,
        resilience=None,
        metrics=None,
    ):
        self.hub = hub
        self.report_period = report_period
        #: MetricsRegistry the report pulls shared telemetry from (the
        #: end-to-end delivery histogram the client apply path records);
        #: defaults to the process-wide registry
        if metrics is None:
            from .metrics import global_metrics

            metrics = global_metrics()
        self.metrics = metrics
        self._slow_accesses = 0
        self.registrations = 0
        self.invalidations = 0
        #: ResilienceEvents ledger exported by report(); defaults to the
        #: process-wide registry so breaker transitions, watchdog fallbacks
        #: and oplog quarantines show up with zero wiring
        if resilience is None:
            from ..resilience.events import global_events

            resilience = global_events()
        self.resilience = resilience
        #: RPC hubs whose fan-out/coalescer counters report() exports
        #: (attach_rpc_hub); weakly referenced so a monitor never pins a
        #: stopped hub's peer machinery
        self._rpc_hubs: list = []
        #: cluster control-plane parts (attach_cluster): member / router /
        #: rebalancer snapshots merged into report()["cluster"]
        self._cluster_parts: list = []
        #: edge gateway nodes (attach_edge): per-node snapshots listed in
        #: report()["edge"] — sessions, upstream subs, eviction/delivery
        self._edge_nodes: list = []
        #: mesh telemetry aggregator (attach_mesh_telemetry): fleet-scope
        #: snapshot table + stitched wave timelines via mesh_report()
        self._mesh_telemetry = None
        # the hot-cache fast path counts amortized on the registry (every
        # 16th hit — see core/service.py) instead of firing a hook per hit
        self._fast_hits0 = getattr(hub.registry, "fast_hits", 0)
        self._started_at = time.monotonic()
        self._last_report = self._started_at
        self._disposed = False
        self._reporter_task = None
        #: ConsistencyAuditor started by start_auditor(); its last_report
        #: surfaces as report()["audit"], and dispose() stops it
        self.auditor = None
        self._auditor_kwargs: dict = {}
        hub.registry.on_access.append(self._on_access)
        hub.registry.on_register.append(self._on_register)
        hub.invalidated_hooks.append(self._on_invalidated)

    def start_reporter(self, period: float = None):
        """Emit the periodic report from a BACKGROUND task instead of
        piggybacking on ``_on_access``: an idle-but-subscribed process
        (a server holding live ``$sys-c`` subscriptions with no local
        reads) never fires ``_on_access``, so it never reported at all.
        Requires a running event loop; idempotent while running; stopped
        for good by :meth:`dispose`."""
        import asyncio

        if self._disposed:
            raise RuntimeError("monitor is disposed")
        if self._reporter_task is not None and not self._reporter_task.done():
            return self._reporter_task
        if period is not None:
            self.report_period = period

        async def _report_loop():
            while True:
                await asyncio.sleep(self.report_period)
                self._last_report = time.monotonic()
                log.info("fusion stats: %s", self.report())

        self._reporter_task = asyncio.get_event_loop().create_task(_report_loop())
        return self._reporter_task

    def start_auditor(self, period: Optional[float] = None, **kwargs):
        """Start the online consistency auditor beside the reporter: sampled
        ``validate_hub``/``validate_mirror`` sweeps + the canary staleness
        sentinel, exporting ``fusion_invariant_violations`` /
        ``fusion_canary_staleness_ms`` and tripping a resilience-ledger
        event on violation. Idempotent while running — a repeat
        call with the same settings is a no-op returning the live task,
        and a new ``period`` retimes the running loop; CHANGED constructor
        settings raise instead of being silently dropped (a caller asking
        for ``sample=1.0`` must not keep auditing 25%). Stopped by
        :meth:`dispose`. Extra kwargs reach the
        :class:`~stl_fusion_tpu_torch.diagnostics.auditor.ConsistencyAuditor`
        constructor (``sample=``, ``canary=``, ``backend=``, ...)."""
        if self._disposed:
            raise RuntimeError("monitor is disposed")
        if self.auditor is None:
            from .auditor import ConsistencyAuditor

            # defaults, not fixed arguments: the docstring promises kwargs
            # passthrough, so an explicit metrics=/events= must override
            # the monitor's own instead of raising a duplicate-kwarg error
            kwargs.setdefault("metrics", self.metrics)
            kwargs.setdefault("events", self.resilience)
            self._auditor_kwargs = dict(kwargs)
            self.auditor = ConsistencyAuditor(
                self.hub,
                period=period if period is not None else 30.0,
                **kwargs,
            )
        elif any(self._auditor_setting_differs(k, v) for k, v in kwargs.items()):
            raise RuntimeError(
                "auditor already constructed with different settings — "
                "adjust monitor.auditor directly, or dispose() and "
                "recreate the monitor"
            )
        return self.auditor.start(period=period)

    #: start_auditor kwarg → live ConsistencyAuditor attribute, for the
    #: changed-settings guard (a repeat call passing the value already in
    #: effect — even a constructor default — must stay a no-op)
    _AUDITOR_ATTRS = {
        "sample": "sample",
        "canary": "canary_enabled",
        "backend": "backend",
        "recorder": "recorder",
    }

    def _auditor_setting_differs(self, key: str, value) -> bool:
        if key in self._auditor_kwargs:
            return self._auditor_kwargs[key] != value
        attr = self._AUDITOR_ATTRS.get(key)
        if attr is not None:
            return getattr(self.auditor, attr) != value
        return True  # unrecorded setting (e.g. seed): conservative

    def dispose(self) -> None:
        """Detach all three hub hooks and stop the background reporter
        (idempotent). Without this every constructed monitor kept counting
        — and kept ITSELF alive through the hub's hook lists — forever."""
        if self._disposed:
            return
        self._disposed = True
        if self._reporter_task is not None:
            self._reporter_task.cancel()
            self._reporter_task = None
        if self.auditor is not None:
            self.auditor.dispose()
            self.auditor = None
        for hooks, fn in (
            (self.hub.registry.on_access, self._on_access),
            (self.hub.registry.on_register, self._on_register),
            (self.hub.invalidated_hooks, self._on_invalidated),
        ):
            try:
                hooks.remove(fn)
            except ValueError:
                pass

    def attach_rpc_hub(self, rpc_hub) -> "FusionMonitor":
        """Export an RPC hub's invalidation fan-out counters (per-peer
        outbox coalescing, batch frames, fanout-index drains) in
        :meth:`report` under ``"fanout"``."""
        import weakref

        self._rpc_hubs.append(weakref.ref(rpc_hub))
        return self

    def attach_cluster(self, *parts) -> "FusionMonitor":
        """Export cluster control-plane state in :meth:`report` under
        ``"cluster"``: any mix of ``ClusterMember``, ``ShardMapRouter``
        and ``ClusterRebalancer`` (anything with ``snapshot()``), merged
        into one dict. Weakly referenced, like the RPC hubs."""
        import weakref

        for part in parts:
            self._cluster_parts.append(weakref.ref(part))
        return self

    def attach_edge(self, *nodes) -> "FusionMonitor":
        """Export edge gateway state in :meth:`report` under ``"edge"``:
        one snapshot per attached :class:`~..edge.EdgeNode` (sessions,
        upstream subscriptions, evictions, resume/resubscribe counters,
        the fence→client-visible delivery histogram). Weakly referenced,
        like the RPC hubs."""
        import weakref

        for node in nodes:
            self._edge_nodes.append(weakref.ref(node))
        return self

    def attach_mesh_telemetry(self, aggregator) -> "FusionMonitor":
        """Export the mesh telemetry plane through
        :meth:`mesh_report`: the aggregator's per-host snapshot table and
        the stitched cross-host wave timelines. Weakly referenced, like
        every other attachment."""
        import weakref

        self._mesh_telemetry = weakref.ref(aggregator)
        return self

    def mesh_report(self, cause=None) -> dict:
        """The mesh-scope answer ``report()`` cannot give: fleet snapshot
        freshness (per-host ages, stale/evicted marking) plus ONE stitched
        wave timeline — for ``cause``, or the most recent traced wave.
        Every field degrades explicitly: no aggregator attached reports
        ``"telemetry": None``, an unknown cause reports ``"trace": None``
        (with the cause it looked for) — never a silent empty dict."""
        from .mesh_telemetry import global_mesh_trace

        agg = self._mesh_telemetry() if self._mesh_telemetry is not None else None
        store = global_mesh_trace()
        looked_for = cause or store.latest_cause()
        stitched = None
        if looked_for is not None:
            stitched = store.stitch(
                looked_for,
                expected_hosts=agg.known_hosts() if agg is not None else None,
            )
        if stitched is not None and agg is not None:
            self._name_straggler_hotkeys(stitched, agg)
        return {
            "telemetry": agg.summary() if agg is not None else None,
            "cause": looked_for,
            "trace": stitched,
            # the judgment plane: mesh-scope verdict + merged
            # heavy hitters — degrade explicitly, same contract as above
            "health": agg.mesh_health() if agg is not None else None,
            "hotkeys": agg.hotkeys_report() if agg is not None else None,
        }

    @staticmethod
    def _name_straggler_hotkeys(stitched: dict, agg) -> None:
        """Attribution join: a slow shard names its hottest
        keys. The router's ``shard_keys`` sketch tracks routed calls as
        ``"<shard>|<service>.<method>"`` — each straggler row gets the
        top entries behind its own shard prefix."""
        rows = stitched.get("straggler") or ()
        if not rows:
            return
        try:
            sketch = agg.merged_sketches().get("shard_keys")
        except Exception:  # noqa: BLE001 — attribution is garnish, never a crash
            return
        if sketch is None:
            return
        entries = sketch.topk(sketch.capacity)
        for row in rows:
            prefix = f"{row.get('shard')}|"
            hot = [
                {"key": e["key"].partition("|")[2], "count": e["count"],
                 "share": e["share"]}
                for e in entries
                if e["key"].startswith(prefix)
            ][:3]
            if hot:
                row["hot_keys"] = hot

    def _edge_report(self):
        nodes = [ref() for ref in self._edge_nodes]
        snaps = [n.snapshot() for n in nodes if n is not None]
        return snaps or None

    def _cluster_report(self):
        merged = None
        for ref in self._cluster_parts:
            part = ref()
            if part is None:
                continue
            snap = part.snapshot()
            if merged is None:
                merged = dict(snap)
            else:
                merged.update(snap)
        return merged

    def _fanout_report(self):
        totals = None
        for ref in self._rpc_hubs:
            hub = ref()
            if hub is None:
                continue
            stats = hub.fanout_stats()
            if totals is None:
                totals = stats
            else:
                for k, v in stats.items():
                    if isinstance(v, dict):  # nested fanout_index counters
                        sub = totals.setdefault(k, {})
                        for kk, vv in v.items():
                            if isinstance(vv, (int, float)):
                                sub[kk] = sub.get(kk, 0) + vv
                    elif isinstance(v, (int, float)):
                        totals[k] = totals.get(k, 0) + v
        return totals

    @property
    def accesses(self) -> int:
        fast = getattr(self.hub.registry, "fast_hits", 0) - self._fast_hits0
        return self._slow_accesses + fast

    # computes (misses) register; everything else that probed was a hit
    @property
    def hits(self) -> int:
        return max(self.accesses - self.registrations, 0)

    @property
    def hit_ratio(self) -> float:
        accesses = self.accesses
        return self.hits / accesses if accesses else 0.0

    def _on_access(self, _input) -> None:
        self._slow_accesses += 1
        now = time.monotonic()
        if now - self._last_report >= self.report_period:
            self._last_report = now
            log.info("fusion stats: %s", self.report())

    def _on_register(self, _computed) -> None:
        self.registrations += 1

    def _on_invalidated(self, _computed) -> None:
        self.invalidations += 1

    def report(self) -> dict:
        elapsed = time.monotonic() - self._started_at
        fanout = self._fanout_report()
        extra = {"fanout": fanout} if fanout is not None else {}
        cluster = self._cluster_report()
        if cluster is not None:
            extra["cluster"] = cluster
        edge = self._edge_report()
        if edge is not None:
            extra["edge"] = edge
        # per-wave timelines: the hub's graph backend carries the profiler
        backend = getattr(self.hub, "graph_backend", None)
        profiler = getattr(backend, "profiler", None)
        if profiler is not None:
            # includes fused_depth_p50/p99 + timing_rejects: the
            # fused-path engagement and the negative-timing belt are part
            # of the standard waves report, not bench-only fields
            extra["waves"] = profiler.report()
        # nonblocking wave pipeline: accumulator depth, fused
        # dispatch count, eager/fault fallbacks, overlap occupancy
        pipeline = getattr(backend, "pipeline", None)
        if pipeline is not None:
            extra["pipeline"] = pipeline.stats()
        # end-to-end delivery: wave applied server-side -> client apply,
        # measured INSIDE the system (the $sys-c origin timestamp), not by
        # a harness. find(), not histogram(): reporting must never mint an
        # empty metric.
        delivery = self.metrics.find("fusion_e2e_delivery_ms")
        if delivery is not None:
            extra["delivery"] = delivery.snapshot()
        # causal flight journal: per-kind lifecycle counters + ring depth
        # (the events themselves serve via explain()/GET /explain)
        from .flight_recorder import RECORDER

        extra["recorder"] = RECORDER.summary()
        # online auditor: the latest sweep's verdict, when one is running
        if self.auditor is not None and self.auditor.last_report is not None:
            extra["audit"] = self.auditor.last_report
        # SLO verdict: the same machine-readable judgment
        # GET /health serves — mesh-scope when an aggregator is attached
        from .slo import global_slo_engine

        agg = self._mesh_telemetry() if self._mesh_telemetry is not None else None
        try:
            extra["health"] = (
                agg.mesh_health() if agg is not None
                else global_slo_engine().evaluate()
            )
        except Exception as e:  # noqa: BLE001 — a judging fault degrades, never raises
            extra["health"] = {"verdict": "degraded",
                               "error": {"type": type(e).__name__, "message": str(e)}}
        return {
            **extra,
            "accesses": self.accesses,
            "computes": self.registrations,
            "invalidations": self.invalidations,
            "hit_ratio": round(self.hit_ratio, 4),
            "registry_size": len(self.hub.registry),
            "accesses_per_sec": round(self.accesses / elapsed, 1) if elapsed else 0.0,
            # degradation ledger: breaker transitions, watchdog fallbacks,
            # chaos injections, oplog quarantines — one dict of counters
            "resilience": self.resilience.snapshot(),
        }
