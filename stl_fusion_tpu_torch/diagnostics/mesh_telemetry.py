"""Mesh-wide observability: fleet telemetry aggregation +
cross-host wave trace stitching + straggler attribution.

Every other diagnostics mechanism is process-local: the metrics registry
answers ``GET /metrics`` for ONE host, the span ring and flight recorder
hold ONE host's events, and ``explain()`` can only name what its own
process saw. On a multi-host mesh that leaves the operator with N scrapes
to join by hand and NO way to answer "where did wave X's exchange levels
spend time, per host" — the question the async frontier plane exists to
make interesting.

Three pieces, all transport-agnostic (the mesh control plane — rpc/tcp.py
frames while serving, the rendezvous board during degrade — carries plain
dict payloads):

* :class:`MeshTelemetryPublisher` — periodically snapshots the LOCAL
  ``MetricsRegistry`` into a flat ``{series: value}`` payload (histograms
  ship ``_sum``/``_count``), stamped with a ``(wall_ts, perf_ts)`` clock
  pair and the registry's declared-MAX names, plus this host's recent
  wave trace segments.

* :class:`MeshTelemetryAggregator` — keeps the latest snapshot per host
  and renders ONE merged Prometheus exposition: per-series merge is SUM
  by default and MAX for declared-MAX gauges (the same contract
  ``MetricsRegistry.set_aggregation`` enforces within a process), every
  contributing series is re-emitted labeled ``host="h<N>"``, and a
  snapshot older than two reporting periods — or from an evicted member —
  is EXCLUDED from the merge but marked ``fusion_mesh_telemetry_stale``
  (its last-known per-host series stay visible): stale data is flagged,
  never silently merged and never silently dropped. The local host's
  series are read live at merge time, so the answering host is always
  fresh. The membership arc (``fusion_mesh_epoch``, degrade/re-form
  counters) rides the ordinary series, so a host kill stays visible
  through the scrape.

* :class:`MeshTraceStore` — bounded per-cause store of
  :class:`WaveSegment` records. The routed wave path records segments at
  its HOST-VISIBLE boundaries (dispatch → harvest); the wave kernel
  itself runs inside one jit/shard_map program, so per-level host
  timestamps do not exist — per-level segments are DERIVED by dividing
  the measured host window across the counted levels (totals and
  ordering preserved; documented, not hidden). Cross-host alignment is
  real: ``stitch()`` maps every remote segment through
  ``ClockSync.to_local`` (residual bounded by the recorded RTT/2) and
  returns one timeline with per-level stall attribution, the pacing
  ``(host, shard)`` named per merge epoch, and a straggler table. A host
  that never reported yields a PARTIAL stitch — counted
  (``fusion_mesh_trace_partial_stitches_total``), never silent.

Package constraint: ``core.computed`` imports ``diagnostics`` at module
scope, so nothing here may import ``core``/``rpc`` at module scope (the
RPC-facing :class:`MeshTelemetryService` is plain duck-typing) — and
``torch.distributed`` is only touched lazily inside :func:`local_host`.
"""
from __future__ import annotations

import contextvars
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set

from .clocksync import ClockSync, global_clock_sync, now
from .metrics import MetricsRegistry, global_metrics

__all__ = [
    "WaveSegment",
    "MeshTraceStore",
    "MeshTelemetryPublisher",
    "MeshTelemetryAggregator",
    "MeshTelemetryService",
    "global_mesh_trace",
    "local_host",
    "set_dispatch_cause",
    "reset_dispatch_cause",
    "current_dispatch_cause",
]

#: segment phases the routed wave / super-round path records — the five
#: host-attributable stations of one async wave
PHASES = ("spec_expand", "a2a", "exchange", "tree_round", "quiescence_vote", "fence_drain")

_host_cache: Optional[str] = None


def local_host() -> str:
    """This process's mesh host name (``h<rank>``): the label every locally
    recorded segment and series carries. The rank is ``torch.distributed``'s
    when a process group is initialised, else 0 (a single host)."""
    global _host_cache
    if _host_cache is None:
        idx = 0
        try:  # lazy: diagnostics must import without torch.distributed up
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                idx = dist.get_rank()
        except Exception:  # noqa: BLE001 — no process group: single host
            idx = 0
        _host_cache = f"h{idx}"
    return _host_cache


#: cause id the super-round threads through the routed dispatch so every
#: host-boundary segment of one wave shares the wave's EXISTING cause id
#: (never a second identity minted per layer)
_dispatch_cause: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "fusion_mesh_dispatch_cause", default=None
)


def set_dispatch_cause(cause: Optional[str]):
    return _dispatch_cause.set(cause)


def reset_dispatch_cause(token) -> None:
    _dispatch_cause.reset(token)


def current_dispatch_cause() -> Optional[str]:
    return _dispatch_cause.get()


@dataclass
class WaveSegment:
    """One host's span of one wave phase, in the HOST-LOCAL perf_counter
    timeline (alignment happens at stitch time, where the clock table is)."""

    cause: str
    host: str
    phase: str
    level: int  # merge-epoch index within the wave; -1 = wave-scoped
    shard: int  # pacing shard within the host; -1 = not attributed
    t0: float
    t1: float

    def to_dict(self) -> dict:
        return {
            "cause": self.cause, "host": self.host, "phase": self.phase,
            "level": self.level, "shard": self.shard,
            "t0": self.t0, "t1": self.t1,
        }


_SEGMENT_KEYS = ("cause", "host", "phase", "level", "shard", "t0", "t1")

#: fleet-plane meta series the aggregator owns: rendered once from LIVE
#: state at the top of the mesh exposition, never re-merged from snapshots
#: (a remote host's view of staleness is not THIS scrape's view)
_META_BASES = frozenset(
    {"fusion_mesh_telemetry_stale", "fusion_mesh_telemetry_hosts_reporting"}
)


class MeshTraceStore:
    """Bounded per-cause segment store (FlightRecorder discipline: one
    lock, insertion-ordered eviction, counted drops, an ``enabled`` gate
    so the hot path costs one attribute read when tracing is off)."""

    def __init__(self, max_causes: int = 256, max_segments_per_cause: int = 512):
        self.enabled = True
        self.max_causes = max_causes
        self.max_segments_per_cause = max_segments_per_cause
        self._lock = threading.Lock()
        #: cause -> list of segment dicts, insertion-ordered for eviction
        self._by_cause: "OrderedDict[str, List[dict]]" = OrderedDict()
        #: cause -> originating-command label: bounded the same
        #: way, fed by the cluster commander locally and by the oplog
        #: reader for operations journaled on other hosts
        self._commands: "OrderedDict[str, str]" = OrderedDict()
        self.recorded = 0
        self.ingested = 0
        self.dropped = 0

    # ------------------------------------------------------------------ write
    def record(
        self,
        cause: Optional[str],
        phase: str,
        t0: float,
        t1: float,
        host: Optional[str] = None,
        level: int = -1,
        shard: int = -1,
    ) -> None:
        if not self.enabled or cause is None:
            return
        seg = {
            "cause": cause, "host": host or local_host(), "phase": phase,
            "level": int(level), "shard": int(shard),
            "t0": float(t0), "t1": float(t1),
        }
        if self._append(seg):
            self.recorded += 1
            global_metrics().counter(
                "fusion_mesh_trace_segments_total",
                help="per-host wave trace segments recorded at the routed "
                "path's host-visible boundaries",
            ).inc()

    def ingest(self, segments: Iterable[dict]) -> int:
        """Store segments shipped from another host VERBATIM (still on the
        remote clock — ``stitch`` aligns; storing aligned values would bake
        in whatever offset estimate existed at arrival time)."""
        n = 0
        for raw in segments or ():
            try:
                seg = {k: raw[k] for k in _SEGMENT_KEYS}
                seg["level"] = int(seg["level"])
                seg["shard"] = int(seg["shard"])
                seg["t0"] = float(seg["t0"])
                seg["t1"] = float(seg["t1"])
            except (KeyError, TypeError, ValueError):
                continue  # malformed remote segment: skip, never poison
            if self._append(seg, dedup=True):
                n += 1
        self.ingested += n
        return n

    def _append(self, seg: dict, dedup: bool = False) -> bool:
        with self._lock:
            bucket = self._by_cause.get(seg["cause"])
            if bucket is None:
                bucket = self._by_cause[seg["cause"]] = []
            self._by_cause.move_to_end(seg["cause"])
            if len(bucket) >= self.max_segments_per_cause:
                self.dropped += 1
                return False
            if dedup and seg in bucket:
                return False  # periodic snapshots re-ship recent segments
            bucket.append(seg)
            while len(self._by_cause) > self.max_causes:
                self._by_cause.popitem(last=False)
        return True

    # ------------------------------------------------------------- attribution
    def note_command(self, cause: Optional[str], label: str) -> None:
        """Remember which command a wave cause id originated from, so a
        stitched timeline (and ``explain()``) can say "invalidated by
        command X" instead of only naming an opaque cause.
        First write wins: the origin member labels before any replayer."""
        if cause is None or not label:
            return
        with self._lock:
            if cause not in self._commands:
                self._commands[cause] = label
                while len(self._commands) > self.max_causes:
                    self._commands.popitem(last=False)

    def command_for(self, cause: Optional[str]) -> Optional[str]:
        if cause is None:
            return None
        with self._lock:
            return self._commands.get(cause)

    # ------------------------------------------------------------------ read
    def causes(self) -> List[str]:
        with self._lock:
            return list(self._by_cause)

    def latest_cause(self) -> Optional[str]:
        with self._lock:
            return next(reversed(self._by_cause), None)

    def segments_for(self, cause: str) -> List[dict]:
        with self._lock:
            return list(self._by_cause.get(cause, ()))

    def export_recent(self, host: Optional[str] = None, max_causes: int = 8) -> List[dict]:
        """The last ``max_causes`` causes' segments (optionally one host's
        only — what a publisher ships: each host ships what IT measured)."""
        with self._lock:
            recent = list(self._by_cause)[-max_causes:]
            segs = [dict(s) for c in recent for s in self._by_cause[c]]
        if host is not None:
            segs = [s for s in segs if s["host"] == host]
        return segs

    def clear(self) -> None:
        with self._lock:
            self._by_cause.clear()
            self._commands.clear()
        self.recorded = 0
        self.ingested = 0
        self.dropped = 0

    # ------------------------------------------------------------------ stitch
    def stitch(
        self,
        cause: str,
        clock: Optional[ClockSync] = None,
        expected_hosts: Optional[Sequence[str]] = None,
        local: Optional[str] = None,
    ) -> Optional[dict]:
        """ONE timeline for one wave: every remote segment mapped onto the
        local clock (``ClockSync.to_local`` — residual ≤ recorded RTT/2),
        per-level stall attribution, the pacing (host, shard) named per
        merge epoch, and a straggler table. ``None`` when the cause was
        never seen; a PARTIAL stitch (``expected_hosts`` not all present)
        is counted and flagged, never silent."""
        segs = self.segments_for(cause)
        if not segs:
            return None
        clock = clock or global_clock_sync()
        local = local or local_host()
        aligned = []
        for s in segs:
            if s["host"] == local:
                a0, a1 = s["t0"], s["t1"]
            else:
                a0 = clock.to_local(s["host"], s["t0"])
                a1 = clock.to_local(s["host"], s["t1"])
            aligned.append({**s, "a0": a0, "a1": a1})
        aligned.sort(key=lambda s: (s["a0"], s["a1"], s["host"], s["level"]))
        origin = min(s["a0"] for s in aligned)
        t_end = max(s["a1"] for s in aligned)
        hosts = sorted({s["host"] for s in aligned})
        missing = sorted(set(expected_hosts or ()) - set(hosts))
        partial = bool(missing)
        reg = global_metrics()
        reg.counter(
            "fusion_mesh_trace_stitches_total",
            help="stitched cross-host wave timelines assembled",
        ).inc()
        if partial:
            reg.counter(
                "fusion_mesh_trace_partial_stitches_total",
                help="stitches missing at least one expected host's segments "
                "(counted PARTIAL, never a silent single-host timeline)",
            ).inc()

        def rel(ts: float) -> float:
            return round((ts - origin) * 1e3, 3)

        # per merge epoch: the level's end on each host; the stall is the
        # spread between the first and last host to finish the level, and
        # the pacer is the (host, shard) of the latest-finishing segment
        by_level: Dict[int, List[dict]] = {}
        for s in aligned:
            if s["level"] >= 0:
                by_level.setdefault(s["level"], []).append(s)
        levels = []
        for lvl in sorted(by_level):
            group = by_level[lvl]
            host_end = {}
            for s in group:
                host_end[s["host"]] = max(host_end.get(s["host"], s["a1"]), s["a1"])
            pacer = max(group, key=lambda s: (s["a1"], s["host"]))
            stall_ms = 0.0
            if len(host_end) > 1:
                stall_ms = round((max(host_end.values()) - min(host_end.values())) * 1e3, 3)
            levels.append({
                "level": lvl,
                "start_ms": rel(min(s["a0"] for s in group)),
                "end_ms": rel(max(s["a1"] for s in group)),
                "stall_ms": stall_ms,
                "hosts": len(host_end),
                "paced_by": {"host": pacer["host"], "shard": pacer["shard"]},
            })
        straggler: Dict[tuple, dict] = {}
        for entry in levels:
            key = (entry["paced_by"]["host"], entry["paced_by"]["shard"])
            row = straggler.setdefault(
                key,
                {"host": key[0], "shard": key[1], "paced_levels": 0, "stall_ms_total": 0.0},
            )
            row["paced_levels"] += 1
            row["stall_ms_total"] = round(row["stall_ms_total"] + entry["stall_ms"], 3)
        straggler_rows = sorted(
            straggler.values(),
            key=lambda r: (-r["stall_ms_total"], -r["paced_levels"], r["host"], r["shard"]),
        )
        paced_by = None
        if levels:
            worst = max(levels, key=lambda e: (e["stall_ms"], e["level"]))
            paced_by = {
                "host": worst["paced_by"]["host"],
                "shard": worst["paced_by"]["shard"],
                "level": worst["level"],
                "stall_ms": worst["stall_ms"],
            }
        clock_table = {}
        for h in hosts:
            off, rtt = clock.offset(h), clock.rtt(h)
            clock_table[h] = {
                "offset_ms": None if off is None else round(off * 1e3, 3),
                "rtt_ms": None if rtt is None else round(rtt * 1e3, 3),
                # identity-mapped hosts (local / never probed) carry no
                # alignment error of their own
                "residual_ms": 0.0 if (h == local or rtt is None) else round(rtt * 5e2, 3),
            }
        out = {
            "cause": cause,
            "hosts": hosts,
            "partial": partial,
            "missing_hosts": missing,
            "duration_ms": rel(t_end),
            "clock": clock_table,
            "segments": [
                {
                    "host": s["host"], "phase": s["phase"], "level": s["level"],
                    "shard": s["shard"], "start_ms": rel(s["a0"]), "end_ms": rel(s["a1"]),
                }
                for s in aligned
            ],
            "levels": levels,
            "straggler": straggler_rows,
            "paced_by": paced_by,
        }
        command = self.command_for(cause)
        if command is not None:
            out["command"] = command
        return out


_TRACE: Optional[MeshTraceStore] = None
_TRACE_LOCK = threading.Lock()


def global_mesh_trace() -> MeshTraceStore:
    global _TRACE
    if _TRACE is None:
        with _TRACE_LOCK:
            if _TRACE is None:
                _TRACE = MeshTraceStore()
    return _TRACE


# ---------------------------------------------------------------------- fleet
class MeshTelemetryPublisher:
    """One host's side of the fleet plane: flatten the local registry into
    a transport-agnostic payload and push it — to the rendezvous board
    (:meth:`publish_board`, the channel that survives degrade) or over the
    rpc/tcp control plane (:meth:`publish_hub`)."""

    def __init__(
        self,
        member: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        period_s: float = 2.0,
        trace: Optional[MeshTraceStore] = None,
        max_segment_causes: int = 8,
        slo_engine: Optional[Any] = None,
        hotkeys: Optional[Any] = None,
    ):
        self.member = member or local_host()
        self.registry = registry or global_metrics()
        self.period_s = float(period_s)
        self.trace = trace or global_mesh_trace()
        self.max_segment_causes = max_segment_causes
        self.published = 0
        self.slo_engine = slo_engine
        self.hotkeys = hotkeys

    def _health(self) -> Optional[dict]:
        """This host's local SLO verdict, evaluated at publish time so the
        aggregator's mesh merge is at most one period behind. A publisher
        over a private registry (tests emulating a remote host) gets its
        own engine; the global-registry publisher shares the process one."""
        engine = self.slo_engine
        if engine is None:
            from .slo import SloEngine, global_slo_engine

            if self.registry is global_metrics():
                engine = global_slo_engine()
            else:
                engine = SloEngine(registry=self.registry, hotkeys=self.hotkeys)
            self.slo_engine = engine
        try:
            return engine.evaluate()
        except Exception:  # noqa: BLE001 — a judging fault must not stop telemetry
            return None

    def _sketches(self) -> dict:
        board = self.hotkeys
        if board is None:
            from .hotkeys import global_hotkeys

            board = self.hotkeys = global_hotkeys()
        try:
            return board.payload()
        except Exception:  # noqa: BLE001
            return {}

    def payload(self) -> dict:
        return {
            "member": self.member,
            "period_s": self.period_s,
            # the clock pair lets an aggregator that never ran a $sys
            # probe seed a coarse wall-clock alignment (refined — never
            # displaced — by genuine min-RTT probes)
            "wall_ts": time.time(),
            "perf_ts": now(),
            "series": self.registry.flat_samples(),
            "max_names": self.registry.max_aggregated_names(),
            "segments": self.trace.export_recent(
                host=self.member, max_causes=self.max_segment_causes
            ),
            # the judgment plane rides the same snapshot — the
            # host's local SLO verdict and its heavy-hitter sketches
            "health": self._health(),
            "sketches": self._sketches(),
        }

    def _count(self) -> None:
        self.published += 1
        global_metrics().counter(
            "fusion_mesh_telemetry_snapshots_total",
            help="local MetricsRegistry snapshots published onto the mesh "
            "control plane (board file or rpc/tcp frame)",
        ).inc()

    def publish_board(self, board) -> dict:
        """Atomic board-file publish (``RendezvousBoard.put_telemetry``) —
        the degrade-window path: file rendezvous needs no mesh."""
        payload = self.payload()
        board.put_telemetry(self.member, payload)
        self._count()
        return payload

    async def publish_hub(self, hub, peer_ref: Optional[str] = None,
                          service: str = "mesh-telemetry") -> dict:
        """Push one snapshot over the rpc control plane (a length-prefixed
        rpc/tcp frame when the hub's connector is ``tcp_client_connector``)."""
        payload = self.payload()
        reply = await hub.call(service, "publish", (payload,), peer_ref=peer_ref)
        self._count()
        return reply


class MeshTelemetryService:
    """RPC-facing ingest endpoint: ``hub.add_service("mesh-telemetry",
    MeshTelemetryService(aggregator))`` on the host that answers
    ``GET /metrics?scope=mesh``."""

    def __init__(self, aggregator: "MeshTelemetryAggregator"):
        self.aggregator = aggregator

    async def publish(self, payload: dict) -> dict:
        self.aggregator.ingest(payload)
        return {"ok": True, "hosts": self.aggregator.known_hosts()}


class MeshTelemetryAggregator:
    """Latest-snapshot-per-host table + the honest merge. Register once on
    the answering host; ``render_mesh_prometheus()`` backs
    ``GET /metrics?scope=mesh``."""

    def __init__(
        self,
        local_member: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        period_s: float = 2.0,
        clock: Optional[ClockSync] = None,
        trace: Optional[MeshTraceStore] = None,
        slo_engine: Optional[Any] = None,
        hotkeys: Optional[Any] = None,
    ):
        self.local_member = local_member or local_host()
        self.registry = registry or global_metrics()
        self.period_s = float(period_s)
        self.clock = clock or global_clock_sync()
        self.trace = trace or global_mesh_trace()
        self.slo_engine = slo_engine
        self.hotkeys = hotkeys
        self._lock = threading.Lock()
        self._snaps: Dict[str, dict] = {}
        self._received: Dict[str, float] = {}
        self._evicted: Set[str] = set()
        self.merges = 0
        self.registry.register_collector(self, MeshTelemetryAggregator._collect_metrics)
        self.registry.set_aggregation("fusion_mesh_telemetry_hosts_reporting", "max")

    def _collect_metrics(self) -> dict:
        """Stale markers surface in the LOCAL scrape too (same values the
        merged exposition carries) — an operator watching plain /metrics
        sees the fleet plane's health without asking for scope=mesh."""
        stale = self.stale_hosts()
        out = {
            "fusion_mesh_telemetry_hosts_reporting": float(
                len(self.fresh_hosts())
            ),
        }
        for h in self.known_hosts():
            out[f'fusion_mesh_telemetry_stale{{host="{h}"}}'] = 1.0 if h in stale else 0.0
        return out

    # ------------------------------------------------------------------ intake
    def ingest(self, payload: dict) -> None:
        member = payload.get("member")
        if not member:
            return
        with self._lock:
            self._snaps[member] = payload
            self._received[member] = time.time()
            # a flapped member that reports again is live again — evicted
            # status describes membership, and membership changed
            self._evicted.discard(member)
        self._seed_clock(member, payload)
        self.trace.ingest(payload.get("segments") or ())

    def _seed_clock(self, member: str, payload: dict) -> None:
        """Coarse wall-clock seed for a host no $sys probe ever measured:
        without SOME offset estimate, stitch falls to the identity map and
        cross-host order is garbage. The synthetic sample carries a
        deliberately pessimistic 50 ms RTT, so any genuine min-RTT probe
        immediately replaces it."""
        if member == self.local_member or self.clock.offset(member) is not None:
            return
        wall, perf = payload.get("wall_ts"), payload.get("perf_ts")
        if wall is None or perf is None:
            return
        t = now()
        remote_now_est = float(perf) + max(time.time() - float(wall), 0.0)
        self.clock.note_sample(member, t - 0.025, remote_now_est, t + 0.025)

    def sync_board(self, board) -> List[str]:
        """Pull every member's latest board telemetry file (the standing
        degrade-window channel) into the table."""
        seen = []
        for member, payload in board.read_telemetry().items():
            self.ingest(payload)
            seen.append(member)
        return sorted(seen)

    def mark_evicted(self, member: str) -> None:
        with self._lock:
            self._evicted.add(member)

    def note_members(self, members: Sequence[str]) -> None:
        """Reconcile with the controller's membership: anything we hold a
        snapshot for that the mesh no longer names is evicted (stale by
        membership, not just by age)."""
        live = set(members)
        with self._lock:
            for m in list(self._snaps):
                if m != self.local_member and m not in live:
                    self._evicted.add(m)

    # ------------------------------------------------------------------ state
    def known_hosts(self) -> List[str]:
        with self._lock:
            return sorted({self.local_member, *self._snaps, *self._evicted})

    def stale_hosts(self, now_wall: Optional[float] = None) -> Set[str]:
        now_wall = time.time() if now_wall is None else now_wall
        with self._lock:
            out = {
                m
                for m, at in self._received.items()
                if m != self.local_member and now_wall - at > 2.0 * self.period_s
            }
            out |= {m for m in self._evicted if m != self.local_member}
        return out

    def fresh_hosts(self, now_wall: Optional[float] = None) -> List[str]:
        stale = self.stale_hosts(now_wall)
        return [h for h in self.known_hosts() if h not in stale]

    # ------------------------------------------------------------------ merge
    def _per_host_series(self) -> Dict[str, Dict[str, float]]:
        per_host = {self.local_member: self.registry.flat_samples()}
        with self._lock:
            snaps = dict(self._snaps)
        for m, payload in snaps.items():
            if m == self.local_member:
                continue  # the answering host reads itself live
            series = payload.get("series") or {}
            per_host[m] = {
                k: float(v) for k, v in series.items() if isinstance(v, (int, float))
            }
        return per_host

    def _max_bases(self) -> Set[str]:
        bases = set(self.registry.max_aggregated_names())
        with self._lock:
            for payload in self._snaps.values():
                bases.update(payload.get("max_names") or ())
        return bases

    def merged_samples(self, now_wall: Optional[float] = None):
        """``(per_host, merged, stale)``: the merge covers FRESH hosts only
        — SUM by default, MAX for any base a contributing host declared
        MAX (two hosts each 5 ms behind are 5 ms behind, not 10)."""
        per_host = self._per_host_series()
        stale = self.stale_hosts(now_wall)
        max_bases = self._max_bases()
        merged: Dict[str, float] = {}
        for host in sorted(per_host):
            if host in stale:
                continue
            for k, v in per_host[host].items():
                base = k.partition("{")[0]
                if k in merged and base in max_bases:
                    merged[k] = max(merged[k], v)
                elif k in merged:
                    merged[k] += v
                else:
                    merged[k] = v
        return per_host, merged, stale

    def render_mesh_prometheus(self, now_wall: Optional[float] = None) -> str:
        """The ``scope=mesh`` exposition: merged series first (the fleet
        answer), then every host's contributing series labeled
        ``host="h<N>"`` (stale hosts keep their LAST-KNOWN labeled series —
        flagged by the stale gauge, never dropped). Labeled families get
        one ``# TYPE <base> gauge`` line, same discipline as the registry's
        own labeled-collector rendering."""
        per_host, merged, stale = self.merged_samples(now_wall)
        self.merges += 1
        global_metrics().counter(
            "fusion_mesh_telemetry_merges_total",
            help="mesh-scope merged expositions served (GET /metrics?scope=mesh)",
        ).inc()
        lines: List[str] = []
        typed: Set[str] = set()

        def emit(key: str, value: float) -> None:
            base = key.partition("{")[0]
            if base not in typed:
                lines.append(f"# TYPE {base} gauge")
                typed.add(base)
            lines.append(f"{key} {value}")

        hosts_known = self.known_hosts()
        emit(
            "fusion_mesh_telemetry_hosts_reporting",
            float(len([h for h in hosts_known if h not in stale])),
        )
        for h in hosts_known:
            emit(f'fusion_mesh_telemetry_stale{{host="{h}"}}', 1.0 if h in stale else 0.0)
        for k in sorted(merged):
            if k.partition("{")[0] in _META_BASES:
                continue  # emitted authoritatively above, from LIVE state
            emit(k, merged[k])
        for host in sorted(per_host):
            for k in sorted(per_host[host]):
                if 'host="' in k or k.partition("{")[0] in _META_BASES:
                    continue  # already host-scoped / the fleet-plane meta
                if k.endswith("}"):
                    labeled = f'{k[:-1]},host="{host}"}}'
                else:
                    labeled = f'{k}{{host="{host}"}}'
                emit(labeled, per_host[host][k])
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------ judgment
    def _local_engine(self):
        engine = self.slo_engine
        if engine is None:
            from .slo import SloEngine, global_slo_engine

            if self.registry is global_metrics():
                engine = global_slo_engine()
            else:
                engine = SloEngine(registry=self.registry, hotkeys=self.hotkeys)
            self.slo_engine = engine
        return engine

    def _local_board(self):
        board = self.hotkeys
        if board is None:
            from .hotkeys import global_hotkeys

            board = self.hotkeys = global_hotkeys()
        return board

    def mesh_health(self, now_wall: Optional[float] = None) -> dict:
        """The mesh-scope verdict behind ``GET /health``: the local engine
        evaluates live, every fresh remote contributes the verdict it
        shipped in its snapshot, and every stale/evicted host contributes
        a **degraded** entry — a host we cannot see is never healthy."""
        local = self._local_engine().evaluate()
        stale = self.stale_hosts(now_wall)
        with self._lock:
            remotes = {
                m: (snap.get("health") if isinstance(snap, dict) else None)
                for m, snap in self._snaps.items()
                if m != self.local_member
            }
        from .slo import merge_verdicts

        return merge_verdicts(
            local, remotes, sorted(stale), local_member=self.local_member
        )

    def merged_sketches(self, now_wall: Optional[float] = None) -> dict:
        """Per-domain heavy-hitter sketches folded across the local board
        and every FRESH remote snapshot (stale sketches would attribute a
        past workload to the present — excluded, same rule as series)."""
        from .hotkeys import HotKeyBoard

        stale = self.stale_hosts(now_wall)
        with self._lock:
            payloads = [
                snap.get("sketches")
                for m, snap in sorted(self._snaps.items())
                if m != self.local_member and m not in stale
                and isinstance(snap, dict)
            ]
        return HotKeyBoard.merge_payloads(
            [self._local_board().payload()] + [p for p in payloads if p]
        )

    def hotkeys_report(self, n: int = 5, now_wall: Optional[float] = None) -> dict:
        """Mesh-scope top-k per domain — the ``GET /hotkeys`` body."""
        merged = self.merged_sketches(now_wall)
        return {
            "scope": "mesh",
            "hosts": self.fresh_hosts(now_wall),
            "domains": {
                d: {"total": sk.total, "top": sk.topk(n)}
                for d, sk in sorted(merged.items())
            },
        }

    def summary(self, now_wall: Optional[float] = None) -> dict:
        now_wall = time.time() if now_wall is None else now_wall
        stale = self.stale_hosts(now_wall)
        with self._lock:
            ages = {
                m: round(now_wall - at, 3) for m, at in self._received.items()
            }
            evicted = sorted(self._evicted)
        return {
            "local": self.local_member,
            "hosts": self.known_hosts(),
            "fresh": [h for h in self.known_hosts() if h not in stale],
            "stale": sorted(stale),
            "evicted": evicted,
            "period_s": self.period_s,
            "snapshot_age_s": ages,
            "merges": self.merges,
        }
