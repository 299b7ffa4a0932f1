"""Process-wide metrics registry + wave profiler.

The single telemetry sink the rest of the system reports through: the
analogue of the reference hanging ``Meter``/``ActivitySource`` instances off
every component (src/Stl/Diagnostics/, SURVEY §5.1) — counters, gauges and
bounded log-scale histograms live HERE, with ``snapshot()`` for in-process
consumers (``FusionMonitor.report()``, bench records) and
``render_prometheus()`` for the ``/metrics`` route on the HTTP gateway.

Design rules, in tension and resolved as follows:

- **Hot paths keep their plain attribute counters** (``PeerOutbox.stats()``,
  ``ComputeFanoutIndex``, backend ``waves_run``): a registry hop per send
  would tax the exact paths the perf PRs fight for. Components instead
  register a *collector* — a cheap pull-time function the registry invokes
  only when someone actually snapshots/scrapes. Collectors are held through
  a weakref to their owner, so a dead hub/reader/breaker silently drops out
  instead of pinning itself (the FusionMonitor.dispose() lesson).
- **Histograms are bounded log-scale buckets** (powers of two between a
  floor and a ceiling): a flapping peer or a 10M-wave storm can record
  forever without growing memory, and p50/p99 estimates come from the
  cumulative bucket counts — the system reports its own latency
  distribution instead of leaving it to a bespoke harness
  (perf/fanout_path.py measured delivery p50/p99 from the outside; the
  ``fusion_e2e_delivery_ms`` histogram is the same number measured from
  the inside).
- **Values summed across collectors**: many live RpcHubs (tests, one hub
  per client) report the same metric name; the scrape shows the process
  total, matching Prometheus counter semantics.

``WaveProfiler`` is the per-wave timeline recorder ``TpuGraphBackend``
drives: a ring buffer of wave records (seed count, newly size, device vs
host milliseconds, journal depth pre/post coalescing, cause id) queryable
via ``FusionMonitor.report()["waves"]`` and dumped by bench.py — the
per-stage pipeline telemetry the streaming-dataflow papers (PAPERS.md)
lean on to find fusion-boundary stalls.
"""
from __future__ import annotations

import bisect
import itertools
import math
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "WaveProfiler",
    "global_metrics",
    "next_wave_seq",
]


def _sanitize(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*.

    A ``{label="value"}`` suffix is preserved verbatim (the cluster router
    exports per-peer series like ``fusion_routed_calls_total{peer="m0"}``);
    only the metric-name prefix is sanitized. Suffix values come from
    in-repo collectors, never from wire input."""
    if "{" in name and name.endswith("}"):
        base, _, labels = name.partition("{")
        return _sanitize(base) + "{" + labels
    out = []
    for i, ch in enumerate(name):
        ok = ch.isascii() and (ch.isalpha() or ch == "_" or ch == ":" or (ch.isdigit() and i > 0))
        out.append(ch if ok else "_")
    return "".join(out) or "_"


class Counter:
    """Monotonic counter. ``inc()`` is a plain float add — cheap enough for
    warm paths; the HOT paths (per-send, per-wave) keep attribute counters
    and report through collectors instead."""

    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Point-in-time value: ``set()`` or a pull-time callback ``fn``."""

    kind = "gauge"
    __slots__ = ("name", "help", "_value", "fn")

    def __init__(self, name: str, help: str = "", fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self._value = 0.0
        self.fn = fn

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:  # noqa: BLE001 — a dying callback must not kill a scrape
                return float("nan")
        return self._value

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Bounded log-scale histogram: bucket edges are ``lo * 2^k`` up to
    ``hi`` plus +inf — ~26 buckets cover µs..minute at millisecond units.
    Percentiles interpolate within the winning bucket (log-midpoint for
    the overflow bucket), which is exactly as honest as the bucket width;
    the raw bucket counts travel in ``snapshot()`` so nothing is hidden."""

    kind = "histogram"
    __slots__ = ("name", "help", "unit", "edges", "buckets", "count", "sum",
                 "min", "max", "ex_cap", "exemplars", "ex_recorded", "ex_evicted")

    #: exemplar ring bound — big enough to name several distinct causes in
    #: the tail, small enough that a million-sample storm stays O(1) memory
    EXEMPLAR_CAP = 8

    def __init__(self, name: str, help: str = "", unit: str = "ms",
                 lo: float = 0.001, hi: float = 120_000.0):
        self.name = name
        self.help = help
        self.unit = unit
        edges: List[float] = []
        edge = lo
        while edge <= hi:
            edges.append(edge)
            edge *= 2.0
        self.edges = edges  # upper bounds; final +inf bucket is implicit
        self.buckets = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # tail exemplars: cause-carrying samples, highest values
        # kept — an alert on this histogram links to /trace?cause= in one hop
        self.ex_cap = self.EXEMPLAR_CAP
        self.exemplars: List[list] = []
        self.ex_recorded = 0
        self.ex_evicted = 0

    def record(self, value: float, cause: Optional[str] = None) -> None:
        self.record_many(value, 1, cause)

    def record_many(self, value: float, n: int, cause: Optional[str] = None) -> None:
        """``n`` samples of the same value in one bucket update — the edge
        fan-out records one client-visible instant for a whole batch of
        synchronous-sink sessions (a per-session record() there would put
        a registry histogram inside a million-iteration loop). The single-
        sample :meth:`record` delegates here so the clamp + bucket logic
        exists once. ``cause`` (the wave cause id) offers the sample to the
        bounded exemplar ring — the tail keeps its provenance."""
        if n <= 0:
            return
        v = float(value)
        if v < 0.0 or v != v:  # clock skew / NaN: clamp, never throw
            v = 0.0
        self.buckets[bisect.bisect_left(self.edges, v)] += n
        self.count += n
        self.sum += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if cause is not None:
            self._offer_exemplar(v, cause)

    def _offer_exemplar(self, v: float, cause: Any) -> None:
        """Keep the highest-valued cause-carrying samples, ring bounded at
        ``ex_cap`` — replace the current minimum when the ring is full, so
        a burst of a million tail samples retains exactly ``ex_cap``."""
        ex = self.exemplars
        self.ex_recorded += 1
        if len(ex) < self.ex_cap:
            ex.append([v, str(cause), time.time()])
            return
        self.ex_evicted += 1
        mi = 0
        for i in range(1, len(ex)):
            if ex[i][0] < ex[mi][0]:
                mi = i
        if v >= ex[mi][0]:
            ex[mi] = [v, str(cause), time.time()]

    @staticmethod
    def _percentile_from(buckets, edges, count, observed_max, q: float) -> Optional[float]:
        if count == 0:
            return None
        target = count * q / 100.0
        cum = 0
        for i, n in enumerate(buckets):
            if n == 0:
                continue
            prev_cum = cum
            cum += n
            if cum >= target:
                if i < len(edges):
                    upper = edges[i]
                    lower = edges[i - 1] if i > 0 else 0.0
                else:  # overflow bucket: bounded by the observed max
                    lower = edges[-1]
                    upper = max(observed_max, lower)
                frac = (target - prev_cum) / n
                return lower + (upper - lower) * frac
        return observed_max if observed_max > -math.inf else None

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the q-th percentile (0-100) from the bucket counts."""
        return self._percentile_from(self.buckets, self.edges, self.count, self.max, q)

    def checkpoint(self) -> tuple:
        """Opaque marker for :meth:`since` — snapshot-and-diff lets a
        harness report THIS phase's distribution out of a histogram other
        phases also record into (perf/fanout_path.py separates its A/B
        modes this way)."""
        return (list(self.buckets), self.count, self.sum)

    def since(self, checkpoint: tuple) -> dict:
        """Snapshot of ONLY the samples recorded after ``checkpoint``
        (same shape as :meth:`snapshot`, minus min/max — those are not
        recoverable from a bucket diff)."""
        prev_buckets, prev_count, prev_sum = checkpoint
        buckets = [a - b for a, b in zip(self.buckets, prev_buckets)]
        count = self.count - prev_count
        p50 = self._percentile_from(buckets, self.edges, count, self.max, 50)
        p99 = self._percentile_from(buckets, self.edges, count, self.max, 99)
        return {
            "count": count,
            "sum": round(self.sum - prev_sum, 4),
            "p50": round(p50, 4) if p50 is not None else None,
            "p99": round(p99, 4) if p99 is not None else None,
            "unit": self.unit,
        }

    def snapshot(self) -> dict:
        out = {
            "count": self.count,
            "sum": round(self.sum, 4),
            "min": round(self.min, 4) if self.count else None,
            "max": round(self.max, 4) if self.count else None,
            "p50": round(self.percentile(50), 4) if self.count else None,
            "p99": round(self.percentile(99), 4) if self.count else None,
            "unit": self.unit,
            # sparse bucket map: upper-edge -> count (readable + bounded)
            "buckets": {
                ("+inf" if i == len(self.edges) else repr(self.edges[i])): n
                for i, n in enumerate(self.buckets)
                if n
            },
        }
        if self.exemplars:
            # highest first: the tail's provenance, cause id attached
            out["exemplars"] = [
                [round(v, 4), cause, round(ts, 3)]
                for v, cause, ts in sorted(self.exemplars, reverse=True)
            ]
        return out


#: collector: fn(owner) -> {metric_name: numeric value}; gauge semantics,
#: summed across collectors that report the same name
MetricCollector = Callable[[Any], Dict[str, float]]


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._collectors: List[Tuple["weakref.ref", MetricCollector]] = []
        #: per-name collector aggregation: "sum" (default — counter-like
        #: totals over hubs/peers) or "max" (non-additive gauges: ages,
        #: lags — two hubs each 5 ms behind are 5 ms behind, not 10)
        self._agg: Dict[str, str] = {}

    # ------------------------------------------------------------------ get-or-create
    def _get(self, name: str, cls, **kwargs):
        name = _sanitize(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a {type(m).__name__}, not a {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "", fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, Gauge, help=help)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "", unit: str = "ms",
                  lo: float = 0.001, hi: float = 120_000.0) -> Histogram:
        return self._get(name, Histogram, help=help, unit=unit, lo=lo, hi=hi)

    def find(self, name: str):
        """The metric if it exists — never creates (report paths must not
        mint empty metrics just by looking)."""
        return self._metrics.get(_sanitize(name))

    # ------------------------------------------------------------------ collectors
    def register_collector(self, owner: Any, fn: MetricCollector) -> None:
        """Attach a pull-time collector. ``owner`` is weakly referenced:
        when it dies the collector drops out at the next collection — no
        dispose() protocol needed, no pinning."""
        with self._lock:
            self._collectors.append((weakref.ref(owner), fn))

    def unregister_collector(self, owner: Any) -> None:
        with self._lock:
            self._collectors = [
                (ref, fn) for ref, fn in self._collectors if ref() is not owner
            ]

    def set_aggregation(self, name: str, mode: str) -> None:
        """Declare how collector values for ``name`` combine across owners:
        ``"sum"`` (default) or ``"max"``. Non-additive gauges (ages, lags)
        MUST declare max, or a process with N hubs scrapes N× the truth."""
        if mode not in ("sum", "max"):
            raise ValueError(f"unknown aggregation {mode!r}")
        with self._lock:
            self._agg[_sanitize(name)] = mode

    def _collect(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        dead = False
        with self._lock:
            collectors = list(self._collectors)
            agg = dict(self._agg)
        for ref, fn in collectors:
            owner = ref()
            if owner is None:
                dead = True
                continue
            try:
                values = fn(owner)
            except Exception:  # noqa: BLE001 — one broken collector never kills a scrape
                continue
            for k, v in values.items():
                if isinstance(v, (int, float)):
                    k = _sanitize(k)
                    if agg.get(k) == "max":
                        totals[k] = max(totals.get(k, v), v)
                    else:
                        totals[k] = totals.get(k, 0) + v
        if dead:
            with self._lock:
                self._collectors = [(r, f) for r, f in self._collectors if r() is not None]
        return totals

    # ------------------------------------------------------------------ export
    def _exemplar_totals(self) -> Dict[str, float]:
        """Registry-wide exemplar accounting: summed across all
        histograms, emitted only once any exemplar exists — a repo that
        never passes ``cause=`` scrapes exactly what it did before."""
        rec = ev = 0
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Histogram):
                rec += m.ex_recorded
                ev += m.ex_evicted
        if rec == 0:
            return {}
        return {
            "fusion_exemplars_recorded_total": float(rec),
            "fusion_exemplars_evicted_total": float(ev),
        }

    def snapshot(self) -> dict:
        """Nested dict of everything: registered metrics + collector sums."""
        out: Dict[str, Any] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            out[m.name] = m.snapshot()
        for k, v in self._collect().items():
            if k not in out:  # registered metrics win over collector shadows
                out[k] = v
        for k, v in self._exemplar_totals().items():
            out.setdefault(k, v)
        return out

    def flat_samples(self) -> Dict[str, float]:
        """One flat ``{series: value}`` map — the transport shape of a mesh
        telemetry snapshot. Counters/gauges contribute their
        value; histograms contribute ``_sum``/``_count`` (their buckets are
        per-process detail the fleet merge has no honest semantics for);
        collector samples ride as-is, registered metrics winning shadows."""
        out: Dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Histogram):
                out[f"{m.name}_sum"] = float(m.sum)
                out[f"{m.name}_count"] = float(m.count)
            else:
                out[m.name] = float(m.value)
        for k, v in self._collect().items():
            if k not in out:
                out[k] = float(v)
        for k, v in self._exemplar_totals().items():
            out.setdefault(k, v)
        return out

    def max_aggregated_names(self) -> List[str]:
        """The declared-MAX series names — shipped with every mesh snapshot
        so the cross-host merge applies the same non-additive contract the
        in-process collector merge does."""
        with self._lock:
            return sorted(k for k, mode in self._agg.items() if mode == "max")

    def render_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4)."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for i, n in enumerate(m.buckets):
                    cum += n
                    le = "+Inf" if i == len(m.edges) else repr(m.edges[i])
                    lines.append(f'{m.name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{m.name}_sum {m.sum}")
                lines.append(f"{m.name}_count {m.count}")
            else:
                v = m.value
                lines.append(f"{m.name} {v}")
        collected = self._collect()
        typed = {m.name for m in metrics}
        for k in sorted(collected):
            # labeled samples (fusion_routed_calls_total{peer="m0"}) belong
            # to their base family: ONE valid "# TYPE <base> gauge" line,
            # never a TYPE line with a brace-suffixed name (which breaks
            # the whole scrape — the exposition name charset is strict)
            base = k.partition("{")[0]
            if k == base and base in typed:
                continue  # registered metrics win over collector shadows
            if base not in typed:
                lines.append(f"# TYPE {base} gauge")
                typed.add(base)
            lines.append(f"{k} {collected[k]}")
        for k, v in sorted(self._exemplar_totals().items()):
            if k not in typed:
                lines.append(f"# TYPE {k} gauge")
                lines.append(f"{k} {v}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        """Drop every metric, collector and aggregation override (tests)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()
            self._agg.clear()


_GLOBAL = MetricsRegistry()


def global_metrics() -> MetricsRegistry:
    """The process-wide registry — components report here with no wiring,
    exactly like ``resilience.events.global_events()``."""
    return _GLOBAL


# ---------------------------------------------------------------------- waves

_wave_seq = itertools.count(1)


def next_wave_seq() -> int:
    """Mint the next process-wide wave sequence number. The backend mints
    it at ``_begin_wave`` (so the flight recorder can stamp events DURING
    wave application with the wave they belong to) and hands it back to
    :meth:`WaveProfiler.record_wave` — one numbering for both rings."""
    return next(_wave_seq)


class WaveProfiler:
    """Per-wave timeline ring buffer for a TpuGraphBackend.

    One record per device wave dispatch (union / lanes / seq / collect /
    icasc): seed count, newly-invalidated size, device milliseconds
    (dispatch → readback), host-apply milliseconds (two-tier apply + hook
    drain), the journal depth the preceding flush replayed (pre/post
    coalescing) and its host cost, and the wave's cause id — the same id
    the fan-out stamps into ``$sys-c`` frames, so a client-side delivery
    sample joins back to its wave record.

    Bounded and cheap: a deque of small dicts plus two registry histograms;
    ``enabled = False`` reduces every call to one attribute check (the
    <3% live-path overhead budget is enforced by bench telemetry)."""

    def __init__(self, capacity: int = 256, metrics: Optional[MetricsRegistry] = None):
        self.enabled = True
        self._ring: Deque[dict] = deque(maxlen=capacity)
        self.metrics = metrics if metrics is not None else global_metrics()
        self.waves_recorded = 0
        self.flushes_recorded = 0
        # totals survive ring eviction — the summary stays whole-run honest
        self.device_ms_total = 0.0
        self.apply_ms_total = 0.0
        self.flush_ms_total = 0.0
        self.newly_total = 0
        self._pending_flush: Optional[dict] = None
        #: fused-chain accounting: logical waves per physical
        #: dispatch, and the bench-layer negative-timing rejects that were
        #: previously counted only inside BENCH_*.json
        self.fused_dispatches = 0
        self.fused_waves_total = 0
        self.timing_rejects_total = 0

    # ------------------------------------------------------------------ feed
    def note_flush(self, journal_pre: int, journal_post: int, host_ms: float) -> None:
        """Record one journal flush; attached to the NEXT wave record (the
        flush a wave path runs before dispatching is part of that wave's
        latency story). A flush with no following wave stays visible in
        the totals."""
        if not self.enabled:
            return
        self.flushes_recorded += 1
        self.flush_ms_total += host_ms
        self._pending_flush = {
            "journal_pre": journal_pre,
            "journal_post": journal_post,
            "flush_ms": round(host_ms, 3),
        }

    def note_fused_dispatch(self, fused_depth: int) -> None:
        """One physical device dispatch that FUSED ``fused_depth`` > 1
        logical waves (wave-chain fusion). Feeds the
        ``fusion_wave_fused_depth`` histogram — the CI live smoke asserts
        it is non-empty with p50 > 1, i.e. the fused path actually engaged
        instead of silently falling back to eager one-wave dispatches.
        Plain one-wave dispatches are NOT recorded: a workload full of
        ordinary lone bursts would otherwise dilute the engagement metric
        below the gate even while every chain-eligible wave fused (and the
        log-bucket interpolation of depth-1 samples reads below 1.0)."""
        if not self.enabled or fused_depth <= 1:
            return
        self.fused_dispatches += 1
        self.fused_waves_total += int(fused_depth)
        self.metrics.histogram(
            "fusion_wave_fused_depth",
            help="logical waves per physical device dispatch (wave-chain fusion; depth>1 only)",
            unit="waves", lo=1.0, hi=4096.0,
        ).record(float(fused_depth))

    def note_timing_rejects(self, n: int, source: str = "") -> None:
        """Negative chain-difference samples rejected by the timing
        belt (bench.py / live_path.py) — previously bench-local counters;
        exported here as ``fusion_wave_timing_rejects_total`` and surfaced
        in ``FusionMonitor.report()["waves"]`` so the belt is observable
        in production scrapes, not just BENCH_*.json."""
        if n <= 0:
            return
        self.timing_rejects_total += int(n)
        c = self.metrics.counter(
            "fusion_wave_timing_rejects_total",
            help="negative per-wave timing samples rejected as measurement artifacts",
        )
        c.inc(int(n))

    def record_wave(
        self,
        kind: str,
        seeds: int,
        newly: int,
        device_ms: float,
        apply_ms: float,
        cause: Optional[str] = None,
        groups: Optional[int] = None,
        seq: Optional[int] = None,
        fused_depth: Optional[int] = None,
        seq_span: Optional[tuple] = None,
        dispatches: Optional[int] = None,
        mesh: Optional[dict] = None,
    ) -> None:
        if not self.enabled:
            return
        rec = {
            "seq": seq if seq is not None else next(_wave_seq),
            "kind": kind,
            "at": time.time(),
            "seeds": int(seeds),
            "newly": int(newly),
            "device_ms": round(device_ms, 3),
            "apply_ms": round(apply_ms, 3),
            "cause": cause,
        }
        if groups is not None:
            rec["groups"] = int(groups)
        if fused_depth is not None:
            # per-logical-wave identity survives physical fusion: the
            # record covers the CONTIGUOUS seq span [seq_span[0],
            # seq_span[1]] (one seq per logical wave), and explain()
            # resolves any seq inside the span to this record
            rec["fused_depth"] = int(fused_depth)
        if seq_span is not None:
            rec["seq_span"] = [int(seq_span[0]), int(seq_span[1])]
        if dispatches is not None:
            rec["dispatches"] = int(dispatches)
        if mesh is not None:
            # the shard hop: exchange mode, collective levels, placement
            # epoch — explain() renders it ("frontier exchanged on-mesh")
            rec["mesh"] = dict(mesh)
        if self._pending_flush is not None:
            rec.update(self._pending_flush)
            self._pending_flush = None
        self._ring.append(rec)
        self.waves_recorded += 1
        self.device_ms_total += device_ms
        self.apply_ms_total += apply_ms
        self.newly_total += int(newly)
        self.metrics.histogram(
            "fusion_wave_device_ms", help="device wave dispatch->readback latency"
        ).record(device_ms, cause=cause)
        self.metrics.histogram(
            "fusion_wave_apply_ms", help="host two-tier wave application latency"
        ).record(apply_ms, cause=cause)

    # ------------------------------------------------------------------ query
    def recent(self, n: Optional[int] = None) -> List[dict]:
        out = list(self._ring)
        return out[-n:] if n is not None else out

    def summary(self) -> dict:
        dev = self.metrics.find("fusion_wave_device_ms")
        fused = self.metrics.find("fusion_wave_fused_depth")
        return {
            "enabled": self.enabled,
            "waves_recorded": self.waves_recorded,
            "flushes_recorded": self.flushes_recorded,
            "newly_total": self.newly_total,
            "device_ms_total": round(self.device_ms_total, 2),
            "apply_ms_total": round(self.apply_ms_total, 2),
            "flush_ms_total": round(self.flush_ms_total, 2),
            "device_ms_p50": (
                round(dev.percentile(50), 4) if dev is not None and dev.count else None
            ),
            "device_ms_p99": (
                round(dev.percentile(99), 4) if dev is not None and dev.count else None
            ),
            # fused-chain engagement: dispatches carrying >1
            # logical wave; the live smoke asserts fused_depth_p50 > 1
            "fused_dispatches": self.fused_dispatches,
            "fused_waves_total": self.fused_waves_total,
            "fused_depth_p50": (
                round(fused.percentile(50), 2)
                if fused is not None and fused.count else None
            ),
            "fused_depth_p99": (
                round(fused.percentile(99), 2)
                if fused is not None and fused.count else None
            ),
            # negative-timing rejects, observable
            "timing_rejects": self.timing_rejects_total,
        }

    def report(self, recent: int = 32) -> dict:
        return {**self.summary(), "recent": self.recent(recent)}
