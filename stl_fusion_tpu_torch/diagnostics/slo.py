"""Declarative SLOs + multi-window burn-rate verdicts.

The registry (metrics.py) measures; this module *judges*. An
:class:`SloSpec` binds a named objective to an existing registry series
(`fusion_e2e_delivery_ms` p99 ≤ budget, `fusion_superround_eager_rounds_total`
rate = 0, …) and owns the ONE comparator — :meth:`SloSpec.violated` — that
every consumer shares: the :class:`SloEngine` state machine behind
``GET /health``, ``FusionMonitor.report()["health"]``, and the perf-gate
``SloGate`` in perf/traffic_path.py. CI gates and ``/health`` can never
disagree about what "violated" means because they literally call the same
method.

The engine evaluates on demand (every ``/health`` hit, every mesh
telemetry publish) and keeps a bounded ring of observations per SLO. The
verdict is a multi-window burn-rate state machine in the SRE-workbook
style:

- **burning** (page): the violation fraction over the *fast* window
  crosses the fast ratio — the budget is burning NOW.
- **warn**: the *slow* window fraction crosses the slow ratio — a
  simmering problem that has not yet earned a page — or a just-recovered
  SLO still inside its hold-down (hysteresis: a verdict closes only after
  the fast window has been clean for ``hold_s``, so a flapping series
  cannot flap the page).
- **ok**: both windows clean and the hold-down elapsed.

Mesh scope: each host ships its local verdict inside the mesh telemetry
snapshot; :func:`merge_verdicts` folds them worst-wins, and a host whose
snapshot is stale contributes a **degraded** entry — stale is itself a
verdict, never silently healthy (the elastic-mesh lesson).

Windows and thresholds read their defaults from env
(``FUSION_SLO_FAST_S`` / ``FUSION_SLO_SLOW_S`` / ``FUSION_SLO_HOLD_S``,
``FUSION_SLO_DELIVERY_P99_MS`` / ``FUSION_SLO_SHED_RATE``) so the CI
smoke can compress minutes into seconds without forking the code path.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

__all__ = [
    "SloSpec",
    "SloEngine",
    "default_slos",
    "global_slo_engine",
    "merge_verdicts",
    "VERDICT_RANK",
]

#: severity order for merging — degraded (stale/unknown) outranks warn
#: because "we cannot see the host" is worse than "the host is simmering"
VERDICT_RANK: Dict[str, int] = {"ok": 0, "warn": 1, "degraded": 2, "burning": 3}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SloSpec:
    """One declarative objective bound to a registry series.

    ``kind`` selects how the engine observes the series:

    - ``"p99"``: 99th percentile of a registry histogram (ms).
    - ``"rate"``: per-second increase of a counter-like series (labeled
      collector samples summed over their base name).
    - ``"value"``: the instantaneous series value.

    ``comparator`` is how :meth:`violated` judges the observation against
    ``threshold``: ``"le"`` (healthy while value ≤ threshold, the default),
    ``"ge"`` (healthy while value ≥ threshold) or ``"eq"`` (healthy while
    value == threshold). ``attribution`` optionally names a hot-key domain
    (diagnostics/hotkeys.py) whose top entries ride along whenever this
    SLO is not ok — the verdict names its suspects.
    """

    __slots__ = (
        "name", "series", "kind", "threshold", "comparator",
        "description", "attribution", "unit",
    )

    def __init__(
        self,
        name: str,
        series: str = "",
        kind: str = "value",
        threshold: float = 0.0,
        comparator: str = "le",
        description: str = "",
        attribution: Optional[str] = None,
        unit: str = "",
    ):
        if kind not in ("p99", "rate", "value"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if comparator not in ("le", "ge", "eq"):
            raise ValueError(f"unknown SLO comparator {comparator!r}")
        self.name = name
        self.series = series
        self.kind = kind
        self.threshold = threshold
        self.comparator = comparator
        self.description = description
        self.attribution = attribution
        self.unit = unit

    def violated(self, value: Optional[float]) -> bool:
        """THE shared pass/fail comparator. ``None`` (a measurement that
        was attempted but produced nothing) counts as violated — a gate
        that measured nothing must fail loudly, not pass silently."""
        if value is None:
            return True
        if self.comparator == "eq":
            return value != self.threshold
        if self.comparator == "ge":
            return value < self.threshold
        return value > self.threshold


def default_slos() -> List[SloSpec]:
    """The shipped objectives (OBSERVABILITY.md §SLO catalog). Thresholds
    read env at call time so a harness can tighten/loosen per run."""
    return [
        SloSpec(
            "delivery_e2e_p99",
            series="fusion_e2e_delivery_ms",
            kind="p99",
            threshold=_env_float("FUSION_SLO_DELIVERY_P99_MS", 250.0),
            unit="ms",
            description="end-to-end invalidation delivery p99 within budget",
        ),
        SloSpec(
            "superround_eager_rounds",
            series="fusion_superround_eager_rounds_total",
            kind="rate",
            threshold=0.0,
            unit="/s",
            description="no rounds served by the counted eager fallback",
        ),
        SloSpec(
            "invariant_violations",
            series="fusion_invariant_violations",
            kind="value",
            threshold=0.0,
            unit="",
            description="the graph auditor has found zero invariant breaks",
        ),
        SloSpec(
            "edge_shed_rate",
            series="fusion_edge_shed_total",
            kind="rate",
            threshold=_env_float("FUSION_SLO_SHED_RATE", 0.5),
            unit="/s",
            attribution="tenant_sheds",
            description="admission shed rate within budget (per-tenant attribution)",
        ),
        SloSpec(
            "cmd_visible_p99",
            series="fusion_cmd_visible_ms",
            kind="p99",
            threshold=_env_float("FUSION_SLO_CMD_P99_MS", 250.0),
            unit="ms",
            description="command → client-visible invalidation p99 within budget",
        ),
        SloSpec(
            "cmd_error_rate",
            series="fusion_cmd_errors_total",
            kind="rate",
            threshold=_env_float("FUSION_SLO_CMD_ERROR_RATE", 0.0),
            unit="/s",
            description="no commands failing after bounded owner retries",
        ),
    ]


class _SloState:
    __slots__ = ("ring", "state", "state_since", "last_violation_t",
                 "last_value", "last_raw", "last_raw_t")

    def __init__(self):
        #: (t, value, violating) observations, pruned to the slow window
        self.ring: Deque[Tuple[float, Optional[float], bool]] = deque()
        self.state = "ok"
        self.state_since: Optional[float] = None
        self.last_violation_t: Optional[float] = None
        self.last_value: Optional[float] = None
        # rate-kind bookkeeping: previous raw counter reading
        self.last_raw: Optional[float] = None
        self.last_raw_t: Optional[float] = None


def _window_burn(
    ring: Deque[Tuple[float, Optional[float], bool]], t0: float
) -> Tuple[float, int]:
    """(violating fraction, sample count) over observations at/after t0."""
    n = 0
    bad = 0
    for t, _value, violating in ring:
        if t >= t0:
            n += 1
            if violating:
                bad += 1
    return (bad / n if n else 0.0), n


class SloEngine:
    """Evaluates a set of :class:`SloSpec` against a metrics registry and
    runs the multi-window burn-rate state machine per SLO."""

    def __init__(
        self,
        specs: Optional[List[SloSpec]] = None,
        registry: Optional[Any] = None,
        hotkeys: Optional[Any] = None,
        fast_s: Optional[float] = None,
        slow_s: Optional[float] = None,
        hold_s: Optional[float] = None,
        fast_ratio: float = 0.5,
        slow_ratio: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
    ):
        if registry is None:
            from .metrics import global_metrics

            registry = global_metrics()
        self.registry = registry
        self._hotkeys = hotkeys
        self.specs: List[SloSpec] = list(specs) if specs is not None else default_slos()
        self.fast_s = float(fast_s if fast_s is not None else _env_float("FUSION_SLO_FAST_S", 60.0))
        self.slow_s = float(slow_s if slow_s is not None else _env_float("FUSION_SLO_SLOW_S", 300.0))
        self.hold_s = float(hold_s if hold_s is not None else _env_float("FUSION_SLO_HOLD_S", self.fast_s))
        self.fast_ratio = float(fast_ratio)
        self.slow_ratio = float(slow_ratio)
        self.clock = clock
        self.wall = wall
        self.evaluations = 0
        self._lock = threading.Lock()
        self._states: Dict[str, _SloState] = {s.name: _SloState() for s in self.specs}
        registry.register_collector(self, SloEngine._collect_metrics)
        # per-SLO state is a rank, not a count: two engines at warn are at
        # warn, never at burning — scrape/merge as MAX (same contract as
        # fusion_superround_occupancy). Declared on the labeled series for
        # the in-process collector merge AND on the base name so the mesh
        # aggregator's base-name max set picks it up (mesh_telemetry.py).
        registry.set_aggregation("fusion_slo_state", "max")
        for spec in self.specs:
            registry.set_aggregation(f'fusion_slo_state{{slo="{spec.name}"}}', "max")

    # ------------------------------------------------------------------ observation
    def _observe(self, spec: SloSpec, st: _SloState, flat: Dict[str, float],
                 now: float) -> Tuple[Optional[float], bool]:
        """(value, have_observation) for one spec. Missing scalar series
        read as 0.0 (no shed counter means no sheds); an empty histogram
        yields NO observation (we cannot claim a latency we never saw)."""
        if spec.kind == "p99":
            h = self.registry.find(spec.series)
            if h is None or getattr(h, "count", 0) == 0:
                return None, False
            return h.percentile(99.0), True
        # scalar: sum flat samples over the base name (labeled collector
        # series like fusion_edge_shed_total{reason="..."} fold together)
        raw = 0.0
        for k, v in flat.items():
            if k == spec.series or k.partition("{")[0] == spec.series:
                raw += v
        if spec.kind == "value":
            return raw, True
        # rate: per-second increase since the previous evaluation
        prev_raw, prev_t = st.last_raw, st.last_raw_t
        st.last_raw, st.last_raw_t = raw, now
        if prev_raw is None or prev_t is None or now <= prev_t:
            return None, False  # first reading anchors the rate, no sample yet
        return max(0.0, raw - prev_raw) / (now - prev_t), True

    # ------------------------------------------------------------------ evaluate
    def evaluate(self) -> dict:
        """Take one observation per SLO, advance each state machine, and
        return the machine-readable local verdict (the ``/health`` body)."""
        now = self.clock()
        flat = self.registry.flat_samples()
        slos: List[dict] = []
        with self._lock:
            self.evaluations += 1
            for spec in self.specs:
                st = self._states[spec.name]
                value, have = self._observe(spec, st, flat, now)
                if have:
                    violating = spec.violated(value)
                    st.ring.append((now, value, violating))
                    st.last_value = value
                    if violating:
                        st.last_violation_t = now
                horizon = now - self.slow_s
                while st.ring and st.ring[0][0] < horizon:
                    st.ring.popleft()
                fast_frac, fast_n = _window_burn(st.ring, now - self.fast_s)
                slow_frac, slow_n = _window_burn(st.ring, horizon)
                prev = st.state
                if fast_n >= 2 and fast_frac >= self.fast_ratio:
                    state = "burning"
                elif slow_n >= 2 and slow_frac >= self.slow_ratio:
                    state = "warn"
                elif (
                    prev in ("burning", "warn")
                    and st.last_violation_t is not None
                    and (now - st.last_violation_t) < self.hold_s
                ):
                    state = "warn"  # hysteresis hold-down before closing
                else:
                    state = "ok"
                if state != prev:
                    st.state_since = now
                st.state = state
                entry = {
                    "name": spec.name,
                    "state": state,
                    "kind": spec.kind,
                    "series": spec.series,
                    "threshold": spec.threshold,
                    "unit": spec.unit,
                    "value": round(st.last_value, 4) if st.last_value is not None else None,
                    "burn": {
                        "fast": {"window_s": self.fast_s, "ratio": round(fast_frac, 4), "samples": fast_n},
                        "slow": {"window_s": self.slow_s, "ratio": round(slow_frac, 4), "samples": slow_n},
                    },
                }
                if state != "ok" and spec.attribution:
                    entry["attribution"] = {
                        "domain": spec.attribution,
                        "top": self._attribution(spec.attribution),
                    }
                slos.append(entry)
        worst = max(slos, key=lambda s: VERDICT_RANK.get(s["state"], 0), default=None)
        verdict = worst["state"] if worst is not None else "ok"
        return {
            "verdict": verdict,
            "scope": "local",
            "at": round(self.wall(), 3),
            "triggered_by": worst["name"] if worst is not None and verdict != "ok" else None,
            "slos": slos,
        }

    def _attribution(self, domain: str) -> List[dict]:
        board = self._hotkeys
        if board is None:
            from .hotkeys import global_hotkeys

            board = global_hotkeys()
        try:
            return board.topk(domain, 3)
        except Exception:  # noqa: BLE001 — attribution is garnish, never a crash
            return []

    # ------------------------------------------------------------------ telemetry
    def _collect_metrics(self) -> dict:
        with self._lock:
            out: Dict[str, float] = {
                "fusion_slo_evaluations_total": self.evaluations,
            }
            burning = 0
            for name, st in self._states.items():
                out[f'fusion_slo_state{{slo="{name}"}}'] = VERDICT_RANK.get(st.state, 0)
                if st.state == "burning":
                    burning += 1
            out["fusion_slo_burning"] = burning
            return out


def merge_verdicts(
    local: dict,
    remotes: Dict[str, Optional[dict]],
    stale_hosts: Optional[List[str]] = None,
    local_member: Optional[str] = None,
) -> dict:
    """Fold per-host verdicts into one mesh-scope verdict, worst-wins.

    ``remotes`` maps member → its last shipped local verdict (None when a
    host's snapshot predates the health plane). Every host in
    ``stale_hosts`` contributes a **degraded** entry regardless of what
    its stale snapshot claimed — a host we cannot see is never healthy."""
    stale = set(stale_hosts or ())
    hosts: Dict[str, dict] = {}
    worst_rank = -1
    worst_host: Optional[str] = None
    worst_slo: Optional[str] = None

    def _fold(member: str, verdict: Optional[dict], is_stale: bool) -> None:
        nonlocal worst_rank, worst_host, worst_slo
        if is_stale:
            entry = {
                "verdict": "degraded",
                "reason": "telemetry snapshot stale",
                "triggered_by": None,
            }
        elif not isinstance(verdict, dict):
            entry = {
                "verdict": "degraded",
                "reason": "no health verdict in snapshot",
                "triggered_by": None,
            }
        else:
            entry = {
                "verdict": verdict.get("verdict", "degraded"),
                "triggered_by": verdict.get("triggered_by"),
            }
        hosts[member] = entry
        rank = VERDICT_RANK.get(entry["verdict"], VERDICT_RANK["degraded"])
        if rank > worst_rank:
            worst_rank = rank
            worst_host = member
            worst_slo = entry.get("triggered_by")

    _fold(local_member or "local", local, False)
    for member in sorted(remotes):
        _fold(member, remotes[member], member in stale)
    for member in sorted(stale - set(remotes)):
        _fold(member, None, True)

    out = {
        "verdict": "ok" if worst_rank <= 0 else
        next(k for k, v in VERDICT_RANK.items() if v == worst_rank),
        "scope": "mesh",
        "at": local.get("at") if isinstance(local, dict) else None,
        "hosts": hosts,
        "stale": sorted(stale),
        "triggered_by": worst_slo if worst_rank > 0 else None,
        "triggered_host": worst_host if worst_rank > 0 else None,
        "slos": local.get("slos", []) if isinstance(local, dict) else [],
    }
    return out


_GLOBAL: Optional[SloEngine] = None
_GLOBAL_LOCK = threading.Lock()


def global_slo_engine() -> SloEngine:
    """The process-wide engine over ``global_metrics()`` and the default
    SLO catalog — ``/health`` and the mesh publisher evaluate here."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = SloEngine()
    return _GLOBAL
