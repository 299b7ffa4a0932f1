"""Edge admission control — overload safety at the serving boundary.

The reference Stl.Fusion survives overload by
bounding the work any one node accepts (bounded compute retries, pruner
backpressure — PAPER.md §L1/§2.6); this module is that discipline applied
to the edge tier's FRONT door. An :class:`AdmissionController` sits in
front of :class:`~.gateway.EdgeNode` and both transports
(:class:`~.server.EdgeHttpServer` / :class:`~.server.EdgeWebSocketServer`)
and decides, per connection/attach, one of ADMIT or SHED — before the
request has cost a watch loop, an upstream subscription or a fan-shard
slot. The pieces:

- **per-tenant token buckets** — connection-rate and subscribe-rate
  limits, resolved through the existing
  :class:`~...ext.multitenancy.TenantResolver` (default tenant in
  single-tenant deployments). One tenant's flash crowd exhausts ITS
  bucket; every other tenant's lane keeps its full rate.
- **priority lanes** — ``resume`` (reconnects replaying a resume token)
  and ``priority`` (tenants flagged ``priority=True``) are admitted ahead
  of ``anonymous`` cold attaches: the global concurrent-attach gate keeps
  reserved headroom per lane (anonymous fills at most
  ``1 - resume_reserve - priority_reserve`` of it), and pressure-shedding
  cuts the anonymous lane first. A reconnect storm after a deploy never
  queues behind a cold flash crowd.
- **global concurrent-attach gate** — bounds attach operations IN FLIGHT
  (head read → attach → replay) across every transport, with a per-tenant
  share cap so one tenant cannot occupy the whole gate.
- **pressure feedback** — downstream saturation signals (worker-pipe
  handoff drops, fan-shard queue depth — registered as pull-time sources)
  raise :meth:`pressure`; above ``shed_pressure`` the anonymous lane
  sheds, and the owning EdgeNode widens its upstream re-read batching
  window (``effective_reread_window``) so overload degrades to higher
  latency before it degrades to evictions.

Every decision is COUNTED, never silent: ``fusion_edge_admitted_total``
per lane, ``fusion_edge_shed_total`` per reason, the live pressure and
in-flight gauges. Rejections answer 503 with ``Retry-After`` (SSE) or a
clean WS error — see :func:`rejection_bytes`, the ONE responder both the
SSE server and the worker pool's parent accept plane write. Admission
applies only at the boundary: an already-admitted session is NEVER torn
down by the controller (eviction stays what it always was — a slow
consumer's own backpressure story).

A drain (:meth:`EdgeNode.drain`) flips :attr:`draining`: everything sheds
with reason ``draining`` while live sessions are hinted to reconnect
elsewhere — the rolling-deploy runbook in EDGE.md.
"""
from __future__ import annotations

import json
import logging
import math
import time
from typing import Callable, Dict, Optional

from ..diagnostics.hotkeys import global_hotkeys
from ..diagnostics.metrics import global_metrics

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "AdmissionRejected",
    "rejection_bytes",
    "LANE_RESUME",
    "LANE_PRIORITY",
    "LANE_ANONYMOUS",
]

LANE_RESUME = "resume"
LANE_PRIORITY = "priority"
LANE_ANONYMOUS = "anonymous"
_LANES = (LANE_RESUME, LANE_PRIORITY, LANE_ANONYMOUS)


def rejection_bytes(
    status: str, payload: dict, retry_after: Optional[float] = None
) -> bytes:
    """The ONE HTTP rejection responder: admission
    503s, key-allowlist 400s and replay-evicted 409s all ship this shape —
    a JSON body, ``Connection: close`` (a shed connection must not be
    kept-alive into a retry loop on the same socket), and ``Retry-After``
    when the shed is retryable. Shared by the SSE server and the worker
    pool's parent accept plane, so the two planes' rejections cannot
    drift."""
    body = json.dumps(payload, separators=(",", ":")).encode()
    head = [
        f"HTTP/1.1 {status}",
        "Content-Type: application/json",
        f"Content-Length: {len(body)}",
        "Cache-Control: no-cache",
        "Connection: close",
    ]
    if retry_after is not None and math.isfinite(retry_after):
        # a non-finite retry (a zero-rate bucket's honest "never") must
        # not turn the answered 503 into an OverflowError-dropped socket;
        # the header is simply omitted and the client treats it as opaque
        head.append(
            f"Retry-After: {max(1, min(3600, int(math.ceil(retry_after))))}"
        )
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


class TokenBucket:
    """Deterministic token bucket: ``rate`` tokens/second up to ``burst``
    capacity, refilled lazily from an injectable monotonic ``clock`` (the
    tests drive a fake clock — no sleeps, no flakes)."""

    __slots__ = ("rate", "burst", "tokens", "_last", "clock")

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.clock = clock
        self._last = clock()

    def _refill(self) -> None:
        now = self.clock()
        elapsed = now - self._last
        if elapsed > 0:
            self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 when they
        already are) — the honest ``Retry-After`` a shed client gets."""
        self._refill()
        missing = n - self.tokens
        if missing <= 0:
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return missing / self.rate


class AdmissionDecision:
    """One admit/shed verdict. Truthy iff admitted. A ``hold=True``
    admission occupies a gate slot until :meth:`AdmissionController.release`
    (the transports hold across head-read → attach → replay); ``hold=False``
    checks the gate against current holds without occupying it (the
    synchronous in-process attach path)."""

    __slots__ = ("admitted", "lane", "tenant_id", "reason", "retry_after", "_held")

    def __init__(self, admitted, lane, tenant_id, reason=None, retry_after=None):
        self.admitted = admitted
        self.lane = lane
        self.tenant_id = tenant_id
        self.reason = reason
        self.retry_after = retry_after
        self._held = False

    def __bool__(self) -> bool:
        return self.admitted

    def __repr__(self) -> str:  # operator/debug surface
        if self.admitted:
            return f"<admitted lane={self.lane} tenant={self.tenant_id!r}>"
        return (
            f"<shed reason={self.reason} lane={self.lane} "
            f"tenant={self.tenant_id!r} retry_after={self.retry_after}>"
        )


class AdmissionRejected(RuntimeError):
    """Raised by EdgeNode.attach/resume when the installed controller
    sheds the request (in-process callers; the transports answer 503/WS
    errors instead of raising)."""

    def __init__(self, decision: AdmissionDecision):
        super().__init__(
            f"admission rejected ({decision.reason}; lane={decision.lane}, "
            f"tenant={decision.tenant_id!r})"
        )
        self.decision = decision


class AdmissionController:
    """Admit/shed decisions for one edge process.

    ``registry``/``resolver`` are the existing multitenancy pieces
    (``ext/multitenancy.py``); omitted, a single-tenant registry is
    minted and every request resolves to the default tenant. Knobs:

    - ``connect_rate``/``connect_burst``: per-tenant connection token
      bucket (attaches/second sustained, burst capacity).
    - ``subscribe_rate``/``subscribe_burst``: per-tenant KEY-subscribe
      bucket — an attach naming N keys takes N tokens, bounding the
      upstream-subscription minting rate per tenant.
    - ``resume_rate``/``resume_burst``: the resume lane's own (global)
      bucket — reconnects replay parked state and mint no new upstream
      subs, so they ride a wider pipe and never compete with cold
      attaches for tenant tokens.
    - ``max_concurrent``: the global concurrent-attach gate.
      ``resume_reserve``/``priority_reserve`` carve reserved headroom:
      anonymous admits while holds < max*(1-rr-pr), priority while
      holds < max*(1-rr), resume up to the full gate — the lane ORDER.
    - ``tenant_gate_share``: max fraction of the gate one non-default
      tenant may hold (isolation; not applied in single-tenant mode).
    - ``shed_pressure``: anonymous cold attaches shed once
      :meth:`pressure` crosses this (priority/resume lanes keep
      admitting — overload cuts the cheapest-to-retry lane first).
    - ``retry_after``: the default Retry-After for non-rate sheds.
    - ``clock``: injectable monotonic clock (tests).
    """

    def __init__(
        self,
        registry=None,
        resolver=None,
        *,
        connect_rate: float = 500.0,
        connect_burst: float = 1000.0,
        subscribe_rate: float = 5000.0,
        subscribe_burst: float = 10000.0,
        resume_rate: float = 5000.0,
        resume_burst: float = 10000.0,
        max_concurrent: int = 1024,
        resume_reserve: float = 0.25,
        priority_reserve: float = 0.25,
        tenant_gate_share: float = 0.5,
        shed_pressure: float = 0.9,
        retry_after: float = 1.0,
        clock=time.monotonic,
        name: str = "edge",
    ):
        from ..ext.multitenancy import TenantRegistry, TenantResolver

        self.registry = registry if registry is not None else TenantRegistry()
        self.resolver = (
            resolver if resolver is not None else TenantResolver(self.registry)
        )
        self.connect_rate = connect_rate
        self.connect_burst = connect_burst
        self.subscribe_rate = subscribe_rate
        self.subscribe_burst = subscribe_burst
        self.max_concurrent = int(max_concurrent)
        if not 0.0 <= resume_reserve + priority_reserve < 1.0:
            raise ValueError("lane reserves must leave anonymous headroom")
        self.resume_reserve = resume_reserve
        self.priority_reserve = priority_reserve
        self.tenant_gate_share = tenant_gate_share
        self.shed_pressure = shed_pressure
        self.retry_after = retry_after
        self.clock = clock
        self.name = name
        self.draining = False
        self._resume_bucket = TokenBucket(resume_rate, resume_burst, clock)
        #: tenant id -> (connect bucket, subscribe bucket), minted lazily
        self._buckets: Dict[str, tuple] = {}
        #: gate occupancy: held (hold=True, unreleased) admissions
        self._in_flight = 0
        self._tenant_in_flight: Dict[str, int] = {}
        #: pull-time pressure sources: name -> fn() -> 0..1 (fan-shard
        #: depth, worker-pipe drops, ...); set_pressure() installs a
        #: constant (tests, external signals)
        self._pressure_sources: Dict[str, Callable[[], float]] = {}
        # -- counters (collector-exported) --------------------------------
        self.admitted_by_lane: Dict[str, int] = {lane: 0 for lane in _LANES}
        self.shed_by_reason: Dict[str, int] = {}
        reg = global_metrics()
        # non-additive gauges combine by MAX across controllers (two
        # half-loaded controllers are half loaded, not fully loaded)
        reg.set_aggregation("fusion_edge_admission_pressure", "max")
        reg.register_collector(self, AdmissionController._collect_metrics)

    # ------------------------------------------------------------- pressure
    def add_pressure_source(self, name: str, fn: Callable[[], float]) -> None:
        self._pressure_sources[name] = fn

    def set_pressure(self, name: str, value: float) -> None:
        """Install a constant pressure source (or overwrite one)."""
        v = float(value)
        self._pressure_sources[name] = lambda: v

    def clear_pressure(self, name: str) -> None:
        self._pressure_sources.pop(name, None)

    def pressure(self) -> float:
        """The load signal, 0..1: the MAX over registered sources — one
        saturated plane is enough to start shedding; a healthy plane never
        hides a wedged one behind an average."""
        worst = 0.0
        for fn in list(self._pressure_sources.values()):
            try:
                worst = max(worst, float(fn()))
            except Exception:  # noqa: BLE001 — a dying source must not
                # turn admission into an exception path
                log.exception("admission %s: pressure source failed", self.name)
        return min(1.0, max(0.0, worst))

    # ------------------------------------------------------------- tenants
    def _tenant_buckets(self, tenant_id: str) -> tuple:
        buckets = self._buckets.get(tenant_id)
        if buckets is None:
            buckets = self._buckets[tenant_id] = (
                TokenBucket(self.connect_rate, self.connect_burst, self.clock),
                TokenBucket(self.subscribe_rate, self.subscribe_burst, self.clock),
            )
        return buckets

    def _resolve(self, tenant_id: Optional[str]):
        """Tenant id (wire string) -> registered Tenant; None/"" is the
        default tenant. Returns None when the id names no registered
        tenant (shed, counted — a typo'd tenant must not mint unbounded
        per-tenant bucket state). The registry lookup is the fast path
        (what the default resolver does after parsing the id back out of
        a session suffix — minting a Session per admit() would put a
        urandom read on the hot accept path); a CUSTOM resolver still
        gets consulted for ids the registry does not key directly."""
        from ..ext.multitenancy import Session, TenantNotFoundError

        tenant = self.registry.try_get(tenant_id or "")
        if tenant is not None:
            return tenant
        if not tenant_id:
            return None
        try:
            return self.resolver.resolve(Session.new(tenant_id))
        except TenantNotFoundError:
            return None

    # ------------------------------------------------------------- admit
    def _shed(
        self, lane: str, tenant_id: str, reason: str,
        retry_after: Optional[float] = None,
    ) -> AdmissionDecision:
        self.shed_by_reason[reason] = self.shed_by_reason.get(reason, 0) + 1
        # attribution: the per-tenant shed sketch is what the
        # edge_shed_rate SLO names in its /health attribution block
        global_hotkeys().offer("tenant_sheds", tenant_id or "(default)")
        if retry_after is None:
            retry_after = self.retry_after
        elif not math.isfinite(retry_after):
            # a zero-rate bucket answers "an hour", not Infinity (which
            # is not even valid JSON on the wire)
            retry_after = 3600.0
        return AdmissionDecision(
            False, lane, tenant_id, reason=reason, retry_after=retry_after,
        )

    def note_shed(self, reason: str) -> None:
        """Count a shed decided OUTSIDE admit() — the transports' unified
        rejection path (bad_request / replay_evicted / resume_expired) and
        the worker pool's dropped fd-handoffs ride the same counter."""
        self.shed_by_reason[reason] = self.shed_by_reason.get(reason, 0) + 1

    def _lane_ceiling(self, lane: str) -> int:
        if lane == LANE_RESUME:
            return self.max_concurrent
        if lane == LANE_PRIORITY:
            return int(self.max_concurrent * (1.0 - self.resume_reserve))
        return int(
            self.max_concurrent
            * (1.0 - self.resume_reserve - self.priority_reserve)
        )

    def admit(
        self,
        tenant_id: str = "",
        lane: Optional[str] = None,
        keys: int = 0,
        hold: bool = False,
    ) -> AdmissionDecision:
        """One admission decision. ``lane=None`` derives it from the
        tenant (``priority`` tenants ride the priority lane, everything
        else is anonymous); pass ``lane="resume"`` for reconnects. With
        ``hold`` the caller occupies a gate slot until :meth:`release`."""
        tenant = self._resolve(tenant_id)
        if tenant is None:
            return self._shed(
                lane or LANE_ANONYMOUS, tenant_id, "unknown_tenant",
                retry_after=0.0,
            )
        tid = tenant.id
        if lane is None:
            lane = (
                LANE_PRIORITY
                if getattr(tenant, "priority", False)
                else LANE_ANONYMOUS
            )
        if self.draining:
            return self._shed(lane, tid, "draining")
        # -- NON-CONSUMING checks first (pressure, gate): a request shed
        # here must not burn the tenant's rate budget — otherwise a
        # client retrying per Retry-After through sustained pressure
        # drains its bucket to zero and keeps being shed ("rate") after
        # the pressure clears, on an idle node
        # -- pressure shed: the anonymous lane goes first
        if lane == LANE_ANONYMOUS and self.pressure() >= self.shed_pressure:
            return self._shed(lane, tid, "pressure")
        # -- the global gate with lane-reserved headroom ------------------
        if self._in_flight >= self._lane_ceiling(lane):
            return self._shed(lane, tid, "gate_full")
        # -- per-tenant gate share (multi-tenant only: in single-tenant
        # mode everyone IS the default tenant and a share cap would just
        # be a second, surprising gate)
        if tid and len(self.registry.all_tenants) > 1:
            share = max(1, int(self.max_concurrent * self.tenant_gate_share))
            if self._tenant_in_flight.get(tid, 0) >= share:
                return self._shed(lane, tid, "tenant_gate")
        # -- rate buckets (per tenant; the resume lane rides its own) -----
        connect, subscribe = self._tenant_buckets(tid)
        if lane == LANE_RESUME:
            if not self._resume_bucket.try_take(1.0):
                return self._shed(
                    lane, tid, "rate", self._resume_bucket.retry_after(1.0)
                )
        else:
            if not connect.try_take(1.0):
                return self._shed(lane, tid, "rate", connect.retry_after(1.0))
            if keys > 0 and not subscribe.try_take(float(keys)):
                return self._shed(
                    lane, tid, "subscribe_rate",
                    subscribe.retry_after(float(keys)),
                )
        decision = AdmissionDecision(True, lane, tid)
        self.admitted_by_lane[lane] = self.admitted_by_lane.get(lane, 0) + 1
        global_hotkeys().offer("tenant_admits", tid or "(default)")
        if hold:
            decision._held = True
            self._in_flight += 1
            self._tenant_in_flight[tid] = self._tenant_in_flight.get(tid, 0) + 1
        return decision

    def admit_keys(self, tenant_id: str = "", keys: int = 0) -> AdmissionDecision:
        """Charge ONLY the per-tenant subscribe bucket (the worker-pool
        plane: the connection was admitted at the accept hop BEFORE its
        key specs were readable, so the key debit lands when the worker
        forwards them). Resumed sessions are exempt — they replay, they
        do not mint new upstream state. Does not touch the connect
        bucket, the gate, or the admitted-per-lane counters (the
        connection already counted)."""
        tenant = self._resolve(tenant_id)
        if tenant is None:
            return self._shed(
                LANE_ANONYMOUS, tenant_id, "unknown_tenant", retry_after=0.0
            )
        if keys <= 0:
            return AdmissionDecision(True, LANE_ANONYMOUS, tenant.id)
        _connect, subscribe = self._tenant_buckets(tenant.id)
        if not subscribe.try_take(float(keys)):
            return self._shed(
                LANE_ANONYMOUS, tenant.id, "subscribe_rate",
                subscribe.retry_after(float(keys)),
            )
        return AdmissionDecision(True, LANE_ANONYMOUS, tenant.id)

    def release(self, decision: Optional[AdmissionDecision]) -> None:
        """Release a held gate slot (idempotent per decision)."""
        if decision is None or not decision._held:
            return
        decision._held = False
        self._in_flight = max(0, self._in_flight - 1)
        tid = decision.tenant_id
        left = self._tenant_in_flight.get(tid, 0) - 1
        if left > 0:
            self._tenant_in_flight[tid] = left
        else:
            self._tenant_in_flight.pop(tid, None)

    # ------------------------------------------------------------- drain
    def begin_drain(self) -> None:
        """Stop admitting (every lane sheds ``draining``); live sessions
        are untouched — EdgeNode.drain() hints and parks them."""
        self.draining = True

    # ------------------------------------------------------------- metrics
    @property
    def in_flight(self) -> int:
        return self._in_flight

    def total_admitted(self) -> int:
        return sum(self.admitted_by_lane.values())

    def total_shed(self) -> int:
        return sum(self.shed_by_reason.values())

    def snapshot(self) -> dict:
        return {
            "draining": self.draining,
            "pressure": round(self.pressure(), 4),
            "in_flight": self._in_flight,
            "max_concurrent": self.max_concurrent,
            "admitted": dict(self.admitted_by_lane),
            "shed": dict(self.shed_by_reason),
        }

    def _collect_metrics(self) -> dict:
        out = {
            "fusion_edge_admission_pressure": round(self.pressure(), 4),
            "fusion_edge_admission_in_flight": self._in_flight,
            "fusion_edge_admission_draining": 1 if self.draining else 0,
        }
        for lane, count in self.admitted_by_lane.items():
            out[f'fusion_edge_admitted_total{{lane="{lane}"}}'] = count
        for reason, count in self.shed_by_reason.items():
            out[f'fusion_edge_shed_total{{reason="{reason}"}}'] = count
        return out
