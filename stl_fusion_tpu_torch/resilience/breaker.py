"""PeerCircuitBreaker — quarantine for flapping RPC peers.

Every reconnect re-sends the peer's whole registered-call batch
(rpc/peer.py:on_run), so a peer flapping at the transport's natural retry
rate multiplies wire traffic by the batch size — the re-send storm this
breaker exists to damp. Scoring is fed by the peer's ``connection_state``
AsyncEvent chain (the same stream ``ext/peer_monitor.py`` renders):

- **closed** — healthy; error-carrying DISCONNECTED transitions count as
  flaps, CONNECTED as successes. Too many flaps inside ``flap_window`` OR a
  high failure rate over the recent outcome window trips it open.
- **open** — quarantined: the hub's connect gate (installed via
  ``RpcHub.connect_gates``) parks every dial until the cooldown elapses, so
  a flapping peer stops burning connect + re-send cycles. Cooldowns escalate
  (×2 per consecutive open, capped).
- **half-open** — one probe dial is allowed through. A connection that
  stays up for ``probe_stable`` closes the breaker; one that dies first
  re-opens it with the escalated cooldown.

Transitions are counted in the shared :class:`ResilienceEvents` ledger and
surfaced per-peer through ``RpcPeerState.breaker`` (ext/peer_monitor.py).
"""
from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Callable, Deque, Optional

from ..rpc.peer import ConnectionState, RpcClientPeer
from ..utils.async_chain import WorkerBase
from ..utils.async_utils import AsyncEvent
from .events import ResilienceEvents, global_events

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["BreakerState", "PeerCircuitBreaker"]


class BreakerState:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"


class PeerCircuitBreaker(WorkerBase):
    def __init__(
        self,
        peer: RpcClientPeer,
        flap_threshold: int = 3,
        flap_window: float = 10.0,
        failure_rate_threshold: float = 0.75,
        failure_rate_min_samples: int = 6,
        cooldown: float = 0.5,
        max_cooldown: float = 30.0,
        probe_stable: float = 0.25,
        events: Optional[ResilienceEvents] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        super().__init__(f"breaker:{peer.ref}")
        self.peer = peer
        self.flap_threshold = flap_threshold
        self.flap_window = flap_window
        self.failure_rate_threshold = failure_rate_threshold
        self.failure_rate_min_samples = failure_rate_min_samples
        self.cooldown = cooldown
        self.max_cooldown = max_cooldown
        self.probe_stable = probe_stable
        self.events = events if events is not None else global_events()
        self._clock = clock
        self.state = BreakerState.CLOSED
        #: awaitable transition chain — some transitions (open→half-open in
        #: the dial gate, half-open→closed on probe-stable timeout) happen
        #: with NO connection_state event, so observers like
        #: RpcPeerStateMonitor select on this chain too
        self.changes: AsyncEvent[str] = AsyncEvent(BreakerState.CLOSED)
        self.opens = 0  # lifetime open transitions
        self.closes = 0  # lifetime half-open → closed recoveries
        self.quarantined_dials = 0  # dials the gate parked while open
        self._consecutive_opens = 0
        self._open_until = 0.0
        self._probe_pending = False  # a released half-open probe hasn't resolved
        self._flaps: Deque[float] = deque(maxlen=64)
        self._outcomes: Deque[bool] = deque(maxlen=16)  # True = connected
        self._gate: Optional[Callable] = None

    # ------------------------------------------------------------------ wiring
    def install(self) -> "PeerCircuitBreaker":
        """Attach to the peer's hub: gate dials, watch state, advertise on
        the peer (``peer.breaker``) so peer_monitor can render the state."""

        async def gate(peer) -> None:
            if peer is self.peer:
                await self._gate_dial()

        self._gate = gate
        self.peer.hub.connect_gates.append(gate)
        self.peer.breaker = self  # type: ignore[attr-defined]
        # breaker-state gauges for /metrics: weak-registered, so a
        # disposed/collected breaker drops out of the scrape on its own
        from ..diagnostics.metrics import global_metrics

        global_metrics().register_collector(self, PeerCircuitBreaker._collect_metrics)
        self.start()
        return self

    def _collect_metrics(self) -> dict:
        return {
            "fusion_breakers": 1,
            "fusion_breakers_open": 1 if self.state == BreakerState.OPEN else 0,
            "fusion_breakers_half_open": 1 if self.state == BreakerState.HALF_OPEN else 0,
            "fusion_breaker_opens_total": self.opens,
            "fusion_breaker_closes_total": self.closes,
            "fusion_breaker_quarantined_dials_total": self.quarantined_dials,
        }

    async def dispose(self) -> None:
        if self._gate is not None:
            try:
                self.peer.hub.connect_gates.remove(self._gate)
            except ValueError:
                pass
            self._gate = None
        if getattr(self.peer, "breaker", None) is self:
            self.peer.breaker = None  # type: ignore[attr-defined]
        from ..diagnostics.metrics import global_metrics

        global_metrics().unregister_collector(self)
        await self.stop()

    # ------------------------------------------------------------------ scoring
    async def on_run(self) -> None:
        ev = self.peer.connection_state
        while True:
            s = ev.value
            if s.kind == ConnectionState.DISCONNECTED and s.error is not None:
                self._on_failure()
            elif s.is_connected:
                self._outcomes.append(True)
                if self.state in (BreakerState.HALF_OPEN, BreakerState.OPEN):
                    # HALF_OPEN: the sanctioned probe. OPEN: a dial that was
                    # already in flight when the breaker tripped (or replayed
                    # history) connected anyway — the quarantine can't undo a
                    # live link, so judge it like a probe; refusing to would
                    # strand the breaker OPEN on a healthy connection with no
                    # future dial ever consulting the gate.
                    ev = await self._judge_probe(ev)
                    continue
            ev = await ev.when_next()

    def _on_failure(self) -> None:
        now = self._clock()
        self._flaps.append(now)
        self._outcomes.append(False)
        if self.state == BreakerState.HALF_OPEN:
            self._trip("probe link died")
            return
        if self.state != BreakerState.CLOSED:
            return
        recent = [t for t in self._flaps if now - t <= self.flap_window]
        rate_samples = len(self._outcomes)
        failure_rate = (
            sum(1 for ok in self._outcomes if not ok) / rate_samples
            if rate_samples
            else 0.0
        )
        if len(recent) >= self.flap_threshold:
            self._trip(f"{len(recent)} flaps in {self.flap_window}s")
        elif (
            rate_samples >= self.failure_rate_min_samples
            and failure_rate >= self.failure_rate_threshold
        ):
            self._trip(f"failure rate {failure_rate:.2f}")

    def _set_state(self, state: str) -> None:
        self.state = state
        self.changes = self.changes.latest().create_next(state)

    def _trip(self, why: str) -> None:
        self._probe_pending = False
        self._consecutive_opens += 1
        self.opens += 1
        delay = min(
            self.cooldown * (2 ** (self._consecutive_opens - 1)), self.max_cooldown
        )
        self._open_until = self._clock() + delay
        self._set_state(BreakerState.OPEN)
        self.events.record("breaker_open", f"{self.peer.ref}: {why}")
        log.debug("breaker %s OPEN for %.2fs (%s)", self.peer.ref, delay, why)

    async def _judge_probe(self, ev):
        """Half-open + connected: stable for ``probe_stable`` ⇒ closed;
        a faster transition ⇒ the probe failed, re-open escalated."""
        try:
            nxt = await asyncio.wait_for(ev.when_next(), self.probe_stable)
        except asyncio.TimeoutError:
            self._probe_pending = False
            self._set_state(BreakerState.CLOSED)
            self.closes += 1
            self._consecutive_opens = 0
            self._flaps.clear()
            # a fresh close means a fresh score: stale failures must not
            # let one new transient disconnect re-trip via the rate rule
            self._outcomes.clear()
            self.events.record("breaker_close", self.peer.ref)
            log.debug("breaker %s CLOSED (probe stable)", self.peer.ref)
            return ev
        # the probe connection changed state before stabilizing; the
        # DISCONNECTED handler on the next loop pass re-opens via _trip
        return nxt

    # ------------------------------------------------------------------ gating
    async def _gate_dial(self) -> None:
        """Awaited by RpcHub.connect_client before every dial of this peer:
        parks dials while open, releases exactly one probe when the
        cooldown elapses (half-open)."""
        parked = False
        while True:
            if self.state == BreakerState.HALF_OPEN and self._probe_pending:
                # the peer is dialing AGAIN while a released probe never
                # resolved: the probe dial itself failed to connect (dial
                # errors emit no connection_state event — this gate re-entry
                # is the only signal). An unreachable peer must re-open
                # escalated, not dial ungated at the transport retry rate.
                self._trip("probe dial failed")
            if self.state != BreakerState.OPEN:
                if self.state == BreakerState.HALF_OPEN:
                    self._probe_pending = True
                return
            wait = self._open_until - self._clock()
            if wait <= 0:
                self._set_state(BreakerState.HALF_OPEN)
                self.events.record("breaker_half_open", self.peer.ref)
                continue  # falls through to release exactly one probe
            if not parked:  # one DIAL quarantined, however many sleep cycles
                parked = True
                self.quarantined_dials += 1
            await asyncio.sleep(wait)

    def snapshot(self) -> dict:
        return {
            "peer": self.peer.ref,
            "state": self.state,
            "opens": self.opens,
            "closes": self.closes,
            "quarantined_dials": self.quarantined_dials,
        }
