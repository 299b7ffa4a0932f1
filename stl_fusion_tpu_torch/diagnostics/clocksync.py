"""Cross-host clock alignment for delivery timestamps.

``fusion_e2e_delivery_ms`` (and the edge tier's ``fusion_edge_delivery_ms``
hop built on it) measures ``recv_perf_counter - origin_ts`` where
``origin_ts`` is the SENDER's ``perf_counter`` — trustworthy only when
both ends share a clock. Across hosts the two counters have unrelated
epochs, which OBSERVABILITY.md/EDGE.md carried as a shared open item and
the mesh exchange makes wrong BY CONSTRUCTION (a frontier crossing hosts
always lands on a foreign clock).

This module closes it with the standard NTP-style estimate, riding the
existing ``$sys`` channel (rpc/peer.py): a probe records
``(t_send, t_remote, t_recv)`` and the peer's offset is estimated at the
round trip's midpoint::

    offset(peer) = t_remote - (t_send + t_recv) / 2     # remote - local

keeping the MINIMUM-RTT sample (the one least contaminated by queueing —
Cristian's algorithm). ``to_local`` then maps a remote ``origin_ts`` onto
the local timeline before the histogram records it; the residual error is
bounded by RTT/2, a property the raw cross-host number never had. Peers
never probed (in-process transports, same-host stacks) fall back to the
identity mapping — exactly the old, correct-same-clock behavior.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Tuple

from .metrics import global_metrics

__all__ = ["ClockSync", "global_clock_sync"]


class ClockSync:
    """Per-peer clock-offset table (thread-safe; samples arrive on rpc
    pumps, reads happen on whatever loop applies the invalidation)."""

    def __init__(self):
        self._lock = threading.Lock()
        #: peer ref → (offset_s, rtt_s) of the best (min-RTT) sample
        self._offsets: Dict[str, Tuple[float, float]] = {}
        self.probes = 0
        global_metrics().register_collector(self, ClockSync._collect_metrics)

    def _collect_metrics(self) -> dict:
        out = {"fusion_clock_probes_total": self.probes}
        with self._lock:
            for ref, (off, rtt) in self._offsets.items():
                out[f'fusion_clock_offset_ms{{peer="{ref}"}}'] = off * 1e3
                out[f'fusion_clock_rtt_ms{{peer="{ref}"}}'] = rtt * 1e3
        return out

    # ------------------------------------------------------------------ samples
    def note_sample(self, ref: Optional[str], t_send: float, t_remote: float, t_recv: float) -> None:
        if ref is None:
            return
        rtt = max(t_recv - t_send, 0.0)
        offset = t_remote - (t_send + t_recv) / 2.0
        with self._lock:
            self.probes += 1
            best = self._offsets.get(ref)
            if best is None or rtt < best[1]:
                self._offsets[ref] = (offset, rtt)

    def forget(self, ref: str) -> None:
        """Retire one peer's sample — the mesh controller calls this for
        every member a re-form drops, so ``fusion_clock_offset_ms{peer=}``
        / ``fusion_clock_rtt_ms{peer=}`` series stop accumulating across
        re-forms and flaps (the per-peer label set was
        append-only before this)."""
        with self._lock:
            self._offsets.pop(ref, None)

    def prune(self, retired: "Iterable[str]") -> int:
        """Batch retire: drop every listed peer's sample, returning how
        many actually held one (a flap that re-joins re-probes fresh — the
        series set stays bounded by LIVE membership, not history)."""
        dropped = 0
        with self._lock:
            for ref in retired:
                if self._offsets.pop(ref, None) is not None:
                    dropped += 1
        return dropped

    # ------------------------------------------------------------------ mapping
    def offset(self, ref: Optional[str]) -> Optional[float]:
        if ref is None:
            return None
        with self._lock:
            best = self._offsets.get(ref)
        return best[0] if best is not None else None

    def rtt(self, ref: Optional[str]) -> Optional[float]:
        if ref is None:
            return None
        with self._lock:
            best = self._offsets.get(ref)
        return best[1] if best is not None else None

    def to_local(self, ref: Optional[str], remote_ts: float) -> float:
        """A remote perf_counter stamp on the LOCAL timeline. Identity for
        peers never probed (same-clock stacks keep the old exact path)."""
        off = self.offset(ref)
        return remote_ts if off is None else remote_ts - off

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "probes": self.probes,
                "peers": {
                    ref: {"offset_ms": off * 1e3, "rtt_ms": rtt * 1e3}
                    for ref, (off, rtt) in self._offsets.items()
                },
            }


_GLOBAL: Optional[ClockSync] = None
_GLOBAL_LOCK = threading.Lock()


def global_clock_sync() -> ClockSync:
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = ClockSync()
    return _GLOBAL


def now() -> float:
    """The clock every probe + delivery stamp uses (one place to swap)."""
    return time.perf_counter()
