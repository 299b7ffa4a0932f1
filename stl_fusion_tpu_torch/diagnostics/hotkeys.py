"""Workload attribution: cardinality-bounded heavy-hitter sketches.

When a tail blows up, the first operator question is "which key / which
tenant did this?" — and since the async frontier removed the
per-level barrier, a stall no longer localizes itself. This module answers
the question with *space-saving* sketches (Metwally et al.): every hot path
offers its key, the sketch keeps at most ``capacity`` counters no matter
how many distinct keys pass through, and each surviving entry carries an
explicit over-count ``error`` bound so a consumer can tell a confident
heavy hitter from a lucky survivor.

Design rules, matching the registry's own (metrics.py):

- **Hot paths pay one dict hit.** ``offer()`` is a dict lookup + add on
  the common (already-tracked) path; eviction is amortized O(log k) via a
  lazy min-heap that tolerates stale entries and rebuilds itself when it
  grows past 4× capacity — memory stays O(k) under millions of distinct
  keys (tests/test_hotkeys.py drives 1M).
- **Merge is deterministic and commutative.** ``merge(a, b) == merge(b, a)``
  exactly: union the keys, sum per-sketch estimates and error bounds, keep
  the top ``capacity`` by ``(-count, key)``. That makes the sketches safe
  to ship inside mesh telemetry snapshots (mesh_telemetry.py) and fold at
  the aggregator in whatever order hosts report.
- **Counts are estimates, not truth.** A space-saving count may overstate
  by up to ``error``; it never understates. ``topk()`` reports both so
  ``explain()`` / ``/hotkeys`` can print honest shares.

The :class:`HotKeyBoard` groups one sketch per *domain* (wave
invalidations per node, edge deliveries per key, admission decisions per
tenant, routed calls per shard) and exports plain-counter telemetry
through the registry collector idiom — the sketches themselves travel in
mesh snapshots, not in the metric series.
"""
from __future__ import annotations

import heapq
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "SpaceSavingSketch",
    "HotKeyBoard",
    "global_hotkeys",
    "HOTKEY_DOMAINS",
]


class SpaceSavingSketch:
    """Bounded heavy-hitter counter (space-saving algorithm).

    Tracks at most ``capacity`` keys. Offering an untracked key when full
    evicts the current minimum-count entry deterministically (lowest
    count, ties by key) and inherits its count as the new key's error
    bound — the classic space-saving guarantee: a tracked count never
    understates the true count and overstates by at most ``error``.
    """

    __slots__ = ("capacity", "total", "_counts", "_errors", "_heap")

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        #: total offers seen (including evicted keys) — the share denominator
        self.total = 0
        self._counts: Dict[str, int] = {}
        self._errors: Dict[str, int] = {}
        #: lazy min-heap of (count, key); entries go stale when a key's
        #: count moves on — stale entries are skipped at pop time and the
        #: heap is rebuilt when it outgrows 4× capacity, keeping memory O(k)
        self._heap: List[Tuple[int, str]] = []

    def __len__(self) -> int:
        return len(self._counts)

    def offer(self, key: str, n: int = 1) -> None:
        n = int(n)
        if n <= 0:
            return
        self.total += n
        counts = self._counts
        c = counts.get(key)
        if c is not None:
            counts[key] = c + n
            heapq.heappush(self._heap, (c + n, key))
        elif len(counts) < self.capacity:
            counts[key] = n
            self._errors[key] = 0
            heapq.heappush(self._heap, (n, key))
        else:
            victim, vcount = self._pop_min()
            del counts[victim]
            self._errors.pop(victim, None)
            # inherit the victim's count: never understate, bound the lie
            counts[key] = vcount + n
            self._errors[key] = vcount
            heapq.heappush(self._heap, (vcount + n, key))
        if len(self._heap) > 4 * self.capacity:
            self._rebuild_heap()

    def _pop_min(self) -> Tuple[str, int]:
        counts = self._counts
        heap = self._heap
        while heap:
            count, key = heapq.heappop(heap)
            if counts.get(key) == count:
                return key, count
            # stale: the key was bumped (or already evicted) since this push
        # heap exhausted by staleness — fall back to a scan (rare; bounded O(k))
        key = min(counts, key=lambda k: (counts[k], k))
        return key, counts[key]

    def _rebuild_heap(self) -> None:
        self._heap = [(c, k) for k, c in self._counts.items()]
        heapq.heapify(self._heap)

    def estimate(self, key: str) -> int:
        """Estimated count for ``key`` (0 if untracked). Never understates
        the true count; overstates by at most :meth:`error_of`."""
        return self._counts.get(key, 0)

    def error_of(self, key: str) -> int:
        return self._errors.get(key, 0)

    def topk(self, n: int = 10) -> List[dict]:
        """Top-``n`` entries by ``(-count, key)`` with share-of-total."""
        total = self.total
        ranked = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return [
            {
                "key": k,
                "count": c,
                "error": self._errors.get(k, 0),
                "share": round(c / total, 6) if total else 0.0,
            }
            for k, c in ranked[: max(0, int(n))]
        ]

    def merge(self, other: "SpaceSavingSketch") -> "SpaceSavingSketch":
        """Commutative, deterministic merge: union keys, sum estimates and
        error bounds, truncate to capacity by ``(-count, key)``. A key kept
        by one sketch but absent from the other contributes that sketch's
        estimate alone (the absent side may have seen it and evicted it —
        that uncertainty is already inside the kept side's error bound)."""
        out = SpaceSavingSketch(max(self.capacity, other.capacity))
        out.total = self.total + other.total
        merged = sorted(
            (
                -(self._counts.get(k, 0) + other._counts.get(k, 0)),
                k,
                self._errors.get(k, 0) + other._errors.get(k, 0),
            )
            for k in set(self._counts) | set(other._counts)
        )
        for negc, k, e in merged[: out.capacity]:
            out._counts[k] = -negc
            out._errors[k] = e
        out._rebuild_heap()
        return out

    # ------------------------------------------------------------------ transport
    def to_payload(self) -> dict:
        """JSON-safe snapshot for mesh telemetry transport — entries sorted
        by ``(-count, key)`` so equal sketches serialize identically."""
        return {
            "capacity": self.capacity,
            "total": self.total,
            "entries": [
                [k, c, self._errors.get(k, 0)]
                for k, c in sorted(
                    self._counts.items(), key=lambda kv: (-kv[1], kv[0])
                )
            ],
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "SpaceSavingSketch":
        out = cls(int(payload.get("capacity") or 1))
        out.total = int(payload.get("total") or 0)
        for entry in payload.get("entries") or ():
            try:
                key, count, error = str(entry[0]), int(entry[1]), int(entry[2])
            except (TypeError, ValueError, IndexError):
                continue  # malformed wire entry: drop it, keep the sketch
            out._counts[key] = count
            out._errors[key] = error
        out._rebuild_heap()
        return out


#: the attribution domains the hot paths feed (OBSERVABILITY.md §Hot-key
#: attribution) — fixed vocabulary so mesh merge and /hotkeys rendering
#: agree on names without negotiation
HOTKEY_DOMAINS = (
    "wave_invalidations",  # graph waves: invalidations per node id (rpc/fanout.py)
    "edge_deliveries",     # edge fan-out: delivered frames per computed key
    "tenant_admits",       # admission: admitted requests per tenant
    "tenant_sheds",        # admission: shed requests per tenant
    "routed_shards",       # cluster router: routed calls per shard
    "shard_keys",          # cluster router: routed calls per shard|service.method
)


class HotKeyBoard:
    """One space-saving sketch per attribution domain, plus the plain
    offer counters the registry collector exports. Thread-safe: offers
    arrive from the asyncio loop, the edge fan shards, and the router."""

    def __init__(self, capacity: int = 64, registry: Optional[Any] = None):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._sketches: Dict[str, SpaceSavingSketch] = {}
        self.offers: Dict[str, int] = {}
        if registry is None:
            from .metrics import global_metrics

            registry = global_metrics()
        registry.register_collector(self, HotKeyBoard._collect_metrics)

    def offer(self, domain: str, key: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            sk = self._sketches.get(domain)
            if sk is None:
                sk = self._sketches[domain] = SpaceSavingSketch(self.capacity)
            sk.offer(key, n)
            self.offers[domain] = self.offers.get(domain, 0) + int(n)

    def sketch(self, domain: str) -> Optional[SpaceSavingSketch]:
        with self._lock:
            return self._sketches.get(domain)

    def domains(self) -> List[str]:
        with self._lock:
            return sorted(self._sketches)

    def topk(self, domain: str, n: int = 10) -> List[dict]:
        sk = self.sketch(domain)
        return sk.topk(n) if sk is not None else []

    def share_of(self, domain: str, key: str) -> Optional[dict]:
        """Attribution line for ``explain()``: the key's rank/share in the
        domain's top-k, or None when it is not a tracked heavy hitter."""
        sk = self.sketch(domain)
        if sk is None or sk.total <= 0:
            return None
        for rank, entry in enumerate(sk.topk(sk.capacity), start=1):
            if entry["key"] == key:
                return {
                    "domain": domain,
                    "rank": rank,
                    "count": entry["count"],
                    "error": entry["error"],
                    "share": entry["share"],
                }
        return None

    def _collect_metrics(self) -> dict:
        with self._lock:
            out: Dict[str, float] = {}
            for domain, n in self.offers.items():
                out[f'fusion_hotkey_offers_total{{domain="{domain}"}}'] = n
            for domain, sk in self._sketches.items():
                out[f'fusion_hotkey_tracked{{domain="{domain}"}}'] = len(sk)
            return out

    # ------------------------------------------------------------------ transport
    def payload(self) -> dict:
        """All domain sketches in wire shape (rides mesh telemetry
        snapshots under the ``"sketches"`` key)."""
        with self._lock:
            return {d: sk.to_payload() for d, sk in sorted(self._sketches.items())}

    @staticmethod
    def merge_payloads(payloads: List[dict]) -> Dict[str, SpaceSavingSketch]:
        """Fold any number of :meth:`payload` dicts (local + remote hosts)
        into merged per-domain sketches. Order-independent: the pairwise
        merge is commutative and associative-in-effect for the kept top-k
        (ties broken by key), and inputs are folded in sorted-domain order."""
        merged: Dict[str, SpaceSavingSketch] = {}
        for payload in payloads:
            if not isinstance(payload, dict):
                continue
            for domain in sorted(payload):
                sk = SpaceSavingSketch.from_payload(payload[domain])
                prev = merged.get(domain)
                merged[domain] = sk if prev is None else prev.merge(sk)
        return merged

    def report(self, n: int = 5, extra_payloads: Optional[List[dict]] = None) -> dict:
        """Top-``n`` per domain — ``/hotkeys`` and the bench digest shape.
        ``extra_payloads`` folds remote-host sketches in (mesh scope)."""
        if extra_payloads:
            merged = self.merge_payloads([self.payload()] + list(extra_payloads))
            return {
                d: {"total": sk.total, "top": sk.topk(n)}
                for d, sk in sorted(merged.items())
            }
        with self._lock:
            return {
                d: {"total": sk.total, "top": sk.topk(n)}
                for d, sk in sorted(self._sketches.items())
            }


_GLOBAL: Optional[HotKeyBoard] = None
_GLOBAL_LOCK = threading.Lock()


def global_hotkeys() -> HotKeyBoard:
    """The process-wide attribution board — hot paths offer here with no
    wiring, exactly like ``global_metrics()``."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = HotKeyBoard()
    return _GLOBAL
