"""WaveWatchdog — deadline + fault containment for device wave dispatches.

The fused burst paths (topo-mirror sweeps, lat unions — graph/backend.py →
graph/device_graph.py) are the fast path; the SPLIT HOST LOOP (one dense
``run_waves_union(..., mirror="off")`` per seed group, driven from host
Python) is the always-correct slow path — the composable fallback arxiv
2406.18109 argues must stay live behind every fused pipeline. The watchdog
arbitrates between them:

- a fused dispatch that RAISES is contained: the burst re-runs on the host
  loop (invalidation is idempotent, so a partially-applied fused attempt is
  absorbed by the re-run) and the backend degrades;
- a fused dispatch that exceeds ``deadline_s`` degrades the backend (its
  result stands — a launched device dispatch cannot be preempted, so the deadline is
  judged on completion);
- while degraded, ``recovery_bursts`` bursts run on the host loop, then the
  fused path re-engages and the FIRST fused wave is verified against an
  independent host CSR BFS oracle over the live edge set. A mismatch
  re-degrades (and counts ``wave_oracle_mismatch``); a match closes the
  incident.

``inject_fault_next()`` is the chaos hook: the next fused dispatch raises,
exactly as if the device runtime had — scenario scripts use it to prove the
burst pipeline survives a dead dispatch mid-storm.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .events import ResilienceEvents, global_events

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["WaveWatchdog"]


class WaveWatchdog:
    MODE_FUSED = "fused"
    MODE_HOST = "host"

    def __init__(
        self,
        deadline_s: float = 5.0,
        recovery_bursts: int = 2,
        events: Optional[ResilienceEvents] = None,
    ):
        self.deadline_s = deadline_s
        self.recovery_bursts = recovery_bursts
        self.events = events if events is not None else global_events()
        self.mode = WaveWatchdog.MODE_FUSED
        self.fallbacks = 0  # bursts served by the host loop
        self.faults = 0  # fused dispatches that raised
        self.deadline_trips = 0
        self.reengages = 0  # fused re-engagements (oracle-verified)
        self.oracle_checks = 0
        self.oracle_mismatches = 0
        self._host_bursts_left = 0
        self._verify_next = False
        self._inject: Optional[BaseException] = None

    # ------------------------------------------------------------------ chaos hook
    def inject_fault_next(self, exc: Optional[BaseException] = None) -> None:
        """Arm a one-shot fault: the next fused dispatch raises ``exc``."""
        self._inject = exc if exc is not None else RuntimeError("injected wave fault")

    def _check_injected(self) -> None:
        if self._inject is not None:
            exc, self._inject = self._inject, None
            raise exc

    # ------------------------------------------------------------------ dispatch
    def _dispatch(self, graph, seed_lists, fused_fn, host_fn):
        """The shared state machine around one burst: degraded → host path;
        fused → contain faults (re-run on host), judge the deadline, and
        oracle-verify the first wave after a re-engagement. A deadline trip
        on the verify wave re-degrades and KEEPS the pending verify for the
        next re-engagement — never recording a wave_reengaged the mode
        contradicts. Both fused_fn and host_fn return (counts-ish, newly)."""
        if self.mode == WaveWatchdog.MODE_HOST:
            res = host_fn(graph, seed_lists)
            self._after_host_burst()
            return res
        verify = self._verify_next
        pre_invalid = graph._h_invalid.copy() if verify else None
        t0 = time.perf_counter()
        try:
            self._check_injected()
            res = fused_fn(graph, seed_lists)
        except Exception as e:  # noqa: BLE001 — contain, degrade, re-run on host
            self._on_fault(e)
            res = host_fn(graph, seed_lists)
            self._after_host_burst()
            return res
        self._check_deadline(t0)
        if verify and self.mode == WaveWatchdog.MODE_FUSED:
            newly = res[1]
            if isinstance(newly, np.ndarray) and newly.dtype == np.bool_:
                newly = np.nonzero(newly)[0].astype(np.int32)
            self._oracle_verify(graph, seed_lists, pre_invalid, newly)
        return res

    def run_union(self, graph, seed_lists: Sequence[Sequence[int]]) -> Tuple[int, np.ndarray]:
        """Union burst through the watchdog: fused when healthy, split host
        loop while degraded. Same contract as DeviceGraph.run_waves_union."""
        return self._dispatch(
            graph, seed_lists,
            lambda g, s: g.run_waves_union(s), self._host_union,
        )

    def run_lanes(self, graph, seed_lists: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
        """Lane burst through the watchdog. Degraded semantics: each group
        expands SEQUENTIALLY on the dense path (group i sees group < i's
        commits), so per-group counts can undercount relative to the
        snapshot-independent lane kernel — the union (what the hub applies)
        is identical, which is the consistency contract."""
        return self._dispatch(
            graph, seed_lists,
            lambda g, s: g.run_waves_lanes(s), self._host_lanes,
        )

    def run_seq(self, graph, seed_lists: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
        """Sequenced union burst (cascade_rows_batch_seq) through the
        watchdog. The host fallback loops the dense union per wave — which
        IS the seq contract (wave i sees wave < i's commits), so degraded
        counts match the fused ones exactly."""
        return self._dispatch(
            graph, seed_lists,
            lambda g, s: g.run_waves_union_seq(s), self._host_lanes,
        )

    # ------------------------------------------------------------------ degradation
    def _on_fault(self, e: BaseException) -> None:
        self.faults += 1
        self._degrade("wave_fault", repr(e))

    def _check_deadline(self, t0: float) -> None:
        dt = time.perf_counter() - t0
        if dt > self.deadline_s:
            self.deadline_trips += 1
            self._degrade("wave_deadline", f"{dt:.3f}s > {self.deadline_s}s")

    def _degrade(self, kind: str, detail: str) -> None:
        self.events.record(kind, detail)
        if self.mode != WaveWatchdog.MODE_HOST:
            self.mode = WaveWatchdog.MODE_HOST
            self.events.record("wave_fallback", detail)
            log.warning("wave watchdog: degraded to host loop (%s: %s)", kind, detail)
        self._host_bursts_left = self.recovery_bursts

    def _after_host_burst(self) -> None:
        self.fallbacks += 1
        self._host_bursts_left -= 1
        if self._host_bursts_left <= 0 and self.mode == WaveWatchdog.MODE_HOST:
            self.mode = WaveWatchdog.MODE_FUSED
            self._verify_next = True  # first fused wave back is oracle-checked

    # ------------------------------------------------------------------ host path
    @staticmethod
    def _host_lanes(graph, seed_lists) -> Tuple[np.ndarray, np.ndarray]:
        """The split host loop: one dense (mirror-free) union per seed
        group, sequenced from host Python. No mirror, no fused program —
        the degraded path shares nothing with the path that just failed."""
        counts = np.zeros(len(seed_lists), dtype=np.int64)
        parts: List[np.ndarray] = []
        for i, s in enumerate(seed_lists):
            if not len(s):
                continue
            c, ids = graph.run_waves_union([s], mirror="off")
            counts[i] = c
            if len(ids):
                parts.append(ids)
        return counts, (
            np.concatenate(parts) if parts else np.empty(0, np.int32)
        )

    @classmethod
    def _host_union(cls, graph, seed_lists) -> Tuple[int, np.ndarray]:
        counts, ids = cls._host_lanes(graph, seed_lists)
        return int(counts.sum()), ids

    # ------------------------------------------------------------------ oracle
    def _oracle_verify(self, graph, seed_lists, pre_invalid: np.ndarray, newly) -> None:
        """Independent host CSR BFS over the live edge set, compared with
        the fused wave's newly-invalid set. Seeds conduct even when
        pre-invalid; non-seed invalid nodes block — the run_waves_union
        contract (ops/wave.py). Everything stays a boolean MASK end to end:
        a Python int set at the 10M-node scale would burn seconds of
        single-threaded boxing on the event loop mid-recovery."""
        self._verify_next = False
        self.oracle_checks += 1
        nn = graph.n_nodes
        expected = self._host_closure(graph, seed_lists, pre_invalid)
        if isinstance(newly, np.ndarray) and newly.dtype == np.bool_:
            got = newly[:nn]
        else:
            got = np.zeros(nn, dtype=bool)
            ids = np.asarray(newly, dtype=np.int64)
            got[ids[(ids >= 0) & (ids < nn)]] = True
        if np.array_equal(expected, got):
            n_got = int(got.sum())
            self.reengages += 1
            self.events.record("wave_reengaged", f"verified {n_got} newly")
            log.info("wave watchdog: fused path re-engaged (oracle OK, %d newly)", n_got)
            return
        self.oracle_mismatches += 1
        miss = int((expected & ~got).sum())
        extra = int((got & ~expected).sum())
        self._degrade(
            "wave_oracle_mismatch",
            f"missing {miss}, extra {extra} of {int(expected.sum())}",
        )

    @staticmethod
    def _host_closure(graph, seed_lists, pre_invalid: np.ndarray) -> np.ndarray:
        m = graph.n_edges
        live = (
            graph._h_node_epoch[graph._h_edge_dst[:m]] == graph._h_edge_dst_epoch[:m]
        )
        src = graph._h_edge_src[:m][live].astype(np.int64)
        dst = graph._h_edge_dst[:m][live].astype(np.int64)
        nn = graph.n_nodes
        keep = (src < nn) & (dst < nn)
        src, dst = src[keep], dst[keep]
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        starts = np.zeros(nn + 1, dtype=np.int64)
        np.add.at(starts[1:], src_s, 1)
        starts = np.cumsum(starts)
        seeds = np.unique(
            np.asarray([int(i) for s in seed_lists for i in s], dtype=np.int64)
        )
        seeds = seeds[(seeds >= 0) & (seeds < nn)]
        invalid = pre_invalid[:nn].copy()
        newly_mask = np.zeros(nn, dtype=bool)
        newly_mask[seeds[~invalid[seeds]]] = True
        invalid[seeds] = True
        frontier = seeds  # all seeds conduct, pre-invalid or not
        while frontier.size:
            # vectorized level expansion: one fancy-index gather of every
            # frontier out-edge per level — a Python per-node loop here
            # would stall the event loop for minutes on 10M-node graphs
            s0, s1 = starts[frontier], starts[frontier + 1]
            deg = s1 - s0
            total = int(deg.sum())
            if total == 0:
                break
            offsets = np.repeat(np.cumsum(deg) - deg, deg)
            idx = np.repeat(s0, deg) + (np.arange(total, dtype=np.int64) - offsets)
            cand = dst_s[idx]
            cand = np.unique(cand[~invalid[cand]])
            invalid[cand] = True
            newly_mask[cand] = True
            frontier = cand
        return newly_mask

    def snapshot(self) -> dict:
        return {
            "mode": self.mode,
            "fallbacks": self.fallbacks,
            "faults": self.faults,
            "deadline_trips": self.deadline_trips,
            "reengages": self.reengages,
            "oracle_checks": self.oracle_checks,
            "oracle_mismatches": self.oracle_mismatches,
        }
