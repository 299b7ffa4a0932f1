"""SuperRoundProgram — the whole live loop as ONE resident device program.

Port of ``stl_fusion_tpu/graph/superround.py`` on the single-device lanes
route. A live round re-entered the host between its stages (seed prep, the
block refresh, the memo-table apply, the fence extraction); this module is
the FuseFlow-style answer (PAPERS.md: fusion across sparse-pipeline STAGE
boundaries; "Composing Distributed Computations Through Task and Kernel
Fusion": the win is deleting the host round trips that separate kernels):

- **One resident program.** ``backend.enable_super_rounds(block, depth=K)``
  runs K live rounds of (lane burst → block refresh through the memo
  table's device loader → packed fence-mask extraction) as ONE program
  (``ops/topo_wave.py::topo_mirror_superround_step``). On the card that
  program is a CUDA graph captured once per geometry and REPLAYED every
  super-round (``graph/program_cache.py``): one replay runs the K rounds'
  gates, ``topo_sweep`` passes, ``lane_finish``, loader gathers and
  ``block_refresh`` launches, and the host's only per-super-round work is
  feeding a seed buffer and draining a packed fence buffer.
- **Double-buffered host I/O.** :meth:`SuperRoundProgram.stage` packs the
  NEXT super-round's seed tensor into a pinned host buffer (no device
  traffic) while super-round N executes; :meth:`SuperRoundProgram.dispatch`
  copies it non-blocking into the graph's seed input, replays, and — with
  ``MAX_INFLIGHT=1`` — drains super-round N−1's packed fence masks into the
  two-tier apply while N runs. ``occupancy()`` reports the fraction of the
  flight window covered by useful host work; ``host_stall_ms()`` the time
  the host spent blocked on the device with nothing staged.
- **Mesh mode.** When ``backend.enable_mesh_routing`` is active, the
  super-round rides the routed union chain
  (``RoutedShardedGraph.dispatch_union_chain``: each round one union wave
  whose cross-shard frontiers resolve on the mesh, the chain's levels
  enqueued with no readback), so mesh mode keeps ZERO host-relay hops
  between rounds; the columnar refresh folds per SUPER-ROUND at harvest
  (the memo columns live on the dense device state, not the routed
  shards). Seed staging still overlaps the flight window; a reshard
  between stage and dispatch re-packs the buffer (counted, never silently
  stale). This route is not a captured CUDA graph.

**Identity.** Every round keeps its own wave seq (``_begin_wave_span``),
recorder events during a round's host apply stamp that round's seq, and the
profiler record carries ``fused_depth``/``seq_span``.

**Fallbacks** (counted, never silent):

- a mirror that cannot serve the fused path (invalid, or carrying more
  sweep passes than ``FUSED_PASS_MAX``), or a program whose CUDA graph
  capture fails (say, a loader that reads a value back to the host), routes
  the whole super-round to the EAGER per-round path under the pre-minted
  seqs (``eager_rounds``, which ``chip_smoke.py`` requires to be zero);
- a dispatch or harvest FAULT is contained: the device invalid state
  re-syncs to host and whatever committed gets the full two-tier apply; the
  bound block is conservatively RE-STALED and refreshed once (a half-run
  chain may have cleared block rows' invalid bits while its refreshed
  values died with the fault); the staged rounds then re-run on the counted
  eager path (``faults``);
- a seed buffer staged against a mirror that re-leveled before dispatch is
  re-packed (``restages``).

The adaptive sweep (``passes <= 0``) reads a flag back each pass, which a
capture forbids: those super-rounds run the same kernels stream-ordered,
counted as ``uncaptured`` in :meth:`SuperRoundProgram.stats`.

**Consistency contract**: between ``dispatch()`` and its harvest, the
round's transitive dependents still read consistent on the host — nothing
has been applied there. (The table's values and validity are refreshed in
place on the device as the program runs.) ``drain()`` is the barrier, and
``WavePipeline.drain()``, the nonblocking-mode barrier, covers in-flight
super-rounds too.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import TYPE_CHECKING, Deque, List, Optional, Sequence

import numpy as np
import torch

from ..diagnostics.metrics import global_metrics
from ..ops.pull_wave import pack_lane_matrix
from . import device_graph
from .program_cache import PINNED, NotFusible

if TYPE_CHECKING:
    from .backend import RowBlock, TpuGraphBackend

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["SuperRoundProgram", "SuperRoundTicket", "StagedSeeds"]


class StagedSeeds:
    """One super-round's seed BACK BUFFER: the per-round row groups, their
    backend-nid seed lists, and — once packed — the device-ready seed
    tensor. Packing happens at :meth:`SuperRoundProgram.stage` time (while
    the previous super-round executes on device); the buffer remembers the
    mirror-rebuild generation it packed against so a re-level between
    stage and dispatch re-packs instead of dispatching stale NEW-ids."""

    __slots__ = (
        "bursts", "stages", "sizes", "mats", "words",
        "mirror_rebuilds", "routed", "routed_staged", "stage_s",
    )

    def __init__(self, bursts, stages, sizes, routed: bool):
        self.bursts = bursts  # original per-round row-group lists
        self.stages = stages  # per-round backend-nid seed lists
        self.sizes = sizes  # groups per round
        #: int32[K, 32*words, S]: numpy on the CPU, a pinned tensor on the card
        self.mats = None
        self.words: int = 1
        self.mirror_rebuilds: int = -1
        self.routed = routed
        self.routed_staged: Optional[dict] = None
        self.stage_s = 0.0

    @property
    def depth(self) -> int:
        return len(self.bursts)


class SuperRoundTicket:
    """One dispatched super-round in flight: ``harvest()`` blocks on the
    device results, applies every round's packed fence mask under its own
    wave seq (two-tier apply + fence fan-out), commits the chained memo
    columns, and returns one int64 per-group newly-count array per round.
    A harvest fault is contained by the owning program (counted eager
    re-run) — harvest never raises out of containment."""

    __slots__ = (
        "program", "inner", "staged", "cause", "seqs", "dispatched_at",
        "routed_pending", "done", "per_burst", "fallback", "staged_s", "dispatch_s",
    )

    def __init__(self, program, inner, staged, cause, seqs, dispatched_at,
                 routed_pending=None):
        self.program = program
        self.inner = inner  # backend._RefreshChainTicket (lanes flavor)
        self.staged = staged
        self.cause = cause
        self.seqs = seqs
        self.dispatched_at = dispatched_at
        self.routed_pending = routed_pending
        self.done = False
        self.per_burst: Optional[List[np.ndarray]] = None
        self.fallback = False  # resolved by the counted eager path
        self.staged_s = getattr(staged, "stage_s", 0.0)  # host time staging its seeds
        self.dispatch_s = 0.0  # host time of its dispatch

    def harvest(self) -> List[np.ndarray]:
        if self.done:
            if self.per_burst is not None:
                return self.per_burst
            raise RuntimeError("super-round already harvested")
        self.done = True
        prog = self.program
        try:
            # callers may harvest a ticket directly (the live loop's
            # double-buffered caller) — it must leave the in-flight window
            prog._inflight.remove(self)
        except ValueError:
            pass
        prog.harvests += 1
        try:
            if self.routed_pending is not None:
                self.per_burst = self._harvest_routed()
            else:
                self.per_burst = self._harvest_lanes()
        except Exception as e:  # noqa: BLE001 — harvest fault: contain + count
            prog._live_refresh = None
            self.fallback = True
            self.per_burst = prog._on_fault(e, self.staged, self.cause, self.seqs)
        finally:
            prog.wall_s += time.perf_counter() - self.dispatched_at
        return self.per_burst

    def _harvest_lanes(self) -> List[np.ndarray]:
        prog = self.program
        inner = self.inner
        out, _sizes = inner.pending["batches"][0]
        # the ONE blocking device read of the whole super-round — timed as
        # the host stall (everything else in harvest is host apply work
        # that could overlap the next super-round's device execution)
        t0 = time.perf_counter()
        device_graph.fetch_outputs(out)
        stall = time.perf_counter() - t0
        prog.stall_s += stall
        prog._record_stall(stall, self.cause)
        t1 = time.perf_counter()
        per_burst = inner.harvest()
        info = prog.backend.graph.last_harvest_info or {}
        harvest_s = time.perf_counter() - t1
        unpack_s = info.get("unpack_s", 0.0)
        prog.unpack_s += unpack_s
        prog.apply_s += max(harvest_s - unpack_s, 0.0)
        for route in info.get("routes", ()):
            prog.routes[route] = prog.routes.get(route, 0) + 1
        if out.device_ms is not None:
            prog.device_ms += out.device_ms
        prog._note_split(self, stall, unpack_s, harvest_s - unpack_s, out)
        if prog._live_refresh is inner.refresh:
            prog._live_refresh = None
        prog.cleared_total += inner.cleared_total
        return per_burst

    def _harvest_routed(self) -> List[np.ndarray]:
        prog = self.program
        backend = prog.backend
        t0 = time.perf_counter()
        counts, stage_ids = backend.harvest_waves_routed_chain(self.routed_pending)
        stall = time.perf_counter() - t0
        prog.stall_s += stall
        prog._record_stall(stall, self.cause)
        K = len(stage_ids)
        backend.last_cause_id = self.cause
        total = 0
        t_apply0 = time.perf_counter()
        per_burst: List[np.ndarray] = []
        try:
            for i in range(K):
                backend.last_wave_seq = self.seqs[i]
                backend._apply_newly(np.asarray(stage_ids[i], dtype=np.int64))
                per_burst.append(np.asarray([int(counts[i])], dtype=np.int64))
                total += int(counts[i])
        finally:
            backend.last_wave_seq = self.seqs[0]
        backend.waves_run += K
        backend.device_invalidations += total
        # the routed scan exchanges frontiers on-mesh; the memo columns
        # live on the dense device state, so the columnar refresh folds
        # per SUPER-ROUND here (still one dispatch, zero per-round hops)
        prog.cleared_total += backend.refresh_block_on_device(prog.block)
        # the fence drain is the one phase the host DOES time end-to-end:
        # apply + refresh between harvest and profile
        from ..diagnostics.mesh_telemetry import global_mesh_trace

        global_mesh_trace().record(
            self.cause, "fence_drain", t_apply0, time.perf_counter()
        )
        backend._profile_wave(
            "superround", sum(len(s) for s in self.staged.stages),
            self.cause, self.dispatched_at, t_apply0, total, self.seqs[0],
            groups=K, fused_depth=K,
            seq_span=(self.seqs[0], self.seqs[-1]), dispatches=1,
        )
        return per_burst


class SuperRoundProgram:
    #: dispatched-but-unharvested super-rounds kept in flight; 1 = the
    #: fence drain of super-round N−1 runs while N executes on device
    MAX_INFLIGHT = 1

    def __init__(
        self,
        backend: "TpuGraphBackend",
        block: "RowBlock",
        depth: int = 4,
        max_words: int = 16,
    ):
        # validate the table contract up front (device loader + full bind)
        backend._block_refresh_state(block)
        self.backend = backend
        self.block = block
        self.depth = max(int(depth), 1)
        self.max_words = max_words
        self._inflight: Deque[SuperRoundTicket] = deque()
        #: the in-flight super-round's refresh dict — its values/validity
        #: entries are DEVICE FUTURES of that chain's outputs; the next
        #: dispatch threads them so back-to-back super-rounds chain
        #: device-side with no host materialization between them
        self._live_refresh: Optional[dict] = None
        # pinned lane geometry (grows monotonically; stable geometry ⇒ one
        # resident executable)
        self._geom_words = 1
        self._geom_width = 1
        # -- counters (stats() / metrics collector) --
        self.superrounds_dispatched = 0
        self.rounds_total = 0
        self.eager_rounds = 0  # rounds served by the counted eager fallback
        self.faults = 0  # dispatch/harvest faults contained to the eager path
        self.restages = 0  # seed buffers re-packed after a re-level/reshard
        self.journal_forced_harvests = 0  # flush-hazard guard engagements
        self.harvests = 0
        self.cleared_total = 0  # block rows the chained refreshes recomputed
        self.stage_s = 0.0  # host seed-buffer packing time
        self.stall_s = 0.0  # host blocked on the device read, nothing staged
        self.wall_s = 0.0  # dispatch → harvest-complete wall time
        self.dispatch_s = 0.0  # host time of the dispatches (flush, copy, replay)
        self.unpack_s = 0.0  # harvest: the stage masks unpacked into the host mirror
        self.apply_s = 0.0  # harvest: two-tier apply and the refresh bookkeeping
        self.device_ms = 0.0  # CUDA events around the replays (0 on the CPU)
        #: programs by route over the harvests: "replay", "capture",
        #: "recapture", "stream" (adaptive, uncaptured) or "plain" (the CPU)
        self.routes: dict = {}
        #: one dict per harvested super-round (the newest 64): stage, dispatch,
        #: stall, unpack and apply ms on the host clock, device ms, route
        self.history: Deque[dict] = deque(maxlen=64)
        self._disposed = False
        reg = global_metrics()
        reg.register_collector(self, SuperRoundProgram._collect_metrics)
        # non-additive gauges scrape as MAX across programs (two
        # half-stalled programs are half stalled, not summed to a stall)
        reg.set_aggregation("fusion_superround_occupancy", "max")
        reg.set_aggregation("fusion_superround_host_stall_ms", "max")
        # per-harvest stall distribution; exemplars carry the super-round
        # cause so a tail stall links to its trace
        self._stall_hist = reg.histogram(
            "fusion_superround_stall_ms",
            help="per-harvest host milliseconds blocked on the device read",
        )

    def _record_stall(self, stall_s: float, cause) -> None:
        self._stall_hist.record(stall_s * 1e3, cause=cause)

    def _note_split(self, ticket, stall_s, unpack_s, apply_s, out) -> None:
        self.history.append({
            "rounds": ticket.staged.depth, "route": out.route,
            "stage_ms": ticket.staged_s * 1e3, "dispatch_ms": ticket.dispatch_s * 1e3,
            "stall_ms": stall_s * 1e3, "unpack_ms": unpack_s * 1e3,
            "apply_ms": max(apply_s, 0.0) * 1e3, "device_ms": out.device_ms,
        })

    # ------------------------------------------------------------------ metrics
    def occupancy(self) -> float:
        """Fraction of the super-round flight window (dispatch →
        harvest-complete) covered by useful host work — staging the next
        seed buffer, draining the previous fence buffer, churn prep —
        rather than a blocked device read. 0.0 before the first harvest."""
        if self.wall_s <= 0.0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.stall_s / self.wall_s))

    def host_stall_ms(self) -> float:
        """Mean host milliseconds per super-round spent blocked on the
        device with nothing left to stage or drain."""
        if self.harvests == 0:
            return 0.0
        return self.stall_s / self.harvests * 1e3

    def _collect_metrics(self) -> dict:
        return {
            "fusion_superround_dispatches_total": self.superrounds_dispatched,
            "fusion_superround_rounds_total": self.rounds_total,
            "fusion_superround_eager_rounds_total": self.eager_rounds,
            "fusion_superround_faults_total": self.faults,
            "fusion_superround_restages_total": self.restages,
            "fusion_superround_inflight": len(self._inflight),
            "fusion_superround_occupancy": round(self.occupancy(), 4),
            "fusion_superround_host_stall_ms": round(self.host_stall_ms(), 3),
        }

    # ------------------------------------------------------------------ staging
    def stage(self, bursts: Sequence[Sequence[Sequence[int]]]) -> StagedSeeds:
        """Pack the NEXT super-round's seeds into the back buffer — pure
        host work (numpy pack through the mirror's id map), safe to run
        while a dispatched super-round executes on device: no flush, no
        device reads, no journal interaction. ``bursts`` is one row-group
        list per round (each round ≤ ``32*max_words`` groups — the lane
        budget of one sweep; chunk wider rounds before staging)."""
        if self._disposed:
            raise RuntimeError("super-round program is disposed")
        t0 = time.perf_counter()
        backend = self.backend
        block = self.block
        routed = backend.mesh_routing_active()
        stages: List = []
        sizes: List[int] = []
        for groups in bursts:
            if len(groups) > 32 * self.max_words:
                raise ValueError(
                    f"a round carries {len(groups)} groups > 32*max_words="
                    f"{32 * self.max_words}; chunk rounds before staging"
                )
            per_group = [
                (block.base + backend._check_rows(block, g)).tolist()
                for g in groups
            ]
            if routed:
                # the routed chain runs ONE union wave per round (per-group
                # lane counts are a single-chip lane feature) — the round's
                # seed set is the dedup'd union of its groups
                stages.append(
                    sorted({int(i) for g in per_group for i in g})
                )
            else:
                stages.append(per_group)
            sizes.append(len(groups))
        staged = StagedSeeds(
            [list(g) for g in bursts], stages, sizes, routed=routed,
        )
        if staged.routed:
            self._pack_routed(staged)
        else:
            self._pack_lanes(staged)
        staged.stage_s = time.perf_counter() - t0
        self.stage_s += staged.stage_s
        return staged

    def _pack_lanes(self, staged: StagedSeeds) -> None:
        """Seed lists → the pinned-geometry int32[K, 32*words, S] tensor in
        the mirror's NEW-id space. Needs a built topo mirror for the id
        map; with none and nothing in flight it builds one (one-time),
        otherwise packing defers to dispatch (which will have harvested)."""
        dg = self.backend.graph
        if dg._topo_mirror is None:
            if self._inflight:
                return  # dispatch packs after the forced harvest
            self.backend.build_topo_mirror()
        m = dg._topo_mirror
        n_tot = m["n_tot"]
        words = self._geom_words
        for s in staged.stages:
            while 32 * words < max(len(s), 1):
                words <<= 1
        if words > self.max_words:
            raise ValueError(
                f"super-round needs {words} words > max_words={self.max_words}"
            )
        width = self._geom_width
        for s in staged.stages:
            for g in s:
                while width < max(len(g), 1):
                    width <<= 1
        self._geom_words, self._geom_width = words, width
        L = 32 * words
        shape = (staged.depth, L, width)
        if dg.device.type == "cuda":
            # the back buffer: pinned, so dispatch's copy to the graph's seed
            # input is asynchronous (the pool hands out no buffer a pending
            # copy still reads)
            mats = PINNED.take(shape, torch.int32)
            arr = mats.numpy()
            arr.fill(n_tot)
        else:
            mats = arr = np.full(shape, n_tot, dtype=np.int32)
        for i, s in enumerate(staged.stages):
            mat, _w = pack_lane_matrix(
                s, pad_id=n_tot, n_valid=m["n_nodes"], id_map=m["inv_perm"],
            )
            arr[i, : mat.shape[0], : mat.shape[1]] = mat
        staged.mats = mats
        staged.words = words
        staged.mirror_rebuilds = dg.mirror_rebuilds

    def _pack_routed(self, staged: StagedSeeds) -> None:
        """Routed back buffer: the union-chain seed tensor packed through
        the live routed graph's row permutation (host-only). With no
        routed mirror built yet, packing defers to dispatch (the first
        dispatch builds the mirror)."""
        entry = self.backend._routed_mirror
        if entry is None:
            return
        from ..cluster.placement import PlacementError

        try:
            staged.routed_staged = entry["graph"].stage_union_chain(
                staged.stages
            )
        except PlacementError:
            # mid-rebuild / off-mesh permutation state: nothing was
            # packed — defer to dispatch, which stages against the
            # then-current mirror (and contains a repeat as a counted
            # fault). Genuine staging bugs raise to the caller.
            staged.routed_staged = None

    # ------------------------------------------------------------------ dispatch
    def dispatch(self, staged: StagedSeeds) -> SuperRoundTicket:
        """Enqueue a staged super-round (no readback) and — with one
        already in flight — drain ITS fence buffer while this one runs.
        Falls back, counted, per the module contract."""
        if self._disposed:
            raise RuntimeError("super-round program is disposed")
        backend = self.backend
        if backend._journal:
            # flush() with a chain in flight would read and clear invalid
            # state through the STALE host mirror (the WavePipeline
            # journal-guard hazard) — harvest first, counted, and cover
            # BOTH planes: the pipeline's fused chains are just as
            # unharvested as this program's super-rounds
            if self._inflight:
                self.journal_forced_harvests += 1
                self._harvest_all()
            pipe = backend.pipeline
            if pipe is not None and pipe._inflight:
                pipe.harvest_inflight()
        backend.flush()
        cause, seqs = backend._begin_wave_span(staged.depth)
        wd = backend.watchdog
        if wd is not None and wd.mode == wd.MODE_HOST:
            return self._eager_ticket(staged, cause, seqs, time.perf_counter())
        try:
            if wd is not None:
                # the chaos hook: an armed injection IS a fault, not the
                # fusibility fallback below
                wd._check_injected()
        except Exception as e:  # noqa: BLE001 — injected fault: contain + count
            return self._fault_ticket(e, staged, cause, seqs)
        t0 = time.perf_counter()
        try:
            if staged.routed:
                ticket = self._dispatch_routed(staged, cause, seqs, t0)
            else:
                ticket = self._dispatch_lanes(staged, cause, seqs, t0)
        except (NotFusible, ValueError):
            # not a fault: the mirror cannot serve the fused path right now
            # (invalid, multi-pass pileup, out-of-contract seeds) — the
            # counted eager fallback, same policy as the WavePipeline. Any
            # other RuntimeError (a failed CUDA launch, a device-side error)
            # is a fault and takes the branch below
            return self._eager_ticket(staged, cause, seqs, t0)
        except Exception as e:  # noqa: BLE001 — dispatch fault: contain + count
            return self._fault_ticket(e, staged, cause, seqs)
        ticket.dispatch_s = time.perf_counter() - t0
        self.dispatch_s += ticket.dispatch_s
        self.superrounds_dispatched += 1
        self.rounds_total += staged.depth
        self._inflight.append(ticket)
        while len(self._inflight) > self.MAX_INFLIGHT:
            self._harvest(self._inflight.popleft())
        return ticket

    def _dispatch_lanes(self, staged, cause, seqs, t0) -> SuperRoundTicket:
        from .backend import _RefreshChainTicket

        backend = self.backend
        dg = backend.graph
        if staged.mats is None or staged.mirror_rebuilds != dg.mirror_rebuilds:
            # the buffer was packed against a mirror that has since
            # re-leveled (new inv_perm — the staged NEW-ids are garbage in
            # the new order), or packing deferred: re-pack, counted
            if staged.mats is not None:
                self.restages += 1
            self._pack_lanes(staged)
            if staged.mats is None:
                raise NotFusible("no topo mirror — super-round needs the fused path")
        if self._live_refresh is not None:
            # thread the in-flight chain's OUTPUT futures as this chain's
            # input columns: back-to-back super-rounds chain device-side
            refresh = dict(self._live_refresh)
        else:
            refresh = backend._block_refresh_state(self.block)
        pre_block_invalid = dg._h_invalid[
            self.block.base : self.block.end()
        ].copy()
        pending = dg.dispatch_waves_superround(
            staged.mats, staged.sizes, refresh, staged.words
        )
        inner = _RefreshChainTicket(
            backend, self.block, staged.depth, list(range(staged.depth)),
            staged.stages, refresh, pending, cause, seqs, pre_block_invalid,
            t0, refresh["update_valid"], kind="superround",
        )
        self._live_refresh = refresh
        return SuperRoundTicket(self, inner, staged, cause, seqs, t0)

    def _dispatch_routed(self, staged, cause, seqs, t0) -> SuperRoundTicket:
        from ..diagnostics.mesh_telemetry import reset_dispatch_cause, set_dispatch_cause

        backend = self.backend
        # the routed invalid_version protocol ties harvest (which also
        # folds the per-super-round refresh) to the dense mirror — harvest
        # the previous super-round before dispatching the next; staging
        # still overlapped its flight window
        self._harvest_all()
        # thread THIS wave's cause into the routed dispatch so the graph's
        # host-boundary trace segments share it — one identity
        # per wave, never a second cause minted a layer down
        token = set_dispatch_cause(cause)
        try:
            try:
                pending = backend.dispatch_waves_routed_chain(
                    staged.stages, staged=staged.routed_staged
                )
            except Exception as e:
                from ..cluster.placement import PlacementError

                if not isinstance(e, PlacementError):
                    raise
                # staged against a placement that resharded: re-pack + retry
                # once, counted — never dispatch stale row permutations
                self.restages += 1
                staged.routed_staged = None
                pending = backend.dispatch_waves_routed_chain(staged.stages)
        finally:
            reset_dispatch_cause(token)
        return SuperRoundTicket(
            self, None, staged, cause, seqs, t0, routed_pending=pending
        )

    # ------------------------------------------------------------------ fallbacks
    def _eager_ticket(self, staged, cause, seqs, t0) -> SuperRoundTicket:
        ticket = SuperRoundTicket(self, None, staged, cause, seqs, t0)
        ticket.done = True
        ticket.fallback = True
        # dispatch() never counted this super-round's rounds (it returned
        # early); a HARVEST-time fault's rounds were already counted at
        # its dispatch, so the count lives here, not in _run_eager
        self.rounds_total += staged.depth
        ticket.per_burst = self._run_eager(staged, cause, seqs)
        return ticket

    def _fault_ticket(self, e, staged, cause, seqs) -> SuperRoundTicket:
        ticket = SuperRoundTicket(
            self, None, staged, cause, seqs, time.perf_counter()
        )
        ticket.done = True
        ticket.fallback = True
        self.rounds_total += staged.depth  # see _eager_ticket
        ticket.per_burst = self._on_fault(e, staged, cause, seqs)
        return ticket

    def _run_eager(self, staged, cause, seqs) -> List[np.ndarray]:
        """Per-round blocking execution under the PRE-MINTED seqs (the
        non-fused regime the super-round degrades to): each round is one
        lane burst + one device refresh, dispatched and harvested
        sequentially. Counted; never silent."""
        backend = self.backend
        self.eager_rounds += staged.depth
        per_burst: List[np.ndarray] = []
        t0 = time.perf_counter()
        total = 0
        try:
            for i, seed_lists in enumerate(staged.stages):
                if staged.routed:
                    # routed stages are flat per-round unions: one lane
                    seed_lists = [seed_lists]
                backend.flush()
                # a degraded watchdog's host loop returns the union's ids,
                # the fused lanes its mask: the apply takes either
                counts, union = backend._wave_lanes(seed_lists)
                backend.last_cause_id = cause
                backend.last_wave_seq = seqs[i]
                backend._apply_newly(union)
                per_burst.append(counts.astype(np.int64))
                total += int(counts.sum())
                backend.waves_run += len(seed_lists)
                backend.device_invalidations += int(counts.sum())
                self.cleared_total += backend.refresh_block_on_device(self.block)
        finally:
            backend.last_wave_seq = seqs[0]
        backend._profile_wave(
            "superround_eager", sum(len(s) for s in staged.stages), cause,
            t0, time.perf_counter(), total, seqs[0],
            groups=sum(staged.sizes), seq_span=(seqs[0], seqs[-1]),
        )
        return per_burst

    def _on_fault(self, e: BaseException, staged, cause, seqs) -> List[np.ndarray]:
        """A super-round FAULTED (dispatch or harvest): re-sync the device
        invalid state to host and two-tier-apply whatever the half-run
        chain committed (attributed to the span head — per-round
        attribution died with the readback); conservatively RE-STALE the
        whole bound block and refresh it once (the chain may have cleared
        block rows' invalid bits in-program while its refreshed values
        were never committed to the table — without this, those rows read
        consistent with stale values: silent staleness, the one
        unacceptable outcome); then re-run the staged rounds on the
        counted eager path with the attached watchdog degraded."""
        self.faults += 1
        log.warning("super-round: fault contained (%r)", e)
        backend = self.backend
        dg = backend.graph
        self._live_refresh = None
        if dg._g is not None and not dg._dirty:
            pre = dg._h_invalid.copy()
            dg._sync_invalid_back()
            committed = dg._h_invalid & ~pre
            if committed.any():
                backend.last_cause_id = cause
                backend.last_wave_seq = seqs[0]
                backend._apply_newly(committed)
        blk = self.block
        dg.mark_invalid(
            np.arange(blk.base, blk.end(), dtype=np.int64)
        )
        blk.table._mark_stale_from_wave_mask(np.ones(blk.n_rows, dtype=bool))
        backend.refresh_block_on_device(blk)
        wd = backend.watchdog
        if wd is not None:
            wd._on_fault(e)
        per_burst = self._run_eager(staged, cause, seqs)
        if wd is not None:
            wd._after_host_burst()
        return per_burst

    # ------------------------------------------------------------------ harvest
    def _harvest(self, ticket: SuperRoundTicket) -> None:
        ticket.harvest()

    def _harvest_all(self) -> None:
        while self._inflight:
            self._harvest(self._inflight[0])

    def drain(self) -> int:
        """The barrier: harvest every in-flight super-round (two-tier
        apply + fence drain land before this returns). Returns the number
        of super-rounds resolved by this call."""
        n = len(self._inflight)
        self._harvest_all()
        return n

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        """JAX's keys, plus the split of the host time (``dispatch_s``,
        ``unpack_s``, ``apply_s``), the replays' device ms, and the programs
        by route: ``replays``, ``captures`` (first captures and
        re-captures), ``recaptures`` and ``uncaptured`` (the adaptive sweep,
        run stream-ordered)."""
        # async frontier passthrough: when the routed mirror
        # rides the asynchronous exchange, surface its merge/quiescence
        # telemetry beside the super-round counters — the resident program
        # itself is UNCHANGED (double-buffered staging, one scan per
        # super-round); only the wave kernel inside the chain differs
        routed_async: dict = {}
        entry = self.backend._routed_mirror
        if entry is not None:
            g = entry.get("graph")
            if g is not None and getattr(g, "exchange_async", False):
                routed_async = {
                    "exchange_async": True,
                    "async_depth": g.async_depth,
                    "quiescence_checks": g.quiescence_checks,
                    "spec_levels_total": g.spec_levels_total,
                }
        r = self.routes
        return {
            "depth": self.depth,
            "superrounds_dispatched": self.superrounds_dispatched,
            "rounds_total": self.rounds_total,
            "eager_rounds": self.eager_rounds,
            "faults": self.faults,
            "restages": self.restages,
            "journal_forced_harvests": self.journal_forced_harvests,
            "harvests": self.harvests,
            "inflight": len(self._inflight),
            "cleared_total": self.cleared_total,
            "stage_s": round(self.stage_s, 4),
            "stall_s": round(self.stall_s, 4),
            "wall_s": round(self.wall_s, 4),
            "occupancy": round(self.occupancy(), 4),
            "host_stall_ms": round(self.host_stall_ms(), 3),
            "dispatch_s": round(self.dispatch_s, 4),
            "unpack_s": round(self.unpack_s, 4),
            "apply_s": round(self.apply_s, 4),
            "device_ms": round(self.device_ms, 4),
            "replays": r.get("replay", 0) + r.get("capture", 0) + r.get("recapture", 0),
            "captures": r.get("capture", 0) + r.get("recapture", 0),
            "recaptures": r.get("recapture", 0),
            "uncaptured": r.get("stream", 0),
            **routed_async,
        }

    def dispose(self) -> None:
        """Drain outstanding work and detach from the backend
        (idempotent)."""
        if self._disposed:
            return
        self.drain()
        self._disposed = True
        if self.backend.super_rounds is self:
            self.backend.super_rounds = None
        global_metrics().unregister_collector(self)
