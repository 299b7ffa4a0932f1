"""TpuGraphBackend — live mirror of a FusionHub's dependency graph on device.

Port of the core of ``stl_fusion_tpu/graph/backend.py``. The class keeps its
JAX name so the counterpart is easy to find; ``GraphBackend`` is an alias.

The bridge between the authoritative host graph (ComputedRegistry + per-node
edge sets) and the device CSR mirror (DeviceGraph): registry, edge and
invalidate events stream in through the hub hooks, are journaled host-side,
and replay IN ORDER into the device mirror before each wave.
``invalidate_cascade`` then runs the transitive invalidation closure on the
device and applies the result back to host nodes via
``Computed.invalidate_local`` (no host cascade — the device already walked
the graph).

Applying a device wave back to host is two-tier:

- **watched nodes** (anything with an invalidation handler — states, push
  subscriptions, ``when_invalidated`` waiters) are invalidated EAGERLY;
- **unwatched nodes** get a bit in a host-side ``pending`` mask, which the
  read path materializes lazily on next access.

A recompute (epoch bump) clears the node's pending bit: the wave targeted
the previous version, and on device the new epoch's edges never matched.

The sharded mirror (``to_sharded``, ``sharded_mirror``,
``invalidate_cascade_batch_sharded``) runs union bursts on a mesh of logical
shards (``parallel/``). ``build_topo_mirror`` builds the device graph's topo
and lat mirrors, which ``invalidate_cascade_batch`` then rides, and
``invalidate_cascade_batch_lanes`` runs up to 512 independent command groups
in one mirror sweep, one bit lane each.

Row blocks (:class:`RowBlock`, ``bind_table_rows``): a ``MemoTable``'s dense
key space registers as ONE contiguous block of graph nodes, its dependency
edges are declared in bulk numpy, and waves over it apply to the table
vectorized; ``refresh_block_on_device`` recomputes the block's stale rows
through the table's device loader and the ``block_refresh`` kernel
(``ops/block_refresh.py``). ``cascade_rows_lanes_refresh_chain`` runs K
rounds of (lane burst → block refresh) as one program (a ticket with
``nonblocking=True``), and ``enable_super_rounds`` installs the resident
super-round program (``graph/superround.py``); on the card both are captured
CUDA graphs. The packed mesh mirror (``packed_mirror``,
``invalidate_cascade_batch_lanes_sharded``, ``cascade_rows_lanes_sharded``)
runs lane bursts on a mesh through the packed pull wave
(``parallel/packed_wave.py``), patched in place under structural churn.
An attached :class:`~stl_fusion_tpu_torch.resilience.WaveWatchdog`
(``attach_watchdog``) routes every union, lane and sequenced burst: a fused
burst that raises or misses its deadline re-runs on the split host loop (one
dense wave a seed group), and the first fused burst after recovery is
checked against a host BFS oracle. The routed mesh mirror
(``enable_mesh_routing``, ``routed_mirror``) pins the graph's CSR shards
onto a mesh per the cluster shard map (``parallel/routed_wave.py``): its
union waves and the pipeline's routed chain resolve cross-shard frontiers
on the device, and ``apply_mesh_reshard`` moves the shards a new map
reassigns.
"""
from __future__ import annotations

import hashlib
import logging
import threading
import time
import weakref
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diagnostics.flight_recorder import RECORDER
from ..diagnostics.metrics import WaveProfiler, global_metrics, next_wave_seq
from ..diagnostics.tracing import CAUSE_PREFIX, current_span, span_cause_id
from ..ops.block_refresh import block_refresh, loader_rows
from ..parallel import ShardedDeviceGraph, graph_mesh
from .device_graph import DeviceGraph, check_structure_cache
from .program_cache import NotFusible, ProgramCache

if TYPE_CHECKING:
    from ..core.computed import Computed
    from ..core.hub import FusionHub

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["TpuGraphBackend", "GraphBackend", "RowBlock"]

#: process-unique cause-id prefix, shared with tracing
_CAUSE_PREFIX = CAUSE_PREFIX


class RowBlock:
    """A MemoTable bound to a contiguous block of graph node ids — the
    columnar registration unit.

    A table-backed service registers its whole dense key space in ONE
    allocation (``bind_table_rows``) and declares dependency edges in bulk
    numpy (``declare_row_edges``): graph construction runs at array speed,
    not at Python-object speed. Row ``r`` of the table IS graph node
    ``base + r``; scalar ``@compute_method`` nodes for the same keys adopt
    the row's node id on registration, so the scalar and columnar views
    cascade as ONE logical node."""

    __slots__ = ("table", "base", "n_rows", "_decl_src", "_decl_dst", "_csr", "_dev_refresh")

    def __init__(self, table, base: int, n_rows: int):
        self.table = table
        self.base = base
        self.n_rows = n_rows
        # declared topology, kept so a scalar recompute (epoch bump) of a
        # row can re-declare that row's in-edges at the new epoch — the
        # declared-edge contract is "every version until redeclared"
        self._decl_src: List[np.ndarray] = []
        self._decl_dst: List[np.ndarray] = []
        self._csr: Optional[Tuple[np.ndarray, np.ndarray, int]] = None
        #: the block's resident burst→refresh programs (chains, super-rounds)
        self._dev_refresh = ProgramCache()

    def end(self) -> int:
        return self.base + self.n_rows

    def _declared_csr(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """CSR (starts, src_nids, declarations_included) of declared edges
        by LOCAL dst row. Built lazily and NOT rebuilt per declaration —
        per-row queries scan the post-build declaration tail instead (see
        :meth:`declared_in_srcs`): a full rebuild sorts EVERY declared edge,
        while churn appends a few thousand. Refolded once the tail outgrows
        the CSR itself."""
        if self._csr is not None:
            starts, src, included = self._csr
            tail_edges = sum(len(a) for a in self._decl_src[included:])
            if tail_edges > max(len(src), 4096):
                self._csr = None
        if self._csr is None:
            if self._decl_src:
                src = np.concatenate(self._decl_src)
                dst = np.concatenate(self._decl_dst)
                local = dst - self.base
                order = np.argsort(local, kind="stable")
                src, local = src[order], local[order]
                starts = np.zeros(self.n_rows + 1, dtype=np.int64)
                np.add.at(starts[1:], local, 1)
                starts = np.cumsum(starts)
            else:
                src = np.empty(0, dtype=np.int32)
                starts = np.zeros(self.n_rows + 1, dtype=np.int64)
            self._csr = (starts, src, len(self._decl_src))
        return self._csr

    def declared_in_srcs(self, nid: int) -> np.ndarray:
        """Declared in-edge sources of graph node ``nid`` (base CSR slice +
        a linear scan of declarations made after the CSR was built)."""
        starts, src, included = self._declared_csr()
        r = nid - self.base
        s, e = int(starts[r]), int(starts[r + 1])
        parts = [src[s:e]]
        for s_arr, d_arr in zip(self._decl_src[included:], self._decl_dst[included:]):
            sel = d_arr == nid
            if sel.any():
                parts.append(s_arr[sel])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _finish_block_refresh_bookkeeping(table, cleared: np.ndarray) -> None:
    """The host bookkeeping tail of a columnar device refresh: stale
    accounting for the rows the device recomputed, the table version bump,
    and the non-backend ``on_refresh`` fan-out. ``cleared`` is a bool mask
    over the table's rows."""
    was_stale = table._stale_host & cleared
    table._stale_count -= int(np.count_nonzero(was_stale))
    table._stale_host &= ~cleared
    table._bump()
    extern = [h for h in table.on_refresh if not getattr(h, "_backend_hook", False)]
    if extern and cleared.any():
        ids_np = np.nonzero(cleared)[0].astype(np.int32)
        for h in extern:
            h(ids_np)


def _loader_rows(table, n_rows: int) -> torch.Tensor:
    """Every row of a bound table through its DEVICE loader
    (``fn(arange(n_rows), *args)``), as a contiguous tensor with the
    table's shape and dtype on its device."""
    args = tuple(table.device_loader_args()) if table.device_loader_args is not None else ()
    return loader_rows(table.device_compute_fn, args, table._values[:n_rows])


class _RefreshChainTicket:
    """An in-flight burst→refresh chain (``cascade_rows_lanes_refresh_chain``
    with ``nonblocking=True``, and each super-round): the programs are
    enqueued; :meth:`harvest` blocks on the results and runs the two-tier
    host apply per logical wave. ``dispatched_at`` lets the caller account
    the overlap window (host work between dispatch and harvest ran while the
    chain executed on the device)."""

    __slots__ = (
        "backend", "block", "n_bursts", "stage_burst", "stages", "refresh",
        "pending", "cause", "seqs", "pre_block_invalid", "dispatched_at",
        "update_valid", "done", "cleared_total", "kind",
    )

    def __init__(self, backend, block, n_bursts, stage_burst, stages, refresh, pending, cause,
                 seqs, pre_block_invalid, dispatched_at, update_valid,
                 kind: str = "lanes_refresh_chain"):
        self.backend = backend
        self.block = block
        self.n_bursts = n_bursts
        self.stage_burst = stage_burst
        self.stages = stages
        self.refresh = refresh
        self.pending = pending
        self.cause = cause
        self.seqs = seqs
        self.pre_block_invalid = pre_block_invalid
        self.dispatched_at = dispatched_at
        self.update_valid = update_valid
        self.kind = kind
        self.done = False
        #: filled at harvest: the block rows the chained refreshes recomputed
        self.cleared_total = 0

    def harvest(self) -> list:
        """Block on the chain, apply every stage's newly mask under its own
        wave seq, and finish the refresh bookkeeping ONCE, at the end state
        (the device refreshed every block row invalid at ANY stage). Returns
        one int64 newly-count array per burst. A second harvest raises."""
        if self.done:
            raise RuntimeError("refresh chain already harvested")
        self.done = True
        backend = self.backend
        block, table = self.block, self.block.table
        seqs, stages = self.seqs, self.stages
        dg = backend.graph
        stage_counts, stage_masks = dg.harvest_waves_lanes_chain(self.pending)
        t1 = time.perf_counter()
        # the chained table state: the programs refreshed values (and
        # validity when update_valid) in place, so these are the same tensors
        table._values = self.refresh["values"]
        if self.update_valid:
            table._valid_dev = self.refresh["valid_dev"]
        backend.last_cause_id = self.cause
        per_burst = [np.empty(0, dtype=np.int64) for _ in range(self.n_bursts)]
        cleared_rows = self.pre_block_invalid.copy()
        total_newly = 0
        for i, (cnts, mask) in enumerate(zip(stage_counts, stage_masks)):
            backend.last_wave_seq = seqs[i]
            backend._apply_newly(mask)
            sub = mask[block.base : block.end()]
            cleared_rows |= sub
            self.cleared_total += int(sub.sum())
            bi = self.stage_burst[i]
            per_burst[bi] = np.concatenate([per_burst[bi], cnts])
            total_newly += int(mask.sum())
        backend.last_wave_seq = seqs[0]
        _finish_block_refresh_bookkeeping(table, cleared_rows)
        total_counts = sum(int(c.sum()) for c in stage_counts)
        backend.waves_run += sum(len(st) for st in stages)
        backend.device_invalidations += total_counts
        backend._profile_wave(
            self.kind, sum(len(g) for st in stages for g in st), self.cause, self.dispatched_at,
            t1, total_newly, seqs[0], groups=sum(len(st) for st in stages),
            fused_depth=len(stages), seq_span=(seqs[0], seqs[-1]),
            dispatches=self.pending["dispatches"],
        )
        return per_burst


class TpuGraphBackend:
    def __init__(
        self,
        hub: "FusionHub",
        node_capacity: int = 4096,
        edge_capacity: int = 16384,
        device=None,
    ):
        self.hub = hub
        self.graph = DeviceGraph(node_capacity, edge_capacity, device=device)
        self._lock = threading.Lock()
        self._id_by_input: Dict[object, int] = {}
        self._computed_by_id: Dict[int, "weakref.ref[Computed]"] = {}
        # ordered event journal: ("bump", nid) | ("edge", (src, dst)) |
        # ("invalid", nid) (+ the columnar kinds "epack"/"icasc"/"cpack" once
        # row blocks are ported). Order preserves causality — an invalidation
        # mark buffered before a node's recompute-bump must not survive it.
        self._journal: List[Tuple[str, object]] = []
        # pending = device-invalidated, not yet materialized on host;
        # watched = has invalidation observers → apply eagerly
        self._pending = np.zeros(self.graph.n_cap + 1, dtype=bool)
        self._watched = np.zeros(self.graph.n_cap + 1, dtype=bool)
        # nids whose invalidation is CURRENTLY being applied from a device
        # wave — only those skip the journal echo
        self._applying_ids: set = set()
        # columnar row blocks (bind_table_rows): sorted by base, with flat
        # base/end arrays for O(log blocks) wave partitioning
        self._row_blocks: List[RowBlock] = []
        self._block_bases = np.empty(0, dtype=np.int64)
        self._block_ends = np.empty(0, dtype=np.int64)
        self._block_by_table: Dict[int, RowBlock] = {}
        #: the nonblocking wave pipeline (``graph/nonblocking.py``): None
        #: while the hub runs blocking; ``Computed.invalidate_eventually``
        #: and ``FusionHub.enable_nonblocking`` route here
        self.pipeline = None
        #: the resident super-round program (``graph/superround.py``), which
        #: ``enable_super_rounds`` installs; ``WavePipeline.drain()`` covers
        #: its in-flight work
        self.super_rounds = None
        #: True while a pipeline harvest applies chain N-1's masks with chain
        #: N in flight (the fan-out's overlap window)
        self.overlap_active = False
        #: the wave watchdog (``attach_watchdog``): None runs every burst on
        #: the fused path with no deadline or oracle
        self.watchdog = None
        self._routed_config: Optional[dict] = None  # see enable_mesh_routing
        self._routed_mirror: Optional[dict] = None  # see routed_mirror
        self._sharded_mirror: Optional[dict] = None  # see sharded_mirror
        self._packed_mirror: Optional[dict] = None  # see packed_mirror
        self.waves_run = 0
        self.device_invalidations = 0
        #: fired on every wave application with the newly-invalid set as the
        #: device shipped it (an id array or a bool mask over node ids)
        self.newly_hooks: List = []
        #: per-wave timeline recorder; ``profiler.enabled = False`` reduces
        #: the instrumentation to attribute checks
        self.profiler = WaveProfiler()
        self.last_cause_id: Optional[str] = None
        self.last_wave_applied_ts: Optional[float] = None
        self.last_wave_seq: Optional[int] = None
        hub.registry.on_register.append(self._on_register)
        hub.edge_added_hooks.append(self._on_edge_added)
        hub.invalidated_hooks.append(self._on_invalidated)
        hub.attach_graph_backend(self)
        global_metrics().register_collector(self, TpuGraphBackend._collect_metrics)

    def _collect_metrics(self) -> dict:
        """Pull-time gauges for /metrics (weak-registered)."""
        return {
            "fusion_graph_nodes": self.graph.n_nodes,
            "fusion_graph_edges": self.graph.n_edges,
            "fusion_graph_journal_depth": len(self._journal),
            "fusion_waves_run_total": self.waves_run,
            "fusion_device_invalidations_total": self.device_invalidations,
        }

    def _begin_wave(self):
        """Mint this wave's cause id (the open tracing span's, else a
        process-unique ``wave#seq``) and its seq. Returns ``(cause, seq)``."""
        cause, seqs = self._begin_wave_span(1)
        return cause, seqs[0]

    def _begin_wave_span(self, n: int):
        """Mint ``n`` logical-wave seqs for one burst of several stages: the
        profiler record carries the whole span, and the cause id names it
        (``wave#s0-s1``) unless a tracing span is open. Returns ``(cause,
        seqs)``."""
        seqs = [next_wave_seq() for _ in range(max(n, 1))]
        self.last_wave_seq = seqs[0]
        span = current_span()
        if span is not None:
            cause = span_cause_id(span)
        elif len(seqs) == 1:
            cause = f"{_CAUSE_PREFIX}/wave#{seqs[0]}"
        else:
            cause = f"{_CAUSE_PREFIX}/wave#{seqs[0]}-{seqs[-1]}"
        self.last_cause_id = cause
        return cause, seqs

    def _profile_wave(self, kind, seeds, cause, t0, t1, newly, seq, groups=None,
                      fused_depth=None, seq_span=None, dispatches=None, mesh=None) -> None:
        if self.profiler.enabled:
            self.profiler.record_wave(
                kind,
                seeds=seeds,
                newly=newly,
                device_ms=(t1 - t0) * 1e3,
                apply_ms=(time.perf_counter() - t1) * 1e3,
                cause=cause,
                groups=groups,
                seq=seq,
                fused_depth=fused_depth,
                seq_span=seq_span,
                dispatches=dispatches,
                mesh=mesh,
            )
            if fused_depth is not None and dispatches:
                per = max(int(round(fused_depth / dispatches)), 1)
                for _ in range(int(dispatches)):
                    self.profiler.note_fused_dispatch(per)
        if RECORDER.enabled:
            detail = f"{kind}: seeds={seeds} newly={newly}"
            if fused_depth is not None:
                detail += f" fused_depth={fused_depth}"
            RECORDER.note("wave", cause=cause, wave=seq, detail=detail)

    # ------------------------------------------------------------------ event feed
    def _on_register(self, computed: "Computed") -> None:
        input = computed.input
        with self._lock:
            nid = self._id_by_input.get(input)
            old = None
            if nid is None:
                nid = self._row_nid_for_input(input)
                if nid is not None:
                    # ADOPTION: the scalar node materializes an EXISTING
                    # columnar row node (row r of a bound table IS node
                    # base+r), so the two views cascade as one logical node.
                    # No epoch bump (the block's declared in-edges belong to
                    # every version until redeclared), but a fresh value
                    # supersedes any device invalid bit — left set, it would
                    # stop future cascades at this node.
                    self._journal.append(("cpack", np.array([nid], np.int32)))
                    self._id_by_input[input] = nid
                    if self._pending[nid]:
                        self._pending[nid] = False
                        old_ref = self._computed_by_id.get(nid)
                        old = old_ref() if old_ref is not None else None
                else:
                    nid = int(self.graph.add_nodes(1)[0])
                    self._id_by_input[input] = nid
                    self._ensure_host_masks()
            else:
                # recompute: next epoch; stale in-edges die, invalid clears.
                # A pending device invalidation of the PREVIOUS version must
                # be materialized on ITS Computed before the bit clears —
                # otherwise the displaced node would read as consistent
                # again once the bit is gone.
                self._journal.append(("bump", nid))
                blk = self._block_of_nid(nid)
                if blk is not None:
                    # a row node's declared in-edges survive the bump: they
                    # are re-declared at the new epoch ("until redeclared")
                    ins = blk.declared_in_srcs(nid)
                    if len(ins):
                        self._journal.append(
                            ("epack", (ins.copy(), np.full(len(ins), nid, np.int32)))
                        )
                if self._pending[nid]:
                    self._pending[nid] = False
                    old_ref = self._computed_by_id.get(nid)
                    old = old_ref() if old_ref is not None else None
            self._computed_by_id[nid] = weakref.ref(computed)
            computed._backend_nid = nid
        if RECORDER.enabled:
            RECORDER.note("registered", key=repr(input), detail=f"nid={nid}")
        if old is not None:
            from ..core.computed import LAZY_WAVE_DETAIL

            self._applying_ids.add(nid)
            try:
                old.invalidate_local(_detail=LAZY_WAVE_DETAIL)
            finally:
                self._applying_ids.discard(nid)

    def _row_nid_for_input(self, input) -> Optional[int]:
        """The columnar node id these call args map to, if the input's
        method is table-backed AND its table is bound to a row block."""
        if not self._block_by_table:
            return None
        md = getattr(input, "method_def", None)
        service = getattr(input, "service", None)
        if md is None or service is None or md.table is None:
            return None
        table = md.peek_table(service)
        if table is None:
            return None
        blk = self._block_by_table.get(id(table))
        if blk is None:
            return None
        row = md.row_for_args(input.args, table)
        if row is None or not (0 <= row < blk.n_rows):
            return None
        return blk.base + int(row)

    def _block_of_nid(self, nid: int) -> Optional[RowBlock]:
        if not self._block_bases.size:
            return None
        i = int(np.searchsorted(self._block_bases, nid, side="right")) - 1
        if i >= 0 and nid < self._block_ends[i]:
            return self._row_blocks[i]
        return None

    def _on_edge_added(self, dependent: "Computed", used: "Computed") -> None:
        with self._lock:
            did = self._id_by_input.get(dependent.input)
            uid = self._id_by_input.get(used.input)
            if did is None or uid is None:
                return  # nodes born before the backend attached
            self._journal.append(("edge", (uid, did)))

    def _on_invalidated(self, computed: "Computed") -> None:
        nid = getattr(computed, "_backend_nid", None)
        if nid is not None and nid in self._applying_ids:
            return  # the device already knows — this IS a wave application
        with self._lock:
            nid = self._id_by_input.get(computed.input)
            if nid is not None:
                self._journal.append(("invalid", nid))
                self._pending[nid] = False  # host led; nothing left to materialize

    def mark_watched(self, computed: "Computed") -> None:
        """An invalidation observer attached: device waves must apply this
        node EAGERLY (hub routes ``Computed.on_invalidated`` here)."""
        nid = getattr(computed, "_backend_nid", None)
        if nid is not None:
            self._watched[nid] = True

    def _ensure_host_masks(self) -> None:
        need = self.graph.n_cap + 1
        if len(self._pending) < need:
            for name in ("_pending", "_watched"):
                old = getattr(self, name)
                arr = np.zeros(need, dtype=bool)
                arr[: len(old)] = old
                setattr(self, name, arr)

    def attach_watchdog(self, watchdog):
        """Route wave dispatches through a resilience.WaveWatchdog: a fused
        burst that raises or blows its deadline degrades to the split host
        loop; the first fused wave after recovery is oracle-verified."""
        self.watchdog = watchdog
        return watchdog

    def _wave_union(self, seed_lists):
        if self.watchdog is not None:
            return self.watchdog.run_union(self.graph, seed_lists)
        return self.graph.run_waves_union(seed_lists)

    def _wave_lanes(self, seed_lists):
        if self.watchdog is not None:
            return self.watchdog.run_lanes(self.graph, seed_lists)
        return self.graph.run_waves_lanes(seed_lists)

    def _wave_union_seq(self, seed_lists):
        if self.watchdog is not None:
            return self.watchdog.run_seq(self.graph, seed_lists)
        return self.graph.run_waves_union_seq(seed_lists)

    # ------------------------------------------------------------------ flush
    def flush(self) -> None:
        """Replay the event journal against the device mirror IN ORDER,
        coalescing consecutive same-type runs into batches. Ordered replay is
        what keeps the mirror coherent: a stale invalid-mark buffered before
        a node's recompute-bump dies with the bump instead of resurrecting."""
        with self._lock:
            journal, self._journal = self._journal, []
        if not journal:
            return
        t_flush0 = time.perf_counter()
        journal_pre = len(journal)
        journal = self._coalesce_bump_epack_pairs(journal)
        journal_post = len(journal)
        icasc_parts: List[np.ndarray] = []
        icasc_s = 0.0  # embedded wave time, subtracted from flush_ms

        def run_icasc() -> None:
            # one union expansion for the accumulated host-led marks (seeds
            # conduct even while already invalid); the seeds themselves are
            # not re-applied, and seeds that were clear before are restored
            nonlocal icasc_s
            nids = np.unique(np.concatenate(icasc_parts))
            icasc_parts.clear()
            cause, wave_seq = self._begin_wave()
            t0 = time.perf_counter()
            was_clear = nids[~self.graph._h_invalid[nids]]
            total, newly_ids = self._wave_union([nids.tolist()])
            newly_ids = newly_ids[~np.isin(newly_ids, nids)]
            if was_clear.size:
                self.graph.clear_invalid_ids(was_clear)
            t1 = time.perf_counter()
            self._apply_newly(newly_ids)
            self.device_invalidations += total
            self._profile_wave("icasc", len(nids), cause, t0, t1, len(newly_ids), wave_seq)
            icasc_s += time.perf_counter() - t0

        i, n = 0, len(journal)
        while i < n:
            kind = journal[i][0]
            j = i
            while j < n and journal[j][0] == kind:
                j += 1
            batch = [payload for _, payload in journal[i:j]]
            if kind in ("cpack", "bump") and icasc_parts:
                # a refresh/recompute of an ALREADY-ACCUMULATED mark expands
                # the deferred marks first, in journal order
                touched = (
                    np.concatenate(batch) if kind == "cpack"
                    else np.asarray(batch, dtype=np.int32)
                )
                if np.isin(touched, np.concatenate(icasc_parts)).any():
                    run_icasc()
            if kind == "bump":
                self.graph.bump_epochs(np.asarray(batch, dtype=np.int32))
            elif kind == "edge":
                arr = np.asarray(batch, dtype=np.int32)
                # dst_epoch defaults to the dependent's CURRENT epoch, which
                # is correct exactly because earlier bumps already applied
                self.graph.add_edges(arr[:, 0], arr[:, 1])
            elif kind == "epack":  # bulk-declared row edges (already nids)
                self.graph.add_edges(
                    np.concatenate([p[0] for p in batch]),
                    np.concatenate([p[1] for p in batch]),
                )
            elif kind == "icasc":
                # host-led marks mark their bits NOW and expand in ONE union
                # wave at the end of the flush
                nids = np.concatenate(batch)
                self.graph.mark_invalid(nids)
                icasc_parts.append(nids)
            elif kind == "cpack":  # bulk refreshes: consistent again, no bump
                self.graph.clear_invalid_ids(np.concatenate(batch))
            else:  # invalid
                self.graph.mark_invalid(np.asarray(batch, dtype=np.int32))
            i = j
        if icasc_parts:
            run_icasc()
        if self.profiler.enabled:
            self.profiler.note_flush(
                journal_pre,
                journal_post,
                (time.perf_counter() - t_flush0 - icasc_s) * 1e3,
            )

    @staticmethod
    def _coalesce_bump_epack_pairs(journal: List[Tuple[str, object]]) -> List[Tuple[str, object]]:
        """Rewrite maximal alternating ``bump x, epack(→x), bump y,
        epack(→y), ...`` runs (pairwise-distinct nids) into a bump run
        followed by an epack run, so the batcher replays them as ONE epoch
        scatter + ONE edge append. Sound because the entries commute: an
        epack's edges carry their DEPENDENT's current epoch, which only that
        dependent's own bump (already ahead of it) changes. A repeated nid
        ends the run."""
        n = len(journal)
        if n < 4:
            return journal
        out: List[Tuple[str, object]] = []
        i = 0
        while i < n:
            if i + 3 < n and journal[i][0] == "bump" and journal[i + 1][0] == "epack":
                bumps: List[Tuple[str, object]] = []
                epacks: List[Tuple[str, object]] = []
                seen = set()
                j = i
                while (
                    j + 1 < n
                    and journal[j][0] == "bump"
                    and journal[j + 1][0] == "epack"
                    and journal[j][1] not in seen
                ):
                    nid = journal[j][1]
                    _srcs, dsts = journal[j + 1][1]
                    if len(dsts) == 0 or not (dsts == nid).all():
                        break  # not the re-declare shape: keep strict order
                    seen.add(nid)
                    bumps.append(journal[j])
                    epacks.append(journal[j + 1])
                    j += 2
                if len(bumps) > 1:
                    out.extend(bumps)
                    out.extend(epacks)
                    i = j
                    continue
            out.append(journal[i])
            i += 1
        return out

    # ------------------------------------------------------------------ offload
    def invalidate_cascade(self, computed: "Computed", collect_cap: int = 8192) -> int:
        """Run the invalidation wave for ``computed`` ON DEVICE, then apply
        the closure to host state two-tier. Returns nodes the device
        invalidated."""
        self.flush()
        nid = self._id_by_input.get(computed.input)
        if nid is None:
            computed.invalidate(immediately=True)
            return 1
        cause, wave_seq = self._begin_wave()
        t0 = time.perf_counter()
        count, newly_ids = self.graph.run_wave_collect([nid], cap=collect_cap)
        t1 = time.perf_counter()
        self._apply_newly(newly_ids)
        self.waves_run += 1
        self.device_invalidations += count
        self._profile_wave("collect", 1, cause, t0, t1, len(newly_ids), wave_seq)
        return count

    def invalidate_cascade_batch(self, computeds: Sequence["Computed"]) -> int:
        """Cascade MANY seed invalidations in one union BFS + one readback.
        Identical final state to running them one by one (invalidation is
        idempotent and the host applies only the union). Returns the total
        newly-invalidated count."""
        self.flush()
        seeds: List[List[int]] = []
        fallback = 0
        for c in computeds:
            nid = self._id_by_input.get(c.input)
            if nid is None:
                c.invalidate(immediately=True)
                fallback += 1
            else:
                seeds.append([nid])
        if not seeds:
            return fallback
        cause, wave_seq = self._begin_wave()
        t0 = time.perf_counter()
        total, newly_ids = self._wave_union(seeds)
        t1 = time.perf_counter()
        self._apply_newly(newly_ids)
        self.waves_run += len(seeds)
        self.device_invalidations += total
        self._profile_wave("union", len(seeds), cause, t0, t1, len(newly_ids), wave_seq)
        return total + fallback

    def _apply_newly(self, newly) -> None:
        """Two-tier host application of a device wave's newly-invalid set
        (an id array, or a bool mask over node ids)."""
        self.last_wave_applied_ts = time.perf_counter()
        prev_wave = RECORDER.current_wave
        RECORDER.current_wave = self.last_wave_seq
        try:
            if isinstance(newly, np.ndarray) and newly.dtype == np.bool_:
                return self._apply_newly_mask(newly)
            self._apply_newly_ids(newly)
        finally:
            RECORDER.current_wave = prev_wave

    def _apply_newly_ids(self, newly_ids) -> None:
        if len(newly_ids) == 0:
            return
        if self._block_bases.size:
            # columnar tier: rows of bound tables go stale VECTORIZED (O(wave)
            # numpy, not O(wave) Python objects); scalar twins still ride the
            # pending/watched tiers below through the shared node id
            idx = np.searchsorted(self._block_bases, newly_ids, side="right") - 1
            in_block = (idx >= 0) & (newly_ids < self._block_ends[np.maximum(idx, 0)])
            if in_block.any():
                for bi in np.unique(idx[in_block]):
                    blk = self._row_blocks[int(bi)]
                    local = newly_ids[in_block & (idx == bi)] - blk.base
                    blk.table._mark_stale_from_wave(local)
                    for h in blk.table.on_wave_invalidate:
                        h(np.asarray(local, dtype=np.int32))
        watched = newly_ids[self._watched[newly_ids]]
        self._pending[newly_ids] = True
        for hook in self.newly_hooks:
            hook(newly_ids)
        self._eager_invalidate(watched)

    def _apply_newly_mask(self, newly: np.ndarray) -> None:
        """Mask twin of the id path: same tiers, all-vectorized."""
        n = len(newly)
        for blk in self._row_blocks:
            if blk.base >= n:
                continue
            sub = newly[blk.base : min(blk.end(), n)]
            if sub.any():
                blk.table._mark_stale_from_wave_mask(sub)
                if blk.table.on_wave_invalidate:
                    local = np.nonzero(sub)[0].astype(np.int32)
                    for h in blk.table.on_wave_invalidate:
                        h(local)
        self._pending[:n] |= newly
        watched = np.nonzero(newly & self._watched[:n])[0]
        for hook in self.newly_hooks:
            hook(newly)
        self._eager_invalidate(watched)

    def _eager_invalidate(self, watched_ids) -> None:
        for node_id in watched_ids:
            node_id = int(node_id)
            self._pending[node_id] = False
            self._watched[node_id] = False
            c = self.computed_for(node_id)
            if c is None:
                continue
            # cause propagation for the handlers this fires
            c._invalidation_cause = self.last_cause_id
            self._applying_ids.add(node_id)
            try:
                c.invalidate_local()
            finally:
                self._applying_ids.discard(node_id)

    # ------------------------------------------------------------------ columnar ingest
    def bind_table_rows(self, table, n_rows: Optional[int] = None) -> RowBlock:
        """Register a MemoTable's dense key space as ONE contiguous block of
        graph nodes (row ``r`` ⇔ node ``base+r``) — the vectorized live
        ingest path. Bind at service setup, BEFORE scalar reads of the
        method create standalone nodes (a scalar node created pre-bind keeps
        its own node id and will not cascade as the row).

        After binding:
        - ``declare_row_edges`` declares dependency topology in bulk numpy;
        - host-led ``table.invalidate(ids)`` mirrors to the device graph as
          bulk invalid marks that cascade at the next flush;
          ``table.refresh`` (or a ``read_batch`` that refreshes) clears the
          rows' invalid bits — consistent again with NO epoch bump, so
          declared topology survives value churn;
        - device waves mark hit rows stale vectorized;
        - scalar ``@compute_method`` nodes for the same keys ADOPT the row's
          node id on registration (see ``_on_register``)."""
        n = int(n_rows if n_rows is not None else table.n_rows)
        if n > table.n_rows:
            raise ValueError(f"n_rows {n} exceeds table rows {table.n_rows}")
        if table.device.type != self.graph.device.type:
            raise ValueError(f"the table lives on {table.device}, the graph on "
                             f"{self.graph.device}")
        with self._lock:
            existing = self._block_by_table.get(id(table))
            if existing is not None:
                if existing.n_rows != n:
                    raise ValueError(f"table already bound with {existing.n_rows} rows")
                return existing
            base = self.graph.n_nodes
            self.graph.add_nodes(n)
            self._ensure_host_masks()
            blk = RowBlock(table, base, n)
            self._row_blocks.append(blk)
            self._row_blocks.sort(key=lambda b: b.base)
            self._block_bases = np.array([b.base for b in self._row_blocks], dtype=np.int64)
            self._block_ends = np.array([b.end() for b in self._row_blocks], dtype=np.int64)
            self._block_by_table[id(table)] = blk

        def on_inv(ids_np, _blk=blk):
            ids64 = np.asarray(ids_np, np.int64)
            if n < table.n_rows:  # partial bind: rows past the block are unmapped
                ids64 = ids64[ids64 < _blk.n_rows]
            if ids64.size == 0:
                return
            with self._lock:
                # icasc, not a bare mark: a host-led table invalidation must
                # CASCADE through the declared row topology (which exists only
                # on the device); flush runs the expansion wave in journal
                # order, so a refresh that follows still clears its own rows
                self._journal.append(("icasc", (_blk.base + ids64).astype(np.int32)))

        def on_ref(ids_np, _blk=blk):
            ids64 = np.asarray(ids_np, np.int64)
            if n < table.n_rows:
                ids64 = ids64[ids64 < _blk.n_rows]
            if ids64.size == 0:
                return
            with self._lock:
                self._journal.append(("cpack", (_blk.base + ids64).astype(np.int32)))

        on_ref._backend_hook = True  # refresh_block_on_device subsumes it
        table.on_invalidate.append(on_inv)
        table.on_refresh.append(on_ref)
        return blk

    def declare_row_edges(self, src_block: RowBlock, src_rows, dst_block: RowBlock,
                          dst_rows) -> int:
        """Declare dependency edges used(src row) → dependent(dst row) in
        bulk — the columnar analogue of per-``await`` edge capture. One
        journal entry per call regardless of edge count; flush appends them
        to the device CSR in one numpy splice. Declared edges persist across
        value churn and are re-declared automatically when a row's scalar
        twin recomputes. Declarations ACCUMULATE — to change a row's
        dependency set, call :meth:`clear_declared_row_edges` first."""
        src_rows = self._check_rows(src_block, src_rows).astype(np.int64)
        dst_rows = self._check_rows(dst_block, dst_rows).astype(np.int64)
        if src_rows.shape != dst_rows.shape:
            raise ValueError("src_rows and dst_rows must have the same shape")
        if src_rows.size == 0:
            return 0
        src_nids = (src_block.base + src_rows).astype(np.int32)
        dst_nids = (dst_block.base + dst_rows).astype(np.int32)
        with self._lock:
            self._journal.append(("epack", (src_nids, dst_nids)))
            dst_block._decl_src.append(src_nids)
            dst_block._decl_dst.append(dst_nids)
        return int(src_nids.size)

    @staticmethod
    def _check_rows(block: RowBlock, rows) -> np.ndarray:
        """Rows → int32 array, validated against the block: a silent
        out-of-range row would seed a cascade at a FOREIGN node id."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size and (int(rows.min()) < 0 or int(rows.max()) >= block.n_rows):
            raise ValueError(f"rows out of range [0, {block.n_rows})")
        return rows.astype(np.int32)

    def clear_declared_row_edges(self, block: RowBlock, rows) -> None:
        """The 'redeclare' half of the declared-edge lifetime: drop declared
        edges INTO these rows from the declaration log AND kill their live
        in-edges (an epoch bump — the recompute rule: dependencies changed).
        Follow with :meth:`declare_row_edges` for the new topology."""
        rows = self._check_rows(block, rows)
        nids = (block.base + rows.astype(np.int64)).astype(np.int32)
        with self._lock:
            new_src, new_dst = [], []
            for s_arr, d_arr in zip(block._decl_src, block._decl_dst):
                keep = ~np.isin(d_arr, nids)
                if keep.all():
                    new_src.append(s_arr)
                    new_dst.append(d_arr)
                elif keep.any():
                    new_src.append(s_arr[keep])
                    new_dst.append(d_arr[keep])
            block._decl_src, block._decl_dst = new_src, new_dst
            block._csr = None
            for nid in set(int(x) for x in nids):
                self._journal.append(("bump", nid))

    def cascade_rows_batch(self, block: RowBlock, rows) -> int:
        """Invalidate + cascade table rows in ONE union wave (the
        command-completion shape for table-backed services). The wave
        application marks hit rows stale in bulk and runs the two-tier host
        apply for scalar twins. Returns the total newly invalidated."""
        self.flush()
        nids = block.base + self._check_rows(block, rows)
        cause, wave_seq = self._begin_wave()
        t0 = time.perf_counter()
        total, newly_ids = self._wave_union([nids.tolist()])
        t1 = time.perf_counter()
        self._apply_newly(newly_ids)
        self.waves_run += 1
        self.device_invalidations += total
        self._profile_wave("union", len(nids), cause, t0, t1, len(newly_ids), wave_seq)
        return total

    @staticmethod
    def _device_loader_of(table, block: RowBlock, what: str):
        if table.device_compute_fn is None:
            raise TypeError(
                "table has no device loader — declare TableBacking(device_batch=...) "
                f"or use {'table.refresh()' if what == 'refresh' else 'read_batch()'}"
            )
        if block.n_rows != table.n_rows:
            raise ValueError(
                f"{what} on the device requires a FULL table bind (block covers "
                f"{block.n_rows} of {table.n_rows} rows)"
            )

    def refresh_block_on_device(self, block: RowBlock) -> int:
        """Recompute ALL stale rows of a bound table ON THE DEVICE, from the
        device-resident invalid state, through the table's DEVICE loader
        (``TableBacking(device_batch=...)``): the loader computes every row,
        and the ``block_refresh`` kernel takes the rows whose node is
        invalid, marks them valid and clears the block's invalid bits — zero
        host value traffic. Host bookkeeping (stale counts, versions) comes
        from the host invalid mirror, which is cleared in the same call.
        Returns rows refreshed.

        Semantics = ``table.refresh(stale_rows)`` for every row the graph
        holds invalid in this block: values recomputed, rows valid again
        with NO epoch bump (declared topology survives), scalar twins stay
        pending-invalid until their next read. Rows stale on the TABLE but
        not invalid in the graph refresh on next read."""
        self.flush()
        table = block.table
        self._device_loader_of(table, block, "refresh")
        dg = self.graph
        g = dg.device_arrays()
        update_valid = not table._valid_dev_dirty
        fresh = _loader_rows(table, block.n_rows)
        # valid_mask (not the raw tensor) applies any deferred small updates
        # first; with a full materialization pending, validity is left alone
        valid = table.valid_mask if update_valid else None
        # the words are the graph's own (every mirror route reads
        # device_arrays().invalid at its call): cleared in place
        block_refresh(g.invalid, table._values, fresh, valid, block.base)
        del fresh
        cleared = dg._h_invalid[block.base : block.end()].copy()
        n_cleared = int(np.count_nonzero(cleared))
        if n_cleared == 0:
            return 0
        dg._h_invalid[block.base : block.end()] = False
        dg.invalid_version += 1
        # non-backend on_refresh subscribers get the refreshed ids; the
        # backend's own hook is skipped — the kernel already cleared the bits
        _finish_block_refresh_bookkeeping(table, cleared)
        return n_cleared

    def warm_block_on_device(self, block: RowBlock) -> int:
        """Load EVERY row of a bound table through its DEVICE loader in one
        call — the cold-start warm. Graph invalid state is untouched (a
        fresh table has nothing invalid to clear). Returns the rows that
        were stale."""
        table = block.table
        self._device_loader_of(table, block, "warm")
        if self.graph._h_invalid[block.base : block.end()].any():
            # warming would zero table staleness while the graph's invalid
            # bits stayed set, silently pre-blocking those rows in bursts
            raise RuntimeError(
                "block has outstanding invalid marks — use "
                "refresh_block_on_device() (warm is for cold tables)"
            )
        # copied into the table's own tensor: the loader may hand back its
        # own state, which later in-place refreshes must never write
        table._values.copy_(_loader_rows(table, block.n_rows))
        table._valid_dev = torch.ones(block.n_rows, dtype=torch.bool, device=table.device)
        table._valid_dev_dirty = False
        table._valid_pending.clear()
        table._valid_pending_n = 0
        n_stale = table._stale_count
        table._stale_host[:] = False
        table._stale_count = 0
        table._bump()
        extern = [h for h in table.on_refresh if not getattr(h, "_backend_hook", False)]
        if extern:
            all_ids = np.arange(block.n_rows, dtype=np.int32)
            for h in extern:
                h(all_ids)
        return n_stale

    def cascade_rows_batch_seq(self, block: RowBlock, row_batches) -> np.ndarray:
        """M :meth:`cascade_rows_batch` calls as one sequenced chain, each
        batch cascading against the state the previous batches left
        (identical final state and counts): one lat-mirror chain when the
        lat mirror serves them, a host loop otherwise. Returns per-batch
        newly counts int64[M]."""
        self.flush()
        seed_lists = [
            (block.base + self._check_rows(block, rows)).tolist() for rows in row_batches
        ]
        cause, seqs = self._begin_wave_span(len(seed_lists))
        lat_before = self.graph.lat_waves
        t0 = time.perf_counter()
        counts, union_ids = self._wave_union_seq(seed_lists)
        t1 = time.perf_counter()
        self._apply_newly(union_ids)
        self.waves_run += len(seed_lists)
        self.device_invalidations += int(counts.sum())
        fused = self.graph.lat_waves > lat_before  # lat chain vs host loop
        self._profile_wave(
            "seq", sum(len(s) for s in seed_lists), cause, t0, t1, int(counts.sum()), seqs[0],
            groups=len(seed_lists), fused_depth=len(seed_lists), seq_span=(seqs[0], seqs[-1]),
            dispatches=1 if fused else len(seed_lists),
        )
        return counts

    def cascade_rows_lanes(self, block: RowBlock, row_groups) -> np.ndarray:
        """Lane-packed columnar burst: each row group cascades independently
        in its own bit lane (32 groups per packed word, one topo-mirror
        sweep per ``_LANES_CHUNK`` groups) seeded DIRECTLY by table rows.
        Returns per-group newly counts."""
        self.flush()
        seed_lists = [(block.base + self._check_rows(block, g)).tolist() for g in row_groups]
        n_stages = max(-(-len(seed_lists) // self._LANES_CHUNK), 1)
        cause, seqs = self._begin_wave_span(n_stages)
        self.graph.last_lanes_info = None
        t0 = time.perf_counter()
        counts, union = self._wave_lanes(seed_lists)
        t1 = time.perf_counter()
        self._apply_newly(union)
        self.waves_run += len(seed_lists)
        self.device_invalidations += int(counts.sum())
        info = self.graph.last_lanes_info or {}
        self._profile_wave(
            "lanes", sum(len(s) for s in seed_lists), cause, t0, t1, int(counts.sum()), seqs[0],
            groups=len(seed_lists), fused_depth=info.get("depth"),
            seq_span=(seqs[0], seqs[-1]), dispatches=info.get("dispatches"),
        )
        return counts

    def build_topo_mirror(self, k: int = 4, cap: int = 65536) -> dict:
        """Build/refresh the topo and lat mirrors of the live graph:
        ``invalidate_cascade_batch`` bursts then ride them (a lone wave on
        the lat mirror, a larger burst as one depth-free sweep) instead of a
        level-by-level BFS. Structural changes patch into the mirror at its
        next use; an unpatchable one routes bursts back to the dense path
        until this runs again."""
        self.flush()
        return self.graph.build_topo_mirror(k=k, cap=cap)

    #: groups per lane chunk at the default word width (32 * max_words=16)
    _LANES_CHUNK = 512

    def invalidate_cascade_batch_lanes(self, groups: Sequence[Sequence["Computed"]]) -> np.ndarray:
        """Lane-packed live burst: each group (the computeds one command's
        completion invalidates) cascades INDEPENDENTLY in its own bit lane,
        32 groups per packed word, in one topo-mirror sweep per
        ``_LANES_CHUNK`` groups. Per-group semantics = a dense BFS from the
        pre-burst invalid state; the UNION of the closures is applied to the
        hub once, two-tier like every other wave path. Returns per-group
        newly-invalidated counts (int64[len(groups)]; a computed not in the
        graph falls back to an immediate host invalidation and counts 1 in
        its group)."""
        self.flush()
        seed_lists: List[List[int]] = []
        fallback = np.zeros(len(groups), dtype=np.int64)
        for gi, group in enumerate(groups):
            ids: List[int] = []
            for c in group:
                nid = self._id_by_input.get(c.input)
                if nid is None:
                    c.invalidate(immediately=True)
                    fallback[gi] += 1
                else:
                    ids.append(nid)
            seed_lists.append(ids)
        n_stages = max(-(-len(seed_lists) // self._LANES_CHUNK), 1)
        cause, seqs = self._begin_wave_span(n_stages)
        self.graph.last_lanes_info = None
        t0 = time.perf_counter()
        counts, union = self._wave_lanes(seed_lists)
        t1 = time.perf_counter()
        self._apply_newly(union)
        self.waves_run += len(groups)
        self.device_invalidations += int(counts.sum())
        info = self.graph.last_lanes_info or {}
        self._profile_wave(
            "lanes", sum(len(s) for s in seed_lists), cause, t0, t1, int(counts.sum()), seqs[0],
            groups=len(groups), fused_depth=info.get("depth"), seq_span=(seqs[0], seqs[-1]),
            dispatches=info.get("dispatches"),
        )
        return counts + fallback

    def cascade_rows_lanes_refresh_chain(self, block: RowBlock, bursts, nonblocking: bool = False):
        """K consecutive rounds of (lane burst → block refresh) as one
        chain: burst ``i`` cascades, the block's stale rows recompute
        through the table's DEVICE loader (``block_refresh``), and burst
        ``i+1`` cascades against a consistent block, with no host round trip
        between rounds (on the card: ``ceil(stages/8)`` CUDA graph replays).

        ``bursts`` is a list of row-group lists; each burst's semantics are
        exactly :meth:`cascade_rows_lanes` followed by
        :meth:`refresh_block_on_device`, and each stage keeps its own wave
        seq. Returns one int64 newly-count array per burst, or, with
        ``nonblocking=True``, a ticket whose ``harvest()`` returns them
        later. Until harvest, journal appends are safe but ``flush()`` and
        reads of the host invalid mirror are not. Requires a full-table bind
        with a device loader and a fusible mirror (``NotFusible`` or TypeError
        otherwise: callers fall back to the sequential pair)."""
        self.flush()
        stages: List[List[List[int]]] = []
        stage_burst: List[int] = []
        for bi, groups in enumerate(bursts):
            seed_lists = [(block.base + self._check_rows(block, g)).tolist() for g in groups]
            for c0 in range(0, max(len(seed_lists), 1), self._LANES_CHUNK):
                stages.append(seed_lists[c0 : c0 + self._LANES_CHUNK])
                stage_burst.append(bi)
        refresh = self._block_refresh_state(block)
        dg = self.graph
        pre_block_invalid = dg._h_invalid[block.base : block.end()].copy()
        cause, seqs = self._begin_wave_span(len(stages))
        t0 = time.perf_counter()
        pending = dg.dispatch_waves_lanes_chain(stages, refresh=refresh)
        ticket = _RefreshChainTicket(self, block, len(bursts), stage_burst, stages, refresh,
                                     pending, cause, seqs, pre_block_invalid, t0,
                                     refresh["update_valid"])
        if nonblocking:
            return ticket
        return ticket.harvest()

    def _block_refresh_state(self, block: RowBlock) -> dict:
        """The refresh state the chain and super-round programs run the
        block's refresh with (memo values, validity, loader and its
        arguments): ONE construction shared by
        :meth:`cascade_rows_lanes_refresh_chain` and ``graph/superround.py``.
        Raises for tables without a device loader or partial binds."""
        table = block.table
        self._device_loader_of(table, block, "refresh")
        update_valid = not table._valid_dev_dirty
        largs = tuple(table.device_loader_args()) if table.device_loader_args is not None else ()
        return {
            "base": block.base,
            "n_rows": block.n_rows,
            "fn": table.device_compute_fn,
            "largs": largs,
            "values": table._values,
            # valid_mask (not the raw tensor) applies deferred small updates
            "valid_dev": table.valid_mask if update_valid else table._valid_dev,
            "update_valid": update_valid,
            "cache": block._dev_refresh,
        }

    def enable_super_rounds(self, block: RowBlock, depth: int = 4, max_words: int = 16):
        """Install the resident super-round program: K live rounds of (lane
        burst → block refresh through the memo table's loader → the round's
        packed newly mask) as ONE program (on the card one CUDA graph
        replay), with the next super-round's seeds staged and the previous
        one's masks drained around it. Returns the
        :class:`~.superround.SuperRoundProgram`; ``backend.super_rounds``
        holds it and ``WavePipeline.drain()`` covers its in-flight work."""
        from .superround import SuperRoundProgram

        if self.super_rounds is not None and not self.super_rounds._disposed:
            raise ValueError("backend already has a SuperRoundProgram attached")
        self.super_rounds = SuperRoundProgram(self, block, depth=depth, max_words=max_words)
        return self.super_rounds

    def _drain_nonblocking(self) -> None:
        """Harvest every in-flight nonblocking plane (the pipeline's chains
        and the super-rounds), so a blocking path acts on a quiesced state."""
        if self.pipeline is not None:
            self.pipeline.drain()  # also drains super_rounds
        elif self.super_rounds is not None and not self.super_rounds._disposed:
            self.super_rounds.drain()

    # ------------------------------------------------------------------ routed mesh
    def enable_mesh_routing(
        self,
        shard_map,
        mesh=None,
        mesh_members=None,
        exchange: str = "a2a",
        devices_per_host: Optional[int] = None,
        exchange_async: bool = False,
        async_depth: int = 4,
    ) -> None:
        """Pin the live graph's CSR shards onto mesh devices per the
        CLUSTER shard map: each member's shard-map assignment also places
        its slice of the mirror on its mesh devices, and cross-shard
        invalidation frontiers thereafter resolve on the device inside the
        wave (``_union_routed_nids``, the WavePipeline's routed chain)
        instead of surfacing to the host and re-entering through per-key
        RPC. ``mesh_members`` names the members co-located on THIS mesh
        (default: all map members — the single-host cluster); shards owned
        by off-mesh members stay on the DCN relay path (rpc/fanout.py
        counts it). ``devices_per_host`` declares the placement's host
        axis: with ``exchange="hier"`` each BFS level then resolves as an
        intra-host exchange plus an inter-host exchange of the reduced
        per-host frontier words, inside the same chain the super-rounds
        ride. ``exchange_async=True`` runs the routed waves in
        asynchronous mode: each shard expands its LOCAL frontier
        speculatively for up to ``async_depth`` levels between global
        merge epochs, and the level fence becomes a counted quiescence
        vote — the invalid mask stays bit-identical to sync by the
        idempotent-OR argument. The mirror itself builds lazily on the
        first routed wave."""
        self._routed_config = {
            "shard_map": shard_map,
            "mesh": mesh,
            "mesh_members": tuple(mesh_members) if mesh_members is not None else None,
            "exchange": exchange,
            "devices_per_host": devices_per_host,
            "exchange_async": exchange_async,
            "async_depth": async_depth,
        }
        self._routed_mirror = None  # rebuild under the new config

    def mesh_routing_active(self) -> bool:
        return self._routed_config is not None

    def routed_mirror(self) -> dict:
        """Fingerprint-cached routed mesh mirror of the live graph.
        Structural churn since the last wave PATCHES the resident shards in
        place from the graph's ordered delta stream — the whole batch
        coalesced into ONE patch (the per-patch dispatch overhead, not the
        per-edge cost, dominated the patch time). Anything the in-place
        path can't absorb (new nodes, slot/bucket overflow) rebuilds,
        counted."""
        from ..cluster.placement import DevicePlacement
        from ..parallel.routed_wave import RoutedShardedGraph

        cfg = self._routed_config
        if cfg is None:
            raise RuntimeError("mesh routing not enabled (enable_mesh_routing)")
        self.flush()
        dg = self.graph
        sv = dg._struct_version
        cached = self._routed_mirror
        if cached is not None:
            if cached["validated_at"] == sv:
                return cached
            aux = cached["aux_log"]
            if not aux["broken"] and self._try_patch_routed(cached, aux):
                cached["validated_at"] = sv
                return cached
            if cached["fp"] is not None and check_structure_cache(
                cached, sv, lambda: self._routed_fingerprint()
            ):
                return cached
        if cached is not None:
            dg.drop_aux_delta_log(cached["aux_log"])
            global_metrics().counter(
                "fusion_mesh_rebuilds_total",
                help="routed mesh mirrors rebuilt (patch path could not absorb the churn)",
            ).inc()
        mesh = cfg["mesh"] if cfg["mesh"] is not None else graph_mesh(device=dg.device)
        n_dev = mesh.size
        smap = cfg["shard_map"]
        members = cfg["mesh_members"] or smap.members
        placement = DevicePlacement.build(
            smap, n_dev, dg.n_nodes, mesh_members=members,
            devices_per_host=cfg.get("devices_per_host"),
        )
        m = dg.n_edges
        graph = RoutedShardedGraph(
            dg._h_edge_src[:m].copy(),
            dg._h_edge_dst[:m].copy(),
            dg.n_nodes,
            placement,
            mesh=mesh,
            exchange=cfg["exchange"],
            edge_dst_epoch=dg._h_edge_dst_epoch[:m].copy(),
            node_epoch=dg._h_node_epoch[: dg.n_nodes],
            exchange_async=cfg.get("exchange_async", False),
            async_depth=cfg.get("async_depth", 4),
        )
        self._routed_mirror = {
            "fp": self._routed_fingerprint(),
            "validated_at": sv,
            "graph": graph,
            "aux_log": dg.register_aux_delta_log(),
            # absent invalid_version ⇒ next wave full-syncs from dense
        }
        return self._routed_mirror

    def _routed_fingerprint(self) -> bytes:
        dg = self.graph
        m = dg.n_edges
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64(dg.n_nodes).tobytes())
        h.update(dg._h_edge_src[:m].tobytes())
        h.update(dg._h_edge_dst[:m].tobytes())
        h.update(dg._h_edge_dst_epoch[:m].tobytes())
        h.update(dg._h_node_epoch[: dg.n_nodes].tobytes())
        return h.digest()

    def _try_patch_routed(self, entry: dict, aux: dict) -> bool:
        """Coalesce the WHOLE recorded delta stream into one batched patch
        (bumps are epoch increments and adds carry absolute captured
        epochs, so the final device state is order-independent — the
        property that makes same-burst batching safe) and apply it in ONE
        fused dispatch. False ⇒ rebuild."""
        graph = entry["graph"]
        coalesced = self._coalesce_mirror_deltas(aux["deltas"], graph.n_nodes)
        if coalesced is None:
            aux["broken"] = True  # nodes born after the build
            return False
        bumps, u, v, ep = coalesced
        if not len(bumps) and not len(u):
            aux["deltas"] = []
            return True
        entry["fp"] = None  # in-place mutation: the build fp never revalidates
        # the routed mirror keeps ABSOLUTE epochs — no rebase translation
        if not graph.patch_batch(bumps, u, v, ep.astype(np.int32)):
            aux["broken"] = True
            return False
        aux["deltas"] = []
        global_metrics().counter(
            "fusion_mesh_patch_batches_total",
            help="structural churn batches applied to the routed mesh mirror in one fused dispatch",
        ).inc()
        return True

    def apply_mesh_reshard(self, new_map, mesh_members=None) -> int:
        """MOVE the resident device shards the new epoch reassigns (the
        rebalancer's device half): state blocks transfer on-device, edge
        slices + exchange buckets re-pack for the touched devices only.
        Returns the number of shard moves (0 when no mirror is live yet —
        the next build derives placement from the new map directly).
        A move the placement can't absorb drops the mirror (rebuild on
        next use) — counted, never silent."""
        from ..cluster.placement import PlacementError

        cfg = self._routed_config
        if cfg is None:
            return 0
        cfg["shard_map"] = new_map
        if mesh_members is not None:
            cfg["mesh_members"] = tuple(mesh_members)
        entry = self._routed_mirror
        if entry is None:
            return 0
        if entry.get("inflight", 0):
            # a fused chain mid-flight references the CURRENT row layout;
            # moving shards under it would make its harvest map rows
            # through the new permutation (dropped invalidations). Drain
            # first — the reshard then applies to a quiesced mirror.
            self._drain_nonblocking()
            entry = self._routed_mirror
            if entry is None:
                return 0
        graph = entry["graph"]
        members = cfg["mesh_members"] or new_map.members
        try:
            placement, moves = graph.placement.moved_to(new_map, mesh_members=members)
            graph.apply_placement(placement, moves)
        except PlacementError as e:
            log.warning("mesh reshard forced a rebuild: %s", e)
            self.graph.drop_aux_delta_log(entry["aux_log"])
            self._routed_mirror = None
            global_metrics().counter("fusion_mesh_rebuilds_total").inc()
            return 0
        global_metrics().counter(
            "fusion_mesh_shard_moves_total",
            help="device shards moved between mesh devices by reshards",
        ).inc(len(moves))
        global_metrics().counter("fusion_mesh_reshards_total").inc()
        if RECORDER.enabled:
            RECORDER.note(
                "mesh_reshard",
                key=None,
                cause=f"reshard:{new_map.epoch}",
                count=len(moves),
                detail=(
                    f"epoch {new_map.epoch}: moved {len(moves)} device "
                    f"shard(s) on-mesh (placement epoch {placement.epoch})"
                ),
            )
        return len(moves)

    def invalidate_cascade_batch_routed(self, computeds: Sequence["Computed"]) -> int:
        """The live routed burst: one union wave whose cross-shard frontier
        resolves via mesh collectives (a2a buckets / reduction tree —
        parallel/routed_wave.py), applied back to the hub exactly like the
        single-chip path. Missing computeds fall back to immediate host
        invalidation, counted."""
        seeds: List[int] = []
        fallback = 0
        for c in computeds:
            nid = self._id_by_input.get(c.input)
            if nid is None:
                c.invalidate(immediately=True)
                fallback += 1
            else:
                seeds.append(nid)
        if not seeds:
            return fallback
        return self._union_routed_nids(seeds) + fallback

    def cascade_rows_batch_routed(self, block: RowBlock, rows) -> int:
        nids = block.base + self._check_rows(block, rows)
        return self._union_routed_nids(nids.tolist())

    def _routed_sync(self, entry: dict) -> None:
        dg = self.graph
        if entry.get("invalid_version") != dg.invalid_version:
            mask = dg.invalid_mask()
            dg._h_invalid[: dg.n_nodes] = mask
            entry["graph"].set_invalid(mask)
        # out-of-sync until the dense apply completes (same failure
        # containment as the sharded union bridge)
        entry.pop("invalid_version", None)

    def _union_routed_nids(self, seeds: List[int]) -> int:
        entry = self.routed_mirror()
        if entry.get("inflight", 0):
            # a fused chain is mid-flight: its device advance must land
            # before a blocking union syncs from the dense mirror (drain
            # is the nonblocking-mode barrier — same rule as flush)
            self._drain_nonblocking()
            entry = self.routed_mirror()
        graph = entry["graph"]
        dg = self.graph
        self._routed_sync(entry)
        cause, wave_seq = self._begin_wave()
        t0 = time.perf_counter()
        levels0 = graph.levels_total
        count, newly_ids, overflow = graph.run_wave_collect(seeds)
        if overflow:
            newly = graph.invalid_mask() & ~dg._h_invalid[: graph.n_nodes]
            newly_ids = np.nonzero(newly)[0].astype(np.int32)
        dg.mark_invalid(newly_ids)
        entry["invalid_version"] = dg.invalid_version
        t1 = time.perf_counter()
        levels = graph.levels_total - levels0
        self._apply_newly(newly_ids)
        self.waves_run += 1
        self.device_invalidations += count
        global_metrics().counter(
            "fusion_mesh_routed_waves_total",
            help="union waves whose cross-shard frontier resolved via mesh collectives",
        ).inc()
        global_metrics().counter(
            "fusion_mesh_exchange_levels_total",
            help="collective frontier-exchange rounds run on the mesh",
        ).inc(levels)
        self._profile_wave(
            "routed_union", len(seeds), cause, t0, t1, len(newly_ids), wave_seq,
            mesh={
                "exchange": graph.exchange,
                "levels": int(levels),
                "epoch": graph.placement.epoch,
                "n_dev": graph.n_dev,
            },
        )
        return count

    def dispatch_waves_routed_chain(
        self, stage_seed_lists: Sequence[Sequence[int]], staged: Optional[dict] = None
    ) -> dict:
        """K logical waves in ONE routed chain dispatch with NO readback
        — the frontier exchange composed into the nonblocking loop-carried
        chain (graph/nonblocking.py rides this when mesh routing is on).
        Raises :class:`~.program_cache.NotFusible` for contract violations
        the pipeline treats as the eager fallback (empty seed sets).

        With a chain already IN FLIGHT the device state is AHEAD of the
        dense mirror by exactly that chain's work — the dense full-sync
        must be SKIPPED (it would overwrite the in-flight advance with
        pre-chain state and double-count its cascade at harvest); the
        loop-carried device state is the consistent one. Host-led invalid
        changes between overlapped dispatches are covered by the
        pipeline's journal guard + ``drain()`` barrier, same contract as
        the single-chip lanes chain."""
        if any(len(s) == 0 for s in stage_seed_lists):
            raise NotFusible("routed chain stages need non-empty seed sets")
        entry = self.routed_mirror()
        graph = entry["graph"]
        if entry.get("inflight", 0) == 0:
            self._routed_sync(entry)
        levels0 = graph.levels_total
        # a pre-packed seed buffer (SuperRoundProgram's back buffer) skips
        # the host pack; dispatch_union_chain rejects a stale token
        pending = graph.dispatch_union_chain(stage_seed_lists, staged=staged)
        entry["inflight"] = entry.get("inflight", 0) + 1  # after dispatch succeeds
        pending["entry"] = entry
        pending["levels0"] = levels0
        return pending

    def harvest_waves_routed_chain(self, pending: dict):
        """Block on a routed chain ticket: (per-stage counts, per-stage
        newly id arrays). An overflowed stage's ids are recovered from one
        mask diff against the pre-chain dense mirror and attributed to the
        FIRST overflowed stage — containment preserves the SET (the counts
        stay device-exact); invalidation is idempotent."""
        entry = pending["entry"]
        graph = entry["graph"]
        dg = self.graph
        try:
            counts, stage_ids, info = graph.harvest_union_chain(pending)
        except Exception:
            # a failed harvest leaves the device state unknowable: clear
            # the in-flight accounting and stay out-of-sync so the next
            # wave full-syncs from the dense truth (the pipeline's fault
            # containment re-runs the waves on the split host loop)
            entry["inflight"] = 0
            entry.pop("invalid_version", None)
            raise
        if info["overflowed"]:
            newly = graph.invalid_mask() & ~dg._h_invalid[: graph.n_nodes]
            all_ids = np.nonzero(newly)[0].astype(np.int64)
            attributed = [i for i in stage_ids if i is not None]
            seen = (
                np.concatenate(attributed) if attributed else np.empty(0, np.int64)
            )
            leftover = np.setdiff1d(all_ids, seen)
            first = True
            for i, ids in enumerate(stage_ids):
                if ids is None:
                    stage_ids[i] = leftover if first else np.empty(0, np.int64)
                    first = False
        union = (
            np.concatenate(stage_ids) if stage_ids else np.empty(0, np.int64)
        )
        dg.mark_invalid(union)
        entry["inflight"] = max(entry.get("inflight", 1) - 1, 0)
        if entry["inflight"] == 0:
            # only a FULLY-drained mirror reads in-sync: with another chain
            # still executing, the device state is ahead of the dense
            # mirror until that chain harvests too
            entry["invalid_version"] = dg.invalid_version
        levels = graph.levels_total - pending["levels0"]
        global_metrics().counter("fusion_mesh_routed_waves_total").inc(len(stage_ids))
        global_metrics().counter("fusion_mesh_exchange_levels_total").inc(levels)
        return counts, stage_ids

    # ------------------------------------------------------------------ mesh bridge
    def to_sharded(self, mesh=None, exchange: str = "packed"):
        """Snapshot the LIVE mirrored graph as a mesh-sharded wave graph
        (node epochs, invalid marks, version-carrying edges) — the bridge
        from the incremental dense mirror to the mesh path
        (``parallel/sharded_wave.py``). ``mesh`` defaults to one shard on
        the backend's device. Waves run on it are applied back through the
        caller (ids are the backend's node ids)."""
        self.flush()
        dg = self.graph
        m = dg.n_edges
        return ShardedDeviceGraph(
            dg._h_edge_src[:m].copy(),
            dg._h_edge_dst[:m].copy(),
            dg.n_nodes,
            mesh=mesh if mesh is not None else graph_mesh(device=dg.device),
            edge_dst_epoch=dg._h_edge_dst_epoch[:m].copy(),
            exchange=exchange,
            node_epoch=dg._h_node_epoch,
            # device-authoritative: run_wave_frontier(sync_host=False) leaves
            # the host _h_invalid stale; invalid_mask() reads the device copy
            invalid=dg.invalid_mask(),
        )

    def sharded_mirror(self, mesh=None, exchange: str = "packed"):
        """Fingerprint-cached :meth:`to_sharded` — the LIVE bridge to the
        mesh path. Cached by the full structural state (edges, edge epochs,
        node epochs, n_nodes) with the struct-version shortcut, so calls on
        a stable topology are O(1); any bump or append rebuilds on next
        use. Between mesh bursts the dense state stays authoritative —
        :meth:`invalidate_cascade_batch_sharded` syncs the invalid state."""
        self.flush()
        dg = self.graph
        sv = dg._struct_version

        def fingerprint() -> bytes:
            m = dg.n_edges
            h = hashlib.blake2b(digest_size=16)
            h.update(np.int64(dg.n_nodes).tobytes())
            h.update(dg._h_edge_src[:m].tobytes())
            h.update(dg._h_edge_dst[:m].tobytes())
            h.update(dg._h_edge_dst_epoch[:m].tobytes())
            h.update(dg._h_node_epoch[: dg.n_nodes].tobytes())
            return h.digest()

        cached = self._sharded_mirror
        # the mesh is compared by IDENTITY through a weakref: a bare id(mesh)
        # would alias a new mesh that reuses a collected one's id, and a
        # strong reference would pin a discarded mesh and its graph
        if cached is not None:
            cached_ref = cached["mesh"]
            same_mesh = (
                cached_ref is None if mesh is None
                else cached_ref is not None and cached_ref() is mesh
            )
            if (
                same_mesh
                and cached["exchange"] == exchange
                and check_structure_cache(cached, sv, fingerprint)
            ):
                return cached["graph"]
        sharded = self.to_sharded(mesh=mesh, exchange=exchange)
        self._sharded_mirror = {
            "fp": fingerprint(),
            "mesh": weakref.ref(mesh) if mesh is not None else None,
            "exchange": exchange,
            "validated_at": sv,
            "graph": sharded,
        }
        return sharded

    def invalidate_cascade_batch_sharded(self, computeds: Sequence["Computed"], mesh=None) -> int:
        """The live mesh burst: expand ALL seeds in one union wave on the
        mesh, then apply the newly-invalidated set back to the live hub
        like the dense path (dense mirror + two-tier host apply).

        Per-burst host traffic is O(wave): the mesh's invalid state stays
        RESIDENT between bursts — seed ids go up, compacted newly ids come
        back, and the dense mirror catches up via ``mark_invalid``. The
        dense ``invalid_version`` says whether a host-led change touched the
        invalid state since the last burst; only then does the bridge pay a
        full O(n) re-sync."""
        seeds: List[int] = []
        fallback = 0
        for c in computeds:
            nid = self._id_by_input.get(c.input)
            if nid is None:
                c.invalidate(immediately=True)
                fallback += 1
            else:
                seeds.append(nid)
        if not seeds:
            return fallback
        return self._union_sharded_nids(seeds, mesh) + fallback

    def cascade_rows_batch_sharded(self, block: RowBlock, rows, mesh=None) -> int:
        """:meth:`cascade_rows_batch` ON THE MESH: table rows seed a union
        wave expanded over the mesh, applied back to the live hub and
        tables like the single-device path."""
        nids = block.base + self._check_rows(block, rows)
        return self._union_sharded_nids(nids.tolist(), mesh)

    def _union_sharded_nids(self, seeds: List[int], mesh=None) -> int:
        sharded = self.sharded_mirror(mesh=mesh)
        entry = self._sharded_mirror
        dg = self.graph
        if entry.get("invalid_version") != dg.invalid_version:
            # host-led change since the last burst (or the first burst on
            # this mirror): the dense state is authoritative — full sync,
            # once. The host mirror catches up from the same device read, so
            # the overflow mask diff below never compares against a stale
            # _h_invalid
            mask = dg.invalid_mask()
            dg._h_invalid[: dg.n_nodes] = mask
            sharded.set_invalid(mask)
        # the mesh state is about to advance; until the dense apply below
        # COMPLETES the entry must read as out of sync, or a failure between
        # the wave and the apply would leave the mesh ahead for good and a
        # retry of the same seeds would find nothing newly invalid
        entry.pop("invalid_version", None)
        cause, wave_seq = self._begin_wave()
        t0 = time.perf_counter()
        count, newly_ids, overflow = sharded.run_wave_collect(seeds)
        if overflow:
            # wave larger than the collect buffer: one mask-diff readback
            # against the still-pre-burst dense host mirror
            newly = sharded.invalid_mask() & ~dg._h_invalid[: sharded.n_nodes]
            newly_ids = np.nonzero(newly)[0].astype(np.int32)
        dg.mark_invalid(newly_ids)  # dense device + host mirror catch up
        entry["invalid_version"] = dg.invalid_version  # in sync again
        t1 = time.perf_counter()
        self._apply_newly(newly_ids)
        self.waves_run += 1
        self.device_invalidations += count
        self._profile_wave("sharded_union", len(seeds), cause, t0, t1, len(newly_ids), wave_seq)
        return count

    # ------------------------------------------------------------------ packed mesh mirror
    def packed_mirror(self, mesh=None) -> dict:
        """Packed mesh mirror of the LIVE edge set — the mesh lane-burst
        bridge (``PackedShardedGraph`` over the currently live, epoch-matched
        edges, ``PATCH_SLACK`` free slots a row, and a device-resident
        blocked mask mirroring the invalid state). Structural churn PATCHES
        the mesh tables in place from the graph's ordered delta stream:
        bumps scatter the mesh's rebased epochs (the pull wave has no level
        order, so no violations exist), adds splice into slack slots; only
        slot overflow, unknown nodes, or a broken log rebuild. The blocked
        mask re-syncs from the dense state only after host-led
        invalid-state changes (the ``invalid_version`` protocol of the union
        bridge). ``mesh`` defaults to one shard on the backend's device."""
        from ..parallel import PackedShardedGraph

        self.flush()
        dg = self.graph
        sv = dg._struct_version
        cached = self._packed_mirror
        if cached is not None:
            cached_ref = cached["mesh_ref"]
            same_mesh = (
                cached_ref is None if mesh is None
                else cached_ref is not None and cached_ref() is mesh
            )
            if same_mesh:
                if cached["validated_at"] == sv:
                    return cached
                aux = cached["aux_log"]
                if not aux["broken"] and self._try_patch_packed(cached, aux):
                    cached["validated_at"] = sv
                    return cached
                if cached["fp"] is not None and check_structure_cache(
                    cached, sv, lambda: dg._live_edge_fingerprint()[2]
                ):
                    return cached
        if cached is not None:
            dg.drop_aux_delta_log(cached["aux_log"])
        src, dst, fp = dg._live_edge_fingerprint()
        pg = PackedShardedGraph(
            src, dst, dg.n_nodes, mesh=mesh if mesh is not None else graph_mesh(device=dg.device),
            slack=dg.PATCH_SLACK,
        )
        self._packed_mirror = {
            "fp": fp,
            "validated_at": sv,
            "mesh_ref": weakref.ref(mesh) if mesh is not None else None,
            "graph": pg,
            "blocked": pg.put_blocked(),
            # epochs on the mesh are REBASED to 0 at build; deltas carry
            # absolute epochs and translate through this base
            "epoch_base": dg._h_node_epoch[: dg.n_nodes].copy(),
            "aux_log": dg.register_aux_delta_log(),
            # absent invalid_version: the next burst full-syncs from dense
        }
        return self._packed_mirror

    def _try_patch_packed(self, entry: dict, aux: dict) -> bool:
        """Replay the recorded structural deltas onto the mesh mirror, the
        whole stream coalesced into one ``PackedShardedGraph.patch_batch``.
        The packed mirror's epochs are REBASED to 0 at build, so the
        coalescer's absolute epochs translate through the build base here.
        Returns False (and breaks the log) on anything the in-place path
        cannot absorb — the caller rebuilds."""
        pg = entry["graph"]
        base = entry["epoch_base"]
        coalesced = self._coalesce_mirror_deltas(aux["deltas"], pg.n_nodes)
        if coalesced is None:
            aux["broken"] = True  # nodes born after the build
            return False
        bumps, u, v, ep = coalesced
        if not len(bumps) and not len(u):
            aux["deltas"] = []
            return True
        # the first in-place mutation invalidates the BUILD fingerprint for
        # good: a later failed replay must never let the fingerprint path
        # revalidate half-patched tables
        entry["fp"] = None
        if not pg.patch_batch(bumps, u, v, ep - base[v]):
            aux["broken"] = True  # slot overflow / unknown nodes
            return False
        aux["deltas"] = []
        global_metrics().counter(
            "fusion_mirror_patch_batches_total",
            help="structural churn bursts applied to the packed mesh mirror in one patch batch",
        ).inc()
        return True

    @staticmethod
    def _coalesce_mirror_deltas(deltas, n: int):
        """Collect a recorded structural-delta stream into concatenated
        ``(bumps, u, v, ep_abs)`` for one patch batch. Coalescing is
        final-state-safe: bumps are epoch increments and adds carry their
        captured epochs, so the result is order-independent; bump payloads
        arrive unique (``bump_epochs`` dedups before recording), so plain
        concatenation keeps the sequential replay's semantics. Returns None
        when an add references nodes born after the mirror's build (the
        rebuild signal)."""
        bumps: List[np.ndarray] = []
        us: List[np.ndarray] = []
        vs: List[np.ndarray] = []
        eps: List[np.ndarray] = []
        for kind, payload in deltas:
            if kind == "bump":
                ids = np.asarray(payload, dtype=np.int64)
                ids = ids[ids < n]
                if ids.size:
                    bumps.append(ids)
            else:
                u, v, ep = payload
                u64 = np.asarray(u, dtype=np.int64)
                v64 = np.asarray(v, dtype=np.int64)
                if u64.size and (int(u64.max()) >= n or int(v64.max()) >= n):
                    return None
                us.append(u64)
                vs.append(v64)
                eps.append(np.asarray(ep, dtype=np.int64))

        def cat(parts):
            return np.concatenate(parts) if parts else np.empty(0, np.int64)

        return cat(bumps), cat(us), cat(vs), cat(eps)

    def invalidate_cascade_batch_lanes_sharded(
        self, groups: Sequence[Sequence["Computed"]], mesh=None
    ) -> np.ndarray:
        """Lane-packed live burst ON THE MESH: each command group cascades
        independently in its own bit lane over the mesh (the packed pull
        wave, ``parallel/packed_wave.py``), gated by the live graph's
        invalid state, with the union applied back to the hub exactly like
        the single-device lane path. The blocked mask stays device-resident
        between bursts (the ``invalid_version`` protocol, exception-safe: the
        entry reads out of sync until the dense apply completes). Returns
        per-group newly counts (a computed not in the graph falls back to an
        immediate host invalidation, counting 1)."""
        seed_lists: List[List[int]] = []
        fallback = np.zeros(len(groups), dtype=np.int64)
        for gi, group in enumerate(groups):
            ids: List[int] = []
            for c in group:
                nid = self._id_by_input.get(c.input)
                if nid is None:
                    c.invalidate(immediately=True)
                    fallback[gi] += 1
                else:
                    ids.append(nid)
            seed_lists.append(ids)
        return self._lanes_sharded_nids(seed_lists, mesh) + fallback

    def cascade_rows_lanes_sharded(self, block: RowBlock, row_groups, mesh=None) -> np.ndarray:
        """:meth:`cascade_rows_lanes` ON THE MESH: each row group cascades
        independently in its own bit lane over the mesh, the union applied
        back to the hub and tables like the single-device path."""
        seed_lists = [(block.base + self._check_rows(block, g)).tolist() for g in row_groups]
        return self._lanes_sharded_nids(seed_lists, mesh)

    def _lanes_sharded_nids(self, seed_lists: List[List[int]], mesh=None) -> np.ndarray:
        entry = self.packed_mirror(mesh=mesh)
        pg = entry["graph"]
        dg = self.graph
        if entry.get("invalid_version") != dg.invalid_version:
            mask = dg.invalid_mask()
            dg._h_invalid[: dg.n_nodes] = mask
            entry["blocked"] = pg.put_blocked(mask)
        entry.pop("invalid_version", None)  # out of sync until the apply completes
        cause, wave_seq = self._begin_wave()
        t0 = time.perf_counter()
        # cap=0: no union ids are compacted; the union is what the burst
        # added to the blocked words, applied as a mask
        counts, _, blocked2, _ = pg.run_gated_lanes(seed_lists, entry["blocked"], cap=0)
        t1 = time.perf_counter()
        newly = dg.mark_invalid_words(blocked2 & ~entry["blocked"])
        entry["blocked"] = blocked2
        entry["invalid_version"] = dg.invalid_version
        self._apply_newly(newly)
        self.waves_run += len(seed_lists)
        self.device_invalidations += int(counts.sum())
        self._profile_wave(
            "sharded_lanes", sum(len(s) for s in seed_lists), cause, t0, t1,
            int(counts.sum()), wave_seq, groups=len(seed_lists),
        )
        return counts

    # ------------------------------------------------------------------ lookup
    def computed_for(self, node_id: int):
        """The live Computed for a backend node id (None if collected)."""
        ref = self._computed_by_id.get(int(node_id))
        return ref() if ref is not None else None

    def id_for(self, computed: "Computed") -> Optional[int]:
        """The backend node id for a live Computed (None if unmirrored)."""
        with self._lock:
            return self._id_by_input.get(computed.input)

    # ------------------------------------------------------------------ stats
    @property
    def node_count(self) -> int:
        return self.graph.n_nodes

    @property
    def edge_count(self) -> int:
        return self.graph.n_edges


GraphBackend = TpuGraphBackend
