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
in one mirror sweep, one bit lane each. Row blocks (columnar tables), the
packed and routed mesh mirrors, super-rounds and the watchdog are later
slices of the port and raise ``NotImplementedError``; the row-block checks on
the apply path stay, as no-ops while no block is bound.
"""
from __future__ import annotations

import hashlib
import logging
import threading
import time
import weakref
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..diagnostics.flight_recorder import RECORDER
from ..diagnostics.metrics import WaveProfiler, global_metrics, next_wave_seq
from ..diagnostics.tracing import CAUSE_PREFIX, current_span, span_cause_id
from ..parallel import ShardedDeviceGraph, graph_mesh
from .device_graph import DeviceGraph, check_structure_cache

if TYPE_CHECKING:
    from ..core.computed import Computed
    from ..core.hub import FusionHub

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["TpuGraphBackend", "GraphBackend"]

#: process-unique cause-id prefix, shared with tracing
_CAUSE_PREFIX = CAUSE_PREFIX


def _not_ported(what: str, slice_: str):
    raise NotImplementedError(f"TpuGraphBackend.{what} is not ported yet: ROADMAP {slice_}")


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
        # columnar row blocks: none until bind_table_rows is ported
        self._row_blocks: list = []
        self._block_bases = np.empty(0, dtype=np.int64)
        self._block_ends = np.empty(0, dtype=np.int64)
        #: the nonblocking wave pipeline (a later slice): None while the hub
        #: runs blocking; ``Computed.invalidate_eventually`` reads it
        self.pipeline = None
        self._sharded_mirror: Optional[dict] = None  # see sharded_mirror
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
                      fused_depth=None, seq_span=None, dispatches=None) -> None:
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

    def _wave_union(self, seed_lists):
        return self.graph.run_waves_union(seed_lists)

    def _wave_lanes(self, seed_lists):
        return self.graph.run_waves_lanes(seed_lists)

    def _wave_union_seq(self, seed_lists):
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
            _not_ported("row-block apply", "A.3 (columnar memo table)")
        watched = newly_ids[self._watched[newly_ids]]
        self._pending[newly_ids] = True
        for hook in self.newly_hooks:
            hook(newly_ids)
        self._eager_invalidate(watched)

    def _apply_newly_mask(self, newly: np.ndarray) -> None:
        """Mask twin of the id path: same tiers, all-vectorized."""
        n = len(newly)
        if self._row_blocks:
            _not_ported("row-block apply", "A.3 (columnar memo table)")
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

    # ------------------------------------------------------------------ later slices
    def bind_table_rows(self, *args, **kwargs):
        _not_ported("bind_table_rows", "A.3 (columnar memo table)")

    def declare_row_edges(self, *args, **kwargs):
        _not_ported("declare_row_edges", "A.3 (columnar memo table)")

    def cascade_rows_batch(self, *args, **kwargs):
        _not_ported("cascade_rows_batch", "A.3 (columnar memo table)")

    def refresh_block_on_device(self, *args, **kwargs):
        _not_ported("refresh_block_on_device", "A.3 (columnar memo table)")

    def cascade_rows_lanes(self, *args, **kwargs):
        _not_ported("cascade_rows_lanes", "A.3 (columnar memo table: row-block lane bursts)")

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
        counts, union_mask = self._wave_lanes(seed_lists)
        t1 = time.perf_counter()
        self._apply_newly(union_mask)
        self.waves_run += len(groups)
        self.device_invalidations += int(counts.sum())
        info = self.graph.last_lanes_info or {}
        self._profile_wave(
            "lanes", sum(len(s) for s in seed_lists), cause, t0, t1, int(counts.sum()), seqs[0],
            groups=len(groups), fused_depth=info.get("depth"), seq_span=(seqs[0], seqs[-1]),
            dispatches=info.get("dispatches"),
        )
        return counts + fallback

    def enable_super_rounds(self, *args, **kwargs):
        _not_ported("enable_super_rounds", "A.5 (resident live loop)")

    def attach_watchdog(self, *args, **kwargs):
        _not_ported("attach_watchdog", "A.8 (diagnostics and resilience)")

    def cascade_rows_batch_sharded(self, *args, **kwargs):
        _not_ported("cascade_rows_batch_sharded", "A.3 (columnar memo table)")

    def packed_mirror(self, *args, **kwargs):
        _not_ported("packed_mirror", "A.9 after A.4 (packed mesh waves need the ELL and pull waves)")

    def enable_mesh_routing(self, *args, **kwargs):
        _not_ported("enable_mesh_routing", "A.9 (routed mesh waves and the cluster shard map)")

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
