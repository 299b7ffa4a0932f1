"""DeviceGraph — host-managed container around the device CSR mirror.

Port of the dense path of ``stl_fusion_tpu/graph/device_graph.py``:
capacity-padded device arrays (layout in ``ops/wave.py``), batched edge
ingestion, epoch bumps on recompute, and the wave API. Host numpy staging
is authoritative for structure; the device copy is rebuilt from it when
dirty and patched in place otherwise.

Capacities double on growth, as in the JAX package. PyTorch runs eagerly and
compiles nothing per shape, so the port drops the JAX package's pow2 padding
of id batches (it only limited XLA recompiles). Edges are append-only with
tombstoning by epoch until :meth:`DeviceGraph.compact`.

The invalid state lives on the device as packed int32 words (node ``i`` is
bit ``i & 31`` of word ``i >> 5``) and on the host as a bool mask.

The topo and lat mirrors (:meth:`DeviceGraph.build_topo_mirror`): once built,
``run_waves_union(mirror="auto")`` sends a burst of ≤ ``LAT_SEED_MAX`` seeds
to the lat mirror's O(closure) lone wave (``ops/ell_wave.py``) and every
other burst, or a lat overflow, to one depth-free topo sweep
(``ops/topo_wave.py``); :meth:`DeviceGraph.run_waves_lanes` runs up to 512
independent command groups, one bit lane each, in one sweep. The mirror
follows a churning graph through a structural delta log: edge appends and
epoch bumps since the build are spliced into its tables in place at the
next use (:meth:`DeviceGraph._try_patch_mirror`); a level-violating edge
costs one more sweep pass, past 3 of them a background re-level starts
(:meth:`DeviceGraph.start_topo_mirror_rebuild`), and an unpatchable delta
breaks the log, after which bursts take the dense path until the mirror is
built again. With ``FUSION_MIRROR_CACHE`` set, a built mirror is saved to
disk keyed by its live-edge fingerprint, and a later build of the same edge
set loads it (:meth:`DeviceGraph._mirror_cache_path`).

The non-blocking lane chain (:meth:`DeviceGraph.dispatch_waves_lanes_chain`
and :meth:`DeviceGraph.harvest_waves_lanes_chain`) and the resident
super-round (:meth:`DeviceGraph.dispatch_waves_superround`) enqueue their
stages without reading anything back; on the card each batch of stages is
one replay of a captured CUDA graph (``graph/program_cache.py``).
"""
from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..diagnostics.metrics import global_metrics
from .program_cache import ChainProgram, NotFusible, ProgramCache
from ..ops.bitops import ids_to_word_masks, pack_mask_host, unpack_words_host
from ..ops.ell_wave import (
    EllGraph,
    build_ell,
    ell_live_epoch_init,
    ell_live_union_chain_step,
    ell_live_union_step,
    widen_ell,
)
from ..ops.pull_wave import pack_lane_matrix
from ..ops.topo_wave import (
    TopoGraph,
    build_topo_graph,
    topo_graph_arrays,
    topo_mirror_fused_lanes_chain_step,
    topo_mirror_fused_lanes_step,
    topo_mirror_fused_union_step,
    topo_mirror_superround_step,
)
from ..ops.wave import (
    GraphArrays,
    run_wave,
    run_wave_collect,
    run_wave_with_stats,
    run_waves_chained_packed,
    run_waves_union_packed,
    seeds_to_frontier,
)

__all__ = ["DeviceGraph", "check_structure_cache", "fetch_outputs"]

log = logging.getLogger("stl_fusion_tpu_torch")


def _round_up_pow2(x: int) -> int:
    n = 1
    while n < x:
        n <<= 1
    return n


def fetch_outputs(out):
    """A dispatched chain batch's (lane counts, newly mask words) as numpy:
    the harvest's one blocking read of the device (``ChainOutputs.fetch``)."""
    return out.fetch()


def check_structure_cache(entry: dict, struct_version: int, fp_fn) -> bool:
    """The shared freshness check for structure-fingerprint caches (the
    backend's sharded mirror, the topo mirror): O(1) when the
    entry was already validated — or already known stale — at this
    struct_version, at most one O(edges) fingerprint hash per structural
    mutation otherwise. Mutates ``entry['validated_at']``/``['missed_at']``."""
    if entry["validated_at"] == struct_version:
        return True
    if entry.get("missed_at") == struct_version:
        return False
    if fp_fn() == entry["fp"]:
        entry["validated_at"] = struct_version
        return True
    entry["missed_at"] = struct_version
    return False


class DeviceGraph:
    MAX_MIRROR_DELTAS = 65536  # a longer delta log breaks: a rebuild is cheaper
    MAX_PATCH_EDGES = 65536  # per add-delta; beyond this a rebuild wins
    LAT_CHAIN_OUT_CAP = 65536  # union ids a sequenced lone-wave chain returns

    def __init__(self, node_capacity: int = 1024, edge_capacity: int = 4096, device=None):
        self.device = resolve_device(device)
        self.n_cap = _round_up_pow2(max(node_capacity, 16))
        self.e_cap = _round_up_pow2(max(edge_capacity, 16))
        self.n_nodes = 0  # dense ids [0, n_nodes)
        self.n_edges = 0  # live prefix of edge arrays
        # host staging (authoritative for structure)
        self._h_edge_src = np.full(self.e_cap, self.n_cap, dtype=np.int32)
        self._h_edge_dst = np.full(self.e_cap, self.n_cap, dtype=np.int32)
        self._h_edge_dst_epoch = np.full(self.e_cap, -1, dtype=np.int32)
        self._h_node_epoch = np.zeros(self.n_cap + 1, dtype=np.int32)
        self._h_node_epoch[self.n_cap] = -2  # dummy slot never version-matches
        self._h_invalid = np.zeros(self.n_cap + 1, dtype=bool)  # host-authoritative
        self._g: Optional[GraphArrays] = None  # device copy, built lazily
        self._dirty = True
        self._init_versions()

    LAT_SEED_MAX = 256  # ≤ this many union seeds route via the lat mirror
    LAT_K = 4  # lat out-ELL build width (virtual trees bound fan-out)
    LAT_LCAP = 512
    LAT_CAP = 8192
    # guaranteed-free slots per mirror row (topo in-rows and lat out-rows), as
    # in the JAX package: the tables keep its shapes, which the patch path
    # splices new edges into
    PATCH_SLACK = 2
    #: ≤ this many sweep passes ride the fused chain and super-round; a
    #: heavier patched mirror falls back (the callers' counted eager path)
    FUSED_PASS_MAX = 3

    def _init_versions(self) -> None:
        # bumped on every structural mutation: a structure cache remembers
        # the version it was last validated (or missed) at, so it pays the
        # O(edges) fingerprint check at most once per mutation
        self._struct_version = 0
        # bumped on every change to the INVALID state (waves that lit
        # something, marks, clears, epoch bumps): the sharded live bridge
        # reads it to know whether its resident mesh copy is still current
        self.invalid_version = 0
        self._topo_mirror: Optional[dict] = None  # see build_topo_mirror
        self.mirror_rebuilds = 0  # topo mirror builds (sync and async installs)
        self.mirror_bursts = 0  # bursts served by a mirror (topo or lat)
        self.lat_waves = 0  # unions served by the lat mirror
        #: shape of the last lane burst: {"depth": stages, "dispatches": sweeps}
        self.last_lanes_info: Optional[dict] = None
        # structural deltas since the mirror was last coherent; None = no log
        # (no mirror, or an unpatchable delta broke it: the fingerprint or a
        # rebuild decides next)
        self._mirror_deltas: Optional[list] = None
        # the in-flight background re-level and its catch-up log
        self._async_rebuild: Optional[dict] = None
        self._rebuild_deltas: Optional[list] = None
        # subscribers to the same ordered delta stream (the mesh mirrors)
        self._aux_delta_logs: list = []
        self.mirror_patches = 0  # patch applications (batches, not deltas)
        self.mirror_patch_s = 0.0  # cumulative patch time
        self.mirror_patch_host_s = 0.0  # numpy slot and level bookkeeping
        self.mirror_patch_device_s = 0.0  # the device row scatters
        # adaptive sweep passes: bursts sweep to a fixed point (passes=0)
        # instead of the worst-case 1+n_viol; counted per adaptive burst
        self.adaptive_passes = False
        self.adaptive_stages = 0
        self.mirror_cache_hits = 0  # disk-cache loads (build_topo_mirror)
        self.mirror_cache_misses = 0  # full host builds with a cache root set
        #: the lane chains' resident programs (the refresh chains' live on
        #: their row block)
        self._chain_programs = ProgramCache()
        #: the last harvest's split: seconds blocked on the device read, and
        #: seconds unpacking the stage masks into the host mirror
        self.last_harvest_info: Optional[dict] = None
        self._mirror_cache_writer: Optional[threading.Thread] = None  # the last save
        #: the last disk-cache load's split: reading the entry, installing it
        self.last_mirror_load: Optional[dict] = None

    @classmethod
    def from_numpy_state(cls, state: dict, device=None) -> "DeviceGraph":
        """Adopt a JAX ``DeviceGraph``'s host staging arrays (``_h_edge_src``,
        ``_h_edge_dst``, ``_h_edge_dst_epoch``, ``_h_node_epoch``,
        ``_h_invalid``, ``n_nodes``, ``n_edges``, ``n_cap``, ``e_cap``) — the
        port's counterpart of carrying weights across. Arrays are copied."""
        g = cls.__new__(cls)
        g.device = resolve_device(device)
        g.n_cap, g.e_cap = int(state["n_cap"]), int(state["e_cap"])
        g.n_nodes, g.n_edges = int(state["n_nodes"]), int(state["n_edges"])
        g._h_edge_src = np.array(state["_h_edge_src"], dtype=np.int32)
        g._h_edge_dst = np.array(state["_h_edge_dst"], dtype=np.int32)
        g._h_edge_dst_epoch = np.array(state["_h_edge_dst_epoch"], dtype=np.int32)
        g._h_node_epoch = np.array(state["_h_node_epoch"], dtype=np.int32)
        g._h_invalid = np.array(state["_h_invalid"], dtype=bool)
        if g._h_edge_src.shape != (g.e_cap,) or g._h_node_epoch.shape != (g.n_cap + 1,):
            raise ValueError("from_numpy_state: array shapes do not match n_cap/e_cap")
        g._g = None
        g._dirty = True
        g._init_versions()
        return g

    # ------------------------------------------------------------------ delta log
    def register_aux_delta_log(self, cap: int = MAX_MIRROR_DELTAS) -> dict:
        """Subscribe to the ordered structural-delta stream. Returns the log
        dict ``{"deltas", "broken", "cap"}``: an overflowing log marks itself
        broken and empties, and its owner rebuilds."""
        log = {"deltas": [], "broken": False, "cap": cap}
        self._aux_delta_logs.append(log)
        return log

    def drop_aux_delta_log(self, log: dict) -> None:
        try:
            self._aux_delta_logs.remove(log)
        except ValueError:
            pass

    def _logging_deltas(self) -> bool:
        return ((self._topo_mirror is not None and self._mirror_deltas is not None)
                or self._rebuild_deltas is not None or bool(self._aux_delta_logs))

    def _record_mirror_delta(self, kind: str, payload) -> None:
        """Append ``(kind, payload)`` to every live log: the aux logs, the
        async rebuild's catch-up log (which breaks only on overflow:
        patchability is judged at install against the new levels), and the
        mirror's own log (None once broken; unbounded churn breaks it)."""
        for log in self._aux_delta_logs:
            if log["broken"]:
                continue
            if len(log["deltas"]) >= log["cap"]:
                log["broken"] = True
                log["deltas"] = []
            else:
                log["deltas"].append((kind, payload))
        if self._rebuild_deltas is not None:
            if len(self._rebuild_deltas) >= self.MAX_MIRROR_DELTAS:
                self._rebuild_deltas = None
            else:
                self._rebuild_deltas.append((kind, payload))
        d = self._mirror_deltas
        if self._topo_mirror is None or d is None:
            return
        if len(d) >= self.MAX_MIRROR_DELTAS:
            self._mirror_deltas = None
            return
        d.append((kind, payload))

    # ------------------------------------------------------------------ build
    def add_nodes(self, count: int) -> np.ndarray:
        """Allocate ``count`` dense node ids."""
        start = self.n_nodes
        self.n_nodes += count
        self._struct_version += 1  # n_nodes is part of the fingerprint
        if self.n_nodes > self.n_cap:
            self._grow_nodes(self.n_nodes)
        return np.arange(start, self.n_nodes, dtype=np.int32)

    def add_edges(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        dst_epoch: Optional[np.ndarray] = None,
    ) -> None:
        """Append dependency edges src(used) → dst(dependent) in batch.

        ``dst_epoch`` defaults to each dependent's CURRENT epoch — the
        "edge is valid for this version" capture rule."""
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        k = len(src)
        if k and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) > self.n_cap):
            # the kernels index bit vectors and epochs by these ids unchecked
            raise ValueError(f"add_edges: node ids must lie in [0, {self.n_cap}]")
        if self.n_edges + k > self.e_cap:
            self._grow_edges(self.n_edges + k)
        if dst_epoch is None:
            dst_epoch = self._h_node_epoch[dst]
        dst_epoch = np.broadcast_to(np.asarray(dst_epoch, dtype=np.int32), dst.shape)
        start = self.n_edges
        sl = slice(start, start + k)
        self._h_edge_src[sl] = src
        self._h_edge_dst[sl] = dst
        self._h_edge_dst_epoch[sl] = dst_epoch
        self.n_edges += k
        if self._g is not None and not self._dirty:
            # incremental device append into the padded slots: a slice copy,
            # no full re-upload of the edge arrays
            self._g.edge_src[sl] = self._upload(self._h_edge_src[sl])
            self._g.edge_dst[sl] = self._upload(self._h_edge_dst[sl])
            self._g.edge_dst_epoch[sl] = self._upload(self._h_edge_dst_epoch[sl])
            self._g = self._g._replace(n_live=self.n_edges)
        else:
            self._dirty = True
        self._struct_version += 1
        if self._logging_deltas():
            # only edges live at append exist for the mirror; each carries its
            # CAPTURED epoch, so an edge whose dependent bumps before the
            # patch stays dead in the lat mirror
            ep = np.array(dst_epoch, dtype=np.int32)
            live = ep == self._h_node_epoch[dst]
            if live.all():
                self._record_mirror_delta("add", (src.copy(), dst.copy(), ep))
            elif live.any():
                self._record_mirror_delta("add", (src[live].copy(), dst[live].copy(), ep[live]))

    def bump_epochs(self, node_ids: np.ndarray) -> None:
        """Nodes recomputed: new epoch ⇒ their stale in-edges go dead, and
        their invalid flag clears. Ids are UNIQUE-ified first: the host fancy
        ``+=`` applies once per unique id while a device ``index_add_`` adds
        once per occurrence — a duplicated batch would diverge the copies."""
        node_ids = np.unique(np.asarray(node_ids, dtype=np.int32))
        if node_ids.size == 0:
            return
        self._h_node_epoch[node_ids] += 1
        self._h_invalid[node_ids] = False
        self._struct_version += 1
        self.invalid_version += 1
        if self._logging_deltas():
            self._record_mirror_delta("bump", node_ids.copy())
        if self._g is not None and not self._dirty:
            ids = self._upload(node_ids).long()
            self._g.node_epoch.index_add_(
                0, ids, torch.ones(len(node_ids), dtype=torch.int32, device=self.device)
            )
            self._device_invalid_update(node_ids, False)
        else:
            self._dirty = True

    def mark_invalid(self, node_ids: np.ndarray) -> None:
        """Externally-observed invalidations (host-led waves) → mirror state."""
        node_ids = np.asarray(node_ids, dtype=np.int32)
        if node_ids.size == 0:
            return
        self._h_invalid[node_ids] = True
        self.invalid_version += 1
        self._device_invalid_update(node_ids, True)

    def mark_invalid_words(self, words: torch.Tensor) -> np.ndarray:
        """Mask form of :meth:`mark_invalid`: ``words`` packs the newly
        invalid nodes (bit ``i % 32`` of word ``i // 32``, the layout of the
        device words). The words are OR'ed in on the device, and the host
        mirror from one readback. Returns the mask as bool[n_nodes]."""
        mask = unpack_words_host(words.cpu().numpy(), self.n_nodes)
        if not mask.any():
            return mask
        self._h_invalid[: self.n_nodes] |= mask
        self.invalid_version += 1
        if self._g is not None and not self._dirty:
            inv = self._g.invalid
            k = min(inv.shape[0], words.shape[0])
            inv[:k] |= words[:k].to(inv.device)
        return mask

    def clear_invalid_ids(self, node_ids: np.ndarray) -> None:
        """Refreshed rows are consistent again WITHOUT an epoch bump."""
        node_ids = np.asarray(node_ids, dtype=np.int32)
        if node_ids.size == 0:
            return
        self._h_invalid[node_ids] = False
        self.invalid_version += 1
        self._device_invalid_update(node_ids, False)

    def _device_invalid_update(self, node_ids: np.ndarray, value: bool) -> None:
        """Apply a host-side invalid change to the device words. Small
        batches rewrite only the words they touch (one scatter of per-word
        OR masks, each word once); a batch whose ids outweigh the packed
        mask uploads the host-authoritative mask instead."""
        if self._g is None or self._dirty:
            return
        inv = self._g.invalid
        if node_ids.size > inv.shape[0]:
            inv.copy_(self._upload(pack_mask_host(self._h_invalid)))
            return
        words, masks = ids_to_word_masks(node_ids)
        w = self._upload(words)
        m = self._upload(masks)
        inv[w] = (inv[w] | m) if value else (inv[w] & ~m)

    def _grow_nodes(self, need: int) -> None:
        new_cap = _round_up_pow2(need)
        node_epoch = np.zeros(new_cap + 1, dtype=np.int32)
        node_epoch[: self.n_cap] = self._h_node_epoch[: self.n_cap]
        node_epoch[new_cap] = -2
        invalid = np.zeros(new_cap + 1, dtype=bool)
        invalid[: self.n_cap] = self._h_invalid[: self.n_cap]
        # re-point padded edges at the new dummy slot
        self._h_edge_src[self._h_edge_src == self.n_cap] = new_cap
        self._h_edge_dst[self._h_edge_dst == self.n_cap] = new_cap
        self._h_node_epoch = node_epoch
        self._h_invalid = invalid
        self.n_cap = new_cap
        self._dirty = True

    def _grow_edges(self, need: int) -> None:
        new_cap = _round_up_pow2(need)
        for name in ("_h_edge_src", "_h_edge_dst"):
            arr = np.full(new_cap, self.n_cap, dtype=np.int32)
            arr[: self.n_edges] = getattr(self, name)[: self.n_edges]
            setattr(self, name, arr)
        epoch = np.full(new_cap, -1, dtype=np.int32)
        epoch[: self.n_edges] = self._h_edge_dst_epoch[: self.n_edges]
        self._h_edge_dst_epoch = epoch
        self.e_cap = new_cap
        self._dirty = True

    # ------------------------------------------------------------------ device sync
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → a FRESH device tensor. ``torch.from_numpy`` aliases
        the numpy buffer, and on the CPU ``.to`` would keep that alias; the
        staging arrays are later mutated in place (epoch ``+=``, edge
        splices, invalid marks), so an aliased device copy would absorb
        those writes on top of its own updates. ``copy=True`` always copies."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, copy=True)

    def device_arrays(self) -> GraphArrays:
        """Materialize (or reuse) the device copy; host staging is
        authoritative for structure AND invalid state at rebuild time."""
        if self._g is None or self._dirty:
            self._g = GraphArrays(
                edge_src=self._upload(self._h_edge_src),
                edge_dst=self._upload(self._h_edge_dst),
                edge_dst_epoch=self._upload(self._h_edge_dst_epoch),
                node_epoch=self._upload(self._h_node_epoch),
                invalid=self._upload(pack_mask_host(self._h_invalid)),
                n_live=self.n_edges,
            )
            self._dirty = False
        return self._g

    def _seed_frontier(self, seed_ids) -> torch.Tensor:
        ids = self._upload(np.asarray(seed_ids, dtype=np.int32).reshape(-1))
        return seeds_to_frontier(self.n_cap, ids)

    # ------------------------------------------------------------------ waves
    def run_wave(self, seed_ids: Sequence[int], with_stats: bool = False):
        """Cascade from ``seed_ids``; returns newly-invalidated count
        (+ BFS depth with stats). The device arrays keep the result state."""
        g = self.device_arrays()
        seeds = self._seed_frontier(seed_ids)
        if with_stats:
            self._g, count, depth = run_wave_with_stats(seeds, g)
            self._sync_invalid_back()
            return count, depth
        self._g, count = run_wave(seeds, g)
        self._sync_invalid_back()
        return count

    def run_wave_collect(
        self, seed_ids: Sequence[int], cap: int = 8192
    ) -> Tuple[int, np.ndarray]:
        """Cascade from ``seed_ids`` and return (count, newly-invalidated
        node ids in ascending order) with an O(wave) readback; only on
        overflow (count > cap) does it read back the packed mask. The host
        ``_h_invalid`` copy is patched from the ids."""
        g = self.device_arrays()
        self._g, count, ids, overflow = run_wave_collect(self._seed_frontier(seed_ids), g, cap)
        return count, self._patch_host_invalid(count, ids.cpu().numpy(), overflow)

    def _patch_host_invalid(self, count: int, ids: np.ndarray, overflow: bool) -> np.ndarray:
        """Apply a compacted-wave readback to ``_h_invalid``: the id buffer
        when it fit, otherwise a mask diff against the device words (read
        back bit-packed). Returns the newly-invalid ids."""
        if count or overflow:
            self.invalid_version += 1
        if overflow:
            dev_mask = unpack_words_host(self._g.invalid.cpu().numpy(), len(self._h_invalid))
            newly = dev_mask & ~self._h_invalid
            newly_ids = np.nonzero(newly)[0].astype(np.int32)
            self._h_invalid |= newly
        else:
            newly_ids = ids[:count] if count else np.empty(0, np.int32)
            self._h_invalid[newly_ids] = True
        return newly_ids

    def run_waves_chained(self, seed_id_lists: Sequence[Sequence[int]]):
        """Chain many seed waves, each over the state the previous one left.
        Returns (per-wave counts int64[W], union newly ids)."""
        g = self.device_arrays()
        width = max((len(s) for s in seed_id_lists), default=1)
        mat = np.full((len(seed_id_lists), max(width, 1)), -1, dtype=np.int32)
        for i, s in enumerate(seed_id_lists):
            mat[i, : len(s)] = np.asarray(s, dtype=np.int32)
        self._g, counts, newly_w = run_waves_chained_packed(self._upload(mat), g)
        newly = unpack_words_host(newly_w.cpu().numpy(), self.n_cap + 1)  # 1 bit/node
        if newly.any():  # a no-op wave leaves the version alone
            self.invalid_version += 1
        self._h_invalid |= newly
        return counts.numpy().astype(np.int64), np.nonzero(newly)[0].astype(np.int32)

    def run_waves_union(self, seed_id_lists: Sequence[Sequence[int]], mirror: str = "auto"):
        """Union cascade for a burst of seed waves: ONE expansion from all
        seeds together. Returns (total newly count, union newly ids).

        ``mirror``: "auto" rides the topo mirror when one was built with
        :meth:`build_topo_mirror` and the live edge set still matches it: a
        burst of at most ``LAT_SEED_MAX`` seeds runs the lat mirror's lone
        wave (ids come back ascending), any other burst — or a lat overflow —
        one depth-free topo sweep (ids in topo-row order); "off" forces the
        dense BFS path."""
        if mirror not in ("auto", "off"):
            raise ValueError(f"mirror must be 'auto' or 'off', got {mirror!r}")
        flat = [np.asarray(s, dtype=np.int64).reshape(-1) for s in seed_id_lists]
        flat = np.concatenate(flat) if flat else np.empty(0, np.int64)
        if mirror == "auto" and self._mirror_valid():
            m = self._topo_mirror
            # out-of-contract seed ids (unallocated slots) only the dense
            # path can represent: those bursts fall through to it
            if not len(flat) or (flat.min() >= 0 and flat.max() < m["n_nodes"]):
                if m["lat"] is not None and 0 < len(flat) <= self.LAT_SEED_MAX:
                    res = self._run_lat_union(m["lat"], flat)
                    if res is not None:
                        return res
                return self._run_mirror_union(flat)
        g = self.device_arrays()
        self._g, count, newly_w = run_waves_union_packed(self._upload(flat.astype(np.int32)), g)
        newly = unpack_words_host(newly_w.cpu().numpy(), self.n_cap + 1)  # 1 bit/node
        if newly.any():  # a no-op wave leaves the version alone
            self.invalid_version += 1
        self._h_invalid |= newly
        return count, np.nonzero(newly)[0].astype(np.int32)

    def run_wave_frontier(self, seed_frontier: torch.Tensor, sync_host: bool = False) -> int:
        """Wave from a prebuilt bool frontier (bench hot path — the host copy
        of the invalid state stays stale unless ``sync_host``)."""
        g = self.device_arrays()
        self.invalid_version += 1
        self._g, count = run_wave(seed_frontier, g)
        if sync_host:
            self._sync_invalid_back()
        return count

    def _sync_invalid_back(self) -> None:
        """After a device wave the device invalid words are newer — pull
        them bit-packed."""
        self.invalid_version += 1
        self._h_invalid = unpack_words_host(self._g.invalid.cpu().numpy(), self.n_cap + 1)

    # ------------------------------------------------------------------ topo and lat mirrors
    def _live_edge_fingerprint(self):
        """(live src, live dst, fingerprint) of the CURRENT live edge set
        (epoch-matched edges only), hashing ``n_nodes`` and the live ids as
        the JAX package does: an append, an epoch bump that kills an
        in-edge, or a node allocation changes it; ``compact`` (dead edges
        only) does not. A recapture of the same edges at new epochs does not
        change it either: the patch log keeps the lat slots current."""
        m = self.n_edges
        live = self._h_node_epoch[self._h_edge_dst[:m]] == self._h_edge_dst_epoch[:m]
        src = self._h_edge_src[:m][live]
        dst = self._h_edge_dst[:m][live]
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64(self.n_nodes).tobytes())
        h.update(src.tobytes())
        h.update(dst.tobytes())
        return src, dst, h.digest()

    def _mirror_valid(self) -> bool:
        """Is the built mirror usable RIGHT NOW? O(1) at a structure version
        already validated (or known stale). A structural change first tries
        the patch path (:meth:`_try_patch_mirror`); only with a broken delta
        log does the O(edges) fingerprint decide, and a patched mirror (its
        fingerprint shed) then stays stale until it is rebuilt."""
        m = self._topo_mirror
        if m is None:
            return False
        if m["validated_at"] == self._struct_version:
            return True
        if self._mirror_deltas is not None:
            return self._try_patch_mirror(m)
        if m["fp"] is None:
            m["missed_at"] = self._struct_version
            return False
        return check_structure_cache(
            m, self._struct_version, lambda: self._live_edge_fingerprint()[2]
        )

    def _break_mirror_deltas(self) -> bool:
        """Break the delta log. The lat mirror goes too: a broken log may
        have been applied to its host tables in part, and a lat carried
        across a rebuild would then miss live edges."""
        self._mirror_deltas = None
        m = self._topo_mirror
        if m is not None:
            m["missed_at"] = self._struct_version
            m["lat"] = None
        return False

    def _try_patch_mirror(self, m: dict) -> bool:
        """Apply the recorded structural deltas to the topo mirror and its
        lat mirror IN PLACE, vectorized per delta payload. Patchable:

        - ``bump v``: v's in-edges die → clear v's topo in-row (levels only
          lose constraints); the lat mirror needs nothing (its slot epochs
          stop matching). A cleared row retires the level violations it
          carried;
        - ``add u→v`` with both known to the mirror and a free slot in v's
          in-row (and u's lat out-row). A level-violating add (``level(u) >=
          level(v)`` in the frozen order) costs one more sweep pass each:
          the mirror runs ``1 + n_viol`` passes (or the adaptive sweep).
          Past 3 violations a background re-level starts; past 8 the log
          breaks.

        Anything else (an edge touching a node born after the build, an
        in-degree overflow past ``k + PATCH_SLACK``, a batch over
        ``MAX_PATCH_EDGES``) breaks the log: bursts take the dense path until
        :meth:`build_topo_mirror` rebuilds. A full lat out-row drops only
        the lat mirror. Host tables patch per delta, then each mirror gets
        one row scatter per call. Returns True (the mirror is valid)."""
        deltas = self._mirror_deltas
        if not deltas:
            # struct_version moved without mirror-visible deltas (add_nodes,
            # compact): seeds in unknown nodes fall back per burst
            m["validated_at"] = self._struct_version
            return True
        t0 = time.perf_counter()
        dev_s0 = self.mirror_patch_device_s
        h = m["h_in_src"]
        inv_perm = m["inv_perm"]
        n_tot = m["n_tot"]
        n_known = m["n_nodes"]
        ls = m["level_starts_arr"]
        changed_parts: list = []
        lat = m.get("lat")
        lat_changed_parts: list = []
        # per-row violating sources: a bump that clears a row RETIRES them,
        # so bump + recapture cycles recount instead of ratcheting n_viol
        viol_by_row: Dict[int, set] = m.setdefault("viol_by_row", {})
        n_viol = int(m.get("n_viol", 0))
        mutated = False

        def _break_patched():
            if mutated:
                # the host tables diverged from the untouched device tables:
                # the build fingerprint must never revalidate them
                m["fp"] = None
            return self._break_mirror_deltas()

        for kind, payload in deltas:
            if kind == "bump":
                v = np.asarray(payload, dtype=np.int64)
                v = v[v < n_known]  # born after the build: no mirrored in-edges
                if v.size == 0:
                    continue
                rows = inv_perm[v]
                h[rows, :] = n_tot
                changed_parts.append(rows)
                mutated = True
                if viol_by_row:
                    held = np.fromiter(viol_by_row.keys(), dtype=np.int64, count=len(viol_by_row))
                    for row in np.intersect1d(rows, held):
                        n_viol -= len(viol_by_row.pop(int(row)))
                continue
            src_a, dst_a, ep_a = payload  # "add"
            if len(src_a) > self.MAX_PATCH_EDGES:
                return _break_patched()
            u64 = np.asarray(src_a, dtype=np.int64)
            v64 = np.asarray(dst_a, dtype=np.int64)
            if u64.size and (int(u64.max()) >= n_known or int(v64.max()) >= n_known):
                return _break_patched()
            if lat is not None:
                lat = self._patch_lat_add_batch(m, lat, u64, v64, np.asarray(ep_a),
                                                lat_changed_parts)
            ru = inv_perm[u64]
            rv = inv_perm[v64]
            # edges already present are closure-identical duplicates
            present = (h[rv] == ru[:, None]).any(axis=1)
            ru, rv = ru[~present], rv[~present]
            if ru.size == 0:
                continue
            # in-batch dedup by (rv, ru); the sort groups edges by row
            key = rv * np.int64(n_tot + 1) + ru
            order = np.argsort(key, kind="stable")
            ku = key[order]
            first = np.ones(len(ku), dtype=bool)
            first[1:] = ku[1:] != ku[:-1]
            ru, rv = ru[order][first], rv[order][first]
            # rank within each row's group → the rank-th free slot
            idx = np.arange(len(rv))
            grp_start = np.ones(len(rv), dtype=bool)
            grp_start[1:] = rv[1:] != rv[:-1]
            rank = idx - np.maximum.accumulate(np.where(grp_start, idx, 0))
            free_cum = (h[rv] == n_tot).cumsum(axis=1)
            need = rank + 1
            if (free_cum[:, -1] < need).any():
                return _break_patched()  # in-degree overflow past k + slack
            slot = (free_cum == need[:, None]).argmax(axis=1)
            # level check: violations pay extra passes, capped
            lu = np.searchsorted(ls, ru, side="right") - 1
            lv = np.searchsorted(ls, rv, side="right") - 1
            viol = lu >= lv
            nv = int(viol.sum())
            if nv:
                n_viol += nv
                if n_viol > 3 and self._async_rebuild is None:
                    self.start_topo_mirror_rebuild(k=m["k"], cap=m["cap"])
                if n_viol > 8:
                    return _break_patched()
                for r_, u_ in zip(rv[viol], ru[viol]):
                    viol_by_row.setdefault(int(r_), set()).add(int(u_))
            h[rv, slot] = ru
            changed_parts.append(rv)
            mutated = True
        t_dev0 = time.perf_counter()
        rows = np.unique(np.concatenate(changed_parts)) if changed_parts else None
        lat_rows = (np.unique(np.concatenate(lat_changed_parts))
                    if lat is not None and lat_changed_parts else None)
        if rows is not None and lat_rows is not None:
            self._scatter_mirror_and_lat_rows(m, rows, n_tot, lat, lat_rows)
        elif rows is not None:
            self._scatter_mirror_rows(m, rows, n_tot)
        elif lat_rows is not None:
            self._scatter_lat_rows(lat, lat_rows)
        self.mirror_patch_device_s += time.perf_counter() - t_dev0
        if n_viol != int(m.get("n_viol", 0)):
            m["n_viol"] = n_viol
            m["passes"] = 0 if self.adaptive_passes else 1 + n_viol
        self._mirror_deltas = []
        m["validated_at"] = self._struct_version
        m["fp"] = None  # the build-time fingerprint no longer describes the tables
        self.mirror_patches += 1
        dt = time.perf_counter() - t0
        self.mirror_patch_s += dt
        self.mirror_patch_host_s += max(dt - (self.mirror_patch_device_s - dev_s0), 0.0)
        return True

    def _scatter_mirror_rows(self, m, rows: np.ndarray, n_tot: int) -> None:
        """Copy the patched topo in-rows ``rows`` (unique) from the host
        table into the device tables, whole rows, with their slot epochs
        (live ⇔ 0, pad ⇔ -1). No width quantization: PyTorch compiles
        nothing per shape."""
        new_rows = m["h_in_src"][rows]
        idx = self._upload(rows.astype(np.int64))
        g = m["garrays"]
        g.in_src[idx] = self._upload(new_rows)
        g.edge_epoch[idx] = self._upload(np.where(new_rows != n_tot, 0, -1).astype(np.int32))

    def _scatter_mirror_and_lat_rows(self, m, rows: np.ndarray, n_tot: int, lat: dict,
                                     lat_rows: np.ndarray) -> None:
        """Both mirrors' patched rows (JAX fuses the two scatters into one
        dispatch to save a relay round trip; here they are two)."""
        self._scatter_mirror_rows(m, rows, n_tot)
        self._scatter_lat_rows(lat, lat_rows)

    def _scatter_lat_rows(self, lat: dict, rows: np.ndarray) -> None:
        idx = self._upload(rows.astype(np.int64))
        lat["ell_dst"][idx] = self._upload(lat["h_ell_dst"][rows])
        lat["ell_epoch"][idx] = self._upload(lat["h_ell_epoch"][rows])

    def _patch_lat_add_batch(self, m: dict, lat: dict, u64, v64, ep_a, lat_changed_parts: list):
        """The lat mirror's half of an add delta: one new out-slot per (u,
        v, captured epoch), duplicates dropped, free slots assigned by rank
        within the row. A full out-row or an unknown node drops ONLY the
        lat mirror (lone waves fall back to the sweep). Returns the lat
        dict, or None once dropped."""
        if u64.size == 0:
            return lat
        if int(u64.max()) >= lat["n_real"] or int(v64.max()) >= lat["n_real"]:
            m["lat"] = None
            return None
        hd, he = lat["h_ell_dst"], lat["h_ell_epoch"]
        ln_tot = lat["n_tot"]
        ep = np.asarray(ep_a, dtype=np.int64)
        # slots already live-present with the same captured epoch
        dup = ((hd[u64] == v64[:, None]) & (he[u64] == ep[:, None])).any(axis=1)
        u, v, e = u64[~dup], v64[~dup], ep[~dup]
        if u.size == 0:
            return lat
        order = np.lexsort((e, v, u))  # in-batch dedup; groups by out-row
        u, v, e = u[order], v[order], e[order]
        first = np.ones(len(u), dtype=bool)
        first[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1]) | (e[1:] != e[:-1])
        u, v, e = u[first], v[first], e[first]
        idx = np.arange(len(u))
        grp_start = np.ones(len(u), dtype=bool)
        grp_start[1:] = u[1:] != u[:-1]
        rank = idx - np.maximum.accumulate(np.where(grp_start, idx, 0))
        free_cum = (hd[u] == ln_tot).cumsum(axis=1)
        need = rank + 1
        if (free_cum[:, -1] < need).any():
            m["lat"] = None
            return None
        slot = (free_cum == need[:, None]).argmax(axis=1)
        hd[u, slot] = v
        he[u, slot] = e
        lat_changed_parts.append(u)
        return lat

    def set_adaptive_passes(self, on: bool = True) -> None:
        """Sweep bursts to a fixed point (``passes=0``: unseeded passes until
        one changes nothing) instead of the worst-case ``1 + n_viol`` a
        patched mirror carries. A built mirror's pass count updates in place."""
        self.adaptive_passes = bool(on)
        m = self._topo_mirror
        if m is not None:
            m["passes"] = 0 if on else 1 + int(m.get("n_viol", 0))

    def _count_adaptive(self, passes: int) -> None:
        """Count one adaptive-mode burst (``passes <= 0``)."""
        if passes > 0:
            return
        self.adaptive_stages += 1
        global_metrics().counter(
            "fusion_wave_adaptive_stages_total",
            help="mirror bursts that swept to a fixed point instead of a pinned "
            "worst-case pass count",
        ).inc()

    def build_topo_mirror(self, k: int = 4, cap: int = 65536, force: bool = False) -> dict:
        """Build (or refresh) the topo mirror of the LIVE edge set: the
        level-ordered in-ELL (``ops/topo_wave.py``, ``k`` in-slots plus
        ``PATCH_SLACK``) that runs a whole burst in ONE depth-free sweep, and
        the lat mirror (the out-ELL of ``ops/ell_wave.py``, ``LAT_K`` plus
        ``PATCH_SLACK``) for lone waves. Patch-or-validate first: a mirror
        whose deltas patch, or whose fingerprint still matches, is returned
        as it is. ``force`` re-levels (n_viol back to 0, one pass), carrying
        a patched-current lat mirror across when no delta is pending.
        Synchronous; :meth:`start_topo_mirror_rebuild` is the background
        form. Bursts read and write the dense device invalid words directly,
        so the states never diverge."""
        cached = self._topo_mirror
        same = cached is not None and cached["cap"] == cap and cached["k"] == k
        if not force and same and self._mirror_valid():
            return cached
        src, dst, fp = self._live_edge_fingerprint()
        if not force and same and cached["fp"] == fp:
            cached["validated_at"] = self._struct_version
            self._mirror_deltas = []
            return cached
        cache_path = self._mirror_cache_path(fp, k)
        if cache_path is not None:
            t0 = time.perf_counter()
            loaded = self._load_mirror_cache(cache_path)
            if loaded is not None:
                topo_c, lat_c = loaded
                self.mirror_cache_hits += 1
                log.info("topo mirror loaded from disk cache (%s)", cache_path)
                t1 = time.perf_counter()
                self._install_topo_mirror(topo_c, k, cap, fp, self._struct_version,
                                          self.n_nodes, lat=lat_c)
                self._mirror_deltas = []
                self.last_mirror_load = {"read_s": t1 - t0,
                                         "install_s": time.perf_counter() - t1}
                return self._topo_mirror
            self.mirror_cache_misses += 1
        # the lat mirror is level-independent: a re-level carries a live,
        # patched-current one, unless a delta is pending (it is in the new
        # edge snapshot, not in the lat tables) or nodes were added
        carried_lat = None
        if (cached is not None and self._mirror_deltas == [] and cached.get("lat") is not None
                and cached["lat"]["n_real"] == self.n_nodes):
            carried_lat = cached["lat"]
        topo = build_topo_graph(src, dst, self.n_nodes, k=k, slack=self.PATCH_SLACK)
        lat = carried_lat if carried_lat is not None else widen_ell(
            build_ell(src, dst, self.n_nodes, k=self.LAT_K), self.PATCH_SLACK)
        self._install_topo_mirror(topo, k, cap, fp, self._struct_version, self.n_nodes, lat=lat)
        if cache_path is not None and not isinstance(lat, dict):
            # a carried lat is not saved: its host tables hold patched slots
            self._save_mirror_cache_async(cache_path, topo, lat)
        self._mirror_deltas = []  # a fresh log: the mirror is coherent now
        return self._topo_mirror

    # ------------------------------------------------------------------ mirror disk cache
    #: entries kept: the reusable pre-churn entry and a run's rebuild saves
    #: (loads touch their entry, so pruning by mtime never evicts it first)
    MIRROR_CACHE_KEEP = 3
    #: the port's own file suffix: the JAX package's ``.npz`` entries (and
    #: its pruning, which lists ``.npz``) never meet these
    MIRROR_CACHE_SUFFIX = ".torchmirror"

    def _mirror_cache_path(self, fp, k: int) -> Optional[str]:
        """The fingerprint-keyed disk entry of a mirror build under the
        ``FUSION_MIRROR_CACHE`` root (None while that variable is unset): a
        restart on the same live edge set loads the built topo and lat
        tables instead of re-deriving them (JAX keys it the same way)."""
        root = os.environ.get("FUSION_MIRROR_CACHE")
        if not root:
            return None
        key = f"{fp.hex()}-k{k}s{self.PATCH_SLACK}l{self.LAT_K}-v1"
        return os.path.join(root, key + self.MIRROR_CACHE_SUFFIX)

    def _load_mirror_cache(self, path: str):
        """(TopoGraph, EllGraph) from a cache entry, or None. The derivable
        tables (slot epochs, the lat mirror's is_real) are rebuilt from the
        id tables; the entry stores only what cannot be derived. A corrupt
        entry is a miss and is removed."""
        if not os.path.exists(path):
            return None
        try:
            try:
                os.utime(path)  # the LRU touch: pruning goes by mtime
            except OSError:
                pass
            with open(path, "rb") as f:
                z = np.load(f)
                in_src = z["in_src"]
                n_tot, n_real = int(z["n_tot"]), int(z["n_real"])
                if n_real != self.n_nodes:
                    return None
                topo = TopoGraph(in_src, np.where(in_src != n_tot, 0, -1).astype(np.int32),
                                 z["is_real"], tuple(z["level_starts"].tolist()), z["perm"],
                                 z["inv_perm"], n_real, n_tot, int(z["k"]))
                lat_dst, lat_n_tot, lat_k = z["lat_dst"], int(z["lat_n_tot"]), int(z["lat_k"])
            lat_is_real = np.zeros(lat_n_tot + 1, dtype=bool)
            lat_is_real[:n_real] = True
            lat = EllGraph(lat_dst, np.where(lat_dst != lat_n_tot, 0, -1).astype(np.int32),
                           lat_is_real, n_real, lat_n_tot, lat_k)
            return topo, lat
        except Exception:  # noqa: BLE001 — a corrupt entry is a cache miss
            try:
                os.remove(path)
            except OSError:
                pass
            return None

    def _save_mirror_cache_async(self, path: str, topo, lat) -> None:
        """Persist a freshly built mirror in a background thread (the write
        is ~1 GB at 10M rows: never on the serving path), then prune the
        root to the newest ``MIRROR_CACHE_KEEP`` entries. Returns the
        thread."""
        suffix = self.MIRROR_CACHE_SUFFIX
        keep = self.MIRROR_CACHE_KEEP

        def work():
            tmp = path + ".tmp"
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(tmp, "wb") as f:
                    np.savez(f, in_src=topo.in_src,
                             level_starts=np.asarray(topo.level_starts, dtype=np.int64),
                             perm=topo.perm, inv_perm=topo.inv_perm, is_real=topo.is_real,
                             n_tot=topo.n_tot, n_real=topo.n_real, k=topo.k,
                             lat_dst=lat.ell_dst, lat_n_tot=lat.n_tot, lat_k=lat.k)
                os.replace(tmp, path)
            except Exception:  # noqa: BLE001 — cache writes are best-effort
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return
            try:
                root = os.path.dirname(path)
                entries = []
                for name in os.listdir(root):
                    full = os.path.join(root, name)
                    if name.endswith(suffix + ".tmp"):
                        # an orphan of a killed writer: stale after an hour
                        if time.time() - os.path.getmtime(full) > 3600:
                            os.remove(full)
                    elif name.endswith(suffix):
                        entries.append(full)
                entries.sort(key=os.path.getmtime)
                for old in entries[:-keep]:
                    os.remove(old)
            except Exception:  # noqa: BLE001 — pruning is best-effort
                pass

        t = threading.Thread(target=work, name="mirror-cache-save", daemon=True)
        t.start()
        self._mirror_cache_writer = t
        return t

    def _install_topo_mirror(self, topo, k: int, cap: int, fp, validated_at: int, n_nodes: int,
                             lat=None) -> dict:
        """Upload a built ``TopoGraph`` as the active mirror, with the host
        tables the patch path splices, valid at ``validated_at`` (the
        current version for a synchronous build, the snapshot's for an async
        install, whose catch-up deltas bring it forward). ``lat`` is a
        carried lat dict, an ``EllGraph`` to materialize, or None."""
        self.mirror_rebuilds += 1
        n_tot = topo.n_tot
        node_epoch0 = torch.zeros(n_tot + 1, dtype=torch.int32, device=self.device)
        node_epoch0[n_tot] = -2
        self._topo_mirror = {
            "fp": fp,
            "cap": cap,
            "k": k,
            "validated_at": validated_at,
            "n_nodes": n_nodes,
            "n_tot": n_tot,
            "inv_perm": topo.inv_perm,
            "garrays": topo_graph_arrays(topo, self.device),
            "node_epoch0": node_epoch0,
            # original id per topo row, clipped into the dense arrays (virtual
            # rows would index past n_cap; is_real masks them)
            "perm_clipped": self._upload(np.clip(topo.perm, 0, self.n_cap).astype(np.int32)),
            "level_starts": topo.level_starts,
            "levels": len(topo.level_starts) - 1,
            # the patch path's host state: slot occupancy and row → level
            "h_in_src": topo.in_src.copy(),
            "level_starts_arr": np.asarray(topo.level_starts, dtype=np.int64),
            "passes": 0 if self.adaptive_passes else 1,
            "lat": (lat if isinstance(lat, dict)
                    else self._materialize_lat(lat) if lat is not None else None),
        }
        return self._topo_mirror

    def _materialize_lat(self, lat, node_epoch_dev=None, h_node_epoch=None) -> dict:
        """Device half of the lat mirror: upload the out-ELL id table and
        derive each slot's captured epoch from epochs of the SAME moment as
        the edge snapshot (the live ones for a synchronous build; an async
        install passes the copies taken when its rebuild started, so a node
        bumped since then shows the epoch mismatch of a dead edge). Keeps
        host copies of both tables for the patch path."""
        g = self.device_arrays()
        if node_epoch_dev is None:
            node_epoch_dev = g.node_epoch
        if h_node_epoch is None:
            h_node_epoch = self._h_node_epoch
        ell_dst = self._upload(lat.ell_dst)
        h_epoch = np.where(lat.ell_dst < lat.n_real,
                           h_node_epoch[np.clip(lat.ell_dst, 0, len(h_node_epoch) - 1)],
                           0).astype(np.int32)
        if node_epoch_dev.shape[0] == self.n_cap + 1:
            ell_epoch = ell_live_epoch_init(lat.n_real, self.n_cap)(ell_dst, node_epoch_dev)
        else:  # capacity grew since the snapshot: pay the upload
            ell_epoch = self._upload(h_epoch)
        return {
            "n_tot": lat.n_tot,
            "n_real": lat.n_real,
            "k": lat.k,
            "ell_dst": ell_dst,
            "ell_epoch": ell_epoch,
            "h_ell_dst": lat.ell_dst.copy(),
            "h_ell_epoch": h_epoch,
        }

    def start_topo_mirror_rebuild(self, k: int = 4, cap: int = 65536) -> bool:
        """Re-level the mirror in a BACKGROUND thread while bursts keep
        riding the current (patched, maybe multi-pass) one. The worker does
        host work only (``build_topo_graph``, and ``build_ell`` +
        ``widen_ell`` when the lat mirror cannot be carried); the uploads
        happen in :meth:`poll_topo_mirror_rebuild` on the calling thread.
        Deltas recorded meanwhile catch the fresh mirror up at install.
        Returns False if a rebuild is already in flight."""
        if self._async_rebuild is not None:
            return False
        src, dst, fp = self._live_edge_fingerprint()
        m = self._topo_mirror
        state = {
            "k": k,
            "cap": cap,
            "fp": fp,
            "snap_version": self._struct_version,
            "n_nodes": self.n_nodes,
            "rebuilds_at_start": self.mirror_rebuilds,
            "result": None,
            "result_lat": None,
            # a live, patched-current lat is carried instead of rebuilt
            "need_lat": not (m is not None and m.get("lat") is not None
                             and self._mirror_deltas == []
                             and m["lat"]["n_real"] == self.n_nodes),
            "error": None,
            # the epochs of the snapshot's moment: bump_epochs adds into the
            # device tensor in place, so the snapshot is a copy
            "node_epoch_dev": self.device_arrays().node_epoch.clone(),
            "h_node_epoch": self._h_node_epoch.copy(),
        }

        def work():
            try:
                state["result"] = build_topo_graph(src, dst, state["n_nodes"], k=k,
                                                   slack=self.PATCH_SLACK)
                if state["need_lat"]:
                    state["result_lat"] = widen_ell(
                        build_ell(src, dst, state["n_nodes"], k=self.LAT_K), self.PATCH_SLACK)
            except Exception as e:  # noqa: BLE001 — surfaced at poll
                state["error"] = e

        self._rebuild_deltas = []
        t = threading.Thread(target=work, name="topo-mirror-rebuild", daemon=True)
        state["thread"] = t
        self._async_rebuild = state
        t.start()
        return True

    def poll_topo_mirror_rebuild(self) -> bool:
        """Install a finished background rebuild (no-op while it runs).
        Returns True when a fresh mirror was installed by this call. A
        snapshot that a synchronous rebuild superseded is discarded."""
        st = self._async_rebuild
        if st is None or st["thread"].is_alive():
            return False
        self._async_rebuild = None
        catchup, self._rebuild_deltas = self._rebuild_deltas, None
        if st["error"] is not None:
            log.warning("async mirror rebuild failed: %s", st["error"])
            return False
        if self.mirror_rebuilds != st["rebuilds_at_start"]:
            return False
        old_m = self._topo_mirror
        old_lat = old_m.get("lat") if old_m is not None else None
        self._install_topo_mirror(st["result"], st["k"], st["cap"], st["fp"],
                                  st["snap_version"], st["n_nodes"])
        if st["result_lat"] is not None:
            self._topo_mirror["lat"] = self._materialize_lat(
                st["result_lat"], st["node_epoch_dev"], st["h_node_epoch"])
        elif old_lat is not None and catchup is not None and old_lat["n_real"] == st["n_nodes"]:
            # carried across the re-level; the catch-up replay re-applies its
            # deltas, which the duplicate checks make no-ops
            self._topo_mirror["lat"] = old_lat
        # the deltas since the snapshot bring the fresh mirror forward; a
        # broken catch-up log leaves it stale: dense until the next rebuild
        self._mirror_deltas = catchup
        return True

    def _run_lat_union(self, lat: dict, flat_ids: np.ndarray):
        """Small union wave on the lat mirror. Returns (count, newly real
        ids ascending) or None on capacity overflow (state untouched; the
        caller runs the topo sweep)."""
        g = self.device_arrays()
        ids = np.full(self.LAT_SEED_MAX, lat["n_tot"], dtype=np.int32)
        ids[: len(flat_ids)] = flat_ids
        step = ell_live_union_step(
            lat["n_tot"], lat["n_real"], self.n_cap, self.LAT_LCAP, self.LAT_CAP
        )
        _, count, acc, over = step(lat["ell_dst"], lat["ell_epoch"], g.node_epoch, g.invalid,
                                   self._upload(ids))
        if over:
            return None
        self.mirror_bursts += 1
        self.lat_waves += 1
        # acc is sorted ascending: the real ids (< n_real) are its prefix
        newly = acc[:count].cpu().numpy().astype(np.int32)
        if count:
            self.invalid_version += 1
            self._h_invalid[newly] = True
        return count, newly

    def run_waves_union_seq(self, seed_id_lists: Sequence[Sequence[int]]):
        """M independent union waves SEQUENCED on the lat mirror: wave ``i``
        sees waves ``< i``'s commits, so the final state and per-wave counts
        equal M :meth:`run_waves_union` calls. Waves that overflow the lat
        caps re-run on the topo sweep AFTER the chain (their counts reflect
        that order). Without a valid lat mirror the call is a host loop of
        :meth:`run_waves_union`. Returns (counts int64[M], union newly ids)."""
        M = len(seed_id_lists)
        if M == 0:
            return np.zeros(0, dtype=np.int64), np.empty(0, np.int32)

        def _loop_fallback():
            counts = np.zeros(M, dtype=np.int64)
            parts = []
            for i, s in enumerate(seed_id_lists):
                counts[i], ids = self.run_waves_union([s])
                parts.append(ids)
            return counts, np.concatenate(parts) if parts else np.empty(0, np.int32)

        if not self._mirror_valid():
            return _loop_fallback()
        m = self._topo_mirror
        lat = m.get("lat")
        m_nodes = m["n_nodes"]
        if (lat is None
                or any(len(s) == 0 or len(s) > self.LAT_SEED_MAX for s in seed_id_lists)
                or any(not (0 <= int(i) < m_nodes) for s in seed_id_lists for i in s)):
            return _loop_fallback()
        n_tot = lat["n_tot"]
        mat = np.full((M, self.LAT_SEED_MAX), n_tot, dtype=np.int32)
        for i, s in enumerate(seed_id_lists):
            mat[i, : len(s)] = np.asarray(s, dtype=np.int32)
        g = self.device_arrays()
        step = ell_live_union_chain_step(n_tot, lat["n_real"], self.n_cap, self.LAT_LCAP,
                                         self.LAT_CAP, self.LAT_CHAIN_OUT_CAP)
        _, counts, overs, out_ids, out_count, out_over = step(
            lat["ell_dst"], lat["ell_epoch"], g.node_epoch, g.invalid, self._upload(mat))
        self.mirror_bursts += 1
        self.lat_waves += M
        newly_ids = self._patch_host_invalid(out_count, out_ids.cpu().numpy(), out_over)
        if overs.any():
            # overflowed waves committed nothing in the chain: re-run each now
            extra = []
            for i in np.nonzero(overs)[0]:
                counts[i], ids = self.run_waves_union([seed_id_lists[int(i)]])
                extra.append(ids)
            newly_ids = np.concatenate([newly_ids, *extra])
        return counts, newly_ids

    def _run_mirror_union(self, flat_ids: np.ndarray):
        """A union burst as one topo sweep of the mirror's pass count:
        gate (dense-BFS blocking through the sweep's epochs) → sweep ×
        passes (adaptive at 0) → finish (count, compact, write back into
        the dense words)."""
        m = self._topo_mirror
        g = self.device_arrays()
        passes = m.get("passes", 1)
        self._count_adaptive(passes)
        _, count, out_ids, overflow = topo_mirror_fused_union_step(
            m["level_starts"], m["cap"], m["n_tot"], passes
        )(m["garrays"], m["node_epoch0"], m["perm_clipped"], g.invalid,
          self._upload(m["inv_perm"][flat_ids].astype(np.int32)))
        self.mirror_bursts += 1
        return count, self._patch_host_invalid(count, out_ids.cpu().numpy(), overflow)

    def run_waves_lanes(self, seed_id_lists: Sequence[Sequence[int]],
                        max_words: int = 16) -> Tuple[np.ndarray, np.ndarray]:
        """INDEPENDENT per-group cascades, 32 groups per packed word, one
        topo-mirror sweep (of the mirror's pass count) per ``32*max_words``
        groups: gate → sweep → :func:`~..ops.topo_wave.lane_finish`. Builds,
        patches or revalidates the mirror itself.

        Per-group semantics = a dense BFS from the graph's invalid state at
        the chunk boundary (groups in a chunk are snapshot-independent: two
        may both count a node; chunks apply in order). Returns (per-group
        newly counts int64[B], the union's newly-invalid BOOL MASK over node
        ids, ``n_cap + 1`` long). Several chunks on a fusible mirror ride
        the lane chain (:meth:`run_waves_lanes_chain`, ``ceil(chunks/8)``
        dispatches), as in JAX; otherwise the chunks are a loop."""
        m = self.build_topo_mirror()
        n_tot = m["n_tot"]
        B = len(seed_id_lists)
        counts = np.zeros(B, dtype=np.int64)
        union_mask = np.zeros(self.n_cap + 1, dtype=bool)
        chunk_size = 32 * max_words
        if B > chunk_size and self._mirror_valid() and m.get("passes", 1) <= self.FUSED_PASS_MAX:
            stages = [seed_id_lists[c0 : c0 + chunk_size] for c0 in range(0, B, chunk_size)]
            stage_counts, stage_masks = self.run_waves_lanes_chain(stages, max_words=max_words)
            for mask in stage_masks:
                union_mask |= mask
            return np.concatenate(stage_counts), union_mask
        any_newly = False
        for c0 in range(0, B, chunk_size):
            chunk = seed_id_lists[c0 : c0 + chunk_size]
            mat, words = pack_lane_matrix(chunk, pad_id=n_tot, n_valid=m["n_nodes"],
                                          id_map=m["inv_perm"], base_index=c0)
            g = self.device_arrays()
            passes = m.get("passes", 1)
            self._count_adaptive(passes)
            _, lane_counts, union_count, newly_w = topo_mirror_fused_lanes_step(
                m["level_starts"], n_tot, words, passes
            )(m["garrays"], m["node_epoch0"], m["perm_clipped"], g.invalid, self._upload(mat))
            self.mirror_bursts += 1
            counts[c0 : c0 + len(chunk)] = lane_counts[: len(chunk)].cpu().numpy()
            if int(union_count):
                any_newly = True
                newly = unpack_words_host(newly_w.cpu().numpy(), len(self._h_invalid))
                self._h_invalid |= newly
                union_mask |= newly
        if any_newly:
            self.invalid_version += 1
        n_chunks = max(-(-B // chunk_size), 1)
        self.last_lanes_info = {"depth": n_chunks, "dispatches": n_chunks}
        return counts, union_mask

    # ------------------------------------------------------------------ lane chains
    #: chain stages per dispatch (``dispatch_waves_lanes_chain``): a deeper
    #: chain splits into batches of this many stages, one program each
    FUSE_CHAIN_MAX = 8
    #: rounds per super-round dispatch: the whole depth is one program (one
    #: CUDA graph replay on the card); the cap bounds a runaway depth
    SUPER_DEPTH_MAX = 64

    def _fused_mirror(self, what: str) -> dict:
        """The mirror a chain or super-round runs on: built, patched or
        revalidated, valid, and at most ``FUSED_PASS_MAX`` passes; raises
        :class:`NotFusible` otherwise (callers take their counted eager path)."""
        m = self.build_topo_mirror()
        if not self._mirror_valid():
            raise NotFusible(f"topo mirror unavailable — {what} needs the fused path")
        passes = m.get("passes", 1)
        if passes > self.FUSED_PASS_MAX:
            raise NotFusible(f"mirror carries {passes} sweep passes > FUSED_PASS_MAX — "
                               f"{what} serves only the fused regime")
        self._count_adaptive(passes)
        return m

    @staticmethod
    def _mirror_fixed(m: dict) -> tuple:
        """The mirror tensors a chain body reads (a capture bakes them in)."""
        return (*m["garrays"], m["node_epoch0"], m["perm_clipped"])

    def _lanes_chain_program(self, m: dict, words: int, passes: int, shape) -> ChainProgram:
        """The resident program of a lane chain (no refresh) for one
        geometry: ``topo_mirror_fused_lanes_chain_step``'s stages."""
        level_starts, n_tot = m["level_starts"], m["n_tot"]
        key = ("lanes_chain", words, passes, n_tot, level_starts, tuple(shape))

        def make():
            chain = topo_mirror_fused_lanes_chain_step(level_starts, n_tot, words, passes,
                                                       shape[0])

            def body(g_invalid, seeds, values, valid, fixed):
                in_src, edge_epoch, is_real, node_epoch0, perm_clipped = fixed
                _, counts, masks = chain(type(m["garrays"])(in_src, edge_epoch, is_real),
                                         node_epoch0, perm_clipped, g_invalid, seeds)
                return counts, masks

            return ChainProgram(key, body, capture=passes > 0)

        return self._chain_programs.get_or_make(key, make)

    def _refresh_chain_program(self, m: dict, refresh: dict, words: int, passes: int,
                               shape) -> ChainProgram:
        """The resident burst→refresh program for one block (JAX
        ``_refresh_chain_program``; ``topo_mirror_superround_step``'s rounds):
        the chain path and the super-round share this ONE definition. Kept
        in the caller-owned ``refresh["cache"]`` keyed on everything that
        shapes it: JAX's key, plus the seed tensor's shape (depth included),
        since a CUDA graph is captured for one shape."""
        key = ("lanes_refresh_chain", words, passes, refresh["update_valid"], m["n_tot"],
               m["level_starts"], refresh["base"], refresh["n_rows"], tuple(shape))

        def make():
            step = topo_mirror_superround_step(
                m["level_starts"], m["n_tot"], words, passes, refresh["base"],
                refresh["n_rows"], refresh["fn"], refresh["update_valid"])
            n_mirror = len(self._mirror_fixed(m))

            def body(g_invalid, seeds, values, valid, fixed):
                in_src, edge_epoch, is_real, node_epoch0, perm_clipped = fixed[:n_mirror]
                out = step(values, valid, type(m["garrays"])(in_src, edge_epoch, is_real),
                           node_epoch0, perm_clipped, g_invalid, seeds, *fixed[n_mirror:])
                return out[3], out[4]

            return ChainProgram(key, body, capture=passes > 0)

        return refresh["cache"].get_or_make(key, make)

    def _run_refresh_program(self, m, refresh, words, passes, g, mats):
        prog = self._refresh_chain_program(m, refresh, words, passes, mats.shape)
        return prog.dispatch(
            g.invalid, mats, refresh["values"],
            refresh["valid_dev"] if refresh["update_valid"] else None,
            fixed=(*self._mirror_fixed(m), *refresh["largs"]))

    def dispatch_waves_lanes_chain(self, stage_groups: Sequence[Sequence[Sequence[int]]],
                                   max_words: int = 16, refresh: Optional[dict] = None) -> dict:
        """ENQUEUE ``depth`` consecutive lane bursts as
        ``ceil(depth/FUSE_CHAIN_MAX)`` programs WITHOUT reading anything
        back (stage ``i`` cascades against the words stages ``< i`` leave);
        :meth:`harvest_waves_lanes_chain` blocks on the results. On the card
        each batch is one CUDA graph replay.

        ``refresh`` folds the block's device refresh into EVERY stage (the
        burst→refresh chain of the live loop): keys ``{"base", "n_rows",
        "fn", "largs", "values", "valid_dev", "update_valid", "cache"}``
        (``cache`` holds the block's programs, ``RowBlock._dev_refresh``).
        The words, values and validity update IN PLACE as the stages run.

        Requires a fusible mirror (valid, ``passes <= FUSED_PASS_MAX``);
        raises :class:`NotFusible` otherwise. Returns the pending dict for harvest."""
        m = self._fused_mirror("chain")
        passes = m.get("passes", 1)
        n_tot = m["n_tot"]
        # one lane geometry for the whole chain: words covers the widest
        # stage, width the widest group
        words = 1
        max_groups = max((len(st) for st in stage_groups), default=1)
        while 32 * words < max_groups:
            words <<= 1
        if words > max_words:
            raise ValueError(f"a stage carries {max_groups} groups > 32*max_words="
                             f"{32 * max_words}; chunk stages before chaining")
        width = 1
        max_seeds = max((len(gr) for st in stage_groups for gr in st), default=1)
        while width < max_seeds:
            width <<= 1
        L = 32 * words

        def pack_stage(stage, base_index):
            mat, _w = pack_lane_matrix(stage, pad_id=n_tot, n_valid=m["n_nodes"],
                                       id_map=m["inv_perm"], base_index=base_index)
            out = np.full((L, width), n_tot, dtype=np.int32)
            out[: mat.shape[0], : mat.shape[1]] = mat
            return out

        batches: list = []
        group_base = 0
        for b0 in range(0, len(stage_groups), self.FUSE_CHAIN_MAX):
            batch = stage_groups[b0 : b0 + self.FUSE_CHAIN_MAX]
            parts = []
            for st in batch:
                parts.append(pack_stage(st, group_base))
                group_base += len(st)
            mats = np.stack(parts)
            g = self.device_arrays()
            if refresh is None:
                out = self._lanes_chain_program(m, words, passes, mats.shape).dispatch(
                    g.invalid, mats, fixed=self._mirror_fixed(m))
            else:
                out = self._run_refresh_program(m, refresh, words, passes, g, mats)
            self.mirror_bursts += len(batch)
            batches.append((out, [len(st) for st in batch]))
        self.last_lanes_info = {"depth": len(stage_groups), "dispatches": len(batches)}
        return {"batches": batches, "refresh": refresh, "depth": len(stage_groups),
                "dispatches": len(batches)}

    def dispatch_waves_superround(self, mats, sizes: Sequence[int], refresh: dict,
                                  words: int) -> dict:
        """ONE dispatch for a whole super-round: ``mats`` is the pre-packed
        int32[K, 32*words, S] NEW-id seed tensor (numpy, or the pinned
        buffer ``graph/superround.py`` staged while the previous super-round
        ran), so dispatch packs nothing. No batching: the whole depth is one
        program, on the card one CUDA graph replay, and the same geometry
        replays the same graph every super-round. Requires a fusible mirror;
        raises :class:`NotFusible` otherwise. Returns a pending dict for
        :meth:`harvest_waves_lanes_chain`."""
        m = self._fused_mirror("super-round")
        passes = m.get("passes", 1)
        K = int(mats.shape[0])
        if K > self.SUPER_DEPTH_MAX:
            raise ValueError(f"super-round depth {K} > SUPER_DEPTH_MAX={self.SUPER_DEPTH_MAX}")
        g = self.device_arrays()
        out = self._run_refresh_program(m, refresh, words, passes, g, mats)
        self.mirror_bursts += K
        self.last_lanes_info = {"depth": K, "dispatches": 1}
        return {"batches": [(out, list(sizes))], "refresh": refresh, "depth": K,
                "dispatches": 1}

    def harvest_waves_lanes_chain(self, pending: dict) -> Tuple[list, list]:
        """Block on a dispatched chain or super-round and fold it into the
        host mirror. Returns ``(stage_counts, stage_masks)``: per-stage
        int64 newly counts and per-stage newly BOOL masks over node ids. For
        a refresh chain the block's rows read consistent afterwards: the
        device cleared them at every stage, and the host mirror catches up
        once, at the end state. ``last_harvest_info`` keeps the split: the
        blocking read, the mask unpack, and the device time of the batches
        (CUDA events around each replay; None on the CPU)."""
        t0 = time.perf_counter()
        fetched = [(fetch_outputs(out), sizes, out) for out, sizes in pending["batches"]]
        t1 = time.perf_counter()
        stage_counts, stage_masks = [], []
        any_newly = False
        for (lane_counts, packed), sizes, _out in fetched:
            for d, size in enumerate(sizes):
                stage_counts.append(lane_counts[d, :size].astype(np.int64))
                mask = unpack_words_host(packed[d], len(self._h_invalid))
                stage_masks.append(mask)
                if mask.any():
                    any_newly = True
                    self._h_invalid |= mask
        refresh = pending["refresh"]
        if refresh is not None:
            base, n_rows = refresh["base"], refresh["n_rows"]
            self._h_invalid[base : base + n_rows] = False
            any_newly = True
        if any_newly:
            self.invalid_version += 1
        dev = [out.device_ms for _, _, out in fetched]
        self.last_harvest_info = {
            "fetch_s": t1 - t0, "unpack_s": time.perf_counter() - t1,
            "device_ms": None if any(d is None for d in dev) else sum(dev),
            "routes": [out.route for _, _, out in fetched],
        }
        return stage_counts, stage_masks

    def run_waves_lanes_chain(self, stage_groups: Sequence[Sequence[Sequence[int]]],
                              max_words: int = 16) -> Tuple[list, list]:
        """``depth`` CONSECUTIVE lane bursts — stage ``i`` cascades against
        the invalid state stages ``< i`` left — as ``ceil(depth/8)``
        programs (:meth:`dispatch_waves_lanes_chain` then
        :meth:`harvest_waves_lanes_chain`). Equal to one
        :meth:`run_waves_lanes` per stage; the dispatch count is the only
        difference. Returns (per-stage int64 counts, per-stage newly BOOL
        masks)."""
        return self.harvest_waves_lanes_chain(
            self.dispatch_waves_lanes_chain(stage_groups, max_words=max_words))

    # ------------------------------------------------------------------ readback
    def invalid_mask(self) -> np.ndarray:
        g = self.device_arrays()
        return unpack_words_host(g.invalid.cpu().numpy(), self.n_nodes)

    def invalid_ids(self) -> np.ndarray:
        return np.nonzero(self.invalid_mask())[0].astype(np.int32)

    def clear_invalid(self) -> None:
        self.invalid_version += 1
        g = self.device_arrays()
        g.invalid.zero_()
        self._h_invalid = np.zeros(self.n_cap + 1, dtype=bool)

    def compact(self) -> int:
        """Drop dead edges (epoch-mismatched) — the pruner sweep. Returns
        removed count."""
        live = (
            self._h_node_epoch[self._h_edge_dst[: self.n_edges]]
            == self._h_edge_dst_epoch[: self.n_edges]
        )
        removed = int((~live).sum())
        if removed == 0:
            return 0
        k = int(live.sum())
        for name in ("_h_edge_src", "_h_edge_dst", "_h_edge_dst_epoch"):
            arr = getattr(self, name)
            kept = arr[: self.n_edges][live]
            pad_val = self.n_cap if name != "_h_edge_dst_epoch" else -1
            arr[:k] = kept
            arr[k : self.n_edges] = pad_val
        self.n_edges = k
        self._dirty = True
        self._struct_version += 1
        return removed
