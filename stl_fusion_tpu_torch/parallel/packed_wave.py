"""Bit-packed sharded waves — ``32*words`` independent waves per mesh pass.

Port of ``stl_fusion_tpu/parallel/packed_wave.py``. Node rows block-shard
over the mesh (``parallel/mesh.py``); each row's ≤ k in-edges live beside it
(the in-ELL of ``ops/pull_wave.py::build_pull_graph``, virtual OR-collector
trees bounding the fan-in), and each BFS level is one launch of the
hand-written ``packed_pull`` kernel over every shard's rows
(``ops/packed_pull.py``): the gather of the live in-rows' frontier words,
the epoch-masked OR-fold, the merge into ``invalid``, the per-word count
and the continuation flag. On a one-card mesh of logical shards the
shards' frontier words are the row blocks of one ``[n_global, W]`` tensor,
so JAX's ``lax.all_gather`` of them is that tensor itself (the sharded
wave's ``exchange="packed"`` convention): no copy and no ring. A mesh
across cards raises in ``graph_mesh`` (ROADMAP A.10).

The port keeps one tensor per field for the whole mesh (row ``r`` belongs
to shard ``r // n_local``): ``in_src`` and ``edge_epoch`` int32
``[n_global, k]``, ``node_epoch`` int32 ``[n_global]``, ``is_real`` bool
``[n_global]`` and ``invalid`` int32 ``[n_global, W]``, updated IN PLACE
(JAX returns new arrays). Pad rows past ``n_tot`` hold pad slots at epoch
-1 and node epoch -2, so they never fire. The gated lane burst keeps its
resident blocked mask as packed words, int32 ``[ceil(n_global / 32)]``
(:meth:`PackedShardedGraph.put_blocked` owns that layout), and its epilogue
is the hand-written ``lane_finish`` kernel (``ops/topo_wave.py``) with the
identity row map.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.bitops import n_words, pack_bits, unpack_bits, unpack_words_host
from ..ops.ell_wave import widen_ell
from ..ops.packed_pull import run_pull_wave
from ..ops.pull_wave import build_pull_graph, pack_lane_matrix, pack_seed_words
from ..ops.topo_wave import lane_finish
from ..ops.wave import _bit_at
from .mesh import Mesh, graph_mesh

__all__ = ["PackedShardedGraph", "build_packed_sharded_wave"]


def build_packed_sharded_wave(mesh: Mesh):
    """The packed sharded wave for a mesh. Returns ``wave(seed_bits, in_src,
    edge_epoch, node_epoch, is_real, invalid, stats=None) -> (invalid,
    counts)``: seeds and invalid are int32 words ``[rows, W]`` (32 packed
    waves per word; the row count divides evenly over the mesh), ``invalid``
    updates IN PLACE and comes back, and ``counts`` is int32[W], per word
    the bits this call newly lit on real rows (one word's count is ≤
    32·rows, int32-safe; totals are summed in int64 on the host). k and W
    come from the shapes. ``stats`` accumulates ``levels``, ``syncs`` and
    ``early_exits`` (:func:`~..ops.packed_pull.run_pull_wave`)."""
    n_dev = mesh.size

    def wave(seed_bits, in_src, edge_epoch, node_epoch, is_real, invalid, stats=None):
        if invalid.shape[0] % n_dev:
            raise ValueError(f"packed wave: {invalid.shape[0]} rows do not divide over "
                             f"{n_dev} shards")
        counts = torch.zeros(invalid.shape[1], dtype=torch.int32, device=invalid.device)
        run_pull_wave(in_src, edge_epoch, node_epoch, is_real, seed_bits, invalid, counts,
                      stats=stats)
        return invalid, counts

    return wave


def _gated_inputs(pg: "PackedShardedGraph", seed_ids: torch.Tensor, blocked: torch.Tensor,
                  words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gated burst's prologue: the seed words ``[n_global, words]``
    (lane ``l``'s ids, a row of ``seed_ids`` padded with ``n_global``, set
    bit ``l % 32`` of word ``l // 32``) and the gated node epochs (-3 on
    blocked rows)."""
    n_global, device = pg.n_global, pg.in_src.device
    W, L = words, 32 * words
    lanes = torch.arange(L, dtype=torch.int32, device=device)
    bit_of = torch.bitwise_left_shift(torch.ones_like(lanes), lanes % 32)
    # pad ids (n_global) land in one spare row, dropped: JAX's mode="drop"
    flat = seed_ids.long() * W + (lanes // 32).long()[:, None]
    seeds = torch.zeros((n_global + 1) * W, dtype=torch.int32, device=device)
    # a lane's ids are unique and lanes own disjoint bits: the add is the OR
    seeds.index_add_(0, flat.reshape(-1), bit_of[:, None].expand(seed_ids.shape).reshape(-1))
    node_epoch = torch.where(_bit_at(blocked, pg._rows), -3, pg.node_epoch).to(torch.int32)
    return seeds[: n_global * W].view(n_global, W), node_epoch


def _gated_lane_burst(pg: "PackedShardedGraph", seed_ids: torch.Tensor, blocked: torch.Tensor,
                      words: int, stats: Optional[dict] = None):
    """The live lane burst on the mesh (JAX ``_build_gated_lane_burst``):
    ``32*words`` independent command groups cascade in one pass, gated by
    the resident ``blocked`` words: blocked rows get epoch -3, which no live
    edge's epoch matches, so they neither receive, count nor conduct, but
    seeds conduct even when blocked (the union rule). The epilogue is
    ``lane_finish`` in its identity form (row r is node r: no row map, each
    tile of 32 rows one blocked word): newly = the real rows' final bits
    where not blocked; per-lane counts, the union rows, and the union OR'ed
    into ``blocked`` IN PLACE. Returns (blocked, lane_counts
    int32[32*words], union_count 0-d int32, newly words)."""
    seeds, node_epoch = _gated_inputs(pg, seed_ids, blocked, words)
    inv = torch.zeros_like(seeds)
    counts = torch.zeros(words, dtype=torch.int32, device=seeds.device)
    run_pull_wave(pg.in_src, pg.edge_epoch, node_epoch, pg.is_real, seeds, inv, counts,
                  stats=stats)
    del seeds
    lane_counts, union_count, newly = lane_finish(inv, pg.is_real, None, blocked)
    return blocked, lane_counts, union_count, newly


class PackedShardedGraph:
    """Static mesh-sharded graph running ``32*words`` packed waves per pass."""

    def __init__(
        self,
        edges_src: np.ndarray,
        edges_dst: np.ndarray,
        n_nodes: int,
        mesh: Optional[Mesh] = None,
        k: int = 8,
        words: int = 1,
        slack: int = 0,
    ):
        self.mesh = mesh or graph_mesh()
        n_dev = self.mesh.size
        device = self.mesh.device

        ell = build_pull_graph(edges_src, edges_dst, n_nodes, k=k)
        if slack:
            # guaranteed-free in-slots per row: the live mesh mirror patches
            # structural churn in place, and a packed row would break the
            # patch on its first new in-edge
            ell = widen_ell(ell, slack)
        in_src, n_tot = ell.ell_dst, ell.n_tot
        self.n_nodes = n_nodes
        self.n_tot = n_tot
        self.k = ell.k
        self.words = words
        self.patches = 0  # in-place structural patches absorbed
        # pad rows to the mesh grid; pads are inert (epoch -1 slots)
        self.n_local = max(-(-(n_tot + 1) // n_dev), 1)
        self.n_global = self.n_local * n_dev
        if 32 * self.n_global >= 2**31:
            # per-word counts popcount-sum 32 lanes in int32 on the device;
            # beyond ~67M global rows one word's count could wrap (the same
            # guard as the JAX package's)
            raise ValueError(
                f"packed sharded count tracking is int32-limited to "
                f"<{2**31 // 32} global rows; got {self.n_global} — "
                f"use ShardedDeviceGraph (one wave per pass) at this scale"
            )

        k = self.k
        rows = np.full((self.n_global, k), n_tot, dtype=np.int32)
        rows[: n_tot + 1] = in_src
        edge_epoch = np.full((self.n_global, k), -1, dtype=np.int32)
        edge_epoch[: n_tot + 1][in_src != n_tot] = 0
        node_epoch = np.zeros(self.n_global, dtype=np.int32)
        node_epoch[n_tot:] = -2  # null + pad rows never match any edge epoch
        is_real = np.zeros(self.n_global, dtype=bool)
        is_real[:n_nodes] = True

        self.in_src = self._upload(rows)
        self.edge_epoch = self._upload(edge_epoch)
        self.node_epoch = self._upload(node_epoch)
        self.is_real = self._upload(is_real)
        # host patch truth: REAL copies (on the CPU a tensor made from a
        # numpy array may share its memory, and these mutate in place)
        self.h_in_src = rows.copy()
        self.h_edge_epoch = edge_epoch.copy()
        self.h_node_epoch = node_epoch.copy()
        self.invalid = torch.zeros((self.n_global, words), dtype=torch.int32, device=device)
        #: the identity row map (row r is node r): the gate's blocked test
        self._rows = torch.arange(self.n_global, dtype=torch.int32, device=device)
        self._wave = build_packed_sharded_wave(self.mesh)
        #: levels, host syncs and early exits of the last run_waves /
        #: run_wave_batches / run_gated_lanes call, and its waves
        self.last_stats: dict = {}

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → a FRESH tensor on the mesh's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.mesh.device, copy=True)

    # ------------------------------------------------------------------ patching
    def patch_bumps(self, node_ids: np.ndarray) -> None:
        """Recomputed nodes (RELATIVE epoch convention: the mesh mirror
        rebases epochs to 0 at build; the owner translates): +1 kills all
        live in-edges of those rows — the pull kernel has NO level order,
        so a bump is just an epoch scatter, never a re-level."""
        ids = np.unique(np.asarray(node_ids, dtype=np.int64))
        if ids.size == 0:
            return
        self.h_node_epoch[ids] += 1
        self.node_epoch.index_add_(0, self._upload(ids),
                                   torch.ones(len(ids), dtype=torch.int32,
                                              device=self.mesh.device))
        self.patches += 1

    def _splice_adds(self, u64, v64, ep_rel):
        """Place new in-edges (u → v at RELATIVE epoch) into free slots of the
        host tables: duplicates of a present (u, epoch) slot and repeats in
        the batch are dropped. Returns the rows written (sorted unique), or
        None on in-row overflow (nothing written)."""
        hd, he = self.h_in_src, self.h_edge_epoch
        pad = self.n_tot
        dup = ((hd[v64] == u64[:, None]) & (he[v64] == ep_rel[:, None])).any(axis=1)
        u, v, e = u64[~dup], v64[~dup], ep_rel[~dup]
        if u.size == 0:
            return np.empty(0, np.int64)
        order = np.lexsort((e, u, v))
        u, v, e = u[order], v[order], e[order]
        first = np.ones(len(u), dtype=bool)
        first[1:] = (v[1:] != v[:-1]) | (u[1:] != u[:-1]) | (e[1:] != e[:-1])
        u, v, e = u[first], v[first], e[first]
        idx = np.arange(len(v))
        grp_start = np.ones(len(v), dtype=bool)
        grp_start[1:] = v[1:] != v[:-1]
        rank = idx - np.maximum.accumulate(np.where(grp_start, idx, 0))
        free_cum = (hd[v] == pad).cumsum(axis=1)
        need = rank + 1
        if (free_cum[:, -1] < need).any():
            return None  # in-row overflow: cheaper to rebuild
        slot = (free_cum == need[:, None]).argmax(axis=1)
        hd[v, slot] = u
        he[v, slot] = e
        return np.unique(v)

    def _write_rows(self, rows: np.ndarray) -> None:
        """Copy the host tables' ``rows`` to the device tables."""
        if rows.size:
            idx = self._upload(rows)
            self.in_src.index_copy_(0, idx, self._upload(self.h_in_src[rows]))
            self.edge_epoch.index_copy_(0, idx, self._upload(self.h_edge_epoch[rows]))

    def patch_adds(self, u64: np.ndarray, v64: np.ndarray, ep_rel: np.ndarray) -> bool:
        """Splice new in-edges (u → v at RELATIVE captured epoch) into free
        row slots. The pull wave iterates BFS to a fixpoint, so there are no
        level violations — only slot overflow (returns False: the caller
        rebuilds)."""
        if u64.size == 0:
            return True
        rows = self._splice_adds(u64, v64, ep_rel)
        if rows is None:
            return False
        if rows.size == 0:
            return True
        self._write_rows(rows)
        self.patches += 1
        return True

    def patch_batch(
        self, bump_ids: np.ndarray, u64: np.ndarray, v64: np.ndarray, ep_rel: np.ndarray
    ) -> bool:
        """A whole burst's structural patches at once (vs one per
        :meth:`patch_bumps`/:meth:`patch_adds` call). Safe to coalesce
        because the final state is order-independent: bumps are epoch
        INCREMENTS (``bump_ids`` may repeat — each occurrence adds 1) and
        adds carry their captured epochs; duplicate detection matches the
        sequential path's. Returns False on slot overflow or unknown nodes —
        the caller rebuilds, the same contract as :meth:`patch_adds`."""
        bump_ids = np.asarray(bump_ids, dtype=np.int64)
        u64 = np.asarray(u64, dtype=np.int64)
        v64 = np.asarray(v64, dtype=np.int64)
        ep_rel = np.asarray(ep_rel, dtype=np.int64)
        n = self.n_nodes
        if bump_ids.size and int(bump_ids.max()) >= self.n_global:
            return False
        if u64.size and (int(u64.max()) >= n or int(v64.max()) >= n):
            return False
        rows = np.empty(0, np.int64)
        if u64.size:
            rows = self._splice_adds(u64, v64, ep_rel)
            if rows is None:
                return False
        if bump_ids.size:
            uniq, counts = np.unique(bump_ids, return_counts=True)
            np.add.at(self.h_node_epoch, uniq, counts.astype(np.int32))
        if not bump_ids.size and not rows.size:
            return True
        if bump_ids.size:
            self.node_epoch.index_add_(0, self._upload(bump_ids),
                                       torch.ones(len(bump_ids), dtype=torch.int32,
                                                  device=self.mesh.device))
        self._write_rows(rows)
        self.patches += 1
        return True

    # ------------------------------------------------------------------ waves
    def seeds_to_bits(self, seed_ids_per_wave: Sequence[Sequence[int]]) -> np.ndarray:
        """≤ ``32*words`` seed-id lists → int32 ``[n_global, words]`` bits."""
        bits = pack_seed_words(self.n_global, seed_ids_per_wave, words=self.words)
        return bits[:, None] if self.words == 1 else bits

    def prepare_seeds(self, seed_ids_per_wave: Sequence[Sequence[int]]) -> torch.Tensor:
        """Pack + upload seed words once, outside any timed region."""
        return self._upload(self.seeds_to_bits(seed_ids_per_wave))

    def run_waves(self, seeds) -> int:
        """Run ≤ ``32*words`` packed waves; ``seeds`` is a list of per-wave id
        lists or a tensor from :meth:`prepare_seeds`. Returns the real
        invalidations NEWLY lit by this call (bits already set in the
        persistent cumulative mask are not re-counted; int64-summed over
        lanes)."""
        if isinstance(seeds, (list, tuple)):
            seeds = self.prepare_seeds(seeds)
        self.last_stats = {"waves": 1}
        self.invalid, counts = self._wave(seeds, self.in_src, self.edge_epoch, self.node_epoch,
                                          self.is_real, self.invalid, self.last_stats)
        return int(counts.cpu().numpy().astype(np.int64).sum())

    def prepare_seed_batches(self, seed_batches: np.ndarray) -> torch.Tensor:
        """Upload stacked seed batches ``[B, n_global, W]`` — once, outside
        any timed region."""
        return self._upload(seed_batches)

    def run_wave_batches(self, seed_batches) -> Tuple[int, np.ndarray]:
        """B batches (each ``32*words`` waves, the invalid state cleared
        before each — the bench's churn model), the counts read back once.
        ``seed_batches``: ``[B, n_global, W]`` numpy (uploaded per call) or a
        tensor from :meth:`prepare_seed_batches`. Returns (total, per-batch
        counts int64[B])."""
        if isinstance(seed_batches, np.ndarray):
            seed_batches = self.prepare_seed_batches(seed_batches)
        self.last_stats = {"waves": int(seed_batches.shape[0])}
        counts = []
        for seeds in seed_batches:
            self.invalid.zero_()
            self.invalid, c = self._wave(seeds, self.in_src, self.edge_epoch, self.node_epoch,
                                         self.is_real, self.invalid, self.last_stats)
            counts.append(c)
        counts = torch.stack(counts).cpu().numpy().astype(np.int64)
        return int(counts.sum()), counts.sum(axis=1)

    def run_gated_lanes(
        self,
        seed_id_lists: Sequence[Sequence[int]],
        blocked: torch.Tensor,
        cap: int = 65536,
        max_words: int = 16,
    ):
        """INDEPENDENT per-group cascades over the mesh, gated by a
        device-resident ``blocked`` mask (packed words from
        :meth:`put_blocked` — the live graph's invalid state): the mesh face
        of ``DeviceGraph.run_waves_lanes``. Chunks of ≤ ``32*max_words``
        groups per burst (later chunks see earlier chunks' union as
        blocked). Returns (per-group counts int64[B], union newly ids in
        ascending order or None on overflow, the updated blocked mask — a
        new tensor, ``blocked`` is left as it was — and the overflow flag).
        A caller that reads the union from the blocked words passes
        ``cap=0``, and no ids are compacted.
        JAX enqueues chunk ``c+1`` before reading chunk ``c`` back; here a
        chunk's level loop syncs per group of levels anyway, so each chunk
        is read back as it finishes."""
        B = len(seed_id_lists)
        counts = np.zeros(B, dtype=np.int64)
        union_parts: list = []
        any_overflow = False
        blocked = blocked.clone()
        self.last_stats = {"waves": 0}
        for c0 in range(0, B, 32 * max_words):
            chunk = seed_id_lists[c0: c0 + 32 * max_words]
            mat, words = pack_lane_matrix(
                chunk, pad_id=self.n_global, n_valid=self.n_nodes, base_index=c0
            )
            self.last_stats["waves"] += 1
            blocked, lane_counts, count, newly = _gated_lane_burst(
                self, self._upload(mat), blocked, words, self.last_stats)
            counts[c0: c0 + len(chunk)] = lane_counts[: len(chunk)].cpu().numpy()
            count = int(count)
            if count > cap:
                any_overflow = True
            elif not any_overflow:
                ids = torch.nonzero(unpack_bits(newly, self.n_global)).flatten()
                union_parts.append(ids.to(torch.int32).cpu().numpy())
        union_ids = (
            None
            if any_overflow
            else (np.concatenate(union_parts) if union_parts else np.empty(0, np.int32))
        )
        return counts, union_ids, blocked, any_overflow

    def put_blocked(self, mask: Optional[np.ndarray] = None) -> torch.Tensor:
        """The gated-lane blocked mask in ITS layout (packed int32 words over
        ``n_global`` rows, on the mesh's device) from a host mask over [0,
        n_nodes) — one place owns the layout (mirror sync and the initial
        state); :meth:`blocked_host` reads it back. Row ``i`` is bit ``i %
        32`` of word ``i // 32``, the layout of ``DeviceGraph``'s invalid
        words, so a burst's growth of the mask ORs straight into them
        (``DeviceGraph.mark_invalid_words``)."""
        padded = np.zeros(self.n_global, dtype=bool)
        if mask is not None:
            m = np.asarray(mask[: self.n_global], dtype=bool)
            padded[: len(m)] = m
        return pack_bits(self._upload(padded))

    def blocked_host(self, blocked: torch.Tensor) -> np.ndarray:
        """A blocked mask from :meth:`put_blocked` or :meth:`run_gated_lanes`
        as bool[n_global] on the host."""
        if blocked.shape != (n_words(self.n_global),):
            raise ValueError("blocked_host: not a blocked mask of this graph")
        return unpack_words_host(blocked.cpu().numpy(), self.n_global)

    def clear_invalid(self) -> None:
        self.invalid.zero_()

    def invalid_mask(self, wave: int = 0) -> np.ndarray:
        """bool[n_nodes] for one packed wave lane."""
        w, lane = divmod(wave, 32)
        col = self.invalid[: self.n_nodes, w].cpu().numpy().astype(np.int64)
        return (col & (np.int64(1) << lane)) != 0
