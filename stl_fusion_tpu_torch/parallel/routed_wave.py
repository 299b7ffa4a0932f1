"""Cluster-routed CSR shards with a frontier exchange between shards.

Port of ``stl_fusion_tpu/parallel/routed_wave.py`` on a one-card mesh of
logical shards (``parallel/mesh.py``), the counterpart of the JAX package's
8 virtual CPU devices. Node rows live on the shard that owns their cluster
shard (:class:`~..cluster.placement.DevicePlacement`, the shard map's device
half), edges shard by DESTINATION owner, and each BFS level exchanges the
packed frontier words between shards by one of four routes:

- ``"a2a"``: each consumer shard receives from each producer ONLY the
  words its edges reference — the static per-(producer, consumer) word
  buckets of the send table. On one card the all-to-all is one
  gather of the frontier words into the ``[consumer, producer, icap]``
  receive tensor;
- ``"hier"``: the two-stage route over the ``(host, ldev)`` mesh: the same
  bucket gather within each host group, then each shard's words of the
  per-(producer host, consumer host) buckets (``hsend``), OR-reduced over
  the host group (the shards own disjoint word ranges), which every host
  reads whole (the host tree's assembly);
- ``"tree"`` and ``"gather"``: the whole packed frontier in device order,
  which on one card is the level's output itself (the recursive-doubling
  ``ppermute`` rounds assemble the same vector).

Then one launch of :func:`~..ops.routed_wave.routed_level` for every shard
(``csrc/routed_level.cu``): the per-edge source word through the
cap-independent ``(eprod, ebslot, ebit)`` routing, the version-masked fire,
the merge into the packed invalid words and each shard's newly count.
The asynchronous mode (``exchange_async``) runs ``async_depth`` speculative
local levels (the kernel's ``spec`` form, through ``elsrc``) between merge
epochs, each merge exchanging the ever-lit accumulator; a merge that fires
nothing anywhere is the quiescence vote.

**The level loop.** :meth:`RoutedShardedGraph.run_wave_collect` reads each
level's count on the host (one sync a level, the ``while_loop`` condition).
The chain (:meth:`~RoutedShardedGraph.dispatch_union_chain`) reads nothing
back: it enqueues a budget of :attr:`~RoutedShardedGraph.chain_levels`
level launches a stage, each launch returning at once when the count it
waits on (``go``) says the stage has quiesced, and a stage's seed step
skips itself (marking the stage broken) when the stage before it had not
quiesced within its budget. :meth:`~RoutedShardedGraph.harvest_union_chain`
reads every stage's counts once, finishes the first stage that had not
quiesced with host-read levels from where the device left it, re-runs the
skipped stages the same way, and reports how many it finished
(``info["host_finished"]``). The masks are those of JAX's one scan.

The node state is packed: ``g_invalid`` holds the invalid rows as int32
words, ``g_is_real`` the real rows; :meth:`invalid_mask`,
:meth:`set_invalid`, :meth:`export_shard_state` and
:meth:`import_shard_state` translate to and from JAX's bool a row at the
edge. Node epochs are int32 a row, absolute (no rebase). The newly rows of
a wave compact per shard on the device (a cumsum and a scatter, no host
sync) into ``capd`` slots a shard.

A live reshard MOVES a device shard (:meth:`apply_placement`): the moved
shard's row block moves on the device, the affected consumers' edge slices
and bucket columns re-pack on the host. Structural churn patches route by
owner (:meth:`patch_batch`). An overflowed bucket, host bucket or edge
slack grows IN PLACE (``fusion_mesh_bucket_resizes_total``), then the
resize budget runs out and the caller rebuilds: the ladder resize → resize
exhausted → rebuild, each counted. The JAX multi-process branches are the
single-process case here; ``trace_host`` is
:func:`~..diagnostics.mesh_telemetry.local_host`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cluster.placement import DevicePlacement, PlacementError
from ..diagnostics.mesh_telemetry import current_dispatch_cause, global_mesh_trace, local_host
from ..diagnostics.metrics import global_metrics, next_wave_seq
from ..diagnostics.tracing import wave_shaped_cause
from ..ops.bitops import (
    ids_to_word_masks, pack_bits, pack_mask_host, unpack_bits, unpack_words_host,
)
from ..ops.routed_wave import MODES, RoutedEdges, routed_level, routed_seed, slot_width
from .mesh import Mesh, graph_mesh

__all__ = ["RoutedShardedGraph", "build_routed_wave", "record_level_stall_ms"]

_EXCHANGES = ("a2a", "tree", "gather", "hier")
HOST_AXIS = "host"
LDEV_AXIS = "ldev"


def record_level_stall_ms(ms: float, cause: Optional[str] = None) -> None:
    """Record the level-barrier stall time an async A/B leg reclaimed
    (sync wall − async wall over the same wave schedule, clamped at 0) as
    the ``fusion_mesh_level_stall_ms`` MAX-gauge. ``cause`` (the leg's last
    traced wave) additionally records the sample into the
    ``fusion_mesh_stall_reclaim_ms`` histogram, whose exemplar ring keeps
    the wave id."""
    g = global_metrics().gauge(
        "fusion_mesh_level_stall_ms",
        help="level-barrier stall time reclaimed by the async frontier "
        "mode over an identical wave schedule (sync wall minus async "
        "wall, ms; MAX across recordings)",
    )
    g.set(float(ms))
    global_metrics().set_aggregation("fusion_mesh_level_stall_ms", "max")
    if cause is not None:
        global_metrics().histogram(
            "fusion_mesh_stall_reclaim_ms",
            help="per-recording async stall-reclaim samples; exemplars "
            "carry the reclaiming leg's wave cause id",
        ).record(float(ms), cause=cause)


class _Run:
    """One wave's level loop on the device: a seed step, then levels (sync)
    or speculative levels and merge epochs (async), counted into int64
    slots of :func:`~..ops.routed_wave.slot_width` entries."""

    def __init__(self, wave: "RoutedWave", seeds: torch.Tensor, invalid: torch.Tensor):
        self.w = wave
        self.invalid = invalid
        self.f = self.seeds = seeds  # the frontier words (n_words + 1, the last 0)
        self.acc = seeds.clone() if wave.async_depth else None
        self.slots: List[torch.Tensor] = []  # the seed slot, then one a launch
        self.merge_slots: List[int] = []  # indices of the level/merge slots
        self.spec_slots: List[int] = []
        self.spare: Optional[torch.Tensor] = None

    def _next(self) -> torch.Tensor:
        """A zeroed frontier buffer: the one the frontier before last used."""
        buf = self.spare
        if buf is None:
            buf = torch.zeros_like(self.f)
        else:
            buf.zero_()
        return buf

    def seed(self, slot: torch.Tensor, chain=None) -> None:
        w = self.w
        self.slots.append(slot)
        routed_seed(self.f, self.invalid, slot, w.n_dev, w.w_local, chain)

    def level(self, slot: torch.Tensor, go: torch.Tensor, spec: bool = False) -> None:
        """One launch: ``spec`` expands ``f`` locally; else ``f`` (sync) or
        the accumulator (async merge) is exchanged and every edge fired."""
        w = self.w
        nxt = self._next()
        if spec:
            x, stride, cross = self.f, w.w_local, None
        else:
            x, stride, cross = w.exchange(self.acc if self.acc is not None else self.f)
        if w.tap is not None:
            w.tap(len(self.slots), x, stride, cross, self, spec)
        routed_level(x, stride, cross, w.layout, w.nepoch, self.invalid, nxt, slot, go=go,
                     acc=self.acc if spec else None, spec=spec)
        if self.acc is not None and not spec:
            self.acc |= nxt
        self.slots.append(slot)
        (self.spec_slots if spec else self.merge_slots).append(len(self.slots) - 1)
        # the seed words stay as they are (a harvest may re-run the stage)
        self.spare = None if self.f is self.seeds else self.f
        self.f = nxt

    def _go(self, idx: int) -> torch.Tensor:
        """The count a launch after slot ``idx`` waits on: the seed slot's
        any-seed flag, else that slot's total."""
        n = self.w.n_dev
        return self.slots[idx][n + 1 if idx == 0 else n]

    def epoch(self, slot_of) -> None:
        """One level (sync) or one epoch of speculative levels and a merge
        (async), each launch waiting on the count before it."""
        last_merge = self.merge_slots[-1] if self.merge_slots else 0
        if self.acc is not None:
            prev = last_merge
            for _ in range(self.w.async_depth):
                self.level(slot_of(), self._go(prev), spec=True)
                prev = len(self.slots) - 1
        self.level(slot_of(), self._go(last_merge))

    def last_total(self) -> torch.Tensor:
        """The last merge's (or level's) total; the seed flag before one."""
        return self._go(self.merge_slots[-1] if self.merge_slots else 0)


class RoutedWave:
    """The routed union wave for one graph's layout (what JAX's
    :func:`build_routed_wave` compiles): the exchange, the kernel's edge
    layout and the level loops. Called as ``wave(seed_words, invalid)`` it
    runs the wave with one host read a level and returns ``(count,
    levels, spec_levels)``."""

    def __init__(self, mesh: Mesh, n_global: int, n_dev: int, exchange: str,
                 async_depth: int = 0):
        if exchange not in _EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}")
        n_local = n_global // n_dev
        assert n_local % 32 == 0
        if exchange == "tree" and (n_dev & (n_dev - 1)):
            raise ValueError("tree exchange needs a power-of-two device count")
        if exchange == "hier":
            n_hosts, dph = mesh.shape
            assert n_hosts * dph == n_dev
        else:
            n_hosts, dph = 1, n_dev
        self.exchange_name = exchange
        self.n_dev, self.n_local, self.w_local = n_dev, n_local, n_local // 32
        self.n_words = n_global // 32
        self.n_hosts, self.dph = n_hosts, dph
        self.async_depth = int(async_depth or 0)
        self.layout: Optional[RoutedEdges] = None
        self.nepoch: Optional[torch.Tensor] = None
        self.gidx: Optional[torch.Tensor] = None
        self.hidx: Optional[torch.Tensor] = None
        #: ``(slot table, merge slot indices, spec slot indices)`` of the
        #: last :meth:`run`: each launch's counts, as :meth:`_totals` read them
        self.last: Optional[tuple] = None
        #: a probe's hook: ``tap(slot index, x, x_stride, cross, run, spec)``
        #: just before each level launch, with the words it will read
        self.tap = None

    def bind(self, layout: RoutedEdges, nepoch: torch.Tensor, gidx, hidx) -> None:
        """The graph's current tensors (rebound after every upload)."""
        self.layout, self.nepoch, self.gidx, self.hidx = layout, nepoch, gidx, hidx

    def exchange(self, f: torch.Tensor):
        """One frontier exchange: the packed words (``n_words + 1``, the
        last one the pad) → (the words a shard's row of ``x`` reads, its row
        stride, the host tree's words for ``hier``)."""
        mode = self.exchange_name
        if mode in ("gather", "tree"):
            return f, 0, None
        intra = f.index_select(0, self.gidx)
        if mode == "a2a":
            return intra, self.n_dev * self.layout.icap, None
        c = f.index_select(0, self.hidx).view(self.n_hosts, self.dph, -1)
        cross = c[:, 0]
        for i in range(1, self.dph):  # disjoint word ranges: the OR is the reduction
            cross = cross | c[:, i]
        return intra, self.dph * self.layout.icap, cross.reshape(-1)

    def new_slot(self, device) -> torch.Tensor:
        return torch.zeros(slot_width(self.n_dev), dtype=torch.int64, device=device)

    def run(self, seeds: torch.Tensor, invalid: torch.Tensor, run: Optional[_Run] = None):
        """The wave with one host read a level (a merge epoch): JAX's
        ``while_loop``. ``run`` continues a chain stage where the device
        left it. Returns ``(count, levels, spec_levels)``."""
        if run is None:
            run = _Run(self, seeds, invalid)
            run.seed(self.new_slot(invalid.device))
            if int(run.slots[0][self.n_dev + 1]) == 0:
                return self._totals(run)
        elif int(run.last_total()) == 0:
            return self._totals(run)
        while True:
            run.epoch(lambda: self.new_slot(invalid.device))
            if int(run.last_total()) == 0:
                return self._totals(run)

    def __call__(self, seeds: torch.Tensor, invalid: torch.Tensor):
        return self.run(seeds, invalid)

    def _totals(self, run: _Run):
        """(count, levels, spec_levels) of a run from its slots (one read)."""
        table = torch.stack(run.slots).cpu().numpy()
        self.last = (table, list(run.merge_slots), list(run.spec_slots))
        return self.totals_of(table, run.merge_slots, run.spec_slots, self.n_dev)

    @staticmethod
    def totals_of(table: np.ndarray, merge_slots, spec_slots, n: int):
        count = int(table[:, n].sum())
        # a launch ran when the count it waited on was not 0
        levels = 0
        if table[0, n + 1]:
            for i in merge_slots:
                levels += 1
                if table[i, n] == 0:
                    break
        spec = 0
        if spec_slots:
            spec = int((table[spec_slots, :n] > 0).sum(axis=0).max())
        return count, levels, spec


def build_routed_wave(mesh: Mesh, n_global: int, n_dev: int, exchange: str,
                      async_depth: int = 0) -> RoutedWave:
    """The routed union wave for a mesh + geometry (JAX compiles it into one
    program; here the loops run on the host and each level is one
    ``routed_level`` launch). ``async_depth >= 1`` is the asynchronous mode:
    that many speculative local levels between merge epochs; ``levels``
    then counts merge epochs and ``spec_levels`` the deepest shard's
    productive speculative levels. For ``exchange="hier"`` the mesh must
    have the ``(host, ldev)`` shape. The graph binds its tensors with
    :meth:`RoutedWave.bind` before the first call."""
    return RoutedWave(mesh, n_global, n_dev, exchange, async_depth)


class RoutedShardedGraph:
    """Mesh-sharded device graph whose layout IS the cluster shard map."""

    #: level launches a chain stage enqueues before the harvest takes over
    #: on the host (sync: levels; async: speculative levels and merges)
    chain_levels = 32

    def __init__(
        self,
        edges_src: np.ndarray,
        edges_dst: np.ndarray,
        n_nodes: int,
        placement: DevicePlacement,
        mesh: Optional[Mesh] = None,
        exchange: str = "a2a",
        edge_dst_epoch: Optional[np.ndarray] = None,
        node_epoch: Optional[np.ndarray] = None,
        invalid: Optional[np.ndarray] = None,
        bucket_headroom: float = 1.3,
        edge_headroom: float = 1.3,
        max_resizes: int = 8,
        resize_growth: float = 1.5,
        exchange_async: bool = False,
        async_depth: int = 4,
    ):
        base_mesh = mesh or graph_mesh()
        if base_mesh.size != placement.n_dev:
            raise PlacementError(
                f"placement spans {placement.n_dev} devices, mesh has "
                f"{base_mesh.size}"
            )
        if exchange not in _EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}")
        #: tree requested but n_dev is not a power of two — resolved via
        #: gather, COUNTED (no silent mode swaps; same contract as the hier
        #: fallback below)
        self.tree_fallbacks = 0
        if exchange == "tree" and (placement.n_dev & (placement.n_dev - 1)):
            exchange = "gather"  # tree's xor rounds need 2^k devices
            self.tree_fallbacks = 1
            global_metrics().counter(
                "fusion_mesh_tree_fallback_total",
                help="tree exchanges resolved via gather on a non-power-of-2 "
                "device count (counted fallback, never a decline)",
            ).inc()
            from ..resilience.events import global_events

            global_events().record(
                "tree_fallback", f"n_dev={placement.n_dev}"
            )
        self.dph = placement.devices_per_host or placement.n_dev
        self.n_hosts = placement.n_dev // self.dph
        #: hier requested but the geometry can't ride the xor trees —
        #: resolved via gather instead of declining, COUNTED
        self.hier_fallbacks = 0
        if exchange == "hier" and (
            (self.dph & (self.dph - 1)) or (self.n_hosts & (self.n_hosts - 1))
        ):
            exchange = "gather"  # hier's xor trees need 2^k hosts AND dph
            self.hier_fallbacks = 1
            global_metrics().counter(
                "fusion_mesh_hier_fallback_total",
                help="hier exchanges resolved via gather on a non-power-of-2 "
                "host/device geometry (counted fallback, never a decline)",
            ).inc()
            from ..resilience.events import global_events

            global_events().record(
                "hier_fallback", f"hosts={self.n_hosts} dph={self.dph}"
            )
        if exchange == "hier":
            self.mesh = base_mesh.reshaped((self.n_hosts, self.dph), (HOST_AXIS, LDEV_AXIS))
        else:
            self.mesh = base_mesh
        self.device = self.mesh.device
        self.placement = placement
        self.exchange = exchange
        self.n_nodes = n_nodes
        self.n_dev = placement.n_dev
        self.n_local = placement.n_local
        self.n_global = placement.n_global
        self.w_local = self.n_local // 32
        self.n_words = self.n_global // 32
        #: set when a failed in-place reshard left device/host layout
        #: inconsistent — every wave entry point then refuses (rebuild)
        self.broken = False
        #: in-place capacity growth budget: once spent, an overflow falls
        #: to the REBUILD rung of the ladder (counted, never silent)
        self.max_resizes = max_resizes
        self.resize_growth = resize_growth
        self.bucket_resizes = 0
        self.resize_detail = {"bucket": 0, "hbucket": 0, "edge": 0}
        #: async frontier execution: speculative local levels between
        #: counted-quiescence merge epochs
        self.exchange_async = bool(exchange_async)
        self.async_depth = int(async_depth) if self.exchange_async else 0
        # -- telemetry --
        self.waves_run = 0
        self.levels_total = 0  # frontier exchanges (collective rounds)
        self.quiescence_checks = 0  # async merge epochs (each = one vote)
        self.spec_levels_total = 0  # deepest shard's productive spec levels
        self.shard_moves = 0
        self.cross_host_moves = 0
        self.patches = 0
        self.patch_dispatches = 0
        self.cross_host_words = 0  # cumulative words shipped across hosts
        self.cross_words_per_level = 0  # static per-exchange-level payload
        #: chain stages the harvest finished with host-read levels
        self.chain_host_finished = 0
        #: mesh trace identity: segments recorded at the host boundaries
        #: carry this host label; ``trace_cause`` lets a driver pin a
        #: mesh-wide cause; the super-round threads the backend's cause via
        #: the dispatch contextvar instead
        self.trace_host = local_host()
        self.trace_cause: Optional[str] = None
        self.last_trace_cause: Optional[str] = None

        # int32 host truth: node ids always fit (n_global is int32-bound),
        # and at 240M edges the int64 sorted copies alone were ~5 GB
        src = np.asarray(edges_src, dtype=np.int32)
        dst = np.asarray(edges_dst, dtype=np.int32)
        ep = (
            np.zeros(len(dst), dtype=np.int32)
            if edge_dst_epoch is None
            else np.asarray(edge_dst_epoch, dtype=np.int32)
        )
        # host truth: per-DST-SHARD edge lists (absolute node ids + absolute
        # captured epochs) — the unit a reshard re-partitions by owner
        ips = placement.ids_per_shard
        shard_of_dst = dst // np.int32(ips)
        # a stable sort of small integers is numpy's radix sort (O(edges))
        small = np.uint8 if placement.shard_map.n_shards <= 256 else np.int16
        if placement.shard_map.n_shards <= np.iinfo(small).max + 1:
            shard_of_dst = shard_of_dst.astype(small)
        order = np.argsort(shard_of_dst, kind="stable")
        src, dst, ep, sh = src[order], dst[order], ep[order], shard_of_dst[order]
        del order, shard_of_dst
        self._shard_edges: Dict[int, List[np.ndarray]] = {}
        if len(sh):
            bounds = np.flatnonzero(np.diff(sh)) + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [len(sh)]])
            for a, b in zip(starts, ends):
                self._shard_edges[int(sh[a])] = [src[a:b], dst[a:b], ep[a:b]]
        del sh

        # capacities sized from the initial partition + headroom
        dev_edges = np.zeros(self.n_dev, dtype=np.int64)
        for s, (es, _ed, _ee) in self._shard_edges.items():
            d = int(placement.shard_dev[s])
            if d >= 0:
                dev_edges[d] += len(es)
        self.e_cap = max(int(dev_edges.max() * edge_headroom) + 32, 64)
        self.bucket_headroom = bucket_headroom

        perm, inv_perm = placement.permutation()
        self.perm, self.inv_perm = perm, inv_perm
        self._real_rows = np.flatnonzero(inv_perm >= 0)
        self._real_nodes = inv_perm[self._real_rows]

        # node state, absolute epochs (no rebase: patches translate nothing)
        nep = np.zeros(self.n_global, dtype=np.int32)
        inv0 = np.zeros(self.n_global, dtype=bool)
        if node_epoch is not None:
            nep[perm[: len(node_epoch)][perm[: len(node_epoch)] >= 0]] = np.asarray(
                node_epoch, dtype=np.int32
            )[perm[: len(node_epoch)] >= 0]
        if invalid is not None:
            m = np.asarray(invalid, dtype=bool)
            rows = perm[: len(m)]
            ok = rows >= 0
            inv0[rows[ok]] = m[ok]
        self._h_is_real = np.zeros(self.n_global, dtype=bool)
        self._h_is_real[self._real_rows] = True

        self._wave = build_routed_wave(
            self.mesh, self.n_global, self.n_dev, self.exchange,
            async_depth=self.async_depth,
        )
        self.g_node_epoch = self._put(nep)
        del nep
        self.g_invalid = self._put(pack_mask_host(inv0))
        del inv0
        self.g_is_real = self._put(pack_mask_host(self._h_is_real))
        self._build_exchange_and_edges()
        if self.n_hosts > 1:
            g = global_metrics().gauge(
                "fusion_mesh_hosts",
                help="host processes joined into the global device mesh",
            )
            g.set(self.n_hosts)
            global_metrics().set_aggregation("fusion_mesh_hosts", "max")

    # ---------------------------------------------------------------- helpers
    def _host_of_dev(self, d) -> np.ndarray:
        return np.asarray(d) // self.dph

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Host array → a FRESH tensor on the mesh's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, copy=True)

    def _words_of_rows(self, rows: np.ndarray) -> torch.Tensor:
        """Global rows (pads ``>= n_global`` dropped) → packed words on the
        device, ``n_words + 1`` of them (the last one the exchange's pad)."""
        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[(rows >= 0) & (rows < self.n_global)]
        words = torch.zeros(self.n_words + 1, dtype=torch.int32, device=self.device)
        if len(rows):
            idx, masks = ids_to_word_masks(rows)
            words[self._put(idx)] = self._put(masks)
        return words

    # ------------------------------------------------------------------ build
    def _consumer_pack(self, d: int) -> dict:
        """Pack consumer device ``d``'s edge slice (UNPADDED) + its word
        buckets from the host per-shard edge lists. Intra buckets cover
        every producer for ``a2a`` and same-host producers for ``hier``;
        hier's cross-host edges come back as (producer host, global word)
        pairs — their ``ebslot`` is assigned against the shared host
        buckets by the caller (build: vectorized union; repack/patch:
        append-only against the live tables)."""
        pl = self.placement
        srcs: List[np.ndarray] = []
        dsts: List[np.ndarray] = []
        eps: List[np.ndarray] = []
        for s in range(pl.shard_map.n_shards):
            if int(pl.shard_dev[s]) != d:
                continue
            ent = self._shard_edges.get(s)
            if ent is None:
                continue
            srcs.append(ent[0])
            dsts.append(ent[1])
            eps.append(ent[2])
        if srcs:
            src = np.concatenate(srcs)
            dst = np.concatenate(dsts)
            ep = np.concatenate(eps)
        else:
            src = dst = np.empty(0, np.int64)
            ep = np.empty(0, np.int32)
        del srcs, dsts, eps
        src_rows = self.perm[src] if len(src) else src
        dst_rows = self.perm[dst] if len(dst) else dst
        del src, dst
        if len(src_rows) and (src_rows.min() < 0 or dst_rows.min() < 0):
            raise PlacementError("edge endpoints land on off-mesh shards")
        n_e = len(src_rows)
        words = src_rows >> 5
        eprod = np.zeros(n_e, dtype=np.int32)
        ebslot = np.zeros(n_e, dtype=np.int32)
        ebit = (src_rows & 31).astype(np.int32) if n_e else np.empty(0, np.int32)
        edst = (
            (dst_rows - d * self.n_local).astype(np.int32)
            if n_e
            else np.empty(0, np.int32)
        )
        del dst_rows
        # async speculation operates on LOCAL sources only: same-device
        # producers get their local row, remote ones the pad row (they
        # wait for a merge epoch)
        elsrc = (
            np.where(
                src_rows // self.n_local == d,
                src_rows - d * self.n_local,
                self.n_local,
            ).astype(np.int32)
            if n_e
            else np.empty(0, np.int32)
        )
        buckets: Dict[int, np.ndarray] = {}
        cross = None
        if self.exchange in ("tree", "gather"):
            if n_e:
                ebslot[:] = words.astype(np.int32)
        else:
            prod = (src_rows // self.n_local).astype(np.int64)
            my_host = d // self.dph
            if self.exchange == "hier":
                intra_sel = self._host_of_dev(prod) == my_host if n_e else np.empty(0, bool)
            else:
                intra_sel = np.ones(n_e, dtype=bool)
            for p in range(self.n_dev):
                if self.exchange == "hier" and p // self.dph != my_host:
                    continue
                sel = intra_sel & (prod == p)
                if not sel.any():
                    buckets[p] = np.empty(0, np.int64)
                    continue
                wl = words[sel] - p * self.w_local
                uniq, slots = np.unique(wl, return_inverse=True)
                buckets[p] = uniq
                eprod[sel] = p
                ebslot[sel] = slots
            if self.exchange == "hier":
                csel = ~intra_sel
                if csel.any():
                    ch = self._host_of_dev(prod[csel]).astype(np.int64)
                    eprod[csel] = (self.n_dev + ch).astype(np.int32)
                    cross = (ch, words[csel], np.flatnonzero(csel))
        return {
            "n_e": n_e,
            "eprod": eprod,
            "ebslot": ebslot,
            "ebit": ebit,
            "edst": edst,
            "elsrc": elsrc,
            "eep": ep,
            "buckets": buckets,
            "cross": cross,
        }

    def _register_pack_buckets(self, d: int, pack: dict) -> None:
        """Adopt a pack's build-time intra buckets as device ``d``'s live
        bucket truth (sorted build-time buckets: slot lookup at patch time
        is a searchsorted); patch-added slots restart empty."""
        self._buckets[d] = pack["buckets"]
        self._patch_slots[d] = {}
        self._bucket_fill[d] = {p: len(b) for p, b in pack["buckets"].items()}
        self._dev_edge_count[d] = pack["n_e"]

    def _assign_cross_slots(self, d: int, pack: dict, append: bool) -> int:
        """Resolve a pack's cross-host edges to host-bucket slots. With
        ``append=True`` (repack after a reshard) new words APPEND to the
        live buckets — existing consumers' slots never shift. Returns the
        peak fill the assignment needed (the caller grows ``hbucket_cap``
        when it exceeds it)."""
        peak = 0
        if pack["cross"] is None:
            return peak
        g = d // self.dph
        ch, cw, pos = pack["cross"]
        for h in np.unique(ch).tolist():
            key = (int(h), g)
            sel = ch == h
            wsel = cw[sel]
            hb = self._hbuckets.setdefault(key, np.empty(0, np.int64))
            pslots = self._hpatch_slots.setdefault(key, {})
            fill = self._hbucket_fill.get(key, len(hb))
            base = np.searchsorted(hb, wsel)
            base_cl = np.minimum(base, max(len(hb) - 1, 0))
            hit = (len(hb) > 0) & (hb[base_cl] == wsel) if len(hb) else np.zeros(len(wsel), bool)
            slots = np.where(hit, base_cl, -1).astype(np.int64)
            miss = np.flatnonzero(~hit)
            if len(miss):
                if not append:
                    raise PlacementError(
                        f"cross-host word missing from host bucket {key}"
                    )
                for i in miss.tolist():
                    w = int(wsel[i])
                    j = pslots.get(w)
                    if j is None:
                        j = fill
                        pslots[w] = j
                        fill += 1
                        p = w // self.w_local
                        self._hsend_writes.append((p, g, j, w - p * self.w_local))
                    slots[i] = j
            self._hbucket_fill[key] = fill
            peak = max(peak, fill)
            pack["ebslot"][pos[sel]] = slots.astype(np.int32)
        return peak

    def _build_exchange_and_edges(self) -> None:
        """(Re)build the full host-side edge partition + exchange tables and
        upload. Called at construction and on a rebuild-grade change."""
        n_dev = self.n_dev
        #: consumer dev → {producer dev → sorted build-time word bucket}
        self._buckets: Dict[int, Dict[int, np.ndarray]] = {}
        #: consumer dev → {(producer, word) → slot} for PATCH-added words
        self._patch_slots: Dict[int, Dict[Tuple[int, int], int]] = {}
        self._bucket_fill: Dict[int, Dict[int, int]] = {}
        #: hier cross-host buckets: (producer host, consumer host) →
        #: sorted build-time GLOBAL word ids (+ append-only patch slots)
        self._hbuckets: Dict[Tuple[int, int], np.ndarray] = {}
        self._hpatch_slots: Dict[Tuple[int, int], Dict[int, int]] = {}
        self._hbucket_fill: Dict[Tuple[int, int], int] = {}
        self._hsend_writes: List[Tuple[int, int, int, int]] = []
        self._dev_edge_count = np.zeros(n_dev, dtype=np.int64)
        dev_edges = np.zeros(n_dev, dtype=np.int64)
        for sh, ent in self._shard_edges.items():
            d = int(self.placement.shard_dev[sh])
            if d >= 0:
                dev_edges[d] += len(ent[0])
        if dev_edges.max(initial=0) > self.e_cap:
            # construction sizes e_cap itself; this only triggers on a
            # geometry edge case — size up front, it is not a "resize"
            self.e_cap = int(dev_edges.max()) + 32
        packs = {}
        for d in range(n_dev):
            # one pack at a time into the host mirrors; a pack keeps only
            # what the cross-host slot assignment below needs
            pack = self._consumer_pack(d)
            self._register_pack_buckets(d, pack)
            self._write_edge_slices({d: pack})
            for k in ("eprod", "ebit", "edst", "elsrc", "eep"):
                pack[k] = None
            if pack["cross"] is None:
                pack["ebslot"] = None
            packs[d] = pack
        peak = max(
            (max(f.values(), default=0) for f in self._bucket_fill.values()),
            default=0,
        )
        self.bucket_cap = max(int(peak * self.bucket_headroom) + 8, 16)
        if self.exchange == "hier":
            # host buckets: vectorized union over every consumer's cross
            # word lists, one sorted array per (producer host, consumer
            # host) pair
            per_pair: Dict[Tuple[int, int], List[np.ndarray]] = {}
            for d, pack in packs.items():
                if pack["cross"] is None:
                    continue
                g = d // self.dph
                ch, cw, _pos = pack["cross"]
                for h in np.unique(ch).tolist():
                    per_pair.setdefault((int(h), g), []).append(cw[ch == h])
            for key, parts in per_pair.items():
                hb = np.unique(np.concatenate(parts))
                self._hbuckets[key] = hb
                self._hpatch_slots[key] = {}
                self._hbucket_fill[key] = len(hb)
            hpeak = max(self._hbucket_fill.values(), default=0)
            self.hbucket_cap = max(int(hpeak * self.bucket_headroom) + 8, 16)
            for d, pack in packs.items():
                self._assign_cross_slots(d, pack, append=False)
                if pack["cross"] is not None:  # the cross edges' slots
                    pos = pack["cross"][2]
                    self._h_ebslot[d * self.e_cap + pos] = pack["ebslot"][pos]
            self._hsend_writes = []
        else:
            self.hbucket_cap = 1
        del packs
        self._rebuild_send_tables()
        self._recount_cross_words()
        self._upload_edges()

    def _rebuild_send_tables(self) -> None:
        """Materialize the send-index tables from the live bucket truth."""
        n_dev = self.n_dev
        if self.exchange == "a2a":
            send = np.full(
                (n_dev, n_dev, self.bucket_cap), self.w_local, np.int32
            )
            for d in range(n_dev):
                for p, wl in self._buckets[d].items():
                    send[p, d, : len(wl)] = wl
                for (p, w), j in self._patch_slots[d].items():
                    send[p, d, j] = w
            self._h_send = send.reshape(n_dev * n_dev, self.bucket_cap)
        elif self.exchange == "hier":
            # intra: producer p's rows are its same-host consumers by
            # LOCAL index — [n_dev * dph, icap]
            send = np.full(
                (n_dev, self.dph, self.bucket_cap), self.w_local, np.int32
            )
            for d in range(n_dev):
                c_l = d % self.dph
                for p, wl in self._buckets[d].items():
                    send[p, c_l, : len(wl)] = wl
                for (p, w), j in self._patch_slots[d].items():
                    send[p, c_l, j] = w
            self._h_send = send.reshape(n_dev * self.dph, self.bucket_cap)
        else:
            self.bucket_cap = 16  # unused; the kernel's arguments stay uniform
            self._h_send = np.zeros((n_dev, 1), np.int32)
        if self.exchange == "hier":
            # cross: device p's [n_hosts, hcap] block marks the local word
            # index of every host-bucket word IT owns (pad elsewhere; the
            # host group OR-assembles the full bucket)
            hs = np.full(
                (n_dev, self.n_hosts, self.hbucket_cap), self.w_local, np.int32
            )
            for (h, g), hb in self._hbuckets.items():
                if len(hb):
                    p = hb // self.w_local
                    hs[p, g, np.arange(len(hb))] = (hb - p * self.w_local).astype(
                        np.int32
                    )
                for w, j in self._hpatch_slots[(h, g)].items():
                    p = w // self.w_local
                    hs[p, g, j] = w - p * self.w_local
            self._h_hsend = hs.reshape(n_dev * self.n_hosts, self.hbucket_cap)
        else:
            self._h_hsend = np.zeros((self.n_dev, 1), np.int32)

    def _write_edge_slices(self, packs: Dict[int, dict]) -> None:
        """(Re)write the listed devices' fixed-width edge slices into the
        host mirrors (allocating them first when absent)."""
        if not hasattr(self, "_h_eprod") or len(self._h_eprod) != self.n_dev * self.e_cap:
            self._h_eprod = np.zeros(self.n_dev * self.e_cap, dtype=np.int32)
            self._h_ebslot = np.zeros(self.n_dev * self.e_cap, dtype=np.int32)
            self._h_ebit = np.zeros(self.n_dev * self.e_cap, dtype=np.int32)
            self._h_edst = np.full(
                self.n_dev * self.e_cap, self.n_local, dtype=np.int32
            )  # pad: dropped
            self._h_elsrc = np.full(
                self.n_dev * self.e_cap, self.n_local, dtype=np.int32
            )  # pad: never fires on the speculative level
            self._h_eep = np.full(self.n_dev * self.e_cap, -1, dtype=np.int32)
        for d, pack in packs.items():
            sl = slice(d * self.e_cap, (d + 1) * self.e_cap)
            n_e = pack["n_e"]
            self._h_eprod[sl] = 0
            self._h_ebslot[sl] = 0
            self._h_ebit[sl] = 0
            self._h_edst[sl] = self.n_local
            self._h_elsrc[sl] = self.n_local
            self._h_eep[sl] = -1
            if n_e:
                self._h_eprod[sl][:n_e] = pack["eprod"]
                self._h_ebslot[sl][:n_e] = pack["ebslot"]
                self._h_ebit[sl][:n_e] = pack["ebit"]
                self._h_edst[sl][:n_e] = pack["edst"]
                self._h_elsrc[sl][:n_e] = pack["elsrc"]
                self._h_eep[sl][:n_e] = pack["eep"]

    def _recount_cross_words(self) -> None:
        """Static per-exchange-level cross-host payload (words), per mode —
        the ``fusion_mesh_cross_host_words_total`` increment unit. Zero on
        a single-host mesh by construction. For ``hier`` this counts the
        DISTINCT reduced host-bucket words (fill)."""
        if self.n_hosts <= 1:
            self.cross_words_per_level = 0
            return
        if self.exchange == "hier":
            self.cross_words_per_level = int(sum(self._hbucket_fill.values()))
        elif self.exchange == "a2a":
            total = 0
            for d, by_p in self._bucket_fill.items():
                for p, fill in by_p.items():
                    if p // self.dph != d // self.dph:
                        total += fill
            self.cross_words_per_level = total
        else:  # tree/gather replicate the full frontier to every host
            self.cross_words_per_level = (
                (self.n_hosts - 1) * self.n_hosts * self.dph * self.w_local
            )

    def _gather_index(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """The send tables as indices into the global frontier words (the
        pad → ``n_words``, a word that is always 0): for ``a2a``
        ``[consumer, producer, icap]``, for ``hier`` the intra
        ``[consumer, local producer, icap]`` and the cross ``[producer,
        consumer host, hcap]`` tables."""
        n_dev, wl, pad = self.n_dev, self.w_local, self.n_words
        if self.exchange == "a2a":
            s = self._h_send.reshape(n_dev, n_dev, self.bucket_cap).astype(np.int64)
            base = (np.arange(n_dev, dtype=np.int64) * wl)[:, None, None]
            g = np.where(s == wl, pad, base + s)
            return np.ascontiguousarray(g.transpose(1, 0, 2)).reshape(-1).astype(np.int32), None
        if self.exchange != "hier":
            return None, None
        s = self._h_send.reshape(self.n_hosts, self.dph, self.dph, self.bucket_cap)
        s = s.astype(np.int64)
        base = (np.arange(n_dev, dtype=np.int64) * wl).reshape(self.n_hosts, self.dph, 1, 1)
        g = np.where(s == wl, pad, base + s)  # [host, p_l, c_l, j]
        intra = np.ascontiguousarray(g.transpose(0, 2, 1, 3)).reshape(-1)
        hs = self._h_hsend.reshape(n_dev, self.n_hosts, self.hbucket_cap).astype(np.int64)
        hbase = (np.arange(n_dev, dtype=np.int64) * wl)[:, None, None]
        cross = np.where(hs == wl, pad, hbase + hs).reshape(-1)
        return intra.astype(np.int32), cross.astype(np.int32)

    def _upload_edges(self) -> None:
        self.g_eprod = self._put(self._h_eprod)
        self.g_ebslot = self._put(self._h_ebslot)
        self.g_ebit = self._put(self._h_ebit)
        self.g_edst = self._put(self._h_edst)
        self.g_elsrc = self._put(self._h_elsrc)
        self.g_eep = self._put(self._h_eep)
        gidx, hidx = self._gather_index()
        self.g_gidx = None if gidx is None else self._put(gidx)
        self.g_hidx = None if hidx is None else self._put(hidx)
        self._upload_counts()

    def _upload_counts(self) -> None:
        """The live edge counts a shard and the layout the kernel reads."""
        self.g_ecount = self._put(self._dev_edge_count.astype(np.int32))
        self._layout = RoutedEdges(
            self.g_eprod, self.g_ebslot, self.g_ebit, self.g_edst, self.g_elsrc, self.g_eep,
            self.g_ecount, int(self._dev_edge_count.max(initial=0)), self.e_cap, self.n_local,
            self.n_dev, MODES[self.exchange], self.bucket_cap, self.hbucket_cap, self.dph,
            self.n_hosts,
        )
        self._wave.bind(self._layout, self.g_node_epoch, self.g_gidx, self.g_hidx)

    # ------------------------------------------------------------------ resize
    def _try_grow(self, kind: str, needed: int, upload: bool = True) -> bool:
        """Grow an overflowed capacity IN PLACE: re-allocate the host table
        with headroom and re-upload — slot assignments are cap-independent
        so NOTHING re-packs. Counted; a spent budget returns False and the
        caller takes the rebuild rung. ``upload=False`` defers the device
        re-upload to the caller (one transfer for several grows)."""
        if self.bucket_resizes >= self.max_resizes:
            global_metrics().counter(
                "fusion_mesh_resize_exhausted_total",
                help="bucket/edge-slack overflows that exhausted the in-place "
                "resize budget and fell to the rebuild rung",
            ).inc()
            return False
        if kind == "bucket":
            old = self.bucket_cap
            new = max(needed + 8, int(old * self.resize_growth) + 1)
            rows = self._h_send.shape[0]
            grown = np.full((rows, new), self.w_local, np.int32)
            grown[:, :old] = self._h_send
            self._h_send = grown
            self.bucket_cap = new
        elif kind == "hbucket":
            old = self.hbucket_cap
            new = max(needed + 8, int(old * self.resize_growth) + 1)
            rows = self._h_hsend.shape[0]
            grown = np.full((rows, new), self.w_local, np.int32)
            grown[:, :old] = self._h_hsend
            self._h_hsend = grown
            self.hbucket_cap = new
        elif kind == "edge":
            old = self.e_cap
            new = max(needed + 32, int(old * self.resize_growth) + 1)
            for name, pad in (
                ("_h_eprod", 0),
                ("_h_ebslot", 0),
                ("_h_ebit", 0),
                ("_h_edst", self.n_local),
                ("_h_elsrc", self.n_local),
                ("_h_eep", -1),
            ):
                arr = getattr(self, name)
                grown = np.full(self.n_dev * new, pad, dtype=np.int32)
                grown.reshape(self.n_dev, new)[:, :old] = arr.reshape(
                    self.n_dev, old
                )
                setattr(self, name, grown)
            self.e_cap = new
        else:  # pragma: no cover — internal misuse
            raise ValueError(kind)
        self.bucket_resizes += 1
        self.resize_detail[kind] += 1
        global_metrics().counter(
            "fusion_mesh_bucket_resizes_total",
            help="exchange-bucket / host-bucket / edge-slack capacities grown "
            "in place instead of rebuilding the routed mirror",
        ).inc()
        if upload:
            self._upload_edges()
        return True

    # ------------------------------------------------------------------ waves
    def _count_exchange(self, levels: int, spec_levels: int = 0) -> None:
        self.levels_total += levels
        if self.exchange_async and levels:
            # async mode: each merge epoch ends in exactly one counted
            # quiescence vote (the level fence that replaced the per-level
            # barrier)
            self.quiescence_checks += levels
            self.spec_levels_total += spec_levels
            global_metrics().counter(
                "fusion_mesh_quiescence_checks_total",
                help="async-mode counted quiescence votes (one per merge "
                "epoch — the fence that replaced the per-level exchange "
                "barrier)",
            ).inc(levels)
        if self.cross_words_per_level and levels:
            shipped = levels * self.cross_words_per_level
            self.cross_host_words += shipped
            global_metrics().counter(
                "fusion_mesh_cross_host_words_total",
                help="distinct reduced host-bucket frontier words per exchange "
                "level (the DCN leg's information content — what the bucket "
                "protocol exists to minimize). Wire cost runs higher: the "
                "recursive-doubling tree replicates the assembled payload "
                "~n_hosts x and ships capacity padding",
            ).inc(shipped)

    # -------------------------------------------------------- trace hooks
    #: derived per-level segments are capped per stage (coarsened by
    #: grouping, window preserved) so a deep wave cannot flood the store
    _TRACE_MAX_LEVELS = 64

    def _trace_cause_for_dispatch(self) -> Optional[str]:
        """The cause this dispatch's segments key under: the super-round's
        wave cause (contextvar) > a driver-pinned mesh-wide cause > a
        freshly minted wave-shaped cause. None when tracing is off."""
        if not global_mesh_trace().enabled:
            return None
        cause = current_dispatch_cause() or self.trace_cause
        if cause is None:
            cause = wave_shaped_cause(next_wave_seq())
        self.last_trace_cause = cause
        return cause

    def _pacing_shard(self, newly_node_ids) -> int:
        """The shard that carried most of this window's newly-invalid
        frontier — the per-host pacing attribution."""
        if newly_node_ids is None or len(newly_node_ids) == 0:
            return -1
        ips = self.placement.ids_per_shard
        counts = np.bincount(np.asarray(newly_node_ids, dtype=np.int64) // ips)
        return int(counts.argmax())

    def _trace_slice(self, store, cause, t0, t1, levels, spec, shard, level_base) -> int:
        """Record one stage's host-visible window as per-level segments.

        The measured window is divided across the counted levels (totals
        and ordering preserved; derived, never passed off as measured).
        Async mode: the speculative share first (spec_expand), then one
        quiescence_vote per merge epoch; hier sync: each level splits into
        a2a (intra-host) + tree_round (cross-host); other sync modes: one
        exchange/tree_round segment per level. Returns the next wave-wide
        level index (chains keep level numbering cumulative)."""
        window = max(t1 - t0, 0.0)
        if levels <= 0:
            store.record(cause, "spec_expand" if spec else "exchange",
                         t0, t0 + window, host=self.trace_host, shard=shard)
            return level_base
        cursor = t0
        if self.exchange_async and spec > 0:
            cut = t0 + window * (spec / (spec + levels))
            store.record(cause, "spec_expand", cursor, cut,
                         host=self.trace_host, shard=shard)
            cursor = cut
        per = max(t1 - cursor, 0.0) / levels
        step = max(1, -(-levels // self._TRACE_MAX_LEVELS))
        for first in range(0, levels, step):
            n = min(step, levels - first)
            seg0 = cursor + first * per
            seg1 = seg0 + n * per
            lvl = level_base + first
            if self.exchange_async:
                store.record(cause, "quiescence_vote", seg0, seg1,
                             host=self.trace_host, level=lvl, shard=shard)
            elif self.exchange == "hier":
                mid = (seg0 + seg1) / 2.0
                store.record(cause, "a2a", seg0, mid,
                             host=self.trace_host, level=lvl, shard=shard)
                store.record(cause, "tree_round", mid, seg1,
                             host=self.trace_host, level=lvl, shard=shard)
            else:
                phase = "tree_round" if self.exchange == "tree" else "exchange"
                store.record(cause, phase, seg0, seg1,
                             host=self.trace_host, level=lvl, shard=shard)
        return level_base + levels

    def _compact(self, inv2: torch.Tensor, inv: torch.Tensor, capd: int):
        """Per-device LOCAL newly-id compaction, on the device with no host
        sync: each shard's newly rows (``inv2 & ~inv & real``) in order into
        ``capd`` slots. Returns ``(counts int64[n_dev], bufs
        int32[n_dev, capd])``; ``counts[d] > capd`` = that shard
        overflowed (the caller mask-diffs)."""
        n = self.n_words
        newly = inv2[:n] & ~inv[:n] & self.g_is_real
        bits = unpack_bits(newly, self.n_global)
        # one scan over every shard's rows (a scan along the rows of an
        # [n_dev, n_local] view runs one block a row: ~30x slower at 80M),
        # then each shard's count before its first row taken off
        pos = torch.cumsum(bits, dim=0, dtype=torch.int32).view(self.n_dev, self.n_local)
        bits = bits.view(self.n_dev, self.n_local)
        ends = pos[:, -1]
        before = torch.cat([ends.new_zeros(1), ends[:-1]])
        pos = pos - before[:, None]
        counts = (ends - before).to(torch.int64)
        keep = bits & (pos <= capd)
        col = torch.where(keep, pos - 1, torch.full_like(pos, capd)).to(torch.int64)
        rows = torch.arange(self.n_global, dtype=torch.int32, device=self.device)
        buf = torch.full((self.n_dev, capd + 1), -1, dtype=torch.int32, device=self.device)
        buf.scatter_(1, col, rows.view(self.n_dev, self.n_local))
        return counts, buf[:, :capd]

    def _ids_of(self, counts: np.ndarray, bufs: np.ndarray) -> np.ndarray:
        return self.inv_perm[np.concatenate(
            [bufs[d, : int(counts[d])] for d in range(self.n_dev)])]

    def run_wave_collect(
        self, seed_node_ids: Sequence[int], cap: int = 65536
    ) -> Tuple[int, np.ndarray, bool]:
        """Union wave from node ids with O(wave) host exchange: seed ids up,
        compacted newly NODE ids back. Returns (count, newly node ids,
        overflow)."""
        self._check_usable()
        k = len(seed_node_ids)
        rows = np.empty(0, np.int64)
        if k:
            rows = self.perm[np.asarray(seed_node_ids, dtype=np.int64)]
            if rows.min() < 0:
                raise PlacementError("seed node lands on an off-mesh shard")
        capd = max(cap // self.n_dev, 1024)
        cause = self._trace_cause_for_dispatch()
        t0 = time.perf_counter()
        seeds = self._words_of_rows(rows)
        before = self.g_invalid.clone()
        _count, levels, spec = self._wave(seeds, self.g_invalid)
        counts, bufs = self._compact(self.g_invalid, before, capd)
        counts = counts.cpu().numpy()
        bufs = bufs.cpu().numpy()
        self.waves_run += 1
        self._count_exchange(int(levels), int(spec))
        count = int(counts.sum())
        overflow = bool((counts > capd).any())
        node_ids: Optional[np.ndarray] = None
        if not overflow:
            node_ids = self._ids_of(counts, bufs)
        if cause is not None:
            self._trace_slice(
                global_mesh_trace(), cause, t0, time.perf_counter(),
                int(levels), int(spec), self._pacing_shard(node_ids), 0,
            )
        if overflow:
            return count, np.empty(0, np.int64), True
        return count, node_ids, False

    # ------------------------------------------------------------------ chain
    def stage_union_chain(
        self, stage_seed_lists: Sequence[Sequence[int]], cap: int = 65536
    ) -> dict:
        """Host-side pack of a union chain's seed tensor — the super-round
        BACK BUFFER: perm-map and pad WITHOUT dispatching. The staged dict
        carries a (graph identity, placement epoch) token;
        :meth:`dispatch_union_chain` refuses a buffer staged against a
        permutation a reshard/rebuild has since retired (PlacementError —
        the caller re-stages, counted)."""
        K = len(stage_seed_lists)
        if K == 0:
            raise ValueError("empty chain")
        width = 1
        kmax = max((len(s) for s in stage_seed_lists), default=1)
        while width < max(kmax, 1):
            width <<= 1
        mat = np.full((K, width), self.n_global, dtype=np.int64)
        for i, seeds in enumerate(stage_seed_lists):
            if seeds:
                r = self.perm[np.asarray(seeds, dtype=np.int64)]
                if r.min() < 0:
                    raise PlacementError("seed node lands on an off-mesh shard")
                mat[i, : len(seeds)] = r
        capd = max(cap // self.n_dev, 1024)
        return {
            "mat": mat, "stages": K, "width": width, "capd": capd,
            "token": (id(self), self.placement.epoch),
        }

    def _seed_mat(self, mat: np.ndarray) -> torch.Tensor:
        """The staged rows → one seed-word row a stage on the device (one
        upload of the packed (word, mask) pairs)."""
        K = mat.shape[0]
        stride = self.n_words + 1
        out = torch.zeros((K, stride), dtype=torch.int32, device=self.device)
        idx, val = [], []
        for i in range(K):
            r = mat[i][mat[i] < self.n_global]
            if len(r):
                w, m = ids_to_word_masks(r)
                idx.append(w + i * stride)
                val.append(m)
        if idx:
            out.view(-1)[self._put(np.concatenate(idx))] = self._put(np.concatenate(val))
        return out

    def dispatch_union_chain(
        self,
        stage_seed_lists: Optional[Sequence[Sequence[int]]] = None,
        cap: int = 65536,
        staged: Optional[dict] = None,
    ) -> dict:
        """K logical union waves with NO readback: stage i cascades against
        the invalid state stages < i left (each result equals a sequential
        per-stage dispatch). Each stage enqueues its seed step and
        :attr:`chain_levels` level launches that return at once once the
        stage has quiesced, then its compaction. ``staged`` (from
        :meth:`stage_union_chain`) skips the host pack. Returns a pending
        ticket for :meth:`harvest_union_chain`; the device invalid state
        advances immediately."""
        self._check_usable()
        if staged is None:
            staged = self.stage_union_chain(stage_seed_lists, cap)
        elif staged["token"] != (id(self), self.placement.epoch):
            raise PlacementError(
                "staged seed buffer predates a reshard/rebuild — re-stage"
            )
        K, capd = staged["stages"], staged["capd"]
        trace_cause = self._trace_cause_for_dispatch()
        trace_t0 = time.perf_counter()
        wave = self._wave
        seeds = self._seed_mat(staged["mat"])
        per_epoch = 1 + self.async_depth
        epochs = max(1, self.chain_levels // per_epoch)
        n_slots = 1 + epochs * per_epoch
        slots = torch.zeros((K, n_slots, slot_width(self.n_dev)), dtype=torch.int64,
                            device=self.device)
        broken = torch.zeros(K, dtype=torch.int32, device=self.device)
        runs, befores, counts, bufs = [], [], [], []
        for i in range(K):
            befores.append(self.g_invalid.clone())
            run = _Run(wave, seeds[i], self.g_invalid)
            chain = None
            if i:
                chain = (runs[-1].last_total(), broken[i - 1], broken[i])
            run.seed(slots[i, 0], chain)
            it = iter(range(1, n_slots))
            for _ in range(epochs):
                run.epoch(lambda: slots[i, next(it)])
            c, b = self._compact(self.g_invalid, befores[-1], capd)
            counts.append(c)
            bufs.append(b)
            runs.append(run)
        return {"runs": runs, "slots": slots, "broken": broken, "befores": befores,
                "seeds": seeds, "counts": torch.stack(counts), "bufs": torch.stack(bufs),
                "stages": K, "capd": capd, "dispatches": 1,
                "trace_cause": trace_cause, "trace_t0": trace_t0}

    def harvest_union_chain(self, pending: dict) -> Tuple[np.ndarray, List[np.ndarray], dict]:
        """Block on a chain ticket: (per-stage counts, per-stage newly NODE
        id arrays, info). The first stage that had not quiesced within its
        budget finishes here with host-read levels, and the stages after
        it (which the device skipped) run the same way; ``info
        ["host_finished"]`` counts them. An overflowed stage returns
        ``None`` in its slot — the caller mask-diffs against its dense
        mirror; every overflow is COUNTED
        (``fusion_mesh_chain_overflows_total``)."""
        K, capd, n = pending["stages"], pending["capd"], self.n_dev
        runs: List[_Run] = pending["runs"]
        slots = pending["slots"].cpu().numpy()
        counts_dev = pending["counts"].cpu().numpy()
        bufs = pending["bufs"].cpu().numpy()
        levels = np.zeros(K, dtype=np.int64)
        spec = np.zeros(K, dtype=np.int64)
        host_finished = 0
        for i in range(K):
            run = runs[i]
            if host_finished:
                # the device skipped this stage (its predecessor had not
                # quiesced): run all of it here
                before = self.g_invalid.clone()
                _c, lv, sp = self._wave.run(pending["seeds"][i], self.g_invalid)
            elif slots[i, run.merge_slots[-1], n] != 0:
                # the budget ran out before quiescence: go on from there
                before = pending["befores"][i]
                _c, lv, sp = self._wave.run(None, self.g_invalid, run)
            else:
                _c, lv, sp = RoutedWave.totals_of(slots[i], run.merge_slots, run.spec_slots, n)
                levels[i], spec[i] = lv, sp
                continue
            levels[i], spec[i] = lv, sp
            c, b = self._compact(self.g_invalid, before, capd)
            counts_dev[i], bufs[i] = c.cpu().numpy(), b.cpu().numpy()
            host_finished += 1
        self.chain_host_finished += host_finished
        self.waves_run += K
        self._count_exchange(int(levels.sum()), int(spec.sum()))
        counts = counts_dev.astype(np.int64).sum(axis=1)
        stage_ids: List[Optional[np.ndarray]] = []
        overflowed = False
        for i in range(K):
            if (counts_dev[i] > capd).any():
                stage_ids.append(None)
                overflowed = True
            else:
                stage_ids.append(self._ids_of(counts_dev[i], bufs[i]))
        if overflowed:
            global_metrics().counter(
                "fusion_mesh_chain_overflows_total",
                help="fused-chain stages whose compacted newly-id buffer "
                "overflowed (recovered by one dense mask diff — counted, "
                "never silent)",
            ).inc(sum(1 for i in stage_ids if i is None))
        cause = pending.get("trace_cause")
        store = global_mesh_trace()
        if cause is not None and store.enabled:
            # the chain's dispatch→harvest window, split across stages
            # proportionally to their counted levels, then per-level within
            # each stage; level numbering runs cumulatively
            t1 = time.perf_counter()
            t0 = float(pending.get("trace_t0", t1))
            weights = np.maximum(levels + spec, 1).astype(np.float64)
            edges = np.concatenate([[0.0], np.cumsum(weights)])
            scale = max(t1 - t0, 0.0) / edges[-1] if edges[-1] else 0.0
            level_base = 0
            for i in range(K):
                level_base = self._trace_slice(
                    store, cause, t0 + edges[i] * scale, t0 + edges[i + 1] * scale,
                    int(levels[i]), int(spec[i]), self._pacing_shard(stage_ids[i]),
                    level_base,
                )
        info = {"levels": levels, "overflowed": overflowed, "trace_cause": cause,
                "host_finished": host_finished}
        return counts, stage_ids, info

    # ------------------------------------------------------------------ state
    def _rows_mask(self) -> np.ndarray:
        """The packed invalid words → bool[n_global] (one device read)."""
        return unpack_words_host(self.g_invalid.cpu().numpy(), self.n_global)

    def invalid_mask(self) -> np.ndarray:
        """bool[n_nodes] in NODE space (reads the device state once)."""
        arr = self._rows_mask()
        out = np.zeros(self.n_nodes, dtype=bool)
        out[self._real_nodes] = arr[self._real_rows]
        return out

    def _put_invalid_rows(self, inv: np.ndarray) -> None:
        self.g_invalid.copy_(self._put(pack_mask_host(inv)))

    def set_invalid(self, mask: np.ndarray) -> None:
        inv = np.zeros(self.n_global, dtype=bool)
        m = np.asarray(mask[: self.n_nodes], dtype=bool)
        rows = self.perm[: len(m)]
        ok = rows >= 0
        inv[rows[ok]] = m[ok]
        self._put_invalid_rows(inv)

    def clear_invalid(self) -> None:
        self.g_invalid.zero_()

    # ------------------------------------------------------------------ reshard
    def apply_placement(self, new_placement: DevicePlacement, moves) -> None:
        """MOVE the listed device shards to their new owners: each moved
        shard's fixed-width row block moves on the device (one gather and
        scatter of node state), and the affected consumer devices' edge
        slices + exchange buckets re-pack — affected means the old/new
        OWNER devices plus every consumer whose edges SOURCE from a moved
        shard (their slot/bucket routes reference the vacated rows). State
        for unmoved shards never moves. An overflow the in-place resize
        ladder cannot absorb raises :class:`PlacementError`, after which the
        graph is BROKEN (every wave entry point refuses) — the caller
        rebuilds. Cross-host row moves are counted separately."""
        if not moves:
            self.placement = new_placement
            return
        old_rows_l: List[np.ndarray] = []
        new_rows_l: List[np.ndarray] = []
        affected_devs: set = set()
        ips = self.placement.ids_per_shard
        for s, old_dev, new_dev in moves:
            if old_dev >= 0:
                affected_devs.add(old_dev)
            if new_dev >= 0:
                affected_devs.add(new_dev)
            if old_dev < 0 or new_dev < 0:
                # shard entering/leaving the mesh changes real-row coverage:
                # that is a rebuild-grade change, not an in-place move
                raise PlacementError(f"shard {s} crossed the mesh boundary")
            base_old = old_dev * self.n_local + int(self.placement.shard_slot[s]) * self.placement.slot_rows
            base_new = new_dev * self.n_local + int(new_placement.shard_slot[s]) * new_placement.slot_rows
            n = min(ips, self.n_nodes - s * ips)
            if n <= 0:
                continue
            old_rows_l.append(np.arange(base_old, base_old + n, dtype=np.int64))
            new_rows_l.append(np.arange(base_new, base_new + n, dtype=np.int64))
        # consumers whose edge SOURCES moved: their exchange routes point at
        # the old rows
        moved_shards = np.fromiter((m[0] for m in moves), dtype=np.int64)
        for shard, ent in self._shard_edges.items():
            d = int(new_placement.shard_dev[shard])
            if d < 0 or d in affected_devs:
                continue
            if len(ent[0]) and np.isin(ent[0] // ips, moved_shards).any():
                affected_devs.add(d)
        cross = new_placement.cross_host_moves(moves) if self.n_hosts > 1 else 0
        self.placement = new_placement
        self.perm, self.inv_perm = new_placement.permutation()
        self._real_rows = np.flatnonzero(self.inv_perm >= 0)
        self._real_nodes = self.inv_perm[self._real_rows]
        self._h_is_real = np.zeros(self.n_global, dtype=bool)
        self._h_is_real[self._real_rows] = True
        self.g_is_real = self._put(pack_mask_host(self._h_is_real))
        if old_rows_l:
            self._move_rows(np.concatenate(old_rows_l), np.concatenate(new_rows_l))
        # re-pack edges + buckets for the touched consumer devices only
        try:
            self._repack_devices(sorted(affected_devs))
        except PlacementError:
            # the state blocks already moved and some devices may be half
            # repacked — a partial rollback would LOOK usable while being
            # wrong. Mark broken; every wave entry point refuses until the
            # caller rebuilds.
            self.broken = True
            raise
        self.shard_moves += len(moves)
        if cross:
            self.cross_host_moves += cross
            global_metrics().counter(
                "fusion_mesh_cross_host_moves_total",
                help="moved device-shard row blocks that crossed a host "
                "boundary during a reshard (the DCN transfers the "
                "host-aware placement ranking minimizes)",
            ).inc(cross)

    def _move_rows(self, old_rows: np.ndarray, new_rows: np.ndarray) -> None:
        """Move node state from ``old_rows`` to ``new_rows`` on the device:
        read every moved row first, clear the old rows, then write the new
        ones (a shard may move into a slot another one leaves). Rows out of
        range are dropped, as JAX's ``mode="drop"`` scatter drops them."""
        ok = (old_rows < self.n_global) & (new_rows < self.n_global)
        po, pn = self._put(old_rows[ok]), self._put(new_rows[ok])
        ep = self.g_node_epoch
        mep = ep[po]
        ep[po] = 0
        ep[pn] = mep
        bits = unpack_bits(self.g_invalid, self.n_global)
        minv = bits[po]
        bits[po] = False
        bits[pn] = minv
        self.g_invalid.copy_(pack_bits(bits))

    def _repack_devices(self, devs: Sequence[int]) -> None:
        """Host-side re-pack of the listed consumer devices' edge slices
        and their bucket columns, then one upload. Overflow climbs the
        resize ladder first (edge slack and bucket/host-bucket capacities
        grow in place, counted); only a spent budget raises."""
        packs = {d: self._consumer_pack(d) for d in devs}
        need_e = max((p["n_e"] for p in packs.values()), default=0)
        if need_e > self.e_cap and not self._try_grow("edge", need_e, upload=False):
            raise PlacementError(
                f"edge slice {need_e} exceeds capacity {self.e_cap} and the "
                f"resize budget is spent"
            )
        for d, pack in packs.items():
            self._register_pack_buckets(d, pack)
        peak = max(
            (max(f.values(), default=0) for f in self._bucket_fill.values()),
            default=0,
        )
        if peak > self.bucket_cap and not self._try_grow("bucket", peak, upload=False):
            raise PlacementError(
                f"exchange bucket fill {peak} exceeds cap {self.bucket_cap} "
                f"and the resize budget is spent"
            )
        if self.exchange == "hier":
            self._hsend_writes = []
            hpeak = 0
            for d, pack in packs.items():
                hpeak = max(hpeak, self._assign_cross_slots(d, pack, append=True))
            if hpeak > self.hbucket_cap and not self._try_grow(
                "hbucket", hpeak, upload=False
            ):
                raise PlacementError(
                    f"host bucket fill {hpeak} exceeds cap {self.hbucket_cap} "
                    f"and the resize budget is spent"
                )
            for p, g, j, wloc in self._hsend_writes:
                self._h_hsend[p * self.n_hosts + g, j] = wloc
            self._hsend_writes = []
        # repacked consumers rewrite their send columns from bucket truth
        if self.exchange == "a2a":
            for d, pack in packs.items():
                send3 = self._h_send.reshape(self.n_dev, self.n_dev, self.bucket_cap)
                for p in range(self.n_dev):
                    col = np.full(self.bucket_cap, self.w_local, np.int32)
                    wl = self._buckets[d].get(p)
                    if wl is not None and len(wl):
                        col[: len(wl)] = wl
                    send3[p, d] = col
        elif self.exchange == "hier":
            send3 = self._h_send.reshape(self.n_dev, self.dph, self.bucket_cap)
            for d, pack in packs.items():
                c_l = d % self.dph
                my_host = d // self.dph
                for p in range(my_host * self.dph, (my_host + 1) * self.dph):
                    col = np.full(self.bucket_cap, self.w_local, np.int32)
                    wl = self._buckets[d].get(p)
                    if wl is not None and len(wl):
                        col[: len(wl)] = wl
                    send3[p, c_l] = col
        self._write_edge_slices(packs)
        self._recount_cross_words()
        self._upload_edges()

    # ------------------------------------------------------------------ patches
    def patch_batch(
        self,
        bump_ids: np.ndarray,
        add_u: np.ndarray,
        add_v: np.ndarray,
        add_ep: np.ndarray,
    ) -> bool:
        """Apply a WHOLE burst's structural patches in one device update:
        epoch bumps add (+k for k bumps of one row — final state is
        order-independent because bumps are increments and adds carry
        absolute captured epochs), new edges splice into per-device slack
        slots routed by their destination's OWNER. Exhausted slack GROWS IN
        PLACE first (edge slots, exchange buckets, host buckets — each
        counted in ``fusion_mesh_bucket_resizes_total``); returns False
        only for rebuild-grade shapes (new nodes, off-mesh endpoints) or a
        spent resize budget — after False the caller MUST rebuild."""
        self._check_usable()
        bump_rows = np.empty(0, np.int64)
        bump_counts = np.empty(0, np.int32)
        if len(bump_ids):
            ids = np.asarray(bump_ids, dtype=np.int64)
            uniq, counts = np.unique(ids, return_counts=True)
            rows = self.perm[uniq]
            if rows.min() < 0:
                return False
            bump_rows, bump_counts = rows, counts.astype(np.int32)
        e_rows = np.empty(0, np.int64)
        send_writes: List[Tuple[int, int, int, int]] = []  # (p, c, j, wl) intra
        self._hsend_writes = []
        grew = False  # defer the grow re-uploads to ONE transfer
        if len(add_u):
            u = np.asarray(add_u, dtype=np.int64)
            v = np.asarray(add_v, dtype=np.int64)
            ep = np.asarray(add_ep, dtype=np.int32)
            if (u >= self.n_nodes).any() or (v >= self.n_nodes).any():
                return False  # nodes born after the build: rebuild
            ips = self.placement.ids_per_shard
            u_rows = self.perm[u]
            v_rows = self.perm[v]
            if len(u_rows) and (u_rows.min() < 0 or v_rows.min() < 0):
                return False
            shards = v // ips
            devs = (v_rows // self.n_local).astype(np.int64)
            # pre-scan the edge slack so e_rows are computed against ONE
            # final e_cap (a mid-batch grow would mix two layouts)
            uds, ucounts = np.unique(devs, return_counts=True)
            need_e = int(
                max(
                    self._dev_edge_count[d] + k
                    for d, k in zip(uds.tolist(), ucounts.tolist())
                )
            )
            if need_e > self.e_cap:
                if not self._try_grow("edge", need_e, upload=False):
                    return False  # edge slack exhausted: rebuild rung
                grew = True
            er = []
            bucket_need = 0
            hbucket_need = 0
            for d in uds.tolist():
                sel = devs == d
                k = int(sel.sum())
                base = int(self._dev_edge_count[d])
                self._dev_edge_count[d] = base + k
                rows = d * self.e_cap + base + np.arange(k, dtype=np.int64)
                ur, vr = u_rows[sel], v_rows[sel]
                er.append(rows)
                e_bit = (ur & 31).astype(np.int32)
                e_dst = (vr - d * self.n_local).astype(np.int32)
                e_lsrc = np.where(
                    ur // self.n_local == d, ur - d * self.n_local, self.n_local
                ).astype(np.int32)
                if self.exchange in ("tree", "gather"):
                    e_prod = np.zeros(k, np.int32)
                    e_bslot = (ur >> 5).astype(np.int32)
                else:
                    prod = (ur // self.n_local).astype(np.int64)
                    wl = (ur >> 5) - prod * self.w_local
                    my_host = d // self.dph
                    prods = np.empty(k, dtype=np.int64)
                    slots = np.empty(k, dtype=np.int64)
                    built = self._buckets[d]
                    patch_slots = self._patch_slots[d]
                    fill = self._bucket_fill[d]
                    for i, (p, w) in enumerate(zip(prod.tolist(), wl.tolist())):
                        if self.exchange == "hier" and p // self.dph != my_host:
                            # cross-host edge: slot in the (H, G) host
                            # bucket, append-only
                            h = p // self.dph
                            key = (h, my_host)
                            wg = p * self.w_local + w
                            hb = self._hbuckets.get(key)
                            j = None
                            if hb is not None and len(hb):
                                pos = int(np.searchsorted(hb, wg))
                                if pos < len(hb) and hb[pos] == wg:
                                    j = pos
                            if j is None:
                                pslots = self._hpatch_slots.setdefault(key, {})
                                j = pslots.get(wg)
                                if j is None:
                                    j = self._hbucket_fill.get(
                                        key, len(hb) if hb is not None else 0
                                    )
                                    pslots[wg] = j
                                    self._hbucket_fill[key] = j + 1
                                    self._hsend_writes.append((p, my_host, j, w))
                            hbucket_need = max(hbucket_need, j + 1)
                            prods[i] = self.n_dev + h
                            slots[i] = j
                            continue
                        bucket = built.get(p)
                        j = None
                        if bucket is not None and len(bucket):
                            pos = int(np.searchsorted(bucket, w))
                            if pos < len(bucket) and bucket[pos] == w:
                                j = pos
                        if j is None:
                            j = patch_slots.get((p, w))
                        if j is None:
                            j = fill.get(p, 0)
                            patch_slots[(p, w)] = j
                            fill[p] = j + 1
                            send_writes.append((p, d, j, w))
                        bucket_need = max(bucket_need, j + 1)
                        prods[i] = p
                        slots[i] = j
                    e_prod = prods.astype(np.int32)
                    e_bslot = slots.astype(np.int32)
                # host truth for future repacks
                for s in np.unique(shards[sel]).tolist():
                    ss = sel & (shards == s)
                    ent = self._shard_edges.setdefault(
                        int(s),
                        [np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int32)],
                    )
                    ent[0] = np.concatenate([ent[0], u[ss]])
                    ent[1] = np.concatenate([ent[1], v[ss]])
                    ent[2] = np.concatenate([ent[2], ep[ss]])
                # mirror into host edge arrays
                self._h_eprod[rows] = e_prod
                self._h_ebslot[rows] = e_bslot
                self._h_ebit[rows] = e_bit
                self._h_edst[rows] = e_dst
                self._h_elsrc[rows] = e_lsrc
                self._h_eep[rows] = ep[sel]
            # bucket growth AFTER slot assignment (slots are cap-independent
            # — only the flat table rows below depend on the final caps)
            if bucket_need > self.bucket_cap:
                if not self._try_grow("bucket", bucket_need, upload=False):
                    return False
                grew = True
            if hbucket_need > self.hbucket_cap:
                if not self._try_grow("hbucket", hbucket_need, upload=False):
                    return False
                grew = True
            e_rows = np.concatenate(er) if er else e_rows
        # the send-table writes with the FINAL capacities
        for p, c, j, w in send_writes:
            if self.exchange == "a2a":
                self._h_send[p * self.n_dev + c, j] = w
            else:  # hier intra: row p*dph + local consumer index
                self._h_send[p * self.dph + c % self.dph, j] = w
        hs_writes, self._hsend_writes = self._hsend_writes, []
        for p, g, j, w in hs_writes:
            self._h_hsend[p * self.n_hosts + g, j] = w
        if send_writes or hs_writes:
            # new bucket words may be cross-host in EITHER mode — keep
            # fusion_mesh_cross_host_words_total's per-level unit honest
            self._recount_cross_words()
        if not len(bump_rows) and not len(e_rows):
            return True
        if grew:
            # one transfer of the grown tables (the edges written above
            # included), and the bumps below
            self._upload_edges()
        else:
            self._patch_device(e_rows, send_writes, hs_writes)
        if len(bump_rows):
            # a row bumped k times adds k: index_add_, never an indexed +=
            self.g_node_epoch.index_add_(0, self._put(bump_rows), self._put(bump_counts))
        self.patches += 1
        self.patch_dispatches += 1
        return True

    def _patch_device(self, e_rows: np.ndarray, send_writes, hs_writes) -> None:
        """Write the patched edge slots and exchange-table entries into the
        device tables (their shapes unchanged)."""
        if len(e_rows):
            idx = self._put(e_rows)
            for dev_t, host in ((self.g_eprod, self._h_eprod), (self.g_ebslot, self._h_ebslot),
                                (self.g_ebit, self._h_ebit), (self.g_edst, self._h_edst),
                                (self.g_elsrc, self._h_elsrc), (self.g_eep, self._h_eep)):
                dev_t[idx] = self._put(host[e_rows])
        icap, hcap = self.bucket_cap, self.hbucket_cap
        if send_writes:
            pos, val = [], []
            for p, c, j, w in send_writes:
                if self.exchange == "a2a":
                    pos.append((c * self.n_dev + p) * icap + j)
                else:
                    pos.append((c * self.dph + p % self.dph) * icap + j)
                val.append(p * self.w_local + w)
            self.g_gidx[self._put(np.asarray(pos, np.int64))] = self._put(
                np.asarray(val, np.int32))
        if hs_writes:
            pos = [(p * self.n_hosts + g) * hcap + j for p, g, j, _w in hs_writes]
            val = [p * self.w_local + w for p, _g, _j, w in hs_writes]
            self.g_hidx[self._put(np.asarray(pos, np.int64))] = self._put(
                np.asarray(val, np.int32))
        self._upload_counts()

    # ------------------------------------------------------------------ snapshots
    def export_shard_state(self, local_only: bool = False) -> dict:
        """Per-device-shard node state keyed by VIRTUAL SHARD id (the unit
        that survives a reshard): each shard's epochs and invalid rows as
        JAX keeps them (int32 and bool a row). ``local_only`` exports the
        shards whose owner is on THIS host process: all of them on one
        process."""
        ep = self.g_node_epoch.cpu().numpy()
        inv = self._rows_mask()
        pl = self.placement
        shards: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for s in range(pl.shard_map.n_shards):
            if pl.shard_dev[s] < 0:
                continue
            lo = s * pl.ids_per_shard
            n = min(pl.ids_per_shard, self.n_nodes - lo)
            if n <= 0:
                continue
            base = pl.row_of_shard(s)
            shards[s] = (ep[base : base + n].copy(), inv[base : base + n].copy())
        return {
            "epoch": pl.epoch,
            "n_nodes": self.n_nodes,
            "n_shards": pl.shard_map.n_shards,
            "shards": shards,
        }

    def import_shard_state(self, snap: dict) -> int:
        """Re-pin snapshotted shard states under THIS graph's placement.
        Returns the number of shards restored (shards the snapshot lacks
        keep their built state)."""
        pl = self.placement
        if snap.get("n_nodes") != self.n_nodes or snap.get("n_shards") != pl.shard_map.n_shards:
            # shard keying is only meaningful under the SAME (n_nodes, V)
            # geometry — restoring a wider snapshot would write past a
            # shard's slot into its neighbour's rows. Refuse.
            raise ValueError(
                f"mesh shard snapshot geometry (n_nodes={snap.get('n_nodes')}, "
                f"n_shards={snap.get('n_shards')}) does not match this graph "
                f"({self.n_nodes}, {pl.shard_map.n_shards}); cold-build instead"
            )
        ep = self.g_node_epoch.cpu().numpy().copy()
        inv = self._rows_mask().copy()
        restored = 0
        for s, (sep, sinv) in snap["shards"].items():
            s = int(s)
            if s >= pl.shard_map.n_shards or pl.shard_dev[s] < 0:
                continue
            base = pl.row_of_shard(s)
            # never write past the shard's real-id extent
            n = min(len(sep), max(self.n_nodes - s * pl.ids_per_shard, 0), pl.slot_rows)
            ep[base : base + n] = sep[:n]
            inv[base : base + n] = sinv[:n]
            restored += 1
        self.g_node_epoch.copy_(self._put(ep))
        self._put_invalid_rows(inv)
        return restored

    def _check_usable(self) -> None:
        if self.broken:
            raise PlacementError(
                "routed graph broken by a failed in-place reshard; rebuild"
            )

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "exchange": self.exchange,
            "n_dev": self.n_dev,
            "hosts": self.n_hosts,
            "devices_per_host": self.dph,
            "n_nodes": self.n_nodes,
            "n_global": self.n_global,
            "e_cap": self.e_cap,
            "bucket_cap": self.bucket_cap,
            "hbucket_cap": self.hbucket_cap,
            "placement_epoch": self.placement.epoch,
            "waves_run": self.waves_run,
            "exchange_levels_total": self.levels_total,
            "exchange_async": self.exchange_async,
            "async_depth": self.async_depth,
            "quiescence_checks": self.quiescence_checks,
            "spec_levels_total": self.spec_levels_total,
            "tree_fallbacks": self.tree_fallbacks,
            "shard_moves": self.shard_moves,
            "cross_host_moves": self.cross_host_moves,
            "patches": self.patches,
            "patch_dispatches": self.patch_dispatches,
            "bucket_resizes": self.bucket_resizes,
            "hier_fallbacks": self.hier_fallbacks,
            "resize_detail": dict(self.resize_detail),
            "cross_host_words": self.cross_host_words,
            "cross_words_per_level": self.cross_words_per_level,
        }
