"""Sharded invalidation waves — the mesh path of the hot path.

Port of ``stl_fusion_tpu/parallel/sharded_wave.py``. The dependency graph's
nodes AND edges are sharded over a 1-D mesh (``parallel/mesh.py``), and each
BFS level exchanges the frontier with one all-gather.

Sharding layout (the JAX package's):
- nodes: block-sharded — shard d owns ids [d*n_local, (d+1)*n_local);
- edges: sharded by DESTINATION owner, so the version-match gather and the
  invalidation scatter are shard-local; only the frontier read
  (``frontier[src]`` with a GLOBAL src) needs the other shards' words.

Per shard the port keeps int32 tensors of its own: ``edge_src`` (global
ids, pad 0), ``edge_dst_local`` (pad ``n_local``), ``edge_dst_epoch``
(pad -1), ``node_epoch`` with ``n_local + 1`` slots whose dummy slot
``n_local`` holds -2, and the invalid state bit-packed into
``n_local/32 + 1`` words (the last word holds only the dummy bit, never
set). A padding edge points at the dummy slot with epoch -1, so it never
fires: the counterpart of JAX's clamped gather and dropped scatter.

One BFS level is the exchange, then ONE launch of
:func:`~..ops.wave.wave_expand_shards` for every shard (grid y = shard;
the counterpart of ``shard_map`` over the JAX ``wave_step``): each shard
reads the gathered global frontier with its global ``edge_src``, merges the
level into its own invalid words, and writes its row of one
``[n, width]`` next-frontier tensor, zeroed once per level together with
one int64 count for all shards (the ``psum``), read once per level as in
the dense wave. The shards' fixed tensors reach the kernel through a
:class:`~..ops.wave.ShardTable` built once per graph.

``exchange`` selects the frontier collective; all three give identical
results:
- ``"packed"`` (default): the shards' frontier words concatenated into one
  vector every shard reads (on a one-card mesh that is the whole
  all-gather);
- ``"ring"``: the hand-written ring all-gather kernel
  (``ops/ring_all_gather.py``) takes the first ``n_local/32`` words of each
  row of the next-frontier tensor as its 2-D input, and each shard reads
  its own copy of the result. Those UNPADDED words make the gathered vector
  exactly the global packed frontier, so a global id indexes it directly
  (the JAX layout pads each device's words to 128 lanes and indexes
  ``owner*wp + within>>5``: the same bits);
- ``"bool"``: the plain boolean all-gather (the reference exchange).

The wave follows the JAX union rule: seeds CONDUCT even when already
invalid; only fresh seeds count; invalid non-seeds block.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.bitops import pack_bits, pack_mask_host, unpack_bits, unpack_words_host
from ..ops.or_popcount import or_popcount_shards
from ..ops.ring_all_gather import ring_all_gather
from ..ops.wave import ShardTable, wave_expand_shards
from .mesh import Mesh, graph_mesh

__all__ = ["ShardedGraphArrays", "ShardedDeviceGraph", "build_sharded_wave"]

EXCHANGES = ("packed", "bool", "ring")


class ShardedGraphArrays(NamedTuple):
    """One tensor per shard in every field, all on the mesh's device."""

    edge_src: Tuple[torch.Tensor, ...]  # int32[e_shard] — GLOBAL source ids
    edge_dst_local: Tuple[torch.Tensor, ...]  # int32[e_shard] — LOCAL dest ids (pad n_local)
    edge_dst_epoch: Tuple[torch.Tensor, ...]  # int32[e_shard] — pad -1
    node_epoch: Tuple[torch.Tensor, ...]  # int32[n_local+1] — dummy slot -2
    invalid: Tuple[torch.Tensor, ...]  # int32[n_local/32 + 1] — packed bits


def _shard_words(mask: torch.Tensor, n_dev: int, n_local: int, width: int) -> torch.Tensor:
    """bool[n_global] → the shards' packed words as int32[n_dev, width]: row
    d holds shard d's n_local bits, the dummy bit and the padding clear."""
    rows = torch.nn.functional.pad(mask.view(n_dev, n_local), (0, 32 * width - n_local))
    return pack_bits(rows.reshape(-1)).view(n_dev, width)


def _make_gather(exchange: str, n_dev: int, n_local: int) -> Callable:
    """The per-level exchange: the shards' frontier rows int32[n_dev,
    width] → the global frontier's words (covering n_global bits), as one
    vector every shard reads or as one row per shard."""
    w = n_local // 32
    if exchange == "packed":
        def gather(rows):
            return rows[:, :w].contiguous().view(-1)
    elif exchange == "bool":
        def gather(rows):
            bits = unpack_bits(rows.reshape(-1), rows.numel() * 32).view(n_dev, -1)
            return pack_bits(bits[:, :n_local].reshape(-1))
    else:
        def gather(rows):
            return ring_all_gather(rows[:, :w])
    return gather


def build_sharded_wave(mesh: Mesh, n_global: int, exchange: str = "packed"):
    """The sharded wave for a mesh + node capacity.

    Returns a ``(wave, wave_chain)`` pair:
    - ``wave(seed_frontier, g, stats=None) -> (g, newly count)`` — one wave
      from a bool[n_global] seed frontier on the mesh's device; ``g``'s
      invalid words are updated IN PLACE (JAX donates them). A ``stats``
      dict receives ``levels``, the productive BFS levels;
    - ``wave_chain(seed_mat, g, reset_between) -> (g, total, counts)`` —
      one wave per row of a bool[W, n_global] seed matrix; with
      ``reset_between`` the invalid state is cleared before each wave.
      ``counts`` is int64[W] on the host.
    """
    n_dev = mesh.size
    if n_global % n_dev:
        raise ValueError("node capacity must divide evenly over the mesh")
    n_local = n_global // n_dev
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}")
    if exchange in ("packed", "ring") and n_local % 32:
        raise ValueError("packed/ring exchange needs n_local % 32 == 0")
    gather = _make_gather(exchange, n_dev, n_local)
    last: list = [None, None]  # the last graph and its ShardTable

    def shard_table(g: ShardedGraphArrays) -> ShardTable:
        if last[0] is not g:  # a table holds g's addresses: build it once per graph
            last[:] = [g, ShardTable(*g)]
        return last[1]

    def wave(seed_frontier: torch.Tensor, g: ShardedGraphArrays, stats: Optional[dict] = None):
        table = shard_table(g)
        frontier = _shard_words(seed_frontier, n_dev, n_local, table.width)
        # every seed merges and conducts; only the fresh ones count (one
        # launch for all shards)
        _, seeded = or_popcount_shards(frontier, table)
        count = levels = 0
        while True:  # at least one level: an empty frontier lights nothing
            frontier, lit = wave_expand_shards(gather(frontier), table, n_global)
            lit = int(lit)  # the psum: one host read per level
            if lit == 0:
                break
            count += lit
            levels += 1
        if stats is not None:
            stats["levels"] = levels
        return g, int(seeded) + count

    def wave_chain(seed_mat: torch.Tensor, g: ShardedGraphArrays, reset_between: bool):
        counts = []
        for row in seed_mat:
            if reset_between:
                for inv in g.invalid:
                    inv.zero_()
            g, count = wave(row, g)
            counts.append(count)
        return g, sum(counts), np.asarray(counts, dtype=np.int64)

    return wave, wave_chain


class ShardedDeviceGraph:
    """Static sharded graph for mesh waves (the bench and bridge path; the
    incremental host mirror is ``DeviceGraph``)."""

    def __init__(
        self,
        edges_src: np.ndarray,
        edges_dst: np.ndarray,
        n_nodes: int,
        mesh: Optional[Mesh] = None,
        edge_dst_epoch: Optional[np.ndarray] = None,
        exchange: str = "packed",
        node_epoch: Optional[np.ndarray] = None,
        invalid: Optional[np.ndarray] = None,
    ):
        mesh = mesh or graph_mesh()
        n_dev = mesh.size
        # n_local rounds up to a multiple of 32 so each shard's words tile
        # evenly (floor 32: an empty graph still has one word per shard)
        n_local = max(((n_nodes + n_dev - 1) // n_dev + 31) // 32 * 32, 32)
        n_global = n_local * n_dev

        src = np.asarray(edges_src, dtype=np.int32)
        dst = np.asarray(edges_dst, dtype=np.int32)
        if len(src) and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n_global):
            # the kernels index bit vectors and epochs by these ids unchecked
            raise ValueError(f"edge node ids must lie in [0, {n_global})")
        epoch = (
            np.zeros_like(dst)
            if edge_dst_epoch is None
            else np.asarray(edge_dst_epoch, dtype=np.int32)
        )
        # partition edges by destination owner; pad shards to equal length
        owner = dst // n_local
        order = np.argsort(owner, kind="stable")
        src, dst, epoch, owner = src[order], dst[order], epoch[order], owner[order]
        counts = np.bincount(owner, minlength=n_dev)
        e_shard = max(int(counts.max()), 1)
        E = n_dev * e_shard
        esrc = np.zeros(E, dtype=np.int32)
        edst_local = np.full(E, n_local, dtype=np.int32)  # pad: the dummy slot
        eepoch = np.full(E, -1, dtype=np.int32)  # pad: never version-matches
        start = 0
        for d in range(n_dev):
            k = counts[d]
            if k:
                sl = slice(d * e_shard, d * e_shard + k)
                esrc[sl] = src[start : start + k]
                edst_local[sl] = dst[start : start + k] - d * n_local
                eepoch[sl] = epoch[start : start + k]
                start += k
        # optional state import (live-graph snapshots): rows beyond n_nodes
        # keep epoch 0 / not-invalid — they have no edges to fire
        nep = np.zeros(n_global, dtype=np.int32)
        inv = np.zeros(n_global, dtype=bool)
        if node_epoch is not None:
            nep[:n_nodes] = np.asarray(node_epoch[:n_nodes], dtype=np.int32)
        if invalid is not None:
            inv[:n_nodes] = np.asarray(invalid[:n_nodes], dtype=bool)
        self._install(mesh, n_nodes, exchange, esrc, edst_local, eepoch, nep, inv)

    @classmethod
    def from_numpy_state(
        cls,
        state: Mapping[str, np.ndarray],
        mesh: Mesh,
        n_nodes: Optional[int] = None,
        exchange: str = "packed",
    ) -> "ShardedDeviceGraph":
        """Adopt a JAX ``ShardedGraphArrays``'s fields as numpy arrays
        (``jax_graph.g._asdict()`` works as it is): ``edge_src``,
        ``edge_dst_local`` and ``edge_dst_epoch`` flattened to
        ``n_dev * e_shard``, ``node_epoch[n_global]`` and
        ``invalid[n_global]``. ``n_nodes`` defaults to ``n_global``. The
        port graph computes the same next wave. Arrays are copied."""
        esrc, edst, eepoch = (
            np.array(state[k], dtype=np.int32)
            for k in ("edge_src", "edge_dst_local", "edge_dst_epoch")
        )
        nep = np.array(state["node_epoch"], dtype=np.int32)
        inv = np.array(state["invalid"], dtype=bool)
        n_dev, n_global = mesh.size, nep.shape[0]
        n_local = n_global // n_dev
        if n_global % n_dev or len(esrc) % n_dev or inv.shape != nep.shape:
            raise ValueError("from_numpy_state: arrays do not tile the mesh")
        if not (esrc.shape == edst.shape == eepoch.shape):
            raise ValueError("from_numpy_state: edge arrays must have equal length")
        if len(esrc) and (
            esrc.min() < 0 or esrc.max() >= n_global or edst.min() < 0 or edst.max() > n_local
        ):
            raise ValueError("from_numpy_state: edge ids out of range for the mesh")
        g = cls.__new__(cls)
        g._install(mesh, n_global if n_nodes is None else n_nodes, exchange,
                   esrc, edst, eepoch, nep, inv)
        return g

    def _install(self, mesh, n_nodes, exchange, esrc, edst_local, eepoch, nep, inv) -> None:
        """Upload the flat numpy layout as per-shard tensors."""
        n_dev = mesh.size
        self.mesh = mesh
        self.n_dev = n_dev
        self.n_global = nep.shape[0]
        self.n_local = self.n_global // n_dev
        self.n_nodes = n_nodes
        self.exchange = exchange
        self.e_shard = esrc.shape[0] // n_dev
        nl, es = self.n_local, self.e_shard
        self.g = ShardedGraphArrays(
            edge_src=tuple(self._upload(esrc[d * es:(d + 1) * es]) for d in range(n_dev)),
            edge_dst_local=tuple(self._upload(edst_local[d * es:(d + 1) * es]) for d in range(n_dev)),
            edge_dst_epoch=tuple(self._upload(eepoch[d * es:(d + 1) * es]) for d in range(n_dev)),
            node_epoch=tuple(
                self._upload(np.append(nep[d * nl:(d + 1) * nl], np.int32(-2)))
                for d in range(n_dev)
            ),
            invalid=tuple(self._upload(self._pack_shard(inv, d)) for d in range(n_dev)),
        )
        self._wave, self._wave_chain = build_sharded_wave(mesh, self.n_global, exchange)
        #: productive BFS levels of the last wave
        self.last_levels = 0

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → a FRESH tensor on the mesh's device (never an alias
        of the numpy buffer; see ``DeviceGraph._upload``)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.mesh.device, copy=True)

    def _pack_shard(self, mask: np.ndarray, d: int) -> np.ndarray:
        """Shard d's rows of a bool[n_global] mask → its packed words."""
        nl = self.n_local
        return pack_mask_host(np.append(mask[d * nl:(d + 1) * nl], False))

    # ------------------------------------------------------------------ waves
    def _frontier(self, ids: np.ndarray) -> torch.Tensor:
        frontier = torch.zeros(self.n_global, dtype=torch.bool, device=self.mesh.device)
        frontier[self._upload(ids)] = True
        return frontier

    def seeds_to_frontier(self, seed_ids: Sequence[int]) -> torch.Tensor:
        """Seed ids → bool[n_global] on the mesh's device. Ids index as in
        numpy: a negative id counts from the end, an id out of range raises
        ``IndexError``."""
        ids = np.asarray(seed_ids, dtype=np.int64).reshape(-1)
        ids = np.where(ids < 0, ids + self.n_global, ids)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_global):
            raise IndexError(f"seed ids out of range for {self.n_global} rows")
        return self._frontier(ids)

    def run_wave(self, seed_ids: Sequence[int]) -> int:
        return self.run_wave_frontier(self.seeds_to_frontier(seed_ids))

    def run_wave_frontier(self, frontier: torch.Tensor) -> int:
        stats: dict = {}
        self.g, count = self._wave(frontier, self.g, stats)
        self.last_levels = stats["levels"]
        return count

    def run_wave_collect(
        self, seed_ids: Sequence[int], cap: int = 65536
    ) -> Tuple[int, np.ndarray, bool]:
        """Union wave from ``seed_ids`` with an O(wave) host exchange: seed
        ids go up, the newly-invalidated GLOBAL ids come back in ascending
        order. Returns (count, newly ids, overflow); on overflow (count >
        cap) the buffer holds the first ``cap`` ids and the caller falls
        back to a mask diff. Ids outside the rows are dropped (a negative
        one counts from the end first), and only rows below ``n_nodes``
        count and come back: padding rows exist for the mesh tiling."""
        ids = np.asarray(seed_ids, dtype=np.int64).reshape(-1)
        ids = np.where(ids < 0, ids + self.n_global, ids)
        ids = ids[(ids >= 0) & (ids < self.n_global)]
        before = [inv.clone() for inv in self.g.invalid]
        self.run_wave_frontier(self._frontier(ids))
        newly = torch.cat([
            unpack_bits(inv & ~old, self.n_local) for inv, old in zip(self.g.invalid, before)
        ])[: self.n_nodes]
        found = torch.nonzero(newly).flatten()
        count = int(found.shape[0])
        out = found[:cap].to(torch.int32).cpu().numpy()
        return count, out, count > cap

    def prepare_seed_mat(self, seed_mat: np.ndarray) -> torch.Tensor:
        """Pad a bool[W, n_nodes] seed matrix to the mesh capacity and
        upload it — call once, outside any timed region."""
        W, n = seed_mat.shape
        if n < self.n_global:
            seed_mat = np.pad(seed_mat, ((0, 0), (0, self.n_global - n)))
        return self._upload(np.asarray(seed_mat, dtype=bool))

    def run_waves_chained(self, seed_mat, reset_between: bool = True) -> Tuple[int, np.ndarray]:
        """Run ``seed_mat.shape[0]`` waves; returns (total, per-wave counts
        int64[W]). ``seed_mat`` is bool[W, n_nodes-or-global] (numpy,
        uploaded per call) or a tensor from :meth:`prepare_seed_mat`."""
        if isinstance(seed_mat, np.ndarray):
            seed_mat = self.prepare_seed_mat(seed_mat)
        self.g, total, counts = self._wave_chain(seed_mat, self.g, reset_between)
        return int(total), counts

    # ------------------------------------------------------------------ readback
    def invalid_mask(self) -> np.ndarray:
        return np.concatenate([
            unpack_words_host(inv.cpu().numpy(), self.n_local) for inv in self.g.invalid
        ])[: self.n_nodes]

    def set_invalid(self, mask: np.ndarray) -> None:
        """Replace the sharded invalid state from a host mask[n_nodes-or-
        global] (the live-mirror sync path: the dense state is
        authoritative between mesh bursts)."""
        m = np.asarray(mask[: self.n_global], dtype=bool)
        inv = np.zeros(self.n_global, dtype=bool)
        inv[: len(m)] = m
        for d, words in enumerate(self.g.invalid):
            words.copy_(self._upload(self._pack_shard(inv, d)))

    def clear_invalid(self) -> None:
        for words in self.g.invalid:
            words.zero_()
