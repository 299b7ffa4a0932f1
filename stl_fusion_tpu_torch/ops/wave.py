"""The invalidation wave — bit-packed sparse-BFS frontier expansion.

Port of ``stl_fusion_tpu/ops/wave.py``; the same function, level by level:

    frontier_{k+1}[d] = OR over edges (s→d): frontier_k[s]
                        AND node_epoch[d] == edge_dst_epoch   (version match)
                        AND NOT invalid[d]

Layout (all int32, on one device):
- ``edge_src[e]``, ``edge_dst[e]`` — used node → dependent; padding = n_cap
- ``edge_dst_epoch[e]`` — dependent's epoch at capture; padding = -1
- ``node_epoch[i]`` — current epoch per node, (n_cap+1,); the dummy slot -2
- ``invalid`` — the invalid set as PACKED WORDS, int32[ceil((n_cap+1)/32)]:
  node ``i`` is bit ``i & 31`` of word ``i >> 5`` (``ops/bitops.py``)

The frontier is packed the same way. Each BFS level is one kernel,
:func:`wave_expand_merge` (``csrc/wave_expand.cu``), the whole of the XLA
``wave_step``: each firing edge sets its dependent's invalid bit with an
atomic OR, and the edge that found the bit clear sets it in the next
frontier and counts it, so ``invalid |= next`` and the level's count
``popcount(next)`` come out of the same pass. :func:`wave_expand` is the
same kernel without the merge, and :func:`wave_expand_shards` is the merge
form for every shard of a one-card mesh in one launch (the sharded wave's
level, ``parallel/sharded_wave.py``).

The host reads the level count once per level: ``count == 0`` is exactly
"the frontier is empty", because ``next`` already excludes invalid nodes.
That replaces the JAX ``lax.while_loop`` condition at the same cost of one
sync per level. The seed gate, the union's seed merge and its finalize are
one ``or_popcount`` launch each (``ops/or_popcount.py``: the gate, merge
and delta forms). Bool masks appear only at the public boundaries (seed
frontiers in, newly masks out), as in the JAX package.

JAX donates the graph to each wave; the port updates ``g.invalid`` IN
PLACE and returns ``g`` for the same call shape.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .bitops import pack_bits, unpack_bits
from .or_popcount import or_popcount, or_popcount_delta, or_popcount_gate, or_popcount_plain

__all__ = [
    "GraphArrays",
    "ShardTable",
    "wave_expand",
    "wave_expand_plain",
    "wave_expand_merge",
    "wave_expand_merge_plain",
    "wave_expand_shards",
    "wave_expand_shards_plain",
    "wave_step",
    "run_wave",
    "run_wave_collect",
    "run_wave_with_stats",
    "run_waves_chained",
    "run_waves_chained_packed",
    "run_waves_union",
    "run_waves_union_packed",
    "seeds_to_frontier",
    "launches",
    "form_launches",
]

#: wave_expand kernel launches since the last reset, of every form
launches = 0
#: the same launches by form: ``pure`` (:func:`wave_expand`), ``merge``
#: (:func:`wave_expand_merge`, the dense wave's level), ``shards``
#: (:func:`wave_expand_shards`, the sharded wave's level)
form_launches = {"pure": 0, "merge": 0, "shards": 0}


class GraphArrays(NamedTuple):
    """Device-resident dependency-graph mirror (see module docstring)."""

    edge_src: torch.Tensor  # int32[e_cap]
    edge_dst: torch.Tensor  # int32[e_cap]
    edge_dst_epoch: torch.Tensor  # int32[e_cap]
    node_epoch: torch.Tensor  # int32[n_cap+1]
    invalid: torch.Tensor  # int32[ceil((n_cap+1)/32)], packed bits
    #: live edge prefix the kernels walk; None = all e_cap slots (padded
    #: slots never fire, so the answer is the same either way)
    n_live: Optional[int] = None

    @property
    def n_cap(self) -> int:
        return self.node_epoch.shape[0] - 1

    @property
    def e_cap(self) -> int:
        return self.edge_src.shape[0]

    def live_edges(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        k = self.e_cap if self.n_live is None else self.n_live
        return self.edge_src[:k], self.edge_dst[:k], self.edge_dst_epoch[:k]


def seeds_to_frontier(n_cap: int, seed_ids: torch.Tensor) -> torch.Tensor:
    """Seed id list (padded with -1) → bool frontier of size n_cap+1.
    Ids outside [0, n_cap] are dropped, as JAX's scatter drops them."""
    frontier = torch.zeros(n_cap + 1, dtype=torch.bool, device=seed_ids.device)
    ok = (seed_ids >= 0) & (seed_ids <= n_cap)
    frontier[seed_ids[ok].long()] = True
    frontier[n_cap] = False
    return frontier


# ------------------------------------------------------------------ one level
def _bit_at(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return ((words[(ids >> 5).long()] >> (ids & 31)) & 1).bool()


def wave_expand_plain(
    frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch
) -> torch.Tensor:
    """Plain PyTorch version of :func:`wave_expand`: gather the bits,
    scatter ``True`` into a bool vector (deterministic under duplicate
    indices, like JAX's scatter-max), pack again."""
    n_cap = node_epoch.shape[0] - 1
    fire = (
        _bit_at(frontier_w, edge_src)
        & (node_epoch[edge_dst.long()] == edge_dst_epoch)
        & ~_bit_at(invalid_w, edge_dst)
        & (edge_dst < n_cap)
    )
    nxt = torch.zeros(invalid_w.shape[0] * 32, dtype=torch.bool, device=invalid_w.device)
    nxt[edge_dst[fire].long()] = True
    return pack_bits(nxt)


def wave_expand_merge_plain(
    frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`wave_expand_merge`:
    :func:`wave_expand_plain`, then :func:`~.or_popcount.or_popcount_plain`
    into ``invalid_w`` in place."""
    nxt = wave_expand_plain(frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch)
    _, count = or_popcount_plain(nxt, invalid_w, out=invalid_w)
    return nxt, count


def _check_graph(invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch, device):
    for t in (invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("wave_expand: every input must be a contiguous 1-D int32 tensor")
        if t.device != device:
            raise ValueError("wave_expand: inputs must share one device")
    if invalid_w.shape[0] * 32 < node_epoch.shape[0]:
        raise ValueError("wave_expand: invalid words must cover n_cap+1 bits")
    if not (edge_src.shape == edge_dst.shape == edge_dst_epoch.shape):
        raise ValueError("wave_expand: edge arrays must have equal length")
    if device.type == "cuda" and edge_src.data_ptr() % 16:
        raise ValueError("wave_expand: edge_src must be 16-byte aligned (int4 loads)")


def _check_frontier(n_words, edge_src, n_src):
    if n_src is None:  # one reduction and a host sync: hot callers pass it
        n_src = int(edge_src.max()) + 1 if edge_src.numel() else 0
    if n_words * 32 < n_src:
        raise ValueError("wave_expand: frontier words must cover max(edge_src)+1 bits")


def _check_expand(frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch, n_src):
    if frontier_w.dtype != torch.int32 or frontier_w.dim() != 1 or not frontier_w.is_contiguous():
        raise ValueError("wave_expand: every input must be a contiguous 1-D int32 tensor")
    _check_graph(invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch, frontier_w.device)
    _check_frontier(frontier_w.shape[0], edge_src, n_src)
    if frontier_w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wave_expand: unsupported device {frontier_w.device}")


def _zeroed_next(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One zero-filled allocation (one device call) holding the next
    frontier's words int32[shape] and, after them, the level's int64 count."""
    size = math.prod(shape)
    at = size + (size & 1)  # the count is 8-byte aligned
    buf = torch.zeros(at + 2, dtype=torch.int32, device=device)
    return buf[:size].view(shape), buf[at:].view(torch.int64)[0]


def wave_expand(
    frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch,
    n_src: Optional[int] = None,
) -> torch.Tensor:
    """One BFS level on packed words → the next frontier's words.

    An edge fires when its source's frontier bit is set, the dependent's
    epoch matches the edge's captured epoch, the dependent's invalid bit
    is clear, and the dependent is not the dummy slot n_cap. The result
    holds no node that is already invalid; ``invalid_w`` is left alone
    (:func:`wave_expand_merge` merges too). A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/wave_expand.cu`` or raises.

    Sources and dependents may live in different id spaces: a shard of the
    sharded wave reads the GLOBAL frontier with global ``edge_src`` and
    writes its LOCAL invalid words through local ``edge_dst``. The frontier
    must cover ``max(edge_src)+1`` bits; ``n_src`` is a bound on that
    count which a caller that built the edges already knows (the dense
    graph's ``n_cap+1``, the mesh's ``n_global``), so the check costs no
    device reduction. On the card ``edge_src`` must be 16-byte aligned (the
    kernel reads it as int4).
    """
    global launches
    _check_expand(frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch, n_src)
    if frontier_w.device.type == "cpu":
        return wave_expand_plain(
            frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch
        )
    nxt = torch.zeros_like(invalid_w)
    _build.launch(
        "wave_expand", "wave_expand_launch", frontier_w.data_ptr(), invalid_w.data_ptr(),
        node_epoch.data_ptr(), edge_src.data_ptr(), edge_dst.data_ptr(),
        edge_dst_epoch.data_ptr(), nxt.data_ptr(), edge_src.shape[0],
        node_epoch.shape[0] - 1,
    )
    launches += 1
    form_launches["pure"] += 1
    return nxt


def wave_expand_merge(
    frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch,
    n_src: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One whole BFS level, the JAX ``wave_step``: :func:`wave_expand`, then
    ``invalid_w |= next`` IN PLACE. Returns (next words, the level's count
    ``popcount(next)`` as a 0-d int64). On the card one launch does all of
    it: a firing edge into ``d`` sets ``d``'s invalid bit atomically and
    only the edge that found it clear sets ``d`` in ``next`` and counts."""
    global launches
    _check_expand(frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch, n_src)
    if frontier_w.device.type == "cpu":
        return wave_expand_merge_plain(
            frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch
        )
    nxt, count = _zeroed_next(invalid_w.shape, invalid_w.device)
    _build.launch(
        "wave_expand", "wave_expand_merge_launch", frontier_w.data_ptr(),
        invalid_w.data_ptr(), node_epoch.data_ptr(), edge_src.data_ptr(),
        edge_dst.data_ptr(), edge_dst_epoch.data_ptr(), nxt.data_ptr(),
        edge_src.shape[0], node_epoch.shape[0] - 1, count.data_ptr(),
    )
    launches += 1
    form_launches["merge"] += 1
    return nxt, count


class ShardTable:
    """The fixed tensors of a one-card mesh's shards, for
    :func:`wave_expand_shards`: per shard ``edge_src`` (global ids),
    ``edge_dst`` (local ids), ``edge_dst_epoch``, ``node_epoch`` (its last
    slot the dummy) and the packed ``invalid`` words, which the level
    updates IN PLACE, so their addresses stay valid. Built once per graph:
    on the card it uploads one int64[n, 8] table of their addresses and
    sizes, the rows the kernel reads (``csrc/wave_expand.cu``, ``Shard``).

    ``width`` is the row width of the next-frontier tensor: the shards'
    invalid word count rounded up to 4 words, so every row is 16-byte
    aligned. ``invalid_aligned``: every shard's invalid words start on 16
    bytes (the int4 loads of :func:`~.or_popcount.or_popcount_shards`)."""

    def __init__(self, edge_src, edge_dst, edge_dst_epoch, node_epoch, invalid):
        self.shards = tuple(
            GraphArrays(*t) for t in zip(edge_src, edge_dst, edge_dst_epoch, node_epoch, invalid)
        )
        if not self.shards:
            raise ValueError("wave_expand: a shard table needs at least one shard")
        self.device = self.shards[0].invalid.device
        self.words = self.shards[0].invalid.shape[0]
        for s in self.shards:
            _check_graph(s.invalid, s.node_epoch, s.edge_src, s.edge_dst, s.edge_dst_epoch,
                         self.device)
            if s.invalid.shape[0] != self.words:
                raise ValueError("wave_expand: every shard must have as many invalid words")
        self.width = (self.words + 3) // 4 * 4
        self.invalid_aligned = all(s.invalid.data_ptr() % 16 == 0 for s in self.shards)
        self.max_edges = max(s.e_cap for s in self.shards)
        self.table = None
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"wave_expand: unsupported device {self.device}")
        if self.device.type == "cuda":
            rows = [[s.edge_src.data_ptr(), s.edge_dst.data_ptr(), s.edge_dst_epoch.data_ptr(),
                     s.node_epoch.data_ptr(), s.invalid.data_ptr(), s.e_cap, s.n_cap, 0]
                    for s in self.shards]
            self.table = torch.tensor(rows, dtype=torch.int64).to(self.device)

    def __len__(self) -> int:
        return len(self.shards)


def wave_expand_shards_plain(
    frontier: torch.Tensor, table: ShardTable
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`wave_expand_shards`: one
    :func:`wave_expand_merge_plain` per shard."""
    nxt = torch.zeros(len(table), table.width, dtype=torch.int32, device=table.device)
    count = torch.zeros((), dtype=torch.int64, device=table.device)
    for d, s in enumerate(table.shards):
        fw = frontier if frontier.dim() == 1 else frontier[d]
        nx, lit = wave_expand_merge_plain(
            fw, s.invalid, s.node_epoch, s.edge_src, s.edge_dst, s.edge_dst_epoch
        )
        nxt[d, : nx.shape[0]] = nx
        count += lit
    return nxt, count


def wave_expand_shards(
    frontier: torch.Tensor, table: ShardTable, n_src: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One BFS level of every shard of a one-card mesh, merged, in one
    launch (grid y = shard). ``frontier`` is the global frontier's words,
    either one 1-D vector that every shard reads (row stride 0) or a 2-D
    tensor whose row ``d`` shard ``d`` reads; it must cover ``n_src`` bits.
    Returns (next words int32[n, table.width], row ``d`` shard ``d``'s; the
    level's count over all shards, 0-d int64, the psum). Each shard's
    invalid words take ``|= next`` in place."""
    global launches
    if frontier.dtype != torch.int32 or frontier.dim() not in (1, 2) or frontier.stride(-1) != 1:
        raise ValueError(
            "wave_expand: the frontier must be int32 words, 1-D or rows of a 2-D tensor"
        )
    if frontier.dim() == 2 and frontier.shape[0] != len(table):
        raise ValueError("wave_expand: a 2-D frontier needs one row per shard")
    if frontier.device != table.device:
        raise ValueError("wave_expand: inputs must share one device")
    _check_frontier(frontier.shape[-1], None, n_src)
    if table.device.type == "cpu":
        return wave_expand_shards_plain(frontier, table)
    nxt, count = _zeroed_next((len(table), table.width), table.device)
    _build.launch(
        "wave_expand", "wave_expand_shards_launch", frontier.data_ptr(),
        0 if frontier.dim() == 1 else frontier.stride(0), table.table.data_ptr(), len(table),
        table.max_edges, nxt.data_ptr(), table.width, count.data_ptr(),
    )
    launches += 1
    form_launches["shards"] += 1
    return nxt, count


def _level(frontier_w: torch.Tensor, g: GraphArrays) -> Tuple[torch.Tensor, torch.Tensor]:
    """One merged level: (next words, level count 0-d); g.invalid |= next."""
    return wave_expand_merge(
        frontier_w, g.invalid, g.node_epoch, *g.live_edges(), n_src=g.n_cap + 1
    )


def wave_step(frontier: torch.Tensor, g: GraphArrays) -> Tuple[torch.Tensor, GraphArrays]:
    """One BFS level from a bool frontier (n_cap+1,): returns the next bool
    frontier and ``g`` with the level merged into its invalid words."""
    nxt, _ = _level(pack_bits(frontier), g)
    return unpack_bits(nxt, g.n_cap + 1), g


def _expand_to_fixpoint(frontier_w: torch.Tensor, g: GraphArrays) -> Tuple[int, int]:
    """Expand already-merged seed words until a level lights nothing.
    Returns (newly count over the levels, productive levels)."""
    count = depth = 0
    while True:
        nxt, level = _level(frontier_w, g)
        level = int(level)  # the one host sync per level
        if level == 0:
            return count, depth
        count += level
        depth += 1
        frontier_w = nxt


def _gate_and_expand(seed_w: torch.Tensor, g: GraphArrays) -> Tuple[int, int]:
    """Seed gate (already-invalid seeds neither count nor expand) + the
    expansion; ``seed_w`` is overwritten with the fresh seeds. Returns
    (newly count incl. seeds, depth)."""
    _, fresh, seeded = or_popcount_gate(seed_w, g.invalid, out=g.invalid, delta=seed_w)
    count, depth = _expand_to_fixpoint(fresh, g)
    return int(seeded) + count, depth


def run_wave(seed_frontier: torch.Tensor, g: GraphArrays) -> Tuple[GraphArrays, int]:
    """Full cascading-invalidation wave from a bool seed frontier.
    Returns (g, newly-invalidated count)."""
    count, _ = _gate_and_expand(pack_bits(seed_frontier), g)
    return g, count


def run_wave_with_stats(
    seed_frontier: torch.Tensor, g: GraphArrays
) -> Tuple[GraphArrays, int, int]:
    """run_wave + BFS depth (productive levels; the final empty one does
    not count)."""
    count, depth = _gate_and_expand(pack_bits(seed_frontier), g)
    return g, count, depth


def run_wave_collect(
    seed_frontier: torch.Tensor, g: GraphArrays, cap: int
) -> Tuple[GraphArrays, int, torch.Tensor, bool]:
    """run_wave that also returns the newly-invalidated ids: (g, count,
    ids int32[cap] in ascending node order padded with -1, overflow). When
    ``count > cap`` the buffer holds the first ``cap`` ids and ``overflow``
    is set."""
    inv_before = g.invalid.clone()
    count, _ = _gate_and_expand(pack_bits(seed_frontier), g)
    newly = unpack_bits(g.invalid & ~inv_before, g.n_cap + 1)
    found = torch.nonzero(newly).flatten()[:cap].to(torch.int32)
    ids = torch.full((cap,), -1, dtype=torch.int32, device=newly.device)
    ids[: found.shape[0]] = found
    return g, count, ids, count > cap


def run_waves_chained_packed(
    seed_ids_mat: torch.Tensor, g: GraphArrays
) -> Tuple[GraphArrays, torch.Tensor, torch.Tensor]:
    """:func:`run_waves_chained` with the union newly set as packed words
    (for a bit-packed host readback)."""
    inv_before = g.invalid.clone()
    counts: List[int] = []
    for row in seed_ids_mat:
        count, _ = _gate_and_expand(pack_bits(seeds_to_frontier(g.n_cap, row)), g)
        counts.append(count)
    return g, torch.tensor(counts, dtype=torch.int64), g.invalid & ~inv_before


def run_waves_chained(
    seed_ids_mat: torch.Tensor, g: GraphArrays
) -> Tuple[GraphArrays, torch.Tensor, torch.Tensor]:
    """Chain W seed-id waves (int32[W, S], -1-padded), each over the state
    the previous one left. JAX runs them under ``lax.scan``; the port loops
    over the rows. Returns (g, per-wave counts int64[W] on the host, union
    newly mask bool[n_cap+1])."""
    g, counts, newly_w = run_waves_chained_packed(seed_ids_mat, g)
    return g, counts, unpack_bits(newly_w, g.n_cap + 1)


def run_waves_union_packed(
    seed_ids: torch.Tensor, g: GraphArrays
) -> Tuple[GraphArrays, int, torch.Tensor]:
    """:func:`run_waves_union` with the newly set as packed words (for a
    bit-packed host readback)."""
    inv_before = g.invalid.clone()
    frontier_w = pack_bits(seeds_to_frontier(g.n_cap, seed_ids.reshape(-1)))
    or_popcount(frontier_w, g.invalid, out=g.invalid)
    _expand_to_fixpoint(frontier_w, g)
    newly_w, count = or_popcount_delta(g.invalid, inv_before)  # union finalize
    return g, int(count), newly_w


def run_waves_union(
    seed_ids: torch.Tensor, g: GraphArrays
) -> Tuple[GraphArrays, int, torch.Tensor]:
    """Union cascade: ALL seeds (int32[...], -1-padded) expand in ONE BFS.

    Seeds CONDUCT even when already invalid (a host-led mark may have set a
    seed's bit without walking its device-only dependents); already-invalid
    non-seed nodes block. Pre-invalid seeds do not count as newly. Returns
    (g, newly count, union newly mask bool[n_cap+1])."""
    g, count, newly_w = run_waves_union_packed(seed_ids, g)
    return g, count, unpack_bits(newly_w, g.n_cap + 1)
