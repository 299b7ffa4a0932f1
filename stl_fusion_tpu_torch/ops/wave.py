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

The frontier is packed the same way. Each BFS level is two kernels:

- :func:`wave_expand` (``csrc/wave_expand.cu``), the counterpart of the XLA
  ``wave_step``: one thread per live edge ``atomicOr``-s the bit of each
  firing dependent into the next frontier;
- :func:`~.or_popcount.or_popcount`: ``invalid |= next`` and the level's
  count in one pass.

The host reads the level count once per level: ``count == 0`` is exactly
"the frontier is empty", because ``next`` already excludes invalid nodes.
That replaces the JAX ``lax.while_loop`` condition at the same cost of one
sync per level. The seed gate and the union finalize go through
``or_popcount`` too. Bool masks appear only at the public boundaries
(seed frontiers in, newly masks out), as in the JAX package.

JAX donates the graph to each wave; the port updates ``g.invalid`` IN
PLACE and returns ``g`` for the same call shape.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .bitops import pack_bits, unpack_bits
from .or_popcount import or_popcount

__all__ = [
    "GraphArrays",
    "wave_expand",
    "wave_expand_plain",
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
]

#: wave_expand kernel launches since the last reset
launches = 0


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


def _check_expand(frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch, n_src):
    ts = (frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch)
    for t in ts:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("wave_expand: every input must be a contiguous 1-D int32 tensor")
        if t.device != frontier_w.device:
            raise ValueError("wave_expand: inputs must share one device")
    if invalid_w.shape[0] * 32 < node_epoch.shape[0]:
        raise ValueError("wave_expand: invalid words must cover n_cap+1 bits")
    if not (edge_src.shape == edge_dst.shape == edge_dst_epoch.shape):
        raise ValueError("wave_expand: edge arrays must have equal length")
    if n_src is None:  # one reduction and a host sync: hot callers pass it
        n_src = int(edge_src.max()) + 1 if edge_src.numel() else 0
    if frontier_w.shape[0] * 32 < n_src:
        raise ValueError("wave_expand: frontier words must cover max(edge_src)+1 bits")


def wave_expand(
    frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch,
    n_src: Optional[int] = None,
) -> torch.Tensor:
    """One BFS level on packed words → the next frontier's words.

    An edge fires when its source's frontier bit is set, the dependent's
    epoch matches the edge's captured epoch, the dependent's invalid bit
    is clear, and the dependent is not the dummy slot n_cap. The result
    holds no node that is already invalid. A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/wave_expand.cu`` or raises.

    Sources and dependents may live in different id spaces: a shard of the
    sharded wave reads the GLOBAL frontier with global ``edge_src`` and
    writes its LOCAL invalid words through local ``edge_dst``. The frontier
    must cover ``max(edge_src)+1`` bits; ``n_src`` is a bound on that
    count which a caller that built the edges already knows (the dense
    graph's ``n_cap+1``, the mesh's ``n_global``), so the check costs no
    device reduction.
    """
    global launches
    _check_expand(frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch, n_src)
    if frontier_w.device.type == "cpu":
        return wave_expand_plain(
            frontier_w, invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch
        )
    if frontier_w.device.type != "cuda":
        raise ValueError(f"wave_expand: unsupported device {frontier_w.device}")
    nxt = torch.zeros_like(invalid_w)
    _build.launch(
        "wave_expand", frontier_w.data_ptr(), invalid_w.data_ptr(),
        node_epoch.data_ptr(), edge_src.data_ptr(), edge_dst.data_ptr(),
        edge_dst_epoch.data_ptr(), nxt.data_ptr(), edge_src.shape[0],
        node_epoch.shape[0] - 1,
    )
    launches += 1
    return nxt


def _level(frontier_w: torch.Tensor, g: GraphArrays) -> Tuple[torch.Tensor, torch.Tensor]:
    """expand + merge: (next words, level count 0-d); g.invalid |= next."""
    nxt = wave_expand(frontier_w, g.invalid, g.node_epoch, *g.live_edges(), n_src=g.n_cap + 1)
    _, count = or_popcount(nxt, g.invalid, out=g.invalid)
    return nxt, count


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
    expansion. Returns (newly count incl. seeds, depth)."""
    fresh = seed_w & ~g.invalid
    _, seeded = or_popcount(fresh, g.invalid, out=g.invalid)
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
    newly_w = g.invalid & ~inv_before
    _, count = or_popcount(g.invalid, inv_before, out=inv_before)  # union finalize
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
