"""The topo-ordered single sweep: the whole cascade of 32·W waves in ONE pass.

Port of ``stl_fusion_tpu/ops/topo_wave.py`` (the graph, its state, the sweep
and its step functions, and the mirror's gate and finish steps). The
dependency graph is a DAG, so nodes renumbered into topological levels
(level[d] = 1 + max level of d's dependencies) have every in-edge pointing at
a strictly lower level. One pass over the levels in ascending order then
finishes the transitive closure of every packed wave: O(edges) work where the
level-by-level BFS (``ops/wave.py``) costs O(edges × depth).

**The sweep** is the hand-written kernel :func:`topo_sweep`
(``csrc/topo_sweep.cu``), the counterpart of the XLA ``_topo_sweep_impl``:
one launch per non-empty level, all enqueued from the host's
``level_starts`` with no sync between them, and the per-word newly count
fused into each row's single write. PyTorch has no OR-reduction over a
gathered axis, so its plain version (:func:`topo_sweep_plain`) needs per
level k gathers, k ORs, a merge and a popcount. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

Unlike JAX, the sweep updates ``state.invalid_bits`` IN PLACE (at 10M rows
and W=16 the state is 640 MB) and returns the same state. Its optional
``changed`` flag (one device int) is the stop test of the adaptive multi-pass
sweep (:func:`_sweep_adaptive`).

The mirror's gate and finish steps read and write the dense graph's invalid
state as the port keeps it: packed int32 words (``ops/wave.py``). The lane
burst's epilogue is the hand-written kernel :func:`lane_finish`
(``csrc/lane_finish.cu``): per-lane popcounts of the newly bits, the union,
and its commit into the packed words, in one pass; its plain version is
:func:`lane_finish_plain`. The fused union, lanes and chain steps keep their
JAX names and are plain compositions of gate, sweep and finish: JAX fuses
them to save relay round trips, which the port does not have. The chain and
the super-round (:func:`topo_mirror_superround_step`: each round a lane
burst, then the block refresh through the memo table's loader and the
``block_refresh`` kernel) share one per-stage body, :func:`_chain_stages`;
the card runs each as one captured CUDA graph (``graph/program_cache.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import _build
from .block_refresh import block_refresh, loader_rows
from .ell_wave import EllGraph, build_ell
from .pull_wave import pack_seed_words
from .wave import _bit_at

__all__ = [
    "TopoGraph",
    "TopoGraphArrays",
    "TopoState",
    "build_topo_graph",
    "build_topo_wave32",
    "lane_finish",
    "lane_finish_plain",
    "launches",
    "run_topo_sweep_passes",
    "topo_graph_arrays",
    "topo_init_state",
    "topo_mirror_finish_lanes_step",
    "topo_mirror_finish_step",
    "topo_mirror_fused_lanes_chain_step",
    "topo_mirror_fused_lanes_step",
    "topo_mirror_fused_union_step",
    "topo_mirror_gate_lanes_step",
    "topo_mirror_gate_step",
    "topo_mirror_superround_step",
    "topo_seeds_to_bits",
    "topo_sweep",
    "topo_sweep_plain",
    "topo_sweep_step",
]

#: topo_sweep kernel launches since the last reset (one per non-empty level per sweep)
launches = 0
#: lane_finish CUDA launches since the last reset (one per lane burst at a
#: power-of-two W <= 32, the main path's; one per column chunk + 1 otherwise)
lane_finish_launches = 0


class TopoGraph(NamedTuple):
    """Host-built in-ELL in topological level order. Row ids are NEW
    (level-ordered) ids; ``perm`` maps new→old augmented ids, ``inv_perm``
    old→new (fixed point at the null row)."""

    in_src: np.ndarray  # int32[n_tot+1, k] — NEW-id in-neighbors; pad n_tot
    edge_epoch: np.ndarray  # int32[n_tot+1, k] — captured epochs; pad -1
    is_real: np.ndarray  # bool[n_tot+1] (new order)
    level_starts: Tuple[int, ...]  # len L+1; level l = rows [starts[l], starts[l+1])
    perm: np.ndarray  # int64[n_tot+1]: new id -> old id
    inv_perm: np.ndarray  # int64[n_tot_o+1]: old id -> new id
    n_real: int
    n_tot: int
    k: int


def _levels_numpy(in_src: np.ndarray, n: int, k: int) -> np.ndarray:
    """Longest-path levels by vectorized relaxation (the numpy path; the
    native Kahn pass ``gp_topo_levels`` is the fast one)."""
    level = np.zeros(n, dtype=np.int32)
    table = in_src[:n].astype(np.int64)
    live = table < n
    safe = np.where(live, table, 0)
    for _ in range(4 * n + 4):  # depth is bounded by n
        cand = np.where(live, level[safe] + 1, 0).max(axis=1).astype(np.int32)
        if (cand <= level).all():
            return level
        level = np.maximum(level, cand)
    raise ValueError("level relaxation failed to converge (cycle?)")


def _levels_native(in_src: np.ndarray, n: int, k: int) -> np.ndarray:
    """Kahn longest-path levels from the native packer."""
    lib = _build.load_host("graphpack")
    in_src = np.ascontiguousarray(in_src, dtype=np.int32)
    level = np.empty(n, dtype=np.int32)
    rc = lib.gp_topo_levels(in_src.ctypes.data_as(ctypes.c_void_p), n, k,
                            level.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"dependency graph contains a cycle (gp_topo_levels rc={rc})")
    return level


def _quantize_level(s: int) -> int:
    """Pad a level's row count up to a coarse size bucket (≤12.5% overhead
    past 128 rows, minimum 16), so level sizes stay stable under small
    structural drift (the JAX package keys compiled sweeps on them)."""
    if s <= 0:
        return 0
    if s <= 16:
        return 16
    grid = max(16, 1 << (int(s - 1).bit_length() - 3))
    return -(-s // grid) * grid


def build_topo_graph(
    src: np.ndarray, dst: np.ndarray, n_nodes: int, k: int = 4, use_native: bool = True,
    quantize: bool = True, slack: int = 0,
) -> TopoGraph:
    """In-ELL (``build_ell`` on reversed edges: virtual OR-collectors bound
    in-degree at k) renumbered into topological level order, each level
    padded to a quantized size when ``quantize`` (null rows: no in-edges,
    not real). ``slack`` appends that many guaranteed-free pad columns to
    every row (the live mirror's headroom). ``use_native`` selects the
    native packer for both the ELL and the levels (it builds or raises)."""
    ell: EllGraph = build_ell(dst, src, n_nodes, k=k, use_native=use_native)
    n_tot_o = ell.n_tot
    if use_native:
        level = _levels_native(ell.ell_dst, n_tot_o, k)
    else:
        level = _levels_numpy(ell.ell_dst, n_tot_o, k)

    order = np.argsort(level, kind="stable")  # levels ascending over old ids
    sizes = np.bincount(level, minlength=int(level.max()) + 1 if n_tot_o else 1)
    padded = [(_quantize_level(int(s)) if quantize else int(s)) for s in sizes]
    n_tot = int(sum(padded))  # padded row-space size; null row at index n_tot
    if quantize and n_tot:
        # the total too (≤ ~3% tail of pure null rows)
        grain = max(256, (1 << (n_tot.bit_length() - 1)) // 32)
        n_tot = -(-n_tot // grain) * grain

    # perm: new row -> old augmented id; pad rows map to the OLD null row
    perm = np.full(n_tot + 1, n_tot_o, dtype=np.int64)
    starts = [0]
    pos = oi = 0
    for s, ps in zip(sizes, padded):
        s, ps = int(s), int(ps)
        perm[pos : pos + s] = order[oi : oi + s]
        oi += s
        pos += ps
        starts.append(pos)
    inv_perm = np.full(n_tot_o + 1, n_tot, dtype=np.int64)
    real = perm[:n_tot] != n_tot_o
    inv_perm[perm[:n_tot][real]] = np.nonzero(real)[0]
    inv_perm[n_tot_o] = n_tot

    # rows into new order, entries into new ids (the old pad row maps to the
    # new null row n_tot, so pad entries stay pads)
    in_src = inv_perm[ell.ell_dst[perm]].astype(np.int32)
    edge_epoch = ell.ell_epoch[perm]
    is_real = ell.is_real[perm] & (perm != n_tot_o)
    if slack:
        in_src = np.hstack([in_src, np.full((in_src.shape[0], slack), n_tot, dtype=np.int32)])
        edge_epoch = np.hstack(
            [edge_epoch, np.full((in_src.shape[0], slack), -1, dtype=np.int32)])

    return TopoGraph(in_src, edge_epoch, is_real, tuple(starts), perm, inv_perm, n_nodes,
                     n_tot, k + slack)


class TopoGraphArrays(NamedTuple):
    in_src: torch.Tensor  # int32[n_tot+1, k]
    edge_epoch: torch.Tensor  # int32[n_tot+1, k]
    is_real: torch.Tensor  # bool[n_tot+1]


class TopoState(NamedTuple):
    node_epoch: torch.Tensor  # int32[n_tot+1] (new order)
    #: int32[n_tot+1] (words=1) or int32[n_tot+1, words]; each word packs 32 waves
    invalid_bits: torch.Tensor


def topo_graph_arrays(graph: TopoGraph, device=None) -> TopoGraphArrays:
    """Upload the sweep's tables. The epoch table is derived on the device
    (slot live ⇔ epoch 0, pad ⇔ -1), which halves the upload."""
    device = resolve_device(device)
    in_src = torch.from_numpy(np.ascontiguousarray(graph.in_src)).to(device, copy=True)
    return TopoGraphArrays(
        in_src=in_src,
        edge_epoch=torch.where(in_src != graph.n_tot, 0, -1).to(torch.int32),
        is_real=torch.from_numpy(np.ascontiguousarray(graph.is_real)).to(device, copy=True),
    )


def topo_init_state(n_tot: int, words: int = 1, device=None) -> TopoState:
    """All-valid state packing ``32*words`` waves per sweep."""
    device = resolve_device(device)
    if 32 * (n_tot + 1) >= 2**31:
        # per-word counts are int32, as in the JAX package: beyond ~67M rows
        # one word's count could wrap
        raise ValueError(
            f"topo sweep count tracking is int32-limited to <{2**31 // 32} rows; "
            f"got {n_tot + 1} — shard the graph (parallel/sharded_wave.py) instead"
        )
    shape = (n_tot + 1,) if words == 1 else (n_tot + 1, words)
    node_epoch = torch.zeros(n_tot + 1, dtype=torch.int32, device=device)
    node_epoch[n_tot] = -2
    return TopoState(node_epoch, torch.zeros(shape, dtype=torch.int32, device=device))


def topo_seeds_to_bits(graph: TopoGraph, seed_ids_per_wave, words: int = 1) -> np.ndarray:
    """≤``32*words`` seed-id arrays (ORIGINAL node ids) → int32 bits in NEW
    id space (1-D for ``words=1``, else [n_tot+1, words]), null row 0."""
    bits = pack_seed_words(graph.n_tot + 1, seed_ids_per_wave, words=words,
                           id_map=graph.inv_perm)
    bits[graph.n_tot] = 0
    return bits


# ------------------------------------------------------------------ the sweep
def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words (SWAR in int64, so nothing wraps)."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    return t.view(-1, 1) if t.dim() == 1 else t


def _plain_level(inv, garrays: TopoGraphArrays, node_epoch, a: int, b: int) -> None:
    """One level of the plain sweep on rows [a, b) of ``inv`` ([rows, W]):
    the effective in-rows (a dead edge reads the null row), a ``[b-a, k,
    W]`` gather OR-folded over k, and the merge, in place."""
    in_src, edge_epoch, _ = garrays
    n_tot, k = in_src.shape[0] - 1, in_src.shape[1]
    eff = torch.where(edge_epoch[a:b] == node_epoch[a:b, None], in_src[a:b], n_tot)
    f = inv[eff]  # from earlier levels
    fire = f[:, 0]
    for j in range(1, k):
        fire = fire | f[:, j]
    inv[a:b] |= fire


def topo_sweep_plain(level_starts, garrays: TopoGraphArrays, seed_bits: Optional[torch.Tensor],
                     state: TopoState, start_level: int = 1,
                     changed: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`topo_sweep`, level by level as the
    JAX ``_topo_sweep_impl``: per level the effective in-rows (a dead edge
    reads the null row), a ``[rows, k, W]`` gather OR-folded over k, and
    the merge. Updates ``state.invalid_bits`` in place; ``changed[0]`` is
    set to 1 when any row differs from its state before the sweep."""
    n_tot, is_real = garrays.in_src.shape[0] - 1, garrays.is_real
    inv = _as_rows(state.invalid_bits)
    before = inv.clone()
    if seed_bits is not None:
        inv |= _as_rows(seed_bits)
    inv[n_tot] = 0
    for l in range(start_level, len(level_starts) - 1):
        a, b = level_starts[l], level_starts[l + 1]
        if a < b:
            _plain_level(inv, garrays, state.node_epoch, a, b)
    if changed is not None and bool((inv != before).any()):
        changed.fill_(1)
    newly = torch.where(is_real[:, None], inv & ~before, 0)
    counts = _popcount32(newly).sum(dim=0, dtype=torch.int64).to(torch.int32)
    return state, (counts[0] if state.invalid_bits.dim() == 1 else counts)


@functools.lru_cache(maxsize=16)
def _starts_array(level_starts: Tuple[int, ...]) -> np.ndarray:
    return np.asarray(level_starts, dtype=np.int64)


def _check_sweep(level_starts, garrays, seed_bits, state, start_level, changed=None):
    in_src, edge_epoch, is_real = garrays
    node_epoch, inv = state
    device = inv.device
    n = in_src.shape[0]
    for name, t in (("in_src", in_src), ("edge_epoch", edge_epoch), ("node_epoch", node_epoch),
                    ("invalid_bits", inv)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"topo_sweep: {name} must be a contiguous int32 tensor on {device}")
    if in_src.dim() != 2 or edge_epoch.shape != in_src.shape:
        raise ValueError("topo_sweep: in_src and edge_epoch must be [n_tot+1, k]")
    if is_real.dtype != torch.bool or is_real.shape != (n,) or is_real.device != device:
        raise ValueError("topo_sweep: is_real must be bool[n_tot+1] on the same device")
    if node_epoch.shape != (n,) or inv.dim() not in (1, 2) or inv.shape[0] != n:
        raise ValueError("topo_sweep: node_epoch and invalid_bits need n_tot+1 rows")
    if seed_bits is not None:
        if (seed_bits.dtype != torch.int32 or not seed_bits.is_contiguous()
                or seed_bits.device != device or seed_bits.shape[0] != n):
            raise ValueError("topo_sweep: seed_bits must be contiguous int32 with n_tot+1 rows")
        sw = 1 if seed_bits.dim() == 1 else seed_bits.shape[1]
        w = 1 if inv.dim() == 1 else inv.shape[1]
        if sw != w:
            # broadcasting a mismatched width would duplicate or drop lanes
            raise ValueError(
                f"seed_bits width {sw} != state width {w}; "
                f"pass words= consistently to topo_seeds_to_bits/build_topo_wave32"
            )
    if not (len(level_starts) >= 1 and level_starts[0] == 0 and level_starts[-1] <= n - 1
            and all(a <= b for a, b in zip(level_starts, level_starts[1:]))):
        raise ValueError("topo_sweep: level_starts must ascend from 0 to at most n_tot")
    if not 0 <= start_level:
        raise ValueError("topo_sweep: start_level must be >= 0")
    if changed is not None and (changed.dtype != torch.int32 or changed.shape != (1,)
                                or changed.device != device):
        raise ValueError("topo_sweep: changed must be an int32[1] tensor on the same device")


def topo_sweep(level_starts, garrays: TopoGraphArrays, seed_bits: Optional[torch.Tensor],
               state: TopoState, start_level: int = 1, changed: Optional[torch.Tensor] = None):
    """One sweep: ``invalid |= seeds`` (null row 0), then levels ascending
    from ``start_level``: each row ORs in the words of its live in-slots
    (slot epoch == the row's epoch), which lie in finished earlier levels.
    Returns (state, counts): int32 per-word counts of newly lit bits over
    real rows (a 0-d count for a 1-D state). ``seed_bits`` None means no
    seeds. Updates ``state.invalid_bits`` IN PLACE. ``changed`` (int32[1],
    optional) is set to 1 when any row, real or virtual, gained a bit; it
    is never cleared here. A CPU tensor takes :func:`topo_sweep_plain`; a
    CUDA tensor launches ``csrc/topo_sweep.cu`` (one launch per non-empty
    level) or raises."""
    global launches
    _check_sweep(level_starts, garrays, seed_bits, state, start_level, changed)
    inv = state.invalid_bits
    if inv.device.type == "cpu":
        return topo_sweep_plain(level_starts, garrays, seed_bits, state, start_level, changed)
    if inv.device.type != "cuda":
        raise ValueError(f"topo_sweep: unsupported device {inv.device}")
    in_src, edge_epoch, is_real = garrays
    n_tot, k = in_src.shape[0] - 1, in_src.shape[1]
    w = 1 if inv.dim() == 1 else inv.shape[1]
    vec4 = w % 4 == 0 and inv.data_ptr() % 16 == 0 and (
        seed_bits is None or seed_bits.data_ptr() % 16 == 0)
    if w // (4 if vec4 else 1) > 256:
        raise ValueError("topo_sweep: the kernel takes at most 256 threads a row "
                         "(W <= 1024 in int4 groups, else W <= 256)")
    counts = torch.zeros(w, dtype=torch.int32, device=inv.device)
    starts = _starts_array(tuple(level_starts))
    made = ctypes.c_int(0)
    _build.launch(
        "topo_sweep", "topo_sweep_launch", in_src.data_ptr(), edge_epoch.data_ptr(),
        state.node_epoch.data_ptr(), is_real.data_ptr(),
        None if seed_bits is None else seed_bits.data_ptr(), inv.data_ptr(), counts.data_ptr(),
        None if changed is None else changed.data_ptr(), starts.ctypes.data, len(starts) - 1,
        start_level, k, w, n_tot, int(starts[-1]), int(vec4), ctypes.addressof(made),
    )
    launches += made.value
    return state, (counts[0] if inv.dim() == 1 else counts)


def topo_sweep_step(level_starts: Tuple[int, ...], start_level: int = 1):
    """The sweep for one level layout: ``step(garrays, seed_bits, state)``.
    ``start_level=0`` includes level 0 (the mirror's sweeps)."""
    return functools.partial(topo_sweep, tuple(level_starts), start_level=start_level)


def run_topo_sweep_passes(level_starts, garrays, seed_bits, node_epoch, passes: int):
    """``passes`` chained sweeps from an all-valid state with ``node_epoch``
    (only the first pass seeds; ``start_level`` 0), or the adaptive sweep
    (:func:`_sweep_adaptive`) when ``passes <= 0``. Returns the state."""
    state = TopoState(node_epoch, torch.zeros_like(seed_bits))
    if passes <= 0:
        return _sweep_adaptive(level_starts, garrays, seed_bits, state)
    step = topo_sweep_step(level_starts, 0)
    sb = seed_bits
    for _ in range(passes):
        state, _ = step(garrays, sb, state)
        sb = None
    return state


def _sweep_adaptive(level_starts, garrays, seed_bits, state):
    """The adaptive pass mode (``passes <= 0``): one seeded sweep, then
    unseeded sweeps until one changes no row, real or virtual (JAX
    ``_sweep_adaptive``: a ``lax.while_loop`` on ``(after != before).any()``).
    The bits only grow under OR, so the loop ends, at the state any fixed
    pass count at least the violation depth reaches. The kernel's
    ``changed`` flag is read on the host once per pass. Returns the state."""
    state, _ = topo_sweep(level_starts, garrays, seed_bits, state, 0)
    changed = torch.zeros(1, dtype=torch.int32, device=state.invalid_bits.device)
    while True:
        changed.zero_()
        state, _ = topo_sweep(level_starts, garrays, None, state, 0, changed=changed)
        if not int(changed.item()):
            return state


def build_topo_wave32(graph: TopoGraph, words: int = 1, device=None):
    """(state0, wave32): ``wave32(seed_bits, state)`` → (state, per-word
    newly counts over real nodes); the whole ``32*words``-wave cascade is
    one sweep. ``wave32.garrays`` / ``.step`` / ``.impl`` as in JAX."""
    device = resolve_device(device)
    garrays = topo_graph_arrays(graph, device)
    step = topo_sweep_step(graph.level_starts)

    def wave32(seed_bits, state):
        return step(garrays, seed_bits, state)

    wave32.garrays = garrays
    wave32.step = step
    wave32.impl = functools.partial(topo_sweep, graph.level_starts)
    return topo_init_state(graph.n_tot, words, device), wave32


# ------------------------------------------------------------------ mirror steps
def topo_mirror_gate_step(n_tot: int):
    """The union burst's prologue over a topo mirror, with dense-BFS
    semantics expressed through the sweep's epochs: a real row whose node is
    already invalid in the dense state gets epoch -3, so none of its
    in-edges (captured at 0) match and it can neither fire nor pass a wave
    on. Seeds conduct even when already invalid; the finish step keeps them
    out of the count. Returns ``gate(is_real, node_epoch0, perm_clipped,
    g_invalid_words, seed_new_ids) -> (node_epoch, seed_bits int32[n_tot+1])``."""

    def gate(is_real, node_epoch0, perm_clipped, g_invalid, seed_new_ids):
        blocked = is_real & _bit_at(g_invalid, perm_clipped)
        blocked[n_tot].fill_(False)  # fill_: no host scalar copy (graph capture)
        node_epoch = torch.where(blocked, -3, node_epoch0).to(torch.int32)
        seed_bits = torch.zeros(n_tot + 1, dtype=torch.int32, device=g_invalid.device)
        seed_bits[seed_new_ids.long()] = 1
        seed_bits[n_tot].fill_(0)
        return node_epoch, seed_bits

    return gate


def topo_mirror_finish_step(cap: int, n_tot: int):
    """The union burst's epilogue: count the newly-invalid real rows of the
    final sweep bits, list their ORIGINAL ids in topo-row order (first
    ``cap``, -1-padded), and set them in the dense packed words in place.
    Each newly bit is clear and each real row's id unique, so adding the
    bits into their words is the OR. Returns ``finish(is_real,
    perm_clipped, g_invalid_words, final_bits) -> (g_invalid_words, count,
    ids int32[cap], overflow)`` with count and overflow on the host."""

    def finish(is_real, perm_clipped, g_invalid, final_bits):
        newly = (final_bits != 0) & is_real & ~_bit_at(g_invalid, perm_clipped)
        ids = perm_clipped[newly]  # topo-row order, as JAX's cumsum compaction
        count = int(ids.shape[0])
        bit = torch.bitwise_left_shift(torch.ones_like(ids), ids & 31)
        g_invalid.index_add_(0, (ids >> 5).long(), bit)
        out = torch.full((cap,), -1, dtype=torch.int32, device=g_invalid.device)
        out[: min(count, cap)] = ids[:cap]
        return g_invalid, count, out, count > cap

    return finish


def topo_mirror_fused_union_step(level_starts: Tuple[int, ...], cap: int, n_tot: int,
                                 passes: int = 1):
    """The union burst: gate → sweep × ``passes`` (adaptive when ``passes
    <= 0``) → finish. JAX fuses the three into one program to save relay
    round trips; here it is their plain composition, with the same results.
    Returns ``burst(garrays, node_epoch0, perm_clipped, g_invalid_words,
    seed_new_ids) -> (g_invalid_words, count, ids int32[cap], overflow)``."""
    level_starts = tuple(level_starts)

    def burst(garrays: TopoGraphArrays, node_epoch0, perm_clipped, g_invalid, seed_new_ids):
        node_epoch, seed_bits = topo_mirror_gate_step(n_tot)(
            garrays.is_real, node_epoch0, perm_clipped, g_invalid, seed_new_ids)
        state = run_topo_sweep_passes(level_starts, garrays, seed_bits, node_epoch, passes)
        return topo_mirror_finish_step(cap, n_tot)(
            garrays.is_real, perm_clipped, g_invalid, state.invalid_bits)

    return burst


# ------------------------------------------------------------------ lane bursts
def topo_mirror_gate_lanes_step(n_tot: int, words: int):
    """The lane burst's prologue: ``32*words`` independent command groups,
    group ``l`` seeding word ``l // 32`` bit ``l % 32`` (lane 31 is the sign
    bit). Blocked rows (already invalid in the dense state) get epoch -3, as
    in the union gate; seeds conduct even when already invalid. Within a
    lane the ids are unique and the lanes' bits are disjoint, so scattering
    the seed bits by ``index_add_`` is the OR. Returns ``gate(is_real,
    node_epoch0, perm_clipped, g_invalid_words, seed_new_ids int32[32*words,
    S]) -> (node_epoch, seed_bits int32[n_tot+1, words])``; pad ids are
    ``n_tot`` (the null row, zeroed)."""
    W = words
    L = 32 * W

    def gate(is_real, node_epoch0, perm_clipped, g_invalid, seed_new_ids):
        device = g_invalid.device
        blocked = is_real & _bit_at(g_invalid, perm_clipped)
        blocked[n_tot].fill_(False)  # fill_: no host scalar copy (graph capture)
        node_epoch = torch.where(blocked, -3, node_epoch0).to(torch.int32)
        if seed_new_ids.shape[0] != L:
            raise ValueError(f"lane gate: {seed_new_ids.shape[0]} seed rows for {L} lanes")
        lanes = torch.arange(L, dtype=torch.int32, device=device)
        bit_of = torch.bitwise_left_shift(torch.ones_like(lanes), lanes % 32)
        flat = seed_new_ids.long() * W + (lanes // 32).long()[:, None]
        vals = bit_of[:, None].expand(seed_new_ids.shape)
        seed_bits = torch.zeros((n_tot + 1) * W, dtype=torch.int32, device=device)
        seed_bits.index_add_(0, flat.reshape(-1), vals.reshape(-1))
        seed_bits = seed_bits.view(n_tot + 1, W)
        seed_bits[n_tot].fill_(0)
        return node_epoch, seed_bits

    return gate


def _lane_counts_blocked(newly_bits: torch.Tensor, W: int, block: int = 1 << 15) -> torch.Tensor:
    """Per-lane popcounts of ``[rows, W]`` packed bits, a tile of ``block``
    rows unpacked at a time (JAX ``_lane_counts_blocked``: unpacking the
    whole ``[rows, W, 32]`` at once is 5.8G elements at 10M rows and W=16).
    Returns int32[32*W]: lane ``l`` is word ``l // 32``, bit ``l % 32``."""
    shifts = torch.arange(32, dtype=torch.int32, device=newly_bits.device)
    acc = torch.zeros((W, 32), dtype=torch.int64, device=newly_bits.device)
    for a in range(0, newly_bits.shape[0], block):
        blk = newly_bits[a : a + block]
        acc += ((blk[:, :, None] >> shifts) & 1).sum(dim=0)
    return acc.reshape(W * 32).to(torch.int32)


def lane_finish_plain(final_bits, is_real, perm_clipped, g_invalid):
    """Plain PyTorch version of :func:`lane_finish` (JAX
    ``topo_mirror_finish_lanes_step``): the newly bits (real rows whose node
    was valid before the burst), their per-lane counts, the union rows, and
    the union's commit into the dense words in place. ``perm_clipped`` None
    is the identity map (``arange(rows)``). Returns (lane_counts
    int32[32*W], union_count int32 0-d, newly mask words)."""
    fb = _as_rows(final_bits)
    if perm_clipped is None:
        perm_clipped = torch.arange(fb.shape[0], dtype=torch.int32, device=fb.device)
    ok = is_real & ~_bit_at(g_invalid, perm_clipped)
    newly_bits = torch.where(ok[:, None], fb, 0)
    lane_counts = _lane_counts_blocked(newly_bits, fb.shape[1])
    union = (newly_bits != 0).any(dim=1)
    ids = perm_clipped[union]
    newly = torch.zeros_like(g_invalid)
    # each union id is unique and was clear: adding its bit is the OR
    newly.index_add_(0, (ids >> 5).long(), torch.bitwise_left_shift(torch.ones_like(ids), ids & 31))
    g_invalid |= newly
    return lane_counts, union.sum(dtype=torch.int32), newly


_lane_finish_entry = None  # the C entry, resolved at the first launch


def lane_finish(final_bits, is_real, perm_clipped, g_invalid):
    """The lane burst's epilogue. For each real row whose node's bit in the
    dense packed words ``g_invalid`` is clear, its final bits are newly:
    per-lane counts (int32[32*W], JAX's stack order), the union (rows with
    any newly bit: their count, and their bits OR'ed into ``g_invalid`` IN
    PLACE and into a fresh packed newly mask like it). ``perm_clipped``
    maps rows to nodes; None is the identity map (row r is node r, the
    packed mesh burst's rows), which the kernel takes without reading a
    map. Returns (lane_counts, union_count int32 0-d, newly mask words). A
    CPU tensor takes :func:`lane_finish_plain`; a CUDA tensor launches
    ``csrc/lane_finish.cu`` or raises."""
    global lane_finish_launches, _lane_finish_entry
    fb = _as_rows(final_bits)
    n, w = fb.shape
    device = g_invalid.device
    for name, t, dtype in (("final_bits", fb, torch.int32), ("is_real", is_real, torch.bool),
                           ("perm_clipped", perm_clipped, torch.int32),
                           ("g_invalid", g_invalid, torch.int32)):
        if t is not None and (t.dtype != dtype or not t.is_contiguous() or t.device != device):
            raise ValueError(f"lane_finish: {name} must be a contiguous {dtype} tensor on {device}")
    if (is_real.shape != (n,) or (perm_clipped is not None and perm_clipped.shape != (n,))
            or g_invalid.dim() != 1):
        raise ValueError("lane_finish: is_real and perm_clipped need one entry per row of "
                         "final_bits, and g_invalid is 1-D")
    if perm_clipped is None and 32 * g_invalid.shape[0] < n:
        raise ValueError(f"lane_finish: the identity map needs {-(-n // 32)} dense words, "
                         f"g_invalid has {g_invalid.shape[0]}")
    if device.type == "cpu":
        return lane_finish_plain(fb, is_real, perm_clipped, g_invalid)
    if device.type != "cuda":
        raise ValueError(f"lane_finish: unsupported device {device}")
    if w < 1:
        raise ValueError("lane_finish: the kernel takes rows of at least one word")
    # the lane counts and the union count in one buffer, and the mask: the
    # entry zeroes what it accumulates into (the identity form writes every
    # mask word)
    counts = torch.empty(32 * w + 1, dtype=torch.int32, device=device)
    newly = torch.empty_like(g_invalid)
    if _lane_finish_entry is None:
        _lane_finish_entry = _build.entry("lane_finish", "lane_finish_launch")
    made = ctypes.c_int(0)  # the kernel launches the entry made
    perm_ptr = None if perm_clipped is None else perm_clipped.data_ptr()
    err = _lane_finish_entry(
        fb.data_ptr(), is_real.data_ptr(), perm_ptr, g_invalid.data_ptr(), newly.data_ptr(),
        counts.data_ptr(), n, w, g_invalid.shape[0], ctypes.addressof(made),
        torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"lane_finish: lane_finish_launch failed with CUDA error {err}")
    lane_finish_launches += made.value
    return counts[: 32 * w], counts[32 * w], newly


def topo_mirror_finish_lanes_step(n_tot: int, words: int):
    """The lane burst's epilogue as JAX's step: ``finish(is_real,
    perm_clipped, g_invalid_words, final_bits) -> (g_invalid_words,
    lane_counts int32[32*words], union_count, newly mask words)``, through
    :func:`lane_finish`."""

    def finish(is_real, perm_clipped, g_invalid, final_bits):
        lane_counts, union_count, newly = lane_finish(final_bits, is_real, perm_clipped, g_invalid)
        return g_invalid, lane_counts, union_count, newly

    return finish


def _lanes_stage_body(level_starts, n_tot: int, W: int, passes: int,
                      garrays: TopoGraphArrays, node_epoch0, perm_clipped, g_invalid,
                      seed_new_ids):
    """One lane-burst stage against ``g_invalid``: gate → sweep × passes
    (adaptive when ``passes <= 0``) → finish. Returns (g_invalid_words,
    lane_counts, union_count, newly mask words)."""
    node_epoch, seed_bits = topo_mirror_gate_lanes_step(n_tot, W)(
        garrays.is_real, node_epoch0, perm_clipped, g_invalid, seed_new_ids)
    state = run_topo_sweep_passes(level_starts, garrays, seed_bits, node_epoch, passes)
    del seed_bits  # as large as the state: let it go before the finish
    return topo_mirror_finish_lanes_step(n_tot, W)(
        garrays.is_real, perm_clipped, g_invalid, state.invalid_bits)


def _chain_stages(level_starts, n_tot: int, W: int, passes: int, garrays: TopoGraphArrays,
                  node_epoch0, perm_clipped, g_invalid, seed_mats, refresh=None):
    """The per-stage body the chain and the super-round share (JAX's
    ``_refresh_chain_program`` is one definition for both): each stage is
    one lane burst against the words the stages before it left, then, when
    ``refresh`` is given, the block refresh — the block's rows whose bits
    are set take the loader's fresh rows, turn valid when ``refresh
    ["valid"]`` is a tensor, and their bits clear (``block_refresh``), so
    the next stage cascades against a consistent block. ``refresh`` holds
    ``base``, ``fn``, ``largs``, ``values`` and ``valid`` (None leaves
    validity alone). ``g_invalid``, ``values`` and ``valid`` update IN
    PLACE. Returns (lane_counts int32[K, 32W], newly mask words [K, nw]):
    stage ``i``'s newly mask is the words ``lane_finish`` committed, JAX's
    ``pack_bool_bits(newly_dense)``."""
    counts, masks = [], []
    for mat in seed_mats:
        _, lane_counts, _, newly = _lanes_stage_body(
            level_starts, n_tot, W, passes, garrays, node_epoch0, perm_clipped, g_invalid, mat)
        counts.append(lane_counts)
        masks.append(newly)
        if refresh is not None:
            values = refresh["values"]
            fresh = loader_rows(refresh["fn"], refresh["largs"], values)
            block_refresh(g_invalid, values, fresh, refresh["valid"], refresh["base"])
            del fresh
    return torch.stack(counts), torch.stack(masks)


def topo_mirror_fused_lanes_step(level_starts: Tuple[int, ...], n_tot: int, words: int,
                                 passes: int = 1):
    """The lane burst: gate → sweep × ``passes`` → finish, the plain
    composition of what JAX fuses into one program (same results).
    Returns ``burst(garrays, node_epoch0, perm_clipped, g_invalid_words,
    seed_new_ids) -> (g_invalid_words, lane_counts, union_count, newly mask
    words)``."""
    level_starts = tuple(level_starts)

    def burst(garrays: TopoGraphArrays, node_epoch0, perm_clipped, g_invalid, seed_new_ids):
        return _lanes_stage_body(level_starts, n_tot, words, passes, garrays, node_epoch0,
                                 perm_clipped, g_invalid, seed_new_ids)

    return burst


def topo_mirror_fused_lanes_chain_step(level_starts: Tuple[int, ...], n_tot: int, words: int,
                                       passes: int, depth: int):
    """``depth`` consecutive lane bursts, stage ``i`` against the state
    stages ``< i`` left: :func:`_chain_stages` where JAX runs a ``lax.scan``
    in one program (same results; on the card the caller captures it as one
    CUDA graph, ``graph/program_cache.py``). Takes ``seed_mats``
    int32[depth, 32*words, S]. Returns ``chain(garrays, node_epoch0,
    perm_clipped, g_invalid_words, seed_mats) -> (g_invalid_words,
    lane_counts int32[depth, 32*words], newly mask words [depth, nw])``."""
    level_starts = tuple(level_starts)

    def chain(garrays: TopoGraphArrays, node_epoch0, perm_clipped, g_invalid, seed_mats):
        if seed_mats.shape[0] != depth:
            raise ValueError(f"lanes chain: {seed_mats.shape[0]} stages, built for {depth}")
        counts, masks = _chain_stages(level_starts, n_tot, words, passes, garrays, node_epoch0,
                                      perm_clipped, g_invalid, seed_mats)
        return g_invalid, counts, masks

    return chain


def topo_mirror_superround_step(level_starts, n_tot: int, words: int, passes: int, base: int,
                                n_rows: int, fn, update_valid: bool):
    """K live rounds of (lane burst → block refresh through the memo
    table's device loader → the round's packed newly mask), round ``i+1``
    cascading against the state round ``i`` left: JAX's resident
    super-round (``lax.scan`` over rounds, the dense invalid state and the
    memo columns in the carry). Here the carry is the tensors themselves,
    updated IN PLACE, and the rounds are :func:`_chain_stages` with the
    refresh; on the card the caller captures the whole super-round as ONE
    CUDA graph (``graph/program_cache.py``). A super-round of K rounds
    equals K sequential (``cascade_rows_lanes`` → ``refresh_block_on_device``)
    pairs. Returns ``superround(values, valid_dev, garrays, node_epoch0,
    perm_clipped, g_invalid_words, seed_mats, *largs) -> (g_invalid_words,
    values, valid_dev, lane_counts int32[K, 32*words], newly mask words
    [K, nw])``; ``valid_dev`` is updated only when ``update_valid``. ``fn``
    is the loader ``(ids, *largs) -> rows``."""
    level_starts = tuple(level_starts)

    def superround(values, valid_dev, garrays, node_epoch0, perm_clipped, g_invalid, seed_mats,
                   *largs):
        if values.shape[0] != n_rows:
            raise ValueError(f"super-round: {values.shape[0]} value rows, built for {n_rows}")
        refresh = {"base": base, "fn": fn, "largs": largs, "values": values,
                   "valid": valid_dev if update_valid else None}
        counts, masks = _chain_stages(level_starts, n_tot, words, passes, garrays, node_epoch0,
                                      perm_clipped, g_invalid, seed_mats, refresh)
        return g_invalid, values, valid_dev, counts, masks

    return superround
