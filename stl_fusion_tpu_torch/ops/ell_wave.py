"""ELL adjacency with virtual forwarding trees, and the lone-wave lat kernels.

Port of ``stl_fusion_tpu/ops/ell_wave.py``: the host half (``EllGraph``,
``build_ell``, ``widen_ell``) and the lone-wave latency path
(``build_ell_lat_wave``, ``ell_live_epoch_init``, ``ell_live_union_step``,
``ell_live_union_chain_step``).

**Host half.** Every node keeps at most ``k`` out-slots; a node with more
dependents fans out through a k-ary tree of virtual nodes. The native
packer (``csrc/graphpack.cpp``, built by ``ops/_build.py::load_host``) does
it with counting sorts; ``use_native=False`` selects the numpy layered
construction. The two number virtual ids differently; reachability is the
same. ``use_native=True`` builds the library or raises.

**Lat waves.** XLA programs in the JAX package, torch programs here: the
level frontier is a COMPACT sorted id list (``lcap`` slots), dedup and
membership go through a tagged merge-sort against the sorted
accumulated-wave list (``cap`` slots), and the wave's state is written
once at its end. The ``lax.while_loop`` condition becomes one host read per
level (the frontier's size and the overflow flag), as ``ops/wave.py`` does
for the dense wave. A wave wider than ``lcap`` on a level or ``cap`` in all
aborts WITHOUT touching state and reports the overflow.

The live step reads and writes the dense graph's invalid state as the
port keeps it: packed int32 words (node ``i`` is bit ``i & 31`` of word
``i >> 5``). Its commit sets only bits that were clear (a newly id was
valid, and ids are unique), so adding each id's bit into its word with
``index_add_`` is exactly the OR, with no race where ids share a word.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .bitops import unpack_bits
from .wave import _bit_at

__all__ = [
    "EllGraph",
    "EllGraphArrays",
    "EllWaveState",
    "advance_epoch",
    "build_ell",
    "build_ell_lat_wave",
    "ell_live_epoch_init",
    "ell_live_union_chain_step",
    "ell_live_union_step",
    "invalid_mask",
    "widen_ell",
]


class EllGraph(NamedTuple):
    """Host-built ELL graph (device arrays are made by the wave builders)."""

    ell_dst: np.ndarray  # int32[n_tot+1, k] — out-slot targets; pad = n_tot
    ell_epoch: np.ndarray  # int32[n_tot+1, k] — captured target epochs; pad -1
    is_real: np.ndarray  # bool[n_tot+1] — False for virtual forwarding nodes
    n_real: int
    n_tot: int
    k: int


def _native_build_ell(src, dst, n_nodes: int, k: int):
    """(ell_dst int32[n_tot+1, k], n_tot) from the native packer."""
    from ._build import load_host

    lib = load_host("graphpack")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    handle = lib.gp_build_ell(
        src.ctypes.data_as(ctypes.c_void_p), dst.ctypes.data_as(ctypes.c_void_p),
        len(src), n_nodes, k, 1,
    )
    try:
        n_tot = int(lib.gp_n_tot(handle))
        ell_dst = np.empty((n_tot + 1, k), dtype=np.int32)
        rc = lib.gp_fill_out(handle, ell_dst.ctypes.data_as(ctypes.c_void_p), k)
        if rc != 0:
            raise RuntimeError(f"graphpack: ELL degree bound violated (gp_fill_out rc={rc})")
        return ell_dst, n_tot
    finally:
        lib.gp_free(handle)


def build_ell(
    src: np.ndarray, dst: np.ndarray, n_nodes: int, k: int = 4, use_native: bool = True
) -> EllGraph:
    """Rewrite an edge list into ELL(k) with virtual forwarding trees.

    ``use_native=True``: the counting-sort packer (~1 s at 10M nodes).
    ``use_native=False``: the numpy layered construction — in each round,
    nodes whose out-list exceeds ``k`` get it chunked into groups of ``k``
    hung under fresh virtual nodes (rounds ≈ log_k(max degree))."""
    if use_native:
        ell_dst, n_tot = _native_build_ell(src, dst, n_nodes, k)
        ell_epoch = np.where(ell_dst != n_tot, 0, -1).astype(np.int32)
        is_real = np.zeros(n_tot + 1, dtype=bool)
        is_real[:n_nodes] = True
        return EllGraph(ell_dst, ell_epoch, is_real, n_nodes, n_tot, k)

    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    next_virtual = n_nodes
    final_src: List[np.ndarray] = []
    final_dst: List[np.ndarray] = []

    cur_src, cur_dst = src, dst
    while len(cur_src):
        order = np.argsort(cur_src, kind="stable")
        s, d = cur_src[order], cur_dst[order]
        _, starts, counts = np.unique(s, return_index=True, return_counts=True)
        rank = np.arange(len(s)) - np.repeat(starts, counts)
        deg = np.repeat(counts, counts)
        small = deg <= k
        final_src.append(s[small])
        final_dst.append(d[small])
        bs, bd, brank = s[~small], d[~small], rank[~small]
        if len(bs) == 0:
            break
        chunk = brank // k
        # one virtual id per (source, chunk)
        _, grp_first, grp_inv = np.unique(
            bs * (chunk.max() + 1) + chunk, return_index=True, return_inverse=True
        )
        virtual_ids = next_virtual + np.arange(len(grp_first))
        next_virtual += len(grp_first)
        final_src.append(virtual_ids[grp_inv])  # virtual → original dst (≤ k each)
        final_dst.append(bd)
        cur_src = bs[grp_first]  # next round: source → its virtual children
        cur_dst = virtual_ids

    n_tot = next_virtual
    ell_dst = np.full((n_tot + 1, k), n_tot, dtype=np.int32)
    ell_epoch = np.full((n_tot + 1, k), -1, dtype=np.int32)
    fs = np.concatenate(final_src) if final_src else np.empty(0, np.int64)
    fd = np.concatenate(final_dst) if final_dst else np.empty(0, np.int64)
    if len(fs):
        order = np.argsort(fs, kind="stable")
        fs, fd = fs[order], fd[order]
        _, starts, counts = np.unique(fs, return_index=True, return_counts=True)
        slot = np.arange(len(fs)) - np.repeat(starts, counts)
        if slot.max() >= k:
            raise RuntimeError("ELL transform failed to bound out-degree")
        ell_dst[fs, slot] = fd
        ell_epoch[fs, slot] = 0  # all targets start at epoch 0
    is_real = np.zeros(n_tot + 1, dtype=bool)
    is_real[:n_nodes] = True
    return EllGraph(ell_dst, ell_epoch, is_real, n_nodes, n_tot, k)


def widen_ell(graph: EllGraph, extra: int) -> EllGraph:
    """Append ``extra`` guaranteed-free pad columns to every row (slot
    headroom for in-place patching of a live mirror)."""
    if extra <= 0:
        return graph
    rows = graph.ell_dst.shape[0]
    return graph._replace(
        ell_dst=np.hstack([graph.ell_dst, np.full((rows, extra), graph.n_tot, dtype=np.int32)]),
        ell_epoch=np.hstack([graph.ell_epoch, np.full((rows, extra), -1, dtype=np.int32)]),
        k=graph.k + extra,
    )


class EllWaveState(NamedTuple):
    """Persistent lat-wave state. Node x is invalid iff ``inv_stamp[x] ==
    epoch``, so making the whole graph consistent again is ``epoch + 1``
    (O(1)). ``epoch`` is a host int here (JAX keeps a device scalar): the
    waves compare against it and never need it on the device.
    ``frontier`` is unused by the lat wave (the JAX bucketed wave's scratch)."""

    node_epoch: torch.Tensor  # int32[n_tot+1]
    inv_stamp: torch.Tensor  # int32[n_tot+1] — last epoch each node was invalidated in
    epoch: int  # current consistency epoch (≥ 1)
    frontier: torch.Tensor  # int32[0]


def advance_epoch(state: EllWaveState) -> EllWaveState:
    """All nodes consistent again in O(1): stale stamps never equal the new epoch."""
    return state._replace(epoch=state.epoch + 1)


def invalid_mask(state: EllWaveState) -> np.ndarray:
    """bool[n_tot+1] — the materialized invalid set (host readback)."""
    return state.inv_stamp.cpu().numpy() == int(state.epoch)


class EllGraphArrays(NamedTuple):
    """Device-resident ELL adjacency."""

    ell_dst: torch.Tensor  # int32[n_tot+1, k]
    ell_epoch: torch.Tensor  # int32[n_tot+1, k]
    is_real: torch.Tensor  # bool[n_tot+1]


def _dedup_first(sorted_ids: torch.Tensor) -> torch.Tensor:
    prev = torch.cat([sorted_ids.new_full((1,), -1), sorted_ids[:-1]])
    return sorted_ids != prev


def _first_slots(ids: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    """The first ``n`` entries of ``ids``, padded with ``fill`` to ``n``."""
    out = ids[:n]
    if out.shape[0] < n:
        out = torch.cat([out, out.new_full((n - out.shape[0],), fill)])
    return out


def _merge_level(acc, cand, n_tot: int, lcap: int, cap: int):
    """Tagged merge of one level's candidates into the accumulated wave:
    acc entries (even keys) sort before candidates (odd keys), so a
    candidate is new only if it is the first of its id. Returns (next
    frontier int32[lcap], its size, next acc int32[cap], acc's size), the
    sizes as 0-d device tensors."""
    keys = torch.sort(torch.cat([acc * 2, cand * 2 + 1])).values
    ids = keys >> 1
    first = _dedup_first(ids) & (ids < n_tot)
    isnew = first & ((keys & 1) == 1)
    nf = isnew.sum()
    f_next = torch.sort(torch.where(isnew, ids, n_tot)).values[:lcap]
    n_all = first.sum()
    acc_next = torch.sort(torch.where(first, ids, n_tot)).values[:cap]
    return f_next, nf, acc_next, n_all


def _expand(f, nf, acc, over, level_candidates, n_tot: int, lcap: int, cap: int):
    """The level loop: while the frontier is non-empty and nothing
    overflowed, merge the next level's candidates. One host read per level
    (the JAX loop condition). Returns (acc, overflow as a host bool)."""
    while True:
        nf_h, over_h = torch.stack([nf, over.to(nf.dtype)]).tolist()
        if nf_h == 0 or over_h:
            return acc, bool(over_h)
        f, nf, acc, n_all = _merge_level(acc, level_candidates(f), n_tot, lcap, cap)
        over = over | (nf > lcap) | (n_all > cap)


def build_ell_lat_wave(
    graph: EllGraph,
    lcap: int = 1024,
    cap: int = 16384,
    assume_static_epochs: bool = False,
    device=None,
):
    """The LONE-WAVE latency kernel: a shallow edit's cascade in O(wave)
    device work, with no scatter inside the level loop.

    Returns (initial_state, lat_wave) with ``lat_wave(seed_ids, state) ->
    (state, count, overflow)``: ``seed_ids`` int32 (-1-padded), the count of
    newly-invalid real nodes and the overflow flag as host values. The
    commit updates ``state.inv_stamp`` IN PLACE (JAX returns a new array);
    on overflow nothing is written and the count is 0.
    ``assume_static_epochs=True`` elides the per-level epoch gathers — valid
    only when every captured edge epoch is 0, which the builder checks.
    ``lat_wave.garrays`` is the device adjacency."""
    device = resolve_device(device)
    n_tot = graph.n_tot
    if 2 * (n_tot + 1) >= 2**31:
        raise ValueError("tagged-sort keys need 2*(n_tot+1) < 2^31")
    if assume_static_epochs:
        live_slots = graph.ell_dst != n_tot
        if not (graph.ell_epoch[live_slots] == 0).all():
            raise ValueError("assume_static_epochs requires all captured edge epochs == 0")

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)

    garrays = EllGraphArrays(up(graph.ell_dst), up(graph.ell_epoch), up(graph.is_real))
    node_epoch = torch.zeros(n_tot + 1, dtype=torch.int32, device=device)
    node_epoch[n_tot] = -2
    state0 = EllWaveState(
        node_epoch, torch.zeros(n_tot + 1, dtype=torch.int32, device=device), 1,
        torch.zeros(0, dtype=torch.int32, device=device),
    )

    def lat_wave(seed_ids, state: EllWaveState):
        ell_dst, ell_epoch, is_real = garrays
        node_epoch, inv_stamp, epoch = state.node_epoch, state.inv_stamp, state.epoch
        seed_ids = torch.as_tensor(seed_ids, dtype=torch.int32, device=device).reshape(-1)
        # ---- seed stage: dedup by sort, no graph-sized work
        safe = torch.where((seed_ids >= 0) & (seed_ids < n_tot), seed_ids, n_tot)
        ok = (safe < n_tot) & (inv_stamp[safe] != epoch)
        skeys = torch.sort(torch.where(ok, safe, n_tot)).values
        fresh = _dedup_first(skeys) & (skeys < n_tot)
        nf0 = fresh.sum()
        f0 = _first_slots(torch.sort(torch.where(fresh, skeys, n_tot)).values, lcap, n_tot)
        m0 = min(cap, skeys.shape[0])
        acc0 = torch.full((cap,), n_tot, dtype=torch.int32, device=device)
        acc0[:m0] = torch.where(fresh, skeys, n_tot)[:m0]
        acc0 = torch.sort(acc0).values

        def candidates(f):
            rows = ell_dst[f]  # [lcap, k]; pad slots read the null row
            live = (inv_stamp[rows] != epoch) & (rows < n_tot)
            if not assume_static_epochs:
                live &= node_epoch[rows] == ell_epoch[f]
            return torch.where(live, rows, n_tot).reshape(-1)

        acc, over = _expand(f0, nf0, acc0, nf0 > lcap, candidates, n_tot, lcap, cap)
        if over:
            return state, 0, True
        # ---- single commit: stamp the whole wave at once
        valid = acc < n_tot
        inv_stamp.scatter_reduce_(
            0, acc.long(), torch.where(valid, epoch, torch.iinfo(torch.int32).min).to(torch.int32),
            reduce="amax",
        )
        return state, int((valid & is_real[acc]).sum()), False

    lat_wave.garrays = garrays
    return state0, lat_wave


@functools.lru_cache(maxsize=8)
def ell_live_epoch_init(n_nodes: int, n_cap: int):
    """The lat mirror's per-slot captured epochs, derived from the dense
    graph's resident epoch array: slot target real → its current epoch;
    virtual or pad → 0 (forwarding nodes never version). Returns
    ``derive(ell_dst, node_epoch)``."""

    def derive(ell_dst, node_epoch):
        real = ell_dst < n_nodes
        return torch.where(real, node_epoch[ell_dst.clamp(0, n_cap)], 0).to(torch.int32)

    return derive


@functools.lru_cache(maxsize=8)
def ell_live_union_step(n_tot: int, n_nodes: int, n_cap: int, lcap: int, cap: int):
    """The LIVE lone-wave kernel: O(closure) union expansion over the lat
    mirror's out-ELL, gated by the live dense state. Returns ``step(ell_dst,
    ell_epoch, node_epoch, g_invalid, seed_ids) -> (g_invalid, count, acc,
    overflow)``:

    - ``g_invalid`` is the dense graph's PACKED invalid words; the commit
      sets the newly bits in place and returns the same tensor;
    - liveness: slot (u→d) fires iff d is virtual (forwarding trees never
      version) or ``node_epoch[d] == ell_epoch[u, slot]``;
    - blocking: an already-invalid REAL node neither counts, re-fires nor
      conducts; seeds conduct even when already invalid but never count;
    - ``count`` (host int) counts newly-invalid real ids; ``acc`` is the
      sorted wave id list (real and virtual, pads ``n_tot``) — the real ids
      are its first ``count`` entries;
    - a frontier > ``lcap`` on a level or a wave > ``cap`` aborts WITHOUT
      touching state: ``overflow=True``, count 0, ``acc`` all pads."""
    if 2 * (n_tot + 1) >= 2**31:
        raise ValueError("tagged-sort keys need 2*(n_tot+1) < 2^31")

    def step(ell_dst, ell_epoch, node_epoch, g_invalid, seed_ids):
        device = g_invalid.device
        seed_ids = torch.as_tensor(seed_ids, dtype=torch.int32, device=device).reshape(-1)
        # ---- seed stage: pre-invalid seeds CONDUCT (enter the frontier)
        # but are never newly (never enter acc)
        safe = torch.where((seed_ids >= 0) & (seed_ids < n_tot), seed_ids, n_tot)
        skeys = torch.sort(safe).values
        uniq = _dedup_first(skeys) & (skeys < n_tot)
        fresh = uniq & ~_bit_at(g_invalid, skeys.clamp(0, n_cap))
        nf0 = uniq.sum()
        f0 = _first_slots(torch.sort(torch.where(uniq, skeys, n_tot)).values, lcap, n_tot)
        m0 = min(cap, skeys.shape[0])
        acc0 = torch.full((cap,), n_tot, dtype=torch.int32, device=device)
        acc0[:m0] = torch.sort(torch.where(fresh, skeys, n_tot)).values[:m0]
        over0 = (nf0 > lcap) | (fresh.sum() > cap)

        def candidates(f):
            d = ell_dst[f].reshape(-1)  # pad frontier slots read the null row
            e = ell_epoch[f].reshape(-1)
            is_pad = d >= n_tot
            is_virtual = (d >= n_nodes) & ~is_pad
            dc = d.clamp(0, n_cap)
            epoch_ok = is_virtual | (node_epoch[dc] == e)
            unblocked = is_virtual | ~_bit_at(g_invalid, dc)
            return torch.where(~is_pad & epoch_ok & unblocked, d, n_tot)

        acc, over = _expand(f0, nf0, acc0, over0, candidates, n_tot, lcap, cap)
        if over:
            return g_invalid, 0, torch.full_like(acc, n_tot), True
        # ---- single commit into the live packed words: each newly bit is
        # clear (its node was valid) and each id appears once, so adding the
        # bits into their words is the OR
        newly = acc < n_nodes
        word = torch.where(newly, acc >> 5, 0).long()
        bit = torch.where(newly, torch.bitwise_left_shift(torch.ones_like(acc), acc & 31), 0)
        g_invalid.index_add_(0, word, bit)
        return g_invalid, int(newly.sum()), acc, False

    return step


@functools.lru_cache(maxsize=8)
def ell_live_union_chain_step(n_tot: int, n_nodes: int, n_cap: int, lcap: int, cap: int,
                              out_cap: int):
    """M independent lone waves SEQUENCED against the live state: wave ``i``
    sees waves ``< i``'s commits, so the final state and per-wave counts
    equal M :func:`ell_live_union_step` calls. JAX runs them as one
    ``lax.scan`` program; here they are a loop over the same step. A wave
    that overflows commits nothing and flags its slot (the caller re-runs
    it on the topo sweep). Returns ``step(ell_dst, ell_epoch, node_epoch,
    g_invalid, seed_mat[M, S]) -> (g_invalid, counts int64[M] host, overs
    bool[M] host, out_ids int32[out_cap], out_count, out_over)``: the
    union's newly ids ascending, -1-padded, with its count and overflow on
    the host."""
    core = ell_live_union_step(n_tot, n_nodes, n_cap, lcap, cap)

    def step(ell_dst, ell_epoch, node_epoch, g_invalid, seed_mat):
        g_invalid0 = g_invalid.clone()
        m = int(seed_mat.shape[0])
        counts = np.zeros(m, dtype=np.int64)
        overs = np.zeros(m, dtype=bool)
        for i in range(m):
            _, counts[i], _, overs[i] = core(ell_dst, ell_epoch, node_epoch, g_invalid, seed_mat[i])
        newly = unpack_bits(g_invalid & ~g_invalid0, n_cap + 1)
        ids = torch.nonzero(newly).flatten().to(torch.int32)  # ascending
        out_count = int(ids.shape[0])
        out = torch.full((out_cap,), -1, dtype=torch.int32, device=g_invalid.device)
        out[: min(out_count, out_cap)] = ids[:out_cap]
        return g_invalid, counts, overs, out, out_count, out_count > out_cap

    return step
