#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stl_fusion_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``stl_fusion_tpu_torch/csrc`` and
runs the cascading-invalidation wave end to end through the entry points a
user calls. Phases, each printing one JSON line:

1. ``device``   — the card's name, device count, ``nvidia-smi`` name and power
   limit;
2. ``build``    — ``nvcc`` compiles every kernel (``-Xptxas -v`` registers and
   spills) and ``g++`` the mirrors' host graph packer;
3. ``hellocart`` — the HelloCart v1 chain (Product → Cart → Total) on a
   ``FusionHub`` with the port's ``TpuGraphBackend`` on the card: a host-led
   change through ``invalidating()``, ``invalidate_cascade``,
   ``invalidate_cascade_batch`` and one ``invalidate_cascade_batch_sharded``
   burst on an 8-shard mesh on the card, with the watched node applied
   eagerly, the rest pending, and the recomputed totals right; then
   ``build_topo_mirror`` and one burst through the lat mirror, and the
   same burst with the mirror built but ``mirror="off"``: identical; then
   one ``invalidate_cascade_batch_lanes`` burst of 3 groups on the patched
   mirror, each group's count equal to its union wave alone; then the same
   3 groups as one ``invalidate_cascade_batch_lanes_sharded`` burst on the
   8-shard mesh (the packed mesh mirror), each count equal to the
   single-card lane burst's;
4. ``power_law_10m`` — the BASELINE stress graph (``power_law_dag(10M,
   avg_degree=3, seed=7)``) in ``DeviceGraph(device="cuda")`` with 1% of nodes
   epoch-bumped after capture: ``run_waves_union`` from 100,000 seeds,
   ``run_wave_collect`` from 256 shallow seeds and ``run_wave_with_stats``
   from hub nodes, each held EXACTLY against an independent numpy level-BFS
   oracle on a src-sorted CSR; the union wave must make one merged
   ``wave_expand`` launch per level and only two ``or_popcount`` launches
   (the seed merge and the finalize's delta form), the collect wave one
   (the seed gate);
5. ``sharded_10m`` — the same graph and epochs as a ``ShardedDeviceGraph``
   on a mesh of 8 logical shards on the card: the 100,000-seed ``run_wave``
   with ``exchange="ring"`` (the ring all-gather kernel), ``"packed"`` and
   ``"bool"``, and ``run_wave_collect`` from the 256 shallow seeds, each held
   EXACTLY against the same oracle; each wave must make ONE ``wave_expand``
   launch per level for all 8 shards, one ring gather (one CUDA launch) per
   level on the ring, and ONE ``or_popcount`` launch (the shards form) for
   the seed merge of all 8 shards;
6. ``mirror_10m`` — ``build_topo_mirror`` on ``power_law_10m``'s graph,
   then the 100,000-seed union as ONE topo sweep (one ``topo_sweep`` launch
   per non-empty level, no ``wave_expand``) and the 256 shallow seeds as one
   lat wave, each equal to the dense wave's result;
7. ``topo_10m`` — the twin of ``bench.py``'s single-chip leg
   (``stl_fusion_tpu_torch/bench.py``): 512 packed waves of 100,000 seeds
   in one sweep at W=16; counts and bits equal to the plain sweep's, lanes
   0, 31, 32 and 511 equal to the oracle; ``cascading_invalidations_per_sec``,
   the sweep's device time and idle share, its bound; the lat leg's 96
   lone waves (p50/p99/max; three checked against the oracle);
7b. ``packed_10m`` — the twin of ``bench.py::run_sharded`` on
   ``topo_10m``'s graph and 512 seed lists: ``PackedShardedGraph(words=16)``
   on 8 logical shards, one batch of 512 waves (``run_wave_batches``, a
   warm-up and 5 timed runs), per-lane counts equal to the topo sweep's,
   lanes 0, 31, 32 and 511 equal to the oracle, ``packed_pull`` launched
   once per level run plus the seed step and the group's early exits, no
   ``topo_sweep`` and no ``wave_expand``; ``cascading_invalidations_per_sec``,
   levels, host syncs per wave, device time and idle share of one profiled
   batch, peak memory; then the ``packed=False`` branch (20 waves, each
   equal to its topo lane) and the pull leg (``kernel="pull"``, 32 waves at
   W = 1, its count the sum of lanes 0-31, lanes 0 and 31 the oracle's);
7c. ``mesh_80m`` — the routed mesh wave (:func:`phase_mesh_80m`) through the
   twin of ``perf/mesh_path.py`` (``stl_fusion_tpu_torch/mesh_path.py``):
   its static leg at the defaults (``power_law_dag(80M)``, 4 members, 256
   shards on 8 logical shards, ``a2a``, 2 waves of 100,000 seeds, wave 0
   equal to the host BFS), one wave profiled, the ``routed_level`` rows
   made there (the a2a level at the widest level, the seed step on waves
   0 and 1's seeds); ``gather``, ``tree`` and ``hier`` (2 hosts of 4) on
   ``power_law_10m``'s graph, each equal to its dense union with equal
   levels, with the gather and hier lookups' rows at their widest levels;
   the async A/B at its defaults (bit-identical masks, strictly fewer
   merges) with the speculative form's row at its widest speculative
   level. The graphs are freed before the live stack is built;
8. ``profile`` — ``torch.profiler`` over one more 10M union wave and one
   sharded ring wave: device time by kernel, device calls per wave, the
   device's idle share, and the level kernel's launches (one per level);
   then ``wave_ops``: one union wave and one gated ``run_wave``, each
   making only its ``or_popcount`` forms' launches (merge and delta; gate)
   and dispatching no ``aten.bitwise_not`` (the elementwise gate and
   finalize that e0d54c8 ran around ``or_popcount``);
9. ``churn_10m`` — the mirror of ``mirror_10m`` serving a churning graph,
   in ``perf/live_path.py``'s shape (6 rounds of 2,000 level-ordered edges,
   one level-violating edge in the run, and 4 recomputes, each round then
   one 512-group lane burst of 8 seeds a group): every burst rides the
   patched mirror (no synchronous rebuild), its union equals the dense
   union and lanes 0, 31, 32 and 511 their dense waves; 2 passes after the
   violating edge and the adaptive sweep equal to them; sequenced lone
   waves and the patched lat mirror equal to their dense counterparts; a
   background re-level after round 3, installed while rounds go on, and
   1 pass and an exact burst after it; patch and burst ms, one burst
   profiled, the re-level's seconds, peak memory;
10. ``live_10m`` — the twin of ``perf/live_path.py``'s blocking loop
   (``stl_fusion_tpu_torch/live_path.py``) on ``power_law_10m``'s edge
   arrays: a table-backed service bound as one 10M-row block, its edges
   declared in bulk, warmed on the card, the topo mirror built; lone waves
   and a sequenced batch of row waves; then 6 rounds of churn (2,000
   level-ordered edges, one violating edge in the run, 4 scalar recomputes
   of adopted rows), ``refresh_block_on_device`` (the ``block_refresh``
   kernel) and a 512-group ``cascade_rows_lanes`` burst. Every refresh and
   burst is held exactly (see :func:`phase_live`); ``read_batch`` of 1M
   device ids equals ``base[ids]``; one ``live_10m_round`` line a round;
10b. ``live_sr_10m`` — on the same stack after the blocking loop, the
   twin's super-round loop (``perf/live_path.py``'s default: 6 rounds at
   depth 3 after an untimed warm, each super-round ONE replay of a captured
   CUDA graph of ``topo_sweep``, ``lane_finish`` and ``block_refresh``) and
   its chain loop (3 rounds); the first super-round held exactly against 3
   sequential burst + refresh pairs; no eager round; each captured graph's
   launches per replay as expected; one ``live_sr_10m_superround`` line per
   super-round (host ms and its split, device ms around the replay), then
   ``live_inv_per_s`` of each mode, occupancy, host stall, captures and
   peak memory;
10c. ``mesh_lanes_10m`` — on the same stack after ``live_sr_10m``, a
   blocking loop of the live twin whose burst is a 512-group
   ``cascade_rows_lanes_sharded`` on 8 logical shards (3 rounds of churn,
   refresh and burst): round 1 builds the packed mesh mirror, rounds 2-3 patch it in
   place (the same entry, ``patches`` rising, the patch batch counter up by
   one a round); each burst equal to ``cascade_rows_lanes`` run from the
   same state (counts, dense words, union, stale rows); one
   ``mesh_lanes_10m_round`` line a round (build s or patch ms, burst ms and
   its gated and apply parts from the backend's wave record, launches,
   levels), the last burst profiled;
10d. ``write_10m`` — on the same stack after ``mesh_lanes_10m``, the write
   path (:func:`phase_write`): the live twin's snapshot of the 10M graph
   loaded on the card with equal arrays and union waves; two hosts and one
   sqlite operation log; host A's 512 commands replayed by host B's reader
   as ONE lane burst, exact against ``cascade_rows_lanes`` from the same
   state, every written row read back; the next 512 by a reader with
   ``mesh=`` as ONE mesh burst, equal lane by lane to the single-card burst
   (profiled), its host ms split by part; two local writes' host-led
   cascades (a mid-sized and a graph-wide closure), each equal to the dense
   wave; a ``HubCheckpoint`` resume that invalidates exactly the rows
   written after the snapshot; one ``write_10m_*`` line a step (commit
   p50/p99, ``read_new`` split, burst device ms and idle share, snapshot
   seconds and bytes, peak memory);
10e. ``fanout_10m`` — on the same stack after ``write_10m``, the twin of
   ``perf/fanout_path.py`` (``stl_fusion_tpu_torch/fanout_path.py``,
   :func:`phase_fanout`): 100 RPC clients (one over TCP loopback, the rest
   in memory with the wire codec), 16 subscribed tail keys and 4 keys
   outside the bursts' union each; 2 rounds of ``perkey`` then
   ``coalesced`` 32-group lane bursts, each fencing exactly the subscribed
   keys inside the union, each once; a host-led leg equal to the dense
   closure; the lone A/B; a ``RemoteTable`` of 1M ids whose re-read after
   a burst fetches exactly the stale rows; one ``fanout_10m_round`` line a
   round and a ``fanout_10m`` summary;
10f. ``edge_10m`` — on the same stack after ``fanout_10m``, the twin of
   ``perf/edge_path.py`` (``stl_fusion_tpu_torch/edge_path.py``,
   :func:`phase_edge`) at the script's defaults on the 10M rows: 4
   ``EdgeNode`` gateways over the wire codec, 2 delivery worker processes
   an edge on the ``send_fds`` plane, 512 tail-row keys and 1,000,000
   sessions of 2 keys by zipf 1.1; 2 measured 16-group lane bursts on the
   block value plane, each held exactly (512 upstream subscriptions an
   edge, 2,048 on the server, every delivery once at the server's value,
   no eviction, no upstream RPC, every fence a block hit), the last one
   profiled; the encode gates; the smoke leg (a real ``EdgeHttpServer``
   with SSE consumers over TCP loopback, a ``/metrics`` scrape, one burst,
   the pool's listener); one ``edge_10m_round`` line a round and an
   ``edge_10m`` summary with both delivery clocks;
10g. ``resilience_10m`` — on the same stack after ``edge_10m``, the wave
   watchdog (:func:`phase_resilience`): a fused 32-group burst, an
   injected fault re-run on the split host loop (dense waves on the card,
   its union that of the fused burst on a snapshot), the oracle-verified
   re-engagement, a deadline trip and its recovery, a faulted super-round
   (the block re-staled and refreshed, the rounds eager, 4,096 rows equal
   to the service's), ``explain`` naming the last burst's cause, the
   sampled invariant sweeps, the monitor's resilience ledger and the
   gateway's ``/explain``, ``/health`` and ``/trace`` at 200; every count
   exact; one ``resilience_10m`` line;
10h. ``mesh_live_10m`` — on the same stack after ``resilience_10m``, the
   twin's live routed leg (:func:`phase_mesh_live`):
   ``enable_mesh_routing`` of a 2-member, 64-shard map on 8 logical shards
   (``a2a``), the external RPC client through ``set_mesh_scope``, 3 rounds
   of 4 groups through ``WavePipeline(fuse_depth=4)``, the chain-difference
   latency, the kill reshard (shards must move), 3 groups after it, one
   routed super-round of 3 rounds in one dispatch, a
   ``save_mesh_shards``/``restore_mesh_shards`` round trip; every wave's
   count equal to the host BFS over the live edges, the script's gates;
10i. ``read_1k`` — the twin of ``perf/read_throughput.py``
   (``stl_fusion_tpu_torch/read_throughput.py``, :func:`phase_read`): 1000
   users over sqlite, every mode with its tables on the card (the
   host-only ones at ``--quick``'s counts), each passing its exactness
   check; the device chain against its bound; one ``read_1k`` line;
11. ``kernels`` — every kernel form against its plain PyTorch version on the
   card, exact: ``or_popcount``'s four forms (merge, gate, delta at n = 7,
   128, 40,000 and 524,289 words, aliased as the main path calls them, and
   shards on the mesh's 8 × 39,064 words), each with a row at the main
   path's shape timed in turns against e0d54c8's wrapper and kernel doing
   the same job when the reference tree is there, and the launch path's
   host cost on a one-word call (``_build.launch``, ``_build.entry``, the
   wrapper); ``topo_sweep`` (the whole topo_10m sweep,
   its widest level alone, the lane burst's sweep on the churned mirror,
   with its changed flag held against a before/after comparison, and a
   sweep at k = 10 in-slots on a ``build_topo_mirror(k=8)`` mirror with
   patched rows past 8 slots); ``lane_finish`` on that burst's bits, and at
   W = 64 (the column-chunked form), each with its launches a call;
   ``block_refresh`` at the live shape
   (and a correctness case at base 37 with int32 rows of 3); ``packed_pull``
   with its fired summaries, as the main path runs it, at ``packed_10m``'s
   level 0, widest, median and last levels (W = 16, k = 8), the last mesh
   burst's level 0, median and last levels (k = 10, gated) and the pull
   leg's level 0 (W = 1, the null row), each with the bound of what its
   inputs need beside the full-table bound, each also without the
   summaries and, when ``_smoke_tree/ref/packed_pull.cu`` (a reference
   source with the entry of the kernel before the fired summary, see
   :data:`REF_DIR`) is there, that kernel on the same inputs, timed in
   turns; ``lane_finish`` at the mesh shape (its identity form: no row
   map, as the mesh burst calls it);
   ``wave_expand`` (pure) and
   ``wave_expand_merge`` at the union wave's first and widest levels;
   ``wave_expand_shards`` at the sharded wave's first level; the ring from
   2-D rows (the main path's form) and from a list; ``routed_level``'s
   five rows (made and profiled in ``mesh_80m``, where their graphs live).
   Each with its time (CUDA
   events), its device time (``torch.profiler``), the plain version's time,
   the bound for the same work, and one PyTorch computation of the same
   function where there is one (the ring: the concatenation copied into
   all ``n`` rows; ``torch.cat`` alone is recorded beside it).

The whole script runs with ``FUSION_MIRROR_CACHE`` set to a fresh temporary
directory outside the checkout (removed at the end): phases 6 and 10 build
their 10M mirror (a miss, saved in the background), then build it again,
which loads the entry; the loaded tables must equal the built ones, and the
phase's checks run on the loaded mirror (``mirror_cache``: the cold build's
and the load's seconds).

The main path is fifteen paths, each driven with every kernel's launch count
set to 0 just before it and read just after: phases 3-4 (the dense wave,
with HelloCart's mesh lane burst) must launch each ``or_popcount`` form
and ``wave_expand_merge``, phase 5 (the sharded wave) ``or_popcount``'s
shards form and no other, ``wave_expand_shards`` and ``ring_all_gather``, phases 6-7 (the mirror)
``topo_sweep`` and no ``wave_expand``, phase 7b (the mesh leg)
``packed_pull`` and no ``topo_sweep`` or ``lane_finish``, phase 7c (the
routed mesh) ``routed_level``'s three forms and each of its lookups
(``gather``, ``a2a``, ``hier``) and no ``packed_pull``,
``topo_sweep`` or ``lane_finish``, phase 9 (the
churn) ``topo_sweep`` and ``lane_finish``, phase 10 (the live loop)
``topo_sweep``, ``lane_finish`` and ``block_refresh``, phase 10b (the
super-round and chain loops, whose launches are CUDA graph replays: each
replay adds the launches its capture recorded) the same three, phase
10c (the mesh loop) ``packed_pull`` and ``lane_finish``, phase 10d (the
write path) those of the lane and mesh bursts and the restored graph's
dense wave, and phases 10e (the fan-out) and 10f (the edge tier)
``topo_sweep``, ``lane_finish`` and ``block_refresh``, and no
``wave_expand``, ``or_popcount`` or ``packed_pull``, phase 10g (the
watchdog) those three and the split host loop's ``wave_expand_merge`` and
``or_popcount`` merge and delta, and no ``packed_pull``; phase 10h (the
live routed pipeline) ``routed_level`` (its a2a level and seed step) and
``block_refresh`` and no
``packed_pull``; phase 10i (the
read twin) runs torch's gathers and requires no hand-written kernel. Any
failure raises and the script exits non-zero. The last lines are the kernel
summary (the forms the main path runs), the ``nvidia-smi`` name and power
limit, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import asyncio
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, and
#: the non-tensor-core ALU rate used for the integer bit operations here
PEAK_BYTES_PER_S = 3.35e12
PEAK_ALU_OPS_PER_S = 67e12

N_NODES = 10_000_000
N_UNION_SEEDS = 100_000
GRAPH_SEED = 7
N_SHARDS = 8


#: the script's start on the host clock; each phase line carries its offset
T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps({**obj, "at_s": time.perf_counter() - T0}), flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, device, reps: int = 30, warmup: int = 3) -> float:
    """Mean ms per call: CUDA events around ``reps`` calls after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type != "cuda":  # CPU rehearsal only: host clock
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def reload_mirror_from_cache(g, device, cold_s: float) -> dict:
    """The disk mirror cache (``FUSION_MIRROR_CACHE``, set by :func:`main`):
    wait for the background save of the mirror ``g`` just built (a miss),
    drop it, and build again, which must LOAD the entry (a hit). The loaded
    tables must equal the built ones; the phase then runs on the loaded
    mirror. Returns the cold build's and the load's seconds."""
    import numpy as np
    import torch

    built = g._topo_mirror
    if g._mirror_cache_writer is None or g.mirror_cache_misses < 1:
        raise AssertionError("the mirror build did not go through the disk cache")
    t0 = time.perf_counter()
    g._mirror_cache_writer.join(300)
    save_wait_s = time.perf_counter() - t0
    path = g._mirror_cache_path(built["fp"], built["k"])
    if not os.path.exists(path):
        raise AssertionError(f"the mirror cache entry was not saved ({path})")
    hits0 = g.mirror_cache_hits
    g._topo_mirror, g._mirror_deltas = None, None
    t0 = time.perf_counter()
    m = g.build_topo_mirror(k=built["k"], cap=built["cap"])
    sync(device)
    load_s = time.perf_counter() - t0
    if g.mirror_cache_hits != hits0 + 1:
        raise AssertionError("the rebuild of the same edge set missed the disk cache")
    same = (np.array_equal(m["h_in_src"], built["h_in_src"])
            and m["level_starts"] == built["level_starts"]
            and np.array_equal(m["inv_perm"], built["inv_perm"])
            and torch.equal(m["garrays"].in_src, built["garrays"].in_src)
            and torch.equal(m["garrays"].is_real, built["garrays"].is_real)
            and torch.equal(m["perm_clipped"], built["perm_clipped"])
            and np.array_equal(m["lat"]["h_ell_dst"], built["lat"]["h_ell_dst"])
            and torch.equal(m["lat"]["ell_epoch"], built["lat"]["ell_epoch"]))
    if not same:
        raise AssertionError("the mirror loaded from the disk cache differs from the built one")
    return {"cold_build_s": cold_s, "load_s": load_s, **g.last_mirror_load,
            "save_wait_s": save_wait_s, "entry_bytes": os.path.getsize(path)}


# ------------------------------------------------------------------ oracle
class LevelBfsOracle:
    """Independent numpy wave: level BFS on a src-sorted CSR with the
    version-match rule (an edge fires only while its dependent's current
    epoch equals the epoch it was captured at, and only into a dependent
    that is not yet invalid)."""

    def __init__(self, src, dst, edge_epoch, node_epoch, n):
        import numpy as np

        order = np.argsort(src, kind="stable")
        self.dst = dst[order]
        self.live = node_epoch[self.dst] == edge_epoch[order]
        self.start = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n), out=self.start[1:])
        self.n = n

    def out_edges(self, nodes):
        import numpy as np

        deg = self.start[nodes + 1] - self.start[nodes]
        total = int(deg.sum())
        first = np.repeat(self.start[nodes] - (np.cumsum(deg) - deg), deg)
        return first + np.arange(total, dtype=np.int64)

    def wave(self, seeds, levels=None):
        """From an all-valid state: (sorted newly ids, count, depth). A
        ``levels`` list receives each level's frontier ids, seeds first."""
        import numpy as np

        invalid = np.zeros(self.n, bool)
        frontier = np.unique(np.asarray(seeds, np.int64))
        invalid[frontier] = True
        count, depth = len(frontier), 0
        while True:
            if levels is not None:
                levels.append(frontier)
            e = self.out_edges(frontier)
            e = e[self.live[e]]
            d = self.dst[e]
            nxt = np.unique(d[~invalid[d]]).astype(np.int64)
            if nxt.size == 0:
                return np.nonzero(invalid)[0].astype(np.int32), count, depth
            invalid[nxt] = True
            count += nxt.size
            depth += 1
            frontier = nxt


# ------------------------------------------------------------------ phases
def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    out = {"phase": "device", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(out)
    return out


def phase_build() -> dict:
    from stl_fusion_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    for name in _build.HOST_LIBS:  # g++, for the mirrors' graph packer
        _build.load_host(name)
        info["host:" + name] = _build.build_info.get("host:" + name, {"cached": True})
    out = {"phase": "build", "seconds": time.perf_counter() - t0, "kernels": info}
    emit(out)
    return out


async def _hellocart(device) -> dict:
    from stl_fusion_tpu_torch.core import ComputeService, FusionHub, capture, compute_method, invalidating
    from stl_fusion_tpu_torch.graph import TpuGraphBackend

    class Products(ComputeService):
        def __init__(self, hub):
            super().__init__(hub)
            self.price = {"apple": 2.0, "banana": 0.5, "cherry": 4.0}

        @compute_method
        async def get(self, pid: str) -> float:
            return self.price[pid]

    class Carts(ComputeService):
        def __init__(self, hub, products):
            super().__init__(hub)
            self.products = products
            self.items = {"alice": ("apple", "apple", "banana"), "bob": ("banana", "cherry")}

        @compute_method
        async def cart_total(self, cart: str) -> float:
            return sum([await self.products.get(p) for p in self.items[cart]])

    class Totals(ComputeService):
        def __init__(self, hub, carts):
            super().__init__(hub)
            self.carts = carts

        @compute_method
        async def total(self) -> float:
            return await self.carts.cart_total("alice") + await self.carts.cart_total("bob")

    def expect(cond, what):
        if not cond:
            raise AssertionError(f"hellocart: {what}")

    hub = FusionHub()
    backend = TpuGraphBackend(hub, device=None if device.type == "cuda" else device)
    expect(backend.graph.device == device, f"backend on {backend.graph.device}, not {device}")
    products = Products(hub)
    carts = Carts(hub, products)
    totals = Totals(hub, carts)

    def truth():
        p = products.price
        return 2 * p["apple"] + 2 * p["banana"] + p["cherry"]

    out = {"phase": "hellocart", "device": str(device)}
    expect(await totals.total() == truth(), "initial total")

    async def watch_total():
        c = await capture(lambda: totals.total())
        fired = []
        c.on_invalidated(lambda node: fired.append(node))
        return c, fired

    # host-led change through invalidating(): the host cascades, the device
    # mirror receives the marks at the next flush
    c_total, fired = await watch_total()
    c_apple = await capture(lambda: products.get("apple"))
    c_alice = await capture(lambda: carts.cart_total("alice"))
    products.price["apple"] = 3.0
    with invalidating():
        await products.get("apple")
    expect(fired == [c_total], "watched total fires on the host-led change")
    backend.flush()
    marked = backend.graph.invalid_mask()
    expect(all(marked[backend.id_for(c)] for c in (c_apple, c_alice, c_total)),
           "device mirror carries the host-led marks")
    expect(await totals.total() == truth(), "total after invalidating()")

    # device wave: one seed, compacted readback, two-tier apply
    c_total, fired = await watch_total()
    c_banana = await capture(lambda: products.get("banana"))
    c_alice = await capture(lambda: carts.cart_total("alice"))
    c_bob = await capture(lambda: carts.cart_total("bob"))
    products.price["banana"] = 1.5
    out["cascade_count"] = backend.invalidate_cascade(c_banana)
    expect(out["cascade_count"] == 4, f"cascade count {out['cascade_count']} != 4")
    expect(fired == [c_total] and c_total._state == 2, "watched total applied eagerly")
    pending = [c for c in (c_banana, c_alice, c_bob)
               if c._state == 1 and c.is_invalidated and backend._pending[backend.id_for(c)]]
    expect(len(pending) == 3, "unwatched nodes pending")
    expect(await totals.total() == truth(), "total after invalidate_cascade")

    # batch: two seeds, one union wave
    c_total, fired = await watch_total()
    c_apple = await capture(lambda: products.get("apple"))
    c_cherry = await capture(lambda: products.get("cherry"))
    c_alice = await capture(lambda: carts.cart_total("alice"))
    c_bob = await capture(lambda: carts.cart_total("bob"))
    products.price["apple"], products.price["cherry"] = 0.25, 7.0
    out["batch_count"] = backend.invalidate_cascade_batch([c_apple, c_cherry])
    expect(out["batch_count"] == 5, f"batch count {out['batch_count']} != 5")
    expect(fired == [c_total] and c_total._state == 2, "batch: watched total eager")
    expect(all(c.is_invalidated and c._state == 1 for c in (c_apple, c_cherry, c_alice, c_bob)),
           "batch: unwatched nodes pending")
    out["total"] = await totals.total()
    expect(out["total"] == truth(), "total after invalidate_cascade_batch")

    # mesh burst: one union wave on 8 logical shards of the card
    from stl_fusion_tpu_torch.parallel import graph_mesh

    mesh = graph_mesh(N_SHARDS, device=device)
    c_total, fired = await watch_total()
    c_cherry = await capture(lambda: products.get("cherry"))
    c_bob = await capture(lambda: carts.cart_total("bob"))
    products.price["cherry"] = 5.0
    out["sharded_count"] = backend.invalidate_cascade_batch_sharded([c_cherry], mesh)
    expect(out["sharded_count"] == 3, f"sharded count {out['sharded_count']} != 3")
    expect(fired == [c_total] and c_total._state == 2, "sharded: watched total eager")
    expect(all(c.is_invalidated for c in (c_cherry, c_bob)), "sharded: dependents invalid")
    sharded = backend.sharded_mirror(mesh)
    expect(sharded.mesh.size == N_SHARDS and sharded.g.invalid[0].device.type == device.type,
           "sharded mirror lives on the card mesh")
    out["total"] = await totals.total()
    expect(out["total"] == truth(), "total after invalidate_cascade_batch_sharded")

    # the topo and lat mirrors: one burst through the lat mirror, then the
    # same burst with the mirror built but the graph's mirror="off"
    graph, runs = backend.graph, {}
    for route in ("lat", "off"):
        backend.build_topo_mirror()
        c_total, fired = await watch_total()
        nodes = {"apple": await capture(lambda: products.get("apple")),
                 "alice": await capture(lambda: carts.cart_total("alice")),
                 "bob": await capture(lambda: carts.cart_total("bob")), "total": c_total}
        products.price["apple"] += 1.0
        before = (graph.mirror_bursts, graph.lat_waves)
        if route == "off":
            backend._wave_union = lambda seeds: graph.run_waves_union(seeds, mirror="off")
        try:
            count = backend.invalidate_cascade_batch([nodes["apple"]])
        finally:
            backend.__dict__.pop("_wave_union", None)
        runs[route] = {"count": count,
                       "invalidated": sorted(k for k, c in nodes.items() if c.is_invalidated),
                       "mirror_bursts": graph.mirror_bursts - before[0],
                       "lat_waves": graph.lat_waves - before[1]}
        expect(fired == [c_total], f"{route} burst: watched total eager")
        expect(await totals.total() == truth(), f"total after the {route} burst")
    expect(runs["lat"]["lat_waves"] == runs["lat"]["mirror_bursts"] == 1,
           f"the first burst rode the lat mirror: {runs['lat']}")
    expect(runs["off"]["mirror_bursts"] == 0, f"mirror='off' took the dense path: {runs['off']}")
    expect(runs["lat"]["count"] == runs["off"]["count"] == 3
           and runs["lat"]["invalidated"] == runs["off"]["invalidated"],
           f"the lat and dense bursts differ: {runs}")
    out["mirror_bursts"] = runs

    # a lane burst of 3 command groups, each in its own bit lane of one
    # mirror sweep: each group's count equals the union wave of that group
    # alone from the same state (the graph's run_waves_union, as
    # invalidate_cascade_batch runs it, with the state restored after each)
    c_total, fired = await watch_total()
    nodes = {name: await capture(fn) for name, fn in (
        ("apple", lambda: products.get("apple")), ("banana", lambda: products.get("banana")),
        ("cherry", lambda: products.get("cherry")),
        ("alice", lambda: carts.cart_total("alice")))}
    groups = [[nodes["apple"]], [nodes["banana"], nodes["cherry"]], [nodes["alice"]]]
    backend.flush()
    saved = (graph.device_arrays().invalid.clone(), graph._h_invalid.copy())
    alone = []
    for group in groups:
        alone.append(graph.run_waves_union([[backend.id_for(c) for c in group]], mirror="off")[0])
        graph.device_arrays().invalid.copy_(saved[0])
        graph._h_invalid = saved[1].copy()
    bursts0, rebuilds0 = graph.mirror_bursts, graph.mirror_rebuilds
    products.price["banana"] += 1.0
    lane_counts = backend.invalidate_cascade_batch_lanes(groups).tolist()
    out["lanes"] = {"counts": lane_counts, "alone": alone,
                    "mirror_bursts": graph.mirror_bursts - bursts0,
                    "mirror_patches": graph.mirror_patches,
                    "mirror_rebuilds": graph.mirror_rebuilds - rebuilds0}
    expect(lane_counts == alone == [3, 5, 2], f"lane burst counts {out['lanes']}")
    expect(graph.mirror_bursts == bursts0 + 1, f"the lane burst rode the mirror: {out['lanes']}")
    expect(fired == [c_total] and all(c.is_invalidated for c in nodes.values()),
           "lane burst: watched total eager, the groups' nodes invalid")
    expect(await totals.total() == truth(), "total after invalidate_cascade_batch_lanes")

    # the same 3 groups as a lane burst on the 8-shard mesh (the packed mesh
    # mirror, built here, its levels packed_pull launches): each group's
    # count equals the single-card lane burst's from the same state (the
    # graph's run_waves_lanes, with the state restored after it)
    c_total, fired = await watch_total()
    nodes = {name: await capture(fn) for name, fn in (
        ("apple", lambda: products.get("apple")), ("banana", lambda: products.get("banana")),
        ("cherry", lambda: products.get("cherry")),
        ("alice", lambda: carts.cart_total("alice")))}
    groups = [[nodes["apple"]], [nodes["banana"], nodes["cherry"]], [nodes["alice"]]]
    backend.flush()
    saved = (graph.device_arrays().invalid.clone(), graph._h_invalid.copy())
    single = graph.run_waves_lanes([[backend.id_for(c) for c in g] for g in groups])[0].tolist()
    graph.device_arrays().invalid.copy_(saved[0])
    graph._h_invalid = saved[1].copy()
    products.price["cherry"] += 1.0
    mesh_counts = backend.invalidate_cascade_batch_lanes_sharded(groups, mesh).tolist()
    pg = backend._packed_mirror["graph"]
    out["mesh_lanes"] = {"counts": mesh_counts, "single_card": single, "shards": pg.mesh.size,
                         "rows": pg.n_global, "k": pg.k, "levels": pg.last_stats.get("levels")}
    expect(mesh_counts == single == [3, 5, 2], f"mesh lane burst counts {out['mesh_lanes']}")
    expect(pg.mesh.size == N_SHARDS and pg.in_src.device.type == device.type,
           "the packed mesh mirror lives on the card mesh")
    expect(fired == [c_total] and all(c.is_invalidated for c in nodes.values()),
           "mesh lane burst: watched total eager, the groups' nodes invalid")
    expect(await totals.total() == truth(), "total after invalidate_cascade_batch_lanes_sharded")
    out["mirror_rebuilds"] = graph.mirror_rebuilds
    out.update(nodes=backend.node_count, edges=backend.edge_count, waves=backend.waves_run)
    return out


def phase_hellocart(device) -> dict:
    out = asyncio.run(_hellocart(device))
    emit(out)
    return out


def phase_power_law(device, card: str, n: int = N_NODES, n_seeds: int = N_UNION_SEEDS) -> dict:
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.graph import DeviceGraph
    from stl_fusion_tpu_torch.graph.synthetic import power_law_dag

    t0 = time.perf_counter()
    src, dst = power_law_dag(n, avg_degree=3, seed=GRAPH_SEED)
    rng = np.random.default_rng(GRAPH_SEED)
    g = DeviceGraph(node_capacity=n, edge_capacity=len(src), device=device)
    g.add_nodes(n)
    g.add_edges(src, dst)
    bumped = rng.choice(n, n // 100, replace=False)
    g.bump_epochs(bumped)
    node_epoch = np.zeros(n, np.int32)
    node_epoch[bumped] = 1
    oracle = LevelBfsOracle(src, dst, np.zeros(len(src), np.int32), node_epoch, n)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    g.device_arrays()
    sync(device)
    out = {"phase": "power_law_10m", "card": card, "nodes": n, "edges": int(len(src)),
           "stale_edges": int((~oracle.live).sum()), "n_cap": g.n_cap,
           "setup_s": time.perf_counter() - t0, "waves": {}}

    def check(name, got_count, got_ids, want, depth=None):
        want_ids, want_count, want_depth = want
        if got_count != want_count:
            raise AssertionError(f"{name}: count {got_count} != oracle {want_count}")
        if got_ids is not None and not np.array_equal(got_ids, want_ids):
            raise AssertionError(f"{name}: newly ids differ from the oracle")
        if depth is not None and depth != want_depth:
            raise AssertionError(f"{name}: depth {depth} != oracle {want_depth}")
        mask = g.invalid_mask()
        if not np.array_equal(np.nonzero(mask)[0], want_ids):
            raise AssertionError(f"{name}: device invalid mask differs from the oracle")

    def timed(fn):
        t = time.perf_counter()
        res = fn()
        sync(device)
        return res, (time.perf_counter() - t) * 1e3

    from stl_fusion_tpu_torch.ops import block_refresh as brf_mod
    from stl_fusion_tpu_torch.ops import or_popcount as opc_mod
    from stl_fusion_tpu_torch.ops import wave as wave_mod

    union_seeds = rng.choice(n, n_seeds, replace=False)
    def opc_launches():
        return (opc_mod.launches, *opc_mod.form_launches.values())

    opc0, merge0 = opc_launches(), wave_mod.form_launches["merge"]
    (count, ids), ms = timed(lambda: g.run_waves_union([union_seeds.tolist()]))
    union_levels = []
    want = want_union = oracle.wave(union_seeds, levels=union_levels)
    check("run_waves_union", count, ids, want)
    # one merged wave_expand per level (the last one lights nothing); the
    # only or_popcounts are the seed merge and the union finalize (delta)
    launched = (tuple(b - a for a, b in zip(opc0, opc_launches())),
                wave_mod.form_launches["merge"] - merge0)
    if launched != ((2, 1, 0, 1, 0), want[2] + 1):
        raise AssertionError(
            f"union wave launched (or_popcount (all, merge, gate, delta, shards), "
            f"wave_expand_merge) = {launched}, not ((2, 1, 0, 1, 0), {want[2] + 1})")
    # the same wave again from a cleared state: the first run pays one-time
    # lazy loading of the PyTorch kernels it touches
    g.clear_invalid()
    (count2, ids2), ms2 = timed(lambda: g.run_waves_union([union_seeds.tolist()]))
    check("run_waves_union (repeat)", count2, ids2, want)
    out["waves"]["union"] = {"seeds": n_seeds, "newly": count, "levels": want[2], "wave_ms": ms,
                             "invalidations_per_s": count / (ms / 1e3), "wave_ms_repeat": ms2,
                             "invalidations_per_s_repeat": count2 / (ms2 / 1e3)}

    g.clear_invalid()
    shallow = n - 1 - rng.choice(n // 100, 256, replace=False)
    opc0 = opc_launches()
    (count, ids), ms = timed(lambda: g.run_wave_collect(shallow.tolist()))
    want = want_shallow = oracle.wave(shallow)
    check("run_wave_collect", count, ids, want)
    # the seed gate is ONE launch (no elementwise gate before it)
    launched = tuple(b - a for a, b in zip(opc0, opc_launches()))
    if launched != (1, 0, 1, 0, 0):
        raise AssertionError(f"run_wave_collect launched or_popcount (all, merge, gate, delta, "
                             f"shards) = {launched}, not (1, 0, 1, 0, 0)")
    out["waves"]["collect"] = {"seeds": 256, "newly": count, "levels": want[2], "wave_ms": ms,
                               "invalidations_per_s": count / (ms / 1e3)}

    g.clear_invalid()
    hubs = rng.choice(max(n // 10_000, 4), 4, replace=False)
    (count, depth), ms = timed(lambda: g.run_wave(hubs.tolist(), with_stats=True))
    want = oracle.wave(hubs)
    check("run_wave_with_stats", count, None, want, depth=depth)
    out["waves"]["with_stats"] = {"seeds": 4, "newly": count, "levels": depth, "wave_ms": ms,
                                  "invalidations_per_s": count / (ms / 1e3)}
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["launches_so_far"] = {"or_popcount": opc_mod.launches,
                              **{f"or_popcount.{k}": v for k, v in opc_mod.form_launches.items()},
                              "wave_expand": wave_mod.launches,
                              **{f"wave_expand.{k}": v for k, v in wave_mod.form_launches.items()}}
    # the union wave's levels, for the kernel comparison: each level's
    # frontier, its edges (all out-edges of the frontier, stale included)
    # and their distinct dependents, and the invalid set at its start
    levels, before = [], np.zeros(0, np.int64)
    for k, frontier in enumerate(union_levels):
        e = oracle.out_edges(frontier)
        before = np.union1d(before, frontier)
        levels.append({"level": k, "frontier": frontier, "invalid": before,
                       "active_edges": int(e.size),
                       "active_dsts": int(np.unique(oracle.dst[e]).size)})
    widest = max(levels, key=lambda lv: lv["active_edges"])
    out["union_levels"] = [{"level": lv["level"], "frontier_nodes": int(lv["frontier"].size),
                            "active_edges": lv["active_edges"],
                            "active_dsts": lv["active_dsts"]} for lv in levels]
    emit(out)
    g.clear_invalid()
    out["level"] = {"graph": g, "ga": g.device_arrays(), "seeds": union_seeds,
                    "first": levels[0], "widest": widest,
                    # for the sharded phase: the same graph, epochs and seeds
                    "src": src, "dst": dst, "node_epoch": node_epoch, "n": n,
                    "shallow": shallow, "want_union": want_union, "want_shallow": want_shallow}
    return out


def phase_sharded(device, card: str, level: dict) -> dict:
    """The 10M graph and epochs of ``power_law_10m`` on a mesh of 8 logical
    shards on the card, one ``ShardedDeviceGraph`` per exchange."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import block_refresh as brf_mod
    from stl_fusion_tpu_torch.ops import or_popcount as opc_mod
    from stl_fusion_tpu_torch.ops import ring_all_gather as rag
    from stl_fusion_tpu_torch.ops import wave as wave_mod
    from stl_fusion_tpu_torch.parallel import ShardedDeviceGraph, graph_mesh

    def launch_counts():
        return {"wave_expand": wave_mod.launches,
                "wave_expand_shards": wave_mod.form_launches["shards"],
                "or_popcount": opc_mod.launches,
                "or_popcount.shards": opc_mod.form_launches["shards"],
                "ring_all_gather": rag.launches,
                "ring_cuda_launches": rag.cuda_launches}

    src, dst, n = level["src"], level["dst"], level["n"]
    mesh = graph_mesh(N_SHARDS, device=device)
    union_seeds, shallow = level["seeds"], level["shallow"]
    want_union, want_shallow = level["want_union"], level["want_shallow"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"phase": "sharded_10m", "card": card, "nodes": n, "shards": mesh.size,
           "waves": {}}

    def check(name, count, mask_ids, want, levels=None):
        want_ids, want_count, want_depth = want
        if count != want_count:
            raise AssertionError(f"{name}: count {count} != oracle {want_count}")
        if not np.array_equal(mask_ids, want_ids):
            raise AssertionError(f"{name}: newly set differs from the oracle")
        if levels is not None and levels != want_depth:
            raise AssertionError(f"{name}: levels {levels} != oracle {want_depth}")

    def timed(fn):
        t = time.perf_counter()
        res = fn()
        sync(device)
        return res, (time.perf_counter() - t) * 1e3

    graphs = {}
    for exchange in ("ring", "packed", "bool"):
        t0 = time.perf_counter()
        sg = ShardedDeviceGraph(src, dst, n, mesh=mesh, edge_dst_epoch=np.zeros(len(src), np.int32),
                                exchange=exchange, node_epoch=level["node_epoch"])
        sync(device)
        setup_s = time.perf_counter() - t0
        seeds = union_seeds.tolist()
        rec = {"setup_s": setup_s, "e_shard": sg.e_shard, "n_local": sg.n_local}
        for run in ("first", "repeat"):
            sg.clear_invalid()
            before = launch_counts()
            count, ms = timed(lambda: sg.run_wave(seeds))
            check(f"{exchange} run_wave ({run})", count,
                  np.nonzero(sg.invalid_mask())[0], want_union, sg.last_levels)
            rec[f"wave_ms_{run}"] = ms
            launched = {k: v - before[k] for k, v in launch_counts().items()}
            rec[f"launches_{run}"] = launched
            # per level ONE wave_expand launch for all shards (the last level
            # lights nothing); or_popcount only merges the seeds, ONE launch
            # for every shard
            calls = sg.last_levels + 1
            want_launched = {"wave_expand": calls, "wave_expand_shards": calls,
                             "or_popcount": 1, "or_popcount.shards": 1,
                             "ring_all_gather": calls if exchange == "ring" else 0,
                             "ring_cuda_launches": calls if exchange == "ring" else 0}
            if launched != want_launched:
                raise AssertionError(
                    f"{exchange} run_wave launched {launched}, not {want_launched}")
        # the part of a wave that is the 100,000 seed ids: list → array →
        # the bool frontier on the card
        _, rec["seed_frontier_ms"] = timed(lambda: sg.seeds_to_frontier(seeds))
        rec.update(newly=count, levels=sg.last_levels,
                   invalidations_per_s_repeat=count / (rec["wave_ms_repeat"] / 1e3))
        out["waves"][exchange] = rec
        graphs[exchange] = sg
    sg = graphs["ring"]
    sg.clear_invalid()
    (count, ids, overflow), ms = timed(lambda: sg.run_wave_collect(shallow.tolist()))
    if overflow:
        raise AssertionError("ring run_wave_collect overflowed its 65,536-id buffer")
    check("ring run_wave_collect", count, ids, want_shallow)
    check("ring run_wave_collect (mask)", count, np.nonzero(sg.invalid_mask())[0], want_shallow)
    out["waves"]["collect_ring"] = {"seeds": len(shallow), "newly": count, "wave_ms": ms,
                                    "levels": sg.last_levels}
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    out["ring_graph"] = sg
    return out


def _nonempty_levels(level_starts) -> int:
    return sum(b > a for a, b in zip(level_starts, level_starts[1:]))


def phase_mirror(device, card: str, level: dict) -> dict:
    """The topo and lat mirrors of ``power_law_10m``'s graph (1% of nodes
    epoch-bumped): ``build_topo_mirror`` (a disk-cache miss), then the same
    build again, loaded from the disk cache and equal to the built tables;
    then, on the loaded mirror, from a cleared state the
    100,000-seed union as one topo sweep and the 256 shallow seeds as one
    lat wave, each EXACTLY the dense wave's result (the same oracle). The
    sweep must make one ``topo_sweep`` launch per non-empty level per pass
    and no ``wave_expand`` launch."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import topo_wave as tpw
    from stl_fusion_tpu_torch.ops import wave as wave_mod

    g, n = level["graph"], level["n"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    g.clear_invalid()
    t0 = time.perf_counter()
    m = g.build_topo_mirror()
    sync(device)
    per_sweep = _nonempty_levels(m["level_starts"])
    cold_s = time.perf_counter() - t0
    cache = reload_mirror_from_cache(g, device, cold_s)
    m = g._topo_mirror  # every check below runs on the loaded mirror
    out = {"phase": "mirror_10m", "card": card, "nodes": n, "mirror_cache": cache,
           "build_topo_mirror_s": cold_s, "topo_rows": m["n_tot"] + 1,
           "topo_k": int(m["garrays"].in_src.shape[1]), "levels": m["levels"],
           "launches_per_sweep": per_sweep, "lat_rows": m["lat"]["n_tot"] + 1,
           "lat_k": m["lat"]["k"], "waves": {}}

    def burst(name, seeds, want, route):
        want_ids, want_count, _ = want
        rec = {"seeds": len(seeds), "route": route}
        for run in ("first", "repeat"):
            g.clear_invalid()
            before = (g.mirror_bursts, g.lat_waves, tpw.launches, wave_mod.launches)
            t = time.perf_counter()
            count, ids = g.run_waves_union([seeds.tolist()])
            sync(device)
            rec[f"wave_ms_{run}"] = (time.perf_counter() - t) * 1e3
            got = (g.mirror_bursts - before[0], g.lat_waves - before[1],
                   tpw.launches - before[2], wave_mod.launches - before[3])
            want_routes = (1, 1, 0, 0) if route == "lat" else (1, 0, per_sweep, 0)
            if got != want_routes:
                raise AssertionError(f"{name}: (mirror bursts, lat waves, topo_sweep launches, "
                                     f"wave_expand launches) = {got}, not {want_routes}")
            if count != want_count:
                raise AssertionError(f"{name}: count {count} != the dense wave's {want_count}")
            if not np.array_equal(np.sort(ids), want_ids):
                raise AssertionError(f"{name}: newly ids differ from the dense wave's")
            if not np.array_equal(np.nonzero(g.invalid_mask())[0], want_ids):
                raise AssertionError(f"{name}: device invalid mask differs from the dense wave's")
        rec.update(newly=count, invalidations_per_s_repeat=count / (rec["wave_ms_repeat"] / 1e3))
        return rec

    out["waves"]["union_topo"] = burst("mirror run_waves_union (100,000 seeds)", level["seeds"],
                                       level["want_union"], "topo")
    out["waves"]["union_lat"] = burst("mirror run_waves_union (256 shallow seeds)",
                                      level["shallow"], level["want_shallow"], "lat")
    # where each burst's time goes: torch.profiler from a cleared state
    for name, seeds in (("union_topo", level["seeds"]), ("union_lat", level["shallow"])):
        seed_list = [seeds.tolist()]
        g.clear_invalid()
        wall_ms, by_name, calls, seen = profile_checked(
            device, lambda: g.run_waves_union(seed_list),
            {"topo_sweep": per_sweep if name == "union_topo" else 0}, f"mirror {name}")
        sweep_ms = seen["topo_sweep"][0] * per_sweep if name == "union_topo" else 0.0
        dev_ms = sum(v["ms"] for v in by_name.values())
        out["waves"][name].update(
            profile_wall_ms=wall_ms, device_ms=dev_ms, idle_share=1 - dev_ms / wall_ms,
            device_calls=calls, topo_sweep_device_ms=sweep_ms,
            topo_sweep_profiled_launches=seen["topo_sweep"][1],
            top_kernels=dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:6]))
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    g.clear_invalid()
    emit(out)
    return out


def phase_topo_10m(device, card: str, n: int = N_NODES, n_seeds: int = N_UNION_SEEDS) -> dict:
    """The twin of ``bench.py``'s single-chip leg (``stl_fusion_tpu_torch/
    bench.py``, its defaults: 10M nodes, 512 packed waves of 100,000 seeds
    at W=16, the lat leg's 96 lone waves of 256 shallow seeds). Exactness:
    the per-word counts and bits equal the plain sweep's on the card, lanes
    0, 31, 32 and 511 equal the oracle, and three lat samples (counts; the
    last one's ids too) equal the oracle. Reports
    ``cascading_invalidations_per_sec``, the sweep's launches, device time
    and idle share (``torch.profiler``), its bound and peak memory."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch import bench
    from stl_fusion_tpu_torch.ops import topo_wave as tpw
    from stl_fusion_tpu_torch.ops.ell_wave import advance_epoch, invalid_mask

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    leg = bench.build_topo_leg(n, seeds_per_wave=n_seeds, device=device)
    setup_s = time.perf_counter() - t0
    graph, n = leg["graph"], leg["n_nodes"]
    per_sweep = _nonempty_levels(graph.level_starts)
    launches0 = tpw.launches
    sweep = bench.run_topo_leg(leg)
    runs = (1 + len(sweep["sweep_s"])) * leg["n_batches"]
    if tpw.launches - launches0 != runs * per_sweep:
        raise AssertionError(f"topo_10m: {tpw.launches - launches0} topo_sweep launches in "
                             f"{runs} sweeps, not {per_sweep} each")

    # the kernel's last sweep against the plain version on the same inputs
    state, ga, seeds = leg["state"], leg["wave32"].garrays, leg["seed_bits"][-1]
    plain = tpw.TopoState(state.node_epoch, torch.zeros_like(state.invalid_bits))
    _, plain_counts = tpw.topo_sweep_plain(graph.level_starts, ga, seeds, plain)
    if not (np.array_equal(plain_counts.cpu().numpy(), sweep["counts"][-1])
            and torch.equal(plain.invalid_bits, state.invalid_bits)):
        raise AssertionError("topo_10m: the sweep's counts or bits differ from the plain sweep's")
    del plain

    oracle = LevelBfsOracle(leg["src"], leg["dst"], np.zeros(len(leg["src"]), np.int32),
                            np.zeros(n, np.int32), n)
    lanes, lane_ids = {}, {}
    for lane in (0, 31, 32, 511):
        w, b = divmod(lane, 32)
        rows = torch.nonzero(((state.invalid_bits[:, w] >> b) & 1).bool() & ga.is_real)
        got = np.sort(graph.perm[rows.flatten().cpu().numpy()])
        want_ids, want_count, depth = oracle.wave(leg["seed_lists"][-1][lane])
        if not np.array_equal(got, want_ids):
            raise AssertionError(f"topo_10m: lane {lane} differs from the oracle")
        lanes[lane] = {"newly": want_count, "oracle_levels": depth}
        lane_ids[lane] = want_ids

    # where one run of the batches' time goes
    bench.run_batches(leg)
    wall_ms, by_name, calls, seen = profile_checked(
        device, lambda: bench.run_batches(leg), {"topo_sweep": per_sweep * leg["n_batches"]},
        "topo_10m")
    per_launch_ms, profiled = seen["topo_sweep"]
    dev_ms = per_launch_ms * per_sweep * leg["n_batches"]

    lat = bench.build_lat_leg(leg)
    lat_res = bench.run_lat_leg(lat)
    for i in (0, len(lat_res["counts"]) // 2, len(lat_res["counts"]) - 1):
        want_ids, want_count, _ = oracle.wave(lat["seeds"][i + 1])  # seeds[0]: the warm-up
        if lat_res["counts"][i] != want_count:
            raise AssertionError(f"topo_10m: lat sample {i} counts {lat_res['counts'][i]}, "
                                 f"the oracle {want_count}")
    if not np.array_equal(np.nonzero(invalid_mask(lat["state"])[:n])[0], want_ids):
        raise AssertionError("topo_10m: the last lat sample's ids differ from the oracle")
    # one more lone wave under torch.profiler: device time, calls, idle share
    lat_state = advance_epoch(lat["state"])
    lat_wall, lat_by, lat_calls = profile_device(
        device, lambda: lat["wave"](lat["seeds_dev"][1], lat_state))
    lat_dev = sum(v["ms"] for v in lat_by.values())
    lat_profile = {"wall_ms": lat_wall, "device_ms": lat_dev, "device_calls": lat_calls,
                   "idle_share": 1 - lat_dev / lat_wall,
                   "top_kernels": dict(sorted(lat_by.items(), key=lambda kv: -kv[1]["ms"])[:6])}

    rec = bench.record(leg, sweep, lat_res)
    n_bytes = sweep_bytes(graph, leg["words"], start_level=1, seeded=True)
    b_ms, b_by = bound_ms(n_bytes, 0)
    ms = np.asarray(lat_res["samples_ms"])
    out = {"phase": "topo_10m", "card": card, **rec, "setup_s": setup_s,
           "sweep_ms_median": sweep["elapsed_s"] / leg["n_batches"] * 1e3,
           "launches_per_sweep": per_sweep, "profile_wall_ms": wall_ms,
           "profiled_launches": profiled,
           "sweep_device_ms": dev_ms / leg["n_batches"], "device_ms": sum(
               v["ms"] for v in by_name.values()), "device_calls": calls,
           "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": n_bytes,
           "topo_rows": graph.n_tot + 1, "lanes": lanes,
           "lat_rows": lat["ell"].n_tot + 1, "wave_ms_min": float(ms.min()),
           "lat_profile": lat_profile}
    out["idle_share"] = 1 - out["device_ms"] / wall_ms
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    out["leg"] = leg
    out["lane_ids"] = lane_ids  # the oracle's ids of lanes 0, 31, 32, 511 (packed_10m)
    return out


def phase_packed_10m(device, card: str, topo: dict) -> dict:
    """The twin of ``bench.py::run_sharded`` (``stl_fusion_tpu_torch/bench.py``)
    on ``topo_10m``'s graph and its 512 seed lists of 100,000 seeds. Packed
    branch: ``PackedShardedGraph(words=16)`` on 8 logical shards, one batch
    of 512 waves through ``run_wave_batches`` (a warm-up and 5 timed runs);
    its per-lane counts equal the topo sweep's (both graphs all valid), lanes
    0, 31, 32 and 511 the oracle's ids; ``packed_pull`` launched once per
    level run plus the seed step (and the group's early exits), no
    ``topo_sweep`` and no ``wave_expand``; one batch under
    ``torch.profiler``. Then the ``packed=False`` branch on the first 20
    lists (each wave's count the topo lane's) and the pull leg
    (``kernel="pull"``, W = 1) on the first 32 (its count the cumulative
    real popcount, the sum of those lanes; lanes 0 and 31 the oracle's
    ids)."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch import bench
    from stl_fusion_tpu_torch.ops import packed_pull as ppp
    from stl_fusion_tpu_torch.ops import topo_wave as tpw
    from stl_fusion_tpu_torch.ops import wave as wave_mod
    from stl_fusion_tpu_torch.ops.topo_wave import _lane_counts_blocked

    def fail(what):
        raise AssertionError(f"packed_10m: {what}")

    def lane_ids(words, lane):
        w, b = divmod(lane, 32)
        return torch.nonzero(((words[:, w] >> b) & 1).bool()).flatten().cpu().numpy()

    tleg = topo["leg"]
    n, edges, lists = tleg["n_nodes"], (tleg["src"], tleg["dst"]), tleg["seed_lists"][-1]
    tga, tbits = tleg["wave32"].garrays, tleg["state"].invalid_bits  # the last batch's bits
    want_lanes = _lane_counts_blocked(torch.where(tga.is_real[:, None], tbits, 0),
                                      tleg["words"]).cpu().numpy().astype(np.int64)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"phase": "packed_10m", "card": card, "nodes": n}

    # the packed branch
    t0 = time.perf_counter()
    leg = bench.build_sharded_leg(n, seeds_per_wave=N_UNION_SEEDS, packed=True, words=16,
                                  device=device, edges=edges,
                                  seed_lists=[lists])
    setup_s = time.perf_counter() - t0
    pg = leg["graph"]
    before = (ppp.launches, ppp.early_exits, tpw.launches, wave_mod.launches)
    rec = bench.run_sharded_leg(leg)
    runs, st = 1 + len(rec["run_s"]), pg.last_stats
    made, skipped = ppp.launches - before[0], ppp.early_exits - before[1]
    if made != runs * (1 + st["syncs"] * ppp.GROUP) or made - skipped != runs * (1 + st["levels"]):
        fail(f"{made} packed_pull launches ({skipped} early exits) in {runs} runs of "
             f"{st['levels']} levels and {st['syncs']} syncs")
    if tpw.launches != before[2] or wave_mod.launches != before[3]:
        fail("topo_sweep or wave_expand was launched")
    got_lanes = _lane_counts_blocked(pg.invalid[:n], 16).cpu().numpy().astype(np.int64)
    if not np.array_equal(got_lanes, want_lanes):
        fail(f"per-lane counts differ from the topo sweep's in "
             f"{int((got_lanes != want_lanes).sum())} lanes")
    if rec["total_invalidated"] != int(want_lanes.sum()):
        fail(f"total {rec['total_invalidated']} != the topo sweep's {int(want_lanes.sum())}")
    for lane in (0, 31, 32, 511):
        if not np.array_equal(lane_ids(pg.invalid[:n], lane), topo["lane_ids"][lane]):
            fail(f"lane {lane} differs from the oracle")
    # where one batch's time goes
    wall_ms, by_name, calls, seen = profile_checked(
        device, lambda: pg.run_wave_batches(leg["seeds_dev"]),
        {"packed_pull": 1 + st["syncs"] * ppp.GROUP}, "packed_10m")
    dev_ms = sum(v["ms"] for v in by_name.values())
    counts = rec.pop("counts")
    out.update({k: v for k, v in rec.items()}, setup_s=setup_s,
               levels=st["levels"], syncs_per_batch=st["syncs"],
               host_syncs_per_wave=st["syncs"] / leg["waves_per_batch"],
               early_exits_per_batch=st["early_exits"], launches_per_batch=made // runs,
               batch_ms_median=rec["elapsed_s"] / leg["n_batches"] * 1e3,
               profile_wall_ms=wall_ms, device_ms=dev_ms, idle_share=1 - dev_ms / wall_ms,
               device_calls=calls, packed_pull_device_ms=seen["packed_pull"][0] * seen[
                   "packed_pull"][1], packed_pull_profiled_launches=seen["packed_pull"][1],
               top_kernels=dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:6]),
               rows=pg.n_global, k=pg.k, lanes_checked=[0, 31, 32, 511],
               batch_counts=counts.tolist())

    # the packed=False branch: one wave at a time, the first 20 lists
    sleg = bench.build_sharded_leg(n, seeds_per_wave=N_UNION_SEEDS, n_waves=20, packed=False,
                                   device=device, edges=edges,
                                   seed_lists=[lists[:20]])
    srec = bench.run_sharded_leg(sleg)
    if srec["counts"].tolist() != want_lanes[:20].tolist():
        fail("the packed=False waves' counts differ from the topo lanes'")
    srec.pop("counts")
    out["unpacked"] = srec
    del sleg

    # the pull leg: W = 1, the first 32 lists
    pleg = bench.build_pull_leg(n, seeds_per_wave=N_UNION_SEEDS, n_waves=32, device=device,
                                edges=edges, seed_lists=[lists[:32]])
    before = ppp.launches
    prec = bench.run_topo_leg(pleg)
    if prec["total"] != int(want_lanes[:32].sum()):
        fail(f"the pull leg's count {prec['total']} != the sum of lanes 0-31, "
             f"{int(want_lanes[:32].sum())}")
    bits = pleg["state"].invalid_bits[:n].view(-1, 1)
    for lane in (0, 31):
        if not np.array_equal(lane_ids(bits, lane), topo["lane_ids"][lane]):
            fail(f"the pull leg's lane {lane} differs from the oracle")
    pstats = {}
    pleg["state"].invalid_bits.zero_()
    pleg["wave32"](pleg["seed_bits"][0], pleg["state"], pstats)
    pruns = 2 + len(prec["sweep_s"])  # the warm-up, the timed runs, the run just above
    if ppp.launches - before != pruns * (1 + pstats["syncs"] * ppp.GROUP):
        fail("the pull leg's packed_pull launches are not one per level and seed step")
    prec_out = bench.record(pleg, prec, None)
    out["pull"] = {**prec_out, **pstats, "rows": pleg["graph"].n_tot + 1, "k": pleg["graph"].k}
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    return {"out": out, "leg": leg, "pull_leg": pleg}


#: perf/live_path.py's defaults (LIVE_ROUNDS, LIVE_EDGE_CHURN, LIVE_SCALAR_CHURN,
#: LIVE_LANE_GROUPS, LIVE_LANE_SEEDS), at bench.py's 10M nodes
CHURN_ROUNDS, EDGE_CHURN, SCALAR_CHURN, LANE_GROUPS, LANE_SEEDS = 6, 2000, 4, 512, 8
#: rounds before the background re-level starts, and its install deadline
REBUILD_AFTER_ROUND, REBUILD_CAP_S = 3, 180.0


def phase_churn(device, card: str, level: dict) -> dict:
    """The mirror serving a churning graph: ``power_law_10m``'s
    ``DeviceGraph`` with the mirror ``mirror_10m`` built, for
    ``CHURN_ROUNDS`` rounds of ``perf/live_path.py``'s shape. Each round:
    ``EDGE_CHURN`` random pairs oriented from the lower mirror level to the
    higher (``make_churn_edges``: same-level pairs dropped but ONE, the
    run's level-violating edge, oriented by id) and ``SCALAR_CHURN``
    recomputes (a bump, then the node's live in-edges re-added at the new
    epoch); then from a cleared state one ``run_waves_lanes`` burst of
    ``LANE_GROUPS`` groups of ``LANE_SEEDS`` distinct ids, which must ride the
    patched mirror (a patch, one mirror burst, no synchronous rebuild).
    Exactness: the union mask equals the dense union of all the burst's
    seeds, and lanes 0, 31, 32 and 511 each equal a dense wave of their group
    (``mirror="off"``, from a cleared state). In the violating edge's round
    the mirror sweeps 2 passes, and the burst under
    ``set_adaptive_passes(True)`` gives the same counts and mask. In round 2,
    ``run_waves_union_seq`` of 8 lone waves of 32 shallow seeds equals 8
    ``run_waves_union`` calls, and the 256 shallow seeds through the patched
    lat mirror equal the dense collect wave. After round
    ``REBUILD_AFTER_ROUND`` a background re-level starts; rounds go on, it is
    polled until it installs (at most ``REBUILD_CAP_S``), and then the
    mirror sweeps 1 pass and the next burst is exact."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    g, n = level["graph"], level["n"]
    m = g._topo_mirror
    if m is None or not g._mirror_valid():
        raise AssertionError("churn_10m: mirror_10m's mirror is not there to churn")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(GRAPH_SEED + 1)
    out = {"phase": "churn_10m", "card": card, "nodes": n, "rounds": [],
           "shape": {"rounds": CHURN_ROUNDS, "edge_churn": EDGE_CHURN,
                     "scalar_churn": SCALAR_CHURN, "lane_groups": LANE_GROUPS,
                     "lane_seeds": LANE_SEEDS}}
    viol = {"done": False, "round": None}

    def churn_edges():
        a = rng.integers(0, n, size=EDGE_CHURN)
        b = rng.integers(0, n, size=EDGE_CHURN)
        a, b = a[a != b], b[a != b]
        mm = g._topo_mirror
        ls, inv_perm = mm["level_starts_arr"], mm["inv_perm"]
        la = np.searchsorted(ls, inv_perm[a], side="right") - 1
        lb = np.searchsorted(ls, inv_perm[b], side="right") - 1
        swap = la > lb
        u, v = np.where(swap, b, a), np.where(swap, a, b)
        same = la == lb
        keep = ~same
        if not viol["done"]:
            tail = np.nonzero(same)[0][:1]
            keep[tail] = True
            if tail.size:
                viol["done"] = True
        flip = same[keep] & (u[keep] > v[keep])
        u, v = u[keep].copy(), v[keep].copy()
        u[flip], v[flip] = v[flip], u[flip]
        return u.astype(np.int32), v.astype(np.int32), int(same[keep].sum())

    def pick_recomputes():
        """SCALAR_CHURN random nodes that have live in-edges, with their
        live in-edges' sources (every node of this graph has 1-3)."""
        cand = rng.integers(1, n, size=4 * SCALAR_CHURN)
        e = g.n_edges
        dst_all = g._h_edge_dst[:e]
        sel = np.nonzero(np.isin(dst_all, cand))[0]
        sel = sel[g._h_node_epoch[dst_all[sel]] == g._h_edge_dst_epoch[:e][sel]]
        picked = np.unique(dst_all[sel])[:SCALAR_CHURN]
        return {int(v): g._h_edge_src[:e][sel][dst_all[sel] == v].copy() for v in picked}

    def recompute(srcs):
        """The scalar recompute: bump, then re-add the live in-edges at the
        new epoch."""
        g.bump_epochs(np.asarray(list(srcs), np.int32))
        for v, s in srcs.items():
            g.add_edges(s, np.full(len(s), v, np.int32))
        return len(srcs), sum(len(s) for s in srcs.values())

    def dense_check(what, counts, mask, groups):
        flat = np.concatenate([np.asarray(x) for x in groups])
        g.clear_invalid()
        c, ids = g.run_waves_union([flat.tolist()], mirror="off")
        if c != int(mask.sum()) or not np.array_equal(np.nonzero(mask)[0], ids):
            raise AssertionError(f"churn_10m {what}: the union mask differs from the dense "
                                 f"union of its {len(flat)} seeds ({int(mask.sum())} vs {c})")
        res = {"union_newly": int(c), "lanes": {}}
        for lane in (0, 31, 32, 511):
            g.clear_invalid()
            c, _ = g.run_waves_union([groups[lane].tolist()], mirror="off")
            if c != counts[lane]:
                raise AssertionError(f"churn_10m {what}: lane {lane} counts {counts[lane]}, "
                                     f"its dense wave {c}")
            res["lanes"][lane] = int(c)
        return res

    def burst(r, what):
        grng = np.random.default_rng(7 + r)
        groups = []
        while len(groups) < LANE_GROUPS:
            ids = np.unique(grng.integers(0, n, size=LANE_SEEDS))
            if ids.size == LANE_SEEDS:
                groups.append(ids)
        g.clear_invalid()
        before = (g.mirror_patches, g.mirror_bursts, g.mirror_rebuilds, g.mirror_patch_s,
                  tpw.launches, tpw.lane_finish_launches)
        sync(device)
        t = time.perf_counter()
        counts, mask = g.run_waves_lanes([x.tolist() for x in groups])
        sync(device)
        ms = (time.perf_counter() - t) * 1e3
        rec = {"burst_ms": ms, "patched": g.mirror_patches - before[0],
               "patch_ms": (g.mirror_patch_s - before[3]) * 1e3,
               "passes": g._topo_mirror["passes"], "n_viol": g._topo_mirror.get("n_viol", 0),
               "topo_sweep_launches": tpw.launches - before[4],
               "lane_finish_launches": tpw.lane_finish_launches - before[5],
               "newly": int(counts.sum()), "union_newly": int(mask[:n].sum())}
        if g.mirror_bursts != before[1] + 1 or g.mirror_rebuilds != before[2]:
            raise AssertionError(f"churn_10m {what}: the burst did not ride the mirror "
                                 f"(bursts +{g.mirror_bursts - before[1]}, synchronous "
                                 f"rebuilds +{g.mirror_rebuilds - before[2]})")
        return groups, counts, mask[:n], rec

    shallow = level["shallow"]
    rebuild = None
    for r in range(CHURN_ROUNDS):
        rec = {"round": r}
        if rebuild is not None and rebuild.get("installed_s") is None:
            t = time.perf_counter()
            if g.poll_topo_mirror_rebuild():
                rebuild["installed_s"] = time.perf_counter() - rebuild["t0"]
                rebuild["install_ms"] = (time.perf_counter() - t) * 1e3
                rebuild["installed_before_round"] = r
        srcs = pick_recomputes()
        t = time.perf_counter()
        u, v, n_same = churn_edges()
        g.add_edges(u, v)
        rec["recomputed"], rec["recaptured_edges"] = recompute(srcs)
        rec["churn_ms"] = (time.perf_counter() - t) * 1e3
        rec["edges_added"] = int(len(u))
        groups, counts, mask, brec = burst(r, f"round {r}")
        rec.update(brec)
        if not brec["patched"]:
            raise AssertionError(f"churn_10m round {r}: the churn was not patched in")
        if n_same:
            viol["round"] = r
            if brec["passes"] != 2:
                raise AssertionError(f"churn_10m round {r}: the violating edge left "
                                     f"{brec['passes']} passes, not 2")
            g.set_adaptive_passes(True)
            _, counts_ad, mask_ad, arec = burst(r, f"round {r} (adaptive)")
            g.set_adaptive_passes(False)
            if not (np.array_equal(counts_ad, counts) and np.array_equal(mask_ad, mask)):
                raise AssertionError(f"churn_10m round {r}: adaptive passes differ from 2 passes")
            rec["adaptive"] = {"burst_ms": arec["burst_ms"],
                               "topo_sweep_launches": arec["topo_sweep_launches"],
                               "stages": g.adaptive_stages}
        rec["exact"] = dense_check(f"round {r}", counts, mask, groups)
        if r == 1:
            waves = shallow.reshape(8, 32)
            g.clear_invalid()
            lat0 = g.lat_waves
            seq_counts, seq_ids = g.run_waves_union_seq([w.tolist() for w in waves])
            seq_mask = g.invalid_mask()
            if g.lat_waves != lat0 + 8:
                raise AssertionError("churn_10m: run_waves_union_seq did not ride the lat mirror")
            g.clear_invalid()
            one = [g.run_waves_union([w.tolist()])[0] for w in waves]
            if seq_counts.tolist() != one or not np.array_equal(g.invalid_mask(), seq_mask):
                raise AssertionError(f"churn_10m: run_waves_union_seq {seq_counts.tolist()} "
                                     f"differs from 8 run_waves_union calls {one}")
            g.clear_invalid()
            lat0 = g.lat_waves
            c_lat, ids_lat = g.run_waves_union([shallow.tolist()])
            g.clear_invalid()
            c_dense, ids_dense = g.run_wave_collect(shallow.tolist())
            if g.lat_waves != lat0 + 1 or c_lat != c_dense or not np.array_equal(
                    np.sort(ids_lat), ids_dense):
                raise AssertionError(f"churn_10m: the patched lat mirror's wave ({c_lat}) "
                                     f"differs from the dense collect wave ({c_dense})")
            rec["lone_waves"] = {"seq_counts": seq_counts.tolist(), "lat_newly": int(c_lat)}
        if r + 1 == REBUILD_AFTER_ROUND:
            if not g.start_topo_mirror_rebuild():
                raise AssertionError("churn_10m: a background re-level was already in flight")
            rebuild = {"t0": time.perf_counter(), "started_after_round": r, "installed_s": None}
        out["rounds"].append(rec)
        emit({"phase": "churn_10m_round", **rec})
    if viol["round"] is None:
        raise AssertionError("churn_10m: no same-level pair drawn for the violating edge")
    if rebuild is None:
        raise AssertionError("churn_10m: the background re-level never started")
    if rebuild["installed_s"] is None:
        thread = g._async_rebuild["thread"]
        thread.join(max(REBUILD_CAP_S - (time.perf_counter() - rebuild["t0"]), 0.0))
        t = time.perf_counter()
        if not g.poll_topo_mirror_rebuild():
            raise AssertionError(f"churn_10m: the re-level did not install within "
                                 f"{REBUILD_CAP_S} s")
        rebuild["installed_s"] = time.perf_counter() - rebuild["t0"]
        rebuild["install_ms"] = (time.perf_counter() - t) * 1e3
        rebuild["installed_before_round"] = CHURN_ROUNDS
    rebuild.pop("t0")
    groups, counts, mask, brec = burst(CHURN_ROUNDS, "after the re-level")
    if brec["passes"] != 1:
        raise AssertionError(f"churn_10m: {brec['passes']} passes after the re-level, not 1")
    brec["exact"] = dense_check("after the re-level", counts, mask, groups)
    rebuild["next_burst"] = brec
    rebuild["mirror_rebuilds"] = g.mirror_rebuilds

    # three bursts profiled (the last groups, each from a cleared state: the
    # trace may drop a record, and a burst has one lane_finish launch)
    per_sweep = _nonempty_levels(g._topo_mirror["level_starts"])
    group_lists = [x.tolist() for x in groups]

    def bursts():
        for _ in range(3):
            g.clear_invalid()
            g.run_waves_lanes(group_lists)
    wall_ms, by_name, calls, seen = profile_checked(
        device, bursts, {"topo_sweep": 3 * per_sweep * brec["passes"], "lane_finish": 3},
        "churn_10m burst")
    wall_ms, calls = wall_ms / 3, calls / 3
    dev_ms = sum(v["ms"] for v in by_name.values()) / 3
    ms = [r["burst_ms"] for r in out["rounds"]]
    out.update(
        violating_round=viol["round"], rebuild=rebuild,
        patch_ms=[r["patch_ms"] for r in out["rounds"]], burst_ms=ms,
        burst_ms_median=float(np.median(ms)),
        mirror_patches=g.mirror_patches, mirror_bursts=g.mirror_bursts,
        profile={"wall_ms": wall_ms, "device_ms": dev_ms, "device_calls": calls,
                 "idle_share": 1 - dev_ms / wall_ms,
                 "topo_sweep_device_ms": seen["topo_sweep"][0] * per_sweep * brec["passes"],
                 "lane_finish_device_ms": seen["lane_finish"][0],
                 "profiled_launches": {f: n for f, (_, n) in seen.items()},
                 "top_kernels_3_bursts": dict(
                     sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:8])})
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    g.clear_invalid()
    emit(out)
    out["groups"] = groups
    return out


LIVE_LOOPS = (("blocking", 6), ("superround", 6), ("chain", 3), ("mesh", 3))


def _live_state(backend, table) -> dict:
    """What a live round reads and writes, copied: the graph's device words
    and host mirror, the table's values, device validity (the tensor too)
    and staleness, and the backend's pending mask."""
    dg = backend.graph
    return {"words": dg.device_arrays().invalid.clone(), "values": table._values.clone(),
            "valid_t": table._valid_dev, "valid": table._valid_dev.clone(),
            "dirty": table._valid_dev_dirty, "vpending": list(table._valid_pending),
            "vpending_n": table._valid_pending_n, "h_invalid": dg._h_invalid.copy(),
            "stale": table._stale_host.copy(), "stale_count": table._stale_count,
            "pending": backend._pending.copy()}


def _restore_live_state(backend, table, st: dict) -> None:
    """Put a :func:`_live_state` copy back, into the same tensors (a captured
    program's addresses stay valid)."""
    dg = backend.graph
    dg.device_arrays().invalid.copy_(st["words"])
    table._values.copy_(st["values"])
    st["valid_t"].copy_(st["valid"])
    table._valid_dev, table._valid_dev_dirty = st["valid_t"], st["dirty"]
    table._valid_pending, table._valid_pending_n = list(st["vpending"]), st["vpending_n"]
    dg._h_invalid[:] = st["h_invalid"]
    table._stale_host[:] = st["stale"]
    table._stale_count = st["stale_count"]
    backend._pending[:] = st["pending"]


def phase_live(device, card: str, level: dict, paths: dict, reset_counts, read_counts,
               snapshot_path: str) -> dict:
    """The twin of ``perf/live_path.py``'s blocking loop
    (``stl_fusion_tpu_torch/live_path.py``) at 10M rows, on
    ``power_law_10m``'s edge arrays, through the public API: a table-backed
    service bound as one row block, its edges declared in bulk, warmed on
    the card, the topo mirror built, then the lone waves, a sequenced batch
    and ``LIVE_ROUNDS`` rounds of churn, ``refresh_block_on_device`` and a
    512-group ``cascade_rows_lanes`` burst. An observer holds every step
    exactly: after the warm the values equal ``base`` and nothing is stale;
    each refresh returns the block's host-invalid count before it, leaves
    the values equal to ``base``, the block's invalid words (read back) zero
    and the device validity equal to the host's; each burst rides the
    patched mirror (no synchronous rebuild), its union equals the dense
    union of all its seeds, lanes 0, 31, 32 and 511 their dense waves, and
    the table's stale set is the stale set before it plus the union; each
    recomputed scalar row kept its declared in-edges (a wave seeded at one
    of its sources reaches it, on the lat mirror and on the dense path);
    ``cascade_rows_batch_seq`` equals the same batches one call at a time;
    ``read_batch`` of 1M random ids given as a CUDA tensor equals
    ``base[ids]``. One ``live_10m_round`` line a round: refresh ms on the
    host clock, on the device (CUDA events around the call) and the
    ``block_refresh`` kernel's part of it, and burst ms. The mirror is
    built (a disk-cache miss) and then loaded from the disk cache, and the
    loops run on the loaded one.

    Then ``live_sr_10m`` on the same stack: ``perf/live_path.py``'s
    super-round loop (6 rounds at depth 3 after an untimed warm super-round,
    each super-round ONE replay of a captured CUDA graph running
    ``topo_sweep``, ``lane_finish`` and ``block_refresh``), then its chain
    loop (3 rounds). The first timed super-round is held, outside the
    timings, against 3 sequential ``cascade_rows_lanes`` +
    ``refresh_block_on_device`` pairs run from a copy of its inputs: lane
    counts, per-round masks, invalid words, values and validity identical.
    No round may take the eager path; every captured graph's launches per
    replay must be the expected ones (per round ``passes`` x non-empty
    levels ``topo_sweep``, one ``lane_finish``, one ``block_refresh``).
    ``paths`` receives the launch counts of the blocking loop (``live``,
    read just before the super-round loop starts) and of the two
    nonblocking loops (``live_sr``, counted from 0 at the super-round
    loop's start and read at the chain loop's end). The twin's restore leg
    leaves its snapshot of the graph at ``snapshot_path`` for
    :func:`phase_write`."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.diagnostics.metrics import global_metrics
    from stl_fusion_tpu_torch.live_path import run_live
    from stl_fusion_tpu_torch.ops import block_refresh as brf
    from stl_fusion_tpu_torch.ops import packed_pull as ppp
    from stl_fusion_tpu_torch.ops import topo_wave as tpw
    from stl_fusion_tpu_torch.ops.bitops import unpack_words_host
    from stl_fusion_tpu_torch.parallel import graph_mesh

    n, src, dst = level["n"], level["src"], level["dst"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = {"phase": "live_10m", "card": card}
    rounds = []

    def fail(what):
        raise AssertionError(f"live_10m: {what}")

    class Checks:
        def after_warm(self, ctx):
            table = ctx["table"]
            self.base = torch.from_numpy(ctx["svc"].base).to(device)
            if not torch.equal(table.values, self.base) or table.stale_count() != 0:
                fail("after the warm the values differ from base or rows are stale")
            self.t_mirror = time.perf_counter()  # the mirror build starts now

        def after_seq(self, ctx, batches, counts):
            backend, block = ctx["backend"], ctx["block"]
            dg = backend.graph
            seq_mask = dg._h_invalid[:n].copy()
            backend.refresh_block_on_device(block)
            if dg._h_invalid[:n].any():
                fail("a refresh left invalid rows behind")
            one = [backend.cascade_rows_batch(block, b) for b in batches]
            if one != [int(c) for c in counts] or not np.array_equal(dg._h_invalid[:n], seq_mask):
                fail(f"cascade_rows_batch_seq {list(counts)} differs from one call at a time {one}")
            out["seq"] = {"counts": one}

        def before_refresh(self, ctx, rnd):
            brf.timing = []
            self.launches = brf.launches
            self.t = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
            if cuda:
                self.t[0].record()

        def after_refresh(self, ctx, rnd, refreshed, invalid_before):
            table, block, dg = ctx["table"], ctx["block"], ctx["backend"].graph
            dev_ms = None
            if cuda:
                self.t[1].record()
                self.t[1].synchronize()
                dev_ms = self.t[0].elapsed_time(self.t[1])
            kernel_ms = sum(a.elapsed_time(b) for a, b in brf.timing)
            brf.timing = None
            if refreshed != invalid_before:
                fail(f"round {rnd}: the refresh returned {refreshed}, {invalid_before} invalid")
            if cuda and brf.launches != self.launches + 1:
                fail(f"round {rnd}: the refresh made {brf.launches - self.launches} "
                     f"block_refresh launches")
            if not torch.equal(table.values, self.base):
                fail(f"round {rnd}: values differ from base after the refresh")
            words = dg.device_arrays().invalid.cpu().numpy()
            if unpack_words_host(words, block.end())[block.base:].any():
                fail(f"round {rnd}: the block's invalid words are not zero after the refresh")
            if not np.array_equal(table.valid_mask.cpu().numpy(), ~table._stale_host):
                fail(f"round {rnd}: the device validity differs from the host's")
            self.stale_pre = table._stale_host.copy()
            self.rec = {"refresh_device_ms": dev_ms, "block_refresh_ms": kernel_ms,
                        "stale_left": int(table.stale_count())}
            if self.mode == "mesh":
                self.mesh_before_burst(ctx, rnd)

        def after_burst(self, ctx, rnd, group_ids, counts, stats):
            if self.mode == "mesh":
                return self.mesh_after_burst(ctx, rnd, group_ids, counts)
            backend, block, table = ctx["backend"], ctx["block"], ctx["table"]
            dg = backend.graph
            if stats["rebuilds"] or stats["mirror_bursts"] != 1 or not stats["patched"]:
                fail(f"round {rnd}: the burst did not ride the patched mirror ({stats})")
            union = dg._h_invalid[:n].copy()
            if not np.array_equal(table._stale_host, self.stale_pre | union[block.base:]):
                fail(f"round {rnd}: the table's stale set is not the stale set before plus "
                     f"the union")
            groups = [block.base + np.asarray(g_, np.int64) for g_ in group_ids]
            dg.clear_invalid()
            c, ids = dg.run_waves_union([np.concatenate(groups).tolist()], mirror="off")
            if c != int(union.sum()) or not np.array_equal(ids, np.nonzero(union)[0]):
                fail(f"round {rnd}: the union ({int(union.sum())}) differs from the dense "
                     f"union ({c})")
            for lane in (0, 31, 32, 511):
                dg.clear_invalid()
                c, _ = dg.run_waves_union([groups[lane].tolist()], mirror="off")
                if c != int(counts[lane]):
                    fail(f"round {rnd}: lane {lane} counts {int(counts[lane])}, dense {c}")
            reached = 0
            for row in ctx["scalar_rows"]:
                nid = block.base + row
                ins = block.declared_in_srcs(nid)
                if not len(ins):
                    continue
                for mirror in ("auto", "off"):
                    dg.clear_invalid()
                    _, ids = dg.run_waves_union([[int(ins[0])]], mirror=mirror)
                    if nid not in set(ids.tolist()):
                        fail(f"round {rnd}: recomputed row {row} lost its declared in-edge "
                             f"({mirror})")
                reached += 1
            dg.clear_invalid()
            dg.mark_invalid(np.nonzero(union)[0].astype(np.int32))
            self.last_union = union
            self.rec.update(union=int(union.sum()), scalar_rows_reached=reached)
            rounds.append(self.rec)

        def mesh_before_burst(self, ctx, rnd):
            """The mesh loop, just before its burst: the packed mirror built at
            round 0 and patched in place after (the same entry, ``patches``
            rising, the patch batch counter up by one), timed here so the
            burst's time is its own; the state saved for the single-card
            check; the last round's burst profiled."""
            backend, table = ctx["backend"], ctx["table"]
            batches = global_metrics().counter("fusion_mirror_patch_batches_total")
            b0, existed = batches.value, backend._packed_mirror is not None
            t = time.perf_counter()
            entry = backend.packed_mirror(mesh)
            sync(device)
            dt = time.perf_counter() - t
            pg = entry["graph"]
            rec = {"round": rnd, "patches": pg.patches}
            if rnd == 0:
                if existed or pg.patches:
                    fail("mesh round 0 did not build a fresh packed mirror")
                self.mesh_entry = entry
                rec.update(mirror="build", mirror_build_s=dt, rows=pg.n_global, k=pg.k,
                           shards=pg.mesh.size)
            else:
                if (entry is not self.mesh_entry or pg.patches <= self.mesh_rounds[-1]["patches"]
                        or batches.value != b0 + 1):
                    fail(f"mesh round {rnd}: the packed mirror was not patched in place "
                         f"(same entry {entry is self.mesh_entry}, patches {pg.patches}, "
                         f"patch batches +{batches.value - b0})")
                rec.update(mirror="patch", patch_ms=dt * 1e3)
            self.mesh_rounds.append(rec)
            self.s0 = _live_state(backend, table)
            self.l0 = (ppp.launches, ppp.early_exits, tpw.lane_finish_launches)
            self.prof = None
            if rnd == self.mesh_n - 1:  # the last burst, under torch.profiler
                from torch.profiler import ProfilerActivity, profile

                sync(device)
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t_prof = time.perf_counter()

        def mesh_after_burst(self, ctx, rnd, group_ids, counts):
            """The mesh burst against ``cascade_rows_lanes`` run from the same
            state (restored from the copy taken before it): per-group
            counts, the dense words, the host invalid mirror (the union) and
            the table's stale rows; then the mesh burst's state put back."""
            backend, block, table = ctx["backend"], ctx["block"], ctx["table"]
            rec = self.mesh_rounds[-1]
            pg = backend._packed_mirror["graph"]
            if self.prof is not None:
                sync(device)
                wall = (time.perf_counter() - self.t_prof) * 1e3
                self.prof.__exit__(None, None, None)
                by_name, calls = device_times(self.prof)
                dev = sum(v["ms"] for v in by_name.values())
                rec["profile"] = {
                    "wall_ms": wall, "device_ms": dev, "idle_share": 1 - dev / wall,
                    "device_calls": calls,
                    "packed_pull": kernel_calls(by_name, SYMBOLS["packed_pull"]),
                    "lane_finish": kernel_calls(by_name, SYMBOLS["lane_finish"]),
                    "top_kernels": dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:6])}
            rec.update(launches={"packed_pull": ppp.launches - self.l0[0],
                                 "early_exits": ppp.early_exits - self.l0[1],
                                 "lane_finish": tpw.lane_finish_launches - self.l0[2]},
                       levels=pg.last_stats.get("levels"), syncs=pg.last_stats.get("syncs"),
                       newly=int(counts.sum()), groups=len(group_ids))
            # the backend's wave record: the gated lanes (the device wave,
            # lane_finish, the counts read back), then the union's apply
            wave = backend.profiler.recent(1)[-1]
            if wave["kind"] != "sharded_lanes":
                fail(f"mesh round {rnd}: the last wave record is {wave['kind']!r}")
            rec.update(gated_lanes_ms=wave["device_ms"], apply_ms=wave["apply_ms"])
            s1 = _live_state(backend, table)
            saved = (tpw.launches, tpw.lane_finish_launches, brf.launches, ppp.launches,
                     ppp.early_exits)
            journal, backend._journal = backend._journal, []
            _restore_live_state(backend, table, self.s0)
            want = backend.cascade_rows_lanes(block, group_ids)
            s2 = _live_state(backend, table)
            (tpw.launches, tpw.lane_finish_launches, brf.launches, ppp.launches,
             ppp.early_exits) = saved
            _restore_live_state(backend, table, s1)
            backend._journal = journal + backend._journal
            diffs = [name for name, same in (
                ("counts", np.array_equal(counts, want)),
                ("invalid words", torch.equal(s1["words"], s2["words"])),
                ("union", np.array_equal(s1["h_invalid"], s2["h_invalid"])),
                ("stale rows", np.array_equal(s1["stale"], s2["stale"])),
            ) if not same]
            if diffs or int(counts.sum()) == 0:
                fail(f"mesh round {rnd}: the mesh burst differs from cascade_rows_lanes in "
                     f"{diffs} (newly {int(counts.sum())}, single card {int(want.sum())})")
            rec["union"] = int(s1["h_invalid"][:n].sum())
            if rnd == self.mesh_n - 1:  # the last burst's inputs, for phase_kernels
                blocked = pg.put_blocked(unpack_words_host(self.s0["words"].cpu().numpy(), n))
                self.mesh_last = {"pg": pg, "groups": group_ids, "blocked_pre": blocked}

        def after_loop(self, ctx):
            self.ctx = ctx  # the live stack, for write_10m
            table = ctx["table"]
            out["n_cap"] = ctx["backend"].graph.n_cap
            gen = torch.Generator(device=device).manual_seed(GRAPH_SEED)
            ids = torch.randint(0, n, (1_000_000,), device=device, generator=gen)
            t = time.perf_counter()
            first = table.read_batch(ids)  # refreshes every stale row first
            sync(device)
            first_ms = (time.perf_counter() - t) * 1e3
            ms = time_ms(lambda: table.read_batch(ids), device)
            if not (torch.equal(first, self.base[ids]) and torch.equal(table.read_batch(ids),
                                                                       self.base[ids])):
                fail("read_batch of device ids differs from base[ids]")
            out["read_batch"] = {"ids": 1_000_000, "first_ms": first_ms, "ms": ms,
                                 "rows_per_s": 1e6 / (ms / 1e3)}

        def after_mirror(self, ctx):
            g = ctx["backend"].graph
            cold_s = time.perf_counter() - self.t_mirror
            out["mirror_cache"] = reload_mirror_from_cache(g, device, cold_s)

        def begin_loop(self, ctx, mode, n_rounds):
            self.mode = mode = LIVE_LOOPS[self.loop_i][0]  # "mesh" runs as "blocking"
            self.loop_i += 1
            if mode == "mesh":
                reset_counts()  # the mesh lanes path, read just after its loop
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                self.mesh_rounds, self.mesh_entry, self.mesh_last = [], None, None
                self.mesh_n = n_rounds
            if mode == "superround":
                paths["live"] = read_counts()  # the blocking path, read just after it
                out["max_memory_allocated"] = torch.cuda.max_memory_allocated() if cuda else None
                reset_counts()
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                self.first_sr = True
                self.masks = None
                ctx["backend"].newly_hooks.append(self.record_mask)

        def record_mask(self, newly):
            if self.masks is not None:
                self.masks.append(np.asarray(newly).copy())

        def before_dispatch(self, ctx, mode, k, group_ids):
            if mode == "superround" and self.first_sr:
                self.group_ids = group_ids
                self.s0, self.masks = _live_state(ctx["backend"], ctx["table"]), []

        def after_harvest(self, ctx, mode, per_burst):
            if mode != "superround" or not self.first_sr:
                return
            self.first_sr = False
            backend, table, block = ctx["backend"], ctx["table"], ctx["block"]
            got_masks, self.masks = self.masks, []
            s1 = _live_state(backend, table)
            saved = (tpw.launches, tpw.lane_finish_launches, brf.launches)
            journal, backend._journal = backend._journal, []  # the next round's churn waits
            _restore_live_state(backend, table, self.s0)
            want = []
            for _ in range(len(per_burst)):
                want.append(backend.cascade_rows_lanes(block, self.group_ids))
                backend.refresh_block_on_device(block)
            s2 = _live_state(backend, table)
            tpw.launches, tpw.lane_finish_launches, brf.launches = saved
            diffs = [name for name, same in (
                ("lane counts", [c.tolist() for c in per_burst] == [c.tolist() for c in want]),
                ("masks", len(got_masks) == len(self.masks) and all(
                    np.array_equal(a, b) for a, b in zip(got_masks, self.masks))),
                ("invalid words", torch.equal(s1["words"], s2["words"])),
                ("host invalid", np.array_equal(s1["h_invalid"], s2["h_invalid"])),
                ("values", torch.equal(s1["values"], s2["values"])),
                ("validity", torch.equal(s1["valid"], s2["valid"]) and s1["dirty"] == s2["dirty"]
                 and np.array_equal(s1["stale"], s2["stale"])),
            ) if not same]
            _restore_live_state(backend, table, s1)
            backend._journal = journal + backend._journal
            self.masks = None
            if diffs:
                fail(f"the first super-round differs from 3 sequential burst+refresh pairs in "
                     f"{diffs}")
            out["sr_exact"] = {"rounds": len(per_burst), "lanes": int(len(per_burst[0])),
                               "newly": [int(c.sum()) for c in per_burst],
                               "masks": len(got_masks)}

        def end_loop(self, ctx, mode, rec):
            mode = self.mode
            if mode == "superround" and cuda:
                out["sr_max_memory_allocated"] = torch.cuda.max_memory_allocated()
            if mode == "mesh":
                paths["mesh_lanes"] = read_counts()
                out["mesh_max_memory_allocated"] = torch.cuda.max_memory_allocated() if cuda \
                    else None
            if mode == "chain":
                paths["live_sr"] = read_counts()
                self.programs = [p for p in ctx["block"]._dev_refresh.values()]
                self.mirror = ctx["backend"].graph._topo_mirror

    mesh = graph_mesh(N_SHARDS, device=device)

    def mesh_burst(backend, block, group_ids):
        return backend.cascade_rows_lanes_sharded(block, group_ids, mesh)

    checks = Checks()
    checks.loop_i = 0
    rec = run_live(n_nodes=n, edges=(src, dst), device=device, observer=checks,
                   loops=[("blocking", r, mesh_burst) if name == "mesh" else (name, r)
                          for name, r in LIVE_LOOPS], snapshot_path=snapshot_path)
    blocking, sr, chain, mesh_loop = rec["loops"]
    for r, extra in zip(blocking["rounds"], rounds):
        r.update(extra)
        emit({"phase": "live_10m_round", **r})
    out.update({k: v for k, v in rec.items() if k not in ("rounds", "loops")})
    out["rounds"] = blocking["rounds"]
    emit({k: v for k, v in out.items()
          if k not in ("rounds", "sr_exact", "sr_max_memory_allocated")})
    out["last_union"] = checks.last_union
    out["live_sr"] = phase_live_sr(card, rec, sr, chain, blocking, checks, out)
    out["mesh_lanes"] = phase_mesh_lanes(card, mesh_loop, checks, out)
    out["mesh_last"] = checks.mesh_last
    out["ctx"], out["mesh"] = checks.ctx, mesh
    out["snapshot"] = {"path": snapshot_path, "save_s": rec["snapshot_save_s"],
                       "load_s": rec["restore_s"], "bytes": rec["snapshot_bytes"]}
    return out


def phase_mesh_lanes(card: str, mesh_loop: dict, checks, live_out: dict) -> dict:
    """``mesh_lanes_10m``'s lines, from the mesh loop :func:`phase_live`
    ran on the live stack: one ``mesh_lanes_10m_round`` line a round (the
    packed mirror's build seconds or patch ms, the burst's host ms, its
    launches, levels and host syncs, the union), then the summary with the
    last burst's profile. Every burst was held against ``cascade_rows_lanes``
    in the loop's observer."""
    rounds = checks.mesh_rounds
    if len(rounds) != len(mesh_loop["rounds"]) or not rounds:
        raise AssertionError("mesh_lanes_10m: the observer missed mesh rounds")
    for rec, loop_rec in zip(rounds, mesh_loop["rounds"]):
        rec.update(burst_ms=loop_rec["burst_ms"], refresh_ms=loop_rec["refresh_ms"],
                   refreshed=loop_rec["refreshed"])
        emit({"phase": "mesh_lanes_10m_round", "card": card,
              **{k: v for k, v in rec.items() if k != "profile"}})
    out = {"phase": "mesh_lanes_10m", "card": card, "rounds": len(rounds),
           "shards": rounds[0]["shards"], "rows": rounds[0]["rows"], "k": rounds[0]["k"],
           "mirror_build_s": rounds[0]["mirror_build_s"],
           "patch_ms": [r["patch_ms"] for r in rounds[1:]],
           "burst_ms": [r["burst_ms"] for r in rounds],
           "gated_lanes_ms": [r["gated_lanes_ms"] for r in rounds],
           "apply_ms": [r["apply_ms"] for r in rounds], "newly": [r["newly"] for r in rounds],
           "launches": [r["launches"] for r in rounds], "levels": [r["levels"] for r in rounds],
           "syncs": [r["syncs"] for r in rounds], "exact_vs_cascade_rows_lanes": True,
           "live_inv_per_s": mesh_loop["live_inv_per_s"], "profiled_burst": rounds[-1]["profile"],
           "max_memory_allocated": live_out.get("mesh_max_memory_allocated")}
    emit(out)
    return out


def phase_live_sr(card: str, rec: dict, sr: dict, chain: dict, blocking: dict, checks,
                  live_out: dict) -> dict:
    """``live_sr_10m``'s lines, from the loops :func:`phase_live` ran: one
    ``live_sr_10m_superround`` line per timed super-round (host ms and its
    split: seed staging, dispatch, the blocking read, the mask unpack, the
    two-tier apply; device ms between CUDA events around the replay; the
    program's route), then the summary. Fails if any round was eager, if no
    super-round replayed a resident graph, if the first super-round was not
    held exact, or if a captured graph's launches per replay are not the
    expected ones."""

    def fail(what):
        raise AssertionError(f"live_sr_10m: {what}")

    history = sr.get("superrounds", [])
    for i, h in enumerate(history):
        host_ms = h["stage_ms"] + h["dispatch_ms"] + h["stall_ms"] + h["unpack_ms"] + h["apply_ms"]
        emit({"phase": "live_sr_10m_superround", "card": card, "index": i, "host_ms": host_ms,
              **h})
    if sr["live_superround_eager_rounds"] or sr["live_superround_faults"]:
        fail(f"{sr['live_superround_eager_rounds']} eager rounds, "
             f"{sr['live_superround_faults']} faults in the super-round loop")
    if chain["live_eager_fallback_rounds"]:
        fail(f"{chain['live_eager_fallback_rounds']} eager rounds in the chain loop")
    routes = [h["route"] for h in history]
    if not routes or any(r not in ("capture", "recapture", "replay") for r in routes):
        fail(f"super-round routes {routes}: each must be one CUDA graph replay")
    if "replay" not in routes:
        fail("no super-round replayed a resident graph")
    if "sr_exact" not in live_out:
        fail("the first super-round was not held against the sequential pairs")
    names = ("topo_sweep", "lane_finish", "block_refresh")  # program_cache._launch_counters
    programs, replay_launches = [], dict.fromkeys(names, 0)
    for prog in checks.programs:
        if prog.graph is None:
            continue
        _kind, words, passes, update_valid, _n_tot, ls, _base, _rows, shape = prog.key
        levels = sum(1 for a, b in zip(ls, ls[1:]) if a < b) or 1
        want = {"topo_sweep": shape[0] * passes * levels, "lane_finish": shape[0],
                "block_refresh": shape[0]}
        got = {name: d for name, (_mod, _attr, d) in zip(names, prog.launch_deltas)}
        if got != want:
            fail(f"a captured graph launches {got} per replay, expected {want}")
        for name in names:
            replay_launches[name] += got[name] * prog.replays
        programs.append({"depth": shape[0], "lanes": shape[1], "width": shape[2],
                         "words": words, "passes": passes, "update_valid": update_valid,
                         "levels": levels, "launches_per_replay": got,
                         "replays": prog.replays, "captures": prog.captures,
                         "cold_ms": prog.cold_ms})
        prog.release()  # the graph's memory pool goes with the live stack
    out = {
        "phase": "live_sr_10m", "card": card, "rounds": sr["live_rounds"],
        "depth": sr["live_superround_depth"], "chain_rounds": chain["live_rounds"],
        "live_inv_per_s": {"superround": sr["live_inv_per_s"], "chain": chain["live_inv_per_s"],
                           "blocking": blocking["live_inv_per_s"]},
        "live_sustained_inv_per_s": {"superround": sr["live_sustained_inv_per_s"],
                                     "chain": chain["live_sustained_inv_per_s"],
                                     "blocking": blocking["live_sustained_inv_per_s"]},
        "live_total_inv": {"superround": sr["live_total_inv"], "chain": chain["live_total_inv"]},
        "superround_dispatches": sr["live_superround_dispatches"],
        "chain_dispatches": chain["live_fused_chain_dispatches"],
        "occupancy": sr["live_superround_occupancy"],
        "host_stall_ms": sr["live_superround_host_stall_ms"],
        "eager_rounds": sr["live_superround_eager_rounds"],
        "chain_eager_rounds": chain["live_eager_fallback_rounds"],
        "restages": sr["live_superround_restages"],
        "forced_harvests": sr["live_superround_forced_harvests"],
        "programs_in_loop": sr.get("superround_programs"), "routes": routes,
        "captured_graphs": programs, "replay_launches": replay_launches,
        "exact_first_superround": live_out["sr_exact"],
        "max_memory_allocated": live_out.get("sr_max_memory_allocated"),
        "warm_s": {"superround": sr["live_warm_s"], "chain": chain["live_warm_s"]},
        "cold_start_programs": rec["cold_start"]["programs"],
        "mirror_cache": live_out.get("mirror_cache"),
        "loop_phases": {"superround": sr["loop_phases"], "chain": chain["loop_phases"]},
    }
    emit(out)
    return out


WRITE_SEED = 11
WRITE_GROUPS = 512  # the live twin's lane shape: 512 groups of 8 seed rows
WRITE_SEEDS = 8
WRITE_RESUME_OPS = 64


def _launch_state() -> tuple:
    """Every launch counter the main path's kernels keep, to roll a check's
    launches back with :func:`_restore_launches`."""
    from stl_fusion_tpu_torch.ops import block_refresh as brf
    from stl_fusion_tpu_torch.ops import or_popcount as opc
    from stl_fusion_tpu_torch.ops import packed_pull as ppp
    from stl_fusion_tpu_torch.ops import routed_wave as rlw
    from stl_fusion_tpu_torch.ops import topo_wave as tpw
    from stl_fusion_tpu_torch.ops import wave as wave_mod

    return (tpw.launches, tpw.lane_finish_launches, brf.launches, ppp.launches,
            ppp.early_exits, wave_mod.launches, dict(wave_mod.form_launches), opc.launches,
            dict(opc.form_launches), rlw.launches, dict(rlw.form_launches))


def _restore_launches(saved: tuple) -> None:
    from stl_fusion_tpu_torch.ops import block_refresh as brf
    from stl_fusion_tpu_torch.ops import or_popcount as opc
    from stl_fusion_tpu_torch.ops import packed_pull as ppp
    from stl_fusion_tpu_torch.ops import routed_wave as rlw
    from stl_fusion_tpu_torch.ops import topo_wave as tpw
    from stl_fusion_tpu_torch.ops import wave as wave_mod

    (tpw.launches, tpw.lane_finish_launches, brf.launches, ppp.launches, ppp.early_exits,
     wave_mod.launches, wave_forms, opc.launches, opc_forms, rlw.launches, rlw_forms) = saved
    wave_mod.form_launches.update(wave_forms)
    opc.form_launches.update(opc_forms)
    rlw.form_launches.update(rlw_forms)


def phase_write(device, card: str, live: dict, level: dict) -> dict:
    """``write_10m``: the write path on the live stack :func:`phase_live`
    built (the 10M-row ``DagTable`` block, its topo mirror and packed mesh
    mirror), through the entry points a user calls. Two hosts share one
    ``SqliteOperationLog`` in a temporary directory: host B is the live
    stack's hub and backend, host A a second ``FusionHub`` in this process
    with no graph backend. Both register one command service whose
    ``RowsSet(rows, value)`` handler writes ``base[rows] = value`` into the
    store both hosts' tables load from (the host array and its device
    copy) and, in invalidating mode, reads ``dag.node(r)`` for each row.

    1. ``load_graph`` on the card of the snapshot the live twin's restore
       leg saved with ``save_graph`` (the graph as the loops left it; the
       10M graph is saved once a run): equal counts and host arrays (the
       invalid set included), and ``power_law_10m``'s 100,000-seed union
       wave on the restored graph, cleared, equal to the same wave on the
       original, cleared (not empty).
    2. Host B reads the 4,096 seed rows of 512 groups of 8 (drawn as the
       live twin draws its lane groups) by scalar reads, so each is a live
       node; host A commits 512 ``RowsSet`` operations through its
       commander, each journaled by the log's persist listener; host B's
       ``read_new()`` replays the 512 as ONE ``invalidate_cascade_batch_lanes``
       burst of 512 lanes (``topo_sweep`` and ``lane_finish``, no
       ``wave_expand``), held exactly against ``cascade_rows_lanes`` on the
       same row groups from the same state (lane counts, dense words,
       union, stale rows); every written row then reads back its last
       value by scalar read and by ``read_batch`` of CUDA ids.
    3. A second reader on host B with ``mesh=`` the 8-shard mesh replays the
       next 512 operations as ONE ``invalidate_cascade_batch_lanes_sharded``
       burst (``packed_pull`` and ``lane_finish``, no ``topo_sweep``), each
       lane's count equal to the single-card burst of the same groups from
       the same state (that burst profiled: its device ms and idle share).
       The mesh burst's host ms is split: the flush, the packed mirror's
       check or patch, the blocked mask's re-sync, the gated wave and the
       union's apply (the backend's wave record).
    4. Two local ``hub_b.commander.call``s cascade host-led on the card (the
       rows' table invalidation expands at the next flush): one of the step-2
       group whose closure is nearest 10^4 rows, one of 8 rows drawn as the
       lane groups are (a closure of most of the graph). Each newly invalid
       set equals the dense wave's from the same rows and is larger than the
       rows written; host B reads each write back at once, and host A's
       reader sees the two as external operations.
    5. ``HubCheckpoint`` of host B (its live scalar nodes and the 10M-row
       memo table) restored into a fresh hub with no graph backend (its
       table on the card): its reader starts at the snapshot's position,
       host A commits 64 more operations, exactly their rows go stale
       there, and every other row reads warm with no load call. Then host
       B's own reader replays the 64 and reads their rows back, so the
       live stack leaves the phase current with the store.

    The reference bursts and the original graph's wave are checks: their
    launches are rolled back. One ``write_10m_*`` line a step and a
    summary, each with the card's name and power limit."""
    return asyncio.run(_write_10m(device, card, live, level))


async def _write_10m(device, card: str, live: dict, level: dict) -> dict:
    import contextlib
    import dataclasses

    import numpy as np
    import torch

    from stl_fusion_tpu_torch import core
    from stl_fusion_tpu_torch.checkpoint import HubCheckpoint, load_graph
    from stl_fusion_tpu_torch.oplog import (
        OperationLogReader,
        SqliteOperationLog,
        attach_operation_log,
    )
    from stl_fusion_tpu_torch.utils.serialization import wire_type

    ctx, mesh = live["ctx"], live["mesh"]
    backend, block, table, svc_b = ctx["backend"], ctx["block"], ctx["table"], ctx["svc"]
    hub_b, dg, n = backend.hub, backend.graph, ctx["n"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(WRITE_SEED)
    out = {"phase": "write_10m", "card": card, "groups": WRITE_GROUPS, "seeds": WRITE_SEEDS}

    def fail(what):
        raise AssertionError(f"write_10m: {what}")

    @contextlib.contextmanager
    def timed(split, key, obj, name):
        """Adds the ms of each call of ``obj.name`` to ``split[key]``, the
        card synced before and after it (``obj`` None times nothing)."""
        if obj is None:
            yield
            return
        fn, own = getattr(obj, name), name in vars(obj)

        def run(*args, **kwargs):
            sync(device)
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync(device)
                split[key] = split.get(key, 0.0) + (time.perf_counter() - t) * 1e3

        setattr(obj, name, run)
        try:
            yield
        finally:
            if own:
                setattr(obj, name, fn)
            else:
                delattr(obj, name)

    def last_wave(kind):
        """The backend's newest wave record of ``kind``: the device wave's
        ms (``device_ms``: the gated lanes, their counts read back) and the
        union's apply to the hub and tables (``apply_ms``)."""
        return [w for w in backend.profiler.recent() if w["kind"] == kind][-1]

    def burst_split(b, wave):
        """A mesh burst's host ms by part; ``other`` is the rest (the seed
        lists' lookups, the wave's bookkeeping)."""
        sp = b["split"]
        parts = {"flush": sp.get("flush", 0.0),
                 "mirror_check_or_patch": sp.get("mirror", 0.0) - sp.get("flush", 0.0),
                 "blocked_resync": sp.get("resync", 0.0),
                 "gated_wave": wave["device_ms"], "apply": wave["apply_ms"]}
        parts["other"] = b["s"] * 1e3 - sum(parts.values())
        return parts

    @wire_type("RowsSet")
    @dataclasses.dataclass(frozen=True)
    class RowsSet:
        rows: tuple
        value: float

    base = svc_b.base  # the shared store: the host array and its device copy
    base_dev = svc_b.load_dev_args()[0]

    class RowsService:
        """The command service; its handler is registered for ``RowsSet``
        explicitly (this module's annotations are strings)."""

        def __init__(self, dag):
            self.dag = dag

        async def rows_set(self, command):
            if core.is_invalidating():
                for r in command.rows:
                    await self.dag.node(int(r))
                return
            rows = np.asarray(command.rows, np.int64)
            base[rows] = command.value
            base_dev[torch.from_numpy(rows).to(base_dev.device)] = command.value

    dag_type = type(svc_b)
    loads = {"rows": 0}  # rows the second hosts' tables load on the host

    def host():
        hub = core.FusionHub()
        dag = dag_type(hub)
        dag.base, dag._base_dev = base, base_dev
        load = dag.load

        def counted(ids):
            loads["rows"] += len(ids)
            return load(ids)

        dag.load = counted
        hub.add_service(dag, "dag")
        cmd = hub.add_service(RowsService(dag))
        hub.commander.add_handler(cmd.rows_set, command_type=RowsSet)
        return hub, dag

    cmd_b = hub_b.add_service(RowsService(svc_b))
    hub_b.commander.add_handler(cmd_b.rows_set, command_type=RowsSet)
    hub_a, _ = host()
    tmp = tempfile.mkdtemp(prefix="fusion-write-")
    log = SqliteOperationLog(os.path.join(tmp, "ops.sqlite"))
    want_value = {}
    bursts = []
    orig_lanes = backend.invalidate_cascade_batch_lanes
    orig_sharded = backend.invalidate_cascade_batch_lanes_sharded

    def lanes(groups):
        t = time.perf_counter()
        counts = orig_lanes(groups)
        bursts.append({"kind": "lanes", "groups": groups, "counts": counts,
                       "s": time.perf_counter() - t})
        return counts

    def sharded(groups, mesh=None):
        """The mesh burst, its parts timed with the card synced around each:
        the flush and the packed mirror's check or patch (``packed_mirror``),
        the blocked mask's re-sync from the dense state."""
        split = {}
        entry = backend._packed_mirror
        sync(device)
        t = time.perf_counter()
        with timed(split, "mirror", backend, "packed_mirror"), \
                timed(split, "flush", backend, "flush"), \
                timed(split, "resync", dg, "invalid_mask"), \
                timed(split, "resync", entry["graph"] if entry else None, "put_blocked"):
            counts = orig_sharded(groups, mesh=mesh)
        bursts.append({"kind": "sharded", "groups": groups, "counts": counts,
                       "s": time.perf_counter() - t, "split": split})
        return counts

    backend.invalidate_cascade_batch_lanes = lanes
    backend.invalidate_cascade_batch_lanes_sharded = sharded
    try:
        reader_a = attach_operation_log(hub_a.commander, log, start_reader=False)
        reader_b = attach_operation_log(hub_b.commander, log, start_reader=False)

        def draw(k):
            return [rng.choice(n // 10, size=WRITE_SEEDS, replace=False) for _ in range(k)]

        def settle():
            """Every row valid and every invalid bit clear: the block's
            refresh takes the rows whose bit is set; a scalar read clears its
            row's bit without refreshing the row, and a recompute that
            displaces a node a wave left pending invalidates its row (which
            cascades at the flush), so ``read_batch`` takes what is left."""
            for _ in range(3):
                backend.flush()
                backend.refresh_block_on_device(block)
                backend.flush()
                stale = np.nonzero(table._stale_host)[0]
                if stale.size:
                    table.read_batch(stale)
                    backend.flush()
                if not table.stale_count() and not dg._h_invalid[:n].any():
                    return
            fail(f"{table.stale_count()} rows stale and {int(dg._h_invalid[:n].sum())} "
                 f"invalid after settling")

        async def read_rows(groups):
            """Host B's scalar reads of the groups' rows, then :func:`settle`.
            Returns the nodes: the registry holds them weakly, and each must
            stay live for its replay."""
            nodes = [await core.capture(lambda: svc_b.node(r))
                     for r in np.unique(np.concatenate(groups)).tolist()]
            settle()
            return nodes

        async def commit(groups, first_value):
            ms = []
            for i, rows in enumerate(groups):
                value = float(first_value + i)
                t = time.perf_counter()
                await hub_a.commander.call(RowsSet(tuple(int(r) for r in rows), value))
                ms.append((time.perf_counter() - t) * 1e3)
                want_value.update(dict.fromkeys(rows.tolist(), value))
            return ms

        async def read_back(rows, hub_svc, where):
            rows = np.unique(np.asarray(rows, np.int64))
            want = np.asarray([want_value[r] for r in rows.tolist()], np.float32)
            scalar = np.asarray([await hub_svc.node(r) for r in rows.tolist()], np.float32)
            t = core.memo_table_of(hub_svc.node)
            batch = t.read_batch(torch.from_numpy(rows).to(device)).cpu().numpy()
            if not (np.array_equal(scalar, want) and np.array_equal(batch, want)):
                fail(f"{where}: a written row does not read back its value")
            return int(rows.size)

        def check_against(s1, s2, want_counts, got_counts, what):
            """The checked step's state ``s1`` and counts against the
            reference's ``s2`` and counts, run from the same state."""
            diffs = [name for name, same in (
                ("counts", np.array_equal(got_counts, want_counts)),
                ("invalid words", torch.equal(s1["words"], s2["words"])),
                ("union", np.array_equal(s1["h_invalid"], s2["h_invalid"])),
                ("stale rows", np.array_equal(s1["stale"], s2["stale"])),
            ) if not same]
            if diffs or int(np.sum(got_counts)) == 0:
                fail(f"{what} differs in {diffs} (newly {int(np.sum(got_counts))}, "
                     f"reference {int(np.sum(want_counts))})")

        def in_reference(s0, run):
            """``run()`` from the state ``s0``, its launches rolled back,
            then the state after the checked step put back."""
            s1 = _live_state(backend, table)
            saved = _launch_state()
            journal, backend._journal = backend._journal, []
            _restore_live_state(backend, table, s0)
            res = run()
            check = _live_state(backend, table)
            _restore_launches(saved)
            _restore_live_state(backend, table, s1)
            backend._journal = journal + backend._journal
            return s1, check, res

        # ---- 1. the durable restart of the graph: the live twin's restore
        # leg saved the 10M graph as the loops left it, and nothing has
        # changed it since; that snapshot loads on the card and holds the
        # same arrays (the invalid set too) and, both cleared, the same
        # union wave as the live graph
        snapshot = live["snapshot"]
        t = time.perf_counter()
        g2 = load_graph(snapshot["path"], device=device)
        load_s = time.perf_counter() - t
        m = dg.n_edges
        if (g2.n_nodes, g2.n_edges) != (dg.n_nodes, m) or not all(
                np.array_equal(getattr(g2, a)[:k], getattr(dg, a)[:k]) for a, k in (
                    ("_h_edge_src", m), ("_h_edge_dst", m), ("_h_edge_dst_epoch", m),
                    ("_h_node_epoch", n), ("_h_invalid", n))):
            fail("the restored graph's counts or host arrays differ from the original's")
        seeds = (block.base + level["seeds"]).astype(np.int64).tolist()
        s0 = _live_state(backend, table)

        def cleared_union():
            dg.clear_invalid()
            return dg.run_waves_union([seeds], mirror="off")

        _, _, want_wave = in_reference(s0, cleared_union)
        g2.clear_invalid()
        t = time.perf_counter()
        got_wave = g2.run_waves_union([seeds], mirror="off")
        sync(device)
        wave_ms = (time.perf_counter() - t) * 1e3
        if not want_wave[0] or got_wave[0] != want_wave[0] or not np.array_equal(
                got_wave[1], want_wave[1]):
            fail(f"the restored graph's union wave ({got_wave[0]}) differs from the "
                 f"original's ({want_wave[0]})")
        del g2
        graph_bytes = os.path.getsize(snapshot["path"])
        os.remove(snapshot["path"])

        # ---- 2. the batch replay: one lane burst of 512
        groups1 = draw(WRITE_GROUPS)
        live_nodes = await read_rows(groups1)
        commit_ms = await commit(groups1, 1_000_000)
        if log.last_index() != WRITE_GROUPS:
            fail(f"the log holds {log.last_index()} records after {WRITE_GROUPS} commits")
        s0 = _live_state(backend, table)
        c0 = _launch_state()
        sync(device)
        t = time.perf_counter()
        handled = await reader_b.read_new()
        sync(device)
        read_ms = (time.perf_counter() - t) * 1e3
        c1 = _launch_state()
        launches = {"topo_sweep": c1[0] - c0[0], "lane_finish": c1[1] - c0[1],
                    "wave_expand": c1[5] - c0[5], "packed_pull": c1[3] - c0[3]}
        if handled != WRITE_GROUPS or [b["kind"] for b in bursts] != ["lanes"]:
            fail(f"read_new handled {handled} in bursts {[b['kind'] for b in bursts]}")
        burst = bursts[0]
        wave1 = last_wave("lanes")
        if [len(g) for g in burst["groups"]] != [WRITE_SEEDS] * WRITE_GROUPS:
            fail(f"the replay collected groups of {sorted(set(len(g) for g in burst['groups']))} nodes, not one group of 8 live nodes an operation")
        if cuda and (launches["topo_sweep"] <= 0 or launches["lane_finish"] <= 0
                     or launches["wave_expand"] or launches["packed_pull"]):
            fail(f"the batch burst launched {launches}")
        s1, s2, want = in_reference(
            s0, lambda: backend.cascade_rows_lanes(block, [g.tolist() for g in groups1]))
        check_against(s1, s2, want, burst["counts"], "the batch replay")
        union1 = int(s1["h_invalid"][:n].sum())
        readback = await read_back(np.concatenate(groups1), svc_b, "batch replay")
        batch = {"phase": "write_10m_batch", "card": card, "operations": handled,
                 "read_new_ms": read_ms, "burst_ms": burst["s"] * 1e3,
                 "replay_ms": read_ms - burst["s"] * 1e3,
                 "burst_split_ms": {"wave": wave1["device_ms"], "apply": wave1["apply_ms"]},
                 "launches": launches,
                 "newly": int(burst["counts"].sum()), "union": union1,
                 "lane_counts_min_max": [int(burst["counts"].min()), int(burst["counts"].max())],
                 "exact_vs_cascade_rows_lanes": True, "rows_read_back": readback}
        emit(batch)
        commit1 = {"phase": "write_10m_commit", "card": card, "commands": len(commit_ms),
                   "p50_ms": float(np.percentile(commit_ms, 50)),
                   "p99_ms": float(np.percentile(commit_ms, 99)),
                   "mean_ms": float(np.mean(commit_ms))}
        emit(commit1)

        # ---- 3. the mesh reader: one sharded lane burst of the next 512
        groups2 = draw(WRITE_GROUPS)
        live_nodes = await read_rows(groups2)
        await commit(groups2, 2_000_000)
        mesh_reader = OperationLogReader(log, hub_b.commander.operations,
                                         start_position=reader_b.watermark, mesh=mesh)
        s0 = _live_state(backend, table)
        entry0 = backend._packed_mirror
        patches0 = entry0["graph"].patches
        c0 = _launch_state()
        sync(device)
        t = time.perf_counter()
        handled = await mesh_reader.read_new()
        sync(device)
        mesh_ms = (time.perf_counter() - t) * 1e3
        c1 = _launch_state()
        wave2 = last_wave("sharded_lanes")
        entry1 = backend._packed_mirror
        mirror_kind = ("build" if entry1 is not entry0 else
                       "patch" if entry1["graph"].patches > patches0 else "as built")
        mlaunches = {"packed_pull": c1[3] - c0[3], "lane_finish": c1[1] - c0[1],
                     "topo_sweep": c1[0] - c0[0], "wave_expand": c1[5] - c0[5]}
        if handled != WRITE_GROUPS or [b["kind"] for b in bursts] != ["lanes", "sharded"]:
            fail(f"the mesh reader handled {handled} in bursts {[b['kind'] for b in bursts]}")
        mburst = bursts[1]
        if cuda and (mlaunches["packed_pull"] <= 0 or mlaunches["lane_finish"] <= 0
                     or mlaunches["topo_sweep"] or mlaunches["wave_expand"]):
            fail(f"the mesh burst launched {mlaunches}")

        prof = {}

        def single_card():
            if not cuda:
                return orig_lanes(mburst["groups"])
            wall, by_name, calls = profile_device(device, lambda: prof.update(
                counts=orig_lanes(mburst["groups"])))
            dev_ms = sum(v["ms"] for v in by_name.values())
            prof.update(wall_ms=wall, device_ms=dev_ms, idle_share=1 - dev_ms / wall,
                        device_calls=calls,
                        topo_sweep=kernel_calls(by_name, SYMBOLS["topo_sweep"]),
                        lane_finish=kernel_calls(by_name, SYMBOLS["lane_finish"]))
            return prof["counts"]

        s1, s2, want = in_reference(s0, single_card)
        check_against(s1, s2, want, mburst["counts"], "the mesh reader's burst")
        prof.pop("counts", None)
        readback2 = await read_back(np.concatenate(groups2), svc_b, "mesh replay")
        n_bursts = len(bursts)
        if await reader_b.read_new() != WRITE_GROUPS or len(bursts) != n_bursts:
            fail("the first reader replayed operations the mesh reader had applied")
        meshrec = {"phase": "write_10m_mesh", "card": card, "operations": handled,
                   "read_new_ms": mesh_ms, "burst_ms": mburst["s"] * 1e3,
                   "replay_ms": mesh_ms - mburst["s"] * 1e3,
                   "burst_split_ms": burst_split(mburst, wave2),
                   "packed_mirror": mirror_kind, "launches": mlaunches,
                   "newly": int(mburst["counts"].sum()), "shards": N_SHARDS,
                   "exact_vs_single_card": True, "rows_read_back": readback2,
                   "single_card_burst_profile": prof}
        emit(meshrec)

        # ---- 4. local writes: host-led cascades on the card, each from a
        # settled state, the newly invalid set equal to the dense wave's.
        # "mid": the step-1 group whose closure (its lane count there, from
        # a settled state) is nearest 10^4 rows, a write of typical reach;
        # "hub": 8 rows drawn as the lane groups are, whose closure spans
        # most of the graph
        near = int(np.argmin(np.abs(np.log(np.maximum(burst["counts"], 1)) - np.log(1e4))))
        local = {}
        for name, rows_local in (("mid", groups1[near]), ("hub", draw(1)[0])):
            live_nodes = await read_rows([rows_local])
            s0 = _live_state(backend, table)
            inv0 = backend.device_invalidations
            value = 3_000_000.0 + len(local)
            sync(device)
            t = time.perf_counter()
            await hub_b.commander.call(RowsSet(tuple(int(r) for r in rows_local), value))
            call_ms = (time.perf_counter() - t) * 1e3
            backend.flush()
            sync(device)
            local_ms = (time.perf_counter() - t) * 1e3
            want_value.update(dict.fromkeys(rows_local.tolist(), value))
            nids = (block.base + rows_local).astype(np.int64)
            s1, s2, dense = in_reference(
                s0, lambda: dg.run_waves_union([nids.tolist()], mirror="off"))
            newly = int((s1["h_invalid"] & ~s0["h_invalid"]).sum())
            dev_inv = backend.device_invalidations - inv0
            if newly != dense[0] or not np.array_equal(s1["h_invalid"], s2["h_invalid"]):
                fail(f"the {name} local write invalidated {newly}, the dense wave {dense[0]}")
            if newly <= len(rows_local) or dev_inv <= 0:
                fail(f"the {name} local write did not cascade on the card: {newly} newly from "
                     f"{len(rows_local)} rows, {dev_inv} device invalidations")
            await read_back(rows_local, svc_b, f"{name} local write")
            local[name] = {"phase": "write_10m_local", "card": card, "rows": name,
                           "call_ms": call_ms, "to_invalidated_ms": local_ms, "newly": newly,
                           "dense_count": dense[0], "device_invalidations": dev_inv,
                           "step1_lane_count": int(burst["counts"][near]) if name == "mid"
                           else None}
        seen = await reader_a.read_new()
        if seen != len(local) or reader_a.external_seen != len(local):
            fail(f"host A's reader saw {seen} operations ({reader_a.external_seen} external)")
        for rec in local.values():
            emit({**rec, "host_a_external": reader_a.external_seen})
        # ---- 5. the hub's restart: the rows of both batches live as scalar
        # nodes, every row valid, the reader at the log's end
        live_nodes = await read_rows(groups1 + groups2)
        await reader_b.read_new()
        ckpt = os.path.join(tmp, "hub.ckpt")
        t = time.perf_counter()
        snap = HubCheckpoint.save(hub_b, ckpt, reader_b.watermark, log_store=log)
        ckpt_save_s = time.perf_counter() - t
        hub_c, dag_c = host()
        t = time.perf_counter()
        res = HubCheckpoint.restore(hub_c, ckpt)
        ckpt_restore_s = time.perf_counter() - t
        table_c = core.memo_table_of(dag_c.node)
        if res.count != len(snap["nodes"]) or res.tables != 1 or table_c.stale_count() != 0:
            fail(f"the restore brought {res.count} of {len(snap['nodes'])} nodes, "
                 f"{res.tables} tables, {table_c.stale_count()} stale rows")
        if res.watermark != log.last_index():
            fail(f"the snapshot's position {res.watermark} is not the log's {log.last_index()}")
        reader_c = attach_operation_log(hub_c.commander, log, start_reader=False,
                                        start_position=res.watermark)
        groups3 = draw(WRITE_RESUME_OPS)
        await commit(groups3, 4_000_000)
        if await reader_c.read_new() != WRITE_RESUME_OPS:
            fail("the restored hub's reader did not replay the operations after the snapshot")
        rows3 = np.unique(np.concatenate(groups3))
        if not np.array_equal(np.nonzero(table_c._stale_host)[0], rows3):
            fail(f"{table_c.stale_count()} rows went stale after the resume, "
                 f"{rows3.size} were written")
        by_row = {int(c.input.args[0]): c for c in res.computeds}
        for r, c in by_row.items():
            if c.is_consistent == (r in set(rows3.tolist())):
                fail(f"restored node {r} is {'consistent' if c.is_consistent else 'invalid'}")
        # the written rows read back their values (a read_batch refreshes
        # every stale row: these, through the host loader), then nothing
        # else loads
        loads["rows"] = 0
        await read_back(rows3, dag_c, "resumed hub")
        resumed_loads = loads["rows"]
        warm = np.setdiff1d(rng.choice(n, size=min(100_000, n), replace=False), rows3)
        loads["rows"] = 0
        got = table_c.read_batch(torch.from_numpy(warm).to(device)).cpu().numpy()
        warm_nodes = [r for r in by_row if r not in set(rows3.tolist())][:256]
        for r in warm_nodes:
            if await core.capture(lambda: dag_c.node(r)) is not by_row[r]:
                fail(f"restored row {r} recomputed")
        if loads["rows"] or not np.array_equal(got, base[warm]):
            fail(f"warm rows loaded {loads['rows']} rows or read wrong values")
        if resumed_loads != rows3.size:
            fail(f"the resumed hub loaded {resumed_loads} rows for {rows3.size} written")
        restart = {"phase": "write_10m_restart", "card": card,
                   "save_graph_s": snapshot["save_s"], "save_graph_by": "the live twin's leg",
                   "load_graph_s": load_s, "leg_load_graph_s": snapshot["load_s"],
                   "graph_bytes": graph_bytes, "restored_union_wave_ms": wave_ms,
                   "union_newly": int(want_wave[0]),
                   "hub_checkpoint_save_s": ckpt_save_s,
                   "hub_checkpoint_restore_s": ckpt_restore_s,
                   "hub_checkpoint_bytes": os.path.getsize(ckpt),
                   "restored_nodes": res.count, "restored_tables": res.tables,
                   "resume_operations": WRITE_RESUME_OPS, "resume_stale_rows": int(rows3.size),
                   "resume_rows_loaded": resumed_loads, "warm_rows_checked": int(warm.size), "warm_nodes_checked": len(warm_nodes),
                   "fresh_hub_backend": "none", "fresh_hub_table_device": str(table_c.device)}
        emit(restart)
        # host B's own reader catches up with the operations committed after
        # the snapshot (their rows held live, as a server holds watched
        # nodes), so the hub leaves this phase current with the store
        live_nodes = await read_rows(groups3)
        if await reader_b.read_new() != WRITE_RESUME_OPS:
            fail("host B's reader did not replay the operations after the snapshot")
        await read_back(rows3, svc_b, "host B after the resume")
        settle()
    finally:
        del backend.invalidate_cascade_batch_lanes
        del backend.invalidate_cascade_batch_lanes_sharded
        log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(commit_p50_ms=commit1["p50_ms"], commit_p99_ms=commit1["p99_ms"],
               read_new_ms=batch["read_new_ms"], replay_ms=batch["replay_ms"],
               burst_ms=batch["burst_ms"], mesh_read_new_ms=meshrec["read_new_ms"],
               mesh_burst_ms=meshrec["burst_ms"],
               local_write_ms={k: v["to_invalidated_ms"] for k, v in local.items()},
               local_newly={k: v["newly"] for k, v in local.items()},
               burst_profile=prof, save_graph_s=snapshot["save_s"], load_graph_s=load_s,
               graph_bytes=restart["graph_bytes"], hub_checkpoint_save_s=ckpt_save_s,
               hub_checkpoint_restore_s=ckpt_restore_s,
               hub_checkpoint_bytes=restart["hub_checkpoint_bytes"],
               max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None)
    emit(out)
    return out


FANOUT_CLIENTS = 100  # perf/fanout_path.py's defaults
FANOUT_KEYS = 16
FANOUT_ROUNDS = 2
FANOUT_GROUPS = 32
FANOUT_SEEDS_PER_GROUP = 4
FANOUT_LONE_SAMPLES = 24
FANOUT_OUTSIDE_KEYS = 4  # keys a client outside every burst's union
FANOUT_REMOTE_IDS = 1_000_000
FANOUT_REMOTE_SEED = 13


def phase_fanout(device, card: str, live: dict) -> dict:
    """``fanout_10m``: the twin of ``perf/fanout_path.py``
    (``stl_fusion_tpu_torch/fanout_path.py``) on the live stack
    :func:`phase_live` built and :func:`phase_write` left settled. The
    server ``RpcHub`` serves ``svc`` as ``"dag"`` with the ``$sys-c`` call
    type and a ``ComputeFanoutIndex`` on the backend's newly hooks.

    1. 100 clients, each on its own ``FusionHub`` and ``RpcHub``: client 0
       over ``rpc/tcp.py`` on 127.0.0.1, the rest over
       ``RpcTestTransport(wire_codec=True)``; each holds the script's 16
       tail-row keys and 4 keys outside the bursts' union (the dense wave of
       the 32 groups' seeds from a settled state, a check whose launches
       are rolled back and whose invalid state is cleared).
    2. ``perkey`` then ``coalesced``, 2 rounds each: subscribe, flush the
       re-subscriptions' churn untimed, one 32-group ``cascade_rows_lanes``
       burst. Each round: the fenced (client, key) pairs are exactly the
       subscribed keys inside the union, each by one invalidation entry;
       the next subscribe reads back every fenced key's value; ``perkey``
       sends no batch frame, ``coalesced`` fewer batch frames than
       subscriptions; the system's ``fusion_e2e_delivery_ms`` histogram
       takes at most one sample a fence, and some. The last coalesced
       burst is profiled.
    3. The host-led leg: one deep seed row invalidated through
       ``invalidating()`` on ``svc.node`` expands at the next flush on the
       mirrors (one seed: the lat mirror, or the topo sweep past its caps,
       as ``write_10m``'s local writes, whose dense launches are its
       restored graph's wave); the fenced subscriptions equal the dense
       wave's closure of the row intersected with the subscribed keys.
    4. The script's lone A/B: 24 samples a mode, alternated, each one
       ``cascade_rows_batch(block, [key])`` whose subscriber is fenced.
    5. A ``RemoteTable`` over ``RemoteTableHost.expose("dag", table)`` on
       client 1: ``read_batch`` of 1,000,000 seeded ids equals the host
       base; one lane burst's ``$sys-t`` fence arrives; after
       ``refresh_block_on_device`` a second ``read_batch`` of the same ids
       fetches exactly the rows among them the burst left stale, and
       returns equal values.

    One ``fanout_10m_round`` line a mode and round, and a ``fanout_10m``
    summary (with the system's delivery histogram a mode and the device
    waves each leg dispatched, by kind), each with the card's name and
    power limit."""
    return asyncio.run(_fanout_10m(device, card, live))


async def _fanout_10m(device, card: str, live: dict) -> dict:
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.client import RemoteTable, RemoteTableHost
    from stl_fusion_tpu_torch.fanout_path import FanoutRun, port_api

    ctx = live["ctx"]
    backend, block, table, svc = ctx["backend"], ctx["block"], ctx["table"], ctx["svc"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    def fail(what):
        raise AssertionError(f"fanout_10m: {what}")

    def checked(fn):
        saved = _launch_state()
        try:
            return fn()
        finally:
            _restore_launches(saved)

    prof = {}

    def around_burst(mode, rnd, fn):
        if not (cuda and mode == "coalesced" and rnd == FANOUT_ROUNDS - 1):
            return fn()
        wall, by_name, calls = profile_device(device, lambda: prof.update(counts=fn()))
        dev_ms = sum(v["ms"] for v in by_name.values())
        prof.update(mode=mode, round=rnd, wall_ms=wall, device_ms=dev_ms,
                    idle_share=1 - dev_ms / wall, device_calls=calls,
                    topo_sweep=kernel_calls(by_name, SYMBOLS["topo_sweep"]),
                    lane_finish=kernel_calls(by_name, SYMBOLS["lane_finish"]))
        return prof.pop("counts")

    run = FanoutRun(port_api(device), ctx, clients=FANOUT_CLIENTS,
                    keys_per_client=FANOUT_KEYS, groups=FANOUT_GROUPS,
                    seeds_per_group=FANOUT_SEEDS_PER_GROUP, outside_keys=FANOUT_OUTSIDE_KEYS,
                    tcp_clients=1, checked=checked, around_burst=around_burst)
    try:
        start = await run.start()
        if [c.transport for c in run.clients[:2]] != ["tcp", "memory"]:
            fail("client 0 is not the TCP client")
        modes = {}
        for mode in ("perkey", "coalesced"):
            modes[mode] = res = await run.run_mode(mode, FANOUT_ROUNDS)
            for r in res["rounds"]:
                emit({"phase": "fanout_10m_round", "card": card, **r})
            # one sample a fence at most: the range guard drops a sample that
            # the peer's probed clock offset maps before its origin
            if not 0 < res["system_delivery_ms"]["count"] <= res["clients_fenced_total"]:
                fail(f"{mode}: the system's delivery histogram took "
                     f"{res['system_delivery_ms']['count']} samples for "
                     f"{res['clients_fenced_total']} fences")
        host_led = await run.host_led()
        if not host_led["fenced"] or len(host_led["fenced"]) >= FANOUT_CLIENTS * FANOUT_KEYS:
            fail(f"the host-led leg fenced {len(host_led['fenced'])} subscriptions")
        lone = await run.lone_ab(FANOUT_LONE_SAMPLES)

        # ---- 5. the remote table over the live 10M-row table
        RemoteTableHost(run.server_rpc).expose("dag", table)
        reader = run.clients[1]
        rt = RemoteTable(reader.rpc, f"c{reader.i}", "dag")
        ids = np.random.default_rng(FANOUT_REMOTE_SEED).choice(
            ctx["n"], size=FANOUT_REMOTE_IDS, replace=False).astype(np.int64)
        t = time.perf_counter()
        got = await rt.read_batch(ids)
        first_ms = (time.perf_counter() - t) * 1e3
        if not np.array_equal(got, svc.base[ids]):
            fail("the remote table's first read differs from the host base")
        fetched = []
        fetch = rt._fetch

        async def counted(rows):
            fetched.append(len(rows))
            await fetch(rows)

        rt._fetch = counted
        fences0 = rt.fences_seen
        t = time.perf_counter()
        backend.cascade_rows_lanes(block, [run.groups[0]])
        burst_stale = table.stale_count()
        stale = int(table._stale_host[ids].sum())
        # the burst's seeds fence first (their scalar nodes), then the wave
        while int((~rt._valid[ids]).sum()) < stale:
            if time.perf_counter() - t > 60:
                fail(f"the remote table's fence did not arrive ({rt.fences_seen - fences0} "
                     f"fences, {int((~rt._valid[ids]).sum())} of {stale} rows)")
            await asyncio.sleep(0.001)
        fence_ms = (time.perf_counter() - t) * 1e3
        fences = rt.fences_seen - fences0
        await asyncio.sleep(0.05)
        local_stale = int((~rt._valid[ids]).sum())
        backend.refresh_block_on_device(block)
        backend.flush()
        t = time.perf_counter()
        again = await rt.read_batch(ids)
        reread_ms = (time.perf_counter() - t) * 1e3
        if not stale or sum(fetched) != stale or local_stale != stale:
            fail(f"the re-read fetched {sum(fetched)} rows, the fence left {local_stale} "
                 f"stale, the burst {stale} among the ids")
        if not np.array_equal(again, svc.base[ids]):
            fail("the remote table's re-read differs from the host base")
        rt.dispose()
        itemsize = got.dtype.itemsize
        remote = {"ids": FANOUT_REMOTE_IDS, "first_read_ms": first_ms,
                  "first_read_bytes": int(got.nbytes), "fence_ms": fence_ms,
                  "fences": fences, "fence_rows": burst_stale, "fence_bytes": burst_stale * 4,
                  "stale_rows_among_ids": stale, "reread_ms": reread_ms,
                  "reread_rows_fetched": int(sum(fetched)),
                  "reread_bytes": int(sum(fetched) * itemsize),
                  "remote_reads": rt.remote_reads}
        run.settle_block()
    finally:
        await run.close()
    pk, co = modes["perkey"], modes["coalesced"]
    out = {"phase": "fanout_10m", "card": card, "clients": FANOUT_CLIENTS,
           "keys_per_client": FANOUT_KEYS, "outside_keys_per_client": FANOUT_OUTSIDE_KEYS,
           "rounds": FANOUT_ROUNDS, "lane_groups": FANOUT_GROUPS,
           "seeds_per_group": FANOUT_SEEDS_PER_GROUP, "union": start["union"],
           "outside_union": start["outside_union"],
           "clients_fenced_per_s": {"perkey": pk["clients_fenced_per_s"],
                                    "coalesced": co["clients_fenced_per_s"]},
           "coalesced_vs_perkey_speedup": co["clients_fenced_per_s"] / pk["clients_fenced_per_s"],
           "burst_inv_total": {"perkey": pk["burst_inv_total"],
                               "coalesced": co["burst_inv_total"]},
           "batch_frames": {"perkey": pk["batch_frames"], "coalesced": co["batch_frames"]},
           "keys_per_frame": co["keys_per_frame"], "coalesce_ratio": co["coalesce_ratio"],
           "delivery_ms_p50_p99": {m: [r["delivery_ms_p50"], r["delivery_ms_p99"]]
                                   for m, r in modes.items()},
           "tcp_delivery_ms_p50_p99": {m: [r["tcp_delivery_ms_p50"], r["tcp_delivery_ms_p99"]]
                                       for m, r in modes.items()},
           "system_delivery_ms": {m: r["system_delivery_ms"] for m, r in modes.items()},
           "dispatches": {**{m: r["dispatches"] for m, r in modes.items()},
                          "host_led": host_led["dispatches"], "lone": lone["lone_dispatches"]},
           "staleness_ms_p50_p99": {m: [r["staleness_ms_p50"], r["staleness_ms_p99"]]
                                    for m, r in modes.items()},
           "lone_ms_p50_p99": {m: [lone[f"{m}_lone_ms_p50"], lone[f"{m}_lone_ms_p99"]]
                               for m in ("perkey", "coalesced")},
           "lone_samples_per_mode": lone["lone_samples_per_mode"],
           "host_led": {k: v for k, v in host_led.items() if k not in ("fenced", "dispatches")}
           | {"fenced": len(host_led["fenced"])},
           "remote_table": remote, "burst_profile": prof, "start_s": start["start_s"],
           "phase_s": time.perf_counter() - t_phase,
           "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else None}
    emit(out)
    return out


EDGE_NODES = 4  # perf/edge_path.py's defaults
EDGE_SESSIONS = 1_000_000
EDGE_KEYS = 512
EDGE_KEYS_PER_SESSION = 2
EDGE_ZIPF = 1.1
EDGE_ROUNDS = 2
EDGE_GROUPS = 16
EDGE_SEEDS_PER_GROUP = 2
EDGE_WORKERS = 2
EDGE_FAN_WORKERS = 2


def phase_edge(device, card: str, live: dict) -> dict:
    """``edge_10m``: the twin of ``perf/edge_path.py``
    (``stl_fusion_tpu_torch/edge_path.py``, ``EdgeRun``) at the script's
    defaults on the live stack :func:`phase_live` built and
    :func:`phase_fanout` left settled: the server graph is the stack's 10M
    rows, not the script's 2M.

    1. The server ``RpcHub`` serves ``svc`` as ``"dag"`` with a
       ``ComputeFanoutIndex`` and a ``WaveValuePublisher``; the 512 tail-row
       keys round-robin into 16 groups with 2 deep seeds each; one untimed
       warm ``cascade_rows_lanes`` burst and refresh.
    2. 4 ``EdgeNode``s, each on its own ``FusionHub`` and ``RpcHub`` over
       ``RpcTestTransport(wire_codec=True)``, 2 fan workers and an
       ``EdgeWorkerPool`` of 2 worker processes on the ``send_fds`` plane;
       one probe session an edge over every key, then 1,000,000 sessions
       (250,000 an edge, in the workers) of 2 keys by zipf 1.1.
    3. 2 measured rounds, each one 16-group burst that fences every key,
       held exactly (``EdgeRun.run_rounds``): 512 upstream subscriptions an
       edge and 2,048 in the server's index, every expected delivery
       arrived once, every key one version up at the server's value, no
       eviction, no per-key re-read and no upstream RPC, every fence a
       block hit. The last burst is profiled.
    4. The gates (encodes between the keys and the fanned versions,
       deliveries per encode above the floor) and the smoke leg: a real
       ``EdgeHttpServer`` with 2 SSE consumers over TCP loopback, one
       burst, a ``/metrics`` scrape with ``fusion_edge_sessions``, a
       non-empty ``fusion_edge_delivery_ms`` and 2,048 upstream
       subscriptions, and one consumer through the pool's listener. The
       WebSocket leg runs only where ``websockets`` is installed.

    One ``edge_10m_round`` line a round and an ``edge_10m`` summary, each
    with the card's name and power limit."""
    return asyncio.run(_edge_10m(device, card, live))


async def _edge_10m(device, card: str, live: dict) -> dict:
    import torch

    from stl_fusion_tpu_torch.edge_path import EdgeRun, port_api

    ctx = live["ctx"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    prof = {}

    def around_burst(rnd, fn):
        if not (cuda and rnd == EDGE_ROUNDS - 1):
            return fn()
        wall, by_name, calls = profile_device(device, lambda: prof.update(counts=fn()))
        dev_ms = sum(v["ms"] for v in by_name.values())
        prof.update(round=rnd, wall_ms=wall, device_ms=dev_ms, idle_share=1 - dev_ms / wall,
                    device_calls=calls,
                    topo_sweep=kernel_calls(by_name, SYMBOLS["topo_sweep"]),
                    lane_finish=kernel_calls(by_name, SYMBOLS["lane_finish"]),
                    top_kernels=dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:6]))
        return prof.pop("counts")

    run = EdgeRun(port_api(device), ctx, edge_nodes=EDGE_NODES, sessions=EDGE_SESSIONS,
                  keys=EDGE_KEYS, keys_per_session=EDGE_KEYS_PER_SESSION, zipf=EDGE_ZIPF,
                  groups=EDGE_GROUPS, seeds_per_group=EDGE_SEEDS_PER_GROUP,
                  workers=EDGE_WORKERS, fan_workers=EDGE_FAN_WORKERS,
                  value_plane="block", accept_plane="send_fds", around_burst=around_burst)
    try:
        start = await run.start()
        rec = await run.run_rounds(EDGE_ROUNDS)
        for r in rec["rounds"]:
            line = {"phase": "edge_10m_round", "card": card, **r}
            if r["round"] == EDGE_ROUNDS - 1:
                line["burst_profile"] = {k: v for k, v in prof.items() if k != "top_kernels"}
            emit(line)
        gates = await run.gates()
        smoke = await run.smoke()
    finally:
        await run.close()
    last = rec["rounds"][-1]
    out = {"phase": "edge_10m", "card": card, "graph_nodes": run.n,
           "edge_nodes": EDGE_NODES, "workers_per_edge": EDGE_WORKERS,
           "fan_workers": EDGE_FAN_WORKERS, "sessions": start["subscribers"],
           "sessions_per_edge": start["sessions_per_edge"], "distinct_keys": EDGE_KEYS,
           "keys_per_session": EDGE_KEYS_PER_SESSION, "zipf_a": EDGE_ZIPF,
           "subscriptions": start["subscriptions"], "rounds": EDGE_ROUNDS,
           "lane_groups": EDGE_GROUPS, "seeds_per_group": EDGE_SEEDS_PER_GROUP,
           "value_plane": "block", "accept_plane": "send_fds", "wire_codec": True,
           "reduced": [],
           "upstream_subs_per_edge": gates["upstream_subs_per_edge"],
           "server_subscriptions": gates["server_subscriptions"],
           "deliveries_per_s": rec["fenced_per_s"],
           "deliveries_per_s_by_round": [r["deliveries_per_s"] for r in rec["rounds"]],
           "fenced_total": rec["fenced_total"], "fanout_s": rec["fanout_s"],
           "system_delivery_ms_p50_p99": last["system_delivery_ms_p50_p99"],
           "system_delivery_ms": last["system_delivery_ms"],
           "harness_delivery_ms_p50_p99": last["harness_delivery_ms_p50_p99"],
           "worker_done_ms": last["worker_done_ms"],
           "burst_host_ms": [r["burst_ms"] for r in rec["rounds"]],
           "burst_inv": [r["inv"] for r in rec["rounds"]],
           "burst_profile": prof,
           "upstream_rpcs_per_burst": gates["upstream_rpcs_per_burst"],
           "block_hit_ratio": gates["block_hit_ratio"],
           "frames_encoded": gates["frames_encoded"], "fanned_versions": gates["fanned_versions"],
           "deliveries_total": gates["deliveries_total"], "encode_ratio": gates["encode_ratio"],
           "encode_ratio_floor": gates["encode_ratio_floor"], "evictions": gates["evictions"],
           "publisher": gates["publisher"], "per_edge_rss_mb": start["per_edge_rss_mb"],
           "per_worker_rss_mb": gates["per_worker_rss_mb"],
           "subscribe_s": start["subscribe_s"], "attach_s": start["attach_s"],
           "warm_burst_s": start["warm_burst_s"], "smoke": smoke,
           "ws_leg": smoke["ws_leg"], "dispatches": run.dispatches,
           "phase_s": time.perf_counter() - t_phase,
           "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else None}
    emit(out)
    return out


RES_GROUPS = 32  # a fanout_10m-shaped lane burst of tail-row keys
RES_KEYS_PER_GROUP = 16
RES_KEY_SEED = 1414
RES_DEADLINE_S = 5.0  # the watchdog's default deadline
RES_RECOVERY_BURSTS = 2
RES_CHECK_ROWS = 4096
RES_SWEEP_SAMPLE = 0.01  # the auditor's sampled sweep shape


def phase_resilience(device, card: str, live: dict) -> dict:
    """``resilience_10m``: the wave watchdog (``resilience/watchdog.py``)
    attached to the live stack :func:`phase_edge` left, with
    ``recovery_bursts=2``. Every burst is a 32-group ``cascade_rows_lanes``
    of 16 tail rows a group (fresh rows a burst), and the block is refreshed
    on the device after each one.

    1. A fused burst: its union and lanes 0 and 31 equal dense waves from
       the same state (the check waves' launches rolled back).
    2. ``inject_fault_next()``, then a burst: it re-runs on the split host
       loop (one dense ``run_waves_union(mirror="off")`` a group on the
       card); its union equals the fused union of the same seeds on a
       snapshot, its first group's count the fused one, its counts sum to
       the union and none exceeds the fused lane's (the sequential
       semantics).
    3. The second host burst (profiled), then a fused burst the oracle
       verifies against a host CSR BFS over the live edge set: one
       re-engagement, no mismatch.
    4. A deadline trip (``deadline_s = 0`` for one fused burst, whose
       result stands and equals the dense union), then two host bursts and
       a verified fused burst again.
    5. ``inject_fault_next()`` before one super-round on the live program:
       one super-round fault, the whole block re-staled and refreshed
       (``block_refresh``), its rounds eager under the degraded watchdog
       (two on the host loop, the third fused and verified); then 4,096
       random block rows read equal to the service's values.
    6. A watched scalar twin of a seed row, then a fused burst: ``explain``
       of it names the burst's cause id and wave. The invariant sweeps in
       the auditor's sampled shape (``validate_hub``, ``validate_mirror``
       at 1 %) are clean. ``FusionMonitor.report()``'s resilience ledger
       equals the watchdog's counters. A ``FusionHttpServer`` on loopback
       over the live hub answers ``/explain?key=``, ``/health`` and
       ``/trace?cause=`` 200 (a single-card lane burst records no trace
       segment, so the phase records the explained burst's host span under
       its cause first).

    Every count is exact: faults, fallbacks, deadline trips, oracle checks
    and re-engagements equal what the phase injected, with no mismatch. One
    ``resilience_10m`` line with the card's name and power limit."""
    return asyncio.run(_resilience_10m(device, card, live))


async def _resilience_10m(device, card: str, live: dict) -> dict:
    import urllib.parse

    import numpy as np
    import torch

    from stl_fusion_tpu_torch.core import capture, set_default_hub
    from stl_fusion_tpu_torch.diagnostics import (
        FusionMonitor,
        explain,
        global_mesh_trace,
        validate_hub,
        validate_mirror,
    )
    from stl_fusion_tpu_torch.ops import block_refresh as brf
    from stl_fusion_tpu_torch.ops.bitops import unpack_words_host
    from stl_fusion_tpu_torch.resilience import ResilienceEvents, WaveWatchdog
    from stl_fusion_tpu_torch.rpc import RpcHub
    from stl_fusion_tpu_torch.rpc.http_gateway import FusionHttpServer

    ctx = live["ctx"]
    backend, block, table, svc, n = ctx["backend"], ctx["block"], ctx["table"], ctx["svc"], ctx["n"]
    hub, dg = backend.hub, backend.graph
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(RES_KEY_SEED)

    def fail(what):
        raise AssertionError(f"resilience_10m: {what}")

    def checked(fn):
        saved = _launch_state()
        try:
            return fn()
        finally:
            _restore_launches(saved)

    def graph_state():
        return dg.device_arrays().invalid.clone(), dg._h_invalid.copy()

    def set_graph_state(st):
        dg.device_arrays().invalid.copy_(st[0])
        dg._h_invalid[:] = st[1]

    def under(st, fn):
        """``fn()`` on the graph state ``st``, then the current state back;
        its launches rolled back (a check, not the path)."""
        now = graph_state()
        set_graph_state(st)
        try:
            return checked(fn)
        finally:
            set_graph_state(now)

    journal_kinds: dict = {}

    def settle():
        """The block refreshed and the journal flushed empty, with the
        watchdog detached: the flush's host-led expansions are the
        backend's upkeep, not bursts the phase counts."""
        wd_, backend.watchdog = backend.watchdog, None
        try:
            backend._drain_nonblocking()
            for _ in range(8):
                for kind, _v in backend._journal:
                    journal_kinds[kind] = journal_kinds.get(kind, 0) + 1
                backend.flush()
                backend.refresh_block_on_device(block)
                if not backend._journal:
                    return
            fail(f"the journal does not settle: {[k for k, _v in backend._journal][:8]}")
        finally:
            backend.watchdog = wd_

    def seeds_of(groups):
        return [(block.base + g).tolist() for g in groups]

    redraws = [0]

    def new_groups():
        """32 groups of 16 fresh tail rows whose closure holds no watched
        node: a watched node's eager invalidation cascades host-side to
        its dependents, whose marks the next flush expands through the
        watchdog (an extra dispatch the phase did not make)."""
        nn = dg.n_nodes
        for _ in range(50):
            rows = n - 1 - rng.choice(n // 4, size=RES_GROUPS * RES_KEYS_PER_GROUP, replace=False)
            groups = [rows[i::RES_GROUPS].astype(np.int64) for i in range(RES_GROUPS)]
            if not backend._watched[:nn].any():
                return groups
            _c, mask = under(graph_state(), lambda: dg.run_waves_lanes(seeds_of(groups)))
            if not (mask[:nn] & backend._watched[:nn]).any():
                return groups
            redraws[0] += 1
        fail("no draw of 512 tail rows avoids every watched node's closure")

    def burst(groups):
        if backend._journal:
            fail(f"the journal holds {[k for k, _v in backend._journal][:8]} before a burst")
        pre = graph_state()
        t = time.perf_counter()
        counts = backend.cascade_rows_lanes(block, groups)
        sync(device)
        ms = (time.perf_counter() - t) * 1e3
        nn = dg.n_nodes
        union = dg._h_invalid[:nn] & ~pre[1][:nn]
        return np.asarray(counts, dtype=np.int64), union, ms, pre

    def dense_exact(what, groups, counts, union, pre, lanes=(0, 31)):
        seeds = seeds_of(groups)
        c, ids = under(pre, lambda: dg.run_waves_union([sum(seeds, [])], mirror="off"))
        if c != int(union.sum()) or not np.array_equal(ids, np.nonzero(union)[0]):
            fail(f"{what}: the union ({int(union.sum())}) differs from the dense union ({c})")
        for lane in lanes:
            c, _ = under(pre, lambda: dg.run_waves_union([seeds[lane]], mirror="off"))
            if c != int(counts[lane]):
                fail(f"{what}: lane {lane} counts {int(counts[lane])}, dense {c}")
        return int(union.sum())

    settle()
    words = dg.device_arrays().invalid.cpu().numpy()
    if not np.array_equal(unpack_words_host(words, len(dg._h_invalid)), dg._h_invalid):
        fail("the host invalid mirror lags the device words before the watchdog attaches")
    events = ResilienceEvents()
    wd = backend.attach_watchdog(WaveWatchdog(deadline_s=RES_DEADLINE_S,
                                              recovery_bursts=RES_RECOVERY_BURSTS, events=events))
    want = {"faults": 0, "fallbacks": 0, "deadline_trips": 0, "reengages": 0,
            "oracle_checks": 0, "oracle_mismatches": 0}
    oracle_s = []
    real_verify = wd._oracle_verify

    def timed_verify(*args):
        t = time.perf_counter()
        real_verify(*args)
        oracle_s.append(time.perf_counter() - t)

    wd._oracle_verify = timed_verify

    def expect(what, mode):
        got = {k: v for k, v in wd.snapshot().items() if k in want}
        if got != want or wd.mode != mode:
            fail(f"{what}: the watchdog reads {wd.snapshot()}, expected {want} in mode {mode}")

    rec: dict = {"phase": "resilience_10m", "card": card, "graph_nodes": n,
                 "groups": RES_GROUPS, "keys_per_group": RES_KEYS_PER_GROUP,
                 "recovery_bursts": RES_RECOVERY_BURSTS, "deadline_s": RES_DEADLINE_S,
                 "watched_nodes": int(backend._watched[:dg.n_nodes].sum()),
                 "newly_hooks": len(backend.newly_hooks),
                 "wave_invalidate_hooks": len(table.on_wave_invalidate)}
    try:
        # 1. a fused burst
        g1 = new_groups()
        counts, union, ms, pre = burst(g1)
        expect("the fused burst", wd.MODE_FUSED)
        rec["fused_ms"], rec["fused_inv"] = ms, dense_exact("the fused burst", g1, counts, union, pre)
        settle()

        # 2. an injected fault: the split host loop
        g2 = new_groups()
        snap = graph_state()
        f_counts, f_mask = under(snap, lambda: dg.run_waves_lanes(seeds_of(g2)))
        f_union = f_mask[: dg.n_nodes]
        wd.inject_fault_next()
        counts, union, ms, pre = burst(g2)
        want.update(faults=1, fallbacks=1)
        expect("the faulted burst", wd.MODE_HOST)
        if not np.array_equal(union, f_union):
            fail(f"the degraded burst's union ({int(union.sum())}) differs from the fused union "
                 f"of the same seeds ({int(f_union.sum())})")
        if (int(counts[0]) != int(f_counts[0]) or int(counts.sum()) != int(union.sum())
                or (counts > np.asarray(f_counts)).any()):
            fail(f"the degraded counts {counts.tolist()} break the sequential semantics "
                 f"(fused {np.asarray(f_counts).tolist()})")
        rec["degraded_ms"], rec["degraded_inv"] = [ms], [int(union.sum())]
        settle()

        # 3. recovery: the second host burst (profiled), then the oracle
        g3 = new_groups()
        prof = {}
        if cuda:
            out = {}
            wall, by_name, calls = profile_device(device, lambda: out.update(r=burst(g3)))
            counts, union, ms, pre = out["r"]
            dev_ms = sum(v["ms"] for v in by_name.values())
            prof = {"wall_ms": wall, "device_ms": dev_ms, "device_share": dev_ms / wall,
                    "idle_share": 1 - dev_ms / wall, "device_calls": calls,
                    "wave_expand_merge": kernel_calls(by_name, SYMBOLS["wave_expand_merge"]),
                    "or_popcount.merge": kernel_calls(by_name, SYMBOLS["or_popcount.merge"]),
                    "or_popcount.delta": kernel_calls(by_name, SYMBOLS["or_popcount.delta"])}
        else:
            counts, union, ms, pre = burst(g3)
        want.update(fallbacks=2)
        expect("the second host burst", wd.MODE_FUSED)
        dense_exact("the second host burst", g3, counts, union, pre, lanes=())
        rec["degraded_ms"].append(ms)
        rec["degraded_inv"].append(int(union.sum()))
        rec["degraded_profile"] = prof
        settle()
        g4 = new_groups()
        counts, union, ms, pre = burst(g4)
        want.update(reengages=1, oracle_checks=1)
        expect("the verified burst", wd.MODE_FUSED)
        rec["verify_ms"] = [ms]
        dense_exact("the verified burst", g4, counts, union, pre)
        settle()

        # 4. a deadline trip, then recovery as in 3
        wd.deadline_s = 0.0
        g5 = new_groups()
        counts, union, ms, pre = burst(g5)
        wd.deadline_s = RES_DEADLINE_S
        want.update(deadline_trips=1)
        expect("the deadline trip", wd.MODE_HOST)
        dense_exact("the too-slow burst", g5, counts, union, pre)
        rec["deadline_burst_ms"] = ms
        settle()
        for i in range(RES_RECOVERY_BURSTS):
            counts, union, ms, pre = burst(new_groups())
            want["fallbacks"] += 1
            rec["degraded_ms"].append(ms)
            rec["degraded_inv"].append(int(union.sum()))
            settle()
        expect("the host bursts after the trip", wd.MODE_FUSED)
        counts, union, ms, pre = burst(new_groups())
        want.update(reengages=2, oracle_checks=2)
        expect("the second verified burst", wd.MODE_FUSED)
        rec["verify_ms"].append(ms)
        settle()

        # 5. a super-round fault on the live program
        prog = backend.super_rounds
        if prog is None or prog._disposed:
            prog = backend.enable_super_rounds(block, depth=3, max_words=16)
        depth = prog.depth
        faults0, eager0, brf0 = prog.faults, prog.eager_rounds, brf.launches
        rounds = [new_groups() for _ in range(depth)]
        wd.inject_fault_next()
        t = time.perf_counter()
        ticket = prog.dispatch(prog.stage(rounds))
        if not ticket.done:
            prog.drain()
        sr_ms = (time.perf_counter() - t) * 1e3
        if not (ticket.done and ticket.fallback) or prog.faults != faults0 + 1:
            fail(f"the injected super-round fault was not contained as one fault "
                 f"(faults {prog.faults - faults0}, fallback {ticket.fallback})")
        if prog.eager_rounds != eager0 + depth:
            fail(f"the faulted super-round ran {prog.eager_rounds - eager0} eager rounds, "
                 f"not {depth}")
        if cuda and brf.launches < brf0 + 1 + depth:
            fail(f"the fault's re-stale and the eager rounds made {brf.launches - brf0} "
                 f"block_refresh launches, fewer than {1 + depth}")
        # the fault degrades; the eager rounds run RECOVERY_BURSTS on the host
        # loop, then the next one fused and verified; the fault path counts
        # one more host burst at its end
        want["faults"] += 1
        want["fallbacks"] += RES_RECOVERY_BURSTS + 1
        if depth > RES_RECOVERY_BURSTS:
            want["reengages"] += 1
            want["oracle_checks"] += 1
        expect("the super-round fault", wd.MODE_FUSED)
        settle()
        ids = np.sort(rng.choice(n, size=RES_CHECK_ROWS, replace=False))
        got = table.read_batch(torch.from_numpy(ids.astype(np.int32)).to(device)).cpu().numpy()
        if not np.array_equal(got, svc.load(ids)):
            fail(f"{int((got != svc.load(ids)).sum())} of {RES_CHECK_ROWS} random block rows "
                 f"differ from the service's values after the super-round fault")
        rec["superround"] = {"depth": depth, "ms": sr_ms, "faults": prog.faults - faults0,
                             "eager_rounds": prog.eager_rounds - eager0,
                             "block_refresh_launches": brf.launches - brf0,
                             "rows_checked": RES_CHECK_ROWS}

        # 6. explain, the sweeps, the monitor and the gateway
        g = new_groups()
        row = int(g[0][0])
        old_hub = set_default_hub(hub)
        try:
            twin = await capture(lambda: svc.node(row))
            twin.on_invalidated(lambda _c: None)  # watched: the wave applies eagerly
            settle()  # the twin's adoption of its row node
            t0 = time.perf_counter()
            counts, union, ms, pre = burst(g)
            t1 = time.perf_counter()
        finally:
            set_default_hub(old_hub)
        if not twin.is_invalidated:
            fail(f"the watched twin of seed row {row} was not invalidated by the burst")
        cause, seq = backend.last_cause_id, backend.last_wave_seq
        report = explain(twin, hub=hub)
        inv = report["invalidation"] or {}
        if inv.get("cause") != cause or (inv.get("wave") or {}).get("seq") != seq or not any(
                "invalidated by wave" in line for line in report["chain"]):
            fail(f"explain of row {row} does not name the burst {cause} / wave {seq}: {report}")
        rec["explain"] = {"row": row, "cause": cause, "wave_seq": seq, "chain": report["chain"]}
        monitor = FusionMonitor(hub, resilience=events)
        try:
            res = monitor.report()["resilience"]
            ledger = {"wave_fault": wd.faults, "wave_deadline": wd.deadline_trips,
                      "wave_reengaged": wd.reengages}
            if {k: res.get(k, 0) for k in ledger} != ledger:
                fail(f"the monitor's resilience ledger {res} differs from the watchdog's {ledger}")
            global_mesh_trace().record(cause, "fence_drain", t0, t1)
            server = FusionHttpServer(RpcHub("resilience-gateway"))
            server.monitor = monitor
            await server.start()
            try:
                key = urllib.parse.quote(report["key"])
                routes = {}
                for path in (f"/explain?key={key}", "/health",
                             f"/trace?cause={urllib.parse.quote(cause)}"):
                    status, body = await _http_get("127.0.0.1", server.port, path)
                    routes[path.split("?")[0]] = status
                    if not status.endswith(" 200 OK"):
                        fail(f"GET {path} answered {status}: {body[:300]!r}")
                    if path.startswith("/explain") and cause.encode() not in body:
                        fail(f"GET /explain does not name the cause {cause}")
            finally:
                await server.stop()
        finally:
            monitor.dispose()
        rec["gateway"] = routes
        # a block refresh clears a row's device bit while its invalidated
        # scalar twin waits for its next read, which the mirror sweep's M2
        # ("host-invalidated implies invalid on the device") reads as an
        # incoherence: the twins left so (the explained one, the earlier
        # phases' subscribed keys) are read again, and the stack settled,
        # until none is left
        old_hub = set_default_hub(hub)
        twins_updated = []
        try:
            if await svc.node(row) != float(svc.load([row])[0]):
                fail(f"the twin of row {row} recomputed a value other than the service's")
            for _ in range(8):
                settle()
                stale = [c for c in (backend.computed_for(nid)
                                     for nid in list(backend._id_by_input.values()))
                         if c is not None and c.is_invalidated
                         and not dg._h_invalid[c._backend_nid]]
                if not stale:
                    break
                twins_updated.append(len(stale))
                for c in stale:
                    await c.update()
            else:
                fail(f"{len(stale)} invalidated twins keep a clear device bit after 8 rounds")
        finally:
            set_default_hub(old_hub)
        rec["twins_updated"] = twins_updated
        t = time.perf_counter()
        hub_rep = validate_hub(hub, sample=RES_SWEEP_SAMPLE)
        hub_s = time.perf_counter() - t
        t = time.perf_counter()
        mirror_rep = validate_mirror(backend, sample=RES_SWEEP_SAMPLE)
        mirror_s = time.perf_counter() - t
        if not (hub_rep.ok and mirror_rep.ok):
            fail(f"the sampled sweeps found violations: {hub_rep.violations[:4]} "
                 f"{mirror_rep.violations[:4]}")
        rec["sweeps"] = {"sample": RES_SWEEP_SAMPLE, "hub_s": hub_s,
                         "hub_nodes": hub_rep.checked_nodes, "mirror_s": mirror_s,
                         "mirror_nodes": mirror_rep.checked_nodes}
    finally:
        wd._oracle_verify = real_verify
        backend.watchdog = None
    rec.update(watchdog=wd.snapshot(), events=events.snapshot(), oracle_s=oracle_s,
               settle_journal=journal_kinds, redraws=redraws[0],
               phase_s=time.perf_counter() - t_phase,
               max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None)
    emit(rec)
    return rec


async def _http_get(host: str, port: int, path: str) -> tuple:
    """(status line, body) of one ``GET`` over a fresh connection."""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\nConnection: close\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return head.split(b"\r\n", 1)[0].decode(), body


def phase_read(device, card: str) -> dict:
    """``read_1k``: the twin of ``perf/read_throughput.py``
    (``stl_fusion_tpu_torch/read_throughput.py``) with its tables on the
    card: every mode that touches a table at the script's full sizes (the
    ``RemoteTable`` modes with and without the mutator, the vectorized
    modes with host and device ids, the device chain), the host-only modes
    (scalar, hot, RPC client, no fusion) at ``--quick``'s counts. Each mode
    passes the twin's exactness checks. The chain's rate is held beside
    its bound: the ids and rows its gathers read over the card's memory
    rate. One ``read_1k`` line with the card's name and power limit."""
    from stl_fusion_tpu_torch.read_throughput import HOST_MODES, SIZES, quick_sizes, run_read

    t = time.perf_counter()
    sizes = dict(SIZES, **{m: quick_sizes()[m] for m in HOST_MODES})
    rec = run_read(sizes=sizes, device=device)
    modes = rec.pop("modes")
    n_chained, batch = sizes["fusion_device_chained"]
    chain = modes["fusion_device_chained"]
    read_bytes = n_chained * batch * (4 + 2 * 4)  # an int32 id and a float32[2] row each
    bound_s = read_bytes / PEAK_BYTES_PER_S
    out = {"phase": "read_1k", "card": card, "users": 1000, "sizes": sizes,
           "k_ops_per_s": {m: rec[m] / 1e3 for m in modes},
           "db_reads": {m: v["db_reads"] for m, v in modes.items() if v["db_reads"] is not None},
           "rpc_round_trips": {m: v["rpc_reads"] for m, v in modes.items()
                               if v["rpc_reads"] is not None},
           "seconds": {m: v["seconds"] for m, v in modes.items()},
           "chain": {"ops_per_s": rec["fusion_device_chained"], "bound_ops_per_s":
                     n_chained * batch / bound_s, "bound_s": bound_s, "bytes": read_bytes,
                     "readback": chain["readback"]},
           "speedups": {k: v for k, v in rec.items() if k.startswith("speedup")},
           "phase_s": time.perf_counter() - t}
    emit(out)
    return out


MESH_SHARDS = 8  # logical shards of the routed mesh phases
MESH_HIER_DPH = 4  # hier: 2 hosts of 4 shards
SRC_ROUTED = "stl_fusion_tpu_torch/csrc/routed_level.cu"
REP_ROUTED = "stl_fusion_tpu/parallel/routed_wave.py:301 (XLA level of _wave; no Pallas kernel)"


def routed_capture(g, seed_ids, pick) -> dict:
    """The input of one launch of ``g``'s wave from ``seed_ids``, which has
    just run: ``pick(table, merge_slots, spec_slots)`` names a slot of that
    run's table (``RoutedWave.last``), and the wave runs again from a clear
    state with a tap that copies what that launch reads: the exchanged
    words, the frontier, the invalid words and the async accumulator.
    Leaves ``g`` clear."""
    import numpy as np

    w = g._wave
    table, merge, spec = w.last
    k = pick(table, merge, spec)
    cap = {}

    def tap(i, x, stride, cross, run, is_spec):
        if i == k:
            cap.update(x=x.clone(), stride=stride, spec=is_spec,
                       cross=None if cross is None else cross.clone(),
                       front=(run.acc if run.acc is not None and not is_spec else run.f).clone(),
                       inv=run.invalid.clone(),
                       acc=None if run.acc is None else run.acc.clone())
    g.clear_invalid()
    w.tap = tap
    try:
        g.run_wave_collect(list(np.asarray(seed_ids).tolist()))
    finally:
        w.tap = None
    g.clear_invalid()
    if not cap:
        raise AssertionError(f"the wave's rerun made no launch at slot {k}")
    slots = spec if cap["spec"] else merge
    cap.update(newly=int(table[k, g.n_dev]), level=slots.index(k) + 1)
    return cap


def widest(table, merge, spec, form="level"):
    """The slot of the widest level (or speculative level) of a run."""
    slots = spec if form == "spec" else merge
    return max(slots, key=lambda i: table[i, -2])


#: bytes of each live edge's routing a level reads: ``ebslot`` and ``ebit``
#: (mode 0), ``eprod`` too (a2a, hier), ``elsrc`` alone (spec)
ROUTED_ROUTING_BYTES = {"routed_level.gather": 8, "routed_level.a2a": 12,
                        "routed_level.hier": 12, "routed_level.spec": 4}


def routed_level_row(device, g, cap, edges, name: str, form: str, shape: str,
                     main_path: bool) -> dict:
    """``phase_kernels``' row of one ``routed_level`` launch on ``g`` (the
    input :func:`routed_capture` took): the kernel against its plain version
    on the same words and state (exact, and its newly count that of the
    wave's own launch), CUDA-event time less the restore, the plain
    version's time and the kernel's device time (``torch.profiler``). The
    bound: each live edge's routing (``ROUTED_ROUTING_BYTES``) and one read
    of the source words, 12 B for each edge whose source is in the frontier
    (``edst``, ``eepoch``, the destination's epoch; spec: local sources
    only), the invalid words read once and each word the level lit written
    once in ``invalid`` and ``next`` (and ``acc``). Made where the graph
    lives; the caller rolls the launches back. ``form`` is the launch
    counter the row's launches come from."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import routed_wave as rw

    w, spec = g._wave, cap["spec"]
    x, stride, cross, inv0, acc0 = cap["x"], cap["stride"], cap["cross"], cap["inv"], cap["acc"]
    L = w.layout
    state = []
    for fn in (rw.routed_level, rw.routed_level_plain):
        inv, nxt = inv0.clone(), torch.zeros_like(cap["front"])
        acc = None if acc0 is None or not spec else acc0.clone()
        out = torch.zeros(rw.slot_width(g.n_dev), dtype=torch.int64, device=device)

        def restore(inv=inv, nxt=nxt, out=out, acc=acc):
            inv.copy_(inv0)
            nxt.zero_()
            out.zero_()
            if acc is not None:
                acc.copy_(acc0)

        def call(fn=fn, inv=inv, nxt=nxt, out=out, acc=acc, restore=restore):
            restore()
            fn(x, stride, cross, L, w.nepoch, inv, nxt, out, acc=acc, spec=spec)
        call()
        state.append((call, restore, inv, nxt, out) + (() if acc is None else (acc,)))
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in zip(state[0][2:], state[1][2:]))
    if err:
        raise AssertionError(f"{name} differs from its plain version")
    newly = int(state[0][4][g.n_dev])
    if newly != cap["newly"]:
        raise AssertionError(f"{name}: the level lit {newly}, the wave's launch {cap['newly']}")
    call, restore = state[0][0], state[0][1]
    with_ms, restore_ms = time_ms(call, device), time_ms(restore, device)
    plain_ms = time_ms(state[1][0], device, reps=3)
    prof = {}
    if device.type == "cuda":
        key = "routed_level.spec" if spec else "routed_level.level"
        _, _, _, seen = profile_checked(device, lambda: [call() for _ in range(20)],
                                        {key: 20}, name, lost_ok=True)
        ms_d, got = seen[key]
        prof = {"device_ms": ms_d if got else with_ms - restore_ms, "profiled_launches": got,
                **({} if got else {"device_ms_by": "cuda_events"})}
    n_e = int(g._dev_edge_count.sum())
    src, dst = edges
    rows = np.flatnonzero(np.unpackbits(cap["front"][: g.n_words].cpu().numpy().view(np.uint8),
                                        bitorder="little"))
    front = np.zeros(g.n_nodes, bool)
    front[g.inv_perm[rows]] = True
    on = front[src]
    if spec:  # a remote source never fires in the local level
        on &= g.perm[src] // g.n_local == g.perm[dst] // g.n_local
    active = int(on.sum())
    lit_words = int((state[0][3][: g.n_words] != 0).sum())
    source_words = 4 * g.n_words if spec else \
        4 * x.numel() + (4 * cross.numel() if cross is not None else 0)
    n_bytes = ROUTED_ROUTING_BYTES[form] * n_e + source_words + 12 * active \
        + 4 * g.n_words + (12 if len(state[0]) > 5 else 8) * lit_words
    b_ms, b_by = bound_ms(n_bytes, 4 * n_e + 3 * active)
    return {"name": name, "route": "cuda", "source": SRC_ROUTED, "replaces": REP_ROUTED,
            "launches": None, "max_abs_err": err, "ms": with_ms - restore_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "form": form, "main_path": main_path, "ms_with_restore": with_ms,
            "restore_ms": restore_ms, "newly": newly, "level": cap["level"],
            "active_edges": active, "lit_words": lit_words, "bytes": n_bytes,
            "shape": shape, **prof}


def routed_seed_row(device, g, seed_sets, inv_after_0, name: str, shape: str) -> dict:
    """``phase_kernels``' row of ``routed_seed`` on ``g``: wave 0's seed
    words over a clear state (the main path's first step, timed) and wave
    1's over the state wave 0 left (seeds already invalid conduct but do
    not count), each against its plain version (exact). The bound: the
    seed words read once and the invalid word under each nonzero seed word
    read and written."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import routed_wave as rw

    w = g._wave
    cases = []
    for ids, inv0 in ((seed_sets[0], torch.zeros_like(inv_after_0)),
                      (seed_sets[1], inv_after_0)):
        seeds = g._words_of_rows(g.perm[np.asarray(ids, np.int64)])
        pair = []
        for fn in (rw.routed_seed, rw.routed_seed_plain):
            inv = inv0.clone()
            out = torch.zeros(rw.slot_width(g.n_dev), dtype=torch.int64, device=device)

            def restore(inv=inv, out=out, inv0=inv0):
                inv.copy_(inv0)
                out.zero_()

            def call(fn=fn, inv=inv, out=out, seeds=seeds, restore=restore):
                restore()
                fn(seeds, inv, out, w.n_dev, w.w_local)
            call()
            pair.append((call, restore, inv, out))
        cases.append((seeds, pair))
    err = max(int((a.long() - b.long()).abs().max())
              for _, (k, p) in cases for a, b in zip(k[2:], p[2:]))
    if err:
        raise AssertionError(f"{name} differs from its plain version")
    fresh = [int(k[3][g.n_dev]) for _, (k, _p) in cases]
    want = []  # the distinct seed rows whose invalid bit was clear
    for ids, inv0 in ((seed_sets[0], None), (seed_sets[1], inv_after_0)):
        rows = torch.from_numpy(np.unique(g.perm[np.asarray(ids, np.int64)])).to(device)
        old = 0 if inv0 is None else int(((inv0[rows >> 5] >> (rows & 31)) & 1).sum())
        want.append(rows.numel() - old)
    if fresh != want:
        raise AssertionError(f"{name}: fresh counts {fresh}, the seed rows' {want}")
    seeds, ((call, restore, _inv, _out), (plain, *_)) = cases[0]
    with_ms, restore_ms = time_ms(call, device), time_ms(restore, device)
    plain_ms = time_ms(plain, device, reps=3)
    prof = {}
    if device.type == "cuda":
        _, _, _, seen = profile_checked(device, lambda: [call() for _ in range(20)],
                                        {"routed_level.seed": 20}, name, lost_ok=True)
        ms_d, got = seen["routed_level.seed"]
        prof = {"device_ms": ms_d if got else with_ms - restore_ms, "profiled_launches": got,
                **({} if got else {"device_ms_by": "cuda_events"})}
    n_words = w.n_dev * w.w_local
    nz = int((seeds[:n_words] != 0).sum())
    b_ms, b_by = bound_ms(4 * n_words + 8 * nz, 3 * nz)
    return {"name": name, "route": "cuda", "source": SRC_ROUTED, "replaces": REP_ROUTED,
            "launches": None, "max_abs_err": err, "ms": with_ms - restore_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "form": "routed_level.seed", "main_path": True, "ms_with_restore": with_ms,
            "restore_ms": restore_ms, "fresh": fresh, "seed_words": nz, "shape": shape, **prof}


def phase_mesh_80m(device, card: str, level: dict, kernel_rows: dict,
                   static_kw: Optional[dict] = None) -> dict:
    """``mesh_80m``: the routed mesh wave (``parallel/routed_wave.py``, the
    ``routed_level`` kernel) through the twin of ``perf/mesh_path.py``
    (``stl_fusion_tpu_torch/mesh_path.py``). 1. The static leg at the
    twin's defaults: ``power_law_dag(80M)``, 4 members, 256 shards on 8
    logical shards, ``a2a``, an untimed wave, then 2 waves of 100,000 seeds,
    wave 0's mask equal to ``numpy_bfs_mask``; one wave profiled; the
    ``routed_level`` row at the widest level of wave 0 (into
    ``kernel_rows``, its launches rolled back). 2. ``gather``, ``tree`` and
    ``hier`` (2 hosts of 4) on ``power_law_10m``'s graph and epochs, each
    union wave of its 100,000 seeds equal to that phase's dense union, all
    three with the same levels. 3. The async A/B at its defaults. Every
    graph is freed before the phase returns."""
    import gc

    import numpy as np
    import torch

    from stl_fusion_tpu_torch.cluster import DevicePlacement, ShardMap
    from stl_fusion_tpu_torch.mesh_path import STATIC, port_api, run_async_ab, run_static
    from stl_fusion_tpu_torch.parallel import RoutedShardedGraph, graph_mesh

    def fail(what):
        raise AssertionError(f"mesh_80m: {what}")

    api = port_api(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    violations = []
    rec = {"phase": "mesh_80m", "card": card}
    static = run_static(api, n_dev=MESH_SHARDS, violations=violations, keep_graph=True,
                        **dict(STATIC, **(static_kw or {})))
    if violations:
        fail(violations)
    g, seed_sets, (src, _dst) = static.pop("graph"), static.pop("seed_sets"), static.pop("edges")
    n, levels = static["nodes"], static["wave_levels"]
    rec["static"] = {k: v for k, v in static.items() if k != "stats"}
    rec["static"]["routed"] = static["stats"]
    rec["level_ms"] = [1e3 * s / lv for s, lv in zip(static["wave_s"], levels)]
    # one wave profiled (wave 0 again from a clear state)
    g.clear_invalid()
    saved = _launch_state()
    try:
        if cuda:  # (a CPU rehearsal has no kernels to profile)
            # each attempt from a clear state; a trace that lost every record
            # of a form leaves the wave's device time and idle share not
            # measured (None), never a sum short of that form
            wall_ms, by_name, calls, seen = profile_checked(
                device, lambda: g.run_wave_collect(seed_sets[0].tolist()),
                {"routed_level.level": levels[0], "routed_level.seed": 1}, "mesh_80m wave",
                lost_ok=True, attempts=5, reset=g.clear_invalid)
            lost = sorted(f for f, (_, c) in seen.items() if c == 0)
            device_ms = None if lost else sum(v["ms"] for v in by_name.values())
            rec["profile"] = {"wall_ms": wall_ms, "device_ms": device_ms,
                              "idle_share": None if lost else 1 - device_ms / wall_ms,
                              "lost_forms": lost, "device_calls": calls,
                              "kernel_launches": {f: c for f, (_, c) in seen.items()},
                              "by_kernel": dict(sorted(by_name.items(),
                                                       key=lambda kv: -kv[1]["ms"])[:8])}
        else:
            g.run_wave_collect(seed_sets[0].tolist())
        # the wave's bound from this run's edge counts: every level reads each
        # live edge's routing, the exchanged words and the invalid words once;
        # each invalidated row's out-edges fire once (edge and epoch, the
        # destination's epoch) and each word the wave lit is written once in
        # invalid and in next
        mask = g.invalid_mask()
        inv_after_0 = g.g_invalid.clone()
        fired = int(mask[src].sum())
        n_e = int(g._dev_edge_count.sum())
        x_words = g._wave.exchange(g._words_of_rows(np.empty(0, np.int64)))[0].numel()
        per_level = 12 * n_e + 4 * x_words + 4 * g.n_words
        lit_words = int((inv_after_0[: g.n_words] != 0).sum())
        wave_bytes = levels[0] * per_level + 12 * fired + 8 * lit_words
        b_ms, b_by = bound_ms(wave_bytes, levels[0] * 4 * n_e + 3 * fired)
        rec["bound"] = {"wave_bound_ms": b_ms, "bound_by": b_by,
                        "level_bound_ms": bound_ms(per_level, 4 * n_e)[0],
                        "live_edges": n_e, "exchanged_words": x_words, "fired_edges": fired,
                        "lit_words": lit_words, "wave_ms": static["wave_s"][0] * 1e3}
        g.clear_invalid()
        cap = routed_capture(g, seed_sets[0], widest)
        kernel_rows["routed_level"] = routed_level_row(
            device, g, cap, (src, _dst), "routed_level", "routed_level.a2a",
            f"a2a, {MESH_SHARDS} shards of {g.n_local} rows, {n_e} live edges, "
            f"icap {g.bucket_cap}", True)
        del cap
        kernel_rows["routed_level (seed)"] = routed_seed_row(
            device, g, seed_sets, inv_after_0, "routed_level (seed)",
            f"{MESH_SHARDS} shards x int32[{g.n_local // 32}], wave 0's and wave 1's seeds")
        del inv_after_0
    finally:
        _restore_launches(saved)
    rec["routed_level"] = {k: v for k, v in kernel_rows["routed_level"].items()
                           if k not in ("name", "source", "replaces")}
    rec["routed_seed"] = {k: v for k, v in kernel_rows["routed_level (seed)"].items()
                          if k not in ("name", "source", "replaces")}
    del g, src, _dst, mask
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec["static_phase_s"] = time.perf_counter() - t_phase
    emit({**rec, "phase": "mesh_80m_static"})

    # the other three exchanges on power_law_10m's graph and union seeds
    t0 = time.perf_counter()
    src10, dst10, n10 = level["src"], level["dst"], level["n"]
    want_ids, want_count, _depth = level["want_union"]
    smap = ShardMap.initial([f"m{i}" for i in range(STATIC["members"])],
                            n_shards=STATIC["shards"])
    mesh = graph_mesh(devices=[device] * MESH_SHARDS)
    modes = {}
    for exchange, dph in (("gather", None), ("tree", None), ("hier", MESH_HIER_DPH)):
        pl = DevicePlacement.build(smap, MESH_SHARDS, n10, devices_per_host=dph)
        tb = time.perf_counter()
        rg = RoutedShardedGraph(src10, dst10, n10, pl, mesh=mesh, exchange=exchange,
                                edge_dst_epoch=np.zeros(len(dst10), np.int32),
                                node_epoch=level["node_epoch"])
        build_s = time.perf_counter() - tb
        if rg.exchange != exchange:
            fail(f"{exchange} resolved as {rg.exchange}")
        runs = []
        for _ in range(2):  # the first pays one-time lazy loading
            rg.clear_invalid()
            lv0 = rg.levels_total
            sync(device)
            tw = time.perf_counter()
            count, _ids, _over = rg.run_wave_collect(level["seeds"].tolist())
            sync(device)
            runs.append(((time.perf_counter() - tw) * 1e3, rg.levels_total - lv0, count))
        mask = rg.invalid_mask()
        if count != want_count or not np.array_equal(np.nonzero(mask)[0], want_ids):
            fail(f"{exchange}: the union wave differs from the dense union")
        modes[exchange] = {"build_s": build_s, "wave_ms": [r[0] for r in runs],
                           "levels": runs[-1][1], "newly": count,
                           "cross_words_per_level": rg.cross_words_per_level,
                           "cross_host_words": rg.cross_host_words, "hosts": rg.n_hosts,
                           "bucket_cap": rg.bucket_cap, "hbucket_cap": rg.hbucket_cap}
        if exchange in ("gather", "hier"):  # tree's lookup is gather's
            saved = _launch_state()
            try:
                cap = routed_capture(rg, level["seeds"], widest)
                name = f"routed_level ({exchange} lookup)"
                kernel_rows[name] = routed_level_row(
                    device, rg, cap, (src10, dst10), name, f"routed_level.{exchange}",
                    f"{exchange}, {MESH_SHARDS} shards of {rg.n_local} rows"
                    + (f", {rg.n_hosts} hosts of {MESH_HIER_DPH}" if dph else "")
                    + f", icap {rg.bucket_cap}, hcap {rg.hbucket_cap}", True)
                del cap
            finally:
                _restore_launches(saved)
            modes[exchange]["routed_level"] = {
                k: v for k, v in kernel_rows[name].items()
                if k not in ("name", "source", "replaces")}
        del rg, mask
        gc.collect()
    if len({m["levels"] for m in modes.values()}) != 1:
        fail(f"the exchanges ran different levels: {modes}")
    rec["exchanges_10m"] = modes
    rec["exchanges_s"] = time.perf_counter() - t0
    emit({"phase": "mesh_80m_exchanges", "card": card, "modes": modes})

    # the async A/B at its defaults
    t0 = time.perf_counter()
    ab = run_async_ab(api, n_dev=MESH_SHARDS, violations=violations, keep_graph=True)
    if violations:
        fail(violations)
    if not ab["async_merge_epochs"] < ab["sync_levels"]:
        fail(f"async merges {ab['async_merge_epochs']} not fewer than sync levels")
    ga, ab_seeds, ab_edges = ab.pop("graph"), ab.pop("seed_sets"), ab.pop("edges")
    saved = _launch_state()
    try:  # the async A/B's widest speculative level, on wave 0 as run
        ga.run_wave_collect(ab_seeds[0])
        cap = routed_capture(ga, ab_seeds[0], lambda t, m, sp: widest(t, m, sp, "spec"))
        kernel_rows["routed_level (spec)"] = routed_level_row(
            device, ga, cap, ab_edges, "routed_level (spec)", "routed_level.spec",
            f"spec (async depth {ga.async_depth}), {MESH_SHARDS} shards of {ga.n_local} "
            f"rows", True)
    finally:
        _restore_launches(saved)
    ab["routed_level_spec"] = {k: v for k, v in kernel_rows["routed_level (spec)"].items()
                               if k not in ("name", "source", "replaces")}
    del ga, cap, ab_edges
    rec["async_ab"] = ab
    rec["async_ab_s"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.empty_cache()
    import resource

    rec.update(phase_s=time.perf_counter() - t_phase,
               max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None,
               host_max_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    emit(rec)
    return rec


def phase_mesh_live(device, card: str, live: dict) -> dict:
    """``mesh_live_10m``: the live routed pipeline on the 10M live stack
    (after ``resilience_10m``): ``enable_mesh_routing`` of a 2-member,
    64-shard map on 8 logical shards of the card with ``a2a``, then
    ``mesh_path.py::run_live`` on that stack: the external RPC client
    subscribed through ``set_mesh_scope``, 3 rounds of 4 groups through
    ``WavePipeline(fuse_depth=4)``, the chain-difference latency on shallow
    tail rows, the kill reshard (``with_members(["m0"])`` →
    ``apply_mesh_reshard``, shards must move), 3 groups after it; then one
    routed super-round of 3 rounds in one dispatch and a
    ``save_mesh_shards`` / ``restore_mesh_shards`` round trip whose
    ``export_shard_state`` must be equal. Every wave's count equals the
    vectorized host BFS over the live edges; the script's gates hold."""
    import os
    import tempfile

    import numpy as np
    import torch

    from stl_fusion_tpu_torch import checkpoint as ckpt
    from stl_fusion_tpu_torch.mesh_path import port_api, run_live

    def fail(what):
        raise AssertionError(f"mesh_live_10m: {what}")

    ctx = dict(live["ctx"], read="node")
    backend, block = ctx["backend"], ctx["block"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    backend._drain_nonblocking()
    backend.flush()
    backend.refresh_block_on_device(block)
    backend.flush()
    extra = {}

    def after_reshard(ctx2, _pipe):
        oracle, rng = ctx2["mesh_oracle"], np.random.default_rng(29)
        sr = backend.super_rounds
        if sr is not None and not sr._disposed:
            sr.dispose()
        prog = backend.enable_super_rounds(block, depth=3)
        n = ctx2["n"]
        bursts = [[rng.choice(n, size=3, replace=False).tolist() for _ in range(2)]
                  for _ in range(3)]
        t0 = time.perf_counter()
        ticket = prog.dispatch(prog.stage(bursts))
        prog.drain()
        sync(device)
        sr_ms = (time.perf_counter() - t0) * 1e3
        got = [int(c.sum()) for c in ticket.per_burst]
        want = [oracle.wave(sorted({block.base + x for grp in groups for x in grp}))
                for groups in bursts]
        if got != want:
            fail(f"routed super-round counts {got} != host BFS {want}")
        if ticket.routed_pending is None or ticket.routed_pending["dispatches"] != 1:
            fail("the super-round did not ride one routed chain dispatch")
        if prog.eager_rounds or prog.faults:
            fail(f"routed super-round fell back: {prog.stats()}")
        stats = prog.stats()
        prog.dispose()
        oracle.inv = np.asarray(backend.graph.invalid_mask()[: oracle.n], bool).copy()
        rg = backend._routed_mirror["graph"]
        before = rg.export_shard_state()
        with tempfile.TemporaryDirectory(prefix="fusion-mesh-") as td:
            path = os.path.join(td, "mesh.npz")
            t1 = time.perf_counter()
            n_saved = ckpt.save_mesh_shards(rg, path)
            save_s = time.perf_counter() - t1
            n_bytes = os.path.getsize(path)
            rg.clear_invalid()
            t1 = time.perf_counter()
            got_r = ckpt.restore_mesh_shards(rg, path)
            restore_s = time.perf_counter() - t1
        after = rg.export_shard_state()
        same = (before.keys() == after.keys() and before["shards"].keys() == after["shards"].keys()
                and all(np.array_equal(a, b) for s in before["shards"]
                        for a, b in zip(before["shards"][s], after["shards"][s])))
        if not same or got_r["restored"] != n_saved:
            fail("the mesh shard snapshot did not round-trip")
        extra.update(superround={"counts": got, "ms": sr_ms, "stats": stats},
                     mesh_snapshot={"shards": n_saved, "bytes": n_bytes, "save_s": save_s,
                                    "restore_s": restore_s,
                                    "invalid_rows": int(sum(v[1].sum() for v in
                                                            before["shards"].values()))})

    violations = []
    out = asyncio.run(run_live(port_api(device), ctx=ctx, members=2, shards=64, exchange="a2a",
                               n_dev=MESH_SHARDS, violations=violations,
                               after_reshard=after_reshard))
    if violations:
        fail(violations)
    rec = {"phase": "mesh_live_10m", "card": card, **out, **extra,
           "phase_s": time.perf_counter() - t_phase,
           "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else None}
    emit(rec)
    return rec


def sweep_bytes(graph, words: int, start_level: int, seeded: bool, levels=None) -> int:
    """Bytes a sweep (or the ``levels`` range of one) must move: each
    gathered row's in_src and edge_epoch rows and epoch, each row's
    is_real, words read and written (and seed words), and each live
    in-slot's gathered row of W words."""
    starts = graph.level_starts
    lo, hi = (start_level, len(starts) - 1) if levels is None else levels
    a, b = starts[lo], starts[hi]
    k = graph.in_src.shape[1]
    live = int((graph.in_src[a:b] != graph.n_tot).sum())
    rows = graph.n_tot + 1 if levels is None else b - a
    return (b - a) * (8 * k + 4) + rows * ((12 if seeded else 8) * words + 1) + live * 4 * words


def profile_device(device, fn) -> tuple:
    """``fn()`` under ``torch.profiler``: (wall ms, device time by kernel
    name as {name: {"ms", "calls"}}, device calls: kernels, copies and
    fills)."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync(device)
        wall_ms = (time.perf_counter() - t) * 1e3
    return (wall_ms, *device_times(prof))


def device_times(prof) -> tuple:
    """A finished ``torch.profiler`` session's device time by kernel name,
    {name: {"ms", "calls"}}, and its device calls."""
    by_name, calls = {}, 0
    for ev in prof.key_averages():
        if ev.key.startswith("aten::"):
            continue  # a CPU op's device time is its kernels', listed on their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rec = by_name.setdefault(ev.key[:80], {"ms": 0.0, "calls": 0})
            rec["ms"] += dev_us / 1e3
            rec["calls"] += ev.count
            calls += ev.count
    return by_name, calls


def kernel_calls(by_name: dict, symbol: str) -> tuple:
    """(device ms, calls) of the kernels whose name holds ``symbol``
    (spaces ignored: ``wave_expand_kernel<true,true>``)."""
    hits = [v for name, v in by_name.items() if symbol in name.replace(" ", "")]
    return sum(v["ms"] for v in hits), sum(v["calls"] for v in hits)


def profile_checked(device, fn, want: dict, what: str, lost_ok: bool = False,
                    attempts: int = 3, reset=None) -> tuple:
    """``profile_device(fn)`` that must show some launches of each kernel
    form and at most ``want[form]``, the launches the wrappers counted: the
    trace drops some kernel records late in a long process (seen on the
    card: 80-81 of a sweep's 85 launches, 5 of 20 ``or_popcount``
    launches, all 20 of one form twice in a row; quiet host time around
    the profiled calls did not help). A profile that shows
    no launch of a form the wrappers launched is made again, up to
    ``attempts`` times in all (``reset()`` before each new attempt, outside
    the profile, puts back the state ``fn`` starts from), and said so;
    after that it raises, unless ``lost_ok``, when the form's entry in the
    result shows 0 launches. More launches than the wrappers counted always
    raise. Returns (wall ms, by_name, device calls, {form: (device ms per
    launch over the launches shown, launches shown)})."""
    for attempt in range(1, attempts + 1):
        if attempt > 1 and reset is not None:
            reset()
        wall_ms, by_name, calls = profile_device(device, fn)
        seen, over, lost = {}, [], []
        for form, n in want.items():
            ms, got = kernel_calls(by_name, SYMBOLS[form])
            if got > n:
                over.append(form)
            elif got == 0 < n:
                lost.append(form)
            seen[form] = (ms / got if got else 0.0, got)
        bad = [f"{what}: the profile shows {seen[f][1]} launches of {f}, the wrappers made "
               f"{want[f]}" for f in over + lost]
        if over:
            raise AssertionError("; ".join(bad))
        if not lost:
            return wall_ms, by_name, calls, seen
        emit({"phase": "profile_retry" if attempt < attempts else "profile_lost",
              "what": what, "attempt": attempt, "reason": bad})
        if attempt == attempts and not lost_ok:
            raise AssertionError("; ".join(bad))
    return wall_ms, by_name, calls, seen


#: each kernel form's symbol in the profiler's kernel names
SYMBOLS = {
    "or_popcount": "or_popcount_kernel",
    "or_popcount.merge": "or_popcount_kernel<0>",
    "or_popcount.gate": "or_popcount_kernel<1>",
    "or_popcount.delta": "or_popcount_kernel<2>",
    "or_popcount.shards": "or_popcount_kernel<3>",
    "wave_expand": "wave_expand_kernel<false,false>",
    "wave_expand_merge": "wave_expand_kernel<true,false>",
    "wave_expand_shards": "wave_expand_kernel<true,true>",
    "ring_all_gather": "ring_gather_kernel",
    "topo_sweep": "topo_sweep_kernel",
    "lane_finish": "lane_finish_kernel",
    "block_refresh": "block_refresh_kernel",
    "packed_pull": "packed_pull_kernel",
    "routed_level": "routed_",
    "routed_level.level": "routed_level_kernel<false>",
    "routed_level.spec": "routed_level_kernel<true>",
    "routed_level.seed": "routed_seed_kernel",
}


def phase_profile(device, wave: str, run, reset, levels: int, exchange=None) -> dict:
    """Where one 10M-node wave's time goes: ``torch.profiler`` over the same
    wave as the main path's, from a cleared state after a warm-up; device
    time by kernel, the device calls per wave and the device's idle share.
    ``levels`` is the wave's wave_expand calls (productive levels + 1): the
    profile may show no more launches of the level's kernel (and of the
    ring kernel on a ring wave), and shows how many it caught."""
    reset()
    run()  # warm-up
    reset()
    form = "wave_expand_merge" if exchange is None else "wave_expand_shards"
    want = {form: levels, **({"ring_all_gather": levels} if exchange == "ring" else {})}
    wall_ms, by_name, calls, seen = profile_checked(device, run, want, wave)
    seen = {f: n for f, (_, n) in seen.items()}
    device_ms = sum(v["ms"] for v in by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:12])
    out = {"phase": "profile", "wave": wave, "wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": 1 - device_ms / wall_ms, "device_calls": calls,
           "kernel_launches": seen, "by_kernel": top}
    emit(out)
    return out


def lane_kernel_rows(device, level, churn, rng, row, check, restored, timed_pair, src_topo,
                     rep_topo) -> None:
    """``phase_kernels``' rows of the lane burst: ``topo_sweep`` at its shape
    (the changed flag held against a plain before/after comparison too) and
    ``lane_finish``, each against its plain version, exact."""
    # the churned 10M mirror (W = 16, k = 6): churn_10m's last groups from a
    # cleared state through the lane gate, then the sweep (one pass: the
    # re-level left none violated) and lane_finish
    from types import SimpleNamespace

    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import topo_wave as tpw
    from stl_fusion_tpu_torch.ops.bitops import pack_bits
    from stl_fusion_tpu_torch.ops.pull_wave import pack_lane_matrix

    g = level["graph"]
    m = g._topo_mirror
    mga, n_tot, lstarts = m["garrays"], m["n_tot"], m["level_starts"]
    g.clear_invalid()
    mat, lw = pack_lane_matrix([x.tolist() for x in churn["groups"]], pad_id=n_tot,
                               n_valid=m["n_nodes"], id_map=m["inv_perm"])
    g_inv = g.device_arrays().invalid
    node_epoch, lseeds = tpw.topo_mirror_gate_lanes_step(n_tot, lw)(
        mga.is_real, m["node_epoch0"], m["perm_clipped"], g_inv, torch.from_numpy(mat).to(device))
    lzero = torch.zeros_like(lseeds)
    lst = tpw.TopoState(node_epoch, torch.zeros_like(lseeds))
    plain_lst = tpw.TopoState(node_epoch, torch.zeros_like(lseeds))
    call, restore = restored([(lst.invalid_bits, lzero)],
                             lambda: tpw.topo_sweep(lstarts, mga, lseeds, lst, 0))
    plain_call, _ = restored([(plain_lst.invalid_bits, lzero)],
                             lambda: tpw.topo_sweep_plain(lstarts, mga, lseeds, plain_lst, 0))
    got, want = call()[1], plain_call()[1]
    e = check("topo_sweep (lane burst)", [got], [want])
    if not torch.equal(lst.invalid_bits, plain_lst.invalid_bits):
        raise AssertionError("topo_sweep (lane burst): bits differ from its plain version")
    # the changed flag against a plain before/after comparison: a pass over
    # the swept state (no row changes), then one after the widest level's
    # rows were cleared (they light again)
    wl = max(range(1, len(lstarts) - 1), key=lambda lv: lstarts[lv + 1] - lstarts[lv])
    flags = {}
    for case in ("swept", "level cleared"):
        if case == "level cleared":
            lst.invalid_bits[lstarts[wl]:lstarts[wl + 1]] = 0
        before_bits = lst.invalid_bits.clone()
        plain_st = tpw.TopoState(node_epoch, before_bits.clone())
        flag, plain_flag = (torch.zeros(1, dtype=torch.int32, device=device) for _ in range(2))
        tpw.topo_sweep(lstarts, mga, None, lst, 0, changed=flag)
        tpw.topo_sweep_plain(lstarts, mga, None, plain_st, 0, changed=plain_flag)
        want_flag = int(bool((lst.invalid_bits != before_bits).any()))
        if not (int(flag) == int(plain_flag) == want_flag == (case != "swept")
                and torch.equal(lst.invalid_bits, plain_st.invalid_bits)):
            raise AssertionError(f"topo_sweep changed flag ({case}): kernel {int(flag)}, plain "
                                 f"{int(plain_flag)}, before/after {want_flag}")
        flags[case] = int(flag)
    del plain_st, before_bits
    ms, plain_ms, with_ms, restore_ms = timed_pair(call, restore, plain_call, plain_reps=3)
    mview = SimpleNamespace(level_starts=lstarts, in_src=m["h_in_src"], n_tot=n_tot)
    row("topo_sweep (lane burst)", "topo_sweep", src_topo, rep_topo, e, ms, plain_ms,
        sweep_bytes(mview, lw, 0, True), 0, None, call=call, per_call=_nonempty_levels(lstarts),
        shape=(f"{n_tot + 1} rows x int32[{lw}], k={m['h_in_src'].shape[1]}, "
               f"{len(lstarts) - 1} levels, {len(churn['groups'])} lanes of churn_10m"),
        ms_with_restore=with_ms, restore_ms=restore_ms, newly=int(got.long().sum()),
        changed_flag=flags)
    del plain_lst

    # lane_finish on that swept state: against its plain version from the
    # main path's cleared dense state and from one with 1/8 of nodes invalid
    call()
    final, is_real, perm = lst.invalid_bits, mga.is_real, m["perm_clipped"]
    zero_w = torch.zeros_like(g_inv)
    some_w = pack_bits(torch.from_numpy(rng.random(32 * g_inv.shape[0]) < 0.125).to(device))
    e, unions = 0, {}
    for name, w0 in (("cleared", zero_w), ("1/8 invalid", some_w)):
        gk, gp = w0.clone(), w0.clone()
        before = tpw.lane_finish_launches
        got = tpw.lane_finish(final, is_real, perm, gk)
        per_call = tpw.lane_finish_launches - before
        want = tpw.lane_finish_plain(final, is_real, perm, gp)
        e = max(e, check(f"lane_finish ({name})", [got[0], got[1], got[2], gk],
                         [want[0], want[1], want[2], gp]))
        unions[name] = int(got[1])
        if per_call != 1:
            raise AssertionError(f"lane_finish: {per_call} launches for one call at W = {lw}")
    gk, gp = zero_w.clone(), zero_w.clone()
    call, restore = restored([(gk, zero_w)], lambda: tpw.lane_finish(final, is_real, perm, gk))
    plain_call, _ = restored([(gp, zero_w)],
                             lambda: tpw.lane_finish_plain(final, is_real, perm, gp))
    ms, plain_ms, with_ms, restore_ms = timed_pair(call, restore, plain_call, plain_reps=3)
    rows_n, real_n = n_tot + 1, int(is_real.sum())
    row("lane_finish", "lane_finish", "stl_fusion_tpu_torch/csrc/lane_finish.cu",
        "stl_fusion_tpu/ops/topo_wave.py:768 (XLA topo_mirror_finish_lanes_step and "
        "_lane_counts_blocked :446; no Pallas kernel)", e, ms, plain_ms,
        rows_n * (4 * lw + 1 + 4) + real_n * 4 + unions["cleared"] * 8 + g_inv.shape[0] * 4,
        rows_n * 32 * lw, None, call=call,
        shape=(f"{rows_n} rows x int32[{lw}] ({real_n} real), {g_inv.shape[0]} dense words, "
               f"{unions['cleared']} union rows"),
        ms_with_restore=with_ms, restore_ms=restore_ms, union_rows=unions,
        launches_per_call=per_call)

    # lane_finish at W = 64 (2,048 lanes: the bits of that burst four times
    # over), the column-chunked form: 2 chunk launches and 1 commit a call
    final64 = final.repeat(1, 4)
    gk, gp = some_w.clone(), some_w.clone()
    before = tpw.lane_finish_launches
    got = tpw.lane_finish(final64, is_real, perm, gk)
    per_call = tpw.lane_finish_launches - before
    want = tpw.lane_finish_plain(final64, is_real, perm, gp)
    e = check("lane_finish (W=64)", [got[0], got[1], got[2], gk], [want[0], want[1], want[2], gp])
    unions64 = int(got[1])
    gk, gp = zero_w.clone(), zero_w.clone()
    call, restore = restored([(gk, zero_w)], lambda: tpw.lane_finish(final64, is_real, perm, gk))
    plain_call, _ = restored([(gp, zero_w)],
                             lambda: tpw.lane_finish_plain(final64, is_real, perm, gp))
    ms, plain_ms, with_ms, restore_ms = timed_pair(call, restore, plain_call, plain_reps=2)
    row("lane_finish (W=64)", "lane_finish", "stl_fusion_tpu_torch/csrc/lane_finish.cu",
        "stl_fusion_tpu/ops/topo_wave.py:768 (XLA topo_mirror_finish_lanes_step and "
        "_lane_counts_blocked :446; no Pallas kernel)", e, ms, plain_ms,
        rows_n * (4 * 64 + 1 + 4) + real_n * 4 + unions["cleared"] * 8 + g_inv.shape[0] * 4,
        rows_n * 32 * 64, None, call=call, per_call=per_call, main_path=False,
        shape=(f"{rows_n} rows x int32[64] ({real_n} real), {g_inv.shape[0]} dense words; "
               f"2 column chunks of 32 words + the commit"),
        ms_with_restore=with_ms, restore_ms=restore_ms, union_rows_1_8_invalid=unions64,
        launches_per_call=per_call)



def block_refresh_rows(device, live, rng, row, check, restored, timed_pair) -> None:
    """``phase_kernels``' rows of ``block_refresh``: the live path's shape
    (10M float32 rows at the block's base 0, the last burst's union as the
    invalid words, validity left alone as on the main path), held against
    the plain version with and without validity; and a correctness case at
    an unaligned base, int32 rows of 3, with validity."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import block_refresh as brf
    from stl_fusion_tpu_torch.ops.bitops import pack_mask_host

    n, union = live["nodes"], live["last_union"]
    bits = np.zeros(live["n_cap"] + 1, bool)
    bits[:n] = union
    words0 = torch.from_numpy(pack_mask_host(bits)).to(device)
    fresh = torch.arange(n, dtype=torch.float32, device=device)
    values0 = torch.zeros(n, dtype=torch.float32, device=device)
    valid0 = torch.from_numpy(rng.random(n) < 0.5).to(device)
    e = 0
    for with_valid in (False, True):
        w, v, ok = words0.clone(), values0.clone(), valid0.clone()
        pw, pv, pok = words0.clone(), values0.clone(), valid0.clone()
        brf.block_refresh(w, v, fresh, ok if with_valid else None, 0)
        brf.block_refresh_plain(pw, pv, fresh, pok if with_valid else None, 0)
        e = max(e, check(f"block_refresh (valid={with_valid})", [w, v, ok], [pw, pv, pok]))
    # unaligned: base 37, int32 rows of 3, random words, validity updated
    n_u, base_u = 1_000_003, 37
    wu = torch.from_numpy(pack_mask_host(rng.random(base_u + n_u + 64) < 0.4)).to(device)
    vu = torch.from_numpy(rng.integers(-9, 9, (n_u, 3), dtype=np.int32)).to(device)
    fu = torch.from_numpy(rng.integers(10, 99, (n_u, 3), dtype=np.int32)).to(device)
    oku = torch.from_numpy(rng.random(n_u) < 0.5).to(device)
    got = [wu.clone(), vu.clone(), oku.clone()]
    want = [wu.clone(), vu.clone(), oku.clone()]
    brf.block_refresh(got[0], got[1], fu, got[2], base_u)
    brf.block_refresh_plain(want[0], want[1], fu, want[2], base_u)
    e_u = check("block_refresh (base 37, int32[3] rows)", got, want)
    w, v = words0.clone(), values0.clone()
    pw, pv = words0.clone(), values0.clone()
    call, restore = restored([(w, words0), (v, values0)],
                             lambda: brf.block_refresh(w, v, fresh, None, 0))
    plain_call, _ = restored([(pw, words0), (pv, values0)],
                             lambda: brf.block_refresh_plain(pw, pv, fresh, None, 0))
    ms, plain_ms, with_ms, restore_ms = timed_pair(call, restore, plain_call, plain_reps=5)
    stale, n_words = int(union.sum()), (n + 31) // 32
    row("block_refresh", "block_refresh", "stl_fusion_tpu_torch/csrc/block_refresh.cu",
        "stl_fusion_tpu/graph/backend.py:1056 (XLA refresh_block_on_device prog; no Pallas "
        "kernel)", max(e, e_u), ms, plain_ms, 8 * n_words + 8 * stale, 0, None, call=call,
        shape=(f"{n} float32 rows at base 0, {stale} stale, {n_words} words, validity left "
               f"alone"), ms_with_restore=with_ms, restore_ms=restore_ms, stale_rows=stale,
        unaligned_case=f"base {base_u}, {n_u} int32[3] rows with validity: exact")


def wide_mirror_rows(device, rng, row, check, restored, timed_pair, src_topo, rep_topo) -> None:
    """``topo_sweep`` at k = 10: ``build_topo_mirror(k=8)`` (8 + 2 slack
    in-slots) on a 1M-node graph, then 7 level-ordered edges patched into
    each of 2,000 rows (their in-degree of at most 3 grows to 10, so the
    slots past the kernel's chunk of 8 are live); a union of n / 10 seeds
    through the patched mirror equals the dense union, and the sweep at
    W = 16 equals its plain version."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from stl_fusion_tpu_torch.graph import DeviceGraph
    from stl_fusion_tpu_torch.graph.synthetic import power_law_dag
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    n = 1_000_000
    src, dst = power_law_dag(n, avg_degree=3, seed=GRAPH_SEED + 2)
    g = DeviceGraph(node_capacity=n, edge_capacity=len(src) + 20_000, device=device)
    g.add_nodes(n)
    g.add_edges(src, dst)
    m = g.build_topo_mirror(k=8)
    ls, inv_perm, n_tot = m["level_starts_arr"], m["inv_perm"], m["n_tot"]
    lvl = np.searchsorted(ls, inv_perm[:n], side="right") - 1
    targets = rng.choice(np.nonzero(lvl >= 2)[0], 2000, replace=False)
    u = np.concatenate([rng.choice(np.nonzero(lvl < lvl[v])[0], 7, replace=False)
                        for v in targets]).astype(np.int32)
    g.add_edges(u, np.repeat(targets, 7).astype(np.int32))
    seeds = rng.choice(n, n // 10, replace=False).tolist()
    c_m, ids_m = g.run_waves_union([seeds])
    if not g._mirror_valid() or g.mirror_patches != 1:
        raise AssertionError("topo_sweep (k=10): the edges were not patched into the mirror")
    g.clear_invalid()
    c_d, ids_d = g.run_waves_union([seeds], mirror="off")
    if c_m != c_d or not np.array_equal(np.sort(ids_m), ids_d):
        raise AssertionError(f"topo_sweep (k=10): the mirror union ({c_m}) differs from the "
                             f"dense union ({c_d})")
    h = m["h_in_src"]
    wide_rows = int((h[:, 8:] != n_tot).any(axis=1).sum())
    if h.shape[1] != 10 or not wide_rows:
        raise AssertionError("topo_sweep (k=10): no row uses the slots past the first 8")
    w = 16
    seed_bits = torch.from_numpy(rng.integers(-(2**31), 2**31, (n_tot + 1, w), dtype=np.int32)
                                 * (rng.random((n_tot + 1, 1)) < 0.01)).to(device)
    seed_bits[n_tot] = 0
    zero = torch.zeros_like(seed_bits)
    st = tpw.TopoState(m["node_epoch0"], zero.clone())
    plain_st = tpw.TopoState(m["node_epoch0"], zero.clone())
    lstarts, mga = m["level_starts"], m["garrays"]
    call, restore = restored([(st.invalid_bits, zero)],
                             lambda: tpw.topo_sweep(lstarts, mga, seed_bits, st, 0))
    plain_call, _ = restored([(plain_st.invalid_bits, zero)],
                             lambda: tpw.topo_sweep_plain(lstarts, mga, seed_bits, plain_st, 0))
    got, want = call()[1], plain_call()[1]
    e = check("topo_sweep (k=10)", [got, st.invalid_bits], [want, plain_st.invalid_bits])
    ms, plain_ms, with_ms, restore_ms = timed_pair(call, restore, plain_call, plain_reps=3)
    mview = SimpleNamespace(level_starts=lstarts, in_src=h, n_tot=n_tot)
    row("topo_sweep (k=10)", "topo_sweep", src_topo, rep_topo, e, ms, plain_ms,
        sweep_bytes(mview, w, 0, True), 0, None, call=call, per_call=_nonempty_levels(lstarts),
        shape=(f"{n_tot + 1} rows x int32[{w}], k=10 ({wide_rows} rows with live slots past "
               f"8), {len(lstarts) - 1} levels"),
        ms_with_restore=with_ms, restore_ms=restore_ms, main_path=False,
        union_check={"seeds": len(seeds), "newly": int(c_m)})


def pull_levels(tables, seeds, node_epoch, invalid, null_row: int = -1, keep=()) -> dict:
    """A packed pull wave stepped one kernel launch at a time from ``seeds``
    over ``invalid`` (updated in place to the wave's end), as
    :func:`~stl_fusion_tpu_torch.ops.packed_pull.run_pull_wave` runs it:
    every launch with the fired summaries. Returns the rows each level lit
    (the popcount of its summary), the levels, and the inputs (frontier,
    invalid before, summary in; cloned) of level 0, of the widest level and
    of each level in ``keep``."""
    import torch

    from stl_fusion_tpu_torch.ops import packed_pull as ppp
    from stl_fusion_tpu_torch.ops.bitops import unpack_bits

    in_src, edge_epoch, is_real = tables
    n = invalid.shape[0]
    counts = torch.zeros(invalid.shape[1], dtype=torch.int32, device=invalid.device)
    frontier, nxt, summary, summary_next = ppp._wave_buffers(invalid)
    ppp.packed_pull(in_src, edge_epoch, node_epoch, is_real, seeds, frontier, invalid, counts,
                    gather=False, summary_out=summary)
    out = {"lit": [], "kept": {}}
    while True:
        level = len(out["lit"])
        inputs = (frontier.clone(), invalid.clone(), summary.clone())
        ppp.packed_pull(in_src, edge_epoch, node_epoch, is_real, frontier, nxt, invalid, counts,
                        null_row=null_row, summary_in=summary, summary_out=summary_next)
        lit = int(unpack_bits(summary_next, n).sum())
        if level == 0:
            out["first"] = inputs
        if lit > max(out["lit"], default=-1):
            out["widest"], out["widest_level"] = inputs, level
        if level in keep:
            out["kept"][level] = inputs
        del inputs
        out["lit"].append(lit)
        if lit == 0:
            return out
        frontier, nxt = nxt, frontier
        summary, summary_next = summary_next, summary


def tail_levels(lit) -> dict:
    """The tail levels of a wave by its rows lit per level: the last level
    that lights anything, and the level whose count is the median of the
    non-empty levels' (the lower median)."""
    nonempty = [lv for lv, n in enumerate(lit) if n]
    by_count = sorted(nonempty, key=lambda lv: (lit[lv], lv))
    return {"median": by_count[(len(by_count) - 1) // 2], "last": nonempty[-1]}


#: the reference code of the in-call A/Bs, fetched there with ``git show``
#: before a card run (the card's copy of the repo has no .git):
#: ``packed_pull.cu``, a512369's kernel (before the fired summary, its own C
#: entry), and ``e0d54c8/``, e0d54c8's ``or_popcount`` (its
#: ``ops/_build.py``, ``ops/or_popcount.py`` and ``csrc/or_popcount.cu`` in
#: the package layout)
REF_DIR = "_smoke_tree/ref"
_references: dict = {}


def load_reference(name: str):
    """The reference ``name`` from :data:`REF_DIR`, built once, or None when
    it is not in the checkout: ``"packed_pull"``, a512369's
    ``packed_pull_launch`` (every row read and written, no summary) built
    with the port's flags; ``"or_popcount"``, e0d54c8's ``or_popcount``
    module (its wrapper and kernel as they were: a ``torch.zeros`` count and
    ``_build.launch`` a call), its kernel built by its own ``_build``."""
    if name in _references:
        return _references[name]
    import ctypes
    import importlib
    import types

    from stl_fusion_tpu_torch.ops import _build

    path = os.path.join(REF_DIR, {"packed_pull": "packed_pull.cu",
                                  "or_popcount": "e0d54c8/ops/or_popcount.py"}[name])
    ref = None
    if os.path.exists(path) and name == "packed_pull":
        out = str(_build.BUILD_DIR / "ref_packed_pull.so")
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}{proc.stderr}")
        ref = ctypes.CDLL(out).packed_pull_launch
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ref.argtypes, ref.restype = [P] * 10 + [LL, I, I, LL, I, I, I, P], ctypes.c_int
        info = _build._ptxas_stats(proc.stdout + proc.stderr)
    elif os.path.exists(path):
        pkg = types.ModuleType("ref_or_popcount_ops")
        pkg.__path__ = [os.path.abspath(os.path.dirname(path))]
        sys.modules[pkg.__name__] = pkg
        ref = importlib.import_module("ref_or_popcount_ops.or_popcount")
        info = ref._build.build_all(["or_popcount"])["or_popcount"]
    if ref is not None:
        emit({"phase": "kernels_reference", "source": path, **info})
    _references[name] = ref
    return ref


def packed_pull_rows(device, packed, live, row, check, restored, timed_pair) -> None:
    """``phase_kernels``' rows of ``packed_pull`` (each one level launch over
    all rows with the fired summaries, as the main path runs it, against
    its plain version from the same inputs, exact: next, invalid, counts,
    the flag and the summary out; garbage in every frontier row whose bit is
    clear): ``packed_10m``'s level 0, widest, median and last levels (W =
    16, k = 8), the last mesh lane burst's level 0, median and last levels
    (k = 8 + 2 slack, gated) and the pull leg's level 0 (W = 1, the null
    row); each also without the summaries (every row read and written,
    exact against its plain version) and, when its source is in the
    checkout, the reference kernel on the same inputs, timed in turns
    (reference, this, this, reference); and ``lane_finish`` at the mesh shape (that burst's final
    bits, the identity form, its pre-burst blocked words)."""
    import torch

    from stl_fusion_tpu_torch.ops import packed_pull as ppp
    from stl_fusion_tpu_torch.ops import topo_wave as tpw
    from stl_fusion_tpu_torch.ops.bitops import unpack_bits
    from stl_fusion_tpu_torch.ops.pull_wave import pack_lane_matrix
    from stl_fusion_tpu_torch.parallel.packed_wave import _gated_inputs

    src_pp = "stl_fusion_tpu_torch/csrc/packed_pull.cu"
    rep_pp = ("stl_fusion_tpu/parallel/packed_wave.py:93 (XLA level body of "
              "build_packed_sharded_wave; no Pallas kernel)")
    rep_pull = ("stl_fusion_tpu/ops/pull_wave.py:159 (XLA level of _pull_wave32_impl; "
                "no Pallas kernel)")
    ref = load_reference("packed_pull")
    stream = torch.cuda.current_stream().cuda_stream if ref is not None else None

    def level_row(name, replaces, tables, node_epoch, inputs, null_row, shape):
        in_src, edge_epoch, is_real = tables
        frontier, inv0, summary = inputs
        rows, w = inv0.shape
        k = in_src.shape[1]
        lit_in = unpack_bits(summary, rows)
        zeroed = torch.where(lit_in[:, None], frontier, 0)  # the frontier as it reads
        fill = torch.full_like(inv0, 0x5A5A5A5A)
        forms = {"kernel": (ppp.packed_pull, True), "plain": (ppp.packed_pull_plain, True),
                 "full": (ppp.packed_pull, False), "full_plain": (ppp.packed_pull_plain, False)}
        state, runs = {}, {}

        def launcher(which):
            inv, nxt, counts, flag, s_out = state[which] = (
                inv0.clone(), fill.clone(), torch.zeros(w, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device), torch.zeros_like(summary))
            if which == "reference":  # every row read and written, no summary
                vec4 = int(w % 4 == 0)

                def run():
                    err = ref(in_src.data_ptr(), edge_epoch.data_ptr(), node_epoch.data_ptr(),
                              is_real.data_ptr(), zeroed.data_ptr(), nxt.data_ptr(),
                              inv.data_ptr(), counts.data_ptr(), None, flag.data_ptr(), rows, k,
                              w, null_row, 1, 0, vec4, stream)
                    if err:
                        raise RuntimeError(f"the reference packed_pull failed with CUDA error {err}")
                return run
            fn, gated = forms[which]
            if gated:
                return lambda: fn(in_src, edge_epoch, node_epoch, is_real, frontier, nxt, inv,
                                  counts, flag_out=flag, null_row=null_row, summary_in=summary,
                                  summary_out=s_out)
            return lambda: fn(in_src, edge_epoch, node_epoch, is_real, zeroed, nxt, inv, counts,
                              flag_out=flag, null_row=null_row)

        for which in (*forms, *(("reference",) if ref is not None else ())):
            runs[which] = launcher(which)
            runs[which]()
        e = check(name, state["kernel"], state["plain"])
        for which in ("full", "reference"):
            if which in state:
                e = max(e, check(f"{name} ({which})", state[which][:4], state["full_plain"][:4]))
        fired = unpack_bits(state["kernel"][4], rows)
        if not torch.equal(state["kernel"][0], state["full"][0]) or not torch.equal(
                torch.where(fired[:, None], state["kernel"][1], 0), state["full"][1]):
            raise AssertionError(f"{name}: the summary's level differs from the full one")
        # each timed call restores only the rows the level changes (those
        # that fire) and the count and flag: a tail level takes ~0.1 ms, and
        # a whole-table restore's spread would swamp it
        idx = torch.nonzero(fired).flatten()
        rows0 = inv0[idx]

        def timed(which):
            inv, _, counts, flag, _ = state[which]

            def restore():
                inv.index_copy_(0, idx, rows0)
                torch._foreach_zero_([counts, flag])

            def call():
                restore()
                runs[which]()
            return call, restore
        calls = {which: timed(which) for which in runs}
        restore_ms = time_ms(calls["kernel"][1], device)
        extra = {}
        if ref is not None:  # in turns, on the same inputs
            order = ("reference", "kernel", "kernel", "reference")
            laps = [time_ms(calls[which][0], device) - restore_ms for which in order]
            extra = {"reference_ms": (laps[0] + laps[3]) / 2, "ab_ms": (laps[1] + laps[2]) / 2,
                     "ab_order": list(order), "ab_laps_ms": laps}
        full_ms = time_ms(calls["full"][0], device) - restore_ms
        ms, plain_ms, with_ms, restore_ms = timed_pair(calls["kernel"][0], calls["kernel"][1],
                                                       calls["plain"][0], plain_reps=3)
        # what these inputs need, each input byte read once: every row's
        # slot ids and both summaries; for each slot whose source fired its
        # epoch, for each row with one its node_epoch; for each row with a
        # live fired slot its invalid words; each frontier row such a slot
        # names; for each row that fires its invalid and next words and
        # is_real
        src = in_src.long()
        hot = lit_in[src.clamp(0, rows - 1)] & (src >= 0) & (src < rows)
        if null_row >= 0:
            hot[null_row] = False
        live = hot & (edge_epoch == node_epoch[:, None])
        fired_slots, hot_rows = int(hot.sum()), int(hot.any(dim=1).sum())
        gathered, cand_rows = int(live.sum()), int(live.any(dim=1).sum())
        named = torch.zeros(rows, dtype=torch.bool, device=device)
        named[src[live]] = True
        sources = int(named.sum())
        del src, hot, live, named
        lit = int(idx.numel())
        need = (rows * 4 * k + 2 * 4 * summary.shape[0] + 4 * fired_slots + 4 * hot_rows
                + cand_rows * 4 * w + sources * 4 * w + lit * (8 * w + 1))
        full_bytes = rows * (8 * k + 5 + 12 * w) + lit * 4 * w
        live_slots = int((edge_epoch == node_epoch[:, None]).sum())
        # device time now: a deferred profile would keep every row's
        # tensors (GBs at 10M rows) alive until the phase's end
        row(name, "packed_pull", src_pp, replaces, e, ms, plain_ms, need,
            rows * k + (gathered + 4 * cand_rows) * w, None,
            **profiled(device, calls["kernel"][0], "packed_pull", name),
            shape=f"{rows} rows x int32[{w}], k={k}; {shape}",
            full_table_bound_ms=bound_ms(full_bytes, (live_slots + 4 * rows) * w)[0],
            full_table_bytes=full_bytes, needed_bytes=need, without_summary_ms=full_ms,
            ms_with_restore=with_ms, restore_ms=restore_ms, lit_rows_in=int(lit_in.sum()),
            lit_rows=lit, fired_slots=fired_slots, gathered_slots=gathered,
            gathered_rows=sources, gathering_rows=cand_rows, live_slots=live_slots,
            newly=int(state["kernel"][2].long().sum()), **extra)

    def wave_rows(names, replaces, tables, node_epoch, seeds, inv, null_row, what):
        """Rows of the wave from ``seeds`` over ``inv`` (left at the wave's
        end): ``names`` maps "first", "widest", "median" and "last" to row
        names. The wave is stepped twice when a tail level is asked for:
        once to find it, then keeping its inputs."""
        keep = {}
        if "median" in names or "last" in names:
            found = pull_levels(tables, seeds, node_epoch, inv.clone(), null_row)
            keep = tail_levels(found["lit"])
            del found
        lv = pull_levels(tables, seeds, node_epoch, inv, null_row, keep=set(keep.values()))
        where = {"first": 0, "widest": lv["widest_level"], **keep}
        for which, name in names.items():
            level = where[which]
            inputs = lv["kept"].get(level) if which in keep else lv[which]
            level_row(name, replaces, tables, node_epoch, inputs, null_row,
                      f"level {level} of {len(lv['lit'])} of {what} "
                      f"({lv['lit'][level]} rows lit)")

    # packed_10m: its batch's wave stepped level by level
    pg, leg = packed["leg"]["graph"], packed["leg"]
    tables = (pg.in_src, pg.edge_epoch, pg.is_real)
    wave_rows({"first": "packed_pull", "widest": "packed_pull (widest level)",
               "median": "packed_pull (median level)", "last": "packed_pull (last level)"},
              rep_pp, tables, pg.node_epoch, leg["seeds_dev"][0], torch.zeros_like(pg.invalid),
              -1, "packed_10m's 512 waves")

    # the last mesh lane burst (k = 10) from its pre-burst blocked words
    last = live["mesh_last"]
    mpg, blocked = last["pg"], last["blocked_pre"]
    mat, words = pack_lane_matrix(last["groups"], pad_id=mpg.n_global, n_valid=mpg.n_nodes)
    seeds, node_epoch = _gated_inputs(mpg, torch.from_numpy(mat).to(device), blocked, words)
    mtables = (mpg.in_src, mpg.edge_epoch, mpg.is_real)
    minv = torch.zeros_like(seeds)
    wave_rows({"first": "packed_pull (burst level)",
               "median": "packed_pull (burst median level)",
               "last": "packed_pull (burst last level)"}, rep_pp, mtables, node_epoch, seeds,
              minv, -1, f"mesh_lanes_10m's last burst, {len(last['groups'])} groups")
    del seeds

    # lane_finish at the mesh shape: that burst's final bits, the identity
    # form (no row map), as the mesh burst calls it
    gk, gp = blocked.clone(), blocked.clone()
    before = tpw.lane_finish_launches
    got = tpw.lane_finish(minv, mpg.is_real, None, gk)
    per_call = tpw.lane_finish_launches - before
    if per_call != 1:
        raise AssertionError(f"lane_finish (mesh): {per_call} launches for one call")
    want = tpw.lane_finish_plain(minv, mpg.is_real, None, gp)
    e = check("lane_finish (mesh)", [got[0], got[1], got[2], gk], [want[0], want[1], want[2], gp])
    union = int(got[1])
    call, restore = restored([(gk, blocked)],
                             lambda: tpw.lane_finish(minv, mpg.is_real, None, gk))
    plain_call, _ = restored([(gp, blocked)],
                             lambda: tpw.lane_finish_plain(minv, mpg.is_real, None, gp))
    ms, plain_ms, with_ms, restore_ms = timed_pair(call, restore, plain_call, plain_reps=3)
    rows_n, real_n = mpg.n_global, int(mpg.is_real.sum())
    row("lane_finish (mesh)", "lane_finish", "stl_fusion_tpu_torch/csrc/lane_finish.cu",
        "stl_fusion_tpu/parallel/packed_wave.py:169 (XLA epilogue of _build_gated_lane_burst; "
        "no Pallas kernel)", e, ms, plain_ms,
        # the epilogue's own bytes: each row's W words and is_real, the
        # blocked words read and written, the newly words, the lane counts
        rows_n * (4 * words + 1) + 3 * blocked.shape[0] * 4 + 4 * 32 * words,
        rows_n * 32 * words, None, call=call,
        shape=(f"{rows_n} rows x int32[{words}] ({real_n} real), identity form, "
               f"{blocked.shape[0]} blocked words, {union} union rows"),
        ms_with_restore=with_ms, restore_ms=restore_ms, union_rows=union,
        launches_per_call=per_call,
        # what the kernel's design moves beyond that: nothing (the identity
        # form reads each blocked word once and stores each word once)
        design_extra_bytes=0)

    # the pull leg (W = 1, the null row n_tot): its first level
    pleg = packed["pull_leg"]
    ga, n_tot = pleg["wave32"].garrays, pleg["graph"].n_tot
    ptables = (ga.in_src, ga.edge_epoch, ga.is_real)
    pinv = torch.zeros(n_tot + 1, 1, dtype=torch.int32, device=device)
    wave_rows({"first": "packed_pull (pull leg)"}, rep_pull, ptables, pleg["state"].node_epoch,
              pleg["seed_bits"][0].view(-1, 1), pinv, n_tot, "the pull leg's 32 waves")


def aten_ops(fn) -> dict:
    """{aten op: calls} that ``fn()`` dispatched, counted by a
    ``TorchDispatchMode`` (the hand-written kernels' launches go through
    ctypes and do not show)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    seen = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[str(func.overloadpacket)] += 1  # e.g. "aten.bitwise_not"
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return dict(seen)


def phase_wave_ops(g, seeds) -> dict:
    """The dense waves' elementwise work around ``or_popcount``: one union
    wave (the seed merge and the finalize's delta form) and one gated
    ``run_wave`` (the gate form), each from a cleared state, must each make
    exactly those ``or_popcount`` launches and dispatch no
    ``aten.bitwise_not``. e0d54c8's path computed the gate, ``seed &
    ~invalid``, and the finalize, ``invalid & ~before``, as elementwise
    launches around its ``or_popcount`` (and zeroed each count), and neither
    path has another ``~``."""
    from stl_fusion_tpu_torch.ops import or_popcount as opc

    out = {"phase": "wave_ops"}
    for name, run, want in (
            ("union", lambda: g.run_waves_union([seeds], mirror="off"), {"merge": 1, "delta": 1}),
            ("run_wave", lambda: g.run_wave(seeds), {"gate": 1})):
        g.clear_invalid()
        before = dict(opc.form_launches)
        ops = aten_ops(run)
        launched = {k: v - before[k] for k, v in opc.form_launches.items() if v != before[k]}
        out[name] = {"or_popcount": launched, "aten_ops": ops}
        if launched != want or "aten.bitwise_not" in ops:
            emit(out)
            raise AssertionError(f"{name}: or_popcount forms {launched} (want {want}), "
                                 f"aten.bitwise_not {ops.get('aten.bitwise_not', 0)} (want 0)")
    g.clear_invalid()
    emit(out)
    return out


def in_turns(device, ref_call, call, reps: int = 500) -> tuple:
    """(ms of ``call``, ms of ``ref_call``, the four laps) timed in turns:
    reference, this, this, reference."""
    laps = [time_ms(f, device, reps=reps, warmup=20) for f in (ref_call, call, call, ref_call)]
    return (laps[1] + laps[2]) / 2, (laps[0] + laps[3]) / 2, laps


def or_popcount_rows(device, ga, sg, rng, row, check) -> None:
    """``phase_kernels``' rows of ``or_popcount``: each form against its
    plain version, exact, at n = 7, 128, 40,000 and 524,289 words (the
    aliased calls of the main path included) and the shards form on the
    8-shard mesh's words; then a row a form at the main path's shape, as the
    main path calls it, timed in turns against e0d54c8's wrapper and kernel
    doing the same job (its merge; the gate as ``new & ~old`` then its merge;
    the finalize as ``new & ~old`` then its merge into ``old``; the shards
    as a merge a shard, ``torch.stack`` and a sum) when the reference tree
    is there; and the launch path's fixed host cost on a one-word call."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import _build
    from stl_fusion_tpu_torch.ops import or_popcount as opc
    from stl_fusion_tpu_torch.ops import wave as tw

    src = "stl_fusion_tpu_torch/csrc/or_popcount.cu"
    rep = "stl_fusion_tpu/ops/pallas_kernels.py:47"
    ref = load_reference("or_popcount")

    def words(n):
        return torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32)).to(device)

    err = {"merge": 0, "gate": 0, "delta": 0, "shards": 0}
    for n in (7, 128, 40000, 524289):
        new, old = words(n), words(n)
        want_m, want_d, want_c = opc.or_popcount_gate_plain(new, old)
        a, b = new.clone(), old.clone()
        err["merge"] = max(err["merge"], check(f"or_popcount at n={n}", opc.or_popcount(new, old),
                                               (want_m, want_c)),
                           check(f"or_popcount (out=old) at n={n}",
                                 [*opc.or_popcount(a, b, out=b), a], (want_m, want_c, new)))
        a, b = new.clone(), old.clone()
        err["gate"] = max(err["gate"], check(f"or_popcount_gate at n={n}",
                                             [*opc.or_popcount_gate(new, old), new, old],
                                             (want_m, want_d, want_c, a, b)),
                          check(f"or_popcount_gate (out=old, delta=new) at n={n}",
                                [*opc.or_popcount_gate(a, b, out=b, delta=a), a, b],
                                (want_m, want_d, want_c, want_d, want_m)))
        a, b = new.clone(), old.clone()
        err["delta"] = max(err["delta"], check(f"or_popcount_delta at n={n}",
                                               [*opc.or_popcount_delta(new, old), old],
                                               (want_d, want_c, b)),
                           check(f"or_popcount_delta (delta=new) at n={n}",
                                 [*opc.or_popcount_delta(a, old, delta=a), a],
                                 (want_d, want_c, want_d)))

    # the shards form on the mesh's shards (8 x 39,064 words at 10M nodes):
    # clones of the ring graph's invalid words, so the graph stays as it is
    inv0 = [words(x.shape[0]) for x in sg.g.invalid]
    inv, inv_plain = [x.clone() for x in inv0], [x.clone() for x in inv0]
    table = tw.ShardTable(*sg.g._replace(invalid=tuple(inv)))
    plain_table = tw.ShardTable(*sg.g._replace(invalid=tuple(inv_plain)))
    frontier = words(len(table) * table.width).view(len(table), table.width)
    err["shards"] = check("or_popcount_shards",
                          [*opc.or_popcount_shards(frontier, table), *inv],
                          [*opc.or_popcount_shards_plain(frontier, plain_table), *inv_plain])

    # the main path's shape: the dense wave's invalid words, 524,289 at 10M
    n = ga.invalid.shape[0]
    seed, inv_d, before = words(n), words(n), words(n)
    shape = f"int32[{n}] x2"
    forms = {
        "merge": dict(
            call=lambda: opc.or_popcount(seed, inv_d, out=inv_d),
            plain=lambda: opc.or_popcount_plain(seed, inv_d, out=inv_d),
            ref=lambda: ref.or_popcount(seed, inv_d, out=inv_d),
            n_bytes=12 * n + 8, n_ops=4 * n, shape=shape),
        "gate": dict(
            call=lambda: opc.or_popcount_gate(seed, inv_d, out=inv_d, delta=seed),
            plain=lambda: opc.or_popcount_gate_plain(seed, inv_d, out=inv_d, delta=seed),
            ref=lambda: ref.or_popcount(seed & ~inv_d, inv_d, out=inv_d),
            n_bytes=16 * n + 8, n_ops=4 * n, shape=shape),
        "delta": dict(
            call=lambda: opc.or_popcount_delta(inv_d, before),
            plain=lambda: opc.or_popcount_delta_plain(inv_d, before),
            ref=lambda: (inv_d & ~before, ref.or_popcount(inv_d, before, out=before)),
            n_bytes=12 * n + 8, n_ops=3 * n, shape=shape),
        "shards": dict(
            call=lambda: opc.or_popcount_shards(frontier, table),
            plain=lambda: opc.or_popcount_shards_plain(frontier, plain_table),
            ref=lambda: torch.stack([ref.or_popcount(frontier[d, :table.words], x, out=x)[1]
                                     for d, x in enumerate(inv)]).sum(),
            n_bytes=12 * len(table) * table.words + 8 * (len(table) + 1),
            n_ops=4 * len(table) * table.words,
            shape=f"{len(table)} shards x int32[{table.words}] (rows of {table.width})"),
    }
    for form, f in forms.items():
        if ref is not None:
            ms, ref_ms, laps = in_turns(device, f["ref"], f["call"])
        else:
            ms, ref_ms, laps = time_ms(f["call"], device, reps=500, warmup=20), None, None
        name = "or_popcount" if form == "merge" else f"or_popcount ({form})"
        row(name, f"or_popcount.{form}", src, rep, err[form], ms,
            time_ms(f["plain"], device, reps=5), f["n_bytes"], f["n_ops"], None,
            shape=f["shape"], call=f["call"], ref_e0d54c8_ms=ref_ms, laps_ref_this_this_ref=laps)

    # the launch path's fixed host cost, on a one-word merge: through
    # _build.launch (library, entry and device looked up a call) and through
    # the entry resolved once; then this wrapper and e0d54c8's on the same call
    one_new, one_old, count = words(1), words(1), torch.empty((), dtype=torch.int64,
                                                                device=device)
    opc.or_popcount(one_new, one_old, out=one_old)  # the stream's ticket scratch exists
    idx = device.index if device.index is not None else torch.cuda.current_device()
    _, scratch_ptr, slots = opc._scratch[(idx, torch._C._cuda_getCurrentRawStream(idx))]
    args = (opc._ARGS.pack(0, one_new.data_ptr(), 0, one_old.data_ptr(), one_old.data_ptr(), 0,
                           0, 1, 1, scratch_ptr, slots, count.data_ptr()),)
    fn = _build.entry("or_popcount", "or_popcount_launch")

    def via_launch():
        _build.launch("or_popcount", "or_popcount_launch", *args)

    def via_entry():
        if fn(*args, torch._C._cuda_getCurrentRawStream(idx)):
            raise RuntimeError("or_popcount_launch failed")

    def wrapper():
        opc.or_popcount(one_new, one_old, out=one_old)

    def ref_wrapper():
        ref.or_popcount(one_new, one_old, out=one_old)

    def host_ms(fn, reps=2000):
        """ms a call on the host clock: the enqueue rate while the card
        keeps up (a one-word kernel takes less than its launch)."""
        for _ in range(20):
            fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        sync(device)
        return (t1 - t0) * 1e3 / reps

    paths = {"launch": via_launch, "entry": via_entry, "wrapper": wrapper}
    if ref is not None:
        paths["ref_e0d54c8_wrapper"] = ref_wrapper
    cost = {}
    for key, fn_ in paths.items():
        cost[f"{key}_ms"] = time_ms(fn_, device, reps=1000)
        cost[f"{key}_host_ms"] = host_ms(fn_)
    if int(count) != 0 or not torch.equal(one_old, one_new | one_old):
        raise AssertionError("the one-word launches did not merge")
    row("or_popcount launch path (1 word)", "or_popcount.merge", src, rep, 0, cost["entry_ms"],
        time_ms(lambda: opc.or_popcount_plain(one_new, one_old, out=one_old), device, reps=100),
        20, 4, None, shape="int32[1] x2", call=via_entry, main_path=False, launches=0, **cost)


def profiled(device, call, form: str, name: str, reps: int = 20, per_call: int = 1) -> dict:
    """``device_ms`` (``torch.profiler``'s device time of one call of
    ``form``'s kernel) and ``profiled_launches`` over ``reps`` calls;
    ``device_ms`` is None when three profiles in a row lost every launch."""
    form = form if form in SYMBOLS else form.split(".")[0]
    _, _, _, seen = profile_checked(device, lambda: [call() for _ in range(reps)],
                                    {form: reps * per_call}, name, lost_ok=True)
    ms, got = seen[form]
    return {"device_ms": ms * per_call if got else None, "profiled_launches": got}


def phase_kernels(device, main_launches: dict, level: dict, sg, topo: dict, churn: dict,
                  live: dict, packed: dict, card: str, made_rows: Optional[dict] = None) -> dict:
    """Every kernel form against its plain version on the card at the main
    path's shapes, exact, with its time (CUDA events), its device time
    (``torch.profiler``; the CUDA-event time, marked ``device_ms_by``, where
    three profiles in a row lost every launch), the bound for the same work
    and a PyTorch call computing the same function where there is one.
    Returns {name: row}."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import ring_all_gather as rag
    from stl_fusion_tpu_torch.ops import wave as tw
    from stl_fusion_tpu_torch.ops.bitops import pack_bits, pack_mask_host

    rng = np.random.default_rng(1)
    rows = {}

    def row(name, form, source, replaces, err, ms, plain_ms, n_bytes, n_ops, library_ms, **extra):
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        rows[name] = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": main_launches.get(form, 0), "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms, "form": form, **extra}

    def check(name, got, want):
        got, want = list(got), list(want)
        e = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                for a, b in zip(got, want))
        if e or len(got) != len(want) or any(a.shape != b.shape for a, b in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version")
        return e

    def restored(state, fn):
        """``fn`` after restoring the tensors it merges into: a merged level
        updates ``invalid`` in place, so each timed call starts from the
        level's own state. Returns (call, the restore alone)."""
        targets, sources = [t for t, _ in state], [t0 for _, t0 in state]

        def restore():  # one device call: a copy per shard would be host-bound,
            torch._foreach_copy_(targets, sources)  # and its time is subtracted

        def call():
            restore()
            return fn()
        return call, restore

    def timed_pair(call, restore, plain, plain_reps=5):
        """(ms of the call less its restore, plain ms, ms with the restore,
        restore ms)."""
        with_ms, restore_ms = time_ms(call, device), time_ms(restore, device)
        return with_ms - restore_ms, time_ms(plain, device, reps=plain_reps), with_ms, restore_ms

    src_wave = "stl_fusion_tpu_torch/csrc/wave_expand.cu"
    rep_wave = "stl_fusion_tpu/ops/wave.py:80 (XLA wave_step; no Pallas kernel)"

    ga = level["ga"]
    or_popcount_rows(device, ga, sg, rng, row, check)

    # the dense wave's level, pure and merged, at the union wave's first and
    # widest levels; bytes: 4 B per live edge, 8 B more per frontier edge,
    # the epoch of each distinct dependent, and the bit vectors (frontier
    # and invalid read, next written; the merge writes invalid too)
    es, ed, ee = ga.live_edges()
    n_e, n_cap, w = es.shape[0], ga.n_cap, ga.invalid.shape[0]

    def words(ids):
        mask = np.zeros(n_cap + 1, bool)
        mask[ids] = True
        return torch.from_numpy(pack_mask_host(mask)).to(device)

    def dense_level(which):  # a function, so each level's calls keep their own tensors
        lv = level[which]
        fw, iw0 = words(lv["frontier"]), words(lv["invalid"])
        a, u = lv["active_edges"], lv["active_dsts"]
        suffix = "" if which == "first" else " (widest level)"
        shape = (f"level {lv['level']} of the union wave: {n_e} live edges, {a} from the "
                 f"frontier, {u} distinct dependents, {w} words")
        args = (fw, iw0, ga.node_epoch, es, ed, ee)
        e = check(f"wave_expand{suffix}", [tw.wave_expand(*args)], [tw.wave_expand_plain(*args)])

        def expand():  # as a caller with the graph's source-id bound calls it
            return tw.wave_expand(*args, n_src=n_cap + 1)
        row("wave_expand" + suffix, "wave_expand", src_wave, rep_wave, e,
            time_ms(expand, device), time_ms(lambda: tw.wave_expand_plain(*args), device, reps=5),
            4 * n_e + 8 * a + 4 * u + 12 * w, n_e + 3 * a, None, shape=shape, call=expand,
            main_path=False)

        iw, iw_plain = iw0.clone(), iw0.clone()
        got = tw.wave_expand_merge(fw, iw, ga.node_epoch, es, ed, ee)
        want = tw.wave_expand_merge_plain(fw, iw_plain, ga.node_epoch, es, ed, ee)
        e = check(f"wave_expand_merge{suffix}", [*got, iw], [*want, iw_plain])
        call, restore = restored([(iw, iw0)], lambda: tw.wave_expand_merge(
            fw, iw, ga.node_epoch, es, ed, ee, n_src=n_cap + 1))
        plain_call, _ = restored([(iw_plain, iw0)], lambda: tw.wave_expand_merge_plain(
            fw, iw_plain, ga.node_epoch, es, ed, ee))
        ms, plain_ms, with_ms, restore_ms = timed_pair(call, restore, plain_call)
        row("wave_expand_merge" + suffix, "wave_expand_merge", src_wave, rep_wave, e, ms,
            plain_ms, 4 * n_e + 8 * a + 4 * u + 16 * w + 8, n_e + 3 * a + w, None,
            shape=shape, call=call, ms_with_restore=with_ms, restore_ms=restore_ms,
            newly=int(got[1]))

    dense_level("first")
    dense_level("widest")

    # the sharded wave's level: one launch for the 8 shards, at the first
    # level of the 100,000-seed union wave (every shard reads the packed
    # global frontier), against 8 plain merged levels
    table = tw.ShardTable(*sg.g)
    lv = level["first"]
    seeds = torch.zeros(sg.n_global, dtype=torch.bool, device=device)
    seeds[torch.from_numpy(lv["frontier"]).to(device)] = True
    fw = pack_bits(seeds)
    inv0 = [pack_bits(torch.nn.functional.pad(seeds.view(sg.n_dev, -1), (0, 1))[d])
            for d in range(sg.n_dev)]
    for inv, i0 in zip(sg.g.invalid, inv0):
        inv.copy_(i0)
    plain_inv = [i0.clone() for i0 in inv0]
    plain_table = tw.ShardTable(*sg.g._replace(invalid=tuple(plain_inv)))
    got = tw.wave_expand_shards(fw, table, sg.n_global)
    want = tw.wave_expand_shards_plain(fw, plain_table)
    e = check("wave_expand_shards", [*got, *sg.g.invalid], [*want, *plain_inv])
    call, restore = restored(list(zip(sg.g.invalid, inv0)),
                             lambda: tw.wave_expand_shards(fw, table, sg.n_global))
    plain_call, _ = restored(list(zip(plain_inv, inv0)),
                             lambda: tw.wave_expand_shards_plain(fw, plain_table))
    ms, plain_ms, with_ms, restore_ms = timed_pair(call, restore, plain_call, plain_reps=3)
    n_e = sum(s.e_cap for s in table.shards)
    a, u = lv["active_edges"], lv["active_dsts"]
    n_sh = len(table)
    row("wave_expand_shards", "wave_expand_shards", src_wave, rep_wave, e, ms, plain_ms,
        4 * n_e + 8 * a + 4 * u + 4 * fw.shape[0] + 8 * n_sh * table.words
        + 4 * n_sh * table.width + 8, n_e + 3 * a + n_sh * table.words, None,
        shape=(f"level 0 of the union wave on {n_sh} shards: {n_e} edges, {a} from the "
               f"frontier, {fw.shape[0]} frontier words"),
        call=call, ms_with_restore=with_ms, restore_ms=restore_ms, newly=int(got[1]))

    # ring_all_gather: 8 shards x 39,063 words, the sharded 10M wave's
    # shape: rows of the next-frontier tensor (the main path's form) and a
    # list; the yardstick is one PyTorch computation of the same function
    # (n copies of the concatenation), and torch.cat alone is the one-copy
    # exchange "packed" does
    c = sg.n_local // 32
    words_2d = torch.from_numpy(rng.integers(-(2**31), 2**31, (n_sh, table.width),
                                             dtype=np.int32)).to(device)
    chunks_rows, chunks_list = words_2d[:, :c], [x[:c].clone() for x in words_2d]
    full = words_2d[:, :c].reshape(-1)
    copies = torch.empty(n_sh, n_sh * c, dtype=torch.int32, device=device)

    def n_copies():
        return copies.copy_(torch.cat(chunks_list).expand(n_sh, -1))
    cat_ms = time_ms(lambda: torch.cat(chunks_list), device)
    library_ms = time_ms(n_copies, device)
    for name, form, chunks, given in (
            ("ring_all_gather", "ring_all_gather", chunks_rows, f"row stride {table.width}"),
            ("ring_all_gather (list)", "ring_all_gather.list", chunks_list, "a list")):
        got, want = rag.ring_all_gather(chunks), rag.ring_all_gather_plain(chunks)
        e = check(name, [got], [want])
        if not torch.equal(got, full.expand(n_sh, -1)):
            raise AssertionError(f"{name} is not the concatenation on every shard")

        def gather(chunks=chunks):
            return rag.ring_all_gather(chunks)
        row(name, form, "stl_fusion_tpu_torch/csrc/ring_all_gather.cu",
            "stl_fusion_tpu/ops/pallas_kernels.py:103", e, time_ms(gather, device),
            time_ms(lambda: rag.ring_all_gather_plain(chunks), device),
            4 * n_sh * c + 4 * n_sh * n_sh * c, 0, library_ms, call=gather,
            shape=f"{n_sh} shards x int32[{c}] ({given})",
            cat_ms=cat_ms, main_path=form == "ring_all_gather")

    # topo_sweep: the whole sweep of topo_10m (10M nodes, W=16, k=4, 512
    # packed waves of 100,000 seeds) from a zeroed state, and its widest level
    # alone (rows of levels >= 1), launched through the C entry with no tail
    import ctypes

    from stl_fusion_tpu_torch.ops import _build
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    leg = topo["leg"]
    graph, tga, seeds, st = leg["graph"], leg["wave32"].garrays, leg["seed_bits"][-1], leg["state"]
    starts, w, inv = graph.level_starts, leg["words"], st.invalid_bits
    src_topo = "stl_fusion_tpu_torch/csrc/topo_sweep.cu"
    rep_topo = "stl_fusion_tpu/ops/topo_wave.py:257 (XLA _topo_sweep_impl; no Pallas kernel)"
    zero = torch.zeros_like(inv)
    plain_st = tpw.TopoState(st.node_epoch, torch.zeros_like(inv))
    call, restore = restored([(inv, zero)], lambda: tpw.topo_sweep(starts, tga, seeds, st))
    plain_call, _ = restored([(plain_st.invalid_bits, zero)],
                             lambda: tpw.topo_sweep_plain(starts, tga, seeds, plain_st))
    got, want = call()[1], plain_call()[1]
    e = check("topo_sweep", [got], [want])
    if not torch.equal(inv, plain_st.invalid_bits):
        raise AssertionError("topo_sweep: bits differ from its plain version")
    ms, plain_ms, with_ms, restore_ms = timed_pair(call, restore, plain_call, plain_reps=3)
    row("topo_sweep", "topo_sweep", src_topo, rep_topo, e, ms, plain_ms,
        sweep_bytes(graph, w, 1, True), 0, None, call=call, per_call=_nonempty_levels(starts),
        shape=(f"{graph.n_tot + 1} rows x int32[{w}], k={graph.k}, "
               f"{len(starts) - 1} levels, 512 packed waves"),
        ms_with_restore=with_ms, restore_ms=restore_ms, newly=int(got.long().sum()))

    wl = max(range(1, len(starts) - 1), key=lambda lv: starts[lv + 1] - starts[lv])
    a, b = starts[wl], starts[wl + 1]
    lvl = np.asarray([a, b], np.int64)
    inv_k = inv.clone()
    inv_k[a:b] = 0
    inv_p = inv_k.clone()
    level_counts, made = torch.zeros(w, dtype=torch.int32, device=device), ctypes.c_int(0)

    def level_call():
        _build.launch("topo_sweep", "topo_sweep_launch", tga.in_src.data_ptr(),
                      tga.edge_epoch.data_ptr(), st.node_epoch.data_ptr(), tga.is_real.data_ptr(),
                      None, inv_k.data_ptr(), level_counts.data_ptr(), None, lvl.ctypes.data,
                      1, 0, graph.k, w, graph.n_tot, graph.n_tot + 1, int(w % 4 == 0),
                      ctypes.addressof(made))

    def level_plain():
        tpw._plain_level(inv_p, tga, st.node_epoch, a, b)

    level_call()
    level_plain()
    if made.value != 1 or not torch.equal(inv_k, inv_p):
        raise AssertionError("topo_sweep (widest level) differs from its plain version")
    row("topo_sweep (widest level)", "topo_sweep", src_topo, rep_topo, 0,
        time_ms(level_call, device), time_ms(level_plain, device, reps=5),
        sweep_bytes(graph, w, 1, False, levels=(wl, wl + 1)), 0, None, call=level_call,
        main_path=False,
        shape=f"level {wl}: rows [{a}, {b}) x int32[{w}], k={graph.k}")

    lane_kernel_rows(device, level, churn, rng, row, check, restored, timed_pair, src_topo,
                     rep_topo)
    wide_mirror_rows(device, rng, row, check, restored, timed_pair, src_topo, rep_topo)
    block_refresh_rows(device, live, rng, row, check, restored, timed_pair)
    packed_pull_rows(device, packed, live, row, check, restored, timed_pair)
    # rows made (and profiled) where their inputs lived: routed_level's a2a
    # level at the 80M mesh wave's widest level and its seed step there, its
    # gather and hier lookups at the 10M exchanges' widest levels, its
    # speculative form at the async A/B's widest speculative level
    for name, r in (made_rows or {}).items():
        rows[name] = dict(r, launches=main_launches.get(r["form"], 0))

    # device time alone (torch.profiler): tells launch- or host-bound calls
    # from slow kernels, since CUDA events over back-to-back calls also time
    # the host's enqueue when it is the slower side; each call is exactly
    # one launch of its form's kernel
    reps = 20
    for r in rows.values():
        if "device_ms" in r:  # profiled where it was made (its inputs are freed)
            continue
        call, per_call = r.pop("call"), r.pop("per_call", 1)
        r.update(profiled(device, call, r["form"], r["name"], reps, per_call))
        if r["device_ms"] is None:  # the trace lost the launches: CUDA events instead
            r.update(device_ms=r["ms"], device_ms_by="cuda_events")
    emit({"phase": "kernels", "card": card, "kernels": list(rows.values())})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    from stl_fusion_tpu_torch.ops import block_refresh as brf_mod
    from stl_fusion_tpu_torch.ops import or_popcount as opc_mod
    from stl_fusion_tpu_torch.ops import packed_pull as ppp_mod
    from stl_fusion_tpu_torch.ops import ring_all_gather as rag_mod
    from stl_fusion_tpu_torch.ops import routed_wave as rlw_mod
    from stl_fusion_tpu_torch.ops import topo_wave as tpw_mod
    from stl_fusion_tpu_torch.ops import wave as wave_mod

    device = torch.device("cuda")
    dev = phase_device()
    phase_build()
    # a fresh directory outside the checkout for the disk mirror cache (each
    # 10M mirror build is a miss and saves, then the phase loads it back)
    # and the live twin's graph snapshot
    work = tempfile.mkdtemp(prefix="fusion-smoke-")
    os.environ["FUSION_MIRROR_CACHE"] = os.path.join(work, "mirror-cache")
    os.makedirs(os.environ["FUSION_MIRROR_CACHE"])
    try:
        return _main(torch, device, dev, work, opc_mod, wave_mod, rag_mod, tpw_mod, brf_mod,
                     ppp_mod, rlw_mod)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _main(torch, device, dev, work, opc_mod, wave_mod, rag_mod, tpw_mod, brf_mod,
          ppp_mod, rlw_mod) -> int:

    def counts():
        return {"or_popcount": opc_mod.launches,
                **{f"or_popcount.{k}": v for k, v in opc_mod.form_launches.items()},
                "wave_expand.all_forms": wave_mod.launches,
                "wave_expand": wave_mod.form_launches["pure"],
                "wave_expand_merge": wave_mod.form_launches["merge"],
                "wave_expand_shards": wave_mod.form_launches["shards"],
                "ring_all_gather": rag_mod.launches, "ring_cuda_launches": rag_mod.cuda_launches,
                "topo_sweep": tpw_mod.launches, "lane_finish": tpw_mod.lane_finish_launches,
                "block_refresh": brf_mod.launches, "packed_pull": ppp_mod.launches,
                "packed_pull.early_exits": ppp_mod.early_exits,
                "routed_level": rlw_mod.launches,
                **{f"routed_level.{k}": v for k, v in rlw_mod.form_launches.items()}}

    def reset():
        opc_mod.launches = wave_mod.launches = rag_mod.launches = rag_mod.cuda_launches = 0
        tpw_mod.launches = tpw_mod.lane_finish_launches = brf_mod.launches = 0
        ppp_mod.launches = ppp_mod.early_exits = rlw_mod.launches = 0
        rlw_mod.form_launches.update(dict.fromkeys(rlw_mod.form_launches, 0))
        wave_mod.form_launches.update(dict.fromkeys(wave_mod.form_launches, 0))
        opc_mod.form_launches.update(dict.fromkeys(opc_mod.form_launches, 0))

    def check(path, got, kernels, absent=()):
        """Each named kernel form must have launched on the path, each
        ``absent`` one must not have, and the ring made one CUDA launch per
        gather."""
        emit({"phase": "main_path_launches", "path": path, **got})
        for name in kernels:
            if got[name] <= 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
        for name in absent:
            if got[name] != 0:
                raise AssertionError(f"{name} was launched {got[name]} times on the {path} path")
        if got["ring_cuda_launches"] != got["ring_all_gather"]:
            raise AssertionError(f"the ring made {got['ring_cuda_launches']} CUDA launches in "
                                 f"{got['ring_all_gather']} gathers on the {path} path")
        return got

    def drive(path, run, kernels, absent=()):
        """One path of the main path: counts to 0 just before, read just
        after, then checked."""
        reset()
        res = run()
        return res, check(path, counts(), kernels, absent)

    pl, dense = drive("dense", lambda: (phase_hellocart(device),
                                        phase_power_law(device, dev["nvidia_smi"]))[1],
                      ("or_popcount.merge", "or_popcount.gate", "or_popcount.delta",
                       "or_popcount.shards", "wave_expand_merge"))
    sh, sharded = drive("sharded", lambda: phase_sharded(device, dev["nvidia_smi"], pl["level"]),
                        ("or_popcount.shards", "wave_expand_shards", "ring_all_gather"),
                        absent=("or_popcount.merge", "or_popcount.gate", "or_popcount.delta"))
    topo, mirror = drive("mirror", lambda: (phase_mirror(device, dev["nvidia_smi"], pl["level"]),
                                            phase_topo_10m(device, dev["nvidia_smi"]))[1],
                         ("topo_sweep",), absent=("wave_expand.all_forms", "lane_finish"))
    packed, packedd = drive("packed", lambda: phase_packed_10m(device, dev["nvidia_smi"], topo),
                            ("packed_pull",), absent=("topo_sweep", "lane_finish"))
    # the routed mesh at 80M (built, waved and freed before the live stack
    # exists, so the host's peak memory does not stack), its other exchanges
    # on the 10M graph and the async A/B: routed_level and nothing else
    routed_rows: dict = {}
    _, mesh80d = drive("mesh_80m", lambda: phase_mesh_80m(device, dev["nvidia_smi"],
                                                          pl["level"], routed_rows),
                       ("routed_level", "routed_level.level", "routed_level.seed",
                        "routed_level.spec", "routed_level.a2a", "routed_level.gather",
                        "routed_level.hier"),
                       absent=("packed_pull", "topo_sweep", "lane_finish"))
    level = pl["level"]
    g, seeds = level["graph"], level["seeds"].tolist()
    calls = level["want_union"][2] + 1  # wave_expand calls per union wave
    # the dense and ring waves' profiles on the graph as the oracle saw it,
    # before churn_10m adds edges to it
    phase_profile(device, "run_waves_union", lambda: g.run_waves_union([seeds], mirror="off"),
                  g.clear_invalid, calls)
    phase_wave_ops(g, seeds)
    sg = sh.pop("ring_graph")
    phase_profile(device, "sharded run_wave (ring)", lambda: sg.run_wave(seeds),
                  sg.clear_invalid, calls, exchange="ring")
    churn, churned = drive("churn", lambda: phase_churn(device, dev["nvidia_smi"], level),
                           ("topo_sweep", "lane_finish"))
    # the live paths: the blocking loop (counts from 0 just before it, read
    # just before the super-round loop starts) and live_sr, the super-round
    # and chain loops (from 0 at the super-round loop's start, read at the
    # chain loop's end)
    paths = {}
    reset()
    live = phase_live(device, dev["nvidia_smi"], level, paths, reset, counts,
                      os.path.join(work, "live-graph.npz"))
    live_kernels = ("topo_sweep", "lane_finish", "block_refresh")
    lived = check("live", paths["live"], live_kernels)
    live_srd = check("live_sr", paths["live_sr"], live_kernels)
    meshd = check("mesh_lanes", paths["mesh_lanes"], ("packed_pull", "lane_finish"))
    _, writed = drive("write", lambda: phase_write(device, dev["nvidia_smi"], live, level),
                      ("topo_sweep", "lane_finish", "packed_pull", "block_refresh",
                       "or_popcount.merge", "or_popcount.delta", "wave_expand_merge"))
    # every wave of the fan-out rides the mirrors: the lane bursts and the
    # re-subscriptions' expansions the topo sweep, the host-led leg and the
    # lone samples (one seed each) the lat mirror or, past its caps, the sweep
    _, fanoutd = drive("fanout", lambda: phase_fanout(device, dev["nvidia_smi"], live),
                       ("topo_sweep", "lane_finish", "block_refresh"),
                       absent=("wave_expand.all_forms", "or_popcount", "packed_pull"))
    # the edge tier's waves: the warm and measured lane bursts and the smoke
    # burst the topo sweep and lane finish, each round's refresh the block
    # refresh, the value publisher's recomputes of the fenced keys (scalar
    # reads, expanded at the next flush as host-led marks) the mirrors
    _, edged = drive("edge", lambda: phase_edge(device, dev["nvidia_smi"], live),
                     ("topo_sweep", "lane_finish", "block_refresh"),
                     absent=("wave_expand.all_forms", "or_popcount", "packed_pull"))
    # the watchdog's fused bursts (the mirror kernels), its split host loop
    # (the dense union wave: wave_expand_merge, or_popcount's merge and delta
    # forms), the block refresh after every burst and in the faulted
    # super-round; no packed_pull
    _, resd = drive("resilience", lambda: phase_resilience(device, dev["nvidia_smi"], live),
                    ("topo_sweep", "lane_finish", "wave_expand_merge", "or_popcount.merge",
                     "or_popcount.delta", "block_refresh"), absent=("packed_pull",))
    # the live routed pipeline on the same stack: the pipeline's chains and
    # the routed super-round ride routed_level; the super-round's refresh is
    # block_refresh; no packed_pull
    _, meshlived = drive("mesh_live", lambda: phase_mesh_live(device, dev["nvidia_smi"], live),
                         ("routed_level", "routed_level.level", "routed_level.seed",
                          "routed_level.a2a", "block_refresh"), absent=("packed_pull",))
    # the read twin's tables: gathers and scatters of torch, no hand-written
    # kernel (its drive list is empty)
    _, readd = drive("read", lambda: phase_read(device, dev["nvidia_smi"]), ())
    main_launches = {name: sum(p[name] for p in (dense, sharded, mirror, packedd, mesh80d,
                                                 churned, lived, live_srd, meshd, writed, fanoutd,
                                                 edged, resd, meshlived, readd))
                     for name in dense}
    kernels = phase_kernels(device, main_launches, level, sg, topo, churn, live, packed,
                            dev["nvidia_smi"], routed_rows)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels.values()
                                  if r.get("main_path", True)]}))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
