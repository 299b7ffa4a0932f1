#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stl_fusion_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``stl_fusion_tpu_torch/csrc`` and
runs the cascading-invalidation wave end to end through the entry points a
user calls. Phases, each printing one JSON line:

1. ``device``   — the card's name, device count, ``nvidia-smi`` name and power
   limit;
2. ``build``    — ``nvcc`` compiles every kernel (``-Xptxas -v`` registers and
   spills);
3. ``hellocart`` — the HelloCart v1 chain (Product → Cart → Total) on a
   ``FusionHub`` with the port's ``TpuGraphBackend`` on the card: a host-led
   change through ``invalidating()``, ``invalidate_cascade``,
   ``invalidate_cascade_batch`` and one ``invalidate_cascade_batch_sharded``
   burst on an 8-shard mesh on the card, with the watched node applied
   eagerly, the rest pending, and the recomputed totals right;
4. ``power_law_10m`` — the BASELINE stress graph (``power_law_dag(10M,
   avg_degree=3, seed=7)``) in ``DeviceGraph(device="cuda")`` with 1% of nodes
   epoch-bumped after capture: ``run_waves_union`` from 100,000 seeds,
   ``run_wave_collect`` from 256 shallow seeds and ``run_wave_with_stats``
   from hub nodes, each held EXACTLY against an independent numpy level-BFS
   oracle on a src-sorted CSR; the union wave must make one merged
   ``wave_expand`` launch per level and only two ``or_popcount`` launches;
5. ``sharded_10m`` — the same graph and epochs as a ``ShardedDeviceGraph``
   on a mesh of 8 logical shards on the card: the 100,000-seed ``run_wave``
   with ``exchange="ring"`` (the ring all-gather kernel), ``"packed"`` and
   ``"bool"``, and ``run_wave_collect`` from the 256 shallow seeds, each held
   EXACTLY against the same oracle; each wave must make ONE ``wave_expand``
   launch per level for all 8 shards, one ring gather (one CUDA launch) per
   level on the ring, and ``or_popcount`` only for the seed merge;
6. ``profile`` — ``torch.profiler`` over one more 10M union wave and one
   sharded ring wave: device time by kernel, device calls per wave, the
   device's idle share, and the level kernel's launches (one per level);
7. ``kernels``  — every kernel form against its plain PyTorch version on the
   card, exact: ``or_popcount``; ``wave_expand`` (pure) and
   ``wave_expand_merge`` at the union wave's first and widest levels;
   ``wave_expand_shards`` at the sharded wave's first level; the ring from
   2-D rows (the main path's form) and from a list. Each with its time (CUDA
   events), its device time (``torch.profiler``), the plain version's time,
   the bound for the same work, and one PyTorch computation of the same
   function where there is one (the ring: the concatenation copied into
   all ``n`` rows; ``torch.cat`` alone is recorded beside it).

The main path is two paths, each driven with every kernel's launch count
set to 0 just before it and read just after: phases 3-4 (the dense wave)
must launch ``or_popcount`` and ``wave_expand_merge``, phase 5 (the sharded
wave) ``or_popcount``, ``wave_expand_shards`` and ``ring_all_gather``. Any
failure raises and the script exits non-zero. The last lines are the kernel
summary (the forms the main path runs), the ``nvidia-smi`` name and power
limit, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, and
#: the non-tensor-core ALU rate used for the integer bit operations here
PEAK_BYTES_PER_S = 3.35e12
PEAK_ALU_OPS_PER_S = 67e12

N_NODES = 10_000_000
N_UNION_SEEDS = 100_000
GRAPH_SEED = 7
N_SHARDS = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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

    from stl_fusion_tpu_torch.ops import or_popcount as opc_mod
    from stl_fusion_tpu_torch.ops import wave as wave_mod

    union_seeds = rng.choice(n, n_seeds, replace=False)
    opc0, merge0 = opc_mod.launches, wave_mod.form_launches["merge"]
    (count, ids), ms = timed(lambda: g.run_waves_union([union_seeds.tolist()]))
    union_levels = []
    want = want_union = oracle.wave(union_seeds, levels=union_levels)
    check("run_waves_union", count, ids, want)
    # one merged wave_expand per level (the last one lights nothing); the
    # only or_popcounts are the seed merge and the union finalize
    launched = (opc_mod.launches - opc0, wave_mod.form_launches["merge"] - merge0)
    if launched != (2, want[2] + 1):
        raise AssertionError(f"union wave launched (or_popcount, wave_expand_merge) = {launched},"
                             f" not (2, {want[2] + 1})")
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
    (count, ids), ms = timed(lambda: g.run_wave_collect(shallow.tolist()))
    want = want_shallow = oracle.wave(shallow)
    check("run_wave_collect", count, ids, want)
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
    out["launches_so_far"] = {"or_popcount": opc_mod.launches, "wave_expand": wave_mod.launches,
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

    from stl_fusion_tpu_torch.ops import or_popcount as opc_mod
    from stl_fusion_tpu_torch.ops import ring_all_gather as rag
    from stl_fusion_tpu_torch.ops import wave as wave_mod
    from stl_fusion_tpu_torch.parallel import ShardedDeviceGraph, graph_mesh

    def launch_counts():
        return {"wave_expand": wave_mod.launches,
                "wave_expand_shards": wave_mod.form_launches["shards"],
                "or_popcount": opc_mod.launches, "ring_all_gather": rag.launches,
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
            # lights nothing); or_popcount only merges the seeds, once per shard
            calls = sg.last_levels + 1
            want_launched = {"wave_expand": calls, "wave_expand_shards": calls,
                             "or_popcount": mesh.size,
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
    return wall_ms, by_name, calls


def kernel_calls(by_name: dict, symbol: str) -> tuple:
    """(device ms, calls) of the kernels whose name holds ``symbol``
    (spaces ignored: ``wave_expand_kernel<true,true>``)."""
    hits = [v for name, v in by_name.items() if symbol in name.replace(" ", "")]
    return sum(v["ms"] for v in hits), sum(v["calls"] for v in hits)


#: each kernel form's symbol in the profiler's kernel names
SYMBOLS = {
    "or_popcount": "or_popcount_kernel",
    "wave_expand": "wave_expand_kernel<false,false>",
    "wave_expand_merge": "wave_expand_kernel<true,false>",
    "wave_expand_shards": "wave_expand_kernel<true,true>",
    "ring_all_gather": "ring_gather_kernel",
}


def phase_profile(device, wave: str, run, reset, levels: int, exchange=None) -> dict:
    """Where one 10M-node wave's time goes: ``torch.profiler`` over the same
    wave as the main path's, from a cleared state after a warm-up; device
    time by kernel, the device calls per wave and the device's idle share.
    ``levels`` is the wave's wave_expand calls (productive levels + 1): the
    profile must show exactly that many launches of the level's kernel,
    and of the ring kernel on a ring wave."""
    reset()
    run()  # warm-up
    reset()
    wall_ms, by_name, calls = profile_device(device, run)
    device_ms = sum(v["ms"] for v in by_name.values())
    form = "wave_expand_merge" if exchange is None else "wave_expand_shards"
    seen = {form: kernel_calls(by_name, SYMBOLS[form])[1]}
    if exchange == "ring":
        seen["ring_all_gather"] = kernel_calls(by_name, SYMBOLS["ring_all_gather"])[1]
    if any(v != levels for v in seen.values()):
        raise AssertionError(f"{wave}: the profile shows {seen} launches, not {levels} each")
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:12])
    out = {"phase": "profile", "wave": wave, "wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": 1 - device_ms / wall_ms, "device_calls": calls,
           "kernel_launches": seen, "by_kernel": top}
    emit(out)
    return out


def phase_kernels(device, main_launches: dict, level: dict, sg, card: str) -> dict:
    """Every kernel form against its plain version on the card at the main
    path's shapes, exact, with its time (CUDA events), its device time
    (``torch.profiler``), the bound for the same work and a PyTorch call
    computing the same function where there is one. Returns {name: row}."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import ring_all_gather as rag
    from stl_fusion_tpu_torch.ops import wave as tw
    from stl_fusion_tpu_torch.ops.bitops import pack_bits, pack_mask_host
    from stl_fusion_tpu_torch.ops.or_popcount import or_popcount, or_popcount_plain

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

    # or_popcount: random words with negative ones and ragged (non-x4) tails
    err, ga = 0, level["ga"]
    for n in (7, 128, 40000, 524289):
        new = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32)).to(device)
        old = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32)).to(device)
        inplace = old.clone()
        want = or_popcount_plain(new, old)
        err = max(err, check(f"or_popcount at n={n}", or_popcount(new, old), want),
                  check(f"or_popcount in place at n={n}", or_popcount(new, inplace, out=inplace),
                        want))
    n = ga.invalid.shape[0]  # the main path's word count (524,289 at 10M)
    new = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32)).to(device)
    old = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32)).to(device)
    row("or_popcount", "or_popcount", "stl_fusion_tpu_torch/csrc/or_popcount.cu",
        "stl_fusion_tpu/ops/pallas_kernels.py:47", err,
        time_ms(lambda: or_popcount(new, old), device),
        time_ms(lambda: or_popcount_plain(new, old), device), 12 * n + 8, 4 * n, None,
        shape=f"int32[{n}] x2", call=lambda: or_popcount(new, old))

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

    # device time alone (torch.profiler): tells launch- or host-bound calls
    # from slow kernels, since CUDA events over back-to-back calls also time
    # the host's enqueue when it is the slower side; each call is exactly
    # one launch of its form's kernel
    reps = 20
    for r in rows.values():
        call = r.pop("call")
        symbol = SYMBOLS[r["form"].split(".")[0]]
        _, by_name, _ = profile_device(device, lambda: [call() for _ in range(reps)])
        dev_ms, calls = kernel_calls(by_name, symbol)
        if calls != reps:
            raise AssertionError(f"{r['name']}: {calls} launches of {symbol} in {reps} calls")
        r["device_ms"] = dev_ms / reps
    emit({"phase": "kernels", "card": card, "kernels": list(rows.values())})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    from stl_fusion_tpu_torch.ops import or_popcount as opc_mod
    from stl_fusion_tpu_torch.ops import ring_all_gather as rag_mod
    from stl_fusion_tpu_torch.ops import wave as wave_mod

    device = torch.device("cuda")
    dev = phase_device()
    phase_build()

    def counts():
        return {"or_popcount": opc_mod.launches, "wave_expand.all_forms": wave_mod.launches,
                "wave_expand": wave_mod.form_launches["pure"],
                "wave_expand_merge": wave_mod.form_launches["merge"],
                "wave_expand_shards": wave_mod.form_launches["shards"],
                "ring_all_gather": rag_mod.launches, "ring_cuda_launches": rag_mod.cuda_launches}

    def drive(path, run, kernels):
        """One path of the main path: counts to 0 just before, read just
        after; each named kernel form must have launched, and the ring made
        one CUDA launch per gather."""
        opc_mod.launches = wave_mod.launches = rag_mod.launches = rag_mod.cuda_launches = 0
        wave_mod.form_launches.update(dict.fromkeys(wave_mod.form_launches, 0))
        res = run()
        got = counts()
        emit({"phase": "main_path_launches", "path": path, **got})
        for name in kernels:
            if got[name] <= 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
        if got["ring_cuda_launches"] != got["ring_all_gather"]:
            raise AssertionError(f"the ring made {got['ring_cuda_launches']} CUDA launches in "
                                 f"{got['ring_all_gather']} gathers on the {path} path")
        return res, got

    pl, dense = drive("dense", lambda: (phase_hellocart(device),
                                        phase_power_law(device, dev["nvidia_smi"]))[1],
                      ("or_popcount", "wave_expand_merge"))
    sh, sharded = drive("sharded", lambda: phase_sharded(device, dev["nvidia_smi"], pl["level"]),
                        ("or_popcount", "wave_expand_shards", "ring_all_gather"))
    main_launches = {name: dense[name] + sharded[name] for name in dense}
    level = pl["level"]
    g, seeds = level["graph"], level["seeds"].tolist()
    calls = level["want_union"][2] + 1  # wave_expand calls per union wave
    phase_profile(device, "run_waves_union", lambda: g.run_waves_union([seeds]),
                  g.clear_invalid, calls)
    sg = sh.pop("ring_graph")
    phase_profile(device, "sharded run_wave (ring)", lambda: sg.run_wave(seeds),
                  sg.clear_invalid, calls, exchange="ring")
    kernels = phase_kernels(device, main_launches, level, sg, dev["nvidia_smi"])
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
