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
   oracle on a src-sorted CSR;
5. ``sharded_10m`` — the same graph and epochs as a ``ShardedDeviceGraph``
   on a mesh of 8 logical shards on the card: the 100,000-seed ``run_wave``
   with ``exchange="ring"`` (the ring all-gather kernel), ``"packed"`` and
   ``"bool"``, and ``run_wave_collect`` from the 256 shallow seeds, each held
   EXACTLY against the same oracle;
6. ``profile`` — ``torch.profiler`` over one more 10M union wave: device
   time by kernel and the device's idle share;
7. ``kernels``  — each kernel against its plain PyTorch version on the card,
   exact, with its time (CUDA events), the plain version's time, the time
   of one PyTorch call computing the same function where there is one, and
   the bound for the same work.

The main path is two paths, each driven with every kernel's launch count
set to 0 just before it and read just after: phases 3-4 (the dense wave)
must launch ``or_popcount`` and ``wave_expand``, phase 5 (the sharded wave)
those two and ``ring_all_gather``. Any failure raises and the script exits
non-zero. The last lines are the kernel summary, the
``nvidia-smi`` name and power limit, and
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

    def wave(self, seeds):
        """From an all-valid state: (sorted newly ids, count, depth)."""
        import numpy as np

        invalid = np.zeros(self.n, bool)
        frontier = np.unique(np.asarray(seeds, np.int64))
        invalid[frontier] = True
        count, depth = len(frontier), 0
        while True:
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

    union_seeds = rng.choice(n, n_seeds, replace=False)
    (count, ids), ms = timed(lambda: g.run_waves_union([union_seeds.tolist()]))
    want = want_union = oracle.wave(union_seeds)
    check("run_waves_union", count, ids, want)
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
    from stl_fusion_tpu_torch.ops import or_popcount as opc_mod
    from stl_fusion_tpu_torch.ops import wave as wave_mod

    out["launches_so_far"] = {"or_popcount": opc_mod.launches, "wave_expand": wave_mod.launches}
    emit(out)
    # the first level of the union wave, for the kernel comparison
    g.clear_invalid()
    ga = g.device_arrays()
    deg = oracle.start[union_seeds + 1] - oracle.start[union_seeds]
    out["level"] = {"graph": g, "ga": ga, "seeds": union_seeds,
                    "active_edges": int(deg.sum()),
                    "active_dsts": int(np.unique(oracle.dst[oracle.out_edges(union_seeds)]).size),
                    # for the sharded phase: the same graph, epochs and seeds
                    "src": src, "dst": dst, "node_epoch": node_epoch, "n": n,
                    "shallow": shallow, "want_union": want_union, "want_shallow": want_shallow}
    return out


def phase_sharded(device, card: str, level: dict) -> dict:
    """The 10M graph and epochs of ``power_law_10m`` on a mesh of 8 logical
    shards on the card, one ``ShardedDeviceGraph`` per exchange."""
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import ring_all_gather as rag
    from stl_fusion_tpu_torch.parallel import ShardedDeviceGraph, graph_mesh

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
            ring0 = rag.launches
            count, ms = timed(lambda: sg.run_wave(seeds))
            check(f"{exchange} run_wave ({run})", count,
                  np.nonzero(sg.invalid_mask())[0], want_union, sg.last_levels)
            rec[f"wave_ms_{run}"] = ms
            rec[f"ring_launches_{run}"] = rag.launches - ring0
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
    # the ring's input at the main path's shape: each shard's words of the
    # collect wave's state
    out["ring_chunks"] = [inv[: sg.n_local // 32].clone() for inv in sg.g.invalid]
    out["ring_graph"] = sg
    return out


def profile_device(device, fn) -> tuple:
    """``fn()`` under ``torch.profiler``: (wall ms, device time by kernel
    name as {name: {"ms", "calls"}})."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync(device)
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.key.startswith("aten::"):
            continue  # a CPU op's device time is its kernels', listed on their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            by_name[ev.key[:80]] = {"ms": dev_us / 1e3, "calls": ev.count}
    return wall_ms, by_name


def phase_profile(device, wave: str, run, reset) -> dict:
    """Where one 10M-node wave's time goes: ``torch.profiler`` over the same
    wave as the main path's, from a cleared state after a warm-up; device
    time by kernel and the device's idle share."""
    reset()
    run()  # warm-up
    reset()
    wall_ms, by_name = profile_device(device, run)
    device_ms = sum(v["ms"] for v in by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:12])
    out = {"phase": "profile", "wave": wave, "wall_ms": wall_ms,
           "device_ms": device_ms, "idle_share": 1 - device_ms / wall_ms, "by_kernel": top}
    emit(out)
    return out


def phase_kernels(device, main_launches: dict, level: dict, ring_chunks: list, card: str) -> list:
    import numpy as np
    import torch

    from stl_fusion_tpu_torch.ops import wave as tw
    from stl_fusion_tpu_torch.ops.bitops import pack_bits
    from stl_fusion_tpu_torch.ops.or_popcount import or_popcount, or_popcount_plain

    rng = np.random.default_rng(1)
    # or_popcount: random words with negative ones and ragged (non-x4) tails
    cases, err = [], 0
    for n in (7, 128, 40000, 524289):
        new = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32)).to(device)
        old = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32)).to(device)
        want_m, want_c = or_popcount_plain(new, old)
        got_m, got_c = or_popcount(new, old)
        inplace = old.clone()
        in_m, in_c = or_popcount(new, inplace, out=inplace)
        e = max(int((got_m.long() - want_m.long()).abs().max()) if n else 0,
                int((in_m.long() - want_m.long()).abs().max()) if n else 0,
                abs(int(got_c) - int(want_c)), abs(int(in_c) - int(want_c)))
        if e:
            raise AssertionError(f"or_popcount differs from its plain version at n={n}")
        err = max(err, e)
        cases.append(n)
    n = level["ga"].invalid.shape[0]  # the main path's word count (524,289 at 10M)
    new = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32)).to(device)
    old = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32)).to(device)
    b_ms, b_by = bound_ms(12 * n + 8, 4 * n)
    opc = {"name": "or_popcount", "route": "cuda",
           "source": "stl_fusion_tpu_torch/csrc/or_popcount.cu",
           "replaces": "stl_fusion_tpu/ops/pallas_kernels.py:47",
           "launches": main_launches["or_popcount"], "max_abs_err": err,
           "ms": time_ms(lambda: or_popcount(new, old), device),
           "plain_ms": time_ms(lambda: or_popcount_plain(new, old), device),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "shape": f"int32[{n}] x2", "checked_n": cases}

    # wave_expand: the first level of the 10M union wave
    ga = level["ga"]
    frontier = tw.seeds_to_frontier(ga.n_cap, torch.from_numpy(level["seeds"].astype(np.int32)).to(device))
    fw = pack_bits(frontier)
    iw = fw.clone()
    es, ed, ee = ga.live_edges()
    args = (fw, iw, ga.node_epoch, es, ed, ee)

    def expand():  # as the wave calls it: with the graph's source-id bound
        return tw.wave_expand(*args, n_src=ga.n_cap + 1)

    want = tw.wave_expand_plain(*args)
    got = tw.wave_expand(*args)
    e = int((got.long() - want.long()).abs().max())
    if e:
        raise AssertionError("wave_expand differs from its plain version on a 10M level")
    n_e, a, u, w = es.shape[0], level["active_edges"], level["active_dsts"], fw.shape[0]
    b_ms, b_by = bound_ms(4 * n_e + 8 * a + 4 * u + 12 * w, n_e + 3 * a)
    wex = {"name": "wave_expand", "route": "cuda",
           "source": "stl_fusion_tpu_torch/csrc/wave_expand.cu",
           "replaces": "stl_fusion_tpu/ops/wave.py:80 (XLA wave_step; no Pallas kernel)",
           "launches": main_launches["wave_expand"], "max_abs_err": e,
           "ms": time_ms(expand, device),
           "plain_ms": time_ms(lambda: tw.wave_expand_plain(*args), device, reps=5),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "shape": f"{n_e} live edges, {a} from the frontier, {w} words"}

    # ring_all_gather: 8 shards x 39,063 words, the sharded 10M wave's shape
    from stl_fusion_tpu_torch.ops import ring_all_gather as rag

    got = rag.ring_all_gather(ring_chunks)
    want = rag.ring_all_gather_plain(ring_chunks)
    full = torch.cat(ring_chunks)
    e = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    if e or any(not torch.equal(a, full) for a in got):
        raise AssertionError("ring_all_gather differs from its plain version")
    n_sh, c = len(ring_chunks), ring_chunks[0].shape[0]
    b_ms, b_by = bound_ms(4 * n_sh * c + 4 * n_sh * n_sh * c, 0)
    ring = {"name": "ring_all_gather", "route": "cuda",
            "source": "stl_fusion_tpu_torch/csrc/ring_all_gather.cu",
            "replaces": "stl_fusion_tpu/ops/pallas_kernels.py:103",
            "launches": main_launches["ring_all_gather"], "max_abs_err": e,
            "ms": time_ms(lambda: rag.ring_all_gather(ring_chunks), device),
            "plain_ms": time_ms(lambda: rag.ring_all_gather_plain(ring_chunks), device),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.cat(ring_chunks), device),
            "shape": f"{n_sh} shards x int32[{c}]"}
    # device time alone (torch.profiler): tells launch- or host-bound calls
    # from slow kernels, since CUDA events over back-to-back calls also time
    # the host's enqueue when it is the slower side
    for k, fn, symbol in ((opc, lambda: or_popcount(new, old), "or_popcount_kernel"),
                          (wex, expand, "wave_expand_kernel"),
                          (ring, lambda: rag.ring_all_gather(ring_chunks), "ring_step_kernel")):
        reps = 20
        _, by_name = profile_device(device, lambda: [fn() for _ in range(reps)])
        k["device_ms"] = sum(v["ms"] for name, v in by_name.items() if symbol in name) / reps
    emit({"phase": "kernels", "card": card,
          "kernels": [{**k, "kernel_ms": k["ms"]} for k in (opc, wex, ring)]})
    return [opc, wex, ring]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    from stl_fusion_tpu_torch.ops import or_popcount as opc_mod
    from stl_fusion_tpu_torch.ops import ring_all_gather as rag_mod
    from stl_fusion_tpu_torch.ops import wave as wave_mod

    mods = {"or_popcount": opc_mod, "wave_expand": wave_mod, "ring_all_gather": rag_mod}
    device = torch.device("cuda")
    dev = phase_device()
    phase_build()

    def drive(path, run, kernels):
        """One path of the main path: counts to 0 just before, read just
        after; each named kernel must have launched."""
        for mod in mods.values():
            mod.launches = 0
        res = run()
        counts = {name: mod.launches for name, mod in mods.items()}
        emit({"phase": "main_path_launches", "path": path, **counts})
        for name in kernels:
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
        return res, counts

    pl, dense = drive("dense", lambda: (phase_hellocart(device),
                                        phase_power_law(device, dev["nvidia_smi"]))[1],
                      ("or_popcount", "wave_expand"))
    sh, sharded = drive("sharded", lambda: phase_sharded(device, dev["nvidia_smi"], pl["level"]),
                        ("or_popcount", "wave_expand", "ring_all_gather"))
    main_launches = {name: dense[name] + sharded[name] for name in mods}
    g, seeds = pl["level"]["graph"], pl["level"]["seeds"].tolist()
    phase_profile(device, "run_waves_union", lambda: g.run_waves_union([seeds]), g.clear_invalid)
    sg = sh.pop("ring_graph")
    phase_profile(device, "sharded run_wave (ring)", lambda: sg.run_wave(seeds), sg.clear_invalid)
    del sg
    kernels = phase_kernels(device, main_launches, pl["level"], sh["ring_chunks"],
                            dev["nvidia_smi"])
    print(json.dumps({"kernels": [{k: v for k, v in kr.items()
                                   if k not in ("shape", "checked_n", "device_ms")}
                                  for kr in kernels]}))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
