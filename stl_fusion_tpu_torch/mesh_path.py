"""Twin of ``perf/mesh_path.py``: the cluster-routed mesh wave at scale, its
async A/B, and the live routed pipeline with a reshard.

    from stl_fusion_tpu_torch.mesh_path import run_mesh
    record = run_mesh()                       # on the CUDA device
    record = run_mesh(device="cpu", static=dict(n=200_000, seeds=1_000))

Three legs, each with the script's gates (a failed gate is a string in the
record's ``violations``; ``ok`` is True when there is none):

1. :func:`run_static` — ``power_law_dag(MESH_NODES)`` (default 80M, 240M
   edges) as cluster-routed CSR shards (``DevicePlacement.build`` of a
   ``MESH_MEMBERS``-member, ``MESH_SHARDS``-shard map over ``n_dev`` logical
   shards, ``RoutedShardedGraph`` with ``MESH_EXCHANGE``), one untimed
   wave, then ``MESH_WAVES`` waves of ``MESH_SEEDS`` random seeds, each from
   a clear state; wave 0's mask must equal :func:`numpy_bfs_mask` exactly;
2. :func:`run_async_ab` — one graph (``MESH_AB_NODES``, seed 11) and seed
   schedule through a bulk-synchronous and an async routed graph
   (``MESH_ASYNC_DEPTH``): every wave's mask bit-identical across the two
   and to the host BFS, quiescence checks counted, and strictly fewer merge
   epochs than sync levels; the wall-clock delta feeds
   ``record_level_stall_ms``;
3. :func:`run_live` — a live stack with ``enable_mesh_routing``: an
   external RPC client subscribed through the fan-out's mesh scope, rounds
   of groups through ``WavePipeline(fuse_depth=4)``, each wave's count held
   against the host BFS, the chain-difference latency of shallow tail rows
   straight on the routed graph, the kill reshard (``with_members`` minus
   the last member, ``apply_mesh_reshard``, shards must move), waves after
   it; the gates ``eager_waves == 0``, ``fused_dispatches > 0``,
   ``fusion_mesh_routed_waves_total > 0`` and ``mesh_member_relays == 0``.
   Given ``ctx`` (a built live stack: ``backend``, ``block``, ``table``,
   ``svc``, ``n``) it runs on that stack; its host BFS then walks the
   graph's live edges (those whose captured epoch matches) from its invalid
   state, under the union rule.

The multihost leg (``MESH_MULTIHOST``, ``perf/mesh_multihost.py``) is cut
and listed in the record: it needs ``cluster/multihost.py`` (ROADMAP A.9,
third part) and real host processes. ``api`` runs every leg through another
package with this one's API (the parity tests pass the JAX package's).
"""
from __future__ import annotations

import asyncio
import importlib
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .device import resolve_device
from .graph.synthetic import power_law_dag

__all__ = ["MeshApi", "numpy_bfs_mask", "port_api", "run_async_ab", "run_live", "run_mesh",
           "run_static"]

#: the script's defaults
STATIC = dict(n=80_000_000, waves=2, seeds=100_000, exchange="a2a", members=4, shards=256)
ASYNC_AB = dict(n=120_000, waves=3, seeds=64, depth=4, exchange="a2a")
LIVE = dict(n=20_000, members=2, shards=64, exchange="a2a", hosts=1, async_depth=0,
            lat_samples=24, rounds=3, groups=4)
CUT = ("MESH_MULTIHOST multihost leg (cluster/multihost.py, ROADMAP A.9 third part; real "
       "host processes)",)


class MeshApi(NamedTuple):
    """What the legs need of a package: its name (the modules are imported
    from it), a mesh of ``n`` shards, the backend's extra arguments and a
    device sync."""

    package: str
    mesh: Callable[[int], Any]
    backend_kwargs: dict
    sync: Callable[[], None]
    name: str

    def mod(self, name: str):
        return importlib.import_module(f"{self.package}.{name}")


def port_api(device=None) -> MeshApi:
    """This package on ``device`` (``cuda`` unless given): ``n`` logical
    shards of one card."""
    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    from .parallel import graph_mesh

    return MeshApi("stl_fusion_tpu_torch", lambda n: graph_mesh(devices=[dev] * n),
                   {"device": dev}, sync, f"stl_fusion_tpu_torch on {dev}")


def numpy_bfs_mask(src, dst, n, seeds, invalid=None, live=None):
    """Vectorized host BFS closure — the oracle at any scale (a Python
    set-BFS at 80M nodes would dominate the run). ``invalid`` (rows already
    invalid, which block unless seeded) and ``live`` (the edges that may
    fire) default to none and all: the script's oracle. Each level walks
    only its frontier's out-edges (a CSR over ``src``; edges sorted by
    source, as ``power_law_dag`` makes them, need no sort), so a wave reads
    each edge once, not once a level."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if live is not None:
        src, dst = src[live], dst[live]
    if len(src) > 1 and not (src[1:] >= src[:-1]).all():
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=starts[1:])
    inv = np.zeros(n, dtype=bool) if invalid is None else np.asarray(invalid, bool).copy()
    frontier = np.unique(np.asarray(seeds, dtype=np.int64))
    inv[frontier] = True
    while frontier.size:
        lo, hi = starts[frontier], starts[frontier + 1]
        deg = hi - lo
        first = np.repeat(lo - (np.cumsum(deg) - deg), deg)
        d = dst[first + np.arange(int(deg.sum()), dtype=np.int64)]
        nxt = np.zeros(n, dtype=bool)
        nxt[d] = True
        nxt &= ~inv
        inv |= nxt
        frontier = np.flatnonzero(nxt)
    return inv


def run_static(api: MeshApi, n: int = STATIC["n"], waves: int = STATIC["waves"],
               seeds: int = STATIC["seeds"], exchange: str = STATIC["exchange"],
               members: int = STATIC["members"], shards: int = STATIC["shards"],
               n_dev: int = 8, edges=None, violations=None, keep_graph: bool = False) -> dict:
    """The north-star static leg: build, one untimed wave, ``waves`` timed
    waves of ``seeds`` seeds, wave 0's mask against the host BFS. With
    ``keep_graph`` the record's ``graph``, ``seed_sets`` and ``edges`` hold
    the routed graph (cleared), the seed ids and the edge arrays."""
    cluster, parallel = api.mod("cluster"), api.mod("parallel")
    violations = [] if violations is None else violations
    t0 = time.time()
    src, dst = edges if edges is not None else power_law_dag(n, avg_degree=3.0, seed=7)
    gen_s = time.time() - t0
    mesh = api.mesh(n_dev)
    smap = cluster.ShardMap.initial([f"m{i}" for i in range(members)], n_shards=shards)
    api.sync()
    t0 = time.time()
    placement = cluster.DevicePlacement.build(smap, n_dev, n)
    graph = parallel.RoutedShardedGraph(src, dst, n, placement, mesh=mesh, exchange=exchange)
    api.sync()
    build_s = time.time() - t0
    rng = np.random.default_rng(123)
    seed_sets = [rng.choice(n, size=seeds, replace=False) for _ in range(waves)]
    # one untimed wave, then the timed run: the graph re-consistent between
    # waves, every wave cascades (the bench convention)
    t0 = time.time()
    graph.run_wave_collect(seed_sets[0].tolist())
    api.sync()
    compile_s = time.time() - t0
    graph.clear_invalid()
    totals, wave_s, wave_levels = [], [], []
    levels0 = graph.levels_total
    mask = None
    t_run = time.time()
    for w in range(waves):
        lv = graph.levels_total
        t0 = time.time()
        c, _ids, _over = graph.run_wave_collect(seed_sets[w].tolist())
        api.sync()
        wave_s.append(time.time() - t0)
        wave_levels.append(graph.levels_total - lv)
        totals.append(int(c))
        if w == 0:
            mask = graph.invalid_mask()
        graph.clear_invalid()
    elapsed = time.time() - t_run
    levels = graph.levels_total - levels0
    t0 = time.time()
    want = numpy_bfs_mask(src, dst, n, seed_sets[0])
    oracle_s = time.time() - t0
    oracle_exact = bool(np.array_equal(mask, want))
    if not oracle_exact:
        violations.append(f"static oracle divergence ({int((mask != want).sum())} nodes)")
    total = int(sum(totals))
    rec = {
        "nodes": n, "edges": int(len(src)), "mesh_devices": n_dev, "members": members,
        "shards": shards, "exchange": exchange, "waves": waves, "seeds_per_wave": seeds,
        "total_invalidated": total, "wave_totals": totals,
        "inv_per_s": total / max(elapsed, 1e-9), "wave_s": wave_s,
        "wave_levels": wave_levels, "exchange_levels": int(levels),
        "oracle_exact": oracle_exact, "oracle_s": oracle_s, "build_s": build_s,
        "compile_s": compile_s, "gen_s": gen_s, "stats": graph.stats(),
        "vs_single_device_10m": n / 10_000_000,
    }
    if keep_graph:
        rec["graph"], rec["seed_sets"], rec["edges"] = graph, seed_sets, (src, dst)
    return rec


def run_async_ab(api: MeshApi, n: int = ASYNC_AB["n"], waves: int = ASYNC_AB["waves"],
                 seeds: int = ASYNC_AB["seeds"], depth: int = ASYNC_AB["depth"],
                 exchange: str = ASYNC_AB["exchange"], n_dev: int = 8,
                 violations=None, keep_graph: bool = False) -> dict:
    """One graph, one seed schedule, two routed builds — bulk-synchronous
    and async (``depth`` speculative levels between merges): every wave
    bit-identical across the two and to the host BFS, with strictly fewer
    merge epochs than sync levels. With ``keep_graph`` the record's
    ``graph``, ``seed_sets`` and ``edges`` hold the async graph (cleared),
    the seed ids and the edge arrays."""
    cluster, parallel = api.mod("cluster"), api.mod("parallel")
    record_level_stall_ms = api.mod("parallel.routed_wave").record_level_stall_ms
    global_mesh_trace = api.mod("diagnostics.mesh_telemetry").global_mesh_trace
    violations = [] if violations is None else violations
    src, dst = power_law_dag(n, avg_degree=3.0, seed=11)
    mesh = api.mesh(n_dev)
    smap = cluster.ShardMap.initial([f"m{i}" for i in range(4)], n_shards=64)
    placement = cluster.DevicePlacement.build(smap, n_dev, n)
    rng = np.random.default_rng(321)
    seed_sets = [rng.choice(n, size=seeds, replace=False).tolist() for _ in range(waves)]

    def burst(async_mode: bool):
        g = parallel.RoutedShardedGraph(src, dst, n, placement, mesh=mesh, exchange=exchange,
                                        exchange_async=async_mode, async_depth=depth)
        g.run_wave_collect(seed_sets[0])  # untimed
        g.clear_invalid()
        levels0 = g.levels_total
        masks, totals = [], 0
        api.sync()
        t0 = time.time()
        for s in seed_sets:
            c, _ids, _over = g.run_wave_collect(s)
            totals += int(c)
            masks.append(g.invalid_mask())
            g.clear_invalid()
        api.sync()
        return g, masks, totals, g.levels_total - levels0, time.time() - t0

    g_sync, m_sync, tot_sync, lv_sync, wall_sync = burst(False)
    g_async, m_async, tot_async, lv_async, wall_async = burst(True)
    divergence = 0
    for w, (a, s) in enumerate(zip(m_async, m_sync)):
        want = numpy_bfs_mask(src, dst, n, seed_sets[w])
        if not np.array_equal(a, s):
            divergence += 1
            violations.append(f"async wave {w} diverged from sync at {int((a != s).sum())} node(s)")
        elif not np.array_equal(a, want):
            divergence += 1
            violations.append(
                f"async wave {w} diverged from host BFS at {int((a != want).sum())} node(s)")
    if g_async.quiescence_checks == 0:
        violations.append("async graph ran zero quiescence checks (uncounted fallback to sync)")
    reclaimed = lv_sync - lv_async
    if reclaimed <= 0:
        violations.append(f"async reclaimed zero exchange barriers (sync {lv_sync} vs async "
                          f"{lv_async} merge epochs)")
    stall_ms = max(wall_sync - wall_async, 0.0) * 1e3
    record_level_stall_ms(stall_ms, cause=g_async.last_trace_cause)
    stitched = (global_mesh_trace().stitch(g_async.last_trace_cause)
                if g_async.last_trace_cause else None)
    if stitched is None or not stitched["levels"]:
        violations.append("async A/B recorded no stitched wave timeline (trace hooks dark)")
    rec = {
        "nodes": n, "waves": waves, "async_depth": depth, "exchange": exchange,
        "oracle_exact": divergence == 0, "sync_levels": lv_sync,
        "async_merge_epochs": lv_async, "levels_reclaimed": reclaimed,
        "quiescence_checks": g_async.quiescence_checks,
        "spec_levels_total": g_async.spec_levels_total, "level_stall_ms": stall_ms,
        "sync_wall_s": wall_sync, "async_wall_s": wall_async,
        "sync_inv_per_s": tot_sync / max(wall_sync, 1e-9),
        "async_inv_per_s": tot_async / max(wall_async, 1e-9),
        "totals": [tot_sync, tot_async],
    }
    if keep_graph:
        rec["graph"], rec["seed_sets"], rec["edges"] = g_async, seed_sets, (src, dst)
    return rec


def build_live_stack(api: MeshApi, n: int) -> dict:
    """The script's live stack on a fresh default hub: a table-backed
    service of ``n`` rows bound as one block over ``power_law_dag(n, 3,
    seed=23)``, every row read."""
    core, graph = api.mod("core"), api.mod("graph")
    src, dst = power_law_dag(n, avg_degree=3.0, seed=23)
    hub = core.FusionHub()
    old = core.set_default_hub(hub)
    backend = graph.TpuGraphBackend(hub, node_capacity=n + 16, edge_capacity=len(src) + 4096,
                                    **api.backend_kwargs)

    class RowSvc(core.ComputeService):
        def load(self, ids):
            return np.asarray(ids, dtype=np.float32)

        @core.compute_method(table=core.TableBacking(rows=n, batch="load"))
        async def row(self, i: int) -> float:
            return float(i)

    svc = RowSvc(hub)
    hub.add_service(svc)
    table = core.memo_table_of(svc.row)
    block = backend.bind_table_rows(table)
    backend.declare_row_edges(block, src, block, dst)
    table.read_batch(np.arange(n))
    backend.flush()
    return {"backend": backend, "block": block, "table": table, "svc": svc, "n": n,
            "hub": hub, "read": "row", "old_hub": old}


class _Oracle:
    """The host BFS a live leg holds each wave against: the graph's live
    edges (captured epoch == the destination's epoch) from the invalid
    state it tracks (the union rule: seeds conduct, invalid rows block)."""

    def __init__(self, backend):
        dg = backend.graph
        m = dg.n_edges
        self.n = dg.n_nodes
        self.src = dg._h_edge_src[:m].astype(np.int64)
        self.dst = dg._h_edge_dst[:m].astype(np.int64)
        ok = (self.src < self.n) & (self.dst < self.n)
        ok &= dg._h_edge_dst_epoch[:m] == dg._h_node_epoch[np.minimum(self.dst, self.n - 1)]
        self.src, self.dst = self.src[ok], self.dst[ok]
        self.inv = np.asarray(dg.invalid_mask()[: self.n], dtype=bool).copy()

    def wave(self, seeds) -> int:
        after = numpy_bfs_mask(self.src, self.dst, self.n, seeds, invalid=self.inv)
        count = int((after & ~self.inv).sum())
        self.inv = after
        return count


async def run_live(api: MeshApi, ctx: Optional[dict] = None, n: int = LIVE["n"],
                   members: int = LIVE["members"], shards: int = LIVE["shards"],
                   exchange: str = LIVE["exchange"], hosts: int = LIVE["hosts"],
                   async_depth: int = LIVE["async_depth"],
                   lat_samples: int = LIVE["lat_samples"], rounds: int = LIVE["rounds"],
                   groups: int = LIVE["groups"], n_dev: int = 8, violations=None,
                   mesh=None, after_reshard: Optional[Callable] = None) -> dict:
    """The live smoke leg: fused routed chains through the pipeline, the
    chain-difference latency, a reshard that moves device shards, waves
    after it, and the gates. ``ctx`` runs it on a built stack (else the
    script's 20,000-row stack is built); ``after_reshard(ctx, pipe)`` runs
    once the post-reshard waves are exact."""
    core = api.mod("core")
    cluster, client_mod, rpc = api.mod("cluster"), api.mod("client"), api.mod("rpc")
    global_metrics = api.mod("diagnostics.metrics").global_metrics
    WavePipeline = api.mod("graph.nonblocking").WavePipeline
    install_compute_fanout = api.mod("rpc.fanout").install_compute_fanout
    RpcTestTransport = api.mod("rpc.testing").RpcTestTransport
    global_mesh_trace = api.mod("diagnostics.mesh_telemetry").global_mesh_trace
    violations = [] if violations is None else violations
    own = ctx is None
    if own:
        ctx = build_live_stack(api, n)
    backend, block, svc, ns = ctx["backend"], ctx["block"], ctx["svc"], ctx["n"]
    member_ids = [f"m{i}" for i in range(members)]
    snap0 = global_metrics().snapshot()
    try:
        smap = cluster.ShardMap.initial(member_ids, n_shards=shards)
        mesh = mesh if mesh is not None else api.mesh(n_dev)
        t0 = time.time()
        backend.enable_mesh_routing(
            smap, mesh=mesh, exchange=exchange,
            devices_per_host=(n_dev // hosts) if hosts > 1 else None,
            exchange_async=async_depth > 0, async_depth=async_depth,
        )
        backend.flush()
        oracle = ctx["mesh_oracle"] = _Oracle(backend)
        # an EXTERNAL client subscribed over RPC: its fences legitimately
        # ride the relay; the gate is that no ON-MESH member's do
        server_rpc = rpc.RpcHub("server")
        client_rpc = rpc.RpcHub("client")
        client_mod.install_compute_call_type(server_rpc)
        client_mod.install_compute_call_type(client_rpc)
        server_rpc.add_service("rows", svc)
        fanout = install_compute_fanout(server_rpc, backend)
        fanout.set_mesh_scope(member_ids, cluster_members=member_ids)
        RpcTestTransport(client_rpc, server_rpc)
        client = client_mod.compute_client("rows", client_rpc, core.FusionHub())
        read = getattr(client, ctx.get("read", "row"))
        dg = backend.graph
        sub_row = int(dg._h_edge_dst[0]) - block.base
        await read(sub_row)
        # the routed mirror builds on the first routed wave (timed apart)
        t_b = time.time()
        backend.routed_mirror()
        api.sync()
        mirror_build_s = time.time() - t_b

        pipe = WavePipeline(backend, fuse_depth=4)
        rng = np.random.default_rng(5)
        divergence = 0
        wave_counts = []

        def check(group_rows, tickets):
            nonlocal divergence
            for g, t in zip(group_rows, tickets):
                want = oracle.wave([block.base + r for r in g])
                wave_counts.append(int(t.count))
                if t.count != want:
                    divergence += 1

        t0 = time.time()
        for r in range(rounds):
            grp = [rng.choice(ns, size=3, replace=False).tolist() for _ in range(groups)]
            if r == 0:
                # the external client's key: its fence must ride the
                # ordinary relay while the members' frontier stays on-device
                grp[0].append(sub_row)
            tickets = [pipe.submit_rows(block, g) for g in grp]
            pipe.drain()
            await asyncio.sleep(0)  # let fence posts flush
            check(grp, tickets)
        api.sync()
        burst_s = time.time() - t0

        # chain-difference wave_chain latency (shallow tail rows, straight
        # on the routed graph)
        r_short, r_long = 2, 10

        def shallow(k):
            return [[int(block.base + ns - 1 - x)]
                    for x in rng.choice(ns // 50, size=k, replace=False)]

        entry = backend.routed_mirror()
        g = entry["graph"]
        for r in (r_short, r_long):
            g.harvest_union_chain(g.dispatch_union_chain(shallow(r)))
        samples = []
        for _ in range(lat_samples):
            t1 = time.perf_counter()
            g.harvest_union_chain(g.dispatch_union_chain(shallow(r_short)))
            t_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            g.harvest_union_chain(g.dispatch_union_chain(shallow(r_long)))
            t_l = time.perf_counter() - t1
            samples.append((t_l - t_s) / (r_long - r_short) * 1e3)
        arr = np.asarray(samples)
        pos = arr[arr > 0]
        rejects = int((arr <= 0).sum())
        # the latency chains advanced the routed invalid state outside the
        # backend's bookkeeping; reset BOTH sides and the oracle's memory
        backend.graph.clear_invalid()
        entry.pop("invalid_version", None)
        oracle.inv[:] = False

        # mid-burst reshard: kill the last member -> device shards MOVE
        new_map = smap.with_members(member_ids[:-1])
        t1 = time.perf_counter()
        moves = backend.apply_mesh_reshard(new_map)
        api.sync()
        reshard_ms = (time.perf_counter() - t1) * 1e3
        post = [rng.choice(ns, size=3, replace=False).tolist() for _ in range(3)]
        tickets = [pipe.submit_rows(block, gr) for gr in post]
        pipe.drain()
        check(post, tickets)
        if after_reshard is not None:
            after_reshard(ctx, pipe)
        stats = pipe.stats()
        pipe.dispose()

        snap = global_metrics().snapshot()
        routed_waves = int(snap.get("fusion_mesh_routed_waves_total", 0)
                           - snap0.get("fusion_mesh_routed_waves_total", 0))
        levels_total = int(snap.get("fusion_mesh_exchange_levels_total", 0)
                           - snap0.get("fusion_mesh_exchange_levels_total", 0))
        if divergence:
            violations.append(f"live oracle divergence in {divergence} wave(s)")
        if stats["eager_waves"] or not stats["fused_dispatches"]:
            violations.append(f"pipeline disengaged from the fused routed path: {stats}")
        if routed_waves == 0:
            violations.append("fusion_mesh_routed_waves_total == 0")
        if fanout.mesh_member_relays:
            violations.append(f"{fanout.mesh_member_relays} frontier fence(s) re-entered via "
                              f"host RPC for on-mesh members")
        if moves == 0:
            violations.append("reshard moved zero device shards")
        rg = backend._routed_mirror["graph"]
        if async_depth > 0 and rg.quiescence_checks == 0:
            violations.append("live async ran zero quiescence checks (uncounted fallback to sync)")
        live_cause = rg.last_trace_cause or global_mesh_trace().latest_cause()
        live_trace = global_mesh_trace().stitch(live_cause) if live_cause else None
        if live_trace is None:
            violations.append("live leg recorded no wave trace segments (stitch hooks dark)")
        out = {
            "nodes": ns, "members": members, "rounds": rounds, "burst_s": burst_s,
            "mirror_build_s": mirror_build_s, "pipeline": stats, "routed_waves": routed_waves,
            "exchange_levels": levels_total, "wave_counts": wave_counts,
            "wave_chain_ms_p50": float(np.percentile(pos, 50)) if len(pos) else None,
            "wave_chain_ms_p99": float(np.percentile(pos, 99)) if len(pos) else None,
            "wave_chain_rejects": rejects, "reshard_moves": int(moves),
            "reshard_epoch": new_map.epoch, "reshard_ms": reshard_ms,
            "oracle_divergence": divergence, "external_client_fences": fanout.drained_total,
            "mesh_member_relays": fanout.mesh_member_relays,
            "dcn_fallback_relays": fanout.dcn_fallback_relays, "async_depth": async_depth,
            "quiescence_checks": rg.quiescence_checks, "routed_stats": rg.stats(),
            "trace_levels": len(live_trace["levels"]) if live_trace else 0,
        }
        await server_rpc.stop()
        await client_rpc.stop()
        return out
    finally:
        if own:
            core.set_default_hub(ctx["old_hub"])


def run_mesh(device=None, api: Optional[MeshApi] = None, static: Optional[dict] = None,
             async_ab: Optional[dict] = None, live: Optional[dict] = None,
             skip_static: bool = False, run_async: bool = False,
             skip_live: bool = False) -> dict:
    """The script's ``main``: the legs it runs by default (``MESH_ASYNC=1``
    is ``run_async``), each with its keyword overrides; returns the record
    with ``violations`` and ``ok``."""
    api = api if api is not None else port_api(device)
    out: dict = {"metric": "mesh_path", "api": api.name, "violations": [], "cut": list(CUT)}
    if not skip_static:
        out["static"] = run_static(api, violations=out["violations"], **(static or {}))
    if run_async:
        out["async_ab"] = run_async_ab(api, violations=out["violations"], **(async_ab or {}))
    if not skip_live:
        out["live"] = asyncio.run(run_live(api, violations=out["violations"], **(live or {})))
    out["ok"] = not out["violations"]
    return out
