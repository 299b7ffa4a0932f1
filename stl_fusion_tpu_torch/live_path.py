"""Twin of ``perf/live_path.py``'s live loops on the card: the super-round
loop (its default, ``LIVE_NONBLOCKING=1 LIVE_SUPER_ROUNDS=1``), the
burst→refresh chain loop (``LIVE_SUPER_ROUNDS=0``) and the blocking loop
(``LIVE_NONBLOCKING=0``).

    from stl_fusion_tpu_torch.live_path import run_live
    record = run_live()                 # 10M rows on the CUDA device, super-rounds
    record = run_live(nonblocking=False)                # the blocking loop
    record = run_live(loops=[("blocking", 6), ("superround", 6), ("chain", 3)])

The live path builds its graph through the framework's bulk ingest and
drives it under churn, all through the public API: a table-backed service
(``DagTable``: row ``i`` is ``base[i]``, with the device loader
``load_dev(ids, base_dev) = base_dev[ids]``) binds its key space as one row
block (``bind_table_rows``), declares the edges of ``power_law_dag(n, 3,
seed=7)`` in bulk (``declare_row_edges``), warms every row on the device
(``warm_block_on_device``) and builds the topo mirror. Then, untimed, one
union burst (its stale rows refreshed through ``read_batch``), the lone
waves (``cascade_rows_batch(block, [row])`` on tail rows, the lat mirror's
shape), one ``cascade_rows_batch_seq`` of 8 single-row batches and one lane
burst, each followed by ``refresh_block_on_device``. Then per round: the
churn (``make_churn_edges`` declarations, oriented from the lower mirror
level to the higher with one level-violating edge in the run, plus scalar
recomputes of adopted rows), ``flush``, ``refresh_block_on_device`` (every
stale row through the device loader and the ``block_refresh`` kernel) and a
``lane_groups``-group ``cascade_rows_lanes`` burst; a background re-level is
started once 3 violations stack up, and installed when it finishes.

The nonblocking loops run ``fuse_depth`` (``LIVE_FUSE_DEPTH=3``) rounds per
super-round, after untimed warm super-rounds (one per depth the loop uses,
``cold_start.programs`` records them). The super-round loop
(``enable_super_rounds``) stages the next super-round's seeds and preps its
churn (journal only) while the previous one runs, harvests it (the fence
drain), flushes, refreshes and dispatches: one program per super-round, on
the card one CUDA graph replay. The chain loop dispatches
``cascade_rows_lanes_refresh_chain(nonblocking=True)`` in the same cadence.
``loops`` runs several loops one after another on one built stack. A
blocking loop may name its burst (the port's own option, not
``perf/live_path.py``'s): ``("blocking", rounds, burst)`` calls
``burst(backend, block, group_ids)`` in place of ``cascade_rows_lanes``,
for example ``cascade_rows_lanes_sharded`` on a mesh.

Defaults are ``perf/live_path.py``'s (``LIVE_DEG=3``, ``LIVE_ROUNDS=6``,
``LIVE_LANE_GROUPS=512``, ``LIVE_LANE_SEEDS=8``, ``LIVE_EDGE_CHURN=2000``,
``LIVE_SCALAR_CHURN=4``, ``LIVE_LAT_WAVES=32``) at ``bench.py``'s
``FUSION_BENCH_LIVE_NODES=10_000_000``. Cut, and listed in the record:
the scalar-build micro-metric (``LIVE_SCALAR_NODES``), the chain-difference lone-wave estimator and the relay round-trip
subtraction (there is no relay: each lone wave is timed on the host clock,
synchronised), and the multi-pass program warms (nothing compiles here).

:func:`run_live` returns the record with ``perf/live_path.py``'s keys where
they apply (``build_s``, ``mirror_build_s``, ``live_inv_per_s``,
``live_wave_ms_p50``/``_p99``, ``mirror_patches``, ``live_superround_*``,
``live_fused_chain_dispatches``, ...) and the per-round refresh and burst
ms (per super-round the host split and device ms); it prints nothing.
``api`` runs the same loop through another package with this one's API
(the parity tests pass the JAX package's modules); ``observer`` receives
the loop's state at fixed points, for callers that also check results.
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .graph.program_cache import program_warm_report
from .graph.synthetic import power_law_dag

__all__ = ["LiveApi", "port_api", "run_live"]

N_NODES = 10_000_000
GRAPH_SEED = 7
LOOP_SEED = 123
SEQ_WAVES = 8
CUT = (
    "LIVE_SCALAR_NODES scalar-build micro-metric",
    "chain-difference lone-wave estimator and relay-RTT subtraction (no relay)",
    "multi-pass program warms (nothing compiles)",
    "program_cache_stats of the restore leg (a JAX compile cache; nothing compiles here)",
)
#: loop modes: the blocking loop, the super-round loop, the chain loop
MODES = ("blocking", "superround", "chain")


class LiveApi(NamedTuple):
    """What the loop needs of a package: its ``core`` and ``graph``
    modules, the backend's extra arguments, a numpy → device-array
    conversion for the loader's base table, and a device sync."""

    core: Any
    graph: Any
    backend_kwargs: dict
    to_device: Callable[[np.ndarray], Any]
    sync: Callable[[], None]
    name: str
    #: the package's ``checkpoint`` module, for the restore leg
    checkpoint: Any = None


def port_api(device=None) -> LiveApi:
    """This package on ``device`` (``cuda`` unless given)."""
    from . import checkpoint, core, graph

    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return LiveApi(core, graph, {"device": dev},
                   lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), sync,
                   f"stl_fusion_tpu_torch on {dev}", checkpoint)


def make_dag_service(core, n: int, to_device):
    """``perf/live_path.py``'s ``DagTable``: row ``i``'s value is ``base[i]``,
    loaded on the host by ``load`` and on the device by ``load_dev``."""

    class DagTable(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.base = np.arange(n, dtype=np.float32)
            self._base_dev = None

        def load(self, ids):
            return self.base[np.asarray(ids, dtype=np.int64)]

        def load_dev(self, ids, base_dev):
            return base_dev[ids]

        def load_dev_args(self):
            if self._base_dev is None:
                self._base_dev = to_device(self.base)
            return (self._base_dev,)

        @core.compute_method(
            table=core.TableBacking(rows=n, batch="load", device_batch="load_dev",
                                    device_args="load_dev_args")
        )
        async def node(self, i: int) -> float:
            return float(self.base[i])

    return DagTable


def _notify(observer, event: str, *args) -> float:
    """Call ``observer.<event>(*args)`` if it exists; returns its seconds."""
    fn = getattr(observer, event, None) if observer is not None else None
    if fn is None:
        return 0.0
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def run_live(n_nodes: int = N_NODES, deg: float = 3, rounds: int = 6, lane_groups: int = 512,
             lane_seeds: int = 8, edge_churn: int = 2000, scalar_churn: int = 4,
             lat_waves: int = 32, edges=None, device=None, api: Optional[LiveApi] = None,
             observer=None, nonblocking: bool = True, super_rounds: bool = True,
             fuse_depth: int = 3, loops: Optional[Sequence[tuple]] = None,
             snapshot_path: Optional[str] = None, live_async: bool = False) -> dict:
    """Build the live stack once, run its loop and return the record.
    ``nonblocking`` and ``super_rounds`` (``LIVE_NONBLOCKING``,
    ``LIVE_SUPER_ROUNDS``, both on by default as in ``perf/live_path.py``)
    pick the loop: the super-round loop, the chain loop, or the blocking
    loop; ``fuse_depth`` (``LIVE_FUSE_DEPTH``) is the rounds per
    super-round, capped at ``rounds``. ``loops``, a list of ``(mode,
    rounds)`` with modes from :data:`MODES`, runs several loops one after
    another on the same stack instead; the record then holds the first
    loop's keys and ``loops``, one record per loop. A blocking loop may be
    ``("blocking", rounds, burst)``: its bursts are ``burst(backend, block,
    group_ids)``, which returns the per-group counts. ``edges`` (src, dst)
    replaces the generated ``power_law_dag(n_nodes, deg, 7)``.

    After the loops the durable-restart leg runs (``LIVE_RESTORE``, on by
    default in ``perf/live_path.py``) when ``api`` has a ``checkpoint``
    module, as :func:`port_api` does: ``save_graph`` of the live device
    graph to a temporary ``.npz``, then ``load_graph`` of it on the
    backend's device, timed; the record gains ``snapshot_save_s``,
    ``restore_s`` and ``snapshot_bytes`` (None without the leg). Given
    ``snapshot_path``, the leg writes the snapshot there and leaves it, so a
    caller can load the graph as it stood when the loops ended.

    ``observer`` methods, each optional, are called with a context dict
    (``backend``, ``block``, ``table``, ``svc``, ``api``, and in a blocking
    round ``scalar_rows``, the rows it recomputed): ``after_warm(ctx)``,
    ``after_mirror(ctx)`` (untimed; it may rebuild or reload the mirror),
    ``after_seq(ctx, batches, counts)``, ``begin_loop(ctx, mode, rounds)``
    and ``end_loop(ctx, mode, record)`` around each loop, in the blocking loop
    ``before_refresh(ctx, round)``, ``after_refresh(ctx, round, refreshed,
    invalid_before)`` and ``after_burst(ctx, round, group_ids, counts,
    stats)``, in the nonblocking loops ``before_dispatch(ctx, mode, k,
    group_ids)`` just before a super-round's dispatch and
    ``after_harvest(ctx, mode, per_burst)`` just after its harvest, and
    ``after_loop(ctx)`` once at the end; they may run waves, but must leave
    the graph's invalid state and the table as they found them."""
    api = api if api is not None else port_api(device)
    if loops is None:
        mode = "blocking" if not nonblocking else "superround" if super_rounds else "chain"
        loops = [(mode, rounds)]
    for mode, _, *burst in loops:
        if mode not in MODES:
            raise ValueError(f"unknown live loop {mode!r}; modes are {MODES}")
        if burst and mode != "blocking":
            raise ValueError(f"only a blocking loop takes a burst, not {mode!r}")
    return asyncio.run(_run(api, n_nodes, deg, lane_groups, lane_seeds, edge_churn,
                            scalar_churn, lat_waves, edges, observer, fuse_depth, list(loops),
                            snapshot_path, live_async))


def _warm_depths(mode: str, rounds: int, fuse_depth: int) -> list:
    """The warm super-rounds of a nonblocking loop: one per depth it uses."""
    if mode == "blocking":
        return []
    depth = max(1, min(fuse_depth, rounds))
    return [depth] + ([rounds % depth] if rounds % depth else [])


async def _run(api: LiveApi, n, deg, lane_groups, lane_seeds, edge_churn, scalar_churn,
               lat_waves, edges, observer, fuse_depth, loops, snapshot_path=None,
               live_async=False) -> dict:
    core, sync = api.core, api.sync
    rng = np.random.default_rng(LOOP_SEED)
    src, dst = edges if edges is not None else power_law_dag(n, avg_degree=deg,
                                                             seed=GRAPH_SEED)
    # every loop's rounds and warm super-rounds churn (and recompute rows)
    n_rounds = sum(r + sum(_warm_depths(mode, r, fuse_depth)) for mode, r, *_ in loops)
    hub = core.FusionHub()
    old = core.set_default_hub(hub)
    try:
        backend = api.graph.TpuGraphBackend(
            hub, node_capacity=n + 64,
            # headroom for the declared churn: a capacity grow mid-loop would
            # dirty the device copy and re-upload it inside a timed round
            edge_capacity=len(src) + max(65536, 4 * edge_churn * n_rounds),
            **api.backend_kwargs)
        svc = make_dag_service(core, n, api.to_device)(hub)
        hub.add_service(svc, "dag")
        table = core.memo_table_of(svc.node)
        ctx = {"backend": backend, "table": table, "svc": svc, "api": api, "sync": sync, "n": n}

        # ---- columnar build: bulk ingest, every row warmed on the device
        sync()
        t0 = time.perf_counter()
        block = backend.bind_table_rows(table)
        backend.declare_row_edges(block, src, block, dst)
        backend.warm_block_on_device(block)
        backend.flush()
        sync()
        build_s = time.perf_counter() - t0
        ctx["block"] = block
        if backend.node_count != n or table.stale_count() != 0:
            raise AssertionError("live: the columnar build left nodes missing or rows stale")
        _notify(observer, "after_warm", ctx)

        t0 = time.perf_counter()
        info = backend.graph.build_topo_mirror()
        sync()
        mirror_build_s = time.perf_counter() - t0
        gdev = backend.graph
        _notify(observer, "after_mirror", ctx)
        info = gdev._topo_mirror  # the observer may have reloaded it

        def refresh_all() -> int:
            refreshed = backend.refresh_block_on_device(block) if table.stale_count() else 0
            backend.flush()
            return refreshed

        # ---- the union path once, its stale rows refreshed on the host
        backend.cascade_rows_batch(block, [n - 1])
        stale = np.nonzero(table._stale_host)[0]
        if stale.size:
            table.read_batch(stale)
        backend.flush()

        # ---- lone waves on the live hub: one tail row each (shallow
        # closures, the lat mirror's shape), host clock, synchronised
        lat_ms, lat_served = [], 0
        if lat_waves > 0:
            shallow = rng.choice(n // 100, size=lat_waves, replace=False)
            for row in (n - 1 - shallow).tolist():
                lw0 = gdev.lat_waves
                sync()
                t0 = time.perf_counter()
                backend.cascade_rows_batch(block, [row])
                sync()
                lat_ms.append((time.perf_counter() - t0) * 1e3)
                lat_served += int(gdev.lat_waves > lw0)
            refresh_all()
        seq_rows = (n - 1 - rng.choice(n // 100, size=SEQ_WAVES, replace=False)).tolist()
        seq_batches = [[r] for r in seq_rows]
        sync()
        t0 = time.perf_counter()
        seq_counts = backend.cascade_rows_batch_seq(block, seq_batches)
        sync()
        seq_ms = (time.perf_counter() - t0) * 1e3
        _notify(observer, "after_seq", ctx, seq_batches, seq_counts)
        refresh_all()

        # ---- the lane burst once (untimed), then the loop's state
        group_ids = [rng.choice(n // 10, size=lane_seeds, replace=False).tolist()
                     for _ in range(lane_groups)]
        backend.cascade_rows_lanes(block, group_ids)
        refresh_all()
        indeg = np.bincount(np.asarray(dst, np.int64), minlength=n)
        low_indeg = np.nonzero(indeg[: n // 2] <= 4)[0]
        scalar_rows = rng.choice(low_indeg, size=max(scalar_churn, 1) * n_rounds, replace=False)
        row_base = [0]  # rounds' worth of scalar_rows used so far
        viol = {"done": False}

        def make_churn_edges(k):
            """``perf/live_path.py``'s churn: random pairs oriented from the
            lower mirror level to the higher; same-level pairs dropped but
            ONE in the run (the violating tail), oriented by id."""
            a = rng.integers(0, n, size=k)
            b = rng.integers(0, n, size=k)
            neq = a != b
            a, b = a[neq], b[neq]
            m = gdev._topo_mirror
            if m is None:
                return np.minimum(a, b), np.maximum(a, b)
            inv_perm, ls = m["inv_perm"], m["level_starts_arr"]
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
            u, v = u[keep].copy(), v[keep].copy()
            flip = same[keep] & (u > v)
            u[flip], v[flip] = v[flip], u[flip]
            return u.astype(np.int64), v.astype(np.int64)

        def maintain() -> None:
            """Install a finished background re-level (one untimed burst and
            refresh after it), and start one once 3 violations stack up."""
            if gdev.poll_topo_mirror_rebuild():
                backend.cascade_rows_lanes(block, group_ids)
                refresh_all()
            m = gdev._topo_mirror
            if m is not None and m.get("n_viol", 0) >= 3 and gdev._async_rebuild is None:
                gdev.start_topo_mirror_rebuild()

        async def prep_churn(k_rounds: int, timed: Optional[dict]):
            """Churn for the next ``k_rounds`` rounds: the edge declarations,
            then the scalar recomputes of adopted rows. Journal-only host
            work (no flush): safe while a dispatched program runs. ``timed``
            (a loop's phases) takes the seconds and the declared edges."""
            t0 = time.perf_counter()
            declared = 0
            for _ in range(k_rounds):
                u, v = make_churn_edges(edge_churn)
                declared += backend.declare_row_edges(block, u, block, v)
            t1 = time.perf_counter()
            rows = []
            for _ in range(k_rounds):
                b = row_base[0] * scalar_churn
                rows += [int(r) for r in scalar_rows[b: b + scalar_churn]]
                row_base[0] += 1
            for row in rows:
                with core.invalidating():
                    await svc.node(row)
                await svc.node(row)
            if timed is not None:
                timed["declare_s"] += t1 - t0
                timed["scalar_s"] += time.perf_counter() - t1
                timed["churn_edges"] += declared
            return rows, declared

        if live_async:
            # the loops' fused sweeps run ADAPTIVELY: a device-side
            # fixed-point loop (a seeded sweep + counted extra sweeps to
            # quiescence) replaces the fixed worst-case pass count; the
            # loops' exactness checks certify the mode
            gdev.set_adaptive_passes(True)
        loop_records = []
        for mode, rounds, *burst in loops:
            _notify(observer, "begin_loop", ctx, mode, rounds)
            if mode == "blocking":
                rec = await _loop_blocking(ctx, rounds, prep_churn, maintain, group_ids, observer,
                                           *burst)
            else:
                rec = await _loop_nonblocking(ctx, mode, rounds, fuse_depth, prep_churn, maintain,
                                              group_ids, observer)
            _notify(observer, "end_loop", ctx, mode, rec)
            loop_records.append(rec)
        _notify(observer, "after_loop", ctx)
        async_stall_ms = _async_stall_ms(api, gdev, block, sync) if live_async else None
        snapshot_save_s, restore_s, snapshot_bytes = (
            _restore_leg(api, gdev, snapshot_path) if api.checkpoint is not None
            else (None, None, None))
        lat = np.asarray(lat_ms)
        record = {
            "metric": "live_path",
            "api": api.name,
            "nodes": n,
            "edges": int(backend.edge_count),
            "build_s": build_s,
            "build_nodes_per_s": n / build_s,
            "build_path": "columnar bulk ingest (bind_table_rows + declare_row_edges + "
                          "warm_block_on_device)",
            "mirror_build_s": mirror_build_s,
            "mirror_levels": info["levels"],
            "mirror_cache_hits": getattr(gdev, "mirror_cache_hits", None),
            "live_wave_ms_p50": float(np.percentile(lat, 50)) if lat.size else None,
            "live_wave_ms_p99": float(np.percentile(lat, 99)) if lat.size else None,
            "live_wave_lat_served": lat_served,
            "live_wave_seq_ms": seq_ms,
            "live_wave_seq_counts": [int(c) for c in seq_counts],
            "live_lanes_groups": lane_groups,
            "live_lanes_seeds_per_group": lane_seeds,
            **loop_records[0],
            "mirror_patches": gdev.mirror_patches,
            "mirror_rebuilds": gdev.mirror_rebuilds,
            "mirror_bursts": gdev.mirror_bursts,
            "cold_start": {"build_s": build_s, "mirror_build_s": mirror_build_s,
                           "programs": program_warm_report()},
            "snapshot_save_s": snapshot_save_s,
            "restore_s": restore_s,
            "snapshot_bytes": snapshot_bytes,
            # the adaptive sweep mode: whether the loops ran the device-side
            # fixed-point sweeps, how many dispatches did, and the per-wave
            # barrier stall the microbench measured reclaimed
            "live_async": live_async,
            "live_adaptive_stages": gdev.adaptive_stages if live_async else None,
            "live_level_stall_ms": async_stall_ms,
            "cut": list(CUT),
        }
        if len(loop_records) > 1:
            record["loops"] = loop_records
        return record
    finally:
        core.set_default_hub(old)


def _async_stall_ms(api: LiveApi, gdev, block, sync, reps: int = 12) -> Optional[float]:
    """``perf/live_path.py``'s adaptive-pass stall microbench: the same
    single-seed union wave timed (median of ``reps``) at the FIXED worst-case
    pass count and with the adaptive fixed-point sweep; the difference,
    floored at 0, is the per-wave barrier stall the adaptive mode reclaims,
    recorded as ``fusion_mesh_level_stall_ms``. The lat shortcut is off so
    both take the fused sweep the loops ride; the seed is invalid after the
    first call, so every timed wave leaves the state as it found it."""
    import importlib

    if gdev._topo_mirror is None:
        return None
    pkg = api.core.__name__.rsplit(".", 1)[0]
    record = importlib.import_module(f"{pkg}.parallel.routed_wave").record_level_stall_ms
    m = gdev._topo_mirror
    m["lat"] = None
    probe_seed = [[int(block.base)]]

    def union_ms(passes: int) -> float:
        m["passes"] = passes
        gdev.run_waves_union(probe_seed)  # warm (untimed)
        samples = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            gdev.run_waves_union(probe_seed)
            sync()
            samples.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(samples))

    fixed_ms = union_ms(gdev.FUSED_PASS_MAX)
    adaptive_ms = union_ms(0)
    stall_ms = max(fixed_ms - adaptive_ms, 0.0)
    record(stall_ms, cause=getattr(gdev, "last_cause_id", None))
    gdev.clear_invalid()
    return stall_ms


def _restore_leg(api: LiveApi, gdev, path: Optional[str] = None) -> tuple:
    """``perf/live_path.py``'s durable-restart budget: snapshot the live
    device graph atomically, then time its load, the number a rolling
    restart pays instead of the build. The snapshot goes to ``path`` and
    stays there if one is given, else to a temporary directory. Returns
    (save seconds, load seconds, snapshot bytes)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="fusion-restore-") as td:
        path = path or os.path.join(td, "graph.npz")
        t0 = time.perf_counter()
        api.checkpoint.save_graph(gdev, path)
        save_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        restored = api.checkpoint.load_graph(path, **api.backend_kwargs)
        load_s = time.perf_counter() - t0
        if restored.n_nodes != gdev.n_nodes or restored.n_edges != gdev.n_edges:
            raise AssertionError(
                f"live: the restored graph has {restored.n_nodes} nodes and "
                f"{restored.n_edges} edges, the live one {gdev.n_nodes} and {gdev.n_edges}")
    return save_s, load_s, n_bytes


def _lanes_burst(backend, block, group_ids):
    return backend.cascade_rows_lanes(block, group_ids)


async def _loop_blocking(ctx, rounds, prep_churn, maintain, group_ids, observer,
                         burst=_lanes_burst) -> dict:
    """``perf/live_path.py``'s blocking loop: per round the churn, ``flush``,
    ``refresh_block_on_device`` and one burst, ``cascade_rows_lanes`` unless
    the loop names its own ``burst(backend, block, group_ids)``."""
    backend, block, gdev, sync = ctx["backend"], ctx["block"], ctx["backend"].graph, ctx["sync"]
    phases = {"declare_s": 0.0, "scalar_s": 0.0, "churn_edges": 0}
    per_round = []
    total_inv, burst_s, observer_s = 0, 0.0, 0.0
    loop_t0 = time.perf_counter()
    for rnd in range(rounds):
        rec = {"round": rnd}
        round0 = (gdev.mirror_patches, gdev.mirror_rebuilds)
        d0, s0 = phases["declare_s"], phases["scalar_s"]
        rows, _ = await prep_churn(1, phases)
        rec["declare_ms"] = (phases["declare_s"] - d0) * 1e3
        t0 = time.perf_counter()
        backend.flush()  # the churn's marks cascade (one union wave)
        sync()
        rec["scalar_ms"] = (phases["scalar_s"] - s0 + time.perf_counter() - t0) * 1e3
        rec["scalar_rows"] = ctx["scalar_rows"] = rows
        invalid_before = int(np.count_nonzero(gdev._h_invalid[block.base:block.end()]))
        observer_s += _notify(observer, "before_refresh", ctx, rnd)
        t0 = time.perf_counter()
        refreshed = backend.refresh_block_on_device(block)
        sync()
        rec["refresh_ms"] = (time.perf_counter() - t0) * 1e3
        rec["refreshed"] = int(refreshed)
        observer_s += _notify(observer, "after_refresh", ctx, rnd, refreshed, invalid_before)
        bursts0 = gdev.mirror_bursts
        t0 = time.perf_counter()
        counts = burst(backend, block, group_ids)
        bt = time.perf_counter() - t0
        burst_s += bt
        total_inv += int(counts.sum())
        m = gdev._topo_mirror
        # patches and synchronous rebuilds over the round (the churn patches
        # in at the flush's union wave or at the burst), and the mirror
        # sweeps of the burst itself
        stats = {"patched": gdev.mirror_patches - round0[0],
                 "rebuilds": gdev.mirror_rebuilds - round0[1],
                 "mirror_bursts": gdev.mirror_bursts - bursts0,
                 "passes": m.get("passes", 1) if m else None}
        rec.update(burst_ms=bt * 1e3, newly=int(counts.sum()), **stats)
        observer_s += _notify(observer, "after_burst", ctx, rnd, group_ids, counts, stats)
        maintain()
        per_round.append(rec)
    loop_s = time.perf_counter() - loop_t0 - observer_s  # the observer's checks excluded
    return {
        "live_mode": "blocking",
        "live_inv_per_s": total_inv / burst_s if burst_s else None,
        "live_sustained_inv_per_s": total_inv / loop_s if loop_s else None,
        "live_nonblocking": False,
        "live_superround": False,
        "live_rounds": rounds,
        "live_churn_edges": phases["churn_edges"],
        "live_total_inv": total_inv,
        "rounds": per_round,
        "refresh_ms": [r["refresh_ms"] for r in per_round],
        "burst_ms": [r["burst_ms"] for r in per_round],
    }


async def _loop_nonblocking(ctx, mode, rounds, fuse_depth, prep_churn, maintain, group_ids,
                            observer) -> dict:
    """``perf/live_path.py``'s nonblocking loops, ``fuse_depth`` rounds per
    super-round after untimed warm super-rounds. ``superround``: per
    super-round the next one's churn prep and seed staging run while the
    previous one executes, then its harvest (the fence drain), ``flush``,
    ``refresh_block_on_device`` and the dispatch of the staged seeds (one
    program). ``chain``: the same cadence through
    ``cascade_rows_lanes_refresh_chain(nonblocking=True)``, with JAX's
    counted blocking fallback when the mirror cannot serve the chain."""
    backend, block, gdev, sync = ctx["backend"], ctx["block"], ctx["backend"].graph, ctx["sync"]
    from .graph.program_cache import time_program_warm

    depth = max(1, min(fuse_depth, rounds))
    n = ctx["n"]
    phases = {"declare_s": 0.0, "scalar_s": 0.0, "churn_edges": 0, "refresh_s": 0.0,
              "burst_s": 0.0, "stage_s": 0.0, "device_s": 0.0, "maintain_s": 0.0}
    sr = None
    if mode == "superround":
        sr = backend.super_rounds
        if sr is None or sr._disposed or sr.depth != depth:
            if sr is not None and not sr._disposed:
                sr.dispose()
            sr = backend.enable_super_rounds(block, depth=depth, max_words=16)
    depths = _warm_depths(mode, rounds, fuse_depth)
    t0 = time.perf_counter()
    with time_program_warm(mode, key=(n, len(group_ids), tuple(depths))):
        for d in depths:
            await prep_churn(d, None)
            backend.flush()
            backend.refresh_block_on_device(block)
            if sr is not None:
                sr.dispatch(sr.stage([group_ids] * d))
                sr.drain()
            else:
                backend.cascade_rows_lanes_refresh_chain(block, [group_ids] * d)
        backend.flush()
        sync()
    warm_s = time.perf_counter() - t0
    sr0 = sr.stats() if sr is not None else None
    hist0 = len(getattr(sr, "history", ())) if sr is not None else 0
    total_inv, burst_s, churn_rows, dispatches, eager_rounds = 0, 0.0, 0, 0, 0
    overlap_host_s, chain_wall_s, observer_s = 0.0, 0.0, 0.0
    pending, pending_k, staged_next, dispatch_done_ts = None, 0, None, None
    done_rounds = 0
    loop_t0 = time.perf_counter()
    while done_rounds < rounds or pending is not None:
        k = min(depth, rounds - done_rounds)
        if k > 0:
            # overlapped host work: this prep (and the seed staging) runs
            # while the previous program executes on the device
            await prep_churn(k, phases)
            if sr is not None:
                t0 = time.perf_counter()
                staged_next = sr.stage([group_ids] * k)
                dt = time.perf_counter() - t0
                phases["stage_s"] += dt
                phases["burst_s"] += dt
                burst_s += dt
        if pending is not None:
            t0 = time.perf_counter()
            if dispatch_done_ts is not None:
                overlap_host_s += max(t0 - dispatch_done_ts, 0.0)
            stall0 = sr.stall_s if sr is not None else 0.0
            per_burst = pending.harvest()
            dt = time.perf_counter() - t0
            if sr is not None:
                stall = sr.stall_s - stall0
                phases["device_s"] += stall
                phases["stage_s"] += max(dt - stall, 0.0)
            else:
                churn_rows += pending.cleared_total
            phases["burst_s"] += dt
            burst_s += dt
            chain_wall_s += time.perf_counter() - pending.dispatched_at
            total_inv += sum(int(c.sum()) for c in per_burst)
            observer_s += _notify(observer, "after_harvest", ctx, mode, per_burst)
            pending = None
            t0 = time.perf_counter()
            maintain()
            phases["maintain_s"] += time.perf_counter() - t0
        if k > 0:
            # the prep's journal cascades (the scalar marks: one union wave)
            # and the block is consistent again before the dispatch
            t0 = time.perf_counter()
            backend.flush()
            phases["scalar_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            churn_rows += backend.refresh_block_on_device(block)
            sync()  # an honest phase split
            phases["refresh_s"] += time.perf_counter() - t0
            observer_s += _notify(observer, "before_dispatch", ctx, mode, k, group_ids)
            t0 = time.perf_counter()
            if sr is not None:
                ticket = sr.dispatch(staged_next)
                if ticket.done:  # a counted fallback resolved inline
                    total_inv += sum(int(c.sum()) for c in ticket.per_burst)
                    observer_s += _notify(observer, "after_harvest", ctx, mode, ticket.per_burst)
                else:
                    pending = ticket
                    dispatches += 1
            else:
                try:
                    pending = backend.cascade_rows_lanes_refresh_chain(
                        block, [group_ids] * k, nonblocking=True)
                    dispatches += 1
                except (RuntimeError, TypeError):
                    # the mirror cannot serve the chain right now: the
                    # blocking pairs for this super-round, counted
                    eager_rounds += k
                    for _ in range(k):
                        total_inv += int(backend.cascade_rows_lanes(block, group_ids).sum())
                        churn_rows += backend.refresh_block_on_device(block)
            pending_k = k
            dt = time.perf_counter() - t0
            phases["burst_s"] += dt
            burst_s += dt
            dispatch_done_ts = time.perf_counter()
            done_rounds += k
    sync()
    loop_s = time.perf_counter() - loop_t0 - observer_s
    rec = {
        "live_mode": mode,
        "live_inv_per_s": total_inv / burst_s if burst_s else None,
        "live_sustained_inv_per_s": total_inv / loop_s if loop_s else None,
        "live_nonblocking": True,
        "live_fuse_depth": depth,
        "live_fused_chain_dispatches": dispatches,
        "live_eager_fallback_rounds": eager_rounds,
        "live_overlap_occupancy": overlap_host_s / chain_wall_s if chain_wall_s else None,
        "live_superround": sr is not None,
        "live_rounds": rounds,
        "live_churn_edges": phases["churn_edges"],
        "live_total_inv": total_inv,
        "live_burst_s": burst_s,
        "live_loop_s": loop_s,
        "live_warm_s": warm_s,
        "live_last_k": pending_k,
        "churn_rows_recomputed": churn_rows,
        "loop_phases": phases,
    }
    if sr is not None:
        s1 = sr.stats()
        d = {k_: s1[k_] - sr0[k_] for k_ in (
            "superrounds_dispatched", "eager_rounds", "faults", "restages",
            "journal_forced_harvests", "harvests", "stall_s", "wall_s", "cleared_total")}
        rec["churn_rows_recomputed"] += d["cleared_total"]
        occupancy = (max(0.0, min(1.0, 1 - d["stall_s"] / d["wall_s"]))
                     if d["wall_s"] > 0 else None)
        rec.update({
            "live_superround_depth": depth,
            "live_superround_dispatches": d["superrounds_dispatched"],
            "live_superround_occupancy": occupancy,
            "live_superround_host_stall_ms": (d["stall_s"] / d["harvests"] * 1e3
                                              if d["harvests"] else None),
            "live_superround_eager_rounds": d["eager_rounds"],
            "live_superround_faults": d["faults"],
            "live_superround_restages": d["restages"],
            "live_superround_forced_harvests": d["journal_forced_harvests"],
            "live_overlap_occupancy": occupancy,
        })
        rec["live_eager_fallback_rounds"] = d["eager_rounds"]
        history = list(getattr(sr, "history", ()))[hist0:]
        if history:
            rec["superrounds"] = history
            rec["superround_programs"] = {k_: s1[k_] - sr0[k_] for k_ in (
                "replays", "captures", "recaptures", "uncaptured")}
    return rec
