"""Twin of ``perf/live_path.py``'s blocking loop (``LIVE_NONBLOCKING=0``) on
the card.

    from stl_fusion_tpu_torch.live_path import run_live
    record = run_live()                 # 10M rows on the CUDA device

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

Defaults are ``perf/live_path.py``'s (``LIVE_DEG=3``, ``LIVE_ROUNDS=6``,
``LIVE_LANE_GROUPS=512``, ``LIVE_LANE_SEEDS=8``, ``LIVE_EDGE_CHURN=2000``,
``LIVE_SCALAR_CHURN=4``, ``LIVE_LAT_WAVES=32``) at ``bench.py``'s
``FUSION_BENCH_LIVE_NODES=10_000_000``. Cut, and listed in the record:
the scalar-build micro-metric (``LIVE_SCALAR_NODES``), the nonblocking
chain and the super-rounds (a later slice), the chain-difference lone-wave
estimator and the relay round-trip subtraction (there is no relay: each
lone wave is timed on the host clock, synchronised), and the multi-pass
program warms (nothing compiles here).

:func:`run_live` returns the record with ``perf/live_path.py``'s keys where
they apply (``build_s``, ``mirror_build_s``, ``live_inv_per_s``,
``live_wave_ms_p50``/``_p99``, ``mirror_patches``, ...) and the per-round
refresh and burst ms; it prints nothing. ``api`` runs the same loop through
another package with this one's API (the parity tests pass the JAX
package's modules); ``observer`` receives the loop's state at fixed points,
for callers that also check results.
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .device import resolve_device
from .graph.synthetic import power_law_dag

__all__ = ["LiveApi", "port_api", "run_live"]

N_NODES = 10_000_000
GRAPH_SEED = 7
LOOP_SEED = 123
SEQ_WAVES = 8
CUT = (
    "LIVE_SCALAR_NODES scalar-build micro-metric",
    "nonblocking burst→refresh chain and super-rounds (ROADMAP A.5)",
    "chain-difference lone-wave estimator and relay-RTT subtraction (no relay)",
    "multi-pass program warms (nothing compiles)",
)


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


def port_api(device=None) -> LiveApi:
    """This package on ``device`` (``cuda`` unless given)."""
    from . import core, graph

    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return LiveApi(core, graph, {"device": dev},
                   lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), sync,
                   f"stl_fusion_tpu_torch on {dev}")


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
             observer=None) -> dict:
    """Run the blocking live loop once and return its record. ``edges``
    (src, dst) replaces the generated ``power_law_dag(n_nodes, deg, 7)``.
    ``observer`` methods, each optional, are called with a context dict
    (``backend``, ``block``, ``table``, ``svc``, ``api``, and in a round
    ``scalar_rows``, the rows it recomputed):
    ``after_warm(ctx)``, ``after_seq(ctx, batches, counts)``,
    ``before_refresh(ctx, round)``, ``after_refresh(ctx, round, refreshed,
    invalid_before)``, ``after_burst(ctx, round, group_ids, counts, stats)``
    and ``after_loop(ctx)``; they may run waves, but must leave the graph's
    invalid state and the table as they found them."""
    api = api if api is not None else port_api(device)
    return asyncio.run(_run(api, n_nodes, deg, rounds, lane_groups, lane_seeds, edge_churn,
                            scalar_churn, lat_waves, edges, observer))


async def _run(api: LiveApi, n, deg, rounds, lane_groups, lane_seeds, edge_churn, scalar_churn,
               lat_waves, edges, observer) -> dict:
    core, sync = api.core, api.sync
    rng = np.random.default_rng(LOOP_SEED)
    src, dst = edges if edges is not None else power_law_dag(n, avg_degree=deg,
                                                             seed=GRAPH_SEED)
    hub = core.FusionHub()
    old = core.set_default_hub(hub)
    try:
        backend = api.graph.TpuGraphBackend(
            hub, node_capacity=n + 64,
            # headroom for the declared churn: a capacity grow mid-loop would
            # dirty the device copy and re-upload it inside a timed round
            edge_capacity=len(src) + max(65536, 4 * edge_churn * rounds),
            **api.backend_kwargs)
        svc = make_dag_service(core, n, api.to_device)(hub)
        hub.add_service(svc, "dag")
        table = core.memo_table_of(svc.node)
        ctx = {"backend": backend, "table": table, "svc": svc, "api": api}

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
        scalar_rows = rng.choice(low_indeg, size=max(scalar_churn, 1) * rounds, replace=False)
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

        per_round = []
        total_inv, burst_s, churn_edges, observer_s = 0, 0.0, 0, 0.0
        loop_t0 = time.perf_counter()
        for rnd in range(rounds):
            rec = {"round": rnd}
            round0 = (gdev.mirror_patches, gdev.mirror_rebuilds)
            t0 = time.perf_counter()
            u, v = make_churn_edges(edge_churn)
            churn_edges += backend.declare_row_edges(block, u, block, v)
            rec["declare_ms"] = (time.perf_counter() - t0) * 1e3
            rows = [int(r) for r in scalar_rows[rnd * scalar_churn:(rnd + 1) * scalar_churn]]
            t0 = time.perf_counter()
            for row in rows:
                with core.invalidating():
                    await svc.node(row)
                await svc.node(row)
            backend.flush()  # the churn's marks cascade (one union wave)
            sync()
            rec["scalar_ms"] = (time.perf_counter() - t0) * 1e3
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
            counts = backend.cascade_rows_lanes(block, group_ids)
            bt = time.perf_counter() - t0
            burst_s += bt
            total_inv += int(counts.sum())
            m = gdev._topo_mirror
            # patches and synchronous rebuilds over the round (the churn
            # patches in at the flush's union wave or at the burst), and
            # the mirror sweeps of the burst itself
            stats = {"patched": gdev.mirror_patches - round0[0],
                     "rebuilds": gdev.mirror_rebuilds - round0[1],
                     "mirror_bursts": gdev.mirror_bursts - bursts0,
                     "passes": m.get("passes", 1) if m else None}
            rec.update(burst_ms=bt * 1e3, newly=int(counts.sum()), **stats)
            observer_s += _notify(observer, "after_burst", ctx, rnd, group_ids, counts, stats)
            maintain()
            per_round.append(rec)
        loop_s = time.perf_counter() - loop_t0 - observer_s  # the observer's checks excluded
        _notify(observer, "after_loop", ctx)
        lat = np.asarray(lat_ms)
        return {
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
            "live_wave_ms_p50": float(np.percentile(lat, 50)) if lat.size else None,
            "live_wave_ms_p99": float(np.percentile(lat, 99)) if lat.size else None,
            "live_wave_lat_served": lat_served,
            "live_wave_seq_ms": seq_ms,
            "live_wave_seq_counts": [int(c) for c in seq_counts],
            "live_inv_per_s": total_inv / burst_s if burst_s else None,
            "live_sustained_inv_per_s": total_inv / loop_s if loop_s else None,
            "live_nonblocking": False,
            "live_rounds": rounds,
            "live_lanes_groups": lane_groups,
            "live_lanes_seeds_per_group": lane_seeds,
            "live_churn_edges": churn_edges,
            "live_total_inv": total_inv,
            "mirror_patches": gdev.mirror_patches,
            "mirror_rebuilds": gdev.mirror_rebuilds,
            "mirror_bursts": gdev.mirror_bursts,
            "rounds": per_round,
            "refresh_ms": [r["refresh_ms"] for r in per_round],
            "burst_ms": [r["burst_ms"] for r in per_round],
            "cut": list(CUT),
        }
    finally:
        core.set_default_hub(old)
