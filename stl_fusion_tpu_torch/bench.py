"""Twins of ``bench.py::run_single_chip`` (``kernel="topo"`` and
``kernel="pull"``) and ``bench.py::run_sharded`` (the mesh leg,
``FUSION_BENCH_SHARDED=1``) on the card.

    from stl_fusion_tpu_torch.bench import run_sharded, run_single_chip
    result = run_single_chip()          # 10M nodes on the CUDA device, the topo sweep
    result = run_single_chip(kernel="pull")            # the pull wave, 32 waves a pass
    result = run_sharded()              # the packed mesh wave on 8 logical shards

The same graph and defaults as the JAX package's legs: the power-law DAG
``power_law_dag(10M, avg_degree=3, seed=7)``, 100,000 seeds per wave, 20
waves. The topo leg builds ``build_topo_graph(k=4, quantize=False)`` and
runs one batch of ``32 * words`` = 512 packed waves at ``words=16``; the
pull leg (``FUSION_BENCH_KERNEL=pull``) builds ``build_pull_graph(k=8)``
and runs W = 1, 32 waves a pass; the graph is all valid before each batch.
The latency leg builds ``build_ell(k=4)`` and the lat wave (``lcap=512``,
``cap=4096``, ``assume_static_epochs=True``) and seeds each wave with 256
shallow nodes (the top 1% of ids). The mesh leg runs on ``graph_mesh(8)``
logical shards of the card: ``packed=True`` (the default,
``FUSION_BENCH_SHARDED_PACKED=1``) is ``PackedShardedGraph(words=16)``
with ``run_wave_batches`` (512 waves a batch), ``packed=False`` is
``ShardedDeviceGraph.run_waves_chained`` (one wave at a time).

Timing differs from ``bench.py`` on purpose, since there is no relay here:
- the throughput legs are timed on the card directly — a CUDA sync before
  and after each run of all batches (or chained waves) on the host clock,
  the zeroing of the state included; ``elapsed_s`` is the MEDIAN of
  ``timed_sweeps`` (≥ 5) such runs after one warm-up run, with no
  round-trip subtraction;
- each latency sample is ONE lone wave, timed on the host clock from the
  call to the readback of its count, with ``advance_epoch`` (O(1)) before
  every wave; no chain-difference estimator.

:func:`run_single_chip` and :func:`run_sharded` return the ``bench.py``
keys (``total_invalidated``, ``elapsed_s``, ``waves``, ``counts_head``,
``edges``, ``graph_build_s``, ... ) plus a few of their own; they print
nothing. :func:`build_topo_leg`, :func:`build_pull_leg`,
:func:`run_topo_leg`, :func:`build_lat_leg`, :func:`run_lat_leg`,
:func:`build_sharded_leg` and :func:`run_sharded_leg` are their parts, for
callers that also check results; a ``seed_lists`` argument replaces the
drawn seeds.
"""
from __future__ import annotations

import statistics
import time
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .graph.synthetic import power_law_dag
from .ops.ell_wave import advance_epoch, build_ell, build_ell_lat_wave
from .ops.pull_wave import build_pull_graph, build_pull_wave32, seeds_to_bits
from .ops.topo_wave import build_topo_graph, build_topo_wave32, topo_seeds_to_bits
from .parallel import PackedShardedGraph, ShardedDeviceGraph, graph_mesh

__all__ = [
    "build_lat_leg", "build_pull_leg", "build_sharded_leg", "build_topo_leg", "record",
    "run_batches", "run_lat_leg", "run_sharded", "run_sharded_leg", "run_single_chip",
    "run_topo_leg",
]

GRAPH_SEED = 7
#: logical shards of the mesh leg's mesh, one card (``bench.py`` takes every device)
MESH_SHARDS = 8
#: timed runs of a throughput leg, after one warm-up run (their median is reported)
TIMED_RUNS = 5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _edges(n_nodes: int, avg_deg: float, edges):
    return edges if edges is not None else power_law_dag(n_nodes, avg_degree=avg_deg,
                                                         seed=GRAPH_SEED)


def _draw_seed_lists(rng, n_nodes: int, seeds_per_wave: int, n_batches: int, per_batch: int,
                     seed_lists=None) -> list:
    """``seed_lists[b][i]``, wave i's seeds in batch b, drawn as ``bench.py``
    draws them (batch by batch), unless given."""
    if seed_lists is not None:
        if len(seed_lists) != n_batches or any(len(b) > per_batch for b in seed_lists):
            raise ValueError(f"seed_lists: need {n_batches} batches of <= {per_batch} waves")
        return seed_lists
    return [[rng.choice(n_nodes, size=seeds_per_wave, replace=False) for _ in range(per_batch)]
            for _ in range(n_batches)]


def build_topo_leg(n_nodes: int = 10_000_000, avg_deg: float = 3, seeds_per_wave: int = 100_000,
                   n_waves: int = 20, rng: Optional[np.random.Generator] = None,
                   words: int = 16, device=None) -> dict:
    """The graph, the sweep and the seed bits of the throughput leg (set-up,
    untimed but for ``graph_build_s``). ``seed_lists[b][i]`` are wave i's
    seeds (original ids) in batch b: lane i % 32 of word i // 32."""
    device = resolve_device(device)
    rng = np.random.default_rng(123) if rng is None else rng
    t0 = time.time()
    src, dst = _edges(n_nodes, avg_deg, None)
    graph = build_topo_graph(src, dst, n_nodes, k=4, quantize=False)
    build_s = time.time() - t0
    state, wave32 = build_topo_wave32(graph, words=words, device=device)
    waves_per_batch = 32 * words
    n_batches = max(n_waves // waves_per_batch, 1)
    seed_lists = _draw_seed_lists(rng, n_nodes, seeds_per_wave, n_batches, waves_per_batch)
    seed_bits = [torch.from_numpy(topo_seeds_to_bits(graph, lists, words=words)).to(device)
                 for lists in seed_lists]
    return {"kernel": "topo", "device": device, "src": src, "dst": dst, "n_nodes": n_nodes,
            "graph": graph, "graph_build_s": build_s, "state": state, "wave32": wave32,
            "words": words, "waves_per_batch": waves_per_batch, "n_batches": n_batches,
            "seed_lists": seed_lists, "seed_bits": seed_bits, "rng": rng}


def build_pull_leg(n_nodes: int = 10_000_000, avg_deg: float = 3, seeds_per_wave: int = 100_000,
                   n_waves: int = 20, rng: Optional[np.random.Generator] = None, device=None,
                   edges=None, seed_lists=None) -> dict:
    """``bench.py``'s ``FUSION_BENCH_KERNEL=pull`` leg: ``build_pull_graph(k=8)``
    and the pull wave, W = 1, 32 waves a batch; the same keys as
    :func:`build_topo_leg`."""
    device = resolve_device(device)
    rng = np.random.default_rng(123) if rng is None else rng
    t0 = time.time()
    src, dst = _edges(n_nodes, avg_deg, edges)
    graph = build_pull_graph(src, dst, n_nodes, k=8)
    build_s = time.time() - t0
    state, wave32 = build_pull_wave32(graph, device=device)
    n_batches = max(n_waves // 32, 1)
    seed_lists = _draw_seed_lists(rng, n_nodes, seeds_per_wave, n_batches, 32, seed_lists)
    seed_bits = [torch.from_numpy(seeds_to_bits(graph.n_tot, lists)).to(device)
                 for lists in seed_lists]
    return {"kernel": "pull", "device": device, "src": src, "dst": dst, "n_nodes": n_nodes,
            "graph": graph, "graph_build_s": build_s, "state": state, "wave32": wave32,
            "words": 1, "waves_per_batch": 32, "n_batches": n_batches,
            "seed_lists": seed_lists, "seed_bits": seed_bits, "rng": rng}


def run_batches(leg: dict) -> torch.Tensor:
    """Every batch from an all-valid state; per-batch counts on the device:
    the topo leg's per-word newly counts int32[batches, words], the pull
    leg's cumulative real popcount int32[batches, 1]. Leaves the last
    batch's bits in ``leg["state"]``."""
    state, wave32, counts = leg["state"], leg["wave32"], []
    for seed_bits in leg["seed_bits"]:
        state.invalid_bits.zero_()  # the churn model: all consistent before a batch
        state, c = wave32(seed_bits, state)
        counts.append(c.reshape(-1))
    return torch.stack(counts)


def run_topo_leg(leg: dict, timed_sweeps: int = 5) -> dict:
    """The throughput leg (topo or pull): one warm-up run of all batches,
    then ``timed_sweeps`` timed runs.
    Returns {"total", "counts" int64[batches, words], "sweep_s" (each run),
    "elapsed_s" (their median)}."""
    device = leg["device"]
    counts = run_batches(leg)  # warm-up: first launches load the kernel
    _sync(device)
    runs = []
    for _ in range(max(timed_sweeps, 5)):
        _sync(device)
        t0 = time.perf_counter()
        counts = run_batches(leg)
        _sync(device)
        runs.append(time.perf_counter() - t0)
    counts = counts.cpu().numpy().astype(np.int64)
    return {"total": int(counts.sum()), "counts": counts, "sweep_s": runs,
            "elapsed_s": statistics.median(runs)}


def build_lat_leg(leg: dict, lcap: int = 512, cap: int = 4096, n_samples: int = 96) -> dict:
    """The lat wave over ``build_ell(k=4)`` of the leg's graph and
    ``n_samples`` seed sets of 256 shallow nodes (top 1% of ids), on the
    device before any timing."""
    n, device, rng = leg["n_nodes"], leg["device"], leg["rng"]
    ell = build_ell(leg["src"], leg["dst"], n, k=4)
    state, wave = build_ell_lat_wave(ell, lcap=lcap, cap=cap, assume_static_epochs=True,
                                     device=device)
    pool = n // 100
    n_seed = min(256, pool)
    seeds = [(n - 1 - rng.choice(pool, size=n_seed, replace=False)).astype(np.int32)
             for _ in range(n_samples + 1)]  # one more for the warm-up wave
    return {"ell": ell, "state": state, "wave": wave, "seeds": seeds,
            "seeds_dev": [torch.from_numpy(s).to(device) for s in seeds], "device": device}


def run_lat_leg(lat: dict) -> dict:
    """One warm-up wave, then one timed lone wave per seed set, each from an
    all-valid state (``advance_epoch`` first). Raises on an overflow.
    Returns {"samples_ms", "counts"} (counts[i] of sample i)."""
    device, wave = lat["device"], lat["wave"]
    state = lat["state"]
    samples, counts = [], []
    for i, seeds in enumerate(lat["seeds_dev"]):
        state = advance_epoch(state)
        _sync(device)
        t0 = time.perf_counter()
        state, count, over = wave(seeds, state)  # the count is read back here
        dt = (time.perf_counter() - t0) * 1e3
        if over:
            raise RuntimeError("lat wave overflowed its caps: the latency samples are invalid")
        if i:  # sample 0 is the warm-up
            samples.append(dt)
            counts.append(count)
    lat["state"] = state
    return {"samples_ms": samples, "counts": counts}


def run_single_chip(n_nodes: int = 10_000_000, avg_deg: float = 3,
                    seeds_per_wave: int = 100_000, n_waves: int = 20,
                    rng: Optional[np.random.Generator] = None, words: int = 16,
                    lat_samples: int = 96, lat_lcap: int = 512, lat_cap: int = 4096,
                    timed_sweeps: int = 5, device=None, kernel: str = "topo") -> dict:
    """The single-chip leg (``kernel``: ``"topo"``, or ``"pull"`` at W = 1,
    ``words`` unused) and its latency leg (``lat_samples=0`` skips it, as
    ``FUSION_BENCH_LATENCY=0`` does: the p50/p99 fields are then None);
    returns the record. ``bench.py``'s third kernel, ``hybrid``, is not
    ported yet (ROADMAP B.11)."""
    if kernel == "topo":
        leg = build_topo_leg(n_nodes, avg_deg, seeds_per_wave, n_waves, rng, words, device)
    elif kernel == "pull":
        leg = build_pull_leg(n_nodes, avg_deg, seeds_per_wave, n_waves, rng, device)
    elif kernel == "hybrid":
        raise NotImplementedError("the hybrid wave is not ported yet: ROADMAP B.11")
    else:
        raise ValueError(f"kernel must be 'topo', 'hybrid' or 'pull', got {kernel!r}")
    sweep = run_topo_leg(leg, timed_sweeps)
    lat = run_lat_leg(build_lat_leg(leg, lat_lcap, lat_cap, lat_samples)) if lat_samples else None
    return record(leg, sweep, lat)


def record(leg: dict, sweep: dict, lat: Optional[dict]) -> dict:
    """The ``bench.py`` record of one run of the legs (``lat`` None: no
    latency leg)."""
    graph = leg["graph"]
    ms = np.asarray(lat["samples_ms"]) if lat is not None else None
    if ms is None:
        lat_fields = {"wave_ms_p50": None, "wave_ms_p99": None,
                      "wave_ms_amortized": sweep["elapsed_s"] / (
                          leg["n_batches"] * leg["waves_per_batch"]) * 1e3}
    else:
        lat_fields = {"wave_ms_p50": float(np.percentile(ms, 50)),
                      "wave_ms_p99": float(np.percentile(ms, 99)),
                      "wave_ms_max": float(ms.max()), "wave_ms_samples": int(ms.size)}
    return {
        "total_invalidated": sweep["total"],
        "elapsed_s": sweep["elapsed_s"],
        "waves": leg["n_batches"] * leg["waves_per_batch"],
        "kernel": leg["kernel"],
        **lat_fields,
        "edges": int(len(leg["src"])),
        "virtual_nodes": graph.n_tot - graph.n_real,
        "levels": len(graph.level_starts) - 1 if leg["kernel"] == "topo" else None,
        "graph_build_s": round(leg["graph_build_s"], 2),
        "batches": leg["n_batches"],
        "waves_per_batch": leg["waves_per_batch"],
        "counts_head": [int(c) for c in sweep["counts"].sum(axis=1)[:3]],
        "sweep_s": sweep["sweep_s"],
        "cascading_invalidations_per_sec": sweep["total"] / sweep["elapsed_s"],
        "device": (torch.cuda.get_device_name(leg["device"]) if leg["device"].type == "cuda"
                   else "cpu"),
    }


def build_sharded_leg(n_nodes: int = 10_000_000, avg_deg: float = 3,
                      seeds_per_wave: int = 100_000, n_waves: int = 20,
                      rng: Optional[np.random.Generator] = None, packed: bool = True,
                      words: int = 16, device=None, edges=None, seed_lists=None) -> dict:
    """The mesh leg's graph and seeds on ``graph_mesh(MESH_SHARDS)`` (set-up,
    untimed but for ``graph_build_s``). ``packed``: ``PackedShardedGraph``
    at ``words``, ``seed_lists[b]`` the ``32 * words`` waves of batch b;
    else ``ShardedDeviceGraph``, ``seed_lists[0]`` the ``n_waves`` waves."""
    device = resolve_device(device)
    rng = np.random.default_rng(123) if rng is None else rng
    mesh = graph_mesh(MESH_SHARDS, device=device)
    t0 = time.time()
    src, dst = _edges(n_nodes, avg_deg, edges)
    if packed:
        graph = PackedShardedGraph(src, dst, n_nodes, mesh=mesh, words=words)
        build_s = time.time() - t0
        wpb = 32 * words
        n_batches = max(n_waves // wpb, 1)
        seed_lists = _draw_seed_lists(rng, n_nodes, seeds_per_wave, n_batches, wpb, seed_lists)
        seeds_dev = graph.prepare_seed_batches(
            np.stack([graph.seeds_to_bits(lists) for lists in seed_lists]))
    else:
        graph = ShardedDeviceGraph(src, dst, n_nodes, mesh=mesh)
        build_s = time.time() - t0
        wpb, n_batches = n_waves, 1
        seed_lists = _draw_seed_lists(rng, n_nodes, seeds_per_wave, 1, n_waves, seed_lists)
        seed_mat = np.zeros((len(seed_lists[0]), n_nodes), dtype=bool)
        for i, ids in enumerate(seed_lists[0]):
            seed_mat[i, ids] = True
        seeds_dev = graph.prepare_seed_mat(seed_mat)
    return {"device": device, "packed": packed, "src": src, "dst": dst, "n_nodes": n_nodes,
            "graph": graph, "graph_build_s": build_s, "words": words if packed else None,
            "waves_per_batch": wpb, "n_batches": n_batches, "seed_lists": seed_lists,
            "seeds_dev": seeds_dev, "rng": rng}


def _run_sharded_once(leg: dict):
    graph = leg["graph"]
    if leg["packed"]:
        return graph.run_wave_batches(leg["seeds_dev"])
    return graph.run_waves_chained(leg["seeds_dev"])


def run_sharded_leg(leg: dict) -> dict:
    """One warm-up run, then :data:`TIMED_RUNS` timed runs of every batch
    (packed: the state cleared before each batch) or every chained wave.
    Returns the ``bench.py`` record of ``run_sharded`` plus ``run_s`` (each
    run), ``counts`` (per batch, or per wave) and, packed, the last run's
    ``levels``, ``syncs`` and ``early_exits``."""
    device, graph = leg["device"], leg["graph"]
    t0 = time.perf_counter()
    _run_sharded_once(leg)  # warm-up: first launches load the kernel
    _sync(device)
    warm_s = time.perf_counter() - t0
    runs = []
    for _ in range(TIMED_RUNS):
        _sync(device)
        t0 = time.perf_counter()
        total, counts = _run_sharded_once(leg)
        _sync(device)
        runs.append(time.perf_counter() - t0)
    elapsed = statistics.median(runs)
    n_waves = leg["n_batches"] * leg["waves_per_batch"]
    rec = {
        "total_invalidated": int(total),
        "elapsed_s": elapsed,
        "waves": n_waves,
        # one chained run, amortized: never a p50/p99 distribution
        "wave_ms_p50": None,
        "wave_ms_p99": None,
        "wave_ms_amortized": elapsed / n_waves * 1e3,
        "edges": int(len(leg["src"])),
        "graph_build_s": round(leg["graph_build_s"], 2),
        "warmup_s": warm_s,
        "counts_head": [int(c) for c in counts[:3]],
        "sharded": True,
        "packed": leg["packed"],
        "mesh_devices": graph.mesh.size,
        "run_s": runs,
        "counts": np.asarray(counts, dtype=np.int64),
        "cascading_invalidations_per_sec": int(total) / elapsed,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
    }
    if leg["packed"]:
        rec.update(words=leg["words"], **{k: graph.last_stats.get(k) for k in (
            "levels", "syncs", "early_exits")})
    return rec


def run_sharded(n_nodes: int = 10_000_000, avg_deg: float = 3, seeds_per_wave: int = 100_000,
                n_waves: int = 20, rng: Optional[np.random.Generator] = None,
                packed: bool = True, words: int = 16, device=None) -> dict:
    """The mesh leg (``bench.py::run_sharded``): ``packed=True`` (the
    default) the packed mesh wave at ``words`` (``32 * words`` waves a
    batch), else one wave at a time on ``ShardedDeviceGraph``; returns the
    record."""
    leg = build_sharded_leg(n_nodes, avg_deg, seeds_per_wave, n_waves, rng, packed, words,
                            device)
    return run_sharded_leg(leg)
