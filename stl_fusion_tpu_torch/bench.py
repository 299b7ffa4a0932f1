"""Twin of ``bench.py::run_single_chip`` (``kernel="topo"``) on the card.

    from stl_fusion_tpu_torch.bench import run_single_chip
    result = run_single_chip()          # 10M nodes on the CUDA device

The same graph and defaults as the JAX package's single-chip leg: the
power-law DAG ``power_law_dag(10M, avg_degree=3, seed=7)`` as a topo graph
(``k=4``, ``quantize=False``), 100,000 seeds per wave, 20 waves → one batch
of ``32 * words`` = 512 packed waves at ``words=16``; the graph is all valid
before each batch. The latency leg builds ``build_ell(k=4)`` and the lat
wave (``lcap=512``, ``cap=4096``, ``assume_static_epochs=True``) and seeds
each wave with 256 shallow nodes (the top 1% of ids).

Timing differs from ``bench.py`` on purpose, since there is no relay here:
- the throughput leg is timed on the card directly — a CUDA sync before and
  after each run of all batches on the host clock, the zeroing of the state
  included; ``elapsed_s`` is the MEDIAN of ``timed_sweeps`` (≥ 5) such runs
  after one warm-up run, with no round-trip subtraction;
- each latency sample is ONE lone wave, timed on the host clock from the
  call to the readback of its count, with ``advance_epoch`` (O(1)) before
  every wave; no chain-difference estimator.

:func:`run_single_chip` returns the ``bench.py`` keys (``total_invalidated``,
``elapsed_s``, ``waves``, ``kernel``, ``wave_ms_p50``, ``wave_ms_p99``,
``edges``, ``virtual_nodes``, ``levels``, ``graph_build_s``, ``batches``,
``waves_per_batch``, ``counts_head``) plus a few of its own; it prints
nothing. :func:`build_topo_leg`, :func:`run_topo_leg`, :func:`build_lat_leg`
and :func:`run_lat_leg` are its parts, for callers that also check results.
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
from .ops.topo_wave import build_topo_graph, build_topo_wave32, topo_seeds_to_bits

__all__ = [
    "build_lat_leg", "build_topo_leg", "record", "run_batches", "run_lat_leg", "run_single_chip",
    "run_topo_leg",
]

GRAPH_SEED = 7


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_topo_leg(n_nodes: int = 10_000_000, avg_deg: float = 3, seeds_per_wave: int = 100_000,
                   n_waves: int = 20, rng: Optional[np.random.Generator] = None,
                   words: int = 16, device=None) -> dict:
    """The graph, the sweep and the seed bits of the throughput leg (set-up,
    untimed but for ``graph_build_s``). ``seed_lists[b][i]`` are wave i's
    seeds (original ids) in batch b: lane i % 32 of word i // 32."""
    device = resolve_device(device)
    rng = np.random.default_rng(123) if rng is None else rng
    t0 = time.time()
    src, dst = power_law_dag(n_nodes, avg_degree=avg_deg, seed=GRAPH_SEED)
    graph = build_topo_graph(src, dst, n_nodes, k=4, quantize=False)
    build_s = time.time() - t0
    state, wave32 = build_topo_wave32(graph, words=words, device=device)
    waves_per_batch = 32 * words
    n_batches = max(n_waves // waves_per_batch, 1)
    seed_lists = [[rng.choice(n_nodes, size=seeds_per_wave, replace=False)
                   for _ in range(waves_per_batch)] for _ in range(n_batches)]
    seed_bits = [torch.from_numpy(topo_seeds_to_bits(graph, lists, words=words)).to(device)
                 for lists in seed_lists]
    return {"device": device, "src": src, "dst": dst, "n_nodes": n_nodes, "graph": graph,
            "graph_build_s": build_s, "state": state, "wave32": wave32, "words": words,
            "waves_per_batch": waves_per_batch, "n_batches": n_batches,
            "seed_lists": seed_lists, "seed_bits": seed_bits, "rng": rng}


def run_batches(leg: dict) -> torch.Tensor:
    """Every batch from an all-valid state; per-batch per-word counts,
    int32[batches, words] on the device. Leaves the last batch's bits in
    ``leg["state"]``."""
    state, wave32, counts = leg["state"], leg["wave32"], []
    for seed_bits in leg["seed_bits"]:
        state.invalid_bits.zero_()  # the churn model: all consistent before a batch
        state, c = wave32(seed_bits, state)
        counts.append(c.reshape(-1))
    return torch.stack(counts)


def run_topo_leg(leg: dict, timed_sweeps: int = 5) -> dict:
    """One warm-up run of all batches, then ``timed_sweeps`` timed runs.
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
                    timed_sweeps: int = 5, device=None) -> dict:
    """The single-chip topo leg and its latency leg; returns the record."""
    leg = build_topo_leg(n_nodes, avg_deg, seeds_per_wave, n_waves, rng, words, device)
    sweep = run_topo_leg(leg, timed_sweeps)
    lat = run_lat_leg(build_lat_leg(leg, lat_lcap, lat_cap, lat_samples))
    return record(leg, sweep, lat)


def record(leg: dict, sweep: dict, lat: dict) -> dict:
    """The ``bench.py`` record of one run of the legs."""
    graph = leg["graph"]
    ms = np.asarray(lat["samples_ms"])
    return {
        "total_invalidated": sweep["total"],
        "elapsed_s": sweep["elapsed_s"],
        "waves": leg["n_batches"] * leg["waves_per_batch"],
        "kernel": "topo",
        "wave_ms_p50": float(np.percentile(ms, 50)),
        "wave_ms_p99": float(np.percentile(ms, 99)),
        "wave_ms_max": float(ms.max()),
        "wave_ms_samples": int(ms.size),
        "edges": int(len(leg["src"])),
        "virtual_nodes": graph.n_tot - graph.n_real,
        "levels": len(graph.level_starts) - 1,
        "graph_build_s": round(leg["graph_build_s"], 2),
        "batches": leg["n_batches"],
        "waves_per_batch": leg["waves_per_batch"],
        "counts_head": [int(c) for c in sweep["counts"].sum(axis=1)[:3]],
        "sweep_s": sweep["sweep_s"],
        "cascading_invalidations_per_sec": sweep["total"] / sweep["elapsed_s"],
        "device": (torch.cuda.get_device_name(leg["device"]) if leg["device"].type == "cuda"
                   else "cpu"),
    }
