"""Synthetic dependency-graph generators for benchmarks + stress tests.

The BASELINE stress config: a power-law (preferential-attachment) DAG — a
few hub nodes with huge fan-out (the "popular computed" shape: a config
value thousands of views depend on) and a long tail of leaves. Edges point
src(used, lower id) → dst(dependent, higher id), matching how dependency
DAGs grow in time.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["power_law_dag"]


def power_law_dag(
    n_nodes: int,
    avg_degree: float = 3.0,
    seed: int = 0,
    alpha: float = 0.8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Preferential-attachment DAG: each node depends on ~avg_degree earlier
    nodes, biased toward low ids by ``rand**(1/alpha)`` so in-degree of
    early nodes follows a power law. Returns (src, dst) int32 arrays.

    Vectorized: one draw per (node, slot), no Python loop over nodes.
    """
    rng = np.random.default_rng(seed)
    k = max(int(round(avg_degree)), 1)
    # dependents start at 1; node d picks k "used" nodes from [0, d)
    dst = np.repeat(np.arange(1, n_nodes, dtype=np.int64), k)
    u = rng.random(dst.shape[0])
    # power-law bias toward small ids (hubs)
    src = np.floor((u ** (1.0 / alpha)) * dst).astype(np.int64)
    src = np.minimum(src, dst - 1)
    # drop duplicate (src, dst) pairs cheaply: hash and unique
    key = src * n_nodes + dst
    _, idx = np.unique(key, return_index=True)
    src, dst = src[idx], dst[idx]
    return src.astype(np.int32), dst.astype(np.int32)
