"""Bit-packed pull-mode waves: 32 invalidation cascades per pass.

Port of ``stl_fusion_tpu/ops/pull_wave.py``: the host packers
(``pack_seed_words``, ``pack_lane_matrix``, ``seeds_to_bits``) and the pull
wave (``build_pull_graph``, ``build_pull_wave32``). Wave ``i`` of a batch is
bit ``i % 32`` of word ``i // 32``; lane 31 is the sign bit, ``-(1 << 31)``
as an int32.

**The pull wave.** Each row lists the nodes it depends on (``build_ell`` on
the reversed edges, virtual OR-collectors bounding the fan-in at k), and a
level reads each row's in-rows: did any of them just fire? Its level is
the hand-written kernel ``packed_pull`` (``ops/packed_pull.py``,
``csrc/packed_pull.cu``) at W = 1 with the null row's fire forced to 0, the
one the packed mesh wave runs at any W. Unlike JAX, the wave updates
``state.invalid_bits`` IN PLACE and returns the same state; its count is
every real invalid bit after the wave, cumulative, as in JAX.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .ell_wave import EllGraph, build_ell
from .packed_pull import run_pull_wave

__all__ = [
    "PullGraphArrays",
    "PullState",
    "build_pull_graph",
    "build_pull_wave32",
    "pack_lane_matrix",
    "pack_seed_words",
    "pull_graph_arrays",
    "pull_init_state",
    "pull_wave32_step",
    "seeds_to_bits",
]


def build_pull_graph(src: np.ndarray, dst: np.ndarray, n_nodes: int, k: int = 8) -> EllGraph:
    """In-edge ELL: row d lists the nodes d depends on (virtual
    OR-collectors bound fan-in at k). ``build_ell`` on the reversed edges."""
    return build_ell(dst, src, n_nodes, k=k)


def pack_seed_words(
    n_rows: int, seed_ids_per_wave, words: int = 1, id_map: "np.ndarray" = None
) -> np.ndarray:
    """≤``32*words`` seed-id lists → int32 bit words: 1-D [n_rows] for
    ``words=1``, else [n_rows, words]. ``id_map`` remaps seed ids first
    (the topo sweep's original → level-order permutation)."""
    bits = np.zeros((n_rows, words), dtype=np.int32)
    for i, ids in enumerate(seed_ids_per_wave[: 32 * words]):
        w, lane = divmod(i, 32)
        ids = np.asarray(ids, dtype=np.int64)
        if id_map is not None:
            ids = id_map[ids]
        bits[ids, w] |= np.int32(1 << lane) if lane < 31 else np.int32(-(1 << 31))
    return bits[:, 0] if words == 1 else bits


def pack_lane_matrix(groups, pad_id: int, n_valid: int, id_map=None, base_index: int = 0):
    """Per-group seed ids → (int32[32*words, width] lane matrix, words):
    row i holds group i's UNIQUE ids padded with ``pad_id``; words and
    width round up to powers of two. ``id_map`` optionally remaps ids; ids
    must lie in [0, n_valid)."""
    words = 1
    while words < (len(groups) + 31) // 32:
        words <<= 1
    width = 1
    while width < max((len(s) for s in groups), default=1):
        width <<= 1
    mat = np.full((32 * words, width), pad_id, dtype=np.int32)
    for i, s in enumerate(groups):
        ids = np.unique(np.asarray(s, dtype=np.int64))
        if len(ids) and (ids[0] < 0 or ids[-1] >= n_valid):
            raise ValueError(f"group {base_index + i}: seed ids must be in [0, {n_valid})")
        if id_map is not None:
            ids = id_map[ids]
        mat[i, : len(ids)] = ids.astype(np.int32)
    return mat, words


def seeds_to_bits(n_tot: int, seed_ids_per_wave) -> np.ndarray:
    """≤32 seed-id arrays → int32[n_tot+1] bit vector, the null row 0."""
    bits = pack_seed_words(n_tot + 1, seed_ids_per_wave)
    bits[n_tot] = 0
    return bits


class PullGraphArrays(NamedTuple):
    """Device-resident graph structure, passed to the wave per call."""

    in_src: torch.Tensor  # int32[n_tot+1, k]: row d's dependencies
    edge_epoch: torch.Tensor  # int32[n_tot+1, k]: captured dependency epochs
    is_real: torch.Tensor  # bool[n_tot+1]: False for virtual OR-collectors


class PullState(NamedTuple):
    node_epoch: torch.Tensor  # int32[n_tot+1]
    invalid_bits: torch.Tensor  # int32[n_tot+1]


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A FRESH tensor on ``device``: never an alias of the numpy buffer."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, copy=True)


def pull_graph_arrays(graph: EllGraph, device=None) -> PullGraphArrays:
    """One-time upload of the in-edge table to the device."""
    device = resolve_device(device)
    return PullGraphArrays(_upload(graph.ell_dst.astype(np.int32), device),
                           _upload(graph.ell_epoch.astype(np.int32), device),
                           _upload(graph.is_real.astype(bool), device))


def pull_init_state(n_tot: int, device=None) -> PullState:
    """All valid, every node at epoch 0, the null row at -2."""
    device = resolve_device(device)
    node_epoch = torch.zeros(n_tot + 1, dtype=torch.int32, device=device)
    node_epoch[n_tot] = -2
    return PullState(node_epoch, torch.zeros(n_tot + 1, dtype=torch.int32, device=device))


def _pull_wave32_impl(garrays: PullGraphArrays, seed_bits: torch.Tensor, state: PullState,
                      stats: Optional[dict] = None):
    """The 32-wave cascade (JAX ``_pull_wave32_impl``): the seed step
    (``seed_bits & ~invalid``), then ``packed_pull`` levels until one lights
    nothing, the null row's fire 0. Returns (state, count): ``count`` (0-d
    int32) is the popcount of the real rows' invalid bits after the wave."""
    in_src, edge_epoch, is_real = garrays
    n_tot = in_src.shape[0] - 1
    inv = state.invalid_bits
    if seed_bits.shape != inv.shape or inv.dim() != 1:
        raise ValueError(f"pull wave: seed bits {tuple(seed_bits.shape)} for a state of "
                         f"{tuple(inv.shape)} rows")
    counts = torch.zeros(1, dtype=torch.int32, device=inv.device)
    run_pull_wave(in_src, edge_epoch, state.node_epoch, is_real, seed_bits.view(-1, 1),
                  inv.view(-1, 1), counts, null_row=n_tot, count_all=True, stats=stats)
    return state, counts[0]


@functools.lru_cache(maxsize=1)
def pull_wave32_step():
    """The 32-wave kernel: ``step(garrays, seed_bits, state)``, for callers
    that thread ``garrays`` through a larger program (JAX jits it here)."""
    return _pull_wave32_impl


def build_pull_wave32(graph: EllGraph, device=None):
    """The 32-wave bit-packed cascade for one graph. Returns (state0,
    wave32): ``wave32(seed_bits, state) -> (state, real_invalidation_count)``
    with ``seed_bits`` int32[n_tot+1]; the count sums popcounts over REAL
    nodes (virtual collectors excluded) across all 32 waves. ``wave32.garrays``
    is the device graph, ``wave32.step`` and ``wave32.impl`` the raw kernel."""
    garrays = pull_graph_arrays(graph, device)
    step = pull_wave32_step()

    def wave32(seed_bits, state, stats: Optional[dict] = None):
        return step(garrays, seed_bits, state, stats)

    wave32.garrays = garrays
    wave32.step = step
    wave32.impl = _pull_wave32_impl
    return pull_init_state(graph.n_tot, garrays.in_src.device), wave32
