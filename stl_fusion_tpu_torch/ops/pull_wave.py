"""Host packers of the bit-packed waves: 32 independent waves per int32 word.

Port of the host half of ``stl_fusion_tpu/ops/pull_wave.py``
(``pack_seed_words``, ``pack_lane_matrix``, ``seeds_to_bits``). Wave ``i``
of a batch is bit ``i % 32`` of word ``i // 32``; lane 31 is the sign bit,
``-(1 << 31)`` as an int32. The pull kernel itself (``build_pull_wave32``)
is a lineage kernel and a later slice (ROADMAP A.9).
"""
from __future__ import annotations

import numpy as np

__all__ = ["pack_lane_matrix", "pack_seed_words", "seeds_to_bits"]


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
