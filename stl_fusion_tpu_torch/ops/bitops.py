"""Little-endian bool ⇄ word packing for the wave's bit-packed state.

Node ``i`` is bit ``i & 31`` of word ``i >> 5``, the layout of
``stl_fusion_tpu/ops/bitops.py::pack_bool_bits`` and of the host pack in
``graph/device_graph.py``. Words are carried as **int32**: PyTorch on the
CPU has no ``~``, ``>>`` or ``<<`` for uint32. ``1 << 31`` is negative in
int32 and ``>>`` is arithmetic, so every bit test masks with ``& 1`` after
the shift.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "n_words",
    "pack_bits",
    "unpack_bits",
    "pack_mask_host",
    "unpack_words_host",
    "ids_to_word_masks",
]


def n_words(n_bits: int) -> int:
    """Words needed for ``n_bits`` bits."""
    return (n_bits + 31) >> 5


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[n] → int32[ceil(n/32)], on the mask's device."""
    n = mask.shape[0]
    pad = (-n) % 32
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, pad)).view(-1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (m << shifts).sum(dim=1)  # in [0, 2**32): fold to int32 below
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32[w] → bool[n] (the first ``n`` bits), on the words' device."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].bool()


def pack_mask_host(mask: np.ndarray) -> np.ndarray:
    """Host twin of :func:`pack_bits`: bool[n] → int32 words (numpy)."""
    packed8 = np.packbits(np.asarray(mask, dtype=bool), bitorder="little")
    pad = (-len(packed8)) % 4
    if pad:
        packed8 = np.concatenate([packed8, np.zeros(pad, dtype=np.uint8)])
    return packed8.view(np.int32)


def unpack_words_host(words: np.ndarray, n: int) -> np.ndarray:
    """Host twin of :func:`unpack_bits`: int32 words → bool[n] (numpy)."""
    w = np.ascontiguousarray(words, dtype=np.int32)
    return np.unpackbits(w.view(np.uint8), count=n, bitorder="little").view(bool)


def ids_to_word_masks(ids: np.ndarray):
    """Node ids → (unique word indices int64, OR of their bits per word as
    int32). A per-word scatter of these touches each word once, so the
    update is deterministic where several ids share a word."""
    ids = np.unique(np.asarray(ids, dtype=np.int64))
    words = ids >> 5
    bits = (np.uint32(1) << (ids & 31).astype(np.uint32)).astype(np.uint32)
    uniq, starts = np.unique(words, return_index=True)
    masks = np.bitwise_or.reduceat(bits, starts) if len(ids) else bits
    return uniq, masks.astype(np.uint32).view(np.int32)
