"""``or_popcount`` — the wave finalizer, as a hand-written Hopper kernel.

Replaces ``stl_fusion_tpu/ops/pallas_kernels.py::or_popcount``
(``_or_popcount_kernel`` / ``_or_popcount_2d``): merge a new invalidation
bit vector into the accumulated one and count the newly lit bits, in one
pass over the words. In the port's dense wave it is the seed gate, the
per-level merge and count, and the union finalize (see ``ops/wave.py``).

Kernel: ``csrc/or_popcount.cu``. Bound on the H100: bytes (12 B per word:
two reads, one write, one popcount each); at the 10M-node scale that is
~6.3 MB, ~1.9 µs at 3.35 TB/s, so launch latency dominates. The kernel
streams 16-byte vector loads in a grid-stride loop, reduces each block's
count with warp shuffles and shared memory, and makes one 64-bit atomicAdd
per block (blocks run unordered: no count carries between them as the TPU's
SMEM scalar carried between grid steps).

The TPU kernel's count is int32 and wraps past 2³¹ bits; the port returns
a 0-d **int64** count.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["or_popcount", "or_popcount_plain", "launches"]

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

_POPC8: Dict[torch.device, torch.Tensor] = {}


def _popc8(device: torch.device) -> torch.Tensor:
    """256-entry popcount lookup table (torch has no popcount op)."""
    t = _POPC8.get(device)
    if t is None:
        t = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64,
                         device=device)
        _POPC8[device] = t
    return t


def or_popcount_plain(
    new_bits: torch.Tensor, old_bits: torch.Tensor, out: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(old | new, popcount(new & ~old))``; the
    count is a 0-d int64. ``out`` may be ``old_bits`` (the count is taken
    before the merge is written)."""
    delta = new_bits & ~old_bits
    count = _popc8(delta.device)[delta.contiguous().view(torch.uint8).long()].sum()
    merged = torch.bitwise_or(new_bits, old_bits, out=out)
    return merged, count


def _check(new_bits, old_bits, out) -> None:
    for name, t in (("new_bits", new_bits), ("old_bits", old_bits), ("out", out)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"or_popcount: {name} must be a contiguous 1-D int32 tensor")
        if t.shape != new_bits.shape or t.device != new_bits.device:
            raise ValueError(f"or_popcount: {name} must match new_bits in shape and device")


def or_popcount(
    new_bits: torch.Tensor, old_bits: torch.Tensor, out: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(old | new, popcount(new & ~old))`` over 1-D int32 words.

    Returns (merged int32[n], newly-lit bit count as a 0-d int64). ``out``
    receives the merge and may be ``old_bits`` itself (in-place merge: every
    word is read before it is written, by the same thread). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    """
    global launches
    _check(new_bits, old_bits, out)
    if new_bits.device.type == "cpu":
        return or_popcount_plain(new_bits, old_bits, out)
    if new_bits.device.type != "cuda":
        raise ValueError(f"or_popcount: unsupported device {new_bits.device}")
    merged = torch.empty_like(new_bits) if out is None else out
    for t in (new_bits, old_bits, merged):
        if t.data_ptr() % 16:
            raise ValueError("or_popcount: tensors must be 16-byte aligned")
    count = torch.zeros((), dtype=torch.int64, device=new_bits.device)
    _build.launch(
        "or_popcount", "or_popcount_launch", new_bits.data_ptr(), old_bits.data_ptr(),
        merged.data_ptr(), new_bits.shape[0], count.data_ptr(),
    )
    launches += 1
    return merged, count
