"""``ring_all_gather`` — the sharded wave's ring frontier exchange, as a
hand-written Hopper kernel.

Replaces ``stl_fusion_tpu/ops/pallas_kernels.py::make_ring_all_gather``
(``_ring_kernel``): an all-gather of every shard's frontier words into the
full vector on every shard, moved by ``n - 1`` double-buffered hops around a
ring. Shard ``d`` places its own chunk at slot ``d``; at step ``s`` each
shard sends comm slot ``s % 2`` to shard ``(d + 1) % n``, which receives it
into slot ``1 - s % 2`` and writes it at owner ``(d - s - 1) mod n`` of its
own output. The result equals a tiled all-gather.

Kernel: ``csrc/ring_all_gather.cu``, for the ``n`` logical shards of a
one-card mesh (``parallel/mesh.py``): one launch per step covering every
shard, each shard with its own two-slot comm buffer and output. Bound on the
H100: bytes (``n`` chunks read, ``n * n`` written); at the 10M-node scale
(8 shards of 39,063 words) that is ~11.25 MB, ~3.4 µs at 3.35 TB/s, and the
``n`` launches dominate. It takes ``int32`` words, the port's convention,
in chunks of any length.

The yardstick one PyTorch call gives is ``torch.cat(chunks)``, which is
what ``exchange="packed"`` does on a one-card mesh; the ring path never
calls it.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from . import _build

__all__ = ["ring_all_gather", "ring_all_gather_plain", "launches", "MAX_SHARDS"]

#: kernel calls since the last reset (one per gather; each gather enqueues
#: ``n`` CUDA launches, one per ring step)
launches = 0

#: the pointer table the kernel takes by value holds this many shards
MAX_SHARDS = 64


def ring_all_gather_plain(chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain PyTorch version: the same hop schedule, step by step, with
    double-buffered copies between the shards' own comm buffers."""
    n, c = len(chunks), chunks[0].shape[0]
    out = [torch.empty(n * c, dtype=torch.int32, device=x.device) for x in chunks]
    comm = [torch.empty(2, c, dtype=torch.int32, device=x.device) for x in chunks]
    for d, x in enumerate(chunks):
        out[d][d * c:(d + 1) * c] = x
        comm[d][0] = x
    for step in range(n - 1):
        send, recv = step % 2, 1 - step % 2
        for d in range(n):  # every send of a hop reads slot `send` only
            comm[(d + 1) % n][recv] = comm[d][send]
        for d in range(n):
            owner = (d - step - 1) % n
            out[d][owner * c:(owner + 1) * c] = comm[d][recv]
    return out


def _check(chunks: Sequence[torch.Tensor]) -> None:
    if not chunks:
        raise ValueError("ring_all_gather: needs at least one shard")
    if len(chunks) > MAX_SHARDS:
        raise ValueError(f"ring_all_gather: at most {MAX_SHARDS} shards")
    first = chunks[0]
    for x in chunks:
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError("ring_all_gather: every chunk must be a contiguous 1-D int32 tensor")
        if x.shape != first.shape or x.device != first.device:
            raise ValueError("ring_all_gather: chunks must share one length and one device")
    if first.shape[0] == 0:
        raise ValueError("ring_all_gather: chunks must hold at least one word")


def ring_all_gather(chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather ``n`` shards' int32 chunks: returns ``n`` tensors, shard
    ``d``'s holding every chunk in shard order (int32[n * chunk]). A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``csrc/ring_all_gather.cu`` or raises."""
    global launches
    _check(chunks)
    first = chunks[0]
    if first.device.type == "cpu":
        return ring_all_gather_plain(chunks)
    if first.device.type != "cuda":
        raise ValueError(f"ring_all_gather: unsupported device {first.device}")
    n, c = len(chunks), first.shape[0]
    # each shard's output and two-slot comm buffer: rows of one allocation,
    # addressed by byte offset (no view per shard on the host path)
    out = torch.empty(n, n * c, dtype=torch.int32, device=first.device)
    comm = torch.empty(n, 2, c, dtype=torch.int32, device=first.device)
    table = ctypes.c_void_p * n
    _build.launch(
        "ring_all_gather",
        table(*(x.data_ptr() for x in chunks)),
        table(*range(comm.data_ptr(), comm.data_ptr() + n * 8 * c, 8 * c)),
        table(*range(out.data_ptr(), out.data_ptr() + n * 4 * n * c, 4 * n * c)),
        n, c,
    )
    launches += 1
    return list(out.unbind(0))
