"""``ring_all_gather`` — the sharded wave's ring frontier exchange, as a
hand-written Hopper kernel.

Replaces ``stl_fusion_tpu/ops/pallas_kernels.py::make_ring_all_gather``
(``_ring_kernel``): an all-gather of every shard's frontier words into the
full vector on every shard, moved by ``n - 1`` double-buffered hops around a
ring. Shard ``d`` places its own chunk at slot ``d``; at step ``s`` each
shard sends comm slot ``s % 2`` to shard ``(d + 1) % n``, which receives it
into slot ``1 - s % 2`` and writes it at owner ``(d - s - 1) mod n`` of its
own output. The result equals a tiled all-gather.

:func:`ring_all_gather_plain` keeps that hop schedule: it is the spec, held
word for word against the Pallas kernel in the parity tests.

Kernel: ``csrc/ring_all_gather.cu``, for the ``n`` logical shards of a
one-card mesh (``parallel/mesh.py``). On one card the hops only copy chunks
through comm buffers in the same memory, so the kernel computes the
all-gather directly, in ONE launch: each block reads a tile of one owner's
chunk once and writes it into all ``n`` outputs. Bound on the H100: bytes
(``n`` chunks read, ``n * n`` written); at the 10M-node scale (8 shards of
39,063 words) that is ~11.25 MB, 3.36 µs at 3.35 TB/s. The hop schedule
returns with peer-to-peer writes between cards (ROADMAP A.10). It takes
``int32`` words, the port's convention, in chunks of any length.

The chunks come either as a list of 1-D tensors or as the rows of one 2-D
tensor, whose row stride may exceed the chunk (the sharded wave passes the
first ``n_local/32`` words of each row of its next-frontier tensor): the
rows go to the kernel as a base pointer and a row stride.

Yardsticks in ``chip_smoke.py``: one PyTorch computation of the same
function (``torch.cat`` of the chunks broadcast into ``n`` rows), and
``torch.cat`` alone, the one-copy exchange ``exchange="packed"`` does; the
ring path calls neither.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from . import _build

__all__ = ["ring_all_gather", "ring_all_gather_plain", "launches", "cuda_launches", "MAX_SHARDS"]

#: gathers since the last reset (the wrapper adds one per kernel call)
launches = 0
#: CUDA kernel launches since the last reset: one per gather (the hop
#: schedule of the earlier kernel enqueued ``n``)
cuda_launches = 0

#: the kernel's row table holds this many shards
MAX_SHARDS = 64

Chunks = Union[Sequence[torch.Tensor], torch.Tensor]


def ring_all_gather_plain(chunks: Chunks) -> torch.Tensor:
    """Plain PyTorch version: the hop schedule, step by step, with
    double-buffered copies between the shards' own comm buffers. Returns
    int32[n, n * c], row ``d`` being shard ``d``'s output."""
    n, c = len(chunks), chunks[0].shape[0]
    device = chunks[0].device
    out = torch.empty(n, n * c, dtype=torch.int32, device=device)
    comm = torch.empty(n, 2, c, dtype=torch.int32, device=device)
    for d in range(n):
        out[d, d * c:(d + 1) * c] = chunks[d]
        comm[d, 0] = chunks[d]
    for step in range(n - 1):
        send, recv = step % 2, 1 - step % 2
        for d in range(n):  # every send of a hop reads slot `send` only
            comm[(d + 1) % n, recv] = comm[d, send]
        for d in range(n):
            owner = (d - step - 1) % n
            out[d, owner * c:(owner + 1) * c] = comm[d, recv]
    return out


def _check(chunks: Chunks) -> None:
    if isinstance(chunks, torch.Tensor):  # shapes only: indexing a row costs a view
        if chunks.dtype != torch.int32 or chunks.dim() != 2 or chunks.stride(1) != 1:
            raise ValueError(
                "ring_all_gather: rows must be a 2-D int32 tensor with unit column stride"
            )
        n, c = chunks.shape
    else:
        if not chunks:
            raise ValueError("ring_all_gather: needs at least one shard")
        first = chunks[0]
        for x in chunks:
            if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
                raise ValueError(
                    "ring_all_gather: every chunk must be a contiguous 1-D int32 tensor"
                )
            if x.shape != first.shape or x.device != first.device:
                raise ValueError("ring_all_gather: chunks must share one length and one device")
        n, c = len(chunks), first.shape[0]
    if n == 0:
        raise ValueError("ring_all_gather: needs at least one shard")
    if n > MAX_SHARDS:
        raise ValueError(f"ring_all_gather: at most {MAX_SHARDS} shards")
    if c == 0:
        raise ValueError("ring_all_gather: chunks must hold at least one word")


def ring_all_gather(chunks: Chunks) -> torch.Tensor:
    """All-gather ``n`` shards' int32 chunks (a list of 1-D tensors, or the
    rows of a 2-D tensor): returns int32[n, n * chunk], row ``d`` being
    shard ``d``'s output, every chunk in shard order. A CPU tensor takes the
    plain version; a CUDA tensor launches ``csrc/ring_all_gather.cu`` or
    raises."""
    global launches, cuda_launches
    _check(chunks)
    rows = isinstance(chunks, torch.Tensor)
    device = chunks.device if rows else chunks[0].device
    if device.type == "cpu":
        return ring_all_gather_plain(chunks)
    if device.type != "cuda":
        raise ValueError(f"ring_all_gather: unsupported device {device}")
    n, c = chunks.shape if rows else (len(chunks), chunks[0].shape[0])
    out = torch.empty(n, n * c, dtype=torch.int32, device=device)
    if rows:
        _build.launch("ring_all_gather", "ring_all_gather_rows_launch", chunks.data_ptr(),
                      chunks.stride(0), out.data_ptr(), n, c)
    else:
        table = (ctypes.c_void_p * n)(*(x.data_ptr() for x in chunks))
        _build.launch("ring_all_gather", "ring_all_gather_table_launch", table,
                      out.data_ptr(), n, c)
    launches += 1
    cuda_launches += 1
    return out
