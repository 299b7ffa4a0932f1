"""``or_popcount`` — merge and count invalidation bits, as a hand-written
Hopper kernel.

Replaces ``stl_fusion_tpu/ops/pallas_kernels.py::or_popcount``
(``_or_popcount_kernel`` / ``_or_popcount_2d``): merge a new invalidation
bit vector into the accumulated one and count the newly lit bits,
``popcount(new & ~old)``, in one pass over the words. One kernel
(``csrc/or_popcount.cu``) in four forms, each one launch and each with its
plain PyTorch version here:

- :func:`or_popcount` (merge): ``out = old | new``; the union's seed merge;
- :func:`or_popcount_gate` (gate): the merge, and ``delta = new & ~old``,
  the fresh seeds, written too; the dense wave's seed gate
  (``stl_fusion_tpu/ops/wave.py:103-105``, ``:141-143``);
- :func:`or_popcount_delta` (delta): ``new & ~old`` and its count, no merge;
  the union finalize (``stl_fusion_tpu/ops/wave.py:202-205``);
- :func:`or_popcount_shards` (shards): every shard of a one-card mesh in
  one launch, each shard's frontier row merged into its invalid words; the
  sharded wave's seed step.

The TPU kernel's count is int32 and wraps past 2³¹ bits; the port returns
**int64** counts. Bound on the H100: bytes (12 B a word, 16 B for the
gate); at 524,289 words that is ~2 µs, less than the host's launch path.
So the count needs no memset: the kernel writes it (the last block sums
the blocks' partials, see the source), each call is one launch, and the
wrapper does only what it must: cheap checks, ``torch.empty`` for the
outputs, and a C entry resolved once (:func:`._build.entry`) whose
arguments go as one packed bytes object. The count's accumulators are kept
per device and stream, so launches on two streams never share one; a launch
under CUDA graph capture raises, since a replay would run on another stream
with the capture stream's accumulators.
"""
from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = [
    "or_popcount", "or_popcount_plain", "or_popcount_gate", "or_popcount_gate_plain",
    "or_popcount_delta", "or_popcount_delta_plain", "or_popcount_shards",
    "or_popcount_shards_plain", "launches", "form_launches",
]

#: kernel launches since the last reset, of every form (one a call)
launches = 0
#: the same launches by form
form_launches = {"merge": 0, "gate": 0, "delta": 0, "shards": 0}

_FORMS = {"merge": 0, "gate": 1, "delta": 2, "shards": 3}
#: the C entry's ``LaunchArgs``: 12 int64, packed into one bytes object a
#: call (a 2-argument ctypes call; 13 converted arguments cost ~2 µs more)
_ARGS = struct.Struct("<12q")
#: the fewest accumulators a stream's scratch holds (one a shard; the
#: single forms use one)
_SLOTS = 64

_I32 = torch.int32
#: counts a block of :func:`_count` holds (the block's views are made at
#: once, so a larger block makes a longer pause)
_COUNT_BLOCK = 64

_POPC8: Dict[torch.device, torch.Tensor] = {}
_entry = None  # the C entry, resolved at the first launch
#: card index → the current block's count views not handed out yet
_COUNTS: Dict[int, list] = {}
#: (device index, raw stream) → (scratch int64[1 + slots], its address, slots)
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, int, int]] = {}


def _popc8(device: torch.device) -> torch.Tensor:
    """256-entry popcount lookup table (torch has no popcount op)."""
    t = _POPC8.get(device)
    if t is None:
        t = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64,
                         device=device)
        _POPC8[device] = t
    return t


def _popcount(words: torch.Tensor) -> torch.Tensor:
    return _popc8(words.device)[words.contiguous().view(torch.uint8).long()].sum()


# ------------------------------------------------------------------ plain versions
def or_popcount_plain(
    new_bits: torch.Tensor, old_bits: torch.Tensor, out: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`or_popcount`: ``(old | new,
    popcount(new & ~old))``; the count is a 0-d int64. ``out`` may be
    ``old_bits`` (the count is taken before the merge is written)."""
    count = _popcount(new_bits & ~old_bits)
    return torch.bitwise_or(new_bits, old_bits, out=out), count


def or_popcount_gate_plain(
    new_bits: torch.Tensor, old_bits: torch.Tensor, out: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`or_popcount_gate`: ``(old | new,
    new & ~old, popcount(new & ~old))``. ``out`` may be ``old_bits`` and
    ``delta`` may be ``new_bits``."""
    fresh = new_bits & ~old_bits
    merged = torch.bitwise_or(new_bits, old_bits, out=out)
    if delta is not None:
        fresh = delta.copy_(fresh)
    return merged, fresh, _popcount(fresh)


def or_popcount_delta_plain(
    new_bits: torch.Tensor, old_bits: torch.Tensor, delta: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`or_popcount_delta`: ``(new & ~old,
    its popcount)``; neither input changes unless ``delta`` is one of them."""
    fresh = torch.bitwise_and(new_bits, ~old_bits, out=delta)
    return fresh, _popcount(fresh)


def or_popcount_shards_plain(frontier: torch.Tensor, table) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`or_popcount_shards`: one
    :func:`or_popcount_plain` per shard, into its invalid words."""
    counts = [or_popcount_plain(frontier[d, :table.words], s.invalid, out=s.invalid)[1]
              for d, s in enumerate(table.shards)]
    counts = torch.stack(counts)
    return counts, counts.sum()


# ------------------------------------------------------------------ the kernel
def _addr(t: torch.Tensor, shape: torch.Size, dev: int) -> int:
    """``t``'s address under the one rule set of both paths: a contiguous
    int32 tensor of ``shape`` on device ``dev`` (``get_device()``: -1 for the
    CPU), on a card 16-byte aligned (int4 loads); else a ValueError that
    names the rule. A few attribute reads."""
    if t.dtype is not _I32 or t.shape != shape or not t.is_contiguous():
        raise ValueError("or_popcount: operands must be contiguous 1-D int32 tensors of "
                         "new_bits' shape")
    if t.get_device() != dev:
        raise ValueError("or_popcount: operands must be on new_bits' device")
    p = t.data_ptr()
    if p & 15 and dev >= 0:
        raise ValueError("or_popcount: tensors must be 16-byte aligned")
    return p


def _addrs(new_bits: torch.Tensor, old_bits: torch.Tensor, out: Optional[torch.Tensor] = None,
           delta: Optional[torch.Tensor] = None) -> Tuple[int, int, int, int]:
    """The operands' addresses (0 for None) after :func:`_addr`'s checks;
    ``new_bits`` is 1-D on the CPU or a card. An alias (``out`` is
    ``old_bits``, ``delta`` is ``new_bits``) reuses its operand's check."""
    shape, dev = new_bits.shape, new_bits.get_device()
    if len(shape) != 1 or (dev < 0 and new_bits.device.type != "cpu"):
        raise ValueError(f"or_popcount: new_bits must be 1-D on the CPU or a card, not "
                         f"{tuple(shape)} on {new_bits.device}")
    new_p, old_p = _addr(new_bits, shape, dev), _addr(old_bits, shape, dev)
    out_p = 0 if out is None else old_p if out is old_bits else _addr(out, shape, dev)
    delta_p = 0 if delta is None else new_p if delta is new_bits else _addr(delta, shape, dev)
    return new_p, old_p, out_p, delta_p


def _count(dev: int) -> torch.Tensor:
    """A fresh 0-d int64 on card ``dev``: a view of a block of
    :data:`_COUNT_BLOCK`, handed out once (the view keeps its block alive,
    so a returned count stays valid). ``unbind`` makes a block's views in
    one call, which costs less a view than an ``empty_like`` a count."""
    spare = _COUNTS.get(dev)
    if not spare:
        block = torch.empty(_COUNT_BLOCK, dtype=torch.int64, device=torch.device("cuda", dev))
        spare = _COUNTS[dev] = list(block.unbind())
    return spare.pop()


def _launch(form: str, dev: int, new_ptr: int, row_stride: int, old_ptr: int, out_ptr: int,
            delta_ptr: int, rows_ptr: int, n_rows: int, n: int, counts: torch.Tensor) -> None:
    """One launch of ``form`` on card ``dev``'s current stream. Not under
    CUDA graph capture: a captured launch would keep the capture stream's
    accumulators, which a replay on another stream, or beside an eager call,
    would share."""
    global _entry, launches
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("or_popcount: a launch cannot be captured in a CUDA graph (its "
                           "count's accumulators are kept per stream)")
    if _entry is None:
        _entry = _build.entry("or_popcount", "or_popcount_launch")
    stream = torch._C._cuda_getCurrentRawStream(dev)
    scratch = _scratch.get((dev, stream))
    if scratch is None or scratch[2] < n_rows:
        slots = max(_SLOTS, n_rows)
        t = torch.zeros(1 + slots, dtype=torch.int64, device=torch.device("cuda", dev))
        scratch = _scratch[(dev, stream)] = (t, t.data_ptr(), slots)
    err = _entry(_ARGS.pack(_FORMS[form], new_ptr, row_stride, old_ptr, out_ptr, delta_ptr,
                            rows_ptr, n_rows, n, scratch[1], scratch[2], counts.data_ptr()),
                 stream)
    if err != 0:
        raise RuntimeError(f"or_popcount: or_popcount_launch failed with CUDA error {err}")
    launches += 1
    form_launches[form] += 1


def or_popcount(
    new_bits: torch.Tensor, old_bits: torch.Tensor, out: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(old | new, popcount(new & ~old))`` over 1-D int32 words (merge).

    Returns (merged int32[n], newly-lit bit count as a 0-d int64). ``out``
    receives the merge and may be ``old_bits`` itself (in-place merge: every
    word is read before it is written, by the same thread). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    """
    if not new_bits.is_cuda:
        _addrs(new_bits, old_bits, out)
        return or_popcount_plain(new_bits, old_bits, out)
    merged = torch.empty_like(new_bits) if out is None else out
    new_ptr, old_ptr, out_ptr, _ = _addrs(new_bits, old_bits, merged)
    dev = new_bits.get_device()
    count = _count(dev)
    _launch("merge", dev, new_ptr, 0, old_ptr, out_ptr, 0, 0, 1, new_bits.shape[0], count)
    return merged, count


def or_popcount_gate(
    new_bits: torch.Tensor, old_bits: torch.Tensor, out: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The seed gate in one pass (gate): ``out = old | new``, ``delta = new
    & ~old`` (the fresh seeds) and ``popcount(new & ~old)``.

    Returns (merged, delta, count as a 0-d int64). ``out`` may be
    ``old_bits`` and ``delta`` may be ``new_bits``: each word is read before
    either output is written, by the same thread. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if not new_bits.is_cuda:
        _addrs(new_bits, old_bits, out, delta)
        return or_popcount_gate_plain(new_bits, old_bits, out, delta)
    merged = torch.empty_like(new_bits) if out is None else out
    fresh = torch.empty_like(new_bits) if delta is None else delta
    new_ptr, old_ptr, out_ptr, delta_ptr = _addrs(new_bits, old_bits, merged, fresh)
    dev = new_bits.get_device()
    count = _count(dev)
    _launch("gate", dev, new_ptr, 0, old_ptr, out_ptr, delta_ptr, 0, 1, new_bits.shape[0], count)
    return merged, fresh, count


def or_popcount_delta(
    new_bits: torch.Tensor, old_bits: torch.Tensor, delta: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(new & ~old, popcount(new & ~old))`` with no merge (delta): the
    union finalize, the words a wave lit and their count. Neither input is
    written unless ``delta`` is one of them. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if not new_bits.is_cuda:
        _addrs(new_bits, old_bits, delta=delta)
        return or_popcount_delta_plain(new_bits, old_bits, delta)
    fresh = torch.empty_like(new_bits) if delta is None else delta
    new_ptr, old_ptr, _, delta_ptr = _addrs(new_bits, old_bits, delta=fresh)
    dev = new_bits.get_device()
    count = _count(dev)
    _launch("delta", dev, new_ptr, 0, old_ptr, 0, delta_ptr, 0, 1, new_bits.shape[0], count)
    return fresh, count


def or_popcount_shards(frontier: torch.Tensor, table) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge row ``d`` of ``frontier`` into shard ``d``'s invalid words, for
    every shard of a one-card mesh in one launch (shards).

    ``table`` is the mesh's :class:`~.wave.ShardTable`: each shard's invalid
    words (``table.words`` of them, updated IN PLACE) are addressed through
    the device table it uploaded once, so a call uploads nothing.
    ``frontier`` is int32[n, width >= words] with unit column stride; only
    each row's first ``table.words`` words are read. Returns (the newly lit
    bits per shard int64[n], their total as a 0-d int64). A CPU table
    takes the plain version; a CUDA one launches the kernel or raises."""
    n_rows = len(table)
    if (frontier.dtype != torch.int32 or frontier.dim() != 2 or frontier.shape[0] != n_rows
            or frontier.shape[1] < table.words or frontier.stride(1) != 1):
        raise ValueError("or_popcount: the frontier must be int32[n shards, >= words] rows")
    if frontier.device != table.device:
        raise ValueError("or_popcount: the frontier must be on the shard table's device")
    if not frontier.is_cuda:  # the table's device: the CPU or a card
        return or_popcount_shards_plain(frontier, table)
    ptr = frontier.data_ptr()
    if ptr % 16 or frontier.stride(0) % 4 or not table.invalid_aligned:
        raise ValueError("or_popcount: tensors must be 16-byte aligned")
    counts = torch.empty(n_rows + 1, dtype=torch.int64, device=frontier.device)
    _launch("shards", frontier.get_device(), ptr, frontier.stride(0), 0, 0, 0,
            table.table.data_ptr(), n_rows, table.words, counts)
    return counts[:n_rows], counts[n_rows]
