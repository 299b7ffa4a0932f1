"""The columnar refresh of a bound row block: select the loader's fresh rows
where the graph holds the row's node invalid, mark them valid, clear the
block's invalid bits.

The counterpart of the XLA program ``TpuGraphBackend.refresh_block_on_device``
jits in ``stl_fusion_tpu/graph/backend.py`` (no Pallas kernel there). JAX
slices a bool invalid array; here the invalid state is packed int32 words
(node ``i`` is bit ``i & 31`` of word ``i >> 5``), and no single PyTorch
operation reads or clears a bit range at an unaligned node offset, hence
the hand-written kernel ``csrc/block_refresh.cu``. :func:`block_refresh`
launches it for CUDA tensors and takes :func:`block_refresh_plain` for CPU
tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["block_refresh", "block_refresh_plain", "launches", "loader_rows"]

#: block_refresh kernel launches since the last reset (one per refresh)
launches = 0
#: timing hook, off when None: set to a list, each launch appends the pair
#: of CUDA events recorded on the stream just before and just after it
timing = None


def loader_rows(fn, largs, values: torch.Tensor) -> torch.Tensor:
    """Every row of a table through its device loader, ``fn(arange(n_rows),
    *largs)``, as a contiguous tensor with ``values``' shape, dtype and
    device (the ``fresh`` argument of :func:`block_refresh`)."""
    ids = torch.arange(values.shape[0], dtype=torch.int64, device=values.device)
    fresh = torch.as_tensor(fn(ids, *largs), device=values.device)
    if fresh.dtype != values.dtype:
        fresh = fresh.to(values.dtype)
    if fresh.shape != values.shape:
        fresh = fresh.expand(values.shape)
    return fresh.contiguous()


def _range_bits(words: torch.Tensor, base: int, n_rows: int) -> torch.Tensor:
    """bool[n_rows]: bit ``base + r`` of ``words`` for each row ``r``."""
    node = torch.arange(base, base + n_rows, dtype=torch.int64, device=words.device)
    return ((words[node >> 5] >> (node & 31)) & 1).bool()


def _clear_range(words: torch.Tensor, base: int, n_rows: int) -> None:
    """Clear bits ``[base, base + n_rows)`` of ``words`` in place; the
    partial words at both ends keep their bits outside the range."""
    end = base + n_rows
    w = torch.arange(base >> 5, (end + 31) >> 5, dtype=torch.int64, device=words.device)
    lo = torch.clamp(base - 32 * w, min=0)
    hi = torch.clamp(end - 32 * w, max=32)
    span = (1 << hi) - (1 << lo)  # bits [lo, hi) of the word, in int64
    span = torch.where(span >= 2**31, span - 2**32, span).to(torch.int32)
    words[w] &= ~span


def block_refresh_plain(words: torch.Tensor, values: torch.Tensor, fresh: torch.Tensor,
                        valid: Optional[torch.Tensor], base: int) -> None:
    """Plain PyTorch version of :func:`block_refresh`, same arguments."""
    n_rows = values.shape[0]
    if n_rows == 0:
        return
    bit = _range_bits(words, base, n_rows)
    mask = bit.view((n_rows,) + (1,) * (values.dim() - 1))
    values.copy_(torch.where(mask, fresh, values))
    if valid is not None:
        valid |= bit
    _clear_range(words, base, n_rows)


def block_refresh(words: torch.Tensor, values: torch.Tensor, fresh: torch.Tensor,
                  valid: Optional[torch.Tensor], base: int) -> None:
    """For every row ``r`` of ``values`` whose node ``base + r`` has its bit
    set in the packed int32 ``words``: ``values[r] = fresh[r]`` and, when
    ``valid`` (bool[n_rows]) is given, ``valid[r] = True``; then clear bits
    ``[base, base + n_rows)`` of ``words``. Everything updates IN PLACE.
    ``fresh`` has ``values``' shape and dtype. A CPU tensor takes
    :func:`block_refresh_plain`; a CUDA tensor launches
    ``csrc/block_refresh.cu`` or raises."""
    global launches
    n_rows = values.shape[0] if values.dim() else -1
    device = words.device
    if words.dtype != torch.int32 or words.dim() != 1 or not words.is_contiguous():
        raise ValueError("block_refresh: words must be a contiguous 1-D int32 tensor")
    if n_rows < 0 or not values.is_contiguous() or values.device != device:
        raise ValueError(f"block_refresh: values must be a contiguous tensor of rows on {device}")
    if (fresh.shape != values.shape or fresh.dtype != values.dtype or fresh.device != device
            or not fresh.is_contiguous()):
        raise ValueError("block_refresh: fresh must be contiguous, with values' shape, dtype "
                         "and device")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (n_rows,)
                              or valid.device != device or not valid.is_contiguous()):
        raise ValueError("block_refresh: valid must be a contiguous bool[n_rows] tensor")
    if base < 0 or base + n_rows > 32 * words.shape[0]:
        raise ValueError(f"block_refresh: rows [{base}, {base + n_rows}) lie outside the "
                         f"{32 * words.shape[0]} bits of words")
    if device.type == "cpu":
        return block_refresh_plain(words, values, fresh, valid, base)
    if device.type != "cuda":
        raise ValueError(f"block_refresh: unsupported device {device}")
    if n_rows == 0:
        return None
    row_bytes = values.element_size() * values[0].numel()
    if row_bytes == 0:
        raise ValueError("block_refresh: rows of zero bytes")
    chunk = next(c for c in (16, 4, 1) if row_bytes % c == 0
                 and values.data_ptr() % c == 0 and fresh.data_ptr() % c == 0)
    events = None
    if timing is not None:
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record()
    _build.launch("block_refresh", "block_refresh_launch", words.data_ptr(), fresh.data_ptr(),
                  values.data_ptr(), None if valid is None else valid.data_ptr(), base, n_rows,
                  row_bytes, chunk)
    launches += 1
    if events is not None:
        events[1].record()
        timing.append(events)
    return None
