"""``packed_pull`` — one level of the bit-packed pull wave, as a hand-written
Hopper kernel, and the level loop both pull waves run.

Replaces two XLA programs (the JAX package has no Pallas kernel for
either): the level body of
``stl_fusion_tpu/parallel/packed_wave.py::build_packed_sharded_wave``
(``packed_wave.py:93-113``: the all-gather of the frontier words, the
gather of each row's ≤ k in-rows, the epoch-masked OR-fold, the merge into
``invalid``, the count and the continuation ``psum``) and the level of
``stl_fusion_tpu/ops/pull_wave.py::_pull_wave32_impl`` (``pull_wave.py:
159-168``: one shard, W = 1, the null row's fire forced to 0). Each row
holds its in-slots (``in_src``, ``edge_epoch``) and W int32 words, 32·W
packed waves (wave ``l`` is bit ``l % 32`` of word ``l // 32``; lane 31 is
the sign bit). A slot is live when its epoch equals the row's
``node_epoch``; a level's fire is the OR of the live slots' frontier rows,
less the row's invalid bits.

Kernel: ``csrc/packed_pull.cu``, one launch per level over all rows (on a
one-card mesh of logical shards the shards' frontier words are the row
blocks of one tensor, so the all-gather IS that tensor). Frontier and next
are separate tensors (Jacobi, as JAX).

**The fired summary.** Frontier row ``s`` is non-zero exactly when row
``s`` fired in the level before, so beside the words each launch can take
the previous level's summary (``summary_in``: int32 ``[ceil(rows / 32)]``,
bit ``r % 32`` of word ``r // 32`` set when row ``r`` fired) and write its
own (``summary_out``). A level given ``summary_in`` gathers a slot only
when its source is in range, its bit is set and the slot's epoch matches:
a zero frontier row is never read. A launch given ``summary_out`` writes
``next`` ONLY for the rows that fire; every other row of ``next`` is left
as it was, and a reader treats a row whose bit is clear as zero. No result
changes: :func:`run_pull_wave` owns both frontier buffers and both
summaries, and its callers see only ``invalid`` and ``counts``. Without
the summaries every row is read and every row's ``next`` written, as
before (the mode the card test ``test_packed_pull_kernel_matches_plain``
holds).

Its bound on the H100 is bytes, and what a level needs depends on its
frontier: each row's slot ids (``4k`` B) and the summary read and written
(``rows / 8`` B each); for a row with a live slot whose source fired, the
epochs of those slots, its ``node_epoch``, its invalid words and ``4W`` B
per gathered row; for a row that fires, its invalid and next words written
and ``is_real``. A full-table level (every row read and written) moves
``rows·(8k + 5 + 12W) + lit_rows·4W``, about 2.6 GB at 10M rows, k = 8 and
W = 16; a level lighting 48,023 rows needs ~0.4 GB. The design (see the
source): a warp owns one summary word, 32 rows; a scan lane a row loads
its slot ids as 16- or 8-byte vectors, tests the sources' bits first and
loads epochs only for slots whose source fired; then W/4 lanes a row with
16-byte loads when W % 4 == 0 (else a lane a word) gather, merge and
store, in passes over only the rows with a slot to gather; the rows that
fire OR their bits into the summary word, one store; per-block counts,
one atomic per word and block.

**Early exit.** A launch given ``flag_in`` returns at once when the flag is
0 (the previous level lit nothing). :func:`run_pull_wave` enqueues the
levels in groups of :data:`GROUP` (8), each level reading
the flag the one before it wrote, and reads the group's flags once: one
host sync per group instead of one per level.

**Two count semantics**, one kernel: the mesh wave counts the bits newly
lit by the call (``count_all=False``); the pull wave counts every real
invalid bit after it, cumulative (``count_all=True``: the seed step counts
``before | fire``, the levels their fire).

Counters: ``launches`` (every CUDA launch, the wrapper adds one where it
launches) and ``early_exits`` (the launches that found the previous
level's flag 0 and returned at once, added by :func:`run_pull_wave` at its
readback): the levels run are their difference. A CPU tensor takes
:func:`packed_pull_plain`; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .bitops import n_words, pack_bits, unpack_bits
from .or_popcount import _popc8

__all__ = [
    "GROUP",
    "early_exits",
    "launches",
    "packed_pull",
    "packed_pull_level_plain",
    "packed_pull_plain",
    "run_pull_wave",
]

#: CUDA launches of the kernel since the last reset (one per wrapper call on the card)
launches = 0
#: of those, the launches that returned at once (the previous level lit nothing)
early_exits = 0
#: levels enqueued between two reads of the continuation flags
GROUP = 8


def _popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-column popcounts of int32 ``[rows, W]`` words, summed over the
    rows: int32[W] (torch has no popcount: a table over the bytes)."""
    rows, w = words.shape
    per_byte = _popc8(words.device)[words.contiguous().view(torch.uint8).long()]
    return per_byte.view(rows, w, 4).sum(dim=(0, 2)).to(torch.int32)


def packed_pull_level_plain(in_src, edge_epoch, node_epoch, frontier, invalid,
                            null_row: int = -1) -> torch.Tensor:
    """One level, JAX's body step by step (``packed_wave.py:97-104``,
    ``pull_wave.py:159-167``): ``live = edge_epoch == node_epoch[:, None]``,
    the OR over live slots of ``frontier[in_src]``, less ``invalid``, 0 at
    ``null_row`` (``< 0``: none); ``invalid |= fire`` IN PLACE. The OR-fold
    gathers one slot at a time (a ``[rows, k, W]`` gather at 10M rows is
    5 GB). Returns ``fire`` ``[rows, W]``."""
    live = edge_epoch == node_epoch[:, None]
    fire = torch.zeros_like(invalid)
    for j in range(in_src.shape[1]):
        fire |= torch.where(live[:, j, None], frontier[in_src[:, j].long()], 0)
    fire &= ~invalid
    if null_row >= 0:
        fire[null_row] = 0
    invalid |= fire
    return fire


def packed_pull_plain(in_src, edge_epoch, node_epoch, is_real, frontier, next_, invalid,
                      counts, gather: bool = True, flag_in=None, flag_out=None,
                      null_row: int = -1, count_all: bool = False, summary_in=None,
                      summary_out=None) -> None:
    """Plain PyTorch version of :func:`packed_pull` (same arguments, same
    in-place results). With ``summary_in`` the level reads the frontier
    masked by it (a row whose bit is clear is zero, whatever it holds);
    with ``summary_out`` only the rows that fire are written to ``next_``
    and the summary is ``(fire != 0).any(1)``, packed."""
    if flag_in is not None and int(flag_in.reshape(-1)[0]) == 0:
        return
    if gather:
        if summary_in is not None:
            lit = unpack_bits(summary_in, frontier.shape[0])
            frontier = torch.where(lit[:, None], frontier, 0)
        fire = packed_pull_level_plain(in_src, edge_epoch, node_epoch, frontier, invalid,
                                       null_row)
    else:
        fire = frontier & ~invalid
        invalid |= fire
    if summary_out is None:
        next_.copy_(fire)
    else:
        fired = (fire != 0).any(dim=1)
        next_[fired] = fire[fired]
        summary_out.copy_(pack_bits(fired))
    counted = invalid if count_all else fire
    counts += _popcount_words(torch.where(is_real[:, None], counted, 0))
    if flag_out is not None and bool((fire != 0).any()):
        flag_out.fill_(1)


def _check(in_src, edge_epoch, node_epoch, is_real, frontier, next_, invalid, counts,
           flag_in, flag_out, gather, summary_in, summary_out) -> None:
    device = invalid.device
    n, w = invalid.shape if invalid.dim() == 2 else (-1, -1)
    words = (n_words(n),) if n >= 0 else None
    for name, t, dtype, shape in (
            ("in_src", in_src, torch.int32, None), ("edge_epoch", edge_epoch, torch.int32, None),
            ("node_epoch", node_epoch, torch.int32, (n,)), ("is_real", is_real, torch.bool, (n,)),
            ("frontier", frontier, torch.int32, (n, w)), ("next", next_, torch.int32, (n, w)),
            ("invalid", invalid, torch.int32, (n, w)), ("counts", counts, torch.int32, (w,)),
            ("flag_in", flag_in, torch.int32, None), ("flag_out", flag_out, torch.int32, None),
            ("summary_in", summary_in, torch.int32, words),
            ("summary_out", summary_out, torch.int32, words)):
        if t is None and (name.startswith("flag") or name.startswith("summary")):
            continue
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"packed_pull: {name} must be a contiguous {dtype} tensor on {device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"packed_pull: {name} has shape {tuple(t.shape)}, not {shape} "
                             f"(invalid is [rows, W], a summary int32[ceil(rows / 32)])")
    if in_src.dim() != 2 or in_src.shape[0] != n or edge_epoch.shape != in_src.shape:
        raise ValueError("packed_pull: in_src and edge_epoch must be [rows, k]")
    if next_.data_ptr() == frontier.data_ptr():
        raise ValueError("packed_pull: frontier and next must be separate tensors")
    if summary_in is not None and not gather:
        raise ValueError("packed_pull: summary_in is a level's input; the seed step reads "
                         "the seed words of every row")
    if (summary_in is not None and summary_out is not None
            and summary_in.data_ptr() == summary_out.data_ptr()):
        raise ValueError("packed_pull: summary_in and summary_out must be separate tensors")


def _slot_vec(k: int, in_src, edge_epoch) -> int:
    """Slots per load: 4 (one int4) or 2 (one int2) when ``k`` is a
    multiple and both tables are aligned to it, else 1."""
    for sv in (4, 2):
        if k % sv == 0 and all(t.data_ptr() % (4 * sv) == 0 for t in (in_src, edge_epoch)):
            return sv
    return 1


def packed_pull(in_src, edge_epoch, node_epoch, is_real, frontier, next_, invalid, counts,
                gather: bool = True, flag_in: Optional[torch.Tensor] = None,
                flag_out: Optional[torch.Tensor] = None, null_row: int = -1,
                count_all: bool = False, summary_in: Optional[torch.Tensor] = None,
                summary_out: Optional[torch.Tensor] = None) -> None:
    """One level (``gather``) or the seed step (``frontier`` holds the seed
    words) over all rows: ``fire`` (see the module note) is written to
    ``next_``, OR'ed into ``invalid`` and popcounted per word into
    ``counts`` (int32[W], real rows; ``count_all`` counts ``invalid`` after
    the step instead); ``flag_out`` (one int32, not cleared here) is set to
    1 when anything fired. With ``flag_in`` (one int32) at 0 nothing
    happens. ``summary_in`` (a level only) is the previous level's fired
    summary: frontier rows whose bit is clear are zero and never read.
    ``summary_out`` receives this launch's summary, and then ``next_`` is
    written only on the rows that fire. ``in_src``/``edge_epoch`` are int32
    ``[rows, k]``, ``node_epoch`` int32 ``[rows]``, ``is_real`` bool
    ``[rows]``, the words int32 ``[rows, W]``, a summary int32
    ``[ceil(rows / 32)]``. A CPU tensor takes :func:`packed_pull_plain`; a
    CUDA tensor launches ``csrc/packed_pull.cu`` or raises."""
    global launches
    _check(in_src, edge_epoch, node_epoch, is_real, frontier, next_, invalid, counts, flag_in,
           flag_out, gather, summary_in, summary_out)
    device = invalid.device
    if device.type == "cpu":
        return packed_pull_plain(in_src, edge_epoch, node_epoch, is_real, frontier, next_,
                                 invalid, counts, gather, flag_in, flag_out, null_row, count_all,
                                 summary_in, summary_out)
    if device.type != "cuda":
        raise ValueError(f"packed_pull: unsupported device {device}")
    n, w = invalid.shape
    k = in_src.shape[1]
    vec4 = w % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (frontier, next_, invalid))
    if w > 1024:
        raise ValueError("packed_pull: the kernel takes at most W = 1024 words a row")
    _build.launch(
        "packed_pull", "packed_pull_launch", in_src.data_ptr(), edge_epoch.data_ptr(),
        node_epoch.data_ptr(), is_real.data_ptr(), frontier.data_ptr(), next_.data_ptr(),
        invalid.data_ptr(), counts.data_ptr(),
        None if flag_in is None else flag_in.data_ptr(),
        None if flag_out is None else flag_out.data_ptr(),
        None if summary_in is None else summary_in.data_ptr(),
        None if summary_out is None else summary_out.data_ptr(),
        n, k, w, null_row, int(gather), int(count_all), int(vec4),
        _slot_vec(k, in_src, edge_epoch),
    )
    launches += 1


def _wave_buffers(invalid: torch.Tensor) -> tuple:
    """A wave's scratch: two frontier buffers shaped like ``invalid`` and two
    fired summaries. Nothing in them is read before the wave writes it."""
    summary = (n_words(invalid.shape[0]),)
    return (torch.empty_like(invalid), torch.empty_like(invalid),
            torch.empty(summary, dtype=torch.int32, device=invalid.device),
            torch.empty(summary, dtype=torch.int32, device=invalid.device))


def run_pull_wave(in_src, edge_epoch, node_epoch, is_real, seeds, invalid, counts,
                  null_row: int = -1, count_all: bool = False,
                  stats: Optional[dict] = None) -> int:
    """A whole wave: the seed step (``seeds & ~invalid`` is the first
    frontier), then levels until one lights nothing, as JAX's
    ``lax.while_loop``. ``invalid`` updates IN PLACE and ``counts``
    (int32[W]) accumulates IN PLACE; both are ``[rows, W]``-shaped as in
    :func:`packed_pull`. Every launch passes the fired summaries: the seed
    step writes the first, each level reads the one before and writes its
    own, so no level reads a zero frontier row (the frontier buffers are
    defined only under their summary, and never leave this function).
    Levels go out in groups of :data:`GROUP`, and the group's flags are
    read once (one host sync). Returns the levels run (JAX's loop trips);
    ``stats`` (optional) accumulates ``levels``, ``syncs`` and
    ``early_exits``."""
    global early_exits
    group = GROUP
    frontier, nxt, summary, summary_next = _wave_buffers(invalid)
    flags = torch.zeros(group + 1, dtype=torch.int32, device=invalid.device)
    packed_pull(in_src, edge_epoch, node_epoch, is_real, seeds, frontier, invalid, counts,
                gather=False, flag_out=flags[:1], count_all=count_all, summary_out=summary)
    levels = syncs = skipped = 0
    while True:
        for i in range(group):
            packed_pull(in_src, edge_epoch, node_epoch, is_real, frontier, nxt, invalid, counts,
                        flag_in=flags[i:i + 1], flag_out=flags[i + 1:i + 2], null_row=null_row,
                        summary_in=summary, summary_out=summary_next)
            frontier, nxt = nxt, frontier
            summary, summary_next = summary_next, summary
        seen = flags.tolist()  # the group's one host sync
        syncs += 1
        ran = sum(1 for f in seen[:group] if f)
        levels += ran
        if invalid.device.type == "cuda":
            skipped += group - ran
        if not seen[group]:
            break
        flags.zero_()
        flags[:1].fill_(1)  # the last level lit something: the next group runs
    early_exits += skipped
    if stats is not None:
        for key, v in (("levels", levels), ("syncs", syncs), ("early_exits", skipped)):
            stats[key] = stats.get(key, 0) + v
    return levels
