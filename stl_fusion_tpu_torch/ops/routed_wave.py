"""``routed_level`` — one level of the cluster-routed mesh wave, as a
hand-written Hopper kernel, with its plain PyTorch version beside it.

Replaces the XLA level of
``stl_fusion_tpu/parallel/routed_wave.py::build_routed_wave`` (the JAX
package has no Pallas kernel for it): ``merge_fire`` (``:297-310``, the
sync body ``:357-371``) and the asynchronous mode's speculative local level
(``spec_body``, ``:314-327``), for every shard of a one-card mesh in one
launch, as :func:`~.wave.wave_expand_shards` does for the sharded wave. The
seed step (``fresh = seeds & ~inv``, ``inv |= seeds``, the fresh count and
the any-seed flag, ``:292-295``) is a third form.

Layout (``parallel/routed_wave.py`` builds it): the node state is global
and bit-packed, shard ``d`` owning words ``[d * w_local, (d + 1) *
w_local)`` (``n_local`` is a multiple of 32); ``nepoch`` is int32 per row.
Edges are sharded by destination owner, ``e_cap`` slots a shard, ``n_edges``
(an int32 tensor a shard) of them live: ``eprod`` and ``ebslot`` (the
producer family and the slot within its bucket), ``ebit``, ``edst`` (a
local row, pad ``n_local``), ``elsrc`` (the local source row, pad
``n_local``) and ``eepoch`` (pad -1). The bucket capacities ``icap`` and
``hcap`` are launch arguments, so an in-place bucket resize rewrites no
per-edge array (``routed_wave.py:52-66``).

A level reads the exchanged words ``x`` (row ``d`` at ``d * x_stride``)
and, for ``hier``, the host tree's ``cross`` words, through ``_lookup``'s
index for the mode (:data:`MODES`); the ``spec`` form reads the shard's own
frontier words through ``elsrc``. The rows that fire and were valid at the
start of the level are ORed into ``next``, then into ``invalid`` (and into
``acc``, the async mode's ever-lit accumulator, when given) and counted:
``out[d]`` the shard's newly rows, ``out[n_dev]`` the total. A launch given
``go`` (a count of a slot written before) returns at once when it is 0, so
a chain enqueues a budget of levels with no readback.

A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/routed_level.cu`` or raises. The kernel takes at most
:data:`MAX_SHARDS` shards and 16-byte aligned routing arrays. Its C entries
take one packed struct of 64-bit arguments: the layout's part is packed once
per :class:`RoutedEdges` (the graph makes a new one after every upload) and
each call packs only its own pointers, on an entry resolved once. ``launches``
counts the CUDA launches (one per wrapper call on the card),
``form_launches`` by form and lookup.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import torch

from . import _build
from .bitops import pack_bits, unpack_bits

__all__ = [
    "MAX_SHARDS",
    "MODES",
    "RoutedEdges",
    "form_launches",
    "launches",
    "routed_level",
    "routed_level_plain",
    "routed_seed",
    "routed_seed_plain",
    "slot_width",
]

#: the exchange → the kernel's lookup mode (``tree`` reads the same
#: device-order vector as ``gather`` on one card)
MODES = {"gather": 0, "tree": 0, "a2a": 1, "hier": 2}
#: shards a launch takes (a block keeps its counts per shard in shared memory)
MAX_SHARDS = 64

#: CUDA launches since the last reset, of every form
launches = 0
#: the same launches by form: ``level`` (the exchange level), ``spec`` (the
#: async mode's speculative local level), ``seed`` (the seed step); and the
#: ``level`` form's launches again by lookup: ``gather`` (``tree`` too),
#: ``a2a``, ``hier``
form_launches = {"level": 0, "spec": 0, "seed": 0, "gather": 0, "a2a": 0, "hier": 0}
_LOOKUPS = ("gather", "a2a", "hier")  # by kernel mode

#: ``LevelArgs`` of the C entry: the layout's 16 int64, then the call's 10
_LAYOUT_ARGS = struct.Struct("<16q")
_CALL_ARGS = struct.Struct("<10q")
#: ``SeedArgs``: 8 int64
_SEED_ARGS = struct.Struct("<8q")
_entries: dict = {}  # C entry name → its ctypes function, resolved at the first launch


@dataclass(eq=False)
class RoutedEdges:
    """The per-edge tensors of every shard and the geometry a level needs."""

    eprod: torch.Tensor  # int32[n_dev * e_cap]
    ebslot: torch.Tensor
    ebit: torch.Tensor
    edst: torch.Tensor
    elsrc: torch.Tensor
    eepoch: torch.Tensor
    n_edges: torch.Tensor  # int32[n_dev]
    max_edges: int  # the longest shard's live edges (host)
    e_cap: int
    n_local: int
    n_dev: int
    mode: int
    icap: int
    hcap: int
    dph: int
    n_hosts: int
    #: the C entry's layout part, packed at the first launch on the card
    launch_args: Optional[bytes] = field(default=None, init=False, repr=False)


def slot_width(n_dev: int) -> int:
    """Entries of one level's count slot: the shards' counts, the total and
    the any-seed flag."""
    return n_dev + 2


def _check(words: torch.Tensor, what: str) -> None:
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError(f"routed_level: {what} must be contiguous int32 words")


def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = _build.entry("routed_level", name)
    return fn


def _layout_args(L: RoutedEdges, dev: int) -> bytes:
    """``L``'s part of the level's launch arguments, checked and packed
    once per layout."""
    args = L.launch_args
    if args is None:
        if not 1 <= L.n_dev <= MAX_SHARDS:
            raise ValueError(f"routed_level: {L.n_dev} shards; a launch takes 1 to "
                             f"{MAX_SHARDS}")
        if max(L.n_dev * L.e_cap, L.n_dev * L.n_local) >= 2**31:
            raise ValueError("routed_level: the kernel indexes edge slots and rows in 32 bits")
        tensors = (L.eprod, L.ebslot, L.ebit, L.edst, L.elsrc, L.eepoch, L.n_edges)
        for t in tensors:
            _check(t, "the layout's edge arrays")
            if t.get_device() != dev:
                raise ValueError("routed_level: inputs must share one device")
        ptrs = [t.data_ptr() for t in tensors]
        if any(p & 15 for p in ptrs[:5]):
            raise ValueError("routed_level: the routing arrays must be 16-byte aligned")
        args = L.launch_args = _LAYOUT_ARGS.pack(
            *ptrs, L.e_cap, L.max_edges, L.n_local, L.n_dev, L.mode, L.icap, L.hcap, L.dph,
            L.n_hosts)
    elif L.n_edges.get_device() != dev:
        raise ValueError("routed_level: inputs must share one device")
    return args


def routed_level_plain(x, x_stride: int, cross, L: RoutedEdges, nepoch, invalid, nxt, out,
                       go=None, acc=None, spec: bool = False) -> None:
    """Plain PyTorch version of :func:`routed_level`: gather the edges'
    source bits, fire, scatter ``True`` into a bool vector, pack, merge."""
    if go is not None and int(go) == 0:
        return
    dev = invalid.device
    n_dev, e_cap, n_local = L.n_dev, L.e_cap, L.n_local
    slot = torch.arange(e_cap, device=dev)
    live = slot[None, :] < L.n_edges.to(torch.int64)[:, None]
    e = torch.nonzero(live.reshape(-1)).flatten()
    d = e // e_cap
    if spec:
        ls = L.elsrc[e].to(torch.int64)
        ok = ls < n_local
        lsc = torch.where(ok, ls, torch.zeros_like(ls))
        word = x[d * x_stride + (lsc >> 5)]
        on = ok & (((word >> (lsc & 31)) & 1) == 1)
    else:
        prod = L.eprod[e].to(torch.int64)
        bslot = L.ebslot[e].to(torch.int64)
        if L.mode == 0:
            word = x[bslot]
        elif L.mode == 1:
            word = x[d * x_stride + prod * L.icap + bslot]
        else:
            is_cross = prod >= n_dev
            wi = x[torch.where(is_cross, 0, d * x_stride + (prod % L.dph) * L.icap + bslot)]
            wc = cross[torch.where(is_cross, ((prod - n_dev) * L.n_hosts + d // L.dph) * L.hcap
                                   + bslot, 0)]
            word = torch.where(is_cross, wc, wi)
        on = ((word >> (L.ebit[e] & 31)) & 1) == 1
    dst = L.edst[e].to(torch.int64)
    ok = on & (dst < n_local)
    row = d * n_local + torch.where(ok, dst, torch.zeros_like(dst))
    inv_bit = ((invalid[row >> 5] >> (row & 31)) & 1) == 1
    fire = ok & (nepoch[row] == L.eepoch[e]) & ~inv_bit
    rows = torch.unique(row[fire])
    mask = torch.zeros(invalid.shape[0] * 32, dtype=torch.bool, device=dev)
    mask[rows] = True
    nw = pack_bits(mask)
    k = nw.shape[0]  # next and acc may carry the exchange's pad word after these
    invalid[:k] |= nw
    nxt[:k] |= nw
    if acc is not None:
        acc[:k] |= nw
    cnt = torch.bincount(rows // n_local, minlength=n_dev).to(out.dtype)
    out[:n_dev] += cnt
    out[n_dev] += cnt.sum()


def routed_level(x, x_stride: int, cross, L: RoutedEdges, nepoch, invalid, nxt, out,
                 go=None, acc=None, spec: bool = False) -> None:
    """One level of every shard, merged, in one launch: ``invalid |= next``
    in place, ``next`` (zeroed by the caller) and ``acc`` OR'd with the
    rows that fired, ``out`` (int64 ``[slot_width(n_dev)]``, zeroed by the
    caller) += the shards' counts and their total. ``x`` holds the
    exchanged words (``spec``: the frontier words); ``cross`` the host
    tree's words for ``hier`` (else ignored); ``go`` an int64 count that
    stops the launch when 0."""
    global launches
    for t, what in ((x, "x"), (invalid, "invalid"), (nxt, "next")):
        _check(t, what)
    if out.dtype != torch.int64 or out.numel() < slot_width(L.n_dev):
        raise ValueError("routed_level: out must be int64 with n_dev + 2 entries")
    if not invalid.is_cuda:
        if x.device != invalid.device or L.eprod.device != invalid.device:
            raise ValueError("routed_level: inputs must share one device")
        if invalid.device.type != "cpu":
            raise ValueError(f"routed_level: unsupported device {invalid.device}")
        routed_level_plain(x, x_stride, cross, L, nepoch, invalid, nxt, out, go, acc, spec)
        return
    dev = invalid.get_device()
    if x.get_device() != dev or nxt.get_device() != dev or out.get_device() != dev:
        raise ValueError("routed_level: inputs must share one device")
    args = _layout_args(L, dev) + _CALL_ARGS.pack(
        x.data_ptr(), x_stride, (x if cross is None else cross).data_ptr(), nepoch.data_ptr(),
        invalid.data_ptr(), nxt.data_ptr(), 0 if acc is None else acc.data_ptr(),
        out.data_ptr(), 0 if go is None else go.data_ptr(), 1 if spec else 0)
    err = _entry("routed_level_launch")(args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"routed_level: routed_level_launch failed with CUDA error {err}")
    launches += 1
    form_launches["spec" if spec else "level"] += 1
    if not spec:
        form_launches[_LOOKUPS[L.mode]] += 1


def routed_seed_plain(seeds, invalid, out, n_dev: int, w_local: int, chain=None) -> None:
    """Plain PyTorch version of :func:`routed_seed`."""
    if chain is not None:
        prev_last, prev_broken, broken = chain
        if int(prev_broken) != 0 or int(prev_last) != 0:
            broken.fill_(1)
            return
    n = n_dev * w_local
    s = seeds[:n]
    fresh = s & ~invalid[:n]
    invalid[:n] |= s
    bits = unpack_bits(fresh, n * 32).view(n_dev, -1)
    cnt = bits.sum(dim=1).to(out.dtype)
    out[:n_dev] += cnt
    out[n_dev] += cnt.sum()
    if bool((s != 0).any()):
        out[n_dev + 1] = 1


def routed_seed(seeds, invalid, out, n_dev: int, w_local: int, chain=None) -> None:
    """The wave's seed step over every shard's words: ``fresh = seeds &
    ~invalid``, ``invalid |= seeds``, ``out[d]`` and ``out[n_dev]`` +=
    the fresh counts, ``out[n_dev + 1] = 1`` when any seed is set (seeds
    conduct even when already invalid; only fresh ones count). ``chain`` =
    (the previous stage's last count, its broken flag, this stage's broken
    flag): the step skips, and marks this stage broken, when the previous
    stage was skipped or had not quiesced."""
    global launches
    _check(seeds, "seeds")
    _check(invalid, "invalid")
    if not invalid.is_cuda:
        if invalid.device.type != "cpu":
            raise ValueError(f"routed_level: unsupported device {invalid.device}")
        routed_seed_plain(seeds, invalid, out, n_dev, w_local, chain)
        return
    if not 1 <= n_dev <= MAX_SHARDS:
        raise ValueError(f"routed_level: {n_dev} shards; a launch takes 1 to {MAX_SHARDS}")
    dev = invalid.get_device()
    if seeds.get_device() != dev or out.get_device() != dev:
        raise ValueError("routed_level: inputs must share one device")
    ptrs = (0, 0, 0) if chain is None else tuple(t.data_ptr() for t in chain)
    args = _SEED_ARGS.pack(seeds.data_ptr(), invalid.data_ptr(), w_local, n_dev,
                           out.data_ptr(), *ptrs)
    err = _entry("routed_seed_launch")(args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"routed_level: routed_seed_launch failed with CUDA error {err}")
    launches += 1
    form_launches["seed"] += 1
