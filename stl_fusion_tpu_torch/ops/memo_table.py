"""MemoTable — vectorized reactive memoization over a dense key space.

Port of ``stl_fusion_tpu/ops/memo_table.py`` on torch tensors. When the key
space is dense and reads come in bulk, memoization is columnar:

- values live on the device as one tensor with a row per key — the
  "registry" is a gather index, not a hash map;
- a batch of reads is one gather;
- consistency is a per-row validity bit: ``invalidate(ids)`` clears bits,
  the next read of a stale row triggers a vectorized recompute
  (``compute_fn(ids) -> rows``) and an indexed assignment — single-flight
  per refresh call, read-your-writes within a table;
- staleness is authoritative on the host (numpy), so ``read_batch`` never
  reads the device to decide whether to refresh, while the bool device mask
  (and its packed words) stays available to device consumers.

Scalar-graph bridge: ``on_invalidate`` callbacks fire with the invalidated
ids, so a host ``Computed`` can subscribe and cascade through the object
graph; ``changed`` is an AsyncEvent stream of table versions.

PyTorch runs eagerly and compiles nothing per shape, so the JAX package's
pow-2 padding of id batches (it only limited XLA recompiles) is gone; it
changes no answer. The table lives on ``device`` (``cuda`` unless the
caller passes ``device="cpu"``; see :func:`~..device.resolve_device`).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..diagnostics.flight_recorder import RECORDER
from ..utils.async_utils import AsyncEvent
from .bitops import pack_bits

__all__ = ["MemoTable"]

Ids = Union[Sequence[int], np.ndarray, torch.Tensor]


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


class MemoTable:
    def __init__(
        self,
        n_rows: int,
        compute_fn: Callable[[np.ndarray], "np.ndarray"],
        row_shape: tuple = (),
        dtype=None,
        eager: bool = False,
        device=None,
    ):
        self.n_rows = int(n_rows)
        self.compute_fn = compute_fn
        self.version = 0
        self._values = torch.zeros((self.n_rows, *row_shape), dtype=_torch_dtype(dtype),
                                   device=resolve_device(device))
        #: the concrete device (``cuda:0``, not ``cuda``): a tensor's own
        #: device compares equal to it
        self.device = self._values.device
        # host-authoritative staleness (True = stale); the device mirror is
        # an unpacked bool row mask (a scatter of 0/1 is duplicate-safe,
        # unlike a packed-word update, which loses bits when two ids share
        # a word)
        self._stale_host = np.ones(self.n_rows, dtype=bool)
        self._stale_count = self.n_rows  # exact count, O(batch) to maintain
        self._valid_dev = torch.zeros(self.n_rows, dtype=torch.bool, device=self.device)
        # True = the device mask lags _stale_host (wave application defers
        # the scatter: a 10M-row wave would upload 40 MB of ids a burst);
        # valid_mask/valid_bits materialize lazily
        self._valid_dev_dirty = False
        # small invalidate/refresh batches defer their device-mask scatter
        # here (coalesced into one scatter at materialization)
        self._valid_pending: List[np.ndarray] = []
        self._valid_pending_n = 0
        self._packed_cache: Optional[tuple] = None  # (version, packed bits)
        self.on_invalidate: List[Callable[[np.ndarray], None]] = []
        #: fired BY THE GRAPH BACKEND with the local row ids a DEVICE WAVE
        #: marked stale (``_mark_stale_from_wave*`` itself stays silent — the
        #: wave owns the cascade; these hooks are for external observers).
        #: Only fired when non-empty, so unobserved tables pay nothing.
        self.on_wave_invalidate: List[Callable[[np.ndarray], None]] = []
        #: fired with the refreshed ids after a vectorized recompute (the
        #: graph backend subscribes to clear device invalid bits in bulk)
        self.on_refresh: List[Callable[[np.ndarray], None]] = []
        #: optional DEVICE loader (set by ``TableBacking(device_batch=...)``):
        #: a torch function ``(ids: int tensor on the device, *args) -> rows``
        #: that lets the graph backend refresh stale rows entirely on the
        #: device (``TpuGraphBackend.refresh_block_on_device``);
        #: ``device_loader_args()`` returns the loader's tensors
        self.device_compute_fn = None
        self.device_loader_args = None
        #: optional key codec (set by TableBacking wiring): arbitrary
        #: hashable keys ⇄ dense rows — see read_keys/invalidate_keys
        self.key_codec = None
        #: declared key arity (set by TableBacking wiring): disambiguates a
        #: single-arg method whose KEY VALUES are tuples from a multi-arg
        #: method — a runtime isinstance(key, tuple) check cannot
        self.key_arity: Optional[int] = None
        self.changed: AsyncEvent = AsyncEvent(0)
        # /metrics exposure: stale backlog + version, summed over live tables
        # at scrape time (weak-registered: a collected table drops out)
        from ..diagnostics.metrics import global_metrics

        global_metrics().register_collector(self, MemoTable._collect_metrics)
        if eager:
            self.refresh(np.arange(self.n_rows))

    def _collect_metrics(self) -> dict:
        return {
            "fusion_memo_tables": 1,
            "fusion_memo_rows": self.n_rows,
            "fusion_memo_stale_rows": self._stale_count,
            "fusion_memo_versions_total": self.version,
        }

    def _ids_to_device(self, ids_np: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(ids_np.astype(np.int64)).to(self.device)

    # ------------------------------------------------------------------ reads
    def read_batch(self, ids: Ids) -> torch.Tensor:
        """Values for ``ids`` (a tensor [k, ...] on the table's device);
        refreshes stale rows first. The all-fresh fast path is one gather.

        ``ids`` may be a tensor ON THE TABLE'S DEVICE: then the batch never
        crosses to the host — instead of gathering per-id staleness on the
        host (a device→host read), the ENTIRE current stale set (host-known)
        is refreshed before the gather. Out-of-range ids read as JAX reads
        them: negative ones count from the end, the rest clamp to the last
        row. Every other sequence (a CPU tensor for a card table included)
        keeps the numpy contract."""
        if isinstance(ids, torch.Tensor) and ids.device == self.device:
            if self._stale_count:
                self.refresh(np.nonzero(self._stale_host)[0])
            idx = ids.reshape(-1).long()
            idx = torch.where(idx < 0, idx + self.n_rows, idx).clamp_(0, max(self.n_rows - 1, 0))
            return self._values.index_select(0, idx).reshape(*ids.shape, *self._values.shape[1:])
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids_np = np.asarray(ids, dtype=np.int32)
        stale = self._stale_host[ids_np]
        if stale.any():
            self.refresh(np.unique(ids_np[stale]))
        return self._values[self._ids_to_device(ids_np)]

    def encode_keys(self, keys, allocate: bool = True) -> np.ndarray:
        """Dense row ids for arbitrary keys via the attached codec (a key is
        the call-args tuple, or the bare value for single-arg methods).
        ``allocate=False`` maps only already-interned keys (-1 otherwise)."""
        codec = self._require_codec()
        rows = np.empty(len(keys), dtype=np.int32)
        for j, k in enumerate(keys):
            args = self._key_to_args(k)
            row = codec.acquire(args) if allocate else codec.peek(args)
            rows[j] = -1 if row is None else row
        return rows

    def _key_to_args(self, k) -> tuple:
        """Canonical call-args tuple for a key, by DECLARED arity: a
        single-arg method's tuple-valued key must intern as ((1, 2),),
        never be mistaken for two args."""
        if self.key_arity == 1:
            return (k,)
        if self.key_arity is not None:
            if not isinstance(k, tuple) or len(k) != self.key_arity:
                raise TypeError(
                    f"key {k!r} does not match the method's arity "
                    f"({self.key_arity}): pass an args tuple"
                )
            return k
        return k if isinstance(k, tuple) else (k,)  # standalone-table heuristic

    def read_keys(self, keys):
        """``read_batch`` for codec-backed tables: keys are interned to rows
        (first read allocates), stale rows refresh through the service's
        batch method with the DECODED keys, one gather returns the values."""
        return self.read_batch(self.encode_keys(keys))

    def invalidate_keys(self, keys) -> None:
        """Mark the rows of already-interned ``keys`` stale (never-read keys
        have no row and are a no-op, not an allocation)."""
        rows = self.encode_keys(keys, allocate=False)
        rows = rows[rows >= 0]
        if rows.size:
            self.invalidate(rows)

    def _require_codec(self):
        if self.key_codec is None:
            raise TypeError(
                "this MemoTable has no key codec — declare "
                "TableBacking(keys=True) or read by integer row ids"
            )
        return self.key_codec

    @property
    def values(self) -> torch.Tensor:
        """The raw device value table (rows for stale ids may be outdated)."""
        return self._values

    MAX_VALID_PENDING = 4096  # total deferred ids before a full rebuild wins

    def _defer_valid(self, ids_np: np.ndarray, value: bool) -> None:
        """Queue a small device-mask update instead of dispatching it
        eagerly; past the budget the full lazy materialization is cheaper.
        The queue stores only the TOUCHED ids — at flush time the
        authoritative host staleness supplies each id's final value, so
        any number of deferred batches coalesce into ONE scatter."""
        if self._valid_dev_dirty:
            return  # full materialization already pending
        if self._valid_pending_n + len(ids_np) > self.MAX_VALID_PENDING:
            self._valid_dev_dirty = True
            self._valid_pending.clear()
            self._valid_pending_n = 0
        else:
            self._valid_pending.append(ids_np)
            self._valid_pending_n += len(ids_np)

    @property
    def valid_mask(self) -> torch.Tensor:
        """Per-row device validity mask (bool[n_rows]); materialized from
        the host-authoritative staleness if a wave application deferred it.
        Deferred small updates flush as ONE indexed assignment: the final
        value of every touched id is ``~stale_host[id]`` (host truth)."""
        if self._valid_dev_dirty:
            self._valid_dev = torch.from_numpy(~self._stale_host).to(self.device)
            self._valid_dev_dirty = False
            self._valid_pending.clear()
            self._valid_pending_n = 0
        elif self._valid_pending:
            ids = np.unique(np.concatenate(self._valid_pending))
            self._valid_dev[self._ids_to_device(ids)] = torch.from_numpy(
                ~self._stale_host[ids]).to(self.device)
            self._valid_pending.clear()
            self._valid_pending_n = 0
        return self._valid_dev

    def valid_bits(self) -> torch.Tensor:
        """Packed per-row validity (int32 words, the port's word type: the
        bits of JAX's uint32 words) for device bit-kernel consumers; packed
        on demand and cached per table version."""
        if self._packed_cache is None or self._packed_cache[0] != self.version:
            self._packed_cache = (self.version, pack_bits(self.valid_mask))
        return self._packed_cache[1]

    # ------------------------------------------------------------------ writes
    def _rows_tensor(self, rows) -> torch.Tensor:
        if isinstance(rows, torch.Tensor):
            return rows.to(self.device, self._values.dtype)
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self.device, self._values.dtype)

    def refresh(self, ids: Ids) -> None:
        """Vectorized recompute + assignment for ``ids`` (marks them fresh).
        Ids are deduped: compute_fn sees each row once."""
        ids_np = np.unique(np.asarray(ids, dtype=np.int32))
        if ids_np.size == 0:
            return
        rows = self.compute_fn(ids_np)
        self._values[self._ids_to_device(ids_np)] = self._rows_tensor(rows)
        self._defer_valid(ids_np, True)
        self._stale_count -= int(np.count_nonzero(self._stale_host[ids_np]))
        self._stale_host[ids_np] = False
        self._bump()
        if RECORDER.enabled:
            RECORDER.note(
                "table_refreshed",
                key=f"table:{id(self):x}",
                detail=f"{len(ids_np)} rows",
            )
        for handler in self.on_refresh:
            handler(ids_np)

    def invalidate(self, ids: Ids) -> None:
        """Mark rows stale; notifies subscribers (the cascade entry point).
        Ids are deduped: on_invalidate handlers see each row once."""
        ids_np = self._mark_stale(ids)
        if ids_np is not None:
            if RECORDER.enabled:
                # one event per CALL (never per row)
                RECORDER.note(
                    "table_invalidated",
                    key=f"table:{id(self):x}",
                    detail=f"{len(ids_np)} rows",
                )
            for handler in self.on_invalidate:
                handler(ids_np)

    def _mark_stale_from_wave_mask(self, rows_mask: np.ndarray) -> None:
        """Mask twin of :meth:`_mark_stale_from_wave` for lane bursts: the
        wave's newly-rows arrive as bool[rows] (possibly a prefix slice)
        and apply as two vectorized mask ops — no id materialization."""
        if not rows_mask.any():
            return
        sub = self._stale_host[: len(rows_mask)]
        self._stale_count += int(np.count_nonzero(rows_mask & ~sub))
        sub |= rows_mask
        self._valid_dev_dirty = True
        self._bump()

    def _mark_stale_from_wave(self, ids: Ids) -> None:
        """Device-wave application path (graph backend): mark rows stale
        WITHOUT firing ``on_invalidate`` — the wave already owns the cascade
        and the scalar-twin application. The device mask update is DEFERRED
        (dirty flag). ``changed`` still advances."""
        ids_np = np.asarray(ids, dtype=np.int32)
        if ids_np.size == 0:
            return
        self._stale_count += int(np.count_nonzero(~self._stale_host[ids_np]))
        self._stale_host[ids_np] = True
        self._valid_dev_dirty = True
        self._bump()

    def _mark_stale(self, ids: Ids) -> Optional[np.ndarray]:
        """Shared staleness bookkeeping; returns the deduped ids (None when
        empty) so :meth:`invalidate` can notify with exactly what changed."""
        ids_np = np.unique(np.asarray(ids, dtype=np.int32))
        if ids_np.size == 0:
            return None
        self._stale_count += int(np.count_nonzero(~self._stale_host[ids_np]))
        self._stale_host[ids_np] = True
        self._defer_valid(ids_np, False)
        self._bump()
        return ids_np

    def invalidate_all(self) -> None:
        self._stale_host[:] = True
        self._stale_count = self.n_rows
        self._valid_dev = torch.zeros_like(self._valid_dev)
        self._valid_dev_dirty = False
        self._valid_pending.clear()
        self._valid_pending_n = 0
        self._bump()
        if self.on_invalidate:
            all_ids = np.arange(self.n_rows, dtype=np.int32)
            for handler in self.on_invalidate:
                handler(all_ids)

    def _bump(self) -> None:
        self.version += 1
        self.changed = self.changed.create_next(self.version)

    # ------------------------------------------------------------------ checkpoint
    def export_state(self) -> dict:
        """Snapshot of the columnar state (values + per-row validity +
        version, as numpy) for checkpoint/resume; the JAX package's
        ``MemoTable.export_state`` gives the same dict."""
        return {
            "values": self._values.cpu().numpy().copy(),
            "valid": (~self._stale_host).copy(),
            "version": int(self.version),
        }

    def import_state(self, state: dict) -> None:
        """Restore an :meth:`export_state` dict (this package's or a JAX
        table's): valid rows read as warm hits immediately; stale rows
        refresh on first touch. Invalidation wiring (on_invalidate, codec)
        is the LIVE table's — import only replaces the row data."""
        values = np.asarray(state["values"])
        if values.shape != tuple(self._values.shape):
            raise ValueError(
                f"checkpoint shape {values.shape} != table shape {tuple(self._values.shape)}"
            )
        valid = np.asarray(state["valid"], dtype=bool)
        self._values = torch.from_numpy(values.copy()).to(self.device)
        self._stale_host = ~valid
        self._stale_count = int((~valid).sum())
        self._valid_dev = torch.from_numpy(valid.copy()).to(self.device)
        self._valid_dev_dirty = False
        self._valid_pending.clear()
        self._valid_pending_n = 0
        self._packed_cache = None
        self.version = int(state["version"])
        self._bump()

    # ------------------------------------------------------------------ misc
    def stale_count(self) -> int:
        return self._stale_count

    def __repr__(self) -> str:
        return f"MemoTable({self.n_rows} rows, {self.stale_count()} stale, v{self.version})"
