"""Vectorized reads over RPC — the columnar path across the process boundary.

The framework's flagship bulk-read shape (MemoTable +
``read_batch``) previously existed only in-process; a remote client got the
scalar compute-call path. This module carries it over the wire the same way
the reference carries scalar reads (PerformanceTest.cs "+ STJ serialization"
row; Client/Internal/RpcComputeSystemCalls.cs:13-26 for the push pattern):

- **server** (:class:`RemoteTableHost`): exposes named MemoTables over an
  ordinary RPC service — ``read_batch(name, ids)`` is ONE device gather and
  one ndarray-payload response — and pushes **per-table row fences**
  (``$sys-t.fence`` with the invalidated row ids + table version,
  fire-and-forget) to subscribed peers whenever rows invalidate. One
  subscription covers every row of a table: the per-call ``$sys-c`` pattern
  at table granularity.
- **client** (:class:`RemoteTable`): a local row cache (values + validity)
  fed by batched RPC reads; fences flip rows stale, so repeat reads are
  LOCAL gathers until the server actually invalidates. A fence that lands
  while a read is in flight wins over the in-flight response (per-row fence
  stamps), and a reconnect conservatively invalidates every cached row and
  resubscribes — fences dropped while the link was down can't strand stale
  rows.

Codec-keyed tables work remotely too: ``read_keys`` carries
string/composite keys over the wire with the SERVER's codec authoritative —
the server interns unknown keys (``$tables.read_keys``), the client learns
the key→row assignments from responses and thereafter reads by row id
(local gathers until a fence lands). The reference's RPC carries arbitrary
argument lists for every call (Configuration/RpcByteArgumentSerializer.cs:
8-60); this is that capability at table granularity. A reconnect clears the
learned key map along with the row cache — a restarted server may intern
keys onto different rows, and only its codec is truth.
"""
from __future__ import annotations

import asyncio
import logging
import weakref
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np

from ..rpc.message import TABLE_SYSTEM_SERVICE, RpcMessage
from ..utils.serialization import dumps, loads

if TYPE_CHECKING:
    from ..ops.memo_table import MemoTable
    from ..rpc.hub import RpcHub
    from ..rpc.peer import RpcPeer

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["RemoteTableHost", "RemoteTable", "TABLE_RPC_SERVICE"]

TABLE_RPC_SERVICE = "$tables"


from ..utils.serialization import deep_tuple as _deep_tuple


def _table_system(rpc_hub: "RpcHub") -> dict:
    """One composite ``$sys-t`` dispatcher per hub: a hub may HOST tables
    (subscribe messages from downstream peers) and CONSUME remote tables
    (fence messages from upstream) at the same time — two assignments to
    ``table_system_handler`` would silently drop one direction."""
    sys_state = getattr(rpc_hub, "_table_system", None)
    if sys_state is None:
        sys_state = rpc_hub._table_system = {"host": None, "tables": {}}

        def handle(peer: "RpcPeer", message: RpcMessage) -> None:
            if message.method == "subscribe":
                host = sys_state["host"]
                if host is not None:
                    host._handle_subscribe(peer, message)
                else:
                    log.warning("subscribe with no RemoteTableHost on this hub")
            elif message.method == "fence":
                name, version, ids = loads(message.argument_data)
                table = sys_state["tables"].get((getattr(peer, "ref", None), name))
                if table is not None:
                    table._apply_fence(version, ids)

        rpc_hub.table_system_handler = handle
    return sys_state


class RemoteTableHost:
    """Server side: named MemoTables served over RPC with fence push.

    ``expose(name, table)`` wires the table's ``on_invalidate`` to a
    ``$sys-t.fence`` push toward every subscribed peer. Subscriptions
    arrive as ``$sys-t.subscribe`` messages (transport-level, so the
    subscribing PEER is known — an ordinary service method never sees its
    caller); a peer whose push fails is dropped and will resubscribe on
    reconnect, where the client invalidates its whole cache anyway.
    """

    def __init__(self, rpc_hub: "RpcHub"):
        self.rpc_hub = rpc_hub
        self.tables: Dict[str, "MemoTable"] = {}
        # name → {id(peer): weakref(peer)} — weak so a dead server peer
        # never pins its connection state
        self._subs: Dict[str, Dict[int, "weakref.ref[RpcPeer]"]] = {}
        self._fence_tasks: set = set()  # the loop holds tasks weakly
        rpc_hub.add_service(TABLE_RPC_SERVICE, _TableRpcService(self))
        sys_state = _table_system(rpc_hub)
        if sys_state["host"] is not None:
            raise ValueError("this hub already has a RemoteTableHost")
        sys_state["host"] = self

    def expose(self, name: str, table: "MemoTable") -> "RemoteTableHost":
        if name in self.tables:
            raise ValueError(f"table {name!r} already exposed")
        self.tables[name] = table
        self._subs[name] = {}

        def on_invalidate(ids: np.ndarray) -> None:
            self._push_fence(name, table.version, np.asarray(ids, dtype=np.int32))

        table.on_invalidate.append(on_invalidate)

        def on_wave_invalidate(ids: np.ndarray) -> None:
            # device bursts mark rows stale through the wave path, which
            # keeps on_invalidate silent (the wave owns the cascade) — the
            # backend fires this hook instead, so burst-fenced rows reach
            # remote subscribers too (pre-coalescer they never did).
            # Deferred via call_soon: the hook runs INSIDE wave application
            # (backend contract: hooks must be cheap), and serializing a
            # wave-sized id payload there would stall the burst.
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return  # no loop → no live link; reconnect covers it
            loop.call_soon(
                self._push_fence, name, table.version,
                np.asarray(ids, dtype=np.int32),
            )

        table.on_wave_invalidate.append(on_wave_invalidate)
        return self

    def _require(self, name: str) -> "MemoTable":
        table = self.tables.get(name)
        if table is None:
            raise LookupError(f"no table {name!r} exposed; have {sorted(self.tables)}")
        return table

    def _handle_subscribe(self, peer: "RpcPeer", message: RpcMessage) -> None:
        (name,) = loads(message.argument_data)
        subs = self._subs.get(name)
        if subs is None:
            log.warning("subscribe for unknown table %r from %s", name, peer.ref)
            return
        subs[id(peer)] = weakref.ref(peer)

    def _push_fence(self, name: str, version: int, ids: np.ndarray) -> None:
        subs = self._subs.get(name, {})
        if not subs:
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            # wave applied outside any event loop (sync bench/test paths):
            # there is no live connection to push to from here — subscribers
            # recover via the reconnect invalidate-all contract
            return
        message = RpcMessage(
            call_type_id=0,
            call_id=0,
            service=TABLE_SYSTEM_SERVICE,
            method="fence",
            argument_data=dumps([name, version, ids]),
        )
        for key, ref in list(subs.items()):
            peer = ref()
            if peer is None:
                subs.pop(key, None)
                continue
            task = asyncio.ensure_future(self._send_fence(peer, message, subs, key))
            # the loop references tasks weakly: an unanchored fence push
            # could be collected mid-flight and silently lost
            self._fence_tasks.add(task)
            task.add_done_callback(self._fence_tasks.discard)

    async def _send_fence(self, peer, message, subs, key) -> None:
        try:
            await peer.send(message)
        except Exception:  # noqa: BLE001 — link down: drop the sub; the
            # client invalidates everything and resubscribes on reconnect,
            # so a fence lost here can never strand a stale row
            subs.pop(key, None)


class _TableRpcService:
    """The ordinary-RPC face of a RemoteTableHost (reads only; the fence
    channel is transport-level)."""

    def __init__(self, host: RemoteTableHost):
        self._host = host

    async def read_batch(self, name: str, ids: np.ndarray):
        table = self._host._require(name)
        # the table's rows live on its device; the wire codec carries
        # ndarrays, so the batch crosses to the host once per RPC
        values = table.read_batch(np.asarray(ids, dtype=np.int32)).cpu().numpy()
        return {"values": values, "version": table.version}

    async def read_keys(self, name: str, keys):
        """Keyed read with the SERVER's codec authoritative: unknown keys
        intern here (exactly like an in-process ``read_keys``); the response
        carries the assigned row ids so the client can fence-track them."""
        table = self._host._require(name)
        keys = [_deep_tuple(k) for k in keys]  # wire lists → hashable
        rows = table.encode_keys(keys)  # allocates: server is truth
        values = table.read_batch(rows).cpu().numpy()
        return {"rows": rows, "values": values, "version": table.version}

    async def table_info(self, name: str):
        table = self._host._require(name)
        empty = table.values[:0].cpu().numpy()  # shape and dtype, no rows
        return {
            "n_rows": table.n_rows,
            "row_shape": list(empty.shape[1:]),
            "dtype": str(empty.dtype),
            "version": table.version,
        }


class RemoteTable:
    """Client side: a fence-coherent local row cache over a served table.

    ``await read_batch(ids)`` returns the rows for ``ids``: valid rows come
    from the LOCAL cache (no wire traffic); stale rows fetch in ONE RPC
    batch. Rows turn stale when the server pushes a ``$sys-t`` fence for
    them — so a remote reader has the in-process contract: repeat reads are
    memoized until the row actually changes.
    """

    def __init__(self, rpc_hub: "RpcHub", peer_ref: str, name: str):
        self.rpc_hub = rpc_hub
        self.peer_ref = peer_ref
        self.name = name
        self.server_version = -1
        self.fences_seen = 0
        self.remote_reads = 0  # observability: RPC round trips paid
        self._values: Optional[np.ndarray] = None
        self._valid: Optional[np.ndarray] = None
        self._row_fence_stamp: Optional[np.ndarray] = None
        self._fence_counter = 0
        self._lock = asyncio.Lock()
        #: learned server key→row assignments (server codec authoritative;
        #: cleared on reconnect — a restarted server may re-intern)
        self._row_by_key: Dict = {}
        self._subscribed = False
        self._connects_seen = 0
        self._reconnect_task: Optional[asyncio.Task] = None
        self._fetch_lock = asyncio.Lock()
        tables = _table_system(rpc_hub)["tables"]
        key = (peer_ref, name)
        if key in tables:
            raise ValueError(f"RemoteTable for {key!r} already exists on this hub")
        tables[key] = self

    # ------------------------------------------------------------------ reads
    async def read_batch(self, ids) -> np.ndarray:
        ids_np = np.asarray(ids, dtype=np.int32)
        await self._ensure_ready()
        if not self._valid[ids_np].all():
            # single-flight: concurrent readers of the same stale rows
            # coalesce behind one RPC (re-check under the lock — the
            # previous holder may have fetched our rows already)
            async with self._fetch_lock:
                stale = ids_np[~self._valid[ids_np]]
                if stale.size:
                    await self._fetch(np.unique(stale))
        return self._values[ids_np]

    async def read_keys(self, keys) -> np.ndarray:
        """Keyed reads over the wire (string / composite keys): unknown keys
        resolve remotely in ONE batch (the server interns them — its codec
        is authoritative), known keys read like ``read_batch`` — a local
        gather unless a fence marked their rows stale."""
        await self._ensure_ready()
        norm = [_deep_tuple(k) for k in keys]
        rows = np.empty(len(keys), dtype=np.int64)
        # a reconnect mid-fetch clears the learned map (the server may have
        # re-interned), vaporizing keys outside the in-flight batch — retry
        # resolution instead of crashing (bounded: repeated drops give up)
        for _attempt in range(3):
            unknown = [j for j, k in enumerate(norm) if k not in self._row_by_key]
            if not unknown:
                break
            async with self._fetch_lock:
                still = [j for j in unknown if norm[j] not in self._row_by_key]
                if still:
                    # dedup while preserving one representative per key
                    uniq = list({norm[j]: None for j in still})
                    await self._fetch_keys(uniq)
        else:
            missing = [norm[j] for j in range(len(norm)) if norm[j] not in self._row_by_key]
            if missing:
                raise ConnectionError(
                    f"keyed resolution kept getting invalidated by reconnects: {missing[:3]}"
                )
        for j, k in enumerate(norm):
            rows[j] = self._row_by_key[k]
        ids_np = rows.astype(np.int32)
        if not self._valid[ids_np].all():
            async with self._fetch_lock:
                stale = ids_np[~self._valid[ids_np]]
                if stale.size:
                    await self._fetch(np.unique(stale))
        return self._values[ids_np]

    async def _fetch_keys(self, keys) -> None:
        fence_floor = self._fence_counter
        resp = await self.rpc_hub.call(
            TABLE_RPC_SERVICE, "read_keys", (self.name, list(keys)),
            peer_ref=self.peer_ref,
        )
        self.remote_reads += 1
        rows = np.asarray(resp["rows"], dtype=np.int32)
        self._values[rows] = resp["values"]
        for k, r in zip(keys, rows):
            self._row_by_key[_deep_tuple(k)] = int(r)
        self.server_version = max(self.server_version, resp["version"])
        # same in-flight-fence rule as _fetch: a fence stamped after this
        # read began wins — the row keeps the value but stays stale
        unfenced = self._row_fence_stamp[rows] <= fence_floor
        self._valid[rows[unfenced]] = True

    async def _ensure_ready(self) -> None:
        if self._subscribed:
            return
        async with self._lock:
            if self._subscribed:
                return
            peer = self.rpc_hub.client_peer(self.peer_ref)
            await peer.when_connected()
            # subscribe BEFORE the first read: a row invalidated after the
            # subscription lands as a fence; one invalidated before it is
            # covered because every row starts stale
            await peer.send(_subscribe_message(self.name))
            info = await self.rpc_hub.call(
                TABLE_RPC_SERVICE, "table_info", (self.name,), peer_ref=self.peer_ref
            )
            n = info["n_rows"]
            self._values = np.zeros((n, *info["row_shape"]), dtype=np.dtype(info["dtype"]))
            self._valid = np.zeros(n, dtype=bool)
            self._row_fence_stamp = np.full(n, -1, dtype=np.int64)
            self.server_version = info["version"]
            self._subscribed = True
            self._reconnect_task = asyncio.ensure_future(self._watch_reconnects(peer))

    async def _fetch(self, ids_np: np.ndarray) -> None:
        fence_floor = self._fence_counter
        resp = await self.rpc_hub.call(
            TABLE_RPC_SERVICE, "read_batch", (self.name, ids_np), peer_ref=self.peer_ref
        )
        self.remote_reads += 1
        self._values[ids_np] = resp["values"]
        self.server_version = max(self.server_version, resp["version"])
        # a fence that landed while this read was in flight WINS: those
        # rows keep the fetched value but stay stale, so the next read
        # refetches (the response was gathered before the invalidation).
        # <= : a row whose stamp EQUALS the floor was fenced before this
        # fetch began, so the response already reflects it — `<` would
        # leave such rows permanently stale (cache-missing forever)
        unfenced = self._row_fence_stamp[ids_np] <= fence_floor
        self._valid[ids_np[unfenced]] = True

    # ------------------------------------------------------------------ fences
    def _apply_fence(self, version: int, ids: Optional[np.ndarray]) -> None:
        self.fences_seen += 1
        if self._valid is None:
            return  # fence raced _ensure_ready; every row is stale anyway
        self._fence_counter += 1
        if ids is None:
            self._valid[:] = False
            self._row_fence_stamp[:] = self._fence_counter
        else:
            ids = np.asarray(ids, dtype=np.int32)
            self._valid[ids] = False
            self._row_fence_stamp[ids] = self._fence_counter
        self.server_version = max(self.server_version, version)

    async def _watch_reconnects(self, peer) -> None:
        """A reconnect means fences may have been dropped: conservatively
        invalidate every cached row and resubscribe (the server dropped our
        subscription on the failed push, or never knew the link died)."""
        ev = peer.connection_state.latest()
        was_connected = ev.value.is_connected
        while True:
            try:
                ev = await ev.when(lambda s: s.is_connected != was_connected)
            except asyncio.CancelledError:
                return
            was_connected = ev.value.is_connected
            if was_connected:
                self._apply_fence(self.server_version, None)
                # a restarted server may intern keys onto different rows;
                # its codec is the only truth — relearn from scratch
                self._row_by_key.clear()
                try:
                    await peer.send(_subscribe_message(self.name))
                except Exception:  # noqa: BLE001 — next flip retries
                    pass

    def dispose(self) -> None:
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
        tables = _table_system(self.rpc_hub)["tables"]
        key = (self.peer_ref, self.name)
        if tables.get(key) is self:
            tables.pop(key, None)


def _subscribe_message(name: str) -> RpcMessage:
    return RpcMessage(
        call_type_id=0,
        call_id=0,
        service=TABLE_SYSTEM_SERVICE,
        method="subscribe",
        argument_data=dumps([name]),
    )

