"""PeerOutbox — the per-peer outbound drain queue + invalidation coalescer.

Motivation: the server's invalidation
fan-out was one awaited ``RpcMessage`` per subscription per peer, each send
serialized through ``RpcPeer.send()`` — at N clients × K subscriptions a
burst paid N·K awaited channel round trips of pure Python. This module
replaces that shape with the coalescing principle the reduction-tree papers
in PAPERS.md argue for, applied to fan-out frames:

- **FIFO drain**: every outbound message routes through one drain task per
  peer, so per-peer delivery order is a property of the QUEUE, not of which
  sender task the event loop woke first (the pre-outbox send() interleaved
  concurrent senders on the raw channel). The awaited-send error contract
  is preserved exactly: ``send()`` resolves when its message hit the
  channel and raises what the channel raised.
- **Invalidation coalescing**: invalidations are not messages until flush
  time. ``post_invalidation(call_id, version)`` drops into a pending map
  (version-deduped — a key invalidated twice between flushes ships once,
  at the latest version); each drain tick flushes the whole map as ONE
  ``$sys-c.invalidate_batch`` frame. A burst that fences 10k subscriptions
  on a peer costs one frame, not 10k.

Ordering guarantees relied on by the fusion client (result-then-invalidate
per call): queued messages always flush BEFORE the pending invalidation
map in a tick, and a call's result is causally enqueued before its
invalidation is posted, so a client never sees its invalidation overtake a
result that was already on the way out. (When it does lose a result to a
reconnect, the ``ResultMissedError`` retry covers it — unchanged.)

Pending invalidations survive reconnects: flush failures park the map until
the link returns (bounded — after ``RECONNECT_GIVE_UP_S`` disconnected the
map drops; the client's reconnect re-send / version-mismatch machinery
restores coherence, same contract as the pre-outbox per-key retry loop).
"""
from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import TYPE_CHECKING, Deque, Dict, Optional, Tuple

from ..utils.serialization import dumps
from .message import CALL_TYPE_COMPUTE, COMPUTE_SYSTEM_SERVICE, RpcMessage

if TYPE_CHECKING:
    from .peer import RpcPeer

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["PeerOutbox"]


class PeerOutbox:
    #: how long a disconnected peer may hold pending invalidations before
    #: they drop (the client is gone; it resubscribes on return — matches
    #: the pre-outbox per-key sender's 30 s give-up)
    RECONNECT_GIVE_UP_S = 30.0

    def __init__(self, peer: "RpcPeer"):
        self.peer = peer
        # home loop, for marshalling posts from OFF-loop callers (a device
        # wave applied from a worker thread must not lose its invalidation
        # push — the pre-outbox watch task got this via the threadsafe
        # wakeup inside when_invalidated). None when constructed with no
        # loop at all (pure-sync tests: nothing is connected there anyway).
        try:
            self._home_loop: Optional[asyncio.AbstractEventLoop] = (
                asyncio.get_event_loop()
            )
        except RuntimeError:
            self._home_loop = None
        self._fifo: Deque[Tuple[RpcMessage, Optional[asyncio.Future]]] = deque()
        #: call_id → (version | None, cause id | None, origin ts | None);
        #: insertion-order flush, last-posted entry wins — the latest by
        #: causality. cause/origin ride into the batch frame entries so a
        #: client fence can name its originating server wave and measure
        #: true end-to-end delivery.
        self._pending_inval: Dict[int, Tuple[Optional[str], Optional[str], Optional[float]]] = {}
        #: perf_counter of the oldest un-flushed post — the flush-tick lag
        #: gauge/histogram source (how long invalidations sat coalescing)
        self._pending_since: Optional[float] = None
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        #: True while the drain task (or a bypassing direct send) is mid-
        #: channel-write: bypass is only legal when nothing is in flight,
        #: or FIFO order would break
        self._in_flight = False
        self._stopped = False
        # -- counters (exported via RpcHub.fanout_stats / FusionMonitor) --
        self.messages_sent = 0
        self.invalidations_posted = 0  # post_invalidation() calls
        self.invalidations_coalesced = 0  # posts absorbed by a pending entry
        self.batch_frames_sent = 0
        self.batch_keys_sent = 0
        self.pending_dropped = 0  # give-up drops while disconnected
        self.drain_faults = 0  # drain-loop crashes (counted, never just logged)

    # ------------------------------------------------------------------ enqueue
    def can_bypass(self) -> bool:
        """True when a direct send preserves FIFO order: the drain has no
        backlog and nothing is mid-write. Keeps the single-message hot path
        (one awaited channel write) at its pre-outbox cost."""
        return not self._fifo and not self._in_flight and not self._pending_inval

    async def send(self, message: RpcMessage) -> None:
        """Enqueue + await delivery. Raises exactly what the channel write
        raised (the pre-outbox ``RpcPeer.send`` contract)."""
        if self._stopped:
            raise ConnectionError(f"peer {self.peer.ref} outbox is stopped")
        future: asyncio.Future = asyncio.get_event_loop().create_future()
        self._fifo.append((message, future))
        self._kick()
        await future

    def post_invalidation(
        self,
        call_id: int,
        version: Optional[str],
        cause: Optional[str] = None,
        origin_ts: Optional[float] = None,
    ) -> None:
        """Coalesce one subscription invalidation into the next batch frame.
        Synchronous — the caller never awaits a channel. Posting the same
        call twice between flushes ships once, at the latest version.
        Safe from off-loop callers (the kick marshals to the home loop).

        ``cause`` is the originating wave/span id and ``origin_ts`` the
        server-side wave-apply timestamp (``time.perf_counter()``): both
        ride the frame entry to the client, which links its fence back to
        the server wave and records the end-to-end delivery histogram."""
        if self._stopped:
            self.pending_dropped += 1
            return
        self.invalidations_posted += 1
        if call_id in self._pending_inval:
            self.invalidations_coalesced += 1
        elif not self._pending_inval:
            self._pending_since = time.perf_counter()
        self._pending_inval[call_id] = (version, cause, origin_ts)
        self._kick()

    def post_invalidations(self, entries) -> None:
        """Batch :meth:`post_invalidation`: ``entries`` is an iterable of
        ``(call_id, version, cause, origin_ts)`` tuples, merged into the
        pending map under ONE drain wake-up. The overlap drain
        (rpc/fanout.py riding a WavePipeline harvest) ships a
        whole wave's fences for a peer with one kick instead of one per
        subscription — the kick marshals to the home loop, so per-call
        kicks from the wave-apply thread were a measurable share of the
        drain."""
        if self._stopped:
            self.pending_dropped += sum(1 for _ in entries)
            return
        posted = False
        for call_id, version, cause, origin_ts in entries:
            self.invalidations_posted += 1
            if call_id in self._pending_inval:
                self.invalidations_coalesced += 1
            elif not self._pending_inval:
                self._pending_since = time.perf_counter()
            self._pending_inval[call_id] = (version, cause, origin_ts)
            posted = True
        if posted:
            self._kick()

    def _kick(self) -> None:
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            # off-loop caller (wave applied from a worker thread, or a
            # sync context): marshal the wakeup onto the home loop. A home
            # loop that never runs simply leaves the entries pending —
            # with no running loop there is no live link to starve.
            if self._home_loop is not None and not self._home_loop.is_closed():
                try:
                    self._home_loop.call_soon_threadsafe(self._kick_on_loop)
                except RuntimeError:
                    pass  # loop closed mid-call: peer is gone
            return
        self._kick_on_loop()

    def _kick_on_loop(self) -> None:
        if self._stopped:
            return
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._drain())
        self._wake.set()

    # ------------------------------------------------------------------ drain
    async def _drain(self) -> None:
        peer = self.peer
        try:
            while True:
                await self._wake.wait()
                self._wake.clear()
                if self._stopped:
                    return
                while self._fifo or self._pending_inval:
                    if self._in_flight:
                        # a bypassing direct send is mid-channel-write;
                        # draining now would interleave with it. Its
                        # finally-block re-kicks us once it clears.
                        break
                    # snapshot length: entries appended mid-tick go next
                    # tick, so a hot FIFO can never starve the batch flush
                    for _ in range(len(self._fifo)):
                        message, future = self._fifo.popleft()
                        self._in_flight = True
                        try:
                            await peer._send_now(message)
                        except asyncio.CancelledError:
                            if future is not None and not future.done():
                                future.cancel()
                            raise
                        except BaseException as e:  # noqa: BLE001
                            if future is not None and not future.done():
                                future.set_exception(e)
                            else:  # pragma: no cover — all entries carry futures
                                log.debug("outbox %s: dropped send: %s", peer.ref, e)
                        else:
                            self.messages_sent += 1
                            if future is not None and not future.done():
                                future.set_result(None)
                        finally:
                            self._in_flight = False
                    if self._pending_inval:
                        await self._flush_invalidations()
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — the drain must never die silently
            # counted (FL002): a dead drain is a peer whose fences stop
            # flowing while the link looks healthy — the next _kick
            # re-spawns, but the fault must be visible on a scrape
            self.drain_faults += 1
            log.exception("outbox %s: drain loop failed", peer.ref)

    async def _flush_invalidations(self) -> None:
        peer = self.peer
        state = peer.connection_state.latest().value
        if state.is_terminated:
            self.pending_dropped += len(self._pending_inval)
            self._pending_inval.clear()
            self._pending_since = None
            return
        if not peer.is_connected:
            # park until the link returns; pending survives the reconnect.
            # New posts merge into the SAME map meanwhile (last wins).
            ev = peer.connection_state.latest()
            try:
                await asyncio.wait_for(
                    ev.when(lambda s: s.is_connected or s.is_terminated),
                    self.RECONNECT_GIVE_UP_S,
                )
            except asyncio.TimeoutError:
                self.pending_dropped += len(self._pending_inval)
                self._pending_inval.clear()
                self._pending_since = None
                return
            if not peer.is_connected:
                return  # terminated; next tick drops
        batch, self._pending_inval = self._pending_inval, {}
        pending_since, self._pending_since = self._pending_since, None
        message = RpcMessage(
            call_type_id=CALL_TYPE_COMPUTE,
            call_id=0,
            service=COMPUTE_SYSTEM_SERVICE,
            method="invalidate_batch",
            # entry = [call_id, version, cause, origin_ts]; clients also
            # accept the older 2-element shape (wire compat)
            argument_data=dumps(
                [[[cid, ver, cause, ts] for cid, (ver, cause, ts) in batch.items()]]
            ),
        )
        self._in_flight = True
        try:
            await peer._send_now(message)
        except asyncio.CancelledError:
            self._merge_back(batch, pending_since)
            raise
        except Exception:  # noqa: BLE001 — link died mid-flush: the batch
            # stays pending and the next tick parks on the reconnect above
            self._merge_back(batch, pending_since)
        else:
            self.batch_frames_sent += 1
            self.batch_keys_sent += len(batch)
            if pending_since is not None:
                from ..diagnostics.metrics import global_metrics

                global_metrics().histogram(
                    "fusion_outbox_flush_lag_ms",
                    help="oldest pending invalidation -> batch frame on the wire",
                ).record((time.perf_counter() - pending_since) * 1e3)
        finally:
            self._in_flight = False

    def _merge_back(self, batch: Dict[int, Tuple], pending_since: Optional[float] = None) -> None:
        """Re-pend a failed batch WITHOUT clobbering newer posts: anything
        posted since the flush snapshot is newer than the snapshot entry.
        A batch whose flush was cancelled by stop() is dropped — re-pending
        onto a permanently dead drain would report phantom pending entries
        forever."""
        if self._stopped:
            self.pending_dropped += len(batch)
            return
        for call_id, entry in batch.items():
            self._pending_inval.setdefault(call_id, entry)
        # the snapshot's entries are back: the lag clock resumes from the
        # ORIGINAL oldest post, not from the failed flush
        if pending_since is not None and (
            self._pending_since is None or pending_since < self._pending_since
        ):
            self._pending_since = pending_since
        self._wake.set()

    # ------------------------------------------------------------------ lifecycle
    def stop(self) -> None:
        self._stopped = True
        if self._task is not None and not self._task.done():
            self._task.cancel()
        err = ConnectionError(f"peer {self.peer.ref} outbox stopped")
        while self._fifo:
            _, future = self._fifo.popleft()
            if future is not None and not future.done():
                future.set_exception(err)
        self.pending_dropped += len(self._pending_inval)
        self._pending_inval.clear()
        self._pending_since = None  # the age gauge must not report a ghost

    def stats(self) -> dict:
        return {
            "messages_sent": self.messages_sent,
            "invalidations_posted": self.invalidations_posted,
            "invalidations_coalesced": self.invalidations_coalesced,
            "batch_frames_sent": self.batch_frames_sent,
            "batch_keys_sent": self.batch_keys_sent,
            "pending_dropped": self.pending_dropped,
            "drain_faults": self.drain_faults,
            "queued": len(self._fifo),
            "pending_invalidations": len(self._pending_inval),
        }
