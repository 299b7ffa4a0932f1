"""Multi-process edge delivery plane.

A single-process edge tier measures a pure-Python ceiling: one process fans
~292k session-deliveries/s no matter how cheap the per-delivery work
gets, because one interpreter walks every session. This module moves the
DELIVERY half of the edge onto N OS worker processes while the parent
:class:`~.gateway.EdgeNode` keeps the UPSTREAM half — the single
subscription per distinct key, the shard-map affinity, the resume/park
state. The split rides the serialize-once contract end to end:

- the parent encodes each fenced frame ONCE (``EdgeNode.encode_frame``)
  and pushes the immutable body bytes over a per-worker socketpair —
  one ``F`` message per (worker, key, version), never per session;
- each worker owns its sockets and ONLY writes bytes: the per-session
  work is assembling ``id: <token>\\n`` + the shared SSE tail and
  pushing it down the connection — no JSON, no Python object graph, no
  upstream state;
- deliveries/s therefore scales with worker processes (measured in
  ``stl_fusion_tpu_torch/edge_path.py``; the bench records ``deliveries_per_s_per_worker``).

**Socket ownership: a ``send_fds`` accept plane, REUSEPORT
as the fallback knob.** Per-worker ``SO_REUSEPORT``
listeners — symmetric workers, no parent accept loop — come at the cost of
kernel-hash placement: a RECONNECT could land on a different worker, so
resume tokens were worker-local. The default accept plane now closes
that tradeoff: the PARENT owns one listening socket, reads just the
request head off each accepted connection, routes by the resume token's
worker ordinal (``es-w<N>-…``, from the ``Last-Event-ID`` header or the
``resume=`` query param; tokenless connections round-robin), and hands
the fd to that worker over a dedicated ``socket.send_fds`` channel
along with the already-read head bytes. A resume token is therefore
valid on ANY connection — the parent delivers it to the worker that
parked it, which replays only the versions the session missed.
``accept_plane="reuseport"`` keeps the per-worker listener shape (symmetric
independently-restartable workers, no parent accept hop) for
deployments that prefer it; its resume misses still fall back to a
fresh attach. EDGE.md documents both planes' capacity math.

Wire protocol (parent <-> worker, framed ``!BI`` type+length):

    parent -> worker                     worker -> parent
    K {id, key}        register key
    S {sessions}       add sim sessions
    F key_id ver t0 body  one encoded frame
    L {host, port}     start SSE listener  P {port}   actual bound port
    G {heartbeat, resume_ttl}  SSE config (send_fds plane: no bind)
    Q {seq}            stats request       R {...}    stats reply
    X                  shutdown            U {conn, keys}  SSE subscribe
                                           D {conn, key_ids} SSE closed

    (fd channel, send_fds plane only: one sendmsg per accepted conn —
     ``!I``-framed JSON {head: b64} + the connection fd as ancillary)

Workers are spawned as ``python <this file> --worker`` subprocesses so
they import NOTHING beyond the standard library — no torch, no package
``__init__`` — and are serving in tens of milliseconds.

Simulated sessions (``S``) are the 1M-subscriber benchmark's population:
a worker-held list of per-session envelope prefixes per key; a frame
"delivery" assembles the exact bytes a socket write would take (prefix +
shared tail) and accounts for it, without a million real TCP peers. The
REAL path (``L`` + SSE over SO_REUSEPORT) serves actual browsers with
the same code path and is what the CI smoke drives.
"""
from __future__ import annotations

import asyncio
import base64
import json
import logging
import os
import socket
import struct
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["EdgeWorkerPool"]

_HEADER = struct.Struct("!BI")
_FRAME = struct.Struct("!IId")  # key_id, version, t0 (-1.0 = none)

#: the worker's drain-time 503 for connections caught MID-ATTACH — the
#: same wire shape as edge.admission.rejection_bytes (status, JSON body,
#: Retry-After, Connection: close), inlined because the worker half of
#: this file is stdlib-only and cannot import the package
_DRAIN_503_BODY = (
    b'{"error":{"type":"AdmissionRejected","reason":"draining",'
    b'"retry_after":1}}'
)
_DRAIN_503 = (
    b"HTTP/1.1 503 Service Unavailable\r\n"
    b"Content-Type: application/json\r\n"
    b"Content-Length: " + str(len(_DRAIN_503_BODY)).encode() + b"\r\n"
    b"Cache-Control: no-cache\r\nConnection: close\r\nRetry-After: 1"
    b"\r\n\r\n" + _DRAIN_503_BODY
)

# log-scale histogram buckets — MUST mirror diagnostics.metrics.Histogram
# (lo * 2^k up to hi, + overflow) so the parent can merge worker counts
# into fusion_edge_delivery_ms bucket-for-bucket
_HIST_LO, _HIST_HI = 0.001, 120_000.0


def _hist_edges() -> List[float]:
    edges, edge = [], _HIST_LO
    while edge <= _HIST_HI:
        edges.append(edge)
        edge *= 2.0
    return edges


def _bisect_left(edges: List[float], v: float) -> int:
    lo, hi = 0, len(edges)
    while lo < hi:
        mid = (lo + hi) // 2
        if edges[mid] < v:
            lo = mid + 1
        else:
            hi = mid
    return lo


# ======================================================================
# parent side
# ======================================================================


class _Worker:
    """Parent-side handle to one delivery worker process."""

    __slots__ = (
        "index", "proc", "sock", "fd_sock", "fd_lock", "reader", "writer",
        "reader_task", "interest", "sim_keys", "conn_refs", "stats_futures",
        "port_future", "last_stats", "last_hist", "sim_sessions", "outbuf",
    )

    def __init__(self, index: int):
        self.index = index
        self.proc = None
        self.sock: Optional[socket.socket] = None
        #: the send_fds channel: accepted-connection fds ride here (one
        #: sendmsg per conn), never the framed control stream above.
        #: NON-blocking + lock-serialized: a wedged worker must cost
        #: dropped handoffs, never a frozen parent event loop, and two
        #: concurrent handoffs must never interleave a partial frame
        self.fd_sock: Optional[socket.socket] = None
        self.fd_lock: Optional[asyncio.Lock] = None
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.reader_task: Optional[asyncio.Task] = None
        #: key_ids this worker has sessions (sim or real) on — the frame
        #: broadcast filter. Materialized from ``sim_keys`` (permanent for
        #: the pool's life) ∪ keys with a live real-connection refcount —
        #: pruned on disconnect so a key nobody watches stops costing a
        #: pipe write per fence
        self.interest: set = set()
        self.sim_keys: set = set()
        self.conn_refs: Dict[int, int] = {}
        self.stats_futures: Dict[int, asyncio.Future] = {}
        self.port_future: Optional[asyncio.Future] = None
        self.last_stats: Optional[dict] = None
        #: previous cumulative histogram buckets (delta-merge source)
        self.last_hist: Optional[List[int]] = None
        self.sim_sessions = 0
        #: pending outbound messages — flushed as ONE write per event-loop
        #: tick (a write per message would wake the worker per frame; the
        #: wake-up preemption ping-pong measurably halves the parent's
        #: upstream throughput during a burst)
        self.outbuf: List[bytes] = []

    def send(self, mtype: bytes, payload: bytes) -> None:
        if self.writer is None or self.writer.is_closing():
            return
        self.outbuf.append(_HEADER.pack(mtype[0], len(payload)) + payload)

    def send_json(self, mtype: bytes, obj: Any) -> None:
        self.send(mtype, json.dumps(obj).encode())

    def flush(self) -> None:
        if not self.outbuf:
            return
        buf, self.outbuf = self.outbuf, []
        if self.writer is None or self.writer.is_closing():
            return
        self.writer.write(b"".join(buf))


class EdgeWorkerPool:
    """N OS delivery processes behind one :class:`~.gateway.EdgeNode`.

    ``await pool.start()`` spawns the workers and registers the pool as
    the node's delivery-plane broadcast: every fanned frame's SHARED
    encoded bytes go to each worker with sessions on that key, exactly
    once per (worker, key, version).

    - :meth:`add_sim_sessions` populates the benchmark population;
    - :meth:`listen` starts the real SO_REUSEPORT SSE listeners;
    - :meth:`stats` pulls per-worker counters and merges the workers'
      delivery histograms into the process ``fusion_edge_delivery_ms``
      (so the system's own histogram stays the single source of truth).
    """

    def __init__(self, node, workers: int = 2, stats_timeout: float = 10.0,
                 flush_interval: float = 0.02, accept_plane: str = "send_fds",
                 resume_ttl: float = 60.0):
        if workers < 1:
            raise ValueError("worker pool needs at least 1 worker")
        if accept_plane not in ("send_fds", "reuseport"):
            raise ValueError(
                f"accept_plane must be 'send_fds' or 'reuseport', "
                f"got {accept_plane!r}"
            )
        self.node = node
        self.n_workers = workers
        self.stats_timeout = stats_timeout
        #: "send_fds" (default): the parent accepts, routes by resume
        #: token, and hands each fd to the owning worker — portable resume
        #: tokens. "reuseport": per-worker SO_REUSEPORT
        #: listeners, kernel-hash placement, worker-local tokens.
        self.accept_plane = accept_plane
        #: how long a worker parks a disconnected SSE session's delivered-
        #: version map under its token (the resume replay source)
        self.resume_ttl = resume_ttl
        #: frame-pipe flush window. Every write to a worker pipe WAKES the
        #: worker process, and on a saturated box the sender-preemption
        #: ping-pong (one wake per fanned frame per worker) measurably
        #: halves the parent's upstream fence throughput — so frame posts
        #: buffer up to this long and ship as one write per worker. The
        #: added delivery latency (≤ the window) is noise against the
        #: fence→visible distribution; control round-trips (stats, listen,
        #: shutdown) flush immediately.
        self.flush_interval = flush_interval
        self._workers: List[_Worker] = []
        self._key_ids: Dict[str, int] = {}
        self._key_specs: Dict[str, tuple] = {}
        #: upstream pins held for simulated sessions (released at stop)
        self._sim_acquired: List[str] = []
        #: (worker, conn) -> acquired key_strs for real SSE connections
        self._conn_keys: Dict[tuple, List[str]] = {}
        self._stats_seq = 0
        self._started = False
        self._flush_scheduled = False
        self.listen_port: Optional[int] = None
        #: the send_fds plane's parent listener + accept machinery
        self._listen_sock: Optional[socket.socket] = None
        self._accept_task: Optional[asyncio.Task] = None
        self._route_tasks: set = set()
        self._accept_rr = 0
        self.routed_conns = 0  # fds handed to workers
        self.routed_by_token = 0  # of which: placed by a resume token
        self.route_errors = 0
        self.shed_conns = 0  # admission/overload rejections answered 503
        #: tokens the workers reported PARKED (disconnect `D` messages
        #: carry them): the accept plane grants the reserved resume lane
        #: only to a token it knows is genuinely parked — a forged
        #: ``?resume=es-w0-x`` rides the cold lane like any other cold
        #: attach. token -> expiry (resume_ttl), amortized prune.
        self._parked_tokens: Dict[str, float] = {}
        self._next_token_prune = 0.0
        #: recent dropped-handoff timestamps — the worker-pipe saturation
        #: signal: registered as an admission pressure source
        #: at start(); ``drop_pressure_threshold`` drops inside
        #: ``drop_pressure_window`` seconds reads as FULL pressure
        self._drop_times: List[float] = []
        self.drop_pressure_window = 5.0
        self.drop_pressure_threshold = 8
        #: cumulative deliveries last pulled from workers (sync-readable
        #: by the node's metrics collector)
        self.deliveries_seen = 0
        self._hist_edges = _hist_edges()

    # -------------------------------------------------------------- lifecycle
    async def start(self) -> "EdgeWorkerPool":
        if self._started:
            return self
        loop = asyncio.get_event_loop()
        script = os.path.abspath(__file__)
        for i in range(self.n_workers):
            w = _Worker(i)
            parent_sock, child_sock = socket.socketpair()
            parent_sock.setblocking(False)
            # the fd-handoff channel (send_fds accept plane) — created
            # unconditionally so the plane can be chosen at listen() time
            parent_fd_sock, child_fd_sock = socket.socketpair()
            parent_fd_sock.setblocking(False)
            w.fd_lock = asyncio.Lock()
            import subprocess

            w.proc = subprocess.Popen(
                [sys.executable, script, "--worker", str(i),
                 str(child_sock.fileno()), str(child_fd_sock.fileno())],
                pass_fds=(child_sock.fileno(), child_fd_sock.fileno()),
                close_fds=True,
            )
            child_sock.close()
            child_fd_sock.close()
            w.sock = parent_sock
            w.fd_sock = parent_fd_sock
            w.reader, w.writer = await asyncio.open_connection(sock=parent_sock)
            w.reader_task = loop.create_task(self._read_worker(w))
            self._workers.append(w)
        self._started = True
        self.node.worker_pool = self
        self.node.attach_broadcast(self._on_frame)
        admission = getattr(self.node, "admission", None)
        if admission is not None:
            # worker-pipe saturation feeds the admission controller: a
            # wedged delivery worker costs dropped handoffs (already
            # counted in route_errors), and the drop rate IS the load
            # signal that sheds anonymous cold attaches upstream of it
            admission.add_pressure_source(
                f"{self.node.name}:worker_pipe", self._pipe_pressure
            )
        return self

    # -------------------------------------------------------------- pressure
    def _note_drop(self) -> None:
        self._drop_times.append(time.monotonic())

    def _pipe_pressure(self) -> float:
        """0..1 worker-pipe saturation from recent dropped fd-handoffs
        (pruned to the window on every pull)."""
        cutoff = time.monotonic() - self.drop_pressure_window
        self._drop_times = [t for t in self._drop_times if t >= cutoff]
        return min(1.0, len(self._drop_times) / self.drop_pressure_threshold)

    async def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        self.node.detach_broadcast(self._on_frame)
        admission = getattr(self.node, "admission", None)
        if admission is not None:
            admission.clear_pressure(f"{self.node.name}:worker_pipe")
        if self.node.worker_pool is self:
            self.node.worker_pool = None
        if self._accept_task is not None:
            self._accept_task.cancel()
            self._accept_task = None
        for task in list(self._route_tasks):
            task.cancel()
        if self._listen_sock is not None:
            try:
                self._listen_sock.close()
            except OSError:
                pass
            self._listen_sock = None
        for w in self._workers:
            try:
                w.send(b"X", b"")
                w.flush()
                if w.writer is not None:
                    await w.writer.drain()
            except Exception:  # noqa: BLE001 — already-dead worker
                pass
        for w in self._workers:
            if w.reader_task is not None:
                w.reader_task.cancel()
            if w.writer is not None:
                try:
                    w.writer.close()
                except Exception:  # noqa: BLE001
                    pass
            if w.proc is not None:
                # reap off-loop: a blocking wait() here would freeze every
                # other edge's watch loops and pumps for up to the timeout
                try:
                    await asyncio.get_event_loop().run_in_executor(
                        None, w.proc.wait, 5.0
                    )
                except Exception:  # noqa: BLE001 — escalate
                    try:
                        w.proc.kill()
                        await asyncio.get_event_loop().run_in_executor(
                            None, w.proc.wait, 5.0
                        )
                    except Exception:  # noqa: BLE001 — a zombie must not
                        # fail stop(); the OS reaps it with the parent
                        log.exception(
                            "edge worker %d did not exit after kill", w.index
                        )
        for w in self._workers:
            if w.fd_sock is not None:
                try:
                    w.fd_sock.close()
                except OSError:
                    pass
        # release every key real connections + sim sessions still held
        for (_wi, _conn), (key_strs, _kids) in list(self._conn_keys.items()):
            self.node.release_keys(key_strs)
        self._conn_keys.clear()
        self.node.release_keys(self._sim_acquired)
        self._sim_acquired.clear()
        self._workers.clear()

    async def drain(self) -> int:
        """The delivery plane's half of a graceful drain:
        stop accepting (both planes — the parent listener closes, each
        worker closes its REUSEPORT listener), then every worker writes
        its live SSE connections ONE ``event: reconnect`` hint carrying
        the session's resume token and closes them cleanly, parking the
        delivered-version maps. Returns the number of connections
        hinted. Called by :meth:`EdgeNode.drain` — a pooled deployment's
        sessions are NOT stranded when the node drains."""
        if not self._started:
            return 0
        if self._accept_task is not None:
            self._accept_task.cancel()
            self._accept_task = None
        if self._listen_sock is not None:
            try:
                self._listen_sock.close()
            except OSError:
                pass
            self._listen_sock = None
        loop = asyncio.get_event_loop()
        self._stats_seq += 1
        seq = self._stats_seq
        futures = []
        for w in self._workers:
            fut = loop.create_future()
            w.stats_futures[seq] = fut
            w.send_json(b"Y", {"seq": seq})
            futures.append(fut)
        self._flush_all()
        # per-future harvest: ONE wedged worker missing the deadline must
        # not discard the healthy workers' counts (their sessions WERE
        # hinted — under-reporting sessions_drained would make the drain
        # accounting unreconcilable); its own clients reconnect on the
        # dead socket instead
        await asyncio.wait(futures, timeout=self.stats_timeout)
        total = 0
        for w, fut in zip(self._workers, futures):
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                total += int(fut.result().get("drained", 0))
            else:
                log.warning(
                    "edge worker %d never acked the drain", w.index
                )
                fut.cancel()
        return total

    # -------------------------------------------------------------- flushing
    def _kick_flush(self) -> None:
        """Coalesce up to ``flush_interval`` of outbound messages into ONE
        write per worker (see the knob's comment: per-frame writes cost
        the parent half its upstream throughput in wake-up preemption)."""
        if self._flush_scheduled:
            return
        self._flush_scheduled = True
        asyncio.get_event_loop().call_later(self.flush_interval, self._flush_all)

    def _flush_all(self) -> None:
        self._flush_scheduled = False
        for w in self._workers:
            w.flush()

    # -------------------------------------------------------------- keys
    def _key_id_for(self, key_str: str, spec: tuple) -> int:
        kid = self._key_ids.get(key_str)
        if kid is None:
            kid = self._key_ids[key_str] = len(self._key_ids)
            self._key_specs[key_str] = spec
            for w in self._workers:
                w.send_json(b"K", {"id": kid, "key": key_str})
        return kid

    # -------------------------------------------------------------- sim
    async def add_sim_sessions(
        self, worker: int, counts: Dict[Any, int], acquire: bool = True
    ) -> int:
        """Register simulated sessions on one worker: ``counts`` maps a
        key spec ``(method, *args)`` to how many sessions subscribe it
        there. With ``acquire`` the parent pins the upstream subs (the
        node must keep watching these keys while the worker serves
        them). Returns the number of (session, key) subscriptions
        added."""
        w = self._workers[worker]
        specs = list(counts.keys())
        if acquire:
            key_strs = self.node.acquire_keys(specs)
            self._sim_acquired.extend(key_strs)
        else:
            key_strs = [self.node.key_str(s) for s in specs]
        payload: Dict[str, int] = {}
        total = 0
        for spec, ks in zip(specs, key_strs):
            kid = self._key_id_for(ks, tuple(spec))
            n = int(counts[spec])
            payload[str(kid)] = n
            w.interest.add(kid)
            w.sim_keys.add(kid)
            total += n
        w.sim_sessions += total
        w.send_json(b"S", {"sessions": payload})
        self._flush_all()
        if w.writer is not None:
            await w.writer.drain()
        return total

    # -------------------------------------------------------------- real SSE
    async def listen(self, host: str = "127.0.0.1", port: int = 0,
                     heartbeat_interval: float = 15.0) -> int:
        """Start the SSE surface on the configured accept plane.

        ``send_fds`` (default): the PARENT binds one listener, reads each
        accepted connection's request head, routes by the resume token's
        worker ordinal (tokenless conns round-robin) and hands the fd to
        that worker — resume tokens are portable across the whole pool.
        ``reuseport``: every worker binds the same (host, port) with
        SO_REUSEPORT and the kernel places connections.
        Returns the bound port."""
        loop = asyncio.get_event_loop()
        if self.accept_plane == "send_fds":
            for w in self._workers:
                w.send_json(b"G", {"heartbeat": heartbeat_interval,
                                   "resume_ttl": self.resume_ttl})
            self._flush_all()
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
            sock.listen(256)
            sock.setblocking(False)
            self._listen_sock = sock
            self._accept_task = loop.create_task(self._accept_loop(sock))
            self.listen_port = sock.getsockname()[1]
            return self.listen_port
        first = self._workers[0]
        first.port_future = loop.create_future()
        first.send_json(b"L", {"host": host, "port": port,
                               "heartbeat": heartbeat_interval,
                               "resume_ttl": self.resume_ttl})
        self._flush_all()
        bound = await asyncio.wait_for(first.port_future, self.stats_timeout)
        for w in self._workers[1:]:
            w.port_future = loop.create_future()
            w.send_json(b"L", {"host": host, "port": bound,
                               "heartbeat": heartbeat_interval,
                               "resume_ttl": self.resume_ttl})
            self._flush_all()
            await asyncio.wait_for(w.port_future, self.stats_timeout)
        self.listen_port = bound
        return bound

    async def _accept_loop(self, sock: socket.socket) -> None:
        """The send_fds plane's parent accept loop: accept, then route
        each connection in its own task — a slow client reading its head
        never delays the next accept."""
        loop = asyncio.get_event_loop()
        try:
            while True:
                try:
                    conn, _addr = await loop.sock_accept(sock)
                except OSError:
                    return  # listener closed
                task = loop.create_task(self._route_conn(conn))
                self._route_tasks.add(task)
                task.add_done_callback(self._route_tasks.discard)
        except asyncio.CancelledError:
            raise

    async def _route_conn(self, conn: socket.socket) -> None:
        """Read one accepted connection's request head (bounded), admit
        or shed it (the node's AdmissionController — tenant from the head,
        reconnects on the resume lane), pick the worker — the resume
        token's minted ordinal when present, else round-robin — and hand
        the fd + head over ``socket.send_fds``. The worker receives a
        DUPLICATE fd; the parent's copy closes either way, so a handoff
        failure costs the client one ANSWERED 503 (never a hung socket: a
        dropped handoff is pressure, not a silent failure)."""
        loop = asyncio.get_event_loop()
        try:
            conn.setblocking(False)
            head = b""
            # 64 KB cap = the reuseport path's StreamReader limit: a key
            # list that fits max_keys_per_session in the URL must route
            # the same on both planes
            while b"\r\n\r\n" not in head and len(head) < 65536:
                chunk = await asyncio.wait_for(loop.sock_recv(conn, 8192), 10.0)
                if not chunk:
                    return
                head += chunk
            if b"\r\n\r\n" not in head:
                self.route_errors += 1  # oversized/garbage head: drop, counted
                return
            token, tenant = self._extract_route_info(head)
            index, by_token = self._route_index(token)
            admission = getattr(self.node, "admission", None)
            if admission is not None:
                # the resume lane is only for tokens this parent KNOWS a
                # worker parked (disconnect messages report them): a
                # forged/expired ?resume= is a cold attach and must ride
                # the cold lane's buckets, pressure shed and ceiling —
                # the token shape alone is guessable and proves nothing
                decision = admission.admit(
                    tenant_id=tenant,
                    lane="resume" if self._token_parked(token) else None,
                )
                if not decision.admitted:
                    self.shed_conns += 1
                    self.node._note_shed_event(
                        decision.reason, lane=decision.lane
                    )
                    await self._answer_reject(
                        conn, decision.reason, decision.retry_after
                    )
                    return
            w = self._workers[index]
            if w.fd_sock is None:
                # the owner's fd channel died (torn handoff): fail over
                # to any live sibling — the resume token misses there and
                # the session fresh-attaches, the documented fallback
                by_token = False
                for offset in range(1, self.n_workers):
                    sibling = self._workers[(index + offset) % self.n_workers]
                    if sibling.fd_sock is not None:
                        w = sibling
                        break
                else:
                    # every delivery worker's channel is gone: shed with
                    # an answer + Retry-After, count it as pipe pressure
                    self.route_errors += 1
                    self._note_drop()
                    self.node.count_shed("worker_pipe_drop")
                    await self._answer_reject(conn, "worker_unavailable", None)
                    return
            payload = json.dumps(
                {"head": base64.b64encode(head).decode()}
            ).encode()
            framed = struct.pack("!I", len(payload)) + payload
            try:
                await self._send_handoff(w, framed, conn.fileno())
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — wedged worker / torn channel
                # the dropped-handoff path: the client used to get a
                # closed-without-answer socket; now the PARENT answers 503
                # with Retry-After, the drop feeds the admission pressure
                # signal, and the count is never silent
                self.route_errors += 1
                self._note_drop()
                self.node.count_shed("worker_pipe_drop")
                log.exception(
                    "edge accept plane: fd handoff to worker %d dropped",
                    w.index,
                )
                await self._answer_reject(conn, "worker_pipe_drop", None)
                return
            self.routed_conns += 1
            if by_token:
                self.routed_by_token += 1
                # one shot: the worker consumes the park on resume, so a
                # replayed token is a cold attach from here on
                self._parked_tokens.pop(token, None)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001 — one conn must not kill the plane
            self.route_errors += 1
            log.exception("edge accept plane: routing a connection failed")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    async def _answer_reject(
        self, conn: socket.socket, reason: str, retry_after: Optional[float],
    ) -> None:
        """Best-effort 503 on a raw accepted socket — the SAME responder
        bytes (headers, Retry-After, Connection: close) as the SSE
        server's unified rejection path, so a client cannot tell which
        plane shed it."""
        from .admission import rejection_bytes

        data = rejection_bytes(
            "503 Service Unavailable",
            {"error": {"type": "AdmissionRejected", "reason": reason,
                       "retry_after": retry_after}},
            retry_after if retry_after is not None else 1.0,
        )
        try:
            await asyncio.wait_for(
                asyncio.get_event_loop().sock_sendall(conn, data), 2.0
            )
        except Exception:  # noqa: BLE001 — the peer is gone; count stands
            pass

    async def _send_handoff(self, w: _Worker, framed: bytes, fd: int,
                            timeout: float = 10.0) -> None:
        """One fd handoff over the NON-blocking channel: per-worker
        lock-serialized (a partially-sent frame must never interleave
        with a sibling's), waiting out transient backpressure and giving
        up — counted by the caller's error path — after ``timeout``
        rather than ever blocking the parent's event loop on a wedged
        worker."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        async with w.fd_lock:
            while True:
                try:
                    sent = socket.send_fds(w.fd_sock, [framed], [fd])
                    break
                except (BlockingIOError, InterruptedError):
                    if loop.time() > deadline:
                        raise TimeoutError(
                            f"worker {w.index} fd channel backpressured"
                        )
                    await self._wait_writable(w.fd_sock, 0.25)
            if sent < len(framed):
                # the fd rode the first sendmsg's ancillary data; finish
                # the frame bytes (still under the lock). A MID-FRAME
                # failure leaves a torn length-prefixed frame on the wire
                # — every later handoff would desync and mispair fds — so
                # the channel dies with it: routing fails over to live
                # siblings (counted; a token miss is a fresh attach).
                try:
                    await asyncio.wait_for(
                        loop.sock_sendall(w.fd_sock, framed[sent:]),
                        max(0.1, deadline - loop.time()),
                    )
                except BaseException:
                    sock, w.fd_sock = w.fd_sock, None
                    try:
                        sock.close()
                    except OSError:
                        pass
                    raise

    def _token_parked(self, token: Optional[str]) -> bool:
        """Is this a token a worker reported parked (and unexpired)?
        Amortized prune, the gateway's sweep shape."""
        if token is None or not self._parked_tokens:
            return False
        now = time.monotonic()
        if now >= self._next_token_prune:
            self._next_token_prune = now + max(1.0, self.resume_ttl / 4)
            self._parked_tokens = {
                t: dl for t, dl in self._parked_tokens.items() if dl >= now
            }
        deadline = self._parked_tokens.get(token)
        return deadline is not None and deadline >= now

    @staticmethod
    async def _wait_writable(sock: socket.socket, timeout: float) -> None:
        loop = asyncio.get_event_loop()
        future = loop.create_future()
        fd = sock.fileno()

        def _on_writable() -> None:
            if not future.done():
                future.set_result(None)

        loop.add_writer(fd, _on_writable)
        try:
            await asyncio.wait_for(future, timeout)
        except (asyncio.TimeoutError, TimeoutError):
            pass  # the caller's deadline decides when to give up
        finally:
            loop.remove_writer(fd)

    @staticmethod
    def _extract_route_info(head: bytes):
        """ONE pass over the request head for the accept plane's two
        identities: the resume token (``resume=`` / ``Last-Event-ID``,
        the routing AND lane identity) and the tenant id (``tenant=`` /
        ``X-Tenant`` — the SAME wire contract as EdgeHttpServer's
        admission hop). Returns ``(token, tenant)``."""
        from urllib.parse import unquote

        token = None
        tenant = ""
        request_line, _, rest = head.partition(b"\r\n")
        parts = request_line.decode("latin-1", "replace").split(" ")
        if len(parts) >= 2:
            _path, _, query = parts[1].partition("?")
            for pair in query.split("&"):
                k, _, v = pair.partition("=")
                if k == "resume" and v and token is None:
                    token = unquote(v)
                elif k == "tenant" and v and not tenant:
                    tenant = unquote(v)
        if token is None or not tenant:
            for line in rest.split(b"\r\n"):
                low = line.lower()
                if token is None and low.startswith(b"last-event-id:"):
                    token = line.split(b":", 1)[1].strip().decode("latin-1")
                elif not tenant and low.startswith(b"x-tenant:"):
                    tenant = line.split(b":", 1)[1].strip().decode("latin-1")
        return token, tenant

    def _route_index(self, token: Optional[str]):
        """(worker index, routed-by-token) for one extracted token. The
        token's ``es-w<N>-`` prefix names the worker that minted (and
        parked) it; anything else round-robins."""
        if token is not None and token.startswith("es-w"):
            ordinal, _, _tail = token[4:].partition("-")
            if ordinal.isdigit():
                index = int(ordinal)
                if index < self.n_workers:
                    return index, True
        index = self._accept_rr % self.n_workers
        self._accept_rr += 1
        return index, False

    # -------------------------------------------------------------- frames
    def _on_frame(self, key_str: str, frame, encoded) -> None:
        """EdgeNode broadcast hook: ship the SHARED encoded body to every
        worker with sessions on this key — the message bytes are built
        once and written to W pipes, never per session."""
        kid = self._key_ids.get(key_str)
        if kid is None:
            return
        t0 = frame[4] if frame[4] is not None else -1.0
        payload = _FRAME.pack(kid, frame[1], t0) + encoded.body
        msg = _HEADER.pack(ord("F"), len(payload)) + payload
        for w in self._workers:
            if kid in w.interest:
                w.outbuf.append(msg)
        self._kick_flush()

    # -------------------------------------------------------------- stats
    async def stats(self) -> List[dict]:
        """Pull per-worker stats; merges the workers' delivery-histogram
        DELTAS into the process ``fusion_edge_delivery_ms`` histogram and
        refreshes :attr:`deliveries_seen` + each worker's
        ``last_stats`` (what ``/edge/stats`` embeds)."""
        loop = asyncio.get_event_loop()
        self._stats_seq += 1
        seq = self._stats_seq
        futures = []
        for w in self._workers:
            fut = loop.create_future()
            w.stats_futures[seq] = fut
            w.send_json(b"Q", {"seq": seq})
            futures.append(fut)
        self._flush_all()
        replies = await asyncio.wait_for(
            asyncio.gather(*futures), self.stats_timeout
        )
        from ..diagnostics.metrics import global_metrics

        hist = global_metrics().histogram(
            "fusion_edge_delivery_ms",
            help="server fence (wave apply) -> edge session client-visible",
        )
        total = 0
        for w, stats in zip(self._workers, replies):
            w.last_stats = stats
            total += int(stats.get("deliveries", 0))
            buckets = stats.get("hist") or []
            prev = w.last_hist or [0] * len(buckets)
            for i, count in enumerate(buckets):
                delta = count - (prev[i] if i < len(prev) else 0)
                if delta <= 0:
                    continue
                # the bucket's upper edge re-buckets to the same slot in
                # the registry histogram (mirrored edges)
                if i < len(self._hist_edges):
                    hist.record_many(self._hist_edges[i], delta)
                else:
                    hist.record_many(self._hist_edges[-1] * 2.0, delta)
            w.last_hist = list(buckets)
        self.deliveries_seen = total
        return replies

    def snapshot(self) -> dict:
        """Sync view for ``EdgeNode.snapshot()`` — the last pulled
        per-worker stats (call :meth:`stats` to refresh)."""
        return {
            "workers": self.n_workers,
            "listen_port": self.listen_port,
            "accept_plane": self.accept_plane,
            "routed_conns": self.routed_conns,
            "routed_by_token": self.routed_by_token,
            "route_errors": self.route_errors,
            "shed_conns": self.shed_conns,
            "pipe_pressure": round(self._pipe_pressure(), 4),
            "deliveries": self.deliveries_seen,
            "per_worker": [w.last_stats for w in self._workers],
        }

    # -------------------------------------------------------------- inbound
    async def _read_worker(self, w: _Worker) -> None:
        try:
            while True:
                head = await w.reader.readexactly(_HEADER.size)
                mtype, length = _HEADER.unpack(head)
                payload = await w.reader.readexactly(length) if length else b""
                ch = chr(mtype)
                if ch == "R":
                    stats = json.loads(payload)
                    fut = w.stats_futures.pop(stats.get("seq", 0), None)
                    if fut is not None and not fut.done():
                        fut.set_result(stats)
                elif ch == "P":
                    info = json.loads(payload)
                    if w.port_future is not None and not w.port_future.done():
                        if "error" in info:
                            w.port_future.set_exception(
                                RuntimeError(info["error"])
                            )
                        else:
                            w.port_future.set_result(info["port"])
                elif ch == "U":
                    self._handle_subscribe(w, json.loads(payload))
                elif ch == "D":
                    self._handle_disconnect(w, json.loads(payload))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass  # worker exited
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — reader must not die silently
            log.exception("edge worker %d reader failed", w.index)

    def _handle_subscribe(self, w: _Worker, req: dict) -> None:
        """A worker's real SSE connection asked for keys: acquire the
        upstream subs, assign key ids, ack with the ids + the current
        cached frames (the attach replay, base64 over the control
        channel)."""
        conn = req.get("conn")
        admission = getattr(self.node, "admission", None)
        specs = [tuple(k) for k in req.get("keys", [])]
        if admission is not None and not req.get("resumed") and specs:
            # the per-tenant subscribe-rate debit this plane DEFERRED at
            # the accept hop (the key specs were not readable there):
            # same bucket as the SSE plane; resumed sessions replay and
            # are exempt. Counted ONCE (admit_keys moved the per-reason
            # counter — this must NOT fall into the bad_request path
            # below, which would double-count the one rejection under
            # two reasons); the worker answers the unified 503 shape.
            verdict = admission.admit_keys(
                tenant_id=req.get("tenant") or "", keys=len(specs)
            )
            if not verdict.admitted:
                self.node._note_shed_event(verdict.reason)
                w.send_json(b"A", {
                    "conn": conn,
                    "error": f"admission rejected ({verdict.reason})",
                    "status": 503,
                    "retry_after": verdict.retry_after,
                })
                self._kick_flush()
                return
        try:
            if not specs:
                raise ValueError("no keys")
            if len(specs) > self.node.max_keys_per_session:
                raise ValueError(
                    f"session asks for {len(specs)} keys; this edge caps "
                    f"at {self.node.max_keys_per_session} per session"
                )
            key_strs = self.node.acquire_keys(specs)
        except Exception as e:  # noqa: BLE001 — the CLIENT's bad input
            # counted on the SAME shed taxonomy as the SSE plane's 400s
            # (the worker answers the HTTP 400; the parent owns the count)
            self.node.count_shed("bad_request")
            w.send_json(b"A", {"conn": conn, "error": str(e)})
            self._kick_flush()
            return
        keys_out = []
        replays = []
        kids = []
        for spec, ks in zip(specs, key_strs):
            kid = self._key_id_for(ks, spec)
            w.interest.add(kid)
            w.conn_refs[kid] = w.conn_refs.get(kid, 0) + 1
            kids.append(kid)
            keys_out.append({"id": kid, "key": ks})
            sub = self.node._subs.get(ks)
            if sub is not None and sub.last_frame is not None:
                # replayed frames ship WITHOUT the stale origin_ts — same
                # contract as EdgeNode._deliver_contained (the encode
                # cache keeps the stripped twin beside the canonical)
                lf = sub.last_frame
                if lf[4] is not None:
                    lf = (lf[0], lf[1], lf[2], lf[3], None, lf[5])
                encoded = self.node.encode_frame(lf)
                replays.append({
                    "id": kid,
                    "ver": encoded.version,
                    "body": base64.b64encode(encoded.body).decode(),
                })
        self._conn_keys[(w.index, conn)] = (key_strs, kids)
        w.send_json(b"A", {"conn": conn, "keys": keys_out, "replay": replays})
        self._kick_flush()

    def _handle_disconnect(self, w: _Worker, req: dict) -> None:
        token = req.get("token")
        if token:
            # the worker parked this session's versions under its token:
            # a reconnect carrying it is a GENUINE resume — eligible for
            # the reserved lane at the accept hop
            self._parked_tokens[token] = time.monotonic() + self.resume_ttl
        entry = self._conn_keys.pop((w.index, req.get("conn")), None)
        if entry is None:
            return
        key_strs, kids = entry
        self.node.release_keys(key_strs)
        for kid in kids:
            left = w.conn_refs.get(kid, 0) - 1
            if left > 0:
                w.conn_refs[kid] = left
            else:
                # last real connection for this key on this worker: stop
                # shipping its frames there (sim populations keep theirs)
                w.conn_refs.pop(kid, None)
                if kid not in w.sim_keys:
                    w.interest.discard(kid)


# ======================================================================
# worker side (stdlib only — this file runs as a standalone script)
# ======================================================================


class _WorkerHist:
    """The worker's delivery histogram: same log-scale buckets as the
    parent registry's Histogram so counts merge bucket-for-bucket."""

    def __init__(self):
        self.edges = _hist_edges()
        self.buckets = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def record_many(self, value: float, n: int) -> None:
        if n <= 0:
            return
        v = max(0.0, float(value))
        self.buckets[_bisect_left(self.edges, v)] += n
        self.count += n
        self.sum += v * n
        if v > self.max:
            self.max = v


class _WorkerMain:
    """One delivery worker: control-channel loop + local session tables +
    (optionally) the SO_REUSEPORT SSE listener."""

    def __init__(self, index: int, fd: int, fd_channel: Optional[int] = None):
        self.index = index
        sock = socket.socket(fileno=fd)
        sock.setblocking(False)
        self.sock = sock
        #: the send_fds handoff channel (accepted-connection fds + their
        #: pre-read request heads arrive here, outside the framed stream)
        self.fd_sock: Optional[socket.socket] = None
        if fd_channel is not None:
            self.fd_sock = socket.socket(fileno=fd_channel)
            self.fd_sock.setblocking(False)
        self._fd_buf = b""
        self._fd_pending: list = []  # fds awaiting their framed head
        #: in-flight handoff serving tasks — retained (the loop holds
        #: tasks weakly; an unreferenced one can vanish mid-accept) and
        #: cancelled at teardown so a dying worker can't leak half-served
        #: connections (fusionlint FL003). Stdlib-only: no TaskSet import
        #: here — workers run as `python <this file> --worker`.
        self._handoff_tasks: set = set()
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.keys: Dict[int, str] = {}
        #: key_id -> list of per-session SSE id-prefix bytes (the sim
        #: population: everything per-session the delivery pays for)
        self.sim: Dict[int, List[bytes]] = {}
        #: key_id -> set of live real connections
        self.conns_by_key: Dict[int, set] = {}
        self.conn_seq = 0
        self.pending_subscribes: Dict[int, asyncio.Future] = {}
        #: conn_id -> not-yet-open _SseConn: registered into conns_by_key
        #: by the CONTROL LOOP the moment the subscribe ack arrives, so a
        #: frame in the same pipe batch as the ack lands in the conn's
        #: backlog instead of being dropped before the handler resumes
        self.pending_conns: Dict[int, "_SseConn"] = {}
        self.deliveries = 0
        self.delivery_bytes = 0
        self.busy_ms = 0.0
        self.frames = 0
        self.evictions = 0
        self.connections = 0
        self.hist = _WorkerHist()
        self.heartbeat_interval = 15.0
        self.resume_ttl = 60.0
        #: token -> ({kid: delivered version}, deadline) — what a resumed
        #: connection replays AGAINST (only newer versions ship). Under
        #: the send_fds plane the parent routes a token back HERE, so the
        #: park is reachable from any listener port.
        self.parked: Dict[str, tuple] = {}
        self.resumes = 0
        self.server: Optional[asyncio.AbstractServer] = None
        self._sim_minted = 0
        #: write-buffer bound per real connection: a peer that stops
        #: reading past this is evicted (aborted), never blocks siblings
        self.max_buffer = 1 << 20

    # ---------------------------------------------------------- control
    def send(self, mtype: str, payload: bytes) -> None:
        self.writer.write(_HEADER.pack(ord(mtype), len(payload)) + payload)

    def send_json(self, mtype: str, obj: Any) -> None:
        self.send(mtype, json.dumps(obj).encode())

    async def run(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(sock=self.sock)
        if self.fd_sock is not None:
            asyncio.get_event_loop().add_reader(
                self.fd_sock.fileno(), self._on_fd_readable
            )
        try:
            while True:
                head = await self.reader.readexactly(_HEADER.size)
                mtype, length = _HEADER.unpack(head)
                payload = (
                    await self.reader.readexactly(length) if length else b""
                )
                ch = chr(mtype)
                if ch == "F":
                    self.on_frame(payload)
                elif ch == "K":
                    info = json.loads(payload)
                    self.keys[int(info["id"])] = info["key"]
                elif ch == "S":
                    self.on_sim(json.loads(payload))
                elif ch == "A":
                    self.on_subscribe_ack(json.loads(payload))
                elif ch == "L":
                    await self.on_listen(json.loads(payload))
                elif ch == "G":
                    cfg = json.loads(payload)
                    self.heartbeat_interval = float(cfg.get("heartbeat", 15.0))
                    self.resume_ttl = float(cfg.get("resume_ttl", 60.0))
                elif ch == "Q":
                    self.on_stats(json.loads(payload))
                elif ch == "Y":
                    self.on_drain(json.loads(payload))
                elif ch == "X":
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass  # parent died: exit
        finally:
            if self.fd_sock is not None:
                try:
                    asyncio.get_event_loop().remove_reader(self.fd_sock.fileno())
                except (OSError, RuntimeError):
                    pass
            for task in list(self._handoff_tasks):
                if not task.done():
                    task.cancel()
            if self.server is not None:
                self.server.close()

    # ---------------------------------------------------------- fd handoff
    def _on_fd_readable(self) -> None:
        """The send_fds accept plane's inbound side: each parent sendmsg
        carries one ``!I``-framed {head} JSON + the connection fd as
        ancillary data. Linux delivers ancillary data as a read barrier,
        so fds pair with their frames FIFO even under coalesced reads."""
        try:
            msg, fds, _flags, _addr = socket.recv_fds(self.fd_sock, 65536, 8)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            try:
                asyncio.get_event_loop().remove_reader(self.fd_sock.fileno())
            except (OSError, RuntimeError):
                pass
            return
        if not msg and not fds:
            try:  # parent closed the channel
                asyncio.get_event_loop().remove_reader(self.fd_sock.fileno())
            except (OSError, RuntimeError):
                pass
            return
        self._fd_buf += msg
        self._fd_pending.extend(fds)
        while len(self._fd_buf) >= 4:
            (length,) = struct.unpack_from("!I", self._fd_buf)
            if len(self._fd_buf) < 4 + length:
                break
            payload = self._fd_buf[4: 4 + length]
            self._fd_buf = self._fd_buf[4 + length:]
            if not self._fd_pending:
                continue  # frame without its fd (handoff raced a close)
            fd = self._fd_pending.pop(0)
            try:
                info = json.loads(payload)
                head = base64.b64decode(info["head"])
                conn_sock = socket.socket(fileno=fd)
                conn_sock.setblocking(False)
            except Exception:  # noqa: BLE001 — drop the broken handoff
                try:
                    os.close(fd)
                except OSError:
                    pass
                continue
            task = asyncio.get_event_loop().create_task(
                self._handle_handoff(conn_sock, head)
            )
            self._handoff_tasks.add(task)
            task.add_done_callback(self._handoff_tasks.discard)

    async def _handle_handoff(self, conn_sock: socket.socket, head: bytes) -> None:
        try:
            reader, writer = await asyncio.open_connection(sock=conn_sock)
        except Exception:  # noqa: BLE001 — peer vanished during handoff
            try:
                conn_sock.close()
            except OSError:
                pass
            return
        await self._serve_conn(reader, writer, head)

    # ---------------------------------------------------------- sim
    def on_sim(self, req: dict) -> None:
        for kid_str, count in req.get("sessions", {}).items():
            kid = int(kid_str)
            lst = self.sim.setdefault(kid, [])
            for _ in range(int(count)):
                self._sim_minted += 1
                lst.append(
                    f"id: es-w{self.index}-{self._sim_minted}\n".encode()
                )

    # ---------------------------------------------------------- frames
    def on_frame(self, payload: bytes) -> None:
        kid, version, t0 = _FRAME.unpack_from(payload)
        body = payload[_FRAME.size:]
        # the shared tail is assembled ONCE per (worker, frame); each
        # session pays only its envelope prefix + the concat/write
        tail = b"event: update\ndata: " + body + b"\n\n"
        t_start = time.perf_counter()
        n = 0
        nbytes = 0
        prefixes = self.sim.get(kid)
        if prefixes:
            for prefix in prefixes:
                chunk = prefix + tail  # the per-session delivery assembly
                nbytes += len(chunk)
            n += len(prefixes)
        conns = self.conns_by_key.get(kid)
        if conns:
            dead = None
            for conn in conns:
                if conn.deliver(kid, version, tail):
                    n += 1
                    nbytes += len(conn.prefix) + len(tail)
                else:
                    dead = dead or []
                    dead.append(conn)
            for conn in dead or ():
                conn.abort()
                self.evictions += 1
        now = time.perf_counter()
        self.deliveries += n
        self.delivery_bytes += nbytes
        self.frames += 1
        self.busy_ms += (now - t_start) * 1e3
        if t0 >= 0.0 and n:
            # perf_counter is CLOCK_MONOTONIC — one timeline across the
            # processes of one host, so fence -> worker-visible is real
            self.hist.record_many((now - t0) * 1e3, n)

    # ---------------------------------------------------------- stats
    def on_stats(self, req: dict) -> None:
        rss = 0.0
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        rss = int(line.split()[1]) / 1024.0
                        break
        except OSError:
            pass
        self.send_json("R", {
            "seq": req.get("seq", 0),
            "worker": self.index,
            "pid": os.getpid(),
            "deliveries": self.deliveries,
            "delivery_bytes": self.delivery_bytes,
            "frames": self.frames,
            "busy_ms": round(self.busy_ms, 3),
            "rss_mb": round(rss, 1),
            "sim_sessions": sum(len(v) for v in self.sim.values()),
            "connections": self.connections,
            "evictions": self.evictions,
            "resumes": self.resumes,
            "parked": len(self.parked),
            "hist": self.hist.buckets,
            "hist_count": self.hist.count,
            "hist_sum": round(self.hist.sum, 3),
            "hist_max": round(self.hist.max, 3),
        })

    # ---------------------------------------------------------- drain
    def on_drain(self, req: dict) -> None:
        """Graceful drain: stop accepting,
        write every live SSE connection ONE ``event: reconnect`` hint
        (the session's resume token rides both the ``id:`` line and the
        data payload) and CLOSE the stream cleanly — the handler's
        teardown parks the delivered-version map under the token, so a
        reconnect to this worker resumes, and a reconnect to a RESTARTED
        pool misses the park and fresh-attaches at the current values
        (latest-wins: still zero deliveries lost)."""
        if self.server is not None:
            self.server.close()
            self.server = None
        conns = set()
        for peers in self.conns_by_key.values():
            conns.update(peers)
        conns.update(self.pending_conns.values())
        drained = 0
        for conn in conns:
            token = conn.prefix[4:-1].decode("latin-1")
            try:
                if conn.open:
                    hint = json.dumps({
                        "key": "$edge/drain", "ver": 0,
                        "value": {"resume": token},
                        "cause": f"drain:worker-{self.index}",
                    }).encode()
                    conn.writer.write(
                        conn.prefix + b"event: reconnect\ndata: " + hint
                        + b"\n\n"
                    )
                    drained += 1
                else:
                    # mid-attach (headers not yet written): answer the
                    # unified 503 shape instead of a status-less closed
                    # socket; NOT counted as drained — it never streamed
                    conn.writer.write(_DRAIN_503)
                conn.writer.close()  # graceful: flushes the hint; the
                # handler's finally parks versions + pairs the D
            except Exception:  # noqa: BLE001 — a dying peer mid-drain
                pass
        self.send_json("R", {"seq": req.get("seq", 0),
                             "worker": self.index, "drained": drained})

    # ---------------------------------------------------------- real SSE
    async def on_listen(self, req: dict) -> None:
        try:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            sock.bind((req.get("host", "127.0.0.1"), int(req.get("port", 0))))
            sock.listen(128)
            self.heartbeat_interval = float(req.get("heartbeat", 15.0))
            self.resume_ttl = float(req.get("resume_ttl", 60.0))
            self.server = await asyncio.start_server(self._handle_conn, sock=sock)
            self.send_json("P", {"port": sock.getsockname()[1]})
        except Exception as e:  # noqa: BLE001 — report, don't die
            self.send_json("P", {"error": f"{type(e).__name__}: {e}"})

    def on_subscribe_ack(self, ack: dict) -> None:
        conn_id = ack.get("conn")
        fut = self.pending_subscribes.pop(conn_id, None)
        if "error" not in ack:
            # register in the CONTROL LOOP, synchronously: any frame the
            # parent fanned right after the ack (possibly in the same
            # coalesced pipe write) must find the conn and backlog, not
            # vanish before the handler task resumes
            conn = self.pending_conns.get(conn_id)
            if conn is not None:
                conn.key_ids = [k["id"] for k in ack.get("keys", [])]
                for kid in conn.key_ids:
                    self.conns_by_key.setdefault(kid, set()).add(conn)
        if fut is not None and not fut.done():
            fut.set_result(ack)

    async def _handle_conn(self, reader, writer) -> None:
        """REUSEPORT-plane entry: read the head here, then serve. (The
        send_fds plane arrives through ``_handle_handoff`` with the head
        the PARENT already read off the socket.)"""
        try:
            request = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), 30.0
            )
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionResetError, asyncio.LimitOverrunError):
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass
            return
        await self._serve_conn(reader, writer, request)

    def _sweep_parked(self) -> None:
        now = time.monotonic()
        expired = [t for t, (_v, dl) in self.parked.items() if dl < now]
        for t in expired:
            self.parked.pop(t, None)

    async def _serve_conn(self, reader, writer, request: bytes) -> None:
        conn_id = self.conn_seq = self.conn_seq + 1
        self.connections += 1
        conn = None
        sent_u = False
        token = None
        try:
            line = request.split(b"\r\n", 1)[0].decode("latin-1")
            parts = line.split(" ")
            if len(parts) < 2 or parts[0] != "GET":
                writer.write(b"HTTP/1.1 405 Method Not Allowed\r\n\r\n")
                return
            target = parts[1]
            path, _, query = target.partition("?")
            if path != "/edge/sse":
                writer.write(b"HTTP/1.1 404 Not Found\r\n\r\n")
                return
            keys_raw = ""
            resume_token = None
            tenant = ""
            for pair in query.split("&"):
                k, _, v = pair.partition("=")
                if k == "keys":
                    from urllib.parse import unquote

                    keys_raw = unquote(v)
                elif k == "resume" and v:
                    from urllib.parse import unquote

                    resume_token = unquote(v)
                elif k == "tenant" and v:
                    from urllib.parse import unquote

                    tenant = unquote(v)
            if not tenant:
                for hline in request.split(b"\r\n")[1:]:
                    if hline.lower().startswith(b"x-tenant:"):
                        tenant = (
                            hline.split(b":", 1)[1].strip().decode("latin-1")
                        )
                        break
            if resume_token is None:
                # the browser's own reconnect handle (EventSource re-sends
                # the original URL + this header)
                for hline in request.split(b"\r\n")[1:]:
                    if hline.lower().startswith(b"last-event-id:"):
                        resume_token = (
                            hline.split(b":", 1)[1].strip().decode("latin-1")
                        )
                        break
            try:
                specs = json.loads(keys_raw) if keys_raw else []
                assert isinstance(specs, list) and specs
            except Exception:  # noqa: BLE001
                writer.write(
                    b"HTTP/1.1 400 Bad Request\r\n\r\n"
                )
                return
            # resume: a token this worker parked replays only what the
            # session missed, and the session keeps its identity. Under
            # the send_fds plane the PARENT routed the token here, so a
            # reconnect through any port finds its park; a miss (expired,
            # reuseport cross-worker hash) is the documented fresh-attach
            # fallback.
            self._sweep_parked()
            parked_versions: Optional[Dict[int, int]] = None
            if resume_token is not None:
                entry = self.parked.pop(resume_token, None)
                if entry is not None and entry[1] >= time.monotonic():
                    parked_versions = entry[0]
                    token = resume_token
                    self.resumes += 1
            if token is None:
                token = f"es-w{self.index}-c{conn_id}"
            conn = _SseConn(self, conn_id, token, [], writer)
            if parked_versions:
                conn.versions.update(parked_versions)
            self.pending_conns[conn_id] = conn
            fut = asyncio.get_event_loop().create_future()
            self.pending_subscribes[conn_id] = fut
            self.send_json("U", {
                "conn": conn_id, "keys": specs, "tenant": tenant,
                # resumed sessions replay — the parent exempts them from
                # the subscribe-rate debit (they mint no new state)
                "resumed": parked_versions is not None,
            })
            sent_u = True
            ack = await asyncio.wait_for(fut, 30.0)
            if "error" in ack:
                # the parent's verdict names the status: bad input stays
                # 400, an admission shed answers the unified 503 shape
                # (Retry-After + Connection: close) — a rate-limited
                # client must not be told its request was malformed
                status = int(ack.get("status", 400))
                status_line = (
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    if status == 503
                    else b"HTTP/1.1 400 Bad Request\r\n"
                )
                body = json.dumps({"error": ack["error"]}).encode()
                head = (
                    status_line
                    + b"Content-Type: application/json\r\nContent-Length: "
                    + str(len(body)).encode()
                    + b"\r\nConnection: close"
                )
                retry = ack.get("retry_after")
                if status == 503 and isinstance(retry, (int, float)):
                    head += (
                        b"\r\nRetry-After: "
                        + str(max(1, min(3600, int(retry + 1)))).encode()
                    )
                writer.write(head + b"\r\n\r\n" + body)
                return
            writer.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n"
            )
            hello = json.dumps(
                {"token": token, "keys": [k["key"] for k in ack["keys"]],
                 "worker": self.index,
                 "resumed": parked_versions is not None}
            )
            writer.write(
                f"id: {token}\nevent: hello\ndata: {hello}\n\n".encode()
            )
            replayed: Dict[int, int] = dict(conn.versions)
            for rep in ack.get("replay", []):
                kid = rep["id"]
                ver = rep.get("ver", 0)
                if parked_versions is not None and ver <= conn.versions.get(kid, 0):
                    # the session already saw this version before its
                    # disconnect: latest-wins resume ships nothing
                    replayed[kid] = max(replayed.get(kid, 0), ver)
                    continue
                tail = (b"event: update\ndata: "
                        + base64.b64decode(rep["body"]) + b"\n\n")
                conn.write_frame(tail)
                conn.versions[kid] = ver
                replayed[kid] = max(replayed.get(kid, 0), ver)
                self.deliveries += 1
            # open the stream: ship backlogged frames that raced in
            # between the ack and now, skipping versions the replay
            # already covered (the control loop registered the conn at
            # ack time so nothing was dropped)
            conn.open_stream(replayed)
            hb = asyncio.get_event_loop().create_task(self._heartbeat(conn))
            try:
                while await reader.read(4096):
                    pass  # inbound ignored; the stream is one-way
            finally:
                hb.cancel()
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionResetError, asyncio.LimitOverrunError):
            pass
        except Exception:  # noqa: BLE001 — one bad conn never kills the worker
            pass
        finally:
            self.connections -= 1
            self.pending_conns.pop(conn_id, None)
            self.pending_subscribes.pop(conn_id, None)
            if conn is not None:
                for kid in conn.key_ids:
                    peers = self.conns_by_key.get(kid)
                    if peers is not None:
                        peers.discard(conn)
                        if not peers:
                            self.conns_by_key.pop(kid, None)
                if token is not None:
                    # park the delivered-version map under the token: the
                    # resume replay source (portable across the pool under
                    # the send_fds plane — the parent routes it back here)
                    self.parked[token] = (
                        dict(conn.versions),
                        time.monotonic() + self.resume_ttl,
                    )
            if sent_u:
                # ALWAYS pair the U with a D once sent — even on an ack
                # timeout where the parent may have acquired the pins
                # after we stopped waiting (an unpaired U leaks the
                # upstream pins until pool.stop())
                self.send_json(
                    "D",
                    {"conn": conn_id,
                     "key_ids": conn.key_ids if conn is not None else [],
                     # the parked token: the parent's accept plane grants
                     # the reserved resume lane only to tokens it SAW
                     # parked (a forged token rides the cold lane)
                     "token": token if conn is not None else None},
                )
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _heartbeat(self, conn: "_SseConn") -> None:
        try:
            while True:
                await asyncio.sleep(self.heartbeat_interval)
                conn.writer.write(b": hb\n\n")
        except (asyncio.CancelledError, ConnectionResetError):
            pass


class _SseConn:
    __slots__ = ("worker", "conn_id", "prefix", "key_ids", "writer",
                 "open", "backlog", "versions")

    def __init__(self, worker, conn_id, token, key_ids, writer):
        self.worker = worker
        self.conn_id = conn_id
        self.prefix = f"id: {token}\n".encode()
        self.key_ids = key_ids
        self.writer = writer
        #: False until the handler wrote headers + hello + replay: frames
        #: arriving meanwhile (registered by the control loop at ack
        #: time) buffer in ``backlog`` instead of corrupting the HTTP
        #: preamble or being dropped
        self.open = False
        self.backlog: List[tuple] = []
        #: kid -> highest version this peer was sent — parked under the
        #: resume token at disconnect (the resume replay gate)
        self.versions: Dict[int, int] = {}

    def deliver(self, kid: int, version: int, tail: bytes) -> bool:
        if not self.open:
            self.backlog.append((kid, version, tail))
            return True
        if self.write_frame(tail):
            self.versions[kid] = version
            return True
        return False

    def open_stream(self, replayed: Dict[int, int]) -> None:
        backlog, self.backlog = self.backlog, []
        self.open = True
        for kid, version, tail in backlog:
            if version > replayed.get(kid, 0):
                if self.write_frame(tail):
                    self.versions[kid] = version

    def write_frame(self, tail: bytes) -> bool:
        """Write one shared-tail frame with this conn's envelope; False
        when the peer stopped draining (evict)."""
        transport = self.writer.transport
        if transport is None or transport.is_closing():
            return False
        if transport.get_write_buffer_size() > self.worker.max_buffer:
            return False  # slow consumer: the caller aborts us
        self.writer.write(self.prefix + tail)
        return True

    def abort(self) -> None:
        transport = self.writer.transport
        if transport is not None:
            transport.abort()


def _worker_entry(argv: List[str]) -> None:
    index = int(argv[0])
    fd = int(argv[1])
    fd_channel = int(argv[2]) if len(argv) > 2 else None
    asyncio.run(_WorkerMain(index, fd, fd_channel).run())


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "--worker":
        _worker_entry(sys.argv[2:])
    else:
        sys.exit("usage: worker_pool.py --worker <index> <fd> [<fd-channel>]")
