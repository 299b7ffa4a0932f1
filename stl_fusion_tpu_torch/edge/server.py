"""Edge transports: SSE over stdlib asyncio + optional WebSocket.

The browser-facing surface of the edge tier: an
:class:`EdgeHttpServer` serves ``text/event-stream`` live queries against
an :class:`~.gateway.EdgeNode` with zero dependencies beyond the standard
library (the same asyncio-streams shape as ``rpc/http_gateway.py``), and
:class:`EdgeWebSocketServer` serves the same sessions over WebSocket when
the optional ``websockets`` package is installed (gated exactly like
``ui/web.py`` — environments without it still get SSE).

Protocol (SSE):

    GET /edge/sse?keys=<urlencoded JSON [[method, arg...], ...]>
    GET /edge/sse?resume=<token>          (or the Last-Event-ID header)

Every event carries the session's RESUME TOKEN as its SSE ``id`` — so the
browser's own ``Last-Event-ID`` reconnect header IS the resume handle
(EventSource does this without any client code). Event stream:

    event: hello            data: {"token": ..., "keys": [...]}
    event: update           data: {"key", "ver", "value", "cause", "t0"}
    : hb                    (comment heartbeat every heartbeat_interval)

``ver`` is the key's monotonic version; ``cause``/``t0`` are the upstream
fence's identity and wave-apply timestamp (the explain()/delivery-
histogram hop propagation). A reconnect with a token replays exactly the
keys whose current version is newer than the last the session saw.

Observability routes (loopback-only, matching the gateway's trust
default): ``GET /metrics`` (Prometheus exposition of the process
registry — ``fusion_edge_*`` included) and ``GET /edge/stats`` (the
node's snapshot). A slow consumer — a peer that stops reading while the
transport buffer is full — is EVICTED after ``send_timeout`` and handed
its resume token in the close; siblings never notice.
"""
from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse
from typing import Optional

from ..utils.async_utils import TaskSet
from .admission import LANE_RESUME, AdmissionRejected, rejection_bytes
from .gateway import EdgeNode
from .session import KeyedMailbox, frame_to_dict, pump_payloads

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["EdgeHttpServer", "EdgeWebSocketServer"]


def _validate_keys(specs):
    """Wire key-spec shape check shared by BOTH transports: a list of
    non-empty ``[method, arg...]`` arrays. A flat ``["node"]`` must fail
    loudly here — ``tuple("node")`` would silently become the garbage
    method ``'n'``."""
    if not isinstance(specs, list):
        raise ValueError("keys must be a JSON array of [method, arg...] arrays")
    out = []
    for spec in specs:
        if not isinstance(spec, list) or not spec:
            raise ValueError(f"bad key spec {spec!r} (want [method, arg...])")
        out.append(tuple(spec))
    return out


def _parse_keys(raw: Optional[str]):
    if not raw:
        return []
    return _validate_keys(json.loads(raw))


class EdgeHttpServer:
    """SSE live queries for one :class:`EdgeNode` (stdlib-only)."""

    def __init__(
        self,
        node: EdgeNode,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_interval: float = 15.0,
        send_timeout: Optional[float] = 10.0,
        min_send_interval: float = 0.0,
    ):
        self.node = node
        self.host = host
        self.port = port
        self.heartbeat_interval = heartbeat_interval
        self.send_timeout = send_timeout
        self.min_send_interval = min_send_interval
        self.connections = 0
        #: live per-connection pump tasks: stop() cancels them so shutdown
        #: never hangs behind a healthy long-lived stream (Python ≥3.12
        #: wait_closed() waits for connection handlers)
        self._pumps: set = set()
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "EdgeHttpServer":
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def drain(self) -> None:
        """Hand the listen port off (rolling deploy): stop
        ACCEPTING — the successor process can bind — while live streams
        stay up until ``node.drain()`` hints them to reconnect. Call this
        first, then ``await node.drain()``, then :meth:`stop`."""
        if self._server is not None:
            self._server.close()  # idempotent; stop() finishes the teardown

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for task in list(self._pumps):
                task.cancel()
            if self._pumps:
                await asyncio.gather(*self._pumps, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None

    # ------------------------------------------------------------------ http
    @staticmethod
    async def _write_json(writer, status: str, payload) -> None:
        from ..rpc.http_gateway import FusionHttpServer

        await FusionHttpServer._write_json(writer, status, payload)

    async def _reject(
        self, writer, status: str, payload: dict, reason: str,
        retry_after=None, count: bool = True, note: bool = True,
    ) -> None:
        """The unified COUNTED rejection responder:
        admission 503s, key-allowlist/bad-spec 400s, replay-evicted 409s
        and expired-resume 410s all ride one path — correct Retry-After +
        ``Connection: close`` headers, one ``fusion_edge_shed_total``
        count per response, one journal note. ``count=False`` for
        rejections the admission controller already counted (admit()
        moved the per-reason counter; double counting would make the shed
        totals lie); ``note=False`` when the raiser already journaled
        too (EdgeNode's draining shed)."""
        node = self.node
        if count:
            node.count_shed(reason)
        elif note:
            node._note_shed_event(reason)
        writer.write(rejection_bytes(status, payload, retry_after))
        try:
            await writer.drain()
        except (ConnectionError, OSError):
            pass  # the peer is already gone; the count stands

    async def _reject_admission(self, writer, decision, note=True) -> None:
        await self._reject(
            writer, "503 Service Unavailable",
            {"error": {
                "type": "AdmissionRejected",
                "reason": decision.reason,
                "retry_after": decision.retry_after,
            }},
            reason=decision.reason,
            retry_after=decision.retry_after,
            count=False,  # the controller/node already counted this shed
            note=note,
        )

    @staticmethod
    def _is_loopback(writer) -> bool:
        from ..rpc.http_gateway import _normalize_ip

        peer = writer.get_extra_info("peername")
        return bool(peer) and _normalize_ip(peer[0]) in ("127.0.0.1", "::1")

    async def _handle(self, reader, writer) -> None:
        from ..rpc.http_gateway import read_request_head

        try:
            method, target, headers = await read_request_head(reader)
            if method is None:
                return
            parsed = urllib.parse.urlsplit(target)
            path = parsed.path
            query = urllib.parse.parse_qs(parsed.query)
            if method != "GET":
                await self._write_json(
                    writer, "405 Method Not Allowed",
                    {"error": {"type": "MethodNotAllowed", "message": method}},
                )
                return
            if path == "/edge/sse":
                await self._serve_sse(reader, writer, query, headers)
                return
            if path == "/metrics" and self._is_loopback(writer):
                from ..rpc.http_gateway import write_metrics_response

                await write_metrics_response(writer)
                return
            if path == "/edge/stats" and self._is_loopback(writer):
                pool = self.node.worker_pool
                if pool is not None:
                    # refresh the per-worker stats the snapshot embeds
                    # (each worker replies over its control channel)
                    try:
                        await pool.stats()
                    except Exception:  # noqa: BLE001 — stats are best-effort
                        log.exception("edge worker pool stats failed")
                await self._write_json(writer, "200 OK", self.node.snapshot())
                return
            await self._write_json(
                writer, "404 Not Found",
                {"error": {"type": "NotFound", "message": path}},
            )
        except Exception:  # noqa: BLE001 — one bad request never kills the server
            log.exception("edge http request failed")
        finally:
            writer.close()

    # ------------------------------------------------------------------ sse
    async def _serve_sse(self, reader, writer, query, headers) -> None:
        node = self.node
        token = (
            query.get("resume", [None])[0]
            or headers.get("last-event-id")
            or None
        )
        try:
            keys = _parse_keys(query.get("keys", [None])[0])
        except (ValueError, TypeError) as e:
            await self._reject(
                writer, "400 Bad Request",
                {"error": {"type": "BadRequest", "message": str(e)}},
                reason="bad_request",
            )
            return
        # -- admission: admit or shed BEFORE any session/
        # upstream state exists. Tenant rides the request head (?tenant=
        # or X-Tenant), resolved through the controller's TenantResolver;
        # reconnects ride the reserved resume lane. The gate slot is HELD
        # across attach + replay (the expensive setup), released when the
        # stream starts.
        admission = node.admission
        tenant_id = (
            query.get("tenant", [None])[0] or headers.get("x-tenant") or ""
        )
        decision = None
        if admission is not None:
            # the reserved resume lane (and its global bucket) only for a
            # token this node actually PARKED: a forged/expired
            # ?resume=<garbage> is a cold attach — granting the lane on
            # the token's mere presence would let a flood of garbage
            # tokens bypass the per-tenant buckets AND starve the resume
            # bucket genuine post-deploy reconnects depend on
            decision = admission.admit(
                tenant_id=tenant_id,
                lane=LANE_RESUME if (token and token in node._parked) else None,
                keys=len(keys),
                hold=True,
            )
            if not decision.admitted:
                await self._reject_admission(writer, decision)
                return
        mailbox = KeyedMailbox(max_pending=node.max_pending)
        session = None
        try:
            if token:
                try:
                    session = node.resume(
                        token, mailbox=mailbox, admitted=decision
                    )
                except KeyError:
                    session = None  # expired: fresh attach below
                    if admission is not None and decision.lane == LANE_RESUME:
                        # admitted on the RESERVED resume lane but the
                        # park vanished between the admit and the resume
                        # (expired/raced): this is a COLD attach now —
                        # re-admit on the cold lane so the request pays
                        # the per-tenant buckets/pressure/ceiling like
                        # any other (a cold-lane admission stands as-is)
                        admission.release(decision)
                        decision = admission.admit(
                            tenant_id=tenant_id, lane=None,
                            keys=len(keys), hold=True,
                        )
                        if not decision.admitted:
                            await self._reject_admission(writer, decision)
                            return
            if session is None:
                if not keys:
                    await self._reject(
                        writer, "410 Gone",
                        {"error": {
                            "type": "ResumeExpired",
                            "message": "token unknown/expired and no keys= given",
                        }},
                        reason="resume_expired",
                    )
                    return
                try:
                    session = node.attach(keys, mailbox=mailbox, admitted=decision)
                except (ValueError, TypeError) as e:
                    # allowlist rejection / per-session key cap / bad specs —
                    # the CLIENT's bad input, answered, never a dropped socket
                    await self._reject(
                        writer, "400 Bad Request",
                        {"error": {"type": "BadRequest", "message": str(e)}},
                        reason="bad_request",
                    )
                    return
            if session.evicted:
                # the attach/resume REPLAY itself evicted the session (mailbox
                # bound smaller than the key set): answer loudly — streaming
                # would be exactly the silent heartbeat-alive dead
                # subscription the eviction hook exists to prevent
                await self._reject(
                    writer, "409 Conflict",
                    {"error": {
                        "type": "Evicted",
                        "message": "replay overflowed the session outbox "
                                   "(more keys than max_pending?)",
                        "resume": session.token,
                    }},
                    reason="replay_evicted",
                )
                return
        except AdmissionRejected as e:
            # the NODE refused (a draining edge — with or without a
            # controller installed): answered 503 + Retry-After, counted
            # by the raiser, never a dropped socket
            await self._reject_admission(writer, e.decision, note=False)
            return
        finally:
            # the gate covers head-read -> attach -> replay; streaming is
            # bounded by the session machinery itself
            if admission is not None:
                admission.release(decision)
        self.connections += 1
        sid = session.token
        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n"
        )
        hello = json.dumps({"token": sid, "keys": list(session.keys)})
        writer.write(f"id: {sid}\nevent: hello\ndata: {hello}\n\n".encode())
        #: per-session envelope — the ONLY per-session bytes on the hot
        #: path; the event body is the node's shared serialize-once cache
        id_prefix = f"id: {sid}\n".encode()

        async def send(batch) -> None:
            writer.write(
                b"".join(
                    node.encode_frame(frame).sse_event(id_prefix)
                    for frame in batch
                )
            )
            await writer.drain()
            # delivered: advance the resume map + the fence→visible samples
            session.mark_delivered(batch)
            for frame in batch:
                node.record_delivery(frame)

        async def heartbeat() -> None:
            writer.write(b": hb\n\n")
            await writer.drain()

        pump_task = asyncio.ensure_future(
            pump_payloads(
                mailbox,
                send,
                min_send_interval=self.min_send_interval,
                send_timeout=self.send_timeout,
                heartbeat_interval=self.heartbeat_interval,
                heartbeat=heartbeat,
                on_evict=lambda: node.evict(session, reason="sse send timeout"),
            )
        )

        def shutdown_transport() -> None:
            # runs from EdgeNode.evict (any eviction path — send timeout,
            # mailbox overflow, broken sink): the peer must see the stream
            # DIE so its reconnect logic engages, never a silent
            # heartbeat-alive stream that stopped updating
            transport = writer.transport
            if transport is not None:
                transport.abort()
            if not pump_task.done():
                pump_task.cancel()

        def drain_hint(frame) -> None:
            # EdgeNode.drain(): write the reconnect hint — the resume
            # token rides the data payload AND the id line — then wind
            # the pump down; the handler's normal teardown CLOSES (not
            # aborts) the stream so the hint reaches the peer
            try:
                payload = json.dumps(
                    frame_to_dict(frame), separators=(",", ":")
                )
                writer.write(
                    f"id: {sid}\nevent: reconnect\ndata: {payload}\n\n".encode()
                )
            except Exception:  # noqa: BLE001 — a dying peer mid-drain
                pass
            if not pump_task.done():
                pump_task.cancel()

        session.on_evicted = shutdown_transport
        session.on_drain = drain_hint
        self._pumps.add(pump_task)
        try:
            outcome = await pump_task
            if outcome == "closed":
                # normal disconnect: park for resume_ttl so the browser's
                # Last-Event-ID reconnect picks up where it left off
                node.detach(session, park=True)
        except asyncio.CancelledError:
            if not session.evicted:
                # cancelled from OUTSIDE (server stop, handler teardown):
                # park so the client can resume against a restarted server
                node.detach(session, park=True)
                raise
            # eviction-driven cancel: the session is already parked
        finally:
            self._pumps.discard(pump_task)
            self.connections -= 1


class EdgeWebSocketServer:
    """The same sessions over WebSocket (optional ``websockets`` dep,
    gated like ``ui/web.py``). Protocol: the client's FIRST message is
    ``{"keys": [[method, arg...], ...]}`` or ``{"resume": token}``; the
    server replies ``{"hello": {"token", "keys"}}`` and then streams
    ``{"frames": [frame...]}`` batches (latest-wins per key between
    sends) and ``{"ping": t}`` heartbeats."""

    def __init__(
        self,
        node: EdgeNode,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_interval: float = 15.0,
        send_timeout: Optional[float] = 10.0,
        min_send_interval: float = 0.0,
    ):
        self.node = node
        self.host = host
        self.port = port
        self.heartbeat_interval = heartbeat_interval
        self.send_timeout = send_timeout
        self.min_send_interval = min_send_interval
        self.connections = 0
        self._server = None
        #: drain-hint send/close side tasks — owned so stop() can cancel a
        #: hint still in flight instead of leaking it (fusionlint FL003)
        self._side_tasks = TaskSet(name="edge-ws-side")

    async def start(self) -> "EdgeWebSocketServer":
        try:
            from websockets.asyncio.server import serve
        except ImportError as e:  # pragma: no cover — optional dependency
            raise RuntimeError(
                "EdgeWebSocketServer needs the optional 'websockets' package; "
                "the SSE transport (EdgeHttpServer) is dependency-free"
            ) from e
        self._server = await serve(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def url(self) -> str:
        return f"ws://{self.host}:{self.port}/edge/ws"

    async def drain(self) -> None:
        """Stop accepting (the SSE twin's rolling-deploy contract): live
        WS streams stay up until ``node.drain()`` hints them. Unlike
        asyncio's plain ``Server.close()``, the websockets server's
        default also closes every OPEN connection — which would kill the
        streams BEFORE the reconnect hints could reach them — so the
        listener alone is closed here."""
        if self._server is not None:
            try:
                self._server.close(close_connections=False)
            except TypeError:  # older websockets: no kwarg; stop() will
                self._server.close()  # close everything at teardown anyway

    async def stop(self) -> None:
        await self._side_tasks.aclose()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, ws) -> None:
        node = self.node
        loop = asyncio.get_running_loop()
        try:
            raw = await ws.recv()
        except Exception:  # noqa: BLE001 — the peer left before a hello
            # (health probes, stray disconnects): a normal exit, NOT a
            # shed — counting it would pollute bad_request on a healthy
            # node and make the counters untrustworthy
            return
        try:
            first = json.loads(raw)
            if not isinstance(first, dict):
                raise ValueError("hello must be a JSON object")
        except Exception as e:  # noqa: BLE001 — bad hello: answer, close
            node.count_shed("bad_request")
            try:
                await ws.send(json.dumps({"error": f"bad hello: {e}"}))
            except Exception:  # noqa: BLE001 — peer already gone
                pass
            await ws.close()
            return
        token = first.get("resume")
        # -- admission: the WS twin of the SSE path — tenant
        # rides the hello ({"tenant": ...}), reconnects the resume lane; a
        # shed answers a CLEAN error frame + close 1013 (Try Again Later),
        # never a dropped socket
        async def reject_ws(decision) -> None:
            # the WS twin of _reject_admission: ONE clean error frame +
            # close 1013 (Try Again Later) — every WS shed rides it
            try:
                await ws.send(json.dumps({
                    "error": "admission rejected",
                    "reason": decision.reason,
                    "retry_after": decision.retry_after,
                }))
            finally:
                await ws.close(code=1013)

        admission = node.admission
        decision = None
        if admission is not None:
            raw_keys = first.get("keys")
            # resume lane only for a token this node PARKED (the SSE rule)
            decision = admission.admit(
                tenant_id=first.get("tenant") or "",
                lane=LANE_RESUME if (token and token in node._parked) else None,
                keys=len(raw_keys) if isinstance(raw_keys, list) else 0,
                hold=True,
            )
            if not decision.admitted:
                node._note_shed_event(decision.reason, lane=decision.lane)
                await reject_ws(decision)
                return
        mailbox = KeyedMailbox(max_pending=node.max_pending)
        session = None
        try:
            if token:
                try:
                    session = node.resume(
                        token, mailbox=mailbox, admitted=decision
                    )
                except KeyError:
                    session = None
                    if admission is not None and decision.lane == LANE_RESUME:
                        # resume-lane admission whose park vanished (the
                        # SSE twin's rule): re-admit as the cold attach
                        # it now is; a cold-lane admission stands as-is
                        admission.release(decision)
                        raw_keys = first.get("keys")
                        decision = admission.admit(
                            tenant_id=first.get("tenant") or "",
                            lane=None,
                            keys=len(raw_keys)
                            if isinstance(raw_keys, list) else 0,
                            hold=True,
                        )
                        if not decision.admitted:
                            node._note_shed_event(
                                decision.reason, lane=decision.lane
                            )
                            await reject_ws(decision)
                            return
            if session is None:
                try:
                    keys = _validate_keys(first.get("keys", []))
                    if not keys:
                        raise ValueError("no keys and no valid resume token")
                    session = node.attach(keys, mailbox=mailbox, admitted=decision)
                except (ValueError, TypeError) as e:
                    node.count_shed("bad_request")
                    await ws.send(json.dumps({"error": str(e)}))
                    await ws.close()
                    return
            if session.evicted:  # replay overflow: same contract as SSE's 409
                node.count_shed("replay_evicted")
                await ws.send(
                    json.dumps({"error": "replay overflowed the session outbox",
                                "resume": session.token})
                )
                await ws.close()
                return
        except AdmissionRejected as e:
            # the NODE refused (a draining edge): a clean answered close,
            # counted by the raiser
            await reject_ws(e.decision)
            return
        finally:
            if admission is not None:
                admission.release(decision)
        async def send(batch) -> None:
            # the frame bodies are the node's shared serialize-once cache
            # (decoded to str at most once per (key, version)); only the
            # tiny batch envelope is assembled per send
            await ws.send(
                '{"frames":['
                + ",".join(node.encode_frame(f).text for f in batch)
                + "]}"
            )
            session.mark_delivered(batch)
            for frame in batch:
                node.record_delivery(frame)

        async def heartbeat() -> None:
            await ws.send(json.dumps({"ping": loop.time()}))

        pump_task = asyncio.ensure_future(
            pump_payloads(
                mailbox,
                send,
                min_send_interval=self.min_send_interval,
                send_timeout=self.send_timeout,
                heartbeat_interval=self.heartbeat_interval,
                heartbeat=heartbeat,
                on_evict=lambda: node.evict(session, reason="ws send timeout"),
            )
        )

        def shutdown_transport() -> None:
            # any eviction path (send timeout, overflow, broken sink) must
            # kill the socket so the peer's reconnect logic engages
            transport = getattr(ws, "transport", None)
            if transport is not None:
                transport.abort()
            if not pump_task.done():
                pump_task.cancel()

        def drain_hint(frame) -> None:
            # EdgeNode.drain(): send the reconnect hint as its own frame,
            # then close 1001 (Going Away) — the peer reconnects with the
            # carried resume token; never an abort (the hint must arrive)
            async def _send_and_close() -> None:
                try:
                    await ws.send(
                        json.dumps({"reconnect": frame_to_dict(frame)})
                    )
                finally:
                    await ws.close(code=1001)

            try:
                self._side_tasks.spawn(_send_and_close())
            except RuntimeError:  # server already stopped: nothing to hint
                pass
            if not pump_task.done():
                pump_task.cancel()

        session.on_evicted = shutdown_transport
        session.on_drain = drain_hint
        self.connections += 1
        # EVERY await from here on sits under the finally: a peer that
        # drops right after subscribing (the hello send raising) must
        # still detach — a ghost session would be fanned to forever and
        # pin its subs
        try:
            await ws.send(
                json.dumps(
                    {"hello": {"token": session.token, "keys": list(session.keys)}}
                )
            )
            async for _raw in ws:  # inbound ignored; the stream is one-way
                pass
        except Exception:  # noqa: BLE001 — a dying socket is a normal exit
            pass
        finally:
            self.connections -= 1
            pump_task.cancel()
            if not session.evicted:  # evict() already parked it otherwise
                node.detach(session, park=True)
