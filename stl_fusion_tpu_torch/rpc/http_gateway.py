"""HTTP/REST surface for compute services + typed REST client.

The analogue of the reference's REST story: Stl.Fusion.Server's MVC
controllers/endpoints expose compute services over plain HTTP, and
Stl.RestEase generates typed clients for them (src/Stl.RestEase/,
Fusion.Server/Endpoints/ — SURVEY §2.7, §2.8). Protocol:

    GET  /fusion/{service}/{method}?args=<json-array>   — reads
    POST /fusion/{service}/{method}   (json-array body) — commands/writes

Responses are ``{"ok": value}`` or ``{"error": {"type", "message"}}``.
Unlike the RPC/websocket channel this surface carries NO invalidation
subscription — it is the integration path for plain HTTP consumers
(curl, dashboards, other stacks), exactly the niche REST fills in the
reference. Implemented on asyncio streams (stdlib only).

Arguments and results travel in the wire-type encoding
(utils/serialization: plain JSON for plain values, ``{"$t": ...}`` for
registered types), so typed values — Sessions included — round-trip.
With a :class:`HttpSessionMiddleware` attached the gateway issues/resolves
a cookie-based Session per browser and substitutes it for the
default-session placeholder in call arguments
(≈ Fusion.Server/Middlewares/SessionMiddleware.cs +
DefaultSessionReplacerRpcMiddleware.cs).
"""
from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse
from typing import Any, Dict, Optional, Tuple

from ..utils.serialization import decode, encode

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["FusionHttpServer", "HttpSessionMiddleware", "RestClient", "RestError"]

PATH_PREFIX = "/fusion/"


def _normalize_ip(ip: str) -> str:
    """Canonical peer-address form for allowlist membership: a dual-stack
    listener reports the loopback sidecar as ``::ffff:127.0.0.1``, which
    must match a ``127.0.0.1`` allowlist entry."""
    import ipaddress

    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return ip
    mapped = getattr(addr, "ipv4_mapped", None)
    return str(mapped if mapped is not None else addr)


class HttpSessionMiddleware:
    """Cookie-based Session issue/resolve for the HTTP gateway
    (≈ SessionMiddleware.cs): a request without a valid session cookie gets
    a fresh session issued via ``Set-Cookie``; default-placeholder Session
    arguments are replaced with the cookie session before dispatch."""

    def __init__(self, cookie_name: str = "FusionSession", tenant_id: str = ""):
        from ..ext.session import Session

        self.cookie_name = cookie_name
        self.tenant_id = tenant_id
        self._session_cls = Session

    def resolve(self, cookie_header: str):
        """(session, set_cookie_value_or_None) for a request's Cookie header."""
        for part in cookie_header.split(";"):
            name, _, value = part.strip().partition("=")
            if name == self.cookie_name and value:
                try:
                    session = self._session_cls(urllib.parse.unquote(value))
                    if not session.is_default:
                        return session, None
                    # a crafted '~' cookie must not smuggle the shared
                    # placeholder identity past issuance
                except ValueError:
                    pass
                break  # malformed or placeholder id: issue a fresh one
        session = self._session_cls.new(self.tenant_id)
        cookie = (
            f"{self.cookie_name}={urllib.parse.quote(session.id, safe='')};"
            f" Path=/; HttpOnly; SameSite=Lax"
        )
        return session, cookie

    def replace_default_sessions(self, args: list, session) -> list:
        from ..ext.session import replace_default_sessions

        return replace_default_sessions(args, session, self._session_cls)


class RestError(Exception):
    def __init__(self, type_name: str, message: str):
        super().__init__(f"{type_name}: {message}")
        self.type_name = type_name


async def read_request_head(
    reader: asyncio.StreamReader,
) -> Tuple[Optional[str], Optional[str], Dict[str, str]]:
    """Parse one HTTP request line + header block into
    ``(method, target, lowercase-name headers)`` — the one parser every
    asyncio-streams server in the tree rides (this gateway and the edge
    tier's ``EdgeHttpServer``), so header handling never drifts between
    them. Returns ``(None, None, {})`` on an empty (closed) stream."""
    request_line = (await reader.readline()).decode("latin1").strip()
    if not request_line:
        return None, None, {}
    method, target, _version = request_line.split(" ", 2)
    headers: Dict[str, str] = {}
    while True:
        line = (await reader.readline()).decode("latin1").strip()
        if not line:
            break
        name, _, value = line.partition(":")
        headers[name.lower()] = value.strip()
    return method, target, headers


async def write_metrics_response(writer: asyncio.StreamWriter) -> None:
    """One Prometheus-exposition HTTP response off the process registry —
    shared by every server that mounts a ``/metrics`` route (this gateway
    and the edge tier's ``EdgeHttpServer``), so the exposition headers
    never drift between them."""
    from ..diagnostics.metrics import global_metrics

    raw = global_metrics().render_prometheus().encode()
    writer.write(
        "HTTP/1.1 200 OK\r\n"
        "Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
        f"Content-Length: {len(raw)}\r\nConnection: close\r\n\r\n".encode()
        + raw
    )
    await writer.drain()


class FusionHttpServer:
    """Serves registered services of an RpcHub (or any object registry with
    ``service_registry.invoke``) over HTTP."""

    def __init__(
        self,
        rpc_hub,
        host: str = "127.0.0.1",
        port: int = 0,
        session_middleware: Optional[HttpSessionMiddleware] = None,
    ):
        self.rpc_hub = rpc_hub
        self.host = host
        self.port = port
        self.session_middleware = session_middleware
        #: optional ext.server_auth.ServerAuthHelper: when set (requires
        #: session_middleware), every request reconciles the transport's
        #: principal (trusted proxy headers) with the fusion session's user
        #: (≈ ServerAuthHelper.UpdateAuthState called from the host filter)
        self.auth_helper = None
        #: peer IPs allowed to supply ``x-auth-request-*`` principal headers.
        #: Without this gate any client that can reach the port directly
        #: could impersonate any user (ADVICE r2). Default = loopback — the
        #: sidecar reverse-proxy deployment shape; widen explicitly for a
        #: proxy on another host, or use :attr:`proxy_shared_secret`.
        self.trusted_proxies: frozenset = frozenset({"127.0.0.1", "::1"})
        #: when set, proxy trust is decided by this shared secret instead:
        #: the proxy must stamp it in ``x-auth-request-secret`` (constant-
        #: time compared); requests without it are treated as anonymous
        self.proxy_shared_secret: Optional[str] = None
        #: path → (content_type, body): static pages served next to the
        #: JSON API (the sample-UI host path, ≈ MapBlazorHub + index.html)
        self.static_routes: dict = {}
        #: observability routes: GET /metrics — Prometheus
        #: text exposition of the process registry; GET /trace — recent
        #: tracing spans (+ the attached monitor's report, waves and
        #: delivery histogram included, when :attr:`monitor` is set;
        #: ``?section=waves|fanout|delivery|recorder|audit`` bounds the
        #: payload to one report section); GET /explain?key= — the causal
        #: chain for a key (flight recorder + wave profiler + span join,
        #: diagnostics/explain.py). Served ONLY to
        #: peers :meth:`_is_trusted_proxy` accepts (default: loopback — the
        #: sidecar scraper shape; with :attr:`proxy_shared_secret` set the
        #: scraper must send it in ``x-auth-request-secret``): span tags
        #: carry command arguments and the report names internals, so a
        #: direct remote client gets 404, never the dump. Flip off to drop
        #: the routes entirely.
        self.serve_observability: bool = True
        #: optional diagnostics.FusionMonitor whose report() /trace embeds
        self.monitor = None
        #: optional diagnostics.MeshTelemetryAggregator: when
        #: set, ``GET /metrics?scope=mesh`` answers the MERGED fleet
        #: exposition (per-host ``host="h<N>"`` labels, SUM/MAX merge,
        #: stale marking) instead of the process-local registry, and
        #: ``GET /trace?cause=<id>`` marks missing hosts PARTIAL against
        #: the aggregator's membership
        self.mesh_telemetry = None
        #: cluster control-plane parts served by GET /shards:
        #: any mix of ClusterMember / ShardMapRouter / ClusterRebalancer
        #: (anything with ``snapshot()``), merged — same trust gate as the
        #: other observability routes (topology + per-peer traffic are
        #: operator data, not public data)
        self.cluster: tuple = ()
        self._server: Optional[asyncio.AbstractServer] = None

    def _is_trusted_proxy(self, headers: dict) -> bool:
        if self.proxy_shared_secret is not None:
            import hmac

            # bytes compare: compare_digest raises on non-ASCII str, which
            # would 500 the request instead of degrading to anonymous
            return hmac.compare_digest(
                headers.get("x-auth-request-secret", "").encode("utf-8", "replace"),
                self.proxy_shared_secret.encode("utf-8", "replace"),
            )
        return _normalize_ip(headers.get("_ip", "")) in self.trusted_proxies

    async def start(self) -> "FusionHttpServer":
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    @staticmethod
    async def _write_json(writer: asyncio.StreamWriter, status: str, payload) -> None:
        """One JSON response, non-JSON-able leaves repr'd (the observability
        routes ship diagnostic dicts, where a lossy repr beats a 500)."""
        raw = json.dumps(payload, default=repr).encode()
        writer.write(
            f"HTTP/1.1 {status}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(raw)}\r\nConnection: close\r\n\r\n".encode()
            + raw
        )
        await writer.drain()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            method, target, headers = await read_request_head(reader)
            if method is None:
                return
            content_length = int(headers.get("content-length", 0))
            cookie_header = headers.get("cookie", "")
            body = await reader.readexactly(content_length) if content_length else b""
            peer = writer.get_extra_info("peername")
            headers["_ip"] = peer[0] if peer else ""
            parsed_target = urllib.parse.urlsplit(target)
            path = parsed_target.path
            observability = (
                self.serve_observability
                and method == "GET"
                and path in ("/metrics", "/trace", "/explain", "/shards",
                             "/health", "/hotkeys")
                # same trust gate as principal headers: loopback (or the
                # shared scraper secret) only — a direct remote client must
                # not read spans/reports off a port it happens to reach
                and self._is_trusted_proxy(headers)
            )
            if observability and path == "/metrics":
                scope = urllib.parse.parse_qs(parsed_target.query).get(
                    "scope", [None]
                )[0]
                if scope == "mesh":
                    # fleet scrape: the merged exposition, or an
                    # honest 503 — answering scope=mesh with LOCAL data
                    # would silently misrepresent one host as the fleet
                    if self.mesh_telemetry is None:
                        await self._write_json(
                            writer,
                            "503 Service Unavailable",
                            {
                                "error": {
                                    "type": "NoMeshTelemetry",
                                    "message": (
                                        "no MeshTelemetryAggregator attached "
                                        "to this gateway"
                                    ),
                                }
                            },
                        )
                        return
                    raw = self.mesh_telemetry.render_mesh_prometheus().encode()
                    writer.write(
                        "HTTP/1.1 200 OK\r\n"
                        "Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
                        f"Content-Length: {len(raw)}\r\nConnection: close\r\n\r\n".encode()
                        + raw
                    )
                    await writer.drain()
                    return
                await write_metrics_response(writer)
                return
            if observability and path == "/trace":
                from ..diagnostics.tracing import recent_spans

                query = urllib.parse.parse_qs(parsed_target.query)
                cause = query.get("cause", [None])[0]
                if cause:
                    # stitched cross-host wave timeline — one
                    # clock-aligned view of one wave, keyed by its cause id
                    from ..diagnostics.mesh_telemetry import global_mesh_trace

                    expected = (
                        self.mesh_telemetry.known_hosts()
                        if self.mesh_telemetry is not None
                        else None
                    )
                    stitched = global_mesh_trace().stitch(
                        cause, expected_hosts=expected
                    )
                    if stitched is None:
                        await self._write_json(
                            writer,
                            "404 Not Found",
                            {
                                "error": {
                                    "type": "UnknownCause",
                                    "message": (
                                        f"no trace segments recorded for "
                                        f"cause {cause!r}"
                                    ),
                                }
                            },
                        )
                        return
                    await self._write_json(writer, "200 OK", {"trace": stitched})
                    return
                section = query.get("section", [None])[0]
                if section:
                    # payload bound: a scraper fetches
                    # ONE report section (waves|fanout|delivery|recorder|
                    # audit|...) instead of the whole embedded report + spans
                    if self.monitor is None:
                        # every section would 400 as "unknown" here — name
                        # the REAL problem (no monitor wired) instead
                        await self._write_json(
                            writer,
                            "503 Service Unavailable",
                            {
                                "error": {
                                    "type": "NoMonitor",
                                    "message": "no FusionMonitor attached to this gateway",
                                }
                            },
                        )
                        return
                    report = self.monitor.report()
                    if section not in report:
                        # a typo'd section served as {"<typo>": null} reads
                        # as "no data recorded" — reject loudly instead
                        await self._write_json(
                            writer,
                            "400 Bad Request",
                            {
                                "error": {
                                    "type": "BadRequest",
                                    "message": (
                                        f"unknown or empty section {section!r}; "
                                        f"available: {sorted(report)}"
                                    ),
                                }
                            },
                        )
                        return
                    payload: dict = {"report": {section: report.get(section)}}
                else:
                    payload = {
                        "spans": [s.to_dict() for s in recent_spans()[-256:]],
                    }
                    if self.monitor is not None:
                        payload["report"] = self.monitor.report()
                await self._write_json(writer, "200 OK", payload)
                return
            if observability and path == "/explain":
                from ..diagnostics.explain import explain_with_fallback

                query = urllib.parse.parse_qs(parsed_target.query)
                key = query.get("key", [None])[0]
                if not key:
                    await self._write_json(
                        writer,
                        "400 Bad Request",
                        {"error": {"type": "BadRequest", "message": "key= required"}},
                    )
                    return
                try:
                    hub = self.monitor.hub if self.monitor is not None else None
                    status_line, payload = "200 OK", explain_with_fallback(key, hub=hub)
                except Exception as e:  # noqa: BLE001 — the incident-diagnosis
                    # endpoint must answer with the failure, never with a
                    # dropped connection ($sys-d's _serve_explain contract)
                    log.exception("explain(%r) failed", key)
                    status_line = "500 Internal Server Error"
                    payload = {"error": {"type": type(e).__name__, "message": str(e)}}
                await self._write_json(writer, status_line, payload)
                return
            if observability and path == "/health":
                # machine-readable SLO verdict: mesh-scope when
                # an aggregator is attached (stale hosts surface as
                # degraded entries), local-scope otherwise. Always 200 —
                # the verdict IS the answer; transport success must not be
                # conflated with fleet health.
                from ..diagnostics.slo import global_slo_engine

                try:
                    if self.mesh_telemetry is not None:
                        payload = self.mesh_telemetry.mesh_health()
                    else:
                        payload = global_slo_engine().evaluate()
                except Exception as e:  # noqa: BLE001 — a judging fault is a
                    # degraded verdict, never a dropped connection
                    log.exception("/health evaluation failed")
                    from ..diagnostics.metrics import global_metrics

                    global_metrics().counter(
                        "fusion_health_endpoint_errors_total",
                        help="/health evaluations that raised and answered "
                             "a degraded verdict instead",
                    ).inc()
                    payload = {
                        "verdict": "degraded",
                        "scope": "local",
                        "error": {"type": type(e).__name__, "message": str(e)},
                    }
                await self._write_json(writer, "200 OK", payload)
                return
            if observability and path == "/hotkeys":
                # workload attribution: top-k heavy hitters per
                # domain, mesh-merged when an aggregator is attached
                from ..diagnostics.hotkeys import global_hotkeys

                query = urllib.parse.parse_qs(parsed_target.query)
                try:
                    n = max(1, min(int(query.get("n", ["5"])[0]), 64))
                except ValueError:
                    n = 5
                domain = query.get("domain", [None])[0]
                if self.mesh_telemetry is not None:
                    payload = self.mesh_telemetry.hotkeys_report(n)
                else:
                    payload = {
                        "scope": "local",
                        "domains": global_hotkeys().report(n),
                    }
                if domain is not None:
                    domains = payload.get("domains") or {}
                    if domain not in domains:
                        await self._write_json(
                            writer,
                            "404 Not Found",
                            {
                                "error": {
                                    "type": "UnknownDomain",
                                    "message": (
                                        f"no sketch for domain {domain!r}; "
                                        f"available: {sorted(domains)}"
                                    ),
                                }
                            },
                        )
                        return
                    payload["domains"] = {domain: domains[domain]}
                await self._write_json(writer, "200 OK", payload)
                return
            if observability and path == "/shards":
                merged: dict = {}
                for part in self.cluster:
                    try:
                        merged.update(part.snapshot())
                    except Exception as e:  # noqa: BLE001 — one bad part, not a 500
                        merged.setdefault("errors", []).append(repr(e))
                if not merged:
                    await self._write_json(
                        writer,
                        "503 Service Unavailable",
                        {
                            "error": {
                                "type": "NoCluster",
                                "message": "no cluster parts attached to this gateway",
                            }
                        },
                    )
                    return
                await self._write_json(writer, "200 OK", merged)
                return
            static = self.static_routes.get(path)
            if static is not None and method == "GET":
                ctype, content = static
                raw = content.encode() if isinstance(content, str) else content
                writer.write(
                    f"HTTP/1.1 200 OK\r\nContent-Type: {ctype}\r\n"
                    f"Content-Length: {len(raw)}\r\nConnection: close\r\n\r\n".encode()
                    + raw
                )
                await writer.drain()
                return
            status, payload, extra_headers = await self._dispatch(
                method, target, body, cookie_header, headers
            )
            try:
                data = json.dumps(payload).encode()
            except (TypeError, ValueError) as e:
                # the service returned something JSON can't carry — a real
                # error response beats a silently-dropped connection
                status = "500 Internal Server Error"
                data = json.dumps(
                    {"error": {"type": "NotSerializable", "message": str(e)}}
                ).encode()
            header_block = "".join(f"{k}: {v}\r\n" for k, v in extra_headers)
            writer.write(
                f"HTTP/1.1 {status}\r\nContent-Type: application/json\r\n"
                f"{header_block}"
                f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n".encode() + data
            )
            await writer.drain()
        except Exception:  # noqa: BLE001 — one bad request never kills the server
            log.exception("http gateway request failed")
        finally:
            writer.close()

    async def _dispatch(
        self,
        http_method: str,
        target: str,
        body: bytes,
        cookie_header: str = "",
        headers: Optional[dict] = None,
    ) -> Tuple[str, Any, list]:
        parsed = urllib.parse.urlsplit(target)
        not_found = ("404 Not Found", {"error": {"type": "NotFound", "message": parsed.path}}, [])
        if not parsed.path.startswith(PATH_PREFIX):
            return not_found
        parts = parsed.path[len(PATH_PREFIX):].split("/")
        if len(parts) != 2:
            return not_found
        service, method = parts
        extra_headers: list = []
        try:
            if http_method == "GET":
                query = urllib.parse.parse_qs(parsed.query)
                raw_args = query.get("args", ["[]"])[0]
            elif http_method == "POST":
                raw_args = body.decode() or "[]"
            else:
                return "405 Method Not Allowed", {
                    "error": {"type": "MethodNotAllowed", "message": http_method}
                }, []
            try:
                args = json.loads(raw_args)
                if not isinstance(args, list):
                    raise ValueError("args must be a JSON array")
                args = [decode(a) for a in args]  # wire-typed args round-trip
            except (ValueError, TypeError, KeyError) as e:
                # TypeError: unknown "$t" wire tag; KeyError: a known tag
                # missing its payload fields — still the CLIENT's bad
                # input, not a server fault
                return "400 Bad Request", {
                    "error": {"type": "BadRequest", "message": str(e)}
                }, []
            mw = self.session_middleware
            if mw is not None:
                session, set_cookie = mw.resolve(cookie_header)
                if set_cookie is not None:
                    extra_headers.append(("Set-Cookie", set_cookie))
                args = mw.replace_default_sessions(args, session)
                if self.auth_helper is not None:
                    # ≈ ServerAuthHelper.UpdateAuthState per request: sync
                    # the transport principal into the fusion session.
                    # Principal headers are honored ONLY from a trusted
                    # proxy peer — a direct client's copies are ignored, so
                    # impersonation requires owning the proxy, not just
                    # reaching the port. Untrusted ≠ anonymous: an untrusted
                    # peer's request must not sign an existing session OUT
                    # either (that would let any direct client revoke a
                    # user's session everywhere via the replicated op log),
                    # so reconciliation is skipped and only session setup +
                    # presence run
                    from ..ext.server_auth import principal_from_headers

                    h = headers or {}
                    trusted = self._is_trusted_proxy(h)
                    await self.auth_helper.update_auth_state(
                        session,
                        principal_from_headers(h) if trusted else None,
                        ip_address=h.get("_ip", ""),
                        user_agent=h.get("user-agent", ""),
                        principal_authoritative=trusted,
                    )
            result = await self.rpc_hub.service_registry.invoke(service, method, args)
            return "200 OK", {"ok": encode(result)}, extra_headers
        except LookupError as e:
            return "404 Not Found", {
                "error": {"type": type(e).__name__, "message": str(e)}
            }, extra_headers
        except Exception as e:  # noqa: BLE001 — service errors travel as payloads
            return "500 Internal Server Error", {
                "error": {"type": type(e).__name__, "message": str(e)}
            }, extra_headers


class _RestMethod:
    def __init__(self, client: "RestClient", method: str):
        self._client = client
        self._method = method

    async def __call__(self, *args):
        return await self._client.call(self._method, list(args))

    async def post(self, *args):
        return await self._client.call(self._method, list(args), http_method="POST")


class RestClient:
    """Typed REST client for a served compute service (≈ Stl.RestEase
    clients): attribute access → GET call; ``.post`` for commands. Args and
    results use the wire-type encoding; a cookie jar carries the gateway's
    session cookie across calls (≈ a browser talking to SessionMiddleware)."""

    def __init__(self, base_url: str, service: str, headers: Optional[Dict[str, str]] = None):
        parsed = urllib.parse.urlsplit(base_url)
        self.host = parsed.hostname
        self.port = parsed.port or 80
        self.service = service
        self.cookies: Dict[str, str] = {}
        #: extra headers on every request (e.g. trusted-proxy auth headers)
        self.headers: Dict[str, str] = dict(headers or {})

    def __getattr__(self, method: str) -> _RestMethod:
        if method.startswith("_"):
            raise AttributeError(method)
        return _RestMethod(self, method)

    async def call(self, method: str, args: list, http_method: str = "GET") -> Any:
        path = f"{PATH_PREFIX}{self.service}/{method}"
        wire_args = json.dumps([encode(a) for a in args])
        body = b""
        if http_method == "GET":
            path += "?args=" + urllib.parse.quote(wire_args)
        else:
            body = wire_args.encode()
        cookie_line = (
            "Cookie: " + "; ".join(f"{k}={v}" for k, v in self.cookies.items()) + "\r\n"
            if self.cookies
            else ""
        )
        for k, v in self.headers.items():
            # CR/LF in a header would splice extra headers (or a whole
            # pipelined request) into the buffer below — reject loudly
            if "\r" in k or "\n" in k or "\r" in v or "\n" in v:
                raise ValueError(f"illegal CR/LF in header {k!r}")
        cookie_line += "".join(f"{k}: {v}\r\n" for k, v in self.headers.items())
        try:
            reader, writer = await asyncio.open_connection(self.host, self.port)
            try:
                writer.write(
                    f"{http_method} {path} HTTP/1.1\r\nHost: {self.host}\r\n"
                    f"{cookie_line}"
                    f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body
                )
                await writer.drain()
                raw = await reader.read()
            finally:
                writer.close()
        except OSError as e:
            # refused/reset/aborted — one uniform error type for callers
            raise RestError("BadResponse", f"connection failed: {e}") from None
        headers, _, payload = raw.partition(b"\r\n\r\n")
        status_line = headers.split(b"\r\n", 1)[0].decode("latin1", "replace")
        for line in headers.split(b"\r\n")[1:]:
            name, _, value = line.decode("latin1", "replace").partition(":")
            if name.lower() == "set-cookie":
                cookie = value.strip().split(";", 1)[0]
                cname, _, cvalue = cookie.partition("=")
                if cname:
                    self.cookies[cname] = cvalue
        if not payload:
            # server closed without a body (request never parsed, handler
            # crashed before write) — surface as RestError, not a JSON error
            raise RestError("BadResponse", f"empty response ({status_line or 'no status'})")
        try:
            response = json.loads(payload.decode())
        except ValueError as e:
            raise RestError("BadResponse", f"{status_line}: {e}") from None
        if "error" in response:
            raise RestError(response["error"]["type"], response["error"]["message"])
        return decode(response["ok"])
