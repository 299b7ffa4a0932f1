"""Testing utilities — the analogue of src/Stl.Testing/.

The reference ships a test toolkit its own suites build on: ``TestWebHost``
(in-proc Kestrel host wiring server+client DI containers,
Testing/TestWebHost.cs), ``TestClock`` (Time/Testing/), build-agent
detection (TestRunnerInfo.cs), and jittered time helpers
(src/Stl/Time/RandomTimeSpan.cs). This module re-expresses them for the
port: a :class:`TestWebHost` that composes a full in-process fusion
stack (FusionHub + RpcHub + real websocket server) and hands out connected
invalidation-aware clients, plus the small time/env helpers.

The in-memory channel-pair transport (``rpc.testing.RpcTestTransport``) and
``TestClock`` re-export here so one import serves a test module.
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..client import compute_client, install_compute_call_type
from ..core.hub import FusionHub
from ..rpc.hub import RpcHub
from ..rpc.testing import RpcTestTransport
from ..utils.moment import TestClock

__all__ = [
    "TestWebHost",
    "RandomTimeSpan",
    "RpcTestTransport",
    "TestClock",
    "is_build_agent",
]


@dataclass(frozen=True)
class RandomTimeSpan:
    """Jittered duration: ``origin ± max_delta`` seconds, uniformly
    (src/Stl/Time/RandomTimeSpan.cs — used for staggered worker start
    delays so multi-host workers don't thundering-herd the op log)."""

    origin: float
    max_delta: float = 0.0

    def next(self, rng: Optional[random.Random] = None) -> float:
        if self.max_delta <= 0:
            return self.origin
        r = (rng or random).uniform(-self.max_delta, self.max_delta)
        return max(0.0, self.origin + r)

    @property
    def min(self) -> float:
        return max(0.0, self.origin - self.max_delta)

    @property
    def max(self) -> float:
        return self.origin + self.max_delta


def is_build_agent() -> bool:
    """CI detection (≈ TestRunnerInfo.IsBuildAgent) — suites relax
    timing-sensitive assertions on shared runners."""
    return any(os.environ.get(k) for k in ("CI", "GITHUB_ACTIONS", "BUILD_ID", "TF_BUILD"))


class TestWebHost:
    """A full in-process fusion host over a REAL websocket listener.

    ≈ src/Stl.Testing/TestWebHost.cs + the RpcTestBase pattern
    (tests/Stl.Tests/RpcTestBase.cs:28-70): the server side gets its own
    FusionHub + RpcHub bound to an ephemeral-port websocket server; each
    ``new_client`` call builds an isolated client container (own FusionHub +
    RpcHub) connected through the socket, so tests exercise the true
    serialize → socket → deserialize → invalidation-push path.

        async with TestWebHost() as host:
            host.add_service("counters", CounterService(host.fusion))
            client = await host.new_client("counters")
            await client.get("a")

    For protocol tests that need scripted disconnects, use
    ``RpcTestTransport`` directly instead (channel pair, no sockets).
    """

    __test__ = False  # pytest: not a test class despite the Test* name

    def __init__(self, use_http_gateway: bool = False):
        self.fusion = FusionHub()
        self.rpc = RpcHub("test-server")
        install_compute_call_type(self.rpc)
        self.use_http_gateway = use_http_gateway
        self.ws_server = None
        self.http_server = None
        self._client_rpc_hubs: List[RpcHub] = []
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "TestWebHost":
        from ..rpc.websocket import RpcWebSocketServer

        self.ws_server = await RpcWebSocketServer(self.rpc).start()
        if self.use_http_gateway:
            from ..rpc.http_gateway import FusionHttpServer

            self.http_server = await FusionHttpServer(self.rpc).start()
        self._started = True
        return self

    async def stop(self) -> None:
        for hub in self._client_rpc_hubs:
            await hub.stop()
        self._client_rpc_hubs.clear()
        await self.rpc.stop()
        if self.ws_server is not None:
            await self.ws_server.stop()
        if self.http_server is not None:
            await self.http_server.stop()
        self._started = False

    async def __aenter__(self) -> "TestWebHost":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- server side -------------------------------------------------------
    def add_service(self, name: str, service: Any) -> Any:
        """Register a compute service on the host's RPC surface."""
        self.rpc.add_service(name, service)
        return service

    @property
    def url(self) -> str:
        assert self.ws_server is not None, "host not started"
        return self.ws_server.url

    @property
    def http_url(self) -> str:
        assert self.http_server is not None, "host not started with use_http_gateway"
        return self.http_server.url

    # -- client side -------------------------------------------------------
    def new_client_container(self, client_id: Optional[str] = None) -> tuple:
        """A fresh (FusionHub, RpcHub) pair wired to this host's socket —
        the separate client DI container of RpcTestBase."""
        from ..rpc.websocket import websocket_client_connector

        assert self._started, "host not started"
        client_fusion = FusionHub()
        client_rpc = RpcHub(f"test-client-{len(self._client_rpc_hubs)}")
        install_compute_call_type(client_rpc)
        client_rpc.client_connector = websocket_client_connector(self.url, client_id)
        self._client_rpc_hubs.append(client_rpc)
        return client_fusion, client_rpc

    async def new_client(self, service_name: str, cache=None, client_id: Optional[str] = None):
        """A connected invalidation-aware compute client for ``service_name``."""
        client_fusion, client_rpc = self.new_client_container(client_id)
        return compute_client(service_name, client_rpc, client_fusion, cache=cache)
