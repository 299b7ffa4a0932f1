"""Parity of the port's RPC layer (``stl_fusion_tpu_torch/rpc``: messages,
the service registry, inbound and outbound calls, peers and their
reconnects, the hub and its router, the in-memory test transports, TCP and
WebSocket) and its ``testing`` package with the JAX package's.

Each case runs one reference test of ``tests/test_rpc.py``,
``tests/test_tcp_transport.py``, ``tests/test_websocket.py`` or
``tests/test_testing_utils.py`` twice: as the reference module, and as the
same source with the package renamed to the port (:func:`run_both`). The
reference's assertions hold on both runs, and the observations must be
EQUAL: every outbound call's first result (by service and method, values
normalised) and every call error (by type), and, where the case's traffic
does not depend on timing, each hub's counters (``fanout_stats``: messages
sent, invalidations posted and coalesced, batch frames and keys).

``test_default_session_replacer_middleware`` and
``test_test_web_host_http_gateway`` run in ``tests/test_torch_ext.py``, with
the port's ``ext/`` and gateway.
``test_websocket_chaos_calls_and_invalidation_survive`` kills connections
at random over real sockets and polls until the client converges, so each
package's side runs as its own case (``test_torch_edge.run_side``). The
reference's TCP server never returns from ``stop()``
on Python 3.12.1 and later (``asyncio.Server.wait_closed`` waits for every
connection, and each connection's handler waits for its socket), so its
runs here stop the server's peers first (:func:`_jax_tcp_stop`); the port's
``RpcTcpServer.stop`` closes its connections itself (ROADMAP C.4).
Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
import contextlib
import importlib
import inspect
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

TESTS = Path(__file__).resolve().parent
PACKAGES = ("stl_fusion_tpu", "stl_fusion_tpu_torch")
#: the counters of ``RpcHub.fanout_stats`` compared between the packages
HUB_COUNTERS = ("messages_sent", "invalidations_posted", "invalidations_coalesced",
                "batch_frames_sent", "batch_keys_sent")


def reference_module(name: str, package: str, patches=()):
    """The reference test module ``tests/<name>.py``: as pytest imports it
    for the JAX package, or its source with ``stl_fusion_tpu`` renamed to
    the port (``patches``, (old, new) pairs, first) for the port, whose
    graph backends, memo tables and table backings are given
    ``device="cpu"``."""
    if package == PACKAGES[0]:
        return importlib.import_module(name)
    key = f"{name}__port"
    if key not in sys.modules:
        src = (TESTS / f"{name}.py").read_text()
        for old, new in patches:
            assert old in src, old
            src = src.replace(old, new)
        src = re.sub(r"\bstl_fusion_tpu\b", PACKAGES[1], src)
        # the port's entry points run on the card unless given the CPU
        src = re.sub(r"\bTpuGraphBackend\((\w+), ", r'TpuGraphBackend(\1, device="cpu", ', src)
        src = re.sub(r"\bTpuGraphBackend\((\w+)\)", r'TpuGraphBackend(\1, device="cpu")', src)
        src = re.sub(r"\bMemoTable\(([^()]+)\)", r'MemoTable(\1, device="cpu")', src)
        src = re.sub(r"\bTableBacking\(", 'TableBacking(device="cpu", ', src)
        mod = types.ModuleType(key)
        mod.__file__ = str(TESTS / f"{name}.py")
        sys.modules[key] = mod
        exec(compile(src, f"<{name}.py on {PACKAGES[1]}>", "exec"), mod.__dict__)
    return sys.modules[key]


def norm(x):
    """A package-independent form of a call result."""
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {str(k): norm(v) for k, v in sorted(x.items(), key=lambda kv: str(kv[0]))}
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    text = repr(x)
    return type(x).__name__ if " at 0x" in text else text


@contextlib.contextmanager
def observed(package: str):
    """Records every outbound call's first result and every call error, and
    the hubs made, while the block runs."""
    calls = importlib.import_module(f"{package}.rpc.calls")
    compute = importlib.import_module(f"{package}.client.compute_call")
    hub_mod = importlib.import_module(f"{package}.rpc.hub")
    log = {"results": [], "errors": [], "hubs": []}
    saved = []

    def patch(cls, name, wrapper):
        saved.append((cls, name, cls.__dict__[name]))
        setattr(cls, name, wrapper(cls.__dict__[name]))

    def on_result(fn):
        def set_result(self, value, message):
            if self.future is None or not self.future.done():
                log["results"].append(("ok", self.service, self.method, norm(value)))
            return fn(self, value, message)
        return set_result

    def on_error(fn):
        def set_error(self, error):
            if self.future is None or not self.future.done():
                log["errors"].append((self.service, self.method, type(error).__name__))
            return fn(self, error)
        return set_error

    def on_hub(fn):
        def __init__(self, *args, **kwargs):
            fn(self, *args, **kwargs)
            log["hubs"].append(self)
        return __init__

    for cls in (calls.RpcOutboundCall, compute.RpcOutboundComputeCall):
        patch(cls, "set_result", on_result)
        patch(cls, "set_error", on_error)
    patch(hub_mod.RpcHub, "__init__", on_hub)
    try:
        yield log
    finally:
        for cls, name, fn in reversed(saved):
            setattr(cls, name, fn)


def _jax_tcp_stop():
    """The reference ``RpcTcpServer.stop`` with its peers stopped first, so
    ``wait_closed`` finds no connection open (ROADMAP C.4)."""
    from stl_fusion_tpu.rpc.tcp import RpcTcpServer

    stop = RpcTcpServer.stop

    async def stop_peers_first(self):
        for ref, peer in list(self.hub.peers.items()):
            if ref.startswith(self.ref_prefix):
                await peer.stop()
        await stop(self)

    return RpcTcpServer, stop_peers_first


def run_both(module: str, test: str, stats: bool = True, patches=(), **fixtures):
    """Runs ``tests/<module>.py::<test>`` on the JAX package, then on the
    port, each on a fresh event loop (as ``tests/conftest.py`` runs async
    tests), and requires equal observations; ``stats=False`` leaves the
    hubs' counters out (their traffic depends on timing)."""
    got = []
    for package in PACKAGES:
        fn = getattr(reference_module(module, package, patches), test)
        kwargs = {name: fixtures[name] for name in inspect.signature(fn).parameters}
        with contextlib.ExitStack() as stack:
            log = stack.enter_context(observed(package))
            if package == PACKAGES[0] and module == "test_tcp_transport":
                cls, stop = _jax_tcp_stop()
                stack.enter_context(_patched(cls, "stop", stop))
            if inspect.iscoroutinefunction(fn):
                asyncio.run(fn(**kwargs))
            else:
                fn(**kwargs)
        got.append({
            "results": sorted(log["results"], key=repr),
            "errors": sorted(log["errors"]),
            "hubs": [(h.name, {k: h.fanout_stats()[k] for k in HUB_COUNTERS})
                     for h in log["hubs"]] if stats else len(log["hubs"]),
        })
    assert got[0] == got[1], got
    return got[1]


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


# ---------------------------------------------------------------- test_rpc.py
#: test_rpc.py's cases whose traffic does not depend on timing
RPC_STABLE = [
    "test_basic_call_roundtrip", "test_error_propagation", "test_unknown_service_and_method",
    "test_concurrent_calls", "test_no_wait_fire_and_forget",
    "test_consistent_hash_routing_across_servers", "test_router_local_fallback",
    "test_missing_connector_fails_fast", "test_inbound_outbound_middleware_chain",
    "test_middleware_rejection_is_isolated_per_call",
    "test_failing_middleware_on_completion_unblocks_caller",
    "test_unserializable_result_errors_instead_of_hanging",
    "test_outbound_middleware_rejecting_result_errors_client",
    "test_consistent_hash_router_stable_across_process_restarts",
    "test_consistent_hash_router_minimal_movement_on_member_removal",
]
#: and those whose reconnects, cancels or sleeps make their message counts vary
RPC_TIMED = [
    "test_cancellation_propagates", "test_call_survives_disconnect",
    "test_resend_does_not_duplicate_execution", "test_reconnect_backoff_then_success",
    "test_inbound_concurrency_level_gates_calls",
    "test_unrecoverable_connect_error_aborts_reconnect_loop",
    "test_resend_batch_survives_link_death_mid_batch",
    "test_resend_applies_outbound_middlewares", "test_randomized_disconnect_soak",
]


@pytest.mark.parametrize("test", RPC_STABLE)
def test_rpc_case(test):
    run_both("test_rpc", test)


@pytest.mark.parametrize("test", RPC_TIMED)
def test_rpc_timed_case(test):
    run_both("test_rpc", test, stats=False)


# ---------------------------------------------------------------- TCP
@pytest.mark.parametrize("test", ["test_rpc_over_real_tcp",
                                  "test_fusion_invalidation_over_real_tcp",
                                  "test_dcn_fallback_classification_over_real_tcp"])
def test_tcp_case(test):
    run_both("test_tcp_transport", test, stats=False)


async def test_tcp_server_stop_closes_open_connections():
    """The port's ``RpcTcpServer.stop`` returns with a client still
    connected (the reference's waits forever on Python 3.12.1 and later)."""
    from stl_fusion_tpu_torch.rpc import RpcHub
    from stl_fusion_tpu_torch.rpc.tcp import RpcTcpServer, tcp_client_connector

    class Echo:
        async def echo(self, text):
            return f"tcp:{text}"

    server_hub = RpcHub("server")
    server_hub.add_service("echo", Echo())
    server = await RpcTcpServer(server_hub).start()
    client_hub = RpcHub("client")
    client_hub.client_connector = tcp_client_connector(server.host, server.port)
    assert await client_hub.client("echo", "default").echo("x") == "tcp:x"
    await client_hub.stop()
    await asyncio.wait_for(server.stop(), 5.0)
    assert not server._writers
    await server_hub.stop()


# ---------------------------------------------------------------- WebSocket
@pytest.mark.parametrize("test", [
    "test_rpc_over_real_websocket", "test_fusion_invalidation_over_real_websocket",
    "test_websocket_reconnect_resumes_same_server_peer", "test_ws_framing_packs_small_messages",
    "test_ws_writer_bounded_backpressure_and_failure",
    "test_ws_writer_cancel_mid_send_fails_inflight_batch",
    "test_ws_invalidation_flood_bounded_and_delivered", "test_ws_malformed_frame_is_a_connection_error",
])
def test_websocket_case(test):
    run_both("test_websocket", test, stats=False)


@pytest.mark.parametrize("package", PACKAGES)
def test_websocket_chaos_calls_and_invalidation_survive(package):
    from test_torch_edge import run_side

    run_side("test_websocket", "test_websocket_chaos_calls_and_invalidation_survive", package)


# ---------------------------------------------------------------- testing/
@pytest.mark.parametrize("test", ["test_test_web_host_end_to_end",
                                  "test_test_web_host_isolated_clients",
                                  "test_random_time_span", "test_is_build_agent_env"])
def test_testing_utils_case(test, monkeypatch):
    run_both("test_testing_utils", test, stats=False, monkeypatch=monkeypatch)


async def test_web_host_http_gateway_waits_for_its_slice():
    """Its slice is ported: ``TestWebHost(use_http_gateway=True)`` serves
    the host's services over the port's REST gateway."""
    pytest.importorskip("websockets")  # TestWebHost binds a real ws listener
    from stl_fusion_tpu_torch.rpc.http_gateway import FusionHttpServer, RestClient
    from stl_fusion_tpu_torch.testing import TestWebHost

    class Echo:
        async def echo(self, text):
            return f"rest:{text}"

    async with TestWebHost(use_http_gateway=True) as host:
        assert isinstance(host.http_server, FusionHttpServer)
        host.add_service("echo", Echo())
        assert await RestClient(host.http_url, "echo").echo("x") == "rest:x"


def test_set_chaos_waits_for_its_slice():
    """Its slice is ported: a policy wraps both ends of every connection
    made from then on, and ``None`` turns it off for the next ones."""
    from stl_fusion_tpu_torch.resilience import ChaosPolicy
    from stl_fusion_tpu_torch.resilience import chaos as pchaos
    from stl_fusion_tpu_torch.rpc import RpcHub, RpcTestTransport

    transport = RpcTestTransport(RpcHub("client"), RpcHub("server"))
    wrapped = []
    real = pchaos.wrap_chaos_pair

    def wrap(pair, policy):
        wrapped.append(policy)
        return real(pair, policy)

    async def connect():
        peer = transport.client_hub.client_peer("default")
        await transport.wait_connected()
        await transport.client_hub.stop()
        await transport.server_hub.stop()
        return peer

    policy = ChaosPolicy(seed=5)
    transport.set_chaos(policy)
    pchaos.wrap_chaos_pair = wrap
    try:
        asyncio.run(connect())
    finally:
        pchaos.wrap_chaos_pair = real
    assert wrapped == [policy, policy]


# ---------------------------------------------------------------- the wire
def test_messages_and_registry_match_the_reference():
    """``RpcMessage`` round trips through each package's codec to the same
    bytes, and the service registry resolves the same methods."""
    import stl_fusion_tpu.rpc as jrpc
    import stl_fusion_tpu.utils.serialization as jser
    import stl_fusion_tpu_torch.rpc as prpc
    import stl_fusion_tpu_torch.utils.serialization as pser

    out = []
    for rpc, ser in ((jrpc, jser), (prpc, pser)):
        msg = rpc.RpcMessage(call_type_id=1, call_id=7, service="dag", method="node",
                             argument_data=ser.dumps([3, "x"]),
                             headers=((rpc.VERSION_HEADER, "@v1"),))
        back = ser.loads(ser.dumps(msg))

        class Svc:
            async def get(self, i):
                return i

            @rpc.rpc_no_wait
            async def tell(self, i):
                pass

        reg = rpc.RpcServiceRegistry()
        reg.add("svc", Svc())
        d = reg.require("svc")
        out.append((ser.dumps(msg), back == msg, back.header(rpc.VERSION_HEADER),
                    rpc.SYSTEM_SERVICE, rpc.COMPUTE_SYSTEM_SERVICE,
                    sorted(d.methods), d.method("tell").no_wait, d.method("get").no_wait))
    assert out[0] == out[1], out
