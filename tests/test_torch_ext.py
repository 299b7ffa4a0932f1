"""Parity of the port's ``ext/`` package (sessions, multitenancy, auth and
its server helper, the key-value store, ``FusionTime``, the peer monitor,
plugins, streams), its HTTP gateway (``rpc/http_gateway.py``) and its
session middleware (``rpc/middleware.py``) with the JAX package's.

Each case runs one reference test on both packages
(``test_torch_edge.run_case``, or ``test_torch_rpc.run_both`` for the
``tests/test_rpc.py`` and ``tests/test_testing_utils.py`` cases): the
reference's assertions on both, equal call results and errors, and, where
the traffic does not depend on timing, equal hub counters.

- ``tests/test_multitenancy.py`` and ``tests/test_ext_plugins_streams.py``:
  every case. ``find_plugins`` scans the modules its caller names: each
  package scans its own copy of the reference module, so neither scan
  imports the other package.
- ``tests/test_ext_ui.py``: the ``ext`` and gateway cases. Its ``ui``
  cases and ``test_fusion_monitor_hit_ratio`` run in
  ``tests/test_torch_ui.py``.
- ``tests/test_rpc.py::test_default_session_replacer_middleware`` and
  ``tests/test_testing_utils.py::test_test_web_host_http_gateway``.

Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import pytest

from test_torch_edge import run_case
from test_torch_rpc import run_both

MULTITENANCY = [
    "TestTenantRegistry::test_single_tenant_mode", "TestTenantRegistry::test_multi_tenant_add_remove",
    "TestTenantRegistry::test_resolver_uses_session_suffix",
    "TestPerTenantWorkers::test_one_worker_per_tenant_and_follows_changes",
    "test_tenant_isolated_cross_host_invalidation", "test_pending_add_cancelled_by_removal_and_stop",
]


@pytest.mark.parametrize("test", MULTITENANCY)
def test_multitenancy_case(test):
    run_case("test_multitenancy", test)


#: each package's plugin scan reads its own copy of the reference module
OWN_PLUGIN_MODULE = ('find_plugins(["tests.test_ext_plugins_streams"], recurse=False)',
                     'find_plugins(["test_ext_plugins_streams__port"], recurse=False)')

PLUGINS_STREAMS = [
    "TestPlugins::test_start_order_respects_dependencies",
    "TestPlugins::test_host_instantiates_and_queries_capabilities",
    "TestPlugins::test_cycle_detection", "TestPlugins::test_missing_dependency",
    "TestPlugins::test_find_plugins_scans_this_module",
    "TestStreams::test_pubsub_typed_roundtrip", "TestStreams::test_queue_each_item_consumed_once",
    "TestStreams::test_streamer_replays_backlog_then_follows",
    "TestStreams::test_sequence_set_monotone",
    "TestStreams::test_broker_change_notifier_wakes_subscribers",
    "TestHttpGateway::test_rest_roundtrip_and_errors",
    "TestReviewFixes::test_queue_distinct_delivery_across_instances",
    "TestReviewFixes::test_streamer_slow_reader_skips_trimmed_not_misindexed",
    "TestReviewFixes::test_dynamic_service_rejects_non_methods_and_does_not_cache",
    "TestReviewFixes::test_gateway_unserializable_result_returns_500",
    "TestReviewFixes::test_tenant_removed_off_loop_worker_stopped_at_host_stop",
    "TestReviewFixes::test_streamer_trim_while_reader_suspended_mid_batch",
    "TestReviewFixes::test_tenant_added_off_loop_starts_via_flush_pending",
    "TestReviewFixes::test_rest_client_empty_response_is_rest_error",
    "test_peer_monitor_reports_terminated_state", "test_http_session_middleware_cookie_flow",
    "test_gateway_malformed_wire_args_are_400",
]


@pytest.mark.parametrize("test", PLUGINS_STREAMS)
def test_plugins_streams_case(test):
    run_case("test_ext_plugins_streams", test, patches=[OWN_PLUGIN_MODULE])


EXT_UI = [
    "test_fusion_time_auto_invalidates", "test_moments_ago_formatting",
    "test_kv_store_invalidates_reads_and_listings", "test_kv_store_expiration",
    "test_session_semantics", "test_auth_live_sign_in_out",
    "test_sign_out_invalidates_user_session_list",
    "test_sign_in_reassignment_invalidates_old_user_sessions",
    "test_sqlite_kv_store_survives_restart", "test_sandboxed_kv_store_isolates_sessions",
    "test_sandboxed_kv_store_rejects_slash_aliasing", "test_sqlite_auth_survives_restart",
    "test_forced_sign_out_semantics", "test_server_auth_helper_decision_tree",
    "test_auth_helper_forced_signout_never_signs_in",
    "test_gateway_ignores_principal_from_untrusted_peer", "test_gateway_shared_secret_proxy_trust",
    "test_rest_client_rejects_header_injection",
    "test_auth_helper_empty_transport_values_converge",
    "test_untrusted_request_never_signs_out_existing_session",
]


@pytest.mark.parametrize("test", EXT_UI)
def test_ext_ui_case(test, tmp_path):
    run_case("test_ext_ui", test, pipeline=True, tmp_path=tmp_path)


class CountingIds:
    """``secrets`` for ``ext/session.py`` whose session ids count up from 0,
    so both packages' calls return the same ids."""

    def __init__(self):
        self.n = 0

    def token_urlsafe(self, nbytes: int) -> str:
        self.n += 1
        return f"session-{self.n:0{nbytes}d}"


def test_default_session_replacer_middleware_case(monkeypatch):
    import stl_fusion_tpu.ext.session as jsession
    import stl_fusion_tpu_torch.ext.session as psession

    for module in (jsession, psession):
        monkeypatch.setattr(module, "secrets", CountingIds())
    run_both("test_rpc", "test_default_session_replacer_middleware")


def test_web_host_http_gateway_case(monkeypatch):
    run_both("test_testing_utils", "test_test_web_host_http_gateway", stats=False,
             monkeypatch=monkeypatch)


def test_chaos_middleware_waits_for_its_slice():
    """Its slice is ported: the middleware is the chaos stage, and a policy
    that drops everything drops the message."""
    import asyncio

    from stl_fusion_tpu_torch.resilience import ChaosPolicy, ResilienceEvents
    from stl_fusion_tpu_torch.rpc.middleware import chaos_middleware

    events, delivered = ResilienceEvents(), []

    async def nxt(message):
        delivered.append(message)

    class Msg:
        service, method = "svc", "m"

    asyncio.run(chaos_middleware(ChaosPolicy(seed=3, drop=1.0), events)(None, Msg(), nxt))
    assert delivered == [] and events.count("chaos_drop") == 1
