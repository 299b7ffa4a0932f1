"""Parity of the port's UI layer (``ui/``: live components, the action
trackers and ``UICommander``, the auth-state provider, the live-view
server and its latest-wins render slots) and of ``FusionMonitor``'s
hit-ratio report with the JAX package's.

Each case runs one reference test of ``tests/test_ext_ui.py`` on both
packages (``test_torch_edge.run_case``, with the module's ``fresh_hub``
and its operations pipeline): the reference's assertions hold on both,
and the call results, call errors and, where the traffic does not depend
on timing, the hub counters must be EQUAL. The live-view cases push over
real sockets with send intervals, heartbeats and stall evictions, so their
counters are left out (``stats=False``). The ``ext`` and gateway cases of
the same file run in ``tests/test_torch_ext.py``. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import pytest

from test_torch_edge import run_case

#: the ``ui`` cases whose traffic does not depend on timing
UI_STABLE = [
    "test_live_component_rerenders_on_invalidation", "test_live_component_parameter_comparer",
    "test_ui_action_tracker_instant_updates", "test_ui_action_failure_tracker_collects_errors",
    "test_auth_state_provider_live_updates", "test_gateway_auth_sync_end_to_end",
    "test_render_slot_latest_wins",
]
#: and the live-view server's, whose pushes are paced by the clock
UI_TIMED = [
    "test_live_view_server_pushes_renders_per_connection", "test_live_view_component_error_payload",
    "test_live_view_stalled_reader_gets_newest_only", "test_live_view_evicts_stalled_client",
    "test_live_view_min_send_interval_rate_limits",
]


@pytest.mark.parametrize("test", UI_STABLE)
def test_ui_case(test):
    run_case("test_ext_ui", test, pipeline=True)


@pytest.mark.parametrize("test", UI_TIMED)
def test_ui_timed_case(test):
    run_case("test_ext_ui", test, stats=False, pipeline=True)


def test_fusion_monitor_hit_ratio_case():
    run_case("test_ext_ui", "test_fusion_monitor_hit_ratio", pipeline=True)
