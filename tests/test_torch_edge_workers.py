"""Parity of the port's multi-process edge delivery plane
(``stl_fusion_tpu_torch/edge/worker_pool.py``: ``EdgeWorkerPool``, its
worker processes spawned as ``python worker_pool.py --worker``, the
``send_fds`` and ``reuseport`` accept planes) with the JAX package's.

Each of the 10 cases of ``tests/test_edge_workers.py`` runs on both
packages (``test_torch_edge.run_case``): the reference's assertions on
both, and equal call results and errors. The workers' deliveries, polls
and reconnects depend on process scheduling, so no counter is compared,
only the number of hubs and edge nodes each run made. The WebSocket case
skips where ``websockets`` is not installed, as the reference does.
Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import pytest

from test_torch_edge import run_case


@pytest.mark.parametrize("test", [
    "test_sim_sessions_deliver_with_single_encode_per_frame",
    "test_release_keys_tears_down_pinned_subs",
    "test_reuseport_sse_serves_hello_replay_and_live_update",
    "test_reuseport_sse_rejects_bad_keys_via_parent_validation",
    "test_send_fds_resume_token_is_portable_across_the_pool",
    "test_reuseport_fallback_knob_still_serves", "test_websocket_delivery_beside_worker_pool",
    "test_forged_resume_token_rides_cold_lane_on_accept_plane",
    "test_drain_hints_worker_held_sessions", "test_pool_stop_is_clean_and_releases_pins",
])
def test_edge_workers_case(test):
    run_case("test_edge_workers", test, stats=False)
