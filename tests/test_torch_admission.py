"""Parity of the port's edge admission (``stl_fusion_tpu_torch/edge/
admission.py``: the token buckets, the per-tenant gates and lanes, the
pressure shedding, the unified rejection responder, and the drain and
resume paths of ``EdgeNode`` and ``EdgeHttpServer`` that go through it)
with the JAX package's.

Each of the 17 cases of ``tests/test_admission.py`` runs on both packages
(``test_torch_edge.run_case``): the reference's assertions on both, equal
call results and errors, and, where the traffic does not depend on timing,
equal hub, edge node and admission controller counters. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import pytest

from test_torch_edge import run_case

#: the cases whose controllers run on a fake clock, or whose traffic is
#: fixed by the test's own sequence
ADMISSION_STABLE = [
    "test_token_bucket_deterministic_under_fake_clock", "test_rejection_bytes_headers",
    "test_per_tenant_rate_isolation", "test_per_tenant_gate_share_isolation",
    "test_priority_lane_ordering_under_full_gate", "test_pressure_sheds_anonymous_lane_first",
    "test_pressure_and_gate_sheds_do_not_burn_rate_budget", "test_unknown_tenant_and_draining_shed",
    "test_attach_enforcement_and_counted_shed",
    "test_sse_bogus_resume_token_cannot_ride_the_resume_lane",
    "test_sse_draining_without_controller_answers_503",
]
#: and those whose drains, resume windows or pressure decay run on the
#: real clock, or whose SSE streams deliver while the test goes on
ADMISSION_TIMED = [
    "test_sse_unified_rejection_path_and_503",
    "test_pressure_widened_reread_window_returns_to_baseline", "test_drain_then_resume_zero_loss",
    "test_import_parked_honors_remaining_ttl", "test_expired_resume_storm_releases_parked_refs",
    "test_sse_drain_sends_reconnect_event_with_token",
]


@pytest.mark.parametrize("test", ADMISSION_STABLE)
def test_admission_case(test):
    run_case("test_admission", test)


@pytest.mark.parametrize("test", ADMISSION_TIMED)
def test_admission_timed_case(test):
    run_case("test_admission", test, stats=False)
