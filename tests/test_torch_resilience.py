"""Parity of the port's resilience package (``resilience/chaos.py``,
``resilience/breaker.py``, ``resilience/watchdog.py``) and the backend's
watchdog routing with the JAX package's.

Each case runs one reference test of ``tests/test_resilience.py`` on both
packages (``test_torch_edge.run_case``): the reference's assertions hold on
both, and the call results, call errors and hub counters must be EQUAL.
The watchdog cases also compare every ``WaveWatchdog``'s counters
(``fallbacks``, ``faults``, ``deadline_trips``, ``reengages``,
``oracle_checks``, ``oracle_mismatches``, the mode) and the newly-invalid
union ids of every burst it dispatched. The breaker cases hold 8 s
wall-clock deadlines and their traffic depends on timing: each package's
side runs as its own parametrised case, so a loaded box never holds the
one side's time against the other's. The partition-storm scenario's
traffic (what each read returns mid-storm) depends on timing too, and runs
the same way.

Also the card-fault repair: a ``RuntimeError`` raised from inside a fused
dispatch (a failed CUDA launch reports as one) is a fault, never the
counted "not fusible" eager path (``tests/test_torch_read.py`` pins the
same for the super-round and the pipeline). Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import contextlib
import importlib

import numpy as np
import pytest

from test_torch_edge import run_case, run_side
from test_torch_rpc import PACKAGES, reference_module


@contextlib.contextmanager
def unions_recorded():
    """Every ``WaveWatchdog._dispatch`` of either package appends the
    sorted newly-invalid ids of its burst to the watchdog's ``_unions``."""
    saved = []
    for package in PACKAGES:
        cls = importlib.import_module(f"{package}.resilience.watchdog").WaveWatchdog
        dispatch = cls.__dict__["_dispatch"]

        def _dispatch(self, graph, seed_lists, fused_fn, host_fn, __dispatch=dispatch):
            res = __dispatch(self, graph, seed_lists, fused_fn, host_fn)
            newly = np.asarray(res[1])
            ids = np.nonzero(newly)[0] if newly.dtype == np.bool_ else newly
            self.__dict__.setdefault("_unions", []).append(np.unique(ids).tolist())
            return res

        saved.append((cls, dispatch))
        cls._dispatch = _dispatch
    try:
        yield
    finally:
        for cls, dispatch in saved:
            cls._dispatch = dispatch


#: the watchdog's counters and every burst's union, compared
WATCHDOG = (("resilience.watchdog", "WaveWatchdog",
             lambda w: {**w.snapshot(), "unions": w.__dict__.get("_unions", [])}),)


# ---------------------------------------------------------------- chaos
@pytest.mark.parametrize("test", [
    "test_chaos_policy_is_deterministic", "test_chaos_middleware_drop_duplicate_delay",
    "test_named_scenarios_produce_policies", "test_monitor_exports_resilience_counters_and_disposes",
])
def test_resilience_case(test):
    run_case("test_resilience", test)


def test_chaos_policy_fates_match_the_reference():
    """The same seed draws the same fates, message by message, in both
    packages (the policy's RNG and the order of its draws are the
    reference's)."""
    import stl_fusion_tpu.resilience as jres
    import stl_fusion_tpu_torch.resilience as pres

    kw = dict(seed=31, drop=0.1, duplicate=0.2, delay=0.3, reorder_window=4)
    a, b = jres.ChaosPolicy(**kw), pres.ChaosPolicy(**kw)
    fates = [(a.sample(), b.sample()) for _ in range(500)]
    assert [(x.drop, x.duplicate, x.delay_s) for x, _ in fates] == \
        [(y.drop, y.duplicate, y.delay_s) for _, y in fates]
    assert (a.dropped, a.duplicated, a.delayed) == (b.dropped, b.duplicated, b.delayed)


# ---------------------------------------------------------------- watchdog
@pytest.mark.parametrize("test", [
    "test_watchdog_fault_falls_back_to_host_loop_and_reengages",
    "test_watchdog_deadline_trip_degrades", "test_watchdog_lane_bursts_fault_and_recover",
    "test_watchdog_covers_seq_bursts",
])
def test_watchdog_case(test):
    with unions_recorded():
        got = run_case("test_resilience", test, recorded=WATCHDOG)
    assert got["WaveWatchdog"] and got["WaveWatchdog"][0]["reengages"] == 1


# ---------------------------------------------------------------- timed cases
@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("test", [
    "test_breaker_opens_on_flaps_and_recloses",
    "test_breaker_probe_dial_failure_reopens_escalated",
    "test_breaker_state_surfaces_through_peer_monitor",
])
def test_breaker_case(test, package):
    run_side("test_resilience", test, package)


@pytest.mark.parametrize("package", PACKAGES)
def test_chaos_scenario_partition_storm_case(package):
    run_side("test_resilience", "test_chaos_scenario_partition_storm_end_to_end", package)


# ---------------------------------------------------------------- the card-fault repair
def test_watchdog_contains_a_runtime_error_from_the_fused_burst(monkeypatch):
    """A ``RuntimeError`` subclass raised by the fused lane burst itself
    (what torch raises for a failed CUDA launch) is contained as a fault:
    the burst re-runs on the split host loop with the same union, and the
    watchdog degrades."""
    import stl_fusion_tpu_torch.graph.device_graph as pdg

    mod = reference_module("test_resilience", PACKAGES[1])
    backend, table, block = mod.make_wave_stack()
    wd = backend.attach_watchdog(mod.WaveWatchdog(deadline_s=60.0, recovery_bursts=1,
                                                  events=mod.ResilienceEvents()))
    want = backend.cascade_rows_lanes(block, [[10], [40]])
    table.read_batch(np.arange(64))
    backend.flush()

    class LaunchFailed(RuntimeError):
        pass

    def fail(self, *args, **kwargs):
        raise LaunchFailed("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(pdg.DeviceGraph, "run_waves_lanes", fail)
    got = backend.cascade_rows_lanes(block, [[10], [40]])
    assert int(got.sum()) == int(want[0]) == 54  # the host loop's sequential groups
    assert wd.faults == 1 and wd.fallbacks == 1 and wd.mode == wd.MODE_FUSED
