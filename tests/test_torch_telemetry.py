"""Parity of the port's mesh telemetry (``diagnostics/mesh_telemetry.py``:
the fleet aggregator and publisher, the cross-host trace store and its
stitch) and of the metrics, wave profiler, cause round trip, monitor
reporter and gateway observability routes (``tests/test_telemetry.py``)
with the JAX package's.

Each case runs one reference test on both packages
(``test_torch_edge.run_case``): the reference's assertions hold on both,
and the call results, call errors and hub counters must be EQUAL. The
cases are every test of ``tests/test_mesh_telemetry.py`` (12) but the two
that build a ``cluster.mesh_controller`` board or controller (ROADMAP A.9:
``test_publisher_board_roundtrip``, ``test_clock_peer_series_pruned_on_reform``),
and every test of ``tests/test_telemetry.py`` (22).

The metric catalog: ``tools/fusionlint`` checks the JAX package's metric
names against ``OBSERVABILITY.md`` and scans only that package. The port
keeps the same catalog by parity instead: after the same scenario (a
watchdog's fault and recovery, lane and pipeline bursts, an SLO verdict,
an audit sweep, a monitor report, a gateway scrape), each package's
global registry holds the same series names with the same labels.
Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
import contextlib
import importlib
import urllib.request

import numpy as np
import pytest

from test_torch_diagnostics import reference_cases
from test_torch_edge import fresh_state, run_case
from test_torch_rpc import PACKAGES, reference_module


#: the cases that need ``cluster.mesh_controller`` (ROADMAP A.9)
NEEDS_CLUSTER = ("test_publisher_board_roundtrip", "test_clock_peer_series_pruned_on_reform")
MESH_TELEMETRY = [p for p in reference_cases("test_mesh_telemetry") if p.id not in NEEDS_CLUSTER]


def test_reference_case_counts():
    assert len(reference_cases("test_mesh_telemetry")) == 12 and len(MESH_TELEMETRY) == 10
    assert len(reference_cases("test_telemetry")) == 22


@pytest.mark.parametrize("test,fixtures", MESH_TELEMETRY)
def test_mesh_telemetry_case(test, fixtures, tmp_path):
    run_case("test_mesh_telemetry", test, tmp_path=tmp_path, **fixtures)


@pytest.mark.parametrize("test,fixtures", reference_cases("test_telemetry"))
def test_telemetry_case(test, fixtures, caplog):
    run_case("test_telemetry", test, caplog=caplog, **fixtures)


# ---------------------------------------------------------------- the catalog
@contextlib.contextmanager
def fresh_registry(package: str):
    """The package's ``global_metrics()`` is a fresh registry while the
    block runs (so nothing an earlier test recorded shows up)."""
    metrics = importlib.import_module(f"{package}.diagnostics.metrics")
    saved, metrics._GLOBAL = metrics._GLOBAL, metrics.MetricsRegistry()
    try:
        yield metrics._GLOBAL
    finally:
        metrics._GLOBAL = saved


async def catalog_scenario(package: str) -> list:
    """One scenario over every instrumented layer this slice ports; the
    sorted series names (labels included) it leaves in the registry."""
    res = reference_module("test_resilience", package)
    diag = importlib.import_module(f"{package}.diagnostics")
    gateway = importlib.import_module(f"{package}.rpc.http_gateway")
    rpc = importlib.import_module(f"{package}.rpc")
    with fresh_state(package) as hub, fresh_registry(package) as registry:
        backend, table, block = res.make_wave_stack(hub)
        backend.graph.build_topo_mirror()
        wd = backend.attach_watchdog(res.WaveWatchdog(deadline_s=60.0, recovery_bursts=1,
                                                      events=res.ResilienceEvents()))
        monitor = diag.FusionMonitor(hub, resilience=wd.events)
        try:
            backend.cascade_rows_lanes(block, [[10], [40]])
            table.read_batch(np.arange(64))
            wd.inject_fault_next()
            backend.cascade_rows_batch(block, [20])
            table.read_batch(np.arange(64))
            backend.cascade_rows_batch(block, [30])  # re-engaged, oracle-verified
            assert wd.reengages == 1
            pipe = hub.enable_nonblocking(fuse_depth=2)
            pipe.submit_rows(block, [5])
            pipe.submit_rows(block, [50])
            pipe.drain()
            table.read_batch(np.nonzero(table._stale_host)[0])
            diag.validate_hub(hub).require()
            diag.validate_mirror(backend).require()
            diag.global_slo_engine().evaluate()
            monitor.report()
            server = gateway.FusionHttpServer(rpc.RpcHub("catalog"))
            server.monitor = monitor
            await server.start()
            try:
                url = f"http://127.0.0.1:{server.port}/metrics"
                body = await asyncio.to_thread(lambda: urllib.request.urlopen(url).read())
                assert b"fusion_" in body
            finally:
                await server.stop()
        finally:
            monitor.dispose()
        return sorted(registry.flat_samples())


def test_metric_catalog_matches_the_reference():
    names = [asyncio.run(catalog_scenario(package)) for package in PACKAGES]
    assert names[0] == names[1]
    assert any(n.startswith("fusion_wave") for n in names[1])
