"""Parity of the port's edge tier (``stl_fusion_tpu_torch/edge``: the
``EdgeNode`` gateway, its sessions and mailboxes, the SSE and WebSocket
servers, admission and the worker pool) with the JAX package's, and of the
edge twin (``stl_fusion_tpu_torch/edge_path.py``).

Each case runs one reference test of ``tests/test_edge.py`` twice
(:func:`run_case`): as the reference module, and as the same source with
the package renamed to the port (``test_torch_rpc.reference_module``). The
reference's assertions hold on both runs, and the observations must be
EQUAL: every outbound RPC call's first result and every call error, and,
where the case's traffic does not depend on timing, each RPC hub's
counters, each ``EdgeNode``'s counters (:data:`EDGE_COUNTERS`: encodes,
deliveries, evictions, resumes, upstream fences and re-reads, block hits,
attached sessions) and each ``AdmissionController``'s admitted and shed
counts. ``tests/test_admission.py``, ``tests/test_edge_workers.py``, the
``ext/`` files and the ``EdgeNode`` cases of ``tests/test_value_plane.py``
run through the same helper from their own parity files.

``test_chaos_reshard_sessions_converge_to_oracle`` (seeded chaos on the
upstream link and a mid-run reshard through ``cluster.ShardMapRouter``) runs
one package a case (``run_side``): what the chaos does to each call depends
on timing, so only the reference's assertions hold.

The twin at 20,000 nodes runs through both packages
(``run_edge(api=EdgeApi(<jax modules>))``), on each value plane, and must
agree on deliveries a round, upstream and server subscriptions, upstream
RPCs, encodes, block hits and each leg's device waves by kind. No timing
is compared. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
import contextlib
import importlib
import inspect

import jax.numpy as jnp
import pytest

import stl_fusion_tpu.client as jclient
import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.diagnostics as jdiag
import stl_fusion_tpu.edge as jedge
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu.rpc as jrpc
from stl_fusion_tpu_torch.edge_path import EdgeApi, port_api, run_edge
from stl_fusion_tpu_torch.graph.synthetic import power_law_dag
from test_torch_rpc import HUB_COUNTERS, PACKAGES, observed, reference_module

#: the ``EdgeNode`` counters compared between the packages
EDGE_COUNTERS = ("frames_encoded", "frames_lossy", "deliveries", "evictions", "resumes",
                 "resumes_expired", "upstream_fences", "upstream_errors", "upstream_rpcs",
                 "per_key_rereads", "reread_batches", "block_hits", "sessions_attached_total",
                 "drains", "sessions_drained")


#: the objects a case makes whose counters are compared (module, class,
#: the counters of one object)
RECORDED = (
    ("edge.gateway", "EdgeNode",
     lambda n: (n.name, {k: getattr(n, k) for k in EDGE_COUNTERS})),
    ("edge.admission", "AdmissionController",
     lambda c: {k: v for k, v in c.snapshot().items() if k != "pressure"}),
)


@contextlib.contextmanager
def made(package: str, recorded=RECORDED):
    """Records every object of a ``recorded`` class (default
    :data:`RECORDED`) made while the block runs, by class name."""
    out, saved = {}, []
    for module, name, _counters in recorded:
        cls = getattr(importlib.import_module(f"{package}.{module}"), name)
        init = cls.__dict__["__init__"]
        objs = out[name] = []

        def __init__(self, *args, __init=init, __objs=objs, **kwargs):
            __init(self, *args, **kwargs)
            __objs.append(self)

        saved.append((cls, init))
        cls.__init__ = __init__
    try:
        yield out
    finally:
        for cls, init in saved:
            cls.__init__ = init


@contextlib.contextmanager
def fresh_state(package: str, pipeline: bool = False):
    """What the reference modules' autouse ``fresh_hub`` fixture and the
    conftest's span isolation do for a test, on ``package``: a fresh
    default hub (with the operations pipeline where the module's fixture
    attaches it); the recent spans, the flight recorder and the mesh trace
    store cleared; the span listeners and the recorder's and trace store's
    gates restored afterwards."""
    core = importlib.import_module(f"{package}.core")
    diag = importlib.import_module(f"{package}.diagnostics")
    tracing = importlib.import_module(f"{package}.diagnostics.tracing")
    trace_store = diag.global_mesh_trace()
    listeners = list(tracing._listeners)
    gates = diag.RECORDER.enabled, trace_store.enabled
    diag.clear_recent()
    diag.RECORDER.clear()
    trace_store.clear()
    hub = core.FusionHub()
    if pipeline:
        hub.commander.attach_operations_pipeline()
    old = core.set_default_hub(hub)
    try:
        yield hub
    finally:
        core.set_default_hub(old)
        tracing._listeners[:] = listeners
        diag.RECORDER.enabled, trace_store.enabled = gates
        diag.clear_recent()
        diag.RECORDER.clear()
        trace_store.clear()


def _test_fn(module, test: str):
    """``test`` or ``Class::test`` of a reference module."""
    if "::" in test:
        cls, name = test.split("::")
        return getattr(getattr(module, cls)(), name)
    return getattr(module, test)


def run_case(module: str, test: str, stats: bool = True, patches=(), pipeline: bool = False,
             recorded=RECORDED, **fixtures):
    """Runs ``tests/<module>.py::<test>`` on the JAX package, then on the
    port, each on a fresh event loop with a fresh default hub (and
    ``fresh_hub`` passed where the test asks for it; ``tmp_path`` is a
    directory of its own a package), and requires equal observations.
    ``stats=False`` leaves the hubs', edge nodes' and admission
    controllers' counters out (the case's traffic depends on timing:
    coalescing windows, rate limits, reconnects, worker processes).
    ``recorded`` names the classes whose objects' counters are compared
    (default :data:`RECORDED`)."""
    got = []
    for package in PACKAGES:
        fn = _test_fn(reference_module(module, package, patches), test)
        with contextlib.ExitStack() as stack:
            hub = stack.enter_context(fresh_state(package, pipeline))
            have = dict(fixtures, fresh_hub=hub)
            if "tmp_path" in fixtures:
                have["tmp_path"] = fixtures["tmp_path"] / package
                have["tmp_path"].mkdir()
            kwargs = {name: have[name] for name in inspect.signature(fn).parameters}
            log = stack.enter_context(observed(package))
            objs = stack.enter_context(made(package, recorded))
            if inspect.iscoroutinefunction(fn):
                asyncio.run(fn(**kwargs))
            else:
                fn(**kwargs)
        got.append({
            "results": sorted(log["results"], key=repr),
            "errors": sorted(log["errors"]),
            "hubs": [(h.name, {k: h.fanout_stats()[k] for k in HUB_COUNTERS})
                     for h in log["hubs"]] if stats else len(log["hubs"]),
            **{name: [counters(o) for o in objs[name]] if stats else len(objs[name])
               for _module, name, counters in recorded},
        })
    assert got[0] == got[1], got
    return got[1]


def run_side(module: str, test: str, package: str, patches=(), pipeline: bool = False,
             **fixtures):
    """One package's side of ``tests/<module>.py::<test>``, on a fresh loop
    and default hub: the reference's assertions only. For the cases whose
    every observation (even what a read returns mid-storm) depends on
    timing, or that hold wall-clock deadlines: each package's side runs as
    its own parametrised case."""
    fn = _test_fn(reference_module(module, package, patches), test)
    with fresh_state(package, pipeline) as hub:
        have = dict(fixtures, fresh_hub=hub)
        if "tmp_path" in fixtures:
            have["tmp_path"] = fixtures["tmp_path"] / package
            have["tmp_path"].mkdir()
        kwargs = {name: have[name] for name in inspect.signature(fn).parameters}
        if inspect.iscoroutinefunction(fn):
            asyncio.run(fn(**kwargs))
        else:
            fn(**kwargs)


# ---------------------------------------------------------------- test_edge.py
#: test_edge.py's cases whose traffic does not depend on timing
EDGE_STABLE = [
    "test_single_upstream_subscription_per_key", "test_broken_sink_evicted_without_killing_the_key",
    "test_resume_replays_only_missed_keys", "test_client_computed_exposes_invalidation_origin_ts",
    "test_keyed_take_nowait_merges_rate_limited_batch", "test_evict_is_idempotent",
    "test_key_allowlist_and_per_session_cap", "test_resume_validates_args_without_consuming_token",
    "test_sse_rejects_bad_requests", "test_encode_cache_hit_miss_and_fan_eagerness",
    "test_encode_cache_entry_drops_with_sub_teardown",
    "test_resume_replay_uses_cached_bytes_without_stale_t0",
    "test_encoded_bytes_immune_to_payload_mutation", "test_lossy_frames_counted_once_per_encode",
    "test_fan_shards_partition_and_deliver_all_sessions",
    "test_explain_spans_server_edge_session_and_metrics", "test_monitor_reports_edge_section",
]
#: and those whose coalescing, rate limits, heartbeats or sweeps make their
#: counts vary with timing
EDGE_TIMED = [
    "test_mailbox_latest_wins_coalescing", "test_slow_consumer_evicted_without_delaying_healthy",
    "test_mailbox_overflow_evicts_with_resume", "test_pump_rate_limit_ships_newest",
    "test_pump_heartbeat_and_eviction", "test_idle_gateway_sweeps_expired_parked_sessions",
    "test_sse_stream_heartbeat_and_last_event_id_resume",
    "test_sse_answers_409_when_replay_overflows",
]


@pytest.mark.parametrize("test", EDGE_STABLE)
def test_edge_case(test):
    run_case("test_edge", test)


@pytest.mark.parametrize("test", EDGE_TIMED)
def test_edge_timed_case(test):
    run_case("test_edge", test, stats=False)


@pytest.mark.parametrize("package", PACKAGES)
def test_chaos_reshard_sessions_converge_to_oracle(package):
    # what the chaos drops, duplicates and reorders (and so every call's
    # result) depends on timing: each package's side is a case of its own
    run_side("test_edge", "test_chaos_reshard_sessions_converge_to_oracle", package)


# ---------------------------------------------------------------- the twin
TWIN = dict(n_nodes=20_000, edge_nodes=2, sessions=2_000, keys=64)


@pytest.mark.parametrize("plane", [
    dict(value_plane="block", workers=1),
    dict(value_plane="batch", workers=1, accept_plane="reuseport"),
    dict(value_plane="perkey", workers=0, wire_codec=False),
], ids=["block", "batch-reuseport", "perkey-in-parent"])
def test_edge_twin_matches_jax(plane):
    """``perf/edge_path.py``'s scenario at 20,000 nodes (2 edges, 2,000
    sessions over 64 keys by zipf 1.1, 2 rounds of 16 groups of 2 deep
    seeds, the smoke leg) through both packages from the same edge arrays,
    on each value plane (the default block plane with one worker an edge;
    the batched re-read on the ``reuseport`` accept plane; per-key re-reads
    with the sessions in the parent and no wire codec): equal deliveries a
    round, upstream and server subscriptions, upstream RPCs and re-reads,
    encodes, block hits and device waves by kind in every leg."""
    edges = power_law_dag(TWIN["n_nodes"], avg_degree=3, seed=7)
    japi = EdgeApi(jcore, jgraph, jrpc, jclient, jedge, jdiag, {}, jnp.asarray, lambda: None,
                   "jax")
    recs = [run_edge(**TWIN, **plane, edges=edges, api=api) for api in (japi, port_api("cpu"))]
    keys = ["subscribers", "subscriptions", "upstream_subs_per_edge", "server_subscriptions",
            "fenced_total", "frames_encoded", "encodes_per_edge", "fanned_versions",
            "block_hits_total", "block_hits_measured",
            "upstream_rpcs_total", "per_key_rereads_total", "evictions", "dispatches"]
    # the node's delivery totals also count the probe sessions' attach
    # replays, whose number depends on when each key's first value lands;
    # the rounds' deliveries are exact
    smoke = ["sse_consumers", "ws_leg", "block_hits", "per_key_rereads", "metrics_sessions",
             "metrics_upstream_subs", "metrics_frames_encoded"]
    got = [({k: r[k] for k in keys}, {k: r["smoke"][k] for k in smoke},
            [(x["inv"], x["deliveries"], x["upstream"], x["system_delivery_ms"]["count"])
             for x in r["rounds"]]) for r in recs]
    assert got[0] == got[1], got
    port = recs[1]
    assert port["server_subscriptions"] == 2 * 64 and port["upstream_subs_per_edge"] == [64, 64]
    assert [x["deliveries"] for x in port["rounds"]] == [port["subscriptions"]] * 2
    assert all(d["kinds"] is not None for d in port["dispatches"].values())
    assert port["dispatches"]["rounds"]["kinds"]["lanes"]["dispatches"] == 2
    if plane["value_plane"] == "block":
        assert port["block_hits_measured"] == 2 * 2 * 64 and port["upstream_rpcs_per_burst"] == 0
    else:
        assert port["block_hits_total"] == 0 and port["upstream_rpcs_per_burst"] > 0
