"""Parity of the port's coalesced fan-out (``stl_fusion_tpu_torch/rpc/
fanout.py``: the ``ComputeFanoutIndex`` that drains a wave's newly set into
per-peer outboxes and the ``WaveValuePublisher``; ``rpc/outbox.py``) and
of the fan-out twin (``stl_fusion_tpu_torch/fanout_path.py``) with the JAX
package's.

- ``tests/test_fanout.py``: each case runs the reference test on both
  packages (``test_torch_rpc.run_both``: the reference's assertions on
  both, equal call results, errors and hub counters; the duplicate and
  reorder chaos case without the counters). Its dropped-frame chaos case
  polls until the clients converge, so what it reads depends on timing:
  each package's side runs as its own case (``test_torch_edge.run_side``).
- ``tests/test_value_plane.py`` drives the value plane through
  ``edge.EdgeNode``: each of its cases runs on both packages with the
  real ``EdgeNode`` (``test_torch_edge.run_case``: the reference's
  assertions, equal call results and errors, and equal hub and edge node
  counters where the traffic does not depend on timing; its chaos case,
  which polls until both edges converge, one side a package). Its server half
  also runs here through the client's ``capture_batch`` with publish
  entries and a recording ``value_plane_client``: the decoded value
  blocks, the fallback fences, the publisher's and the index's counters
  must be EQUAL.
- The twin at 20,000 nodes through both packages
  (``run_fanout(api=FanoutApi(<jax modules>))``): the fenced totals,
  ``burst_inv_total``, the frames of each mode, the union and the host-led
  leg's fenced (client, key) set must be EQUAL.

Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
import time

import jax.numpy as jnp
import numpy as np
import pytest

import stl_fusion_tpu.client as jclient
import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.diagnostics.clocksync as jclocksync
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu.rpc as jrpc
import stl_fusion_tpu.utils.serialization as jser
import stl_fusion_tpu_torch.client as pclient
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.diagnostics.clocksync as pclocksync
import stl_fusion_tpu_torch.graph as pgraph
import stl_fusion_tpu_torch.rpc as prpc
import stl_fusion_tpu_torch.utils.serialization as pser
from stl_fusion_tpu_torch.fanout_path import FanoutApi, port_api, run_fanout
from stl_fusion_tpu_torch.graph.synthetic import power_law_dag
from test_torch_edge import run_case, run_side
from test_torch_rpc import PACKAGES, run_both


@pytest.mark.parametrize("test", [
    "test_invalidation_rides_batch_frames_by_default", "test_many_keys_coalesce_into_few_frames",
    "test_batch_entry_for_unknown_call_is_ignored", "test_fanout_index_drains_newly_mask_to_batches",
    "test_coalesce_bump_epack_pairs_rules", "test_recompute_storm_flush_equivalent_to_sequential",
    "test_device_burst_fences_remote_table_subscribers", "test_monitor_exports_coalescer_counters",
    "test_wire_codec_transport_roundtrips",
])
def test_fanout_case(test):
    run_both("test_fanout", test)


@pytest.mark.parametrize("test", ["test_redelivered_result_version_mismatch_still_invalidate",
                                  "test_outbox_preserves_per_peer_fifo_across_reconnect"])
def test_fanout_reconnect_case(test):
    run_both("test_fanout", test, stats=False)


@pytest.mark.parametrize("coalesce", [True, False])
def test_batch_delivery_chaos_dup_reorder_converges(coalesce):
    run_both("test_fanout", "test_batch_delivery_chaos_dup_reorder_converges", stats=False,
             coalesce=coalesce)


@pytest.mark.parametrize("package", PACKAGES)
def test_dropped_batch_frame_converges_after_reconnect(package):
    run_side("test_fanout", "test_dropped_batch_frame_converges_after_reconnect", package)


# ---------------------------------------------------------------- value plane
PKGS = {"jax": (jcore, jgraph, jrpc, jclient, jser, {}),
        "port": (pcore, pgraph, prpc, pclient, pser, {"device": "cpu"})}
N_CHAIN = 32


class EdgeStub:
    """The ``value_plane_client`` an edge installs on its hub: records every
    value block (decoded) and every fallback fence routed to it."""

    def __init__(self, ser):
        self.loads, self.blocks, self.fences = ser.loads, [], []

    def on_value_block(self, peer, message):
        cids, vers, seqs, _causes, _t0s, offsets, blob = self.loads(message.argument_data)
        values = [self.loads(blob[a:b]) for a, b in zip(offsets, offsets[1:])]
        self.blocks.append(list(zip(cids, vers, seqs, values)))

    def on_block_fence(self, peer, call_id, cause, origin_ts):
        self.fences.append(call_id)


async def until(pred, timeout: float = 10.0) -> None:
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            raise AssertionError("condition not reached")
        await asyncio.sleep(0.005)


def wave_stack(pkg, **publisher_kw):
    """``tests/test_value_plane.py``'s publish-on-wave stack: a table-backed
    chain 0 → 1 → … → 31 on a graph backend, the fan-out index and the
    publisher on the server; one client hub with an :class:`EdgeStub`."""
    core, graph, rpc, client, ser, kw = PKGS[pkg]
    hub = core.FusionHub()
    backend = graph.TpuGraphBackend(hub, node_capacity=N_CHAIN + 8, edge_capacity=256, **kw)

    class Tbl(core.ComputeService):
        def __init__(self, h=None):
            super().__init__(h)
            self.base = np.arange(N_CHAIN, dtype=np.float32)

        def load(self, ids):
            return self.base[np.asarray(ids, dtype=np.int64)]

        @core.compute_method(table=core.TableBacking(rows=N_CHAIN, batch="load"))
        async def node(self, i: int) -> float:
            return float(self.base[i])

    svc = Tbl(hub)
    hub.add_service(svc, "tbl")
    table = core.memo_table_of(svc.node)
    block = backend.bind_table_rows(table)
    backend.declare_row_edges(block, np.arange(0, N_CHAIN - 1), block, np.arange(1, N_CHAIN))
    table.read_batch(np.arange(N_CHAIN))
    backend.flush()
    server_rpc = rpc.RpcHub("server")
    client.install_compute_call_type(server_rpc)
    server_rpc.add_service("tbl", svc)
    index = rpc.install_compute_fanout(server_rpc, backend)
    publisher = rpc.install_value_publisher(server_rpc, **publisher_kw)
    edge_rpc = rpc.RpcHub("edge")
    client.install_compute_call_type(edge_rpc)
    edge_rpc.value_plane_client = stub = EdgeStub(ser)
    rpc.RpcTestTransport(edge_rpc, server_rpc, wire_codec=True)
    proxy = client.compute_client("tbl", edge_rpc, core.FusionHub())
    return dict(core=core, hub=hub, backend=backend, svc=svc, table=table, block=block,
                server_rpc=server_rpc, index=index, publisher=publisher, edge_rpc=edge_rpc,
                stub=stub, proxy=proxy)


def observe(s):
    pub = {k: v for k, v in s["publisher"].stats().items() if k != "pressure"}
    idx = s["index"].stats()
    # versions are random LTags: the blocks compare by seq and value
    return {"blocks": [[(q, val) for _cid, _v, q, val in b] for b in s["stub"].blocks],
            "fences": len(s["stub"].fences), "publisher": pub,
            "index": {k: idx[k] for k in ("subscriptions", "drained_total", "published_diverted")},
            "fanout": {k: s["server_rpc"].fanout_stats()[k] for k in (
                "invalidations_posted", "batch_frames_sent", "batch_keys_sent")}}


def both_value_plane(scenario, **publisher_kw):
    """``scenario(s)`` on each package's wave stack, each on a fresh loop
    with the stack's hub as the default hub; observations EQUAL."""
    out = {}
    for pkg in PKGS:
        async def run():
            s = wave_stack(pkg, **publisher_kw)
            old = s["core"].set_default_hub(s["hub"])
            try:
                return await scenario(s)
            finally:
                s["publisher"].dispose()
                s["index"].dispose()
                await s["edge_rpc"].stop()
                await s["server_rpc"].stop()
                s["core"].set_default_hub(old)
        out[pkg] = asyncio.run(run())
    assert out["port"] == out["jax"], out
    return out["port"]


async def _arm(s, rows):
    """The edge's batched re-read with publish entries: every row's
    subscription becomes a standing publish registration."""
    got = await s["proxy"].capture_batch([("node", (r,), True) for r in rows])
    assert all(not isinstance(c, BaseException) for c in got), got
    await until(lambda: s["publisher"].stats()["standing_subs"] == len(rows))
    return got


def _rewarm(s):
    """A wave only drains newly invalid rows: refresh and clear first."""
    s["table"].read_batch(np.arange(N_CHAIN))
    s["backend"].flush()
    s["backend"].graph.clear_invalid()


def test_value_block_serves_wave_with_zero_rereads():
    async def scenario(s):
        rows = [5, 9]
        got = await _arm(s, rows)
        assert [c.value for c in got] == [5.0, 9.0]
        s["svc"].base = s["svc"].base + 100.0
        s["backend"].cascade_rows_batch(s["block"], [0])
        await until(lambda: sum(len(b) for b in s["stub"].blocks) >= 2)
        await until(lambda: s["index"].subscriptions == 2)
        first = observe(s)
        assert sorted(v for b in s["stub"].blocks for *_x, v in b) == [105.0, 109.0]
        _rewarm(s)
        s["svc"].base = s["svc"].base + 1.0
        s["backend"].cascade_rows_batch(s["block"], [0])
        await until(lambda: sum(len(b) for b in s["stub"].blocks) >= 4)
        return first, observe(s)
    both_value_plane(scenario)


def test_host_led_invalidation_drops_standing_and_fences_plain():
    async def scenario(s):
        got = await _arm(s, [7])
        with s["core"].invalidating():
            await s["svc"].node(7)
        await until(lambda: got[0].is_invalidated)
        assert s["publisher"].stats()["standing_subs"] == 0
        return observe(s)
    both_value_plane(scenario)


def test_non_graph_resident_key_declines_publish():
    async def scenario(s):
        class Counter(s["core"].ComputeService):
            def __init__(self, h=None):
                super().__init__(h)
                self.n = 0

            @s["core"].compute_method
            async def get(self, key: str) -> int:
                return self.n

        counter = Counter(s["core"].FusionHub())  # a hub with no graph backend
        s["server_rpc"].add_service("counter", counter)
        proxy = type(s["proxy"])("counter", s["edge_rpc"], s["core"].FusionHub())
        (c,) = await proxy.capture_batch([("get", ("x",), True)])
        await asyncio.sleep(0.05)
        assert s["publisher"].stats()["standing_subs"] == 0
        counter.n = 1
        with s["core"].invalidating():
            await counter.get("x")
        await until(lambda: c.is_invalidated)
        return observe(s)
    both_value_plane(scenario)


def test_round_budget_overflow_fences_plain_and_counts():
    async def scenario(s):
        await _arm(s, [4, 8, 12])
        s["backend"].cascade_rows_batch(s["block"], [0])
        await until(lambda: s["publisher"].stats()["overflow_fallbacks"] == 2)
        await until(lambda: sum(len(b) for b in s["stub"].blocks) == 1)
        await asyncio.sleep(0.05)
        return observe(s)
    both_value_plane(scenario, max_keys_per_round=1)


def test_block_bytes_bound_chunks_frames():
    async def scenario(s):
        await _arm(s, [3, 6, 9])
        s["backend"].cascade_rows_batch(s["block"], [0])
        await until(lambda: s["publisher"].stats()["blocks_sent"] == 3)
        # sent is not yet received: the third frame may still be on the wire
        await until(lambda: len(s["stub"].blocks) == 3)
        assert all(len(b) == 1 for b in s["stub"].blocks)
        return observe(s)
    both_value_plane(scenario, max_block_bytes=1)


def test_superseded_standing_sub_is_retired_on_rearm():
    async def scenario(s):
        await _arm(s, [10])
        # the edge re-reads the same key under a new call id (a reconnect or
        # an eviction): one standing sub remains, the newest
        again = await s["proxy"].capture_batch([("node", (10,), True)])
        await asyncio.sleep(0.05)
        assert s["publisher"].stats()["standing_subs"] == 1
        s["backend"].cascade_rows_batch(s["block"], [0])
        await until(lambda: sum(len(b) for b in s["stub"].blocks) >= 1)
        await asyncio.sleep(0.05)
        (cid, *_rest), = s["stub"].blocks[0]
        assert cid == again[0].call.call_id
        return observe(s)
    both_value_plane(scenario)


@pytest.mark.parametrize("test", [
    "test_partial_batch_failure_falls_back_per_key_and_is_counted",
    "test_value_block_serves_wave_with_zero_upstream_rpcs", "test_stale_block_entry_is_seq_gated",
    "test_block_budget_eviction_falls_back_to_reread",
    "test_host_led_invalidation_drops_standing_and_fences_plain",
    "test_wave_then_host_led_reshard_style_fence_falls_back",
    "test_reconnect_style_reread_supersedes_old_call_and_standing",
    "test_reshard_repin_invalidates_exactly_moved_block_entries",
])
def test_value_plane_edge_case(test):
    run_case("test_value_plane", test)


@pytest.mark.parametrize("package", PACKAGES)
def test_batched_reread_equivalent_to_per_key_under_chaos(package):
    run_side("test_value_plane", "test_batched_reread_equivalent_to_per_key_under_chaos", package)


# ---------------------------------------------------------------- the twin
TWIN = dict(n_nodes=20_000, clients=6, keys_per_client=4, rounds=2, groups=8,
            seeds_per_group=4, lone_samples=2, outside_keys=2)


def test_fanout_twin_matches_jax(monkeypatch):
    """``perf/fanout_path.py``'s scenario at 20,000 nodes (6 clients of 4
    keys and 2 keys outside the union, 8 groups of 4 deep seeds, both
    modes, the host-led leg, 2 lone samples a mode) through both packages
    from the same edge arrays: equal fences, frames, device waves by kind
    and delivery samples."""
    edges = power_law_dag(TWIN["n_nodes"], avg_degree=3, seed=7)
    japi = FanoutApi(jcore, jgraph, jrpc, jclient, {}, jnp.asarray, lambda: None, "jax")
    # one process, one clock: a connect's clock probe on a loaded CPU can
    # estimate an offset larger than a fence's delivery time, and the
    # delivery histogram's range guard then drops that sample; the
    # identity map keeps one sample a fence, so the counts compare exactly
    for clocksync in (jclocksync, pclocksync):
        monkeypatch.setattr(clocksync.ClockSync, "to_local", lambda self, ref, ts: ts)
    recs = [run_fanout(**TWIN, edges=edges, api=api) for api in (japi, port_api("cpu"))]
    keys = ["union", "outside_union", "subscriptions", "edges"] + [
        f"{m}_{k}" for m in ("perkey", "coalesced") for k in (
            "clients_fenced_total", "burst_inv_total", "batch_frames", "keys_per_frame",
            "invalidations_posted", "messages_sent")]
    # the device waves each leg dispatched (the flushes' expansions of the
    # re-subscriptions' recomputes included), by kind, with their seeds and
    # newly invalid rows; and the count of the system's own delivery samples
    dispatches = [[r[f"{m}_dispatches"] for m in ("perkey", "coalesced")]
                  + [r["host_led"]["dispatches"], r["lone_dispatches"]] for r in recs]
    delivered = [[r[f"{m}_system_delivery_ms"]["count"] for m in ("perkey", "coalesced")]
                 for r in recs]
    got = [({k: r[k] for k in keys}, r["host_led"]["fenced"], r["host_led"]["closure"],
            [(x["mode"], x["inv"], x["frames"], x["subscriptions"]) for x in r["rounds"]])
           for r in recs]
    assert got[0] == got[1], got
    assert dispatches[0] == dispatches[1], dispatches
    assert delivered[0] == delivered[1], delivered
    jax_rec, port_rec = recs
    assert port_rec["perkey_batch_frames"] == 0 and port_rec["coalesced_batch_frames"] > 0
    assert port_rec["host_led"]["fenced"] and port_rec["perkey_lone_ms_p50"] is not None
    assert all(d["kinds"] and d["flushes"] for d in dispatches[1]), dispatches
    assert all(d["kinds"]["lanes"]["dispatches"] == TWIN["rounds"] for d in dispatches[1][:2])
    assert delivered[1] == [port_rec["perkey_clients_fenced_total"],
                            port_rec["coalesced_clients_fenced_total"]], delivered
