"""Parity of the port's nonblocking wave pipeline (``graph/nonblocking.py``:
``WavePipeline``, the lane chain's dispatch and harvest) and its
burst→refresh chain (``cascade_rows_lanes_refresh_chain``) with the JAX
package's: the cases of ``tests/test_nonblocking.py`` that need no
watchdog, chaos or ``explain``, each run as one scenario through both packages on the
same numpy-made DAG (``power_law_dag(800, 3, seed=7)``, a table-backed
service) and the same seeded waves, with JAX's assertions held on both and
the results required EQUAL: per-wave counts, host and device invalid
masks, table values and staleness, the pipeline's counters. The fused
chain's invalid set is also held against JAX's host-BFS oracle
(``WaveWatchdog._host_closure``, run on the port's own host arrays). The
overlap case counts fences applied while another chain is in flight
through the port's RPC fan-out index (``ComputeFanoutIndex.
drained_overlapped``) over a client subscribed through the in-memory
transport, and the outbox case merges a batch post under one kick.

The watchdog's injected chain fault and degraded mode, the fused bursts
under seeded chaos and ``explain`` of a wave fused into a chain run the
reference tests themselves on both packages (``test_torch_edge.run_case``,
the port's source with the device loader's ``jnp.asarray`` made
``torch.from_numpy``): the reference's assertions, equal call results and
errors, and for the watchdog cases equal watchdog counters and bursts.
Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stl_fusion_tpu.client as jclient
import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu.rpc as jrpc
import stl_fusion_tpu_torch.client as pclient
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.graph as pgraph
import stl_fusion_tpu_torch.rpc as prpc
from stl_fusion_tpu.diagnostics import global_metrics as jax_metrics
from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu.resilience import WaveWatchdog
from stl_fusion_tpu_torch.diagnostics.metrics import global_metrics as port_metrics

N = 800
SRC, DST = power_law_dag(N, avg_degree=3, seed=7)

JAX = ("jax", jcore, jgraph, {}, jnp.asarray)
PORT = ("port", pcore, pgraph, {"device": "cpu"}, lambda a: torch.from_numpy(np.asarray(a)))


def make_stack(pkg, warm_device=False, build_mirror=True):
    """``tests/test_nonblocking.py``'s stack through one package."""
    _name, core, graph, kw, to_dev = pkg

    class Dag(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.base = np.arange(N, dtype=np.float32)
            self._base_dev = None

        def load(self, ids):
            return self.base[np.asarray(ids, dtype=np.int64)]

        def load_dev(self, ids, base_dev):
            return base_dev[ids]

        def load_dev_args(self):
            if self._base_dev is None:
                self._base_dev = to_dev(self.base)
            return (self._base_dev,)

        @core.compute_method(table=core.TableBacking(
            rows=N, batch="load", device_batch="load_dev", device_args="load_dev_args"))
        async def node(self, i: int) -> float:
            return float(self.base[i])

    hub = core.FusionHub()
    backend = graph.TpuGraphBackend(hub, node_capacity=N + 8, edge_capacity=len(SRC) + 512, **kw)
    svc = Dag(hub)
    hub.add_service(svc, "dag")
    table = core.memo_table_of(svc.node)
    block = backend.bind_table_rows(table)
    backend.declare_row_edges(block, SRC, block, DST)
    if warm_device:
        backend.warm_block_on_device(block)
    else:
        table.read_batch(np.arange(N))
    backend.flush()
    if build_mirror:
        backend.graph.build_topo_mirror()
    return hub, backend, svc, table, block


def wave_seeds(k, rng=None, seeds_per_wave=3):
    rng = rng if rng is not None else np.random.default_rng(20260803)
    return [rng.choice(N, size=seeds_per_wave, replace=False).tolist() for _ in range(k)]


def host_oracle_invalid_set(backend, wave_seed_lists):
    """JAX's host-BFS closure over the live edge set, applied per wave from
    an all-clear start (the function reads only the graph's host arrays,
    which both packages keep under the same names)."""
    graph = backend.graph
    invalid = np.zeros(graph.n_nodes, dtype=bool)
    for seeds in wave_seed_lists:
        invalid |= WaveWatchdog._host_closure(graph, [seeds], invalid)
    return invalid


def values(table):
    v = table._values
    return np.array(v.cpu() if isinstance(v, torch.Tensor) else v)


def state(backend, table):
    return {"h_invalid": backend.graph._h_invalid.copy(),
            "invalid": np.asarray(backend.graph.invalid_mask()),
            "values": values(table), "stale": table._stale_host.copy(),
            "stale_count": table.stale_count()}


def same(got, want):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, list) and w and isinstance(w[0], np.ndarray):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=key)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, (key, g, w)


def both(scenario, *args):
    """The scenario through JAX, then through the port; results EQUAL."""
    want, got = scenario(JAX, *args), scenario(PORT, *args)
    same(got, want)
    return got


# ---------------------------------------------------------------- oracle suite
@pytest.mark.parametrize("k", [1, 2, 8])
def test_fused_burst_invalid_set_matches_k_sequential_waves(k):
    """A fused chain of depth K leaves the identical invalid set (device and
    host mirror) as K sequential dispatches, and both match the host-BFS
    oracle."""
    seeds = wave_seeds(k)

    def scenario(pkg):
        _hub1, b1, _s1, _t1, blk1 = make_stack(pkg)
        seq_counts = [b1.cascade_rows_batch(blk1, w) for w in seeds]
        hub2, b2, _s2, t2, blk2 = make_stack(pkg)
        pipe = hub2.enable_nonblocking(fuse_depth=k)
        tickets = [pipe.submit_rows(blk2, w) for w in seeds]
        pipe.drain()
        assert pipe.stats()["eager_waves"] == 0  # the fused path served it
        for i, t in enumerate(tickets):
            assert t.done and t.count == seq_counts[i], (i, t.count, seq_counts[i])
        np.testing.assert_array_equal(b1.graph._h_invalid, b2.graph._h_invalid)
        np.testing.assert_array_equal(np.asarray(b1.graph.invalid_mask()),
                                      np.asarray(b2.graph.invalid_mask()))
        oracle = host_oracle_invalid_set(b2, seeds)
        np.testing.assert_array_equal(np.asarray(b2.graph.invalid_mask()), oracle)
        st = pipe.stats()
        return {"counts": [t.count for t in tickets], **state(b2, t2),
                "dispatches": st["fused_dispatches"], "harvests": st["harvests"]}

    got = both(scenario)
    assert got["dispatches"] == 1  # JAX's: one program for ≤ 8 waves


def test_fused_depth_identity_recorded():
    """A fused dispatch stamps a span of seqs, the profiler record carries
    fused_depth and seq_span, and the engagement histogram has p50 > 1."""

    def scenario(pkg):
        metrics = jax_metrics if pkg is JAX else port_metrics
        hub, backend, _svc, table, block = make_stack(pkg)
        hist = metrics().histogram("fusion_wave_fused_depth", unit="waves", lo=1.0, hi=4096.0)
        ck = hist.checkpoint()
        pipe = hub.enable_nonblocking(fuse_depth=4)
        tickets = [pipe.submit_rows(block, w) for w in wave_seeds(4)]
        pipe.drain()
        rec = backend.profiler.recent()[-1]
        assert rec["kind"] == "pipeline" and rec["fused_depth"] == 4
        s0, s1 = rec["seq_span"]
        assert s1 - s0 == 3
        assert [t.seq for t in tickets] == list(range(s0, s1 + 1))
        assert backend.profiler.summary()["fused_dispatches"] >= 1
        delta = hist.since(ck)
        assert delta["count"] >= 1 and delta["p50"] is not None and delta["p50"] > 1
        return {"counts": [t.count for t in tickets], "dispatches": rec["dispatches"],
                **state(backend, table)}

    both(scenario)


def test_accumulator_batches_submits_between_dispatches():
    """Submits below fuse_depth stay pending (no dispatch, rows still
    consistent) until an explicit drain."""

    def scenario(pkg):
        hub, backend, _svc, table, block = make_stack(pkg)
        pipe = hub.enable_nonblocking(fuse_depth=8)
        before = backend.graph.mirror_bursts
        for w in wave_seeds(3):
            pipe.submit_rows(block, w)
        assert pipe.stats()["pending_waves"] == 3
        assert backend.graph.mirror_bursts == before  # nothing dispatched
        assert table.stale_count() == 0  # nonblocking: not applied yet
        pipe.drain()
        assert pipe.stats()["pending_waves"] == 0
        assert table.stale_count() > 0
        return {"bursts": backend.graph.mirror_bursts - before, **state(backend, table)}

    both(scenario)


async def test_invalidate_eventually_rides_pipeline_and_falls_back():
    """With a pipeline attached the node stays consistent until the drain
    barrier; without one ``invalidate_eventually`` invalidates at once."""
    out = {}
    for pkg in (JAX, PORT):
        core = pkg[1]
        hub, backend, svc, table, block = make_stack(pkg)
        old = core.set_default_hub(hub)
        try:
            node = await core.capture(lambda: svc.node(5))
            assert node.is_consistent
            pipe = hub.enable_nonblocking(fuse_depth=8)
            assert hub.wave_pipeline is pipe and hub.enable_nonblocking() is pipe
            assert node.invalidate_eventually()
            assert node.is_consistent  # lazily accumulated, not applied
            pipe.drain()
            assert node.is_invalidated
            pipe.dispose()
            assert hub.wave_pipeline is None
            node2 = await core.capture(lambda: svc.node(700))
            assert node2.invalidate_eventually()
            assert node2.is_invalidated
            out[pkg[0]] = state(backend, table)
        finally:
            core.set_default_hub(old)
    same(out["port"], out["jax"])


def test_journal_entry_with_inflight_chain_forces_harvest_first():
    """A host-led table mark journaled while a chain is in flight: the next
    dispatch harvests the chain BEFORE flushing; the final state matches
    the sequential twin."""

    def scenario(pkg):
        hub, backend, _svc, table, block = make_stack(pkg)
        _hub2, b2, _s2, t2, blk2 = make_stack(pkg)
        pipe = hub.enable_nonblocking(fuse_depth=1)
        pipe.submit_rows(block, [0])  # depth 1: dispatches at once
        assert pipe.stats()["inflight_chains"] == 1
        row = int(DST[SRC == 0][0]) if (SRC == 0).any() else 1
        table.invalidate(np.array([row]))
        assert backend._journal  # the hazard's precondition (icasc pending)
        pipe.submit_rows(block, [5])  # must harvest chain 1 first
        pipe.drain()
        b2.cascade_rows_batch(blk2, [0])
        t2.invalidate(np.array([row]))
        b2.flush()
        b2.cascade_rows_batch(blk2, [5])
        np.testing.assert_array_equal(backend.graph._h_invalid, b2.graph._h_invalid)
        np.testing.assert_array_equal(np.asarray(backend.graph.invalid_mask()),
                                      np.asarray(b2.graph.invalid_mask()))
        return state(backend, table)

    both(scenario)


# ---------------------------------------------------------------- refresh chain
def test_refresh_chain_matches_sequential_burst_refresh_rounds():
    """cascade_rows_lanes_refresh_chain ≡ K rounds of (cascade_rows_lanes →
    refresh_block_on_device): per-burst counts, values, staleness and a
    consistent end state."""
    rng = np.random.default_rng(11)
    bursts = [[rng.choice(N, size=4, replace=False).tolist() for _ in range(40)]
              for _ in range(4)]

    def scenario(pkg):
        _hub1, b1, _s1, t1, blk1 = make_stack(pkg, warm_device=True)
        ref = []
        for burst in bursts:
            ref.append(b1.cascade_rows_lanes(blk1, burst))
            b1.refresh_block_on_device(blk1)
        _hub2, b2, _s2, t2, blk2 = make_stack(pkg, warm_device=True)
        got = b2.cascade_rows_lanes_refresh_chain(blk2, bursts)
        for i in range(len(bursts)):
            np.testing.assert_array_equal(ref[i], got[i])
        assert t2.stale_count() == 0
        assert not b2.graph._h_invalid.any()
        assert not np.asarray(b2.graph.invalid_mask()).any()
        np.testing.assert_array_equal(values(t1), values(t2))
        rec = b2.profiler.recent()[-1]
        assert rec["kind"] == "lanes_refresh_chain" and rec["fused_depth"] == 4
        assert rec["dispatches"] == 1 and b2.graph.last_lanes_info == {"depth": 4,
                                                                      "dispatches": 1}
        return {"counts": got, **state(b2, t2)}

    both(scenario)


def test_refresh_chain_nonblocking_ticket_overlap_window():
    """The nonblocking ticket: dispatch returns at once, harvest applies
    later, and a second harvest is refused."""
    rng = np.random.default_rng(13)
    bursts = [[rng.choice(N, size=4, replace=False).tolist() for _ in range(20)]
              for _ in range(2)]

    def scenario(pkg):
        _hub, backend, _svc, table, block = make_stack(pkg, warm_device=True)
        ticket = backend.cascade_rows_lanes_refresh_chain(block, bursts, nonblocking=True)
        assert not ticket.done
        per_burst = ticket.harvest()
        assert ticket.done and len(per_burst) == 2
        assert ticket.cleared_total > 0
        assert table.stale_count() == 0
        with pytest.raises(RuntimeError):
            ticket.harvest()
        return {"counts": per_burst, "cleared": ticket.cleared_total, **state(backend, table)}

    both(scenario)


# ---------------------------------------------------------------- fault path
def test_harvest_fault_contained_to_host_path(monkeypatch):
    """A fault in the readback half of the chain is contained: the waves
    re-run on the split host loop, and the final state matches the
    sequential twin."""
    seeds = wave_seeds(3, rng=np.random.default_rng(6))

    def scenario(pkg):
        _hub1, b1, _s1, _t1, blk1 = make_stack(pkg)
        for w in seeds:
            b1.cascade_rows_batch(blk1, w)
        hub2, b2, _s2, t2, blk2 = make_stack(pkg)
        pipe = hub2.enable_nonblocking(fuse_depth=8)
        cls = type(b2.graph)
        real = cls.harvest_waves_lanes_chain
        arm = {"fail": True}

        def flaky(self, pending):
            if arm.pop("fail", None):
                raise RuntimeError("injected harvest fault")
            return real(self, pending)

        monkeypatch.setattr(cls, "harvest_waves_lanes_chain", flaky)
        tickets = [pipe.submit_rows(blk2, w) for w in seeds]
        pipe.drain()
        monkeypatch.setattr(cls, "harvest_waves_lanes_chain", real)
        assert pipe.stats()["chain_faults"] == 1
        np.testing.assert_array_equal(b1.graph._h_invalid, b2.graph._h_invalid)
        return {"counts": [t.count for t in tickets], **state(b2, t2)}

    both(scenario)


# ---------------------------------------------------------------- overlap
def _rpc(pkg):
    """The package's ``rpc`` and ``client`` modules."""
    return (jrpc, jclient) if pkg is JAX else (prpc, pclient)


def _rpc_stack(pkg, build_mirror=True, fanout=True):
    """``tests/test_nonblocking.py``'s RPC stack (its explain services are
    A.8): the server serves the DAG (with a fan-out index unless
    ``fanout`` is False), one client over the in-memory transport with the
    wire codec."""
    rpc, client_mod = _rpc(pkg)
    hub, backend, svc, table, block = make_stack(pkg, build_mirror=build_mirror)
    server_rpc = rpc.RpcHub("server")
    client_mod.install_compute_call_type(server_rpc)
    server_rpc.add_service("dag", svc)
    if fanout:
        rpc.install_compute_fanout(server_rpc, backend)
    client_rpc = rpc.RpcHub("client")
    client_mod.install_compute_call_type(client_rpc)
    rpc.RpcTestTransport(client_rpc, server_rpc, wire_codec=True)
    client = client_mod.compute_client("dag", client_rpc, pkg[1].FusionHub())
    return hub, backend, table, block, server_rpc, client_rpc, client


async def test_overlap_drain_counts_fences_inside_flight_window():
    """With two chains in flight back to back, the first chain's fence
    drain runs while the second executes: the fan-out index counts it under
    ``drained_overlapped``, the pipeline reports overlap occupancy, and
    every subscribed client key is fenced."""
    out = {}
    for pkg in (JAX, PORT):
        core = pkg[1]
        hub, backend, table, block, server_rpc, client_rpc, client = _rpc_stack(pkg)
        try:
            keys = [N - 1 - i for i in range(3)]
            nodes = []
            for key in keys:
                assert await client.node(int(key)) == float(key)
                nodes.append(await core.capture(lambda key=key: client.node(int(key))))
            pipe = hub.enable_nonblocking(fuse_depth=1)
            # chain 1 fences the subscriptions (root seed); chain 2 dispatches
            # before chain 1 is harvested, so that harvest's drain runs in
            # chain 2's flight window
            pipe.submit_rows(block, [0])
            pipe.submit_rows(block, [1])
            pipe.drain()
            assert not backend.overlap_active
            index = server_rpc.compute_fanout
            assert index.drained_total >= len(keys)
            assert index.drained_overlapped >= 1, index.stats()
            st = pipe.stats()
            assert st["overlap_harvests"] >= 1
            assert pipe.overlap_occupancy() > 0.0
            await asyncio.wait_for(asyncio.gather(*(nd.when_invalidated() for nd in nodes)),
                                   10.0)
            out[pkg[0]] = {"index": {k: v for k, v in index.stats().items()},
                           "overlap_harvests": st["overlap_harvests"],
                           "harvests": st["harvests"], **state(backend, table)}
        finally:
            await client_rpc.stop()
            await server_rpc.stop()
    same(out["port"], out["jax"])


# ---------------------------------------------------------------- outbox batch
async def test_outbox_batch_post_merges_under_one_kick():
    """``PeerOutbox.post_invalidations``: N entries merge into the pending
    map (version-deduped, last wins) and flush as one batch frame."""
    out = {}
    for pkg in (JAX, PORT):
        core = pkg[1]
        _hub, _backend, _table, _block, server_rpc, client_rpc, client = _rpc_stack(
            pkg, build_mirror=False, fanout=False)
        try:
            assert await client.node(3) == 3.0
            node = await core.capture(lambda: client.node(3))
            (peer,) = server_rpc.peers.values()
            call_id = node.call.call_id
            peer.outbox.post_invalidations([
                (call_id, "@stale", None, None),
                (call_id, node.version.format(), None, None),  # last wins
            ])
            await asyncio.wait_for(node.when_invalidated(), 5.0)
            stats = peer.outbox.stats()
            assert stats["invalidations_posted"] >= 2
            assert stats["invalidations_coalesced"] >= 1
            assert stats["batch_frames_sent"] >= 1
            out[pkg[0]] = stats
        finally:
            await client_rpc.stop()
            await server_rpc.stop()
    assert out["port"] == out["jax"], out


# ---------------------------------------------------------------- the reference's own
#: the reference's device loader makes a jax array; the port's a tensor
TORCH_LOADER = [("            import jax.numpy as jnp\n", "            import torch\n"),
                ("self._base_dev = jnp.asarray(self.base)",
                 "self._base_dev = torch.from_numpy(self.base)")]


@pytest.mark.parametrize("test", ["test_mid_chain_injected_fault_degrades_to_split_host_path",
                                  "test_degraded_watchdog_routes_pipeline_to_host_loop"])
def test_watchdog_case(test):
    from test_torch_edge import run_case
    from test_torch_resilience import WATCHDOG, unions_recorded

    with unions_recorded():
        got = run_case("test_nonblocking", test, patches=TORCH_LOADER, recorded=WATCHDOG)
    assert got["WaveWatchdog"]


@pytest.mark.parametrize("k", [2, 8])
def test_fused_burst_under_seeded_chaos_converges(k):
    from test_torch_edge import run_case

    run_case("test_nonblocking", "test_fused_burst_under_seeded_chaos_converges", stats=False,
             patches=TORCH_LOADER, k=k)


@pytest.mark.parametrize("test", ["test_explain_names_logical_wave_inside_fused_chain",
                                  "test_explain_fused_wave_end_to_end_over_sys_d"])
def test_explain_case(test):
    from test_torch_edge import run_case

    run_case("test_nonblocking", test, patches=TORCH_LOADER)
