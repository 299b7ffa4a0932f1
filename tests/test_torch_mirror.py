"""Parity of the port's topo and lat mirrors (``DeviceGraph.build_topo_mirror``,
``run_waves_union(mirror="auto")``, ``TpuGraphBackend.build_topo_mirror``)
with the JAX package's: the same op sequence runs on both, and every burst's
count and newly ids, the invalid masks (device and host) and the route
counters must be identical, through structural changes the patch log splices
into the mirror and through ones that make it stale. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import numpy as np
import pytest

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.graph as pgraph
from stl_fusion_tpu.graph.device_graph import DeviceGraph as JaxDeviceGraph
from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu_torch.graph import DeviceGraph


def _pair(n, seed, extra_edges=256):
    src, dst = power_law_dag(n, avg_degree=3.0, seed=seed)
    graphs = (JaxDeviceGraph(n, len(src) + extra_edges),
              DeviceGraph(n, len(src) + extra_edges, device="cpu"))
    for g in graphs:
        g.add_nodes(n)
        g.add_edges(src, dst)
    return graphs, src, dst


def _union(graphs, seeds, ordered=True, **kw):
    """One burst on both; ids in the same order (ascending from the lat and
    dense routes, topo-row order from the sweep) unless the two took
    different routes or mirrors (``ordered=False``)."""
    (jc, jids), (pc, pids) = (g.run_waves_union([seeds], **kw) for g in graphs)
    assert pc == jc
    if not ordered:
        pids, jids = np.sort(pids), np.sort(jids)
    np.testing.assert_array_equal(pids, jids)
    jg, pg = graphs
    np.testing.assert_array_equal(pg.invalid_mask(), jg.invalid_mask())
    np.testing.assert_array_equal(pg._h_invalid[: pg.n_nodes], jg._h_invalid[: jg.n_nodes])
    return pc


def _routes(g):
    return g.mirror_bursts, g.lat_waves


@pytest.mark.parametrize("seed", [3, 8])
def test_topo_and_lat_routes_match_jax(seed):
    graphs, _, _ = _pair(800, seed)
    jg, pg = graphs
    for g in graphs:
        g.build_topo_mirror()
    assert pg.mirror_rebuilds == 1 and pg._topo_mirror["lat"] is not None
    rng = np.random.default_rng(seed)
    for trial in range(8):
        size = int(rng.integers(1, 5)) if trial % 2 == 0 else 300  # lat, then topo sized
        seeds = rng.choice(800, size=size, replace=False).tolist()
        before = _routes(pg)
        _union(graphs, seeds)
        assert _routes(pg) == _routes(jg)
        want_lat = 1 if size <= DeviceGraph.LAT_SEED_MAX else 0
        assert _routes(pg) == (before[0] + 1, before[1] + want_lat)
        if trial == 3:
            for g in graphs:
                g.clear_invalid()
    assert pg.lat_waves >= 4 and pg.mirror_bursts == 8


def test_wide_mirror_k8_matches_jax():
    """ROADMAP C.2: ``build_topo_mirror(k=8)`` gives rows of k = 8 + 2 slack
    = 10 in-slots (past the card kernel's 8-slot chunk); topo-sized and
    lat-sized bursts, before and after a patched recompute, equal JAX's."""
    graphs, src, dst = _pair(1500, 21)
    jg, pg = graphs
    for g in graphs:
        g.build_topo_mirror(k=8)
    assert pg._topo_mirror["h_in_src"].shape[1] == 10
    rng = np.random.default_rng(21)
    for trial in range(6):
        if trial == 3:
            for g in graphs:  # a recompute with its in-edges recaptured, patched in
                v = int(dst[len(dst) // 2])
                g.bump_epochs(np.array([v], np.int32))
                g.add_edges(src[dst == v], dst[dst == v])
        size = 3 if trial % 3 == 2 else 400
        _union(graphs, rng.choice(1500, size=size, replace=False).tolist())
        assert _routes(pg) == _routes(jg)
        for g in graphs:
            g.clear_invalid()
    assert pg.mirror_patches == jg.mirror_patches == 1
    assert pg.mirror_rebuilds == jg.mirror_rebuilds == 1


def test_pre_invalid_seeds_conduct_on_both_routes():
    graphs, src, _ = _pair(300, 5)
    for g in graphs:
        g.build_topo_mirror()
    assert _union(graphs, [7]) >= 1
    assert _union(graphs, [7]) == 0  # idempotent: conducts, nothing newly
    downstream = np.nonzero(graphs[1].invalid_mask())[0]
    downstream = downstream[downstream != 7][:1]
    for g in graphs:
        g.clear_invalid_ids(downstream)
        g.mark_invalid(np.array([3, 4]))
    assert _union(graphs, [7]) == len(downstream)  # the lat route
    assert _union(graphs, list(range(7, 300))) > 0  # the topo route, 293 seeds
    assert _routes(graphs[1]) == _routes(graphs[0]) == (4, 3)


def test_stale_mirror_serves_dense_then_rebuild_rides_again():
    graphs, src, dst = _pair(600, 13)
    jg, pg = graphs
    for g in graphs:
        g.build_topo_mirror()
    rng = np.random.default_rng(1)
    _union(graphs, [int(rng.integers(600))])
    # live edges appended: both mirrors patch them in and keep serving
    for g in graphs:
        g.clear_invalid()
        g.add_edges(np.array([10, 20]), np.array([590, 595]))
    before = _routes(pg)
    _union(graphs, [10], ordered=False)
    assert _routes(pg) == _routes(jg) == (before[0] + 1, before[1] + 1)
    assert pg.mirror_patches == jg.mirror_patches == 1
    # an edge into a node born after the build breaks the log: the mirror is
    # stale and the dense path serves, on both
    for g in graphs:
        g.clear_invalid()
        g.add_nodes(1)
        g.add_edges(np.array([5]), np.array([600]))
    assert not pg._mirror_valid() and not jg._mirror_valid()
    before = _routes(pg)
    _union(graphs, [10], ordered=False)
    _union(graphs, rng.choice(600, 300, replace=False).tolist(), ordered=False)
    assert _routes(pg) == _routes(jg) == before
    # epoch bumps kill live in-edges: still stale, still the same answers
    for g in graphs:
        g.clear_invalid()
        g.bump_epochs(np.array([30, 31, 32, 590]))
    _union(graphs, [0, 1], ordered=False)
    assert _routes(pg) == before
    # a rebuild rides again; compaction drops only dead edges: the live set,
    # and so validity, stand
    for g in graphs:
        g.build_topo_mirror()
        g.clear_invalid()
        g.compact()
    assert pg.mirror_rebuilds == jg.mirror_rebuilds == 2 and pg._mirror_valid()
    _union(graphs, [0, 1], ordered=False)
    _union(graphs, rng.choice(600, 300, replace=False).tolist(), ordered=False)
    assert _routes(pg) == _routes(jg) == (before[0] + 2, before[1] + 1)
    # an unchanged live set keeps the built mirror
    assert pg.build_topo_mirror() is pg._topo_mirror and pg.mirror_rebuilds == 2


def test_lat_overflow_falls_back_to_the_sweep(monkeypatch):
    graphs, src, dst = _pair(2000, 7)
    monkeypatch.setattr(DeviceGraph, "LAT_CAP", 32)
    monkeypatch.setattr(JaxDeviceGraph, "LAT_CAP", 32)
    for g in graphs:
        g.build_topo_mirror()
    assert _union(graphs, [0]) > 32  # a low id: a wide closure
    assert _routes(graphs[1]) == _routes(graphs[0]) == (1, 0)


def test_off_and_out_of_range_seeds_take_the_dense_path():
    graphs, _, _ = _pair(500, 2)
    jg, pg = graphs
    for g in graphs:
        g.build_topo_mirror()
    _union(graphs, [3, 4], mirror="off")
    assert _routes(pg) == (0, 0)
    for g in graphs:  # capacity past n_nodes: only the dense path can represent it
        g.clear_invalid()
    _union(graphs, [3, pg.n_cap - 1])
    assert _routes(pg) == _routes(jg) == (0, 0)
    with pytest.raises(ValueError, match="mirror"):
        pg.run_waves_union([[0]], mirror="on")


def _world(core, graph, **backend_kw):
    class Products(core.ComputeService):
        def __init__(self, hub):
            super().__init__(hub)
            self.price = {"apple": 2.0, "banana": 0.5, "cherry": 4.0}

        @core.compute_method
        async def get(self, pid: str) -> float:
            return self.price[pid]

    class Carts(core.ComputeService):
        def __init__(self, hub, products):
            super().__init__(hub)
            self.products = products
            self.items = {"alice": ("apple", "apple", "banana"), "bob": ("banana", "cherry")}

        @core.compute_method
        async def total(self, cart: str) -> float:
            return sum([await self.products.get(p) for p in self.items[cart]])

        @core.compute_method
        async def grand_total(self) -> float:
            return await self.total("alice") + await self.total("bob")

    hub = core.FusionHub()
    backend = graph.TpuGraphBackend(hub, **backend_kw)
    products = Products(hub)
    return backend, products, Carts(hub, products)


async def _backend_scenario(core, graph, kw):
    backend, products, carts = _world(core, graph, **kw)
    out = {"grand": await carts.grand_total()}
    backend.build_topo_mirror()
    c_banana = await core.capture(lambda: products.get("banana"))
    c_grand = await core.capture(lambda: carts.grand_total())
    c_alice = await core.capture(lambda: carts.total("alice"))
    c_grand.on_invalidated(lambda c: None)
    products.price["banana"] = 1.0
    out["batch"] = backend.invalidate_cascade_batch([c_banana])  # the lat route
    out["routes"] = _routes(backend.graph)
    out["states"] = [int(c._state) for c in (c_banana, c_alice, c_grand)]
    out["pending"] = backend._pending[: backend.node_count].copy()
    out["mask"] = backend.graph.invalid_mask().copy()
    # the recompute recaptures the same edges at new epochs: both patch the
    # bumps and the recaptured edges into the mirror and ride it
    out["grand2"] = await carts.grand_total()
    c_cherry = await core.capture(lambda: products.get("cherry"))
    products.price["cherry"] = 2.0
    out["batch2"] = backend.invalidate_cascade_batch([c_cherry])
    out["routes2"] = _routes(backend.graph)
    out["grand3"] = await carts.grand_total()
    return out


async def test_backend_mirror_matches_jax():
    jout = await _backend_scenario(jcore, jgraph, {})
    pout = await _backend_scenario(pcore, pgraph, {"device": "cpu"})
    assert pout["routes"] == jout["routes"] == (1, 1)
    assert pout["routes2"] == jout["routes2"] == (2, 2)
    for key in jout:
        if isinstance(jout[key], np.ndarray):
            np.testing.assert_array_equal(pout[key], jout[key], err_msg=key)
        else:
            assert pout[key] == jout[key], key
    assert pout["batch"] == 4  # banana → alice, bob → grand
    assert pout["grand3"] == (2.0 + 2.0 + 1.0) + (1.0 + 2.0)
