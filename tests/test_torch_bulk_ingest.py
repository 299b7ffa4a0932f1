"""Parity of the port's row-block backend with the JAX package's: the cases
of ``tests/test_bulk_ingest.py`` (bind, bulk-declared edges, row cascades,
host-led invalidation that cascades, scalar adoption and the re-declare on
recompute, lane bursts against a dense oracle, partial binds, the
declared-edge rewire, the device loader's warm and refresh, sequenced row
waves), each run as one scenario through both packages with the same
assertions, and their counts, stale sets, table values and device invalid
masks required EQUAL. ``test_monitor_counts_no_phantom_hits_on_misses``
runs the reference test on both packages (``test_torch_edge.run_case``).
Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.graph as pgraph
from stl_fusion_tpu.ops.memo_table import MemoTable as JaxTable
from stl_fusion_tpu_torch.ops.memo_table import MemoTable as PortTable


class Pkg:
    def __init__(self, name):
        port = name == "port"
        self.name = name
        self.core = pcore if port else jcore
        self.graph = pgraph if port else jgraph
        self.Table = PortTable if port else JaxTable
        self.kw = {"device": "cpu"} if port else {}
        self.to_device = (lambda a: torch.from_numpy(np.asarray(a))) if port else jnp.asarray

    def backend(self, hub, **kw):
        return self.graph.TpuGraphBackend(hub, **kw, **self.kw)

    def table(self, n, fn, **kw):
        return self.Table(n, fn, **kw, **self.kw)


JAX, PORT = Pkg("jax"), Pkg("port")


def arr(x):
    """A numpy COPY (a CPU tensor's numpy view would follow later in-place
    updates)."""
    return np.array(x.cpu() if isinstance(x, torch.Tensor) else x)


def same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, "shape"):
        np.testing.assert_array_equal(arr(a), arr(b))
    else:
        assert a == b, (a, b)


def both(scenario):
    got = [scenario(pk) for pk in (JAX, PORT)]
    same(*got)
    return got


async def both_async(scenario):
    got = [await scenario(pk) for pk in (JAX, PORT)]
    same(*got)
    return got


def state(backend, table):
    """What the two packages must agree on after a step."""
    return {"stale": table._stale_host.copy(), "stale_count": table.stale_count(),
            "invalid": backend.graph.invalid_mask(), "h_invalid": backend.graph._h_invalid.copy(),
            "values": arr(table.values), "version": table.version}


def chain_service(pk, n=64, rows=64):
    core = pk.core

    class Chain(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.db = {i: float(i) for i in range(n)}
            self.loads = 0

        def load(self, ids):
            self.loads += len(ids)
            return np.array([self.db[int(i)] for i in ids], dtype=np.float32)

        @core.compute_method(table=core.TableBacking(rows=rows, batch="load"))
        async def val(self, i: int) -> float:
            return self.db[i]

    return Chain


def bound_chain(pk, n=64):
    hub = pk.core.FusionHub()
    backend = pk.backend(hub, node_capacity=256, edge_capacity=1024)
    svc = chain_service(pk, n)(hub)
    hub.add_service(svc)
    table = pk.core.memo_table_of(svc.val)
    block = backend.bind_table_rows(table)
    backend.declare_row_edges(block, np.arange(n - 1), block, np.arange(1, n))
    return hub, backend, svc, table, block


def test_bind_allocates_contiguous_block_and_flushes_edges():
    def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        assert block.n_rows == 64 and backend.node_count == 64
        backend.flush()
        assert backend.edge_count == 63
        return block.base, backend.node_count, backend.edge_count
    both(run)


def test_cascade_rows_batch_reaches_transitive_dependents():
    def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        table.read_batch(np.arange(64))
        assert table.stale_count() == 0
        total = backend.cascade_rows_batch(block, [10])
        assert total == 54 and table.stale_count() == 54
        np.testing.assert_array_equal(np.nonzero(table._stale_host)[0], np.arange(10, 64))
        s1 = state(backend, table)
        svc.db[10] = 100.0
        vals = arr(table.read_batch([10, 63]))
        assert vals[0] == 100.0
        table.read_batch(np.arange(64))
        assert table.stale_count() == 0
        backend.flush()
        assert not backend.graph.invalid_mask().any()
        again = backend.cascade_rows_batch(block, [62])
        assert again == 2
        return total, s1, vals, again, state(backend, table)
    both(run)


def test_host_led_table_invalidate_mirrors_and_cascades():
    def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        table.read_batch(np.arange(64))
        table.invalidate([5, 7])
        backend.flush()
        mask = backend.graph.invalid_mask()
        assert mask[5] and mask[7] and mask[6] and mask[63]
        assert mask.sum() == 59 and not mask[:5].any()
        return state(backend, table)
    both(run)


async def test_scalar_adoption_shares_row_node():
    async def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        old = pk.core.set_default_hub(hub)
        try:
            table.read_batch(np.arange(64))
            assert await svc.val(20) == 20.0
            node = await pk.core.capture(lambda: svc.val(20))
            assert backend.id_for(node) == block.base + 20
            assert backend.node_count == 64
            total = backend.cascade_rows_batch(block, [19])
            assert not node.is_consistent
            assert table._stale_host[19] and table._stale_host[20]
            return total, state(backend, table)
        finally:
            pk.core.set_default_hub(old)
    await both_async(run)


async def test_scalar_recompute_redeclares_row_in_edges():
    async def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        old = pk.core.set_default_hub(hub)
        try:
            table.read_batch(np.arange(64))
            assert await svc.val(30) == 30.0
            svc.db[30] = 300.0
            with pk.core.invalidating():
                await svc.val(30)
            assert await svc.val(30) == 300.0
            node = await pk.core.capture(lambda: svc.val(30))
            total = backend.cascade_rows_batch(block, [29])
            assert not node.is_consistent, "declared in-edge died on recompute"
            assert table._stale_host[30]
            return total, state(backend, table), backend.graph._h_node_epoch[:64].copy()
        finally:
            pk.core.set_default_hub(old)
    await both_async(run)


def chain_n_service(pk, n=200):
    core = pk.core

    class ChainN(core.ComputeService):
        def load(self, ids):
            return np.asarray(ids, dtype=np.float32)

        @core.compute_method(table=core.TableBacking(rows=n, batch="load"))
        async def val(self, i: int) -> float:
            return float(i)

    return ChainN


def test_cascade_rows_lanes_matches_dense_oracle():
    rng = np.random.default_rng(3)
    n = 200
    dst = rng.integers(1, n, size=400)
    src = (rng.random(400) * dst).astype(np.int64)
    groups = [rng.choice(n, size=4, replace=False).tolist() for _ in range(40)]

    adj_starts = np.zeros(n + 1, dtype=np.int64)
    np.add.at(adj_starts[1:], src, 1)
    adj_starts = np.cumsum(adj_starts)
    adj_dst = dst[np.argsort(src, kind="stable")]

    def bfs(seeds):
        seen = np.zeros(n, dtype=bool)
        frontier = list(seeds)
        seen[frontier] = True
        while frontier:
            nxt = []
            for u in frontier:
                for v in adj_dst[adj_starts[u]: adj_starts[u + 1]]:
                    if not seen[v]:
                        seen[v] = True
                        nxt.append(int(v))
            frontier = nxt
        return int(seen.sum())

    def run(pk):
        hub = pk.core.FusionHub()
        backend = pk.backend(hub, node_capacity=512, edge_capacity=2048)
        svc = chain_n_service(pk, n)(hub)
        hub.add_service(svc)
        table = pk.core.memo_table_of(svc.val)
        block = backend.bind_table_rows(table)
        backend.declare_row_edges(block, src, block, dst)
        table.read_batch(np.arange(n))
        counts = backend.cascade_rows_lanes(block, groups)
        for gi, g in enumerate(groups):
            assert counts[gi] == bfs(g), (gi, counts[gi], bfs(g))
        assert table.stale_count() == int(backend.graph.invalid_mask().sum())
        return counts, state(backend, table)
    both(run)


def test_bulk_ingest_throughput_smoke():
    """Building a 100K-node graph through the bound-table path takes array
    time, not object time; both packages build the same graph."""
    import time

    n = 100_000
    rng = np.random.default_rng(0)
    dst = rng.integers(1, n, size=3 * n)
    src = (rng.random(3 * n) * dst).astype(np.int64)

    def run(pk):
        hub = pk.core.FusionHub()
        backend = pk.backend(hub, node_capacity=n, edge_capacity=4 * n)
        table = pk.table(n, lambda ids: np.asarray(ids, dtype=np.float32))
        t0 = time.perf_counter()
        block = backend.bind_table_rows(table)
        backend.declare_row_edges(block, src, block, dst)
        table.read_batch(np.arange(n))
        backend.flush()
        rate = n / (time.perf_counter() - t0)
        assert backend.node_count == n and backend.edge_count == 3 * n
        assert table.stale_count() == 0
        assert rate > 100_000, f"{pk.name}: bulk ingest ran at {rate:.0f} nodes/s"
        m = backend.graph.n_edges
        return (backend.graph._h_edge_src[:m].copy(), backend.graph._h_edge_dst[:m].copy(),
                arr(table.values))
    both(run)


def test_partial_bind_guards_out_of_block_rows():
    def run(pk):
        hub = pk.core.FusionHub()
        backend = pk.backend(hub, node_capacity=64, edge_capacity=64)
        table = pk.table(8, lambda ids: np.asarray(ids, dtype=np.float32))
        block = backend.bind_table_rows(table, n_rows=4)
        other = backend.graph.add_nodes(4)
        backend._ensure_host_masks()
        table.read_batch(np.arange(8))
        table.invalidate([2, 6])
        backend.flush()
        mask = backend.graph.invalid_mask()
        assert mask[block.base + 2]
        assert not mask[other].any(), "out-of-block row corrupted a foreign node"
        backend.graph.mark_invalid(np.array([other[1]]))
        table.invalidate([5])
        table.read_batch([5])
        backend.flush()
        assert backend.graph.invalid_mask()[other[1]], "foreign invalid bit cleared"
        with pytest.raises(ValueError, match="FULL table bind"):
            table.device_compute_fn = lambda ids: ids
            backend.refresh_block_on_device(block)
        return state(backend, table)
    both(run)


def test_cascade_rows_rejects_out_of_range():
    def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        with pytest.raises(ValueError):
            backend.cascade_rows_batch(block, [64])
        with pytest.raises(ValueError):
            backend.cascade_rows_lanes(block, [[0], [-1]])
        with pytest.raises(ValueError):
            backend.cascade_rows_batch_seq(block, [[0], [64]])
        with pytest.raises(ValueError):
            backend.declare_row_edges(block, [0, 1], block, [2])
        return backend.node_count
    both(run)


def test_clear_declared_row_edges_redeclares():
    def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        table.read_batch(np.arange(64))
        backend.clear_declared_row_edges(block, [40])
        backend.declare_row_edges(block, np.array([10]), block, np.array([40]))
        backend.flush()
        total = backend.cascade_rows_batch(block, [39])
        assert not table._stale_host[40]
        s1 = state(backend, table)
        total2 = backend.cascade_rows_batch(block, [10])
        assert table._stale_host[40] and table._stale_host[63]
        starts, src, _included = block._declared_csr()
        s, e = int(starts[40]), int(starts[41])
        assert e - s == 1 and int(src[s]) == block.base + 10
        return total, total2, s1, state(backend, table), block.declared_in_srcs(block.base + 41)
    both(run)


def test_host_led_invalidate_cascades_to_declared_dependents():
    def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        table.read_batch(np.arange(64))
        table.invalidate([10])
        svc.db[10] = 100.0
        table.read_batch([10])
        backend.flush()
        assert not table._stale_host[10]
        assert table._stale_host[11] and table._stale_host[63]
        mask = backend.graph.invalid_mask()
        assert mask[11] and mask[63]
        s1 = state(backend, table)
        backend.graph.clear_invalid()
        table.read_batch(np.nonzero(table._stale_host)[0])
        table.invalidate([20])
        backend.flush()
        assert backend.cascade_rows_batch(block, [20]) == 0
        assert table._stale_host[21] and table._stale_host[63]
        return s1, state(backend, table)
    both(run)


def test_icasc_mark_refresh_then_upstream_mark_in_one_flush():
    def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        table.read_batch(np.arange(64))
        table.invalidate([10])
        svc.db[10] = 100.0
        table.read_batch([10])
        table.invalidate([9])
        backend.flush()
        assert table._stale_host[10], "refreshed row escaped its dependency's cascade"
        assert table._stale_host[11] and table._stale_host[63]
        mask = backend.graph.invalid_mask()
        assert mask[10] and mask[9]
        return state(backend, table)
    both(run)


def test_hot_cache_evicts_collected_entries():
    """Dead weakrefs of the per-service hot cache do not accumulate."""
    def run(pk):
        async def go():
            hub = pk.core.FusionHub()
            old = pk.core.set_default_hub(hub)
            try:
                class S(pk.core.ComputeService):
                    @pk.core.compute_method
                    async def get(self, k: int) -> int:
                        return k

                svc = S(hub)
                for i in range(64):
                    await svc.get(i)
                hot_attr = [a for a in svc.__dict__ if a.startswith("_fusion_hot_")][0]
                hot = svc.__dict__[hot_attr]
                n_hot = len(hot)
                hub.timeouts.clear() if hasattr(hub.timeouts, "clear") else None
                gc.collect()
                dead = [k for k, r in hot.items() if r() is None]
                assert not dead, f"{len(dead)} dead hot entries leaked"
                return n_hot
            finally:
                pk.core.set_default_hub(old)
        return asyncio.run(go())
    assert both(run)[0] == 64


def dev_service(pk, n):
    core = pk.core

    class DevSvc(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.base = np.arange(n, dtype=np.float32)
            self._dev = pk.to_device(self.base)

        def load(self, ids):
            return self.base[np.asarray(ids, dtype=np.int64)]

        def load_dev(self, ids, base_dev):
            return base_dev[ids] * 2.0

        def dev_args(self):
            return (self._dev,)

        @core.compute_method(table=core.TableBacking(
            rows=n, batch="load", device_batch="load_dev", device_args="dev_args"))
        async def val(self, i: int) -> float:
            return float(self.base[i])

    return DevSvc


async def test_device_loader_warm_and_refresh():
    """``TableBacking(device_batch=...)``: the cold-start warm and the
    stale-row recompute run on the device, with host bookkeeping matching
    the host path."""
    n = 64

    async def run(pk):
        hub = pk.core.FusionHub()
        old = pk.core.set_default_hub(hub)
        try:
            backend = pk.backend(hub, node_capacity=n, edge_capacity=8 * n)
            svc = dev_service(pk, n)(hub)
            hub.add_service(svc)
            table = pk.core.memo_table_of(svc.val)
            block = backend.bind_table_rows(table)
            backend.declare_row_edges(block, np.arange(n - 1), block, np.arange(1, n))
            assert backend.warm_block_on_device(block) == n
            assert table.stale_count() == 0
            np.testing.assert_allclose(arr(table.values), svc.base * 2.0)
            s0 = state(backend, table)
            svc._dev = pk.to_device(svc.base + 100.0)
            total = backend.cascade_rows_batch(block, [50])
            assert total == 14 and table.stale_count() == 14
            assert backend.refresh_block_on_device(block) == 14
            assert table.stale_count() == 0
            vals = arr(table.values)
            np.testing.assert_allclose(vals[:50], svc.base[:50] * 2.0)
            np.testing.assert_allclose(vals[50:], (svc.base[50:] + 100.0) * 2.0)
            assert not backend.graph.invalid_mask().any()
            assert not backend.graph._h_invalid.any()
            with pytest.raises(RuntimeError, match="outstanding invalid"):
                backend.cascade_rows_batch(block, [60])
                backend.warm_block_on_device(block)
            return s0, total, state(backend, table), arr(table.valid_mask)
        finally:
            pk.core.set_default_hub(old)
    await both_async(run)


async def test_cascade_rows_batch_seq_matches_sequential_hub_level():
    n = 200

    async def run(pk):
        hub = pk.core.FusionHub()
        old = pk.core.set_default_hub(hub)
        try:
            backend = pk.backend(hub, node_capacity=n, edge_capacity=8 * n)
            svc = chain_n_service(pk, n)(hub)
            hub.add_service(svc)
            table = pk.core.memo_table_of(svc.val)
            block = backend.bind_table_rows(table)
            backend.declare_row_edges(block, np.arange(n - 1), block, np.arange(1, n))
            table.read_batch(np.arange(n))
            backend.flush()
            backend.graph.build_topo_mirror()
            counts = backend.cascade_rows_batch_seq(block, [[150], [100], [150]])
            assert counts.tolist() == [50, 50, 0]
            assert table.stale_count() == 100
            assert bool(table._stale_host[100]) and not bool(table._stale_host[99])
            return counts, state(backend, table), backend.graph.lat_waves
        finally:
            pk.core.set_default_hub(old)
    await both_async(run)


def test_cascade_rows_batch_sharded_matches_dense():
    """Table rows seeding a union wave on a one-shard mesh (the JAX side on
    its first CPU device) land like ``cascade_rows_batch``."""
    from stl_fusion_tpu.parallel.mesh import graph_mesh as jax_mesh
    from stl_fusion_tpu_torch.parallel import graph_mesh

    def run(pk):
        hub, backend, svc, table, block = bound_chain(pk)
        table.read_batch(np.arange(64))
        mesh = graph_mesh(1, device="cpu") if pk is PORT else jax_mesh(1)
        total = backend.cascade_rows_batch_sharded(block, [40], mesh=mesh)
        assert total == 24 and table.stale_count() == 24
        return total, state(backend, table)
    both(run)


def test_monitor_counts_no_phantom_hits_on_misses():
    from test_torch_edge import run_case

    run_case("test_bulk_ingest", "test_monitor_counts_no_phantom_hits_on_misses")
