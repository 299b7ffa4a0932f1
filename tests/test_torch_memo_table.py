"""Parity of the port's columnar memo table with the JAX package's: the 23
cases of ``tests/test_memo_table.py`` (reads, refresh, invalidation, the
packed validity bits, the scalar-graph bridge, transparent table backing
and the key codec), each run as one scenario through both packages, with
the same assertions on each and their observations (values, loader calls,
stale counts, versions) required EQUAL; device-resident ids are a CPU
tensor on the port. Plus a JAX table's ``export_state`` loaded into a port
table, and the port's tables on ``cuda`` by default. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu_torch.core as pcore
from stl_fusion_tpu.ops.memo_bridge import MemoTableBridge as JaxBridge
from stl_fusion_tpu.ops.memo_table import MemoTable as JaxTable
from stl_fusion_tpu_torch.ops.memo_bridge import MemoTableBridge as PortBridge
from stl_fusion_tpu_torch.ops.memo_table import MemoTable as PortTable


class Pkg:
    """One package's API as the scenarios use it: the port's tables and
    backings live on the CPU, its device ids are CPU tensors."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.core = pcore if port else jcore
        self.Table = PortTable if port else JaxTable
        self.Bridge = PortBridge if port else JaxBridge
        self.kw = {"device": "cpu"} if port else {}
        self.device_ids = (lambda a: torch.from_numpy(np.asarray(a, np.int32))) if port \
            else (lambda a: jnp.asarray(np.asarray(a, np.int32)))

    def table(self, n, fn, **kw):
        return self.Table(n, fn, **kw, **self.kw)

    def backing(self, **kw):
        return self.core.TableBacking(**kw, **self.kw)


JAX, PORT = Pkg("jax"), Pkg("port")


def arr(x):
    """A numpy COPY (a CPU tensor's numpy view would follow later in-place
    updates)."""
    return np.array(x.cpu() if isinstance(x, torch.Tensor) else x)


def same(a, b):
    """Deep equality of two scenarios' observations (arrays exact)."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, "shape"):
        x, y = arr(a), arr(b)
        assert x.shape == y.shape and x.dtype == y.dtype, (x, y)
        np.testing.assert_array_equal(x, y)
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


def make_table(pk, n=256, row_shape=()):
    calls = []

    def compute(ids):
        calls.append(np.array(ids))
        if row_shape:
            return np.stack([np.full(row_shape, i, dtype=np.float32) * 2.0 for i in ids])
        return ids.astype(np.float32) * 2.0

    return pk.table(n, compute, row_shape=row_shape), calls


def test_read_batch_computes_once_then_gathers():
    def run(pk):
        table, calls = make_table(pk)
        out = arr(table.read_batch(np.array([3, 7, 3, 11], dtype=np.int32)))
        np.testing.assert_allclose(out, [6.0, 14.0, 6.0, 22.0])
        assert len(calls) == 1 and sorted(calls[0].tolist()) == [3, 7, 11]
        out2 = arr(table.read_batch([7, 11]))
        np.testing.assert_allclose(out2, [14.0, 22.0])
        assert len(calls) == 1
        return out, out2, calls, table.version
    both(run)


def test_invalidate_triggers_refresh_on_next_read():
    def run(pk):
        table, calls = make_table(pk)
        table.read_batch([1, 2, 3])
        v0 = table.version
        table.invalidate([2])
        assert table.version > v0
        assert table.stale_count() == 256 - 3 + 1
        table.read_batch([1, 2, 3])
        assert len(calls) == 2 and calls[1].tolist() == [2]
        return calls, table.version, table.stale_count()
    both(run)


def test_on_invalidate_bridges_to_subscribers():
    def run(pk):
        table, _ = make_table(pk)
        seen = []
        table.on_invalidate.append(lambda ids: seen.append(ids.tolist()))
        table.read_batch([5])
        table.invalidate([5, 9])
        assert seen == [[5, 9]]
        table.invalidate_all()
        assert len(seen[1]) == 256
        return seen, table.version
    both(run)


def test_valid_bits_pack_matches_mask():
    """The port's words are int32, JAX's uint32: the bits are equal."""
    def run(pk):
        table, _ = make_table(pk, n=70)
        table.refresh([0, 31, 32, 69])
        bits = arr(table.valid_bits()).view(np.uint32)
        assert bits.shape == (3,)
        assert bits[0] == (1 | (1 << 31)) and bits[1] == 1 and bits[2] == 1 << (69 - 64)
        mask = arr(table.valid_mask)
        assert mask.sum() == 4 and mask[[0, 31, 32, 69]].all()
        return bits, mask
    both(run)


def test_matrix_rows():
    def run(pk):
        table, calls = make_table(pk, n=16, row_shape=(4,))
        out = arr(table.read_batch([2, 5]))
        assert out.shape == (2, 4)
        np.testing.assert_allclose(out[0], 4.0)
        np.testing.assert_allclose(out[1], 10.0)
        return out, calls
    both(run)


async def test_changed_event_stream():
    async def run(pk):
        table, _ = make_table(pk)
        ev = table.changed
        table.refresh([1])
        nxt = await asyncio.wait_for(ev.when_next(), 1.0)
        assert nxt.value == table.version
        return nxt.value
    await both_async(run)


async def test_bridge_row_deps_cascade_into_scalar_graph():
    async def run(pk):
        table, _ = make_table(pk)
        hub = pk.core.FusionHub()
        bridge = pk.Bridge(table, hub)

        class Aggregates(pk.core.ComputeService):
            @pk.core.compute_method
            async def sum_of(self, *ids) -> float:
                await bridge.use_rows(ids)
                return float(arr(table.read_batch(list(ids))).sum())

        agg = Aggregates(hub)
        node = await pk.core.capture(lambda: agg.sum_of(2, 4))
        assert node.value == 4.0 + 8.0
        assert bridge.live_row_leaves() == 2
        table.invalidate([4])
        await asyncio.wait_for(node.when_invalidated(), 1.0)
        again = await agg.sum_of(2, 4)
        node2 = await pk.core.capture(lambda: agg.sum_of(2, 4))
        assert node2.is_consistent
        table.invalidate([50])
        await asyncio.sleep(0.05)
        assert node2.is_consistent
        return node.value, again, table.version
    await both_async(run)


async def test_bridge_table_dep_cascades_on_any_row():
    async def run(pk):
        table, _ = make_table(pk, n=64)
        hub = pk.core.FusionHub()
        bridge = pk.Bridge(table, hub)

        class Aggregates(pk.core.ComputeService):
            @pk.core.compute_method
            async def grand_total(self) -> float:
                await bridge.use_table()
                return float(arr(table.read_batch(np.arange(64))).sum())

        agg = Aggregates(hub)
        node = await pk.core.capture(lambda: agg.grand_total())
        first = node.value
        table.invalidate([63])
        await asyncio.wait_for(node.when_invalidated(), 1.0)
        assert await agg.grand_total() == first
        return first
    await both_async(run)


async def test_bridge_detach_stops_cascading():
    async def run(pk):
        table, _ = make_table(pk)
        hub = pk.core.FusionHub()
        bridge = pk.Bridge(table, hub)

        class Aggregates(pk.core.ComputeService):
            @pk.core.compute_method
            async def one(self) -> float:
                await bridge.use_rows([3])
                return float(arr(table.read_batch([3]))[0])

        agg = Aggregates(hub)
        node = await pk.core.capture(lambda: agg.one())
        bridge.detach()
        table.invalidate([3])
        assert node.is_consistent
        assert bridge.live_row_leaves() == 0
        assert len(table.on_invalidate) == 0
        return node.value
    await both_async(run)


# ---------------------------------------------- transparent table backing

def make_backed_service(pk):
    core = pk.core

    class Users(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.data = {i: float(i) * 2.0 for i in range(64)}
            self.scalar_reads = 0
            self.batch_reads = []

        def get_many(self, ids):
            self.batch_reads.append(np.array(ids))
            return np.array([self.data[int(i)] for i in ids], dtype=np.float32)

        @core.compute_method(table=pk.backing(rows=64, batch="get_many"))
        async def get(self, uid: int) -> float:
            self.scalar_reads += 1
            return self.data[uid]

    return Users(core.FusionHub())


async def test_table_backed_scalar_path_unchanged():
    async def run(pk):
        svc = make_backed_service(pk)
        assert await svc.get(3) == 6.0
        assert await svc.get(3) == 6.0
        assert svc.scalar_reads == 1 and svc.batch_reads == []
        return svc.scalar_reads
    await both_async(run)


async def test_table_backed_batch_read_via_public_api():
    async def run(pk):
        svc = make_backed_service(pk)
        table = pk.core.memo_table_of(svc.get)
        assert pk.core.memo_table_of(svc.get) is table
        out = arr(table.read_batch([1, 2, 3]))
        np.testing.assert_allclose(out, [2.0, 4.0, 6.0])
        assert len(svc.batch_reads) == 1
        table.read_batch([1, 2, 3])
        assert len(svc.batch_reads) == 1
        return out, svc.batch_reads
    await both_async(run)


async def test_scalar_invalidation_marks_table_row_stale():
    async def run(pk):
        svc = make_backed_service(pk)
        table = pk.core.memo_table_of(svc.get)
        table.read_batch([5, 6])
        svc.data[5] = 99.0
        with pk.core.invalidating():
            await svc.get(5)
        out = arr(table.read_batch([5, 6]))
        np.testing.assert_allclose(out, [99.0, 12.0])
        assert svc.batch_reads[-1].tolist() == [5]
        return out, svc.batch_reads, table.version
    await both_async(run)


async def test_table_invalidation_reaches_live_scalar_nodes():
    async def run(pk):
        svc = make_backed_service(pk)
        node = await pk.core.capture(lambda: svc.get(7))
        assert node.is_consistent
        table = pk.core.memo_table_of(svc.get)
        svc.data[7] = -1.0
        table.invalidate([7, 8])
        assert not node.is_consistent
        assert await svc.get(7) == -1.0
        return table.version, table.stale_count()
    await both_async(run)


async def test_two_way_invalidation_has_no_cycle():
    async def run(pk):
        svc = make_backed_service(pk)
        table = pk.core.memo_table_of(svc.get)
        table.read_batch([4])
        await pk.core.capture(lambda: svc.get(4))
        v0 = table.version
        with pk.core.invalidating():
            await svc.get(4)
        assert table.version == v0 + 1
        return v0, table.version
    await both_async(run)


def test_read_batch_device_resident_ids():
    """Device-resident ids (a CPU tensor on the port, a jax array in JAX):
    the whole stale set refreshes first, then one pure gather."""
    def run(pk):
        table, calls = make_table(pk)
        table.read_batch([1, 2])
        ids = pk.device_ids([1, 5, 9])
        out = arr(table.read_batch(ids))
        np.testing.assert_allclose(out, [2.0, 10.0, 18.0])
        assert table.stale_count() == 0
        n = len(calls)
        table.read_batch(pk.device_ids([3]))
        assert len(calls) == n
        table.invalidate([7])
        out2 = arr(table.read_batch(ids))
        assert calls[-1].tolist() == [7]
        # JAX's gather semantics for ids out of range: negatives count from
        # the end, the rest clamp
        edge = arr(table.read_batch(pk.device_ids([-1, 255, 300])))
        return out, out2, edge, calls
    both(run)


def test_stale_count_is_exact_under_repeats():
    def run(pk):
        table, _ = make_table(pk, n=16)
        table.read_batch(np.arange(16))
        seen = [table.stale_count()]
        table.invalidate([3, 3, 5])
        seen.append(table.stale_count())
        table.invalidate([5])
        seen.append(table.stale_count())
        table.refresh([3, 3])
        seen.append(table.stale_count())
        table.refresh([3])
        seen.append(table.stale_count())
        table.invalidate_all()
        seen.append(table.stale_count())
        assert seen == [0, 2, 2, 1, 1, 16]
        return seen
    both(run)


def test_read_batch_accepts_any_host_sequence():
    def run(pk):
        table, calls = make_table(pk)
        out = arr(table.read_batch(range(4)))
        np.testing.assert_allclose(out, [0.0, 2.0, 4.0, 6.0])
        assert table.stale_count() == 256 - 4
        return out, calls
    both(run)


async def test_dependency_cascade_marks_table_row_stale():
    async def run(pk):
        core = pk.core
        hub = core.FusionHub()

        class Source(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.factor = 2.0

            @core.compute_method
            async def get_factor(self) -> float:
                return self.factor

        class Users(core.ComputeService):
            def __init__(self, source, hub=None):
                super().__init__(hub)
                self.source = source

            def get_many(self, ids):
                return np.array([float(i) * self.source.factor for i in ids], dtype=np.float32)

            @core.compute_method(table=pk.backing(rows=32, batch="get_many"))
            async def get(self, uid: int) -> float:
                return float(uid) * await self.source.get_factor()

        source = Source(hub)
        users = Users(source, hub)
        table = core.memo_table_of(users.get)
        assert await users.get(3) == 6.0
        table.read_batch([3])
        assert table.stale_count() == 32 - 1
        source.factor = 10.0
        with core.invalidating():
            await source.get_factor()
        assert await users.get(3) == 30.0
        out = arr(table.read_batch([3]))
        np.testing.assert_allclose(out, [30.0])
        return out, table.version
    await both_async(run)


# ------------------------------------------------------------------ key codec

async def test_string_key_table_coherence_both_ways():
    async def run(pk):
        core = pk.core
        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            class Users(core.ComputeService):
                def __init__(self, hub=None):
                    super().__init__(hub)
                    self.db = {f"u{i}": float(i) for i in range(32)}
                    self.batch_keys = []

                def load(self, names):
                    self.batch_keys.append(list(names))
                    return np.array([self.db[n] for n in names], dtype=np.float32)

                @core.compute_method(table=pk.backing(rows=32, batch="load", keys=True))
                async def balance(self, name: str) -> float:
                    return self.db[name]

                async def deposit(self, name, amount):
                    self.db[name] += amount
                    with core.invalidating():
                        await self.balance(name)

            users = Users(hub)
            table = core.memo_table_of(users.balance)
            vals = arr(table.read_keys(["u3", "u1", "u3"]))
            np.testing.assert_allclose(vals, [3.0, 1.0, 3.0])
            assert all(isinstance(k, str) for batch in users.batch_keys for k in batch)
            await users.deposit("u3", 10.0)
            assert float(arr(table.read_keys(["u3"]))[0]) == 13.0
            node = await core.capture(lambda: users.balance("u1"))
            await users.deposit("u1", 5.0)
            assert node.is_invalidated
            assert float(arr(table.read_keys(["u1"]))[0]) == 6.0
            node2 = await core.capture(lambda: users.balance("u1"))
            users.db["u1"] = 0.0
            table.invalidate_keys(["u1"])
            assert node2.is_invalidated
            assert await users.balance("u1") == 0.0
            rows_before = len(table.key_codec)
            table.invalidate_keys(["u31"])
            assert len(table.key_codec) == rows_before
            return vals, users.batch_keys, table.version
        finally:
            core.set_default_hub(old)
    await both_async(run)


async def test_composite_key_table_and_codec_capacity():
    async def run(pk):
        core = pk.core
        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            class Scores(core.ComputeService):
                def load(self, keys):
                    assert all(isinstance(k, tuple) and len(k) == 2 for k in keys)
                    return np.array([t * 100 + i for t, i in keys], dtype=np.float32)

                @core.compute_method(table=pk.backing(rows=4, batch="load", keys=True))
                async def score(self, tenant: int, uid: int) -> float:
                    return float(tenant * 100 + uid)

            svc = Scores(hub)
            table = core.memo_table_of(svc.score)
            vals = arr(table.read_keys([(1, 2), (3, 4)]))
            np.testing.assert_allclose(vals, [102.0, 304.0])
            table.read_keys([(5, 6), (7, 8)])
            with pytest.raises(KeyError, match="codec full"):
                table.read_keys([(9, 9)])
            return vals
        finally:
            core.set_default_hub(old)
    await both_async(run)


async def test_codec_is_per_service_instance():
    async def run(pk):
        core = pk.core
        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            class KV(core.ComputeService):
                def load(self, keys):
                    return np.array([float(len(k)) for k in keys], dtype=np.float32)

                @core.compute_method(table=pk.backing(rows=4, batch="load", keys=True))
                async def get(self, key: str) -> float:
                    return float(len(key))

            a, b = KV(hub), KV(hub)
            ta, tb = core.memo_table_of(a.get), core.memo_table_of(b.get)
            assert ta is not tb and ta.key_codec is not tb.key_codec
            ta.read_keys([f"a{i}" for i in range(4)])
            vals = arr(tb.read_keys([f"bee{i}" for i in range(4)]))
            np.testing.assert_allclose(vals, [4.0] * 4)
            return vals
        finally:
            core.set_default_hub(old)
    await both_async(run)


async def test_single_arg_tuple_valued_keys():
    async def run(pk):
        core = pk.core
        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            class Grid(core.ComputeService):
                def __init__(self, hub=None):
                    super().__init__(hub)
                    self.db = {(x, y): float(x * 10 + y) for x in range(4) for y in range(4)}

                def load(self, cells):
                    assert all(isinstance(c, tuple) and len(c) == 2 for c in cells)
                    return np.array([self.db[c] for c in cells], dtype=np.float32)

                @core.compute_method(table=pk.backing(rows=16, batch="load", keys=True))
                async def cell(self, pos: tuple) -> float:
                    return self.db[pos]

            grid = Grid(hub)
            table = core.memo_table_of(grid.cell)
            vals = arr(table.read_keys([(1, 2), (3, 0)]))
            np.testing.assert_allclose(vals, [12.0, 30.0])
            node = await core.capture(lambda: grid.cell((1, 2)))
            grid.db[(1, 2)] = 99.0
            table.invalidate_keys([(1, 2)])
            assert node.is_invalidated
            assert await grid.cell((1, 2)) == 99.0
            node2 = await core.capture(lambda: grid.cell((3, 0)))
            grid.db[(3, 0)] = 7.0
            node2.invalidate()
            last = float(arr(table.read_keys([(3, 0)]))[0])
            assert last == 7.0
            return vals, last, table.version
        finally:
            core.set_default_hub(old)
    await both_async(run)


async def test_defaulted_table_method_keeps_row_coherence():
    async def run(pk):
        core = pk.core

        class Scaled(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.data = {i: float(i * 2) for i in range(16)}

            def load(self, ids):
                return np.asarray([self.data[int(i)] for i in ids], dtype=np.float32)

            @core.compute_method(table=pk.backing(rows=16, batch="load"))
            async def val(self, i: int, scale: float = 1.0) -> float:
                return self.data[i] * scale

        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            svc = Scaled()
            table = core.memo_table_of(svc.val)
            table.read_batch([5, 6])
            svc.data[5] = 99.0
            with core.invalidating():
                await svc.val(5)
            out = arr(table.read_batch([5, 6]))
            np.testing.assert_allclose(out, [99.0, 12.0])
            assert await svc.val(7) == 14.0
            svc.data[7] = 50.0
            table.invalidate([7])
            assert await svc.val(7) == 50.0
            return out, table.version
        finally:
            core.set_default_hub(old)
    await both_async(run)


# ------------------------------------------------------------------ the port's own

@pytest.mark.parametrize("row_shape,dtype", [((), np.float32), ((3,), np.int32)])
def test_jax_export_state_loads_into_port_table(row_shape, dtype):
    """A JAX table's checkpoint (numpy) restores into a port table: the same
    values, validity and version, valid rows read as hits, stale rows
    refresh through the port table's own loader on first touch."""
    rng = np.random.default_rng(5)
    n = 40
    data = rng.integers(-1000, 1000, size=(n, *row_shape)).astype(dtype)

    def load(ids):
        return data[np.asarray(ids, np.int64)]

    jt = JaxTable(n, load, row_shape=row_shape, dtype=dtype)
    jt.read_batch(rng.choice(n, 25, replace=False))
    jt.invalidate([3, 4])
    state = jt.export_state()
    calls = []
    pt = PortTable(n, lambda ids: (calls.append(np.array(ids)), load(ids))[1],
                   row_shape=row_shape, dtype=dtype, device="cpu")
    pt.import_state(state)
    assert pt.version == jt.version + 1 == state["version"] + 1
    assert pt.stale_count() == jt.stale_count()
    np.testing.assert_array_equal(arr(pt.values), np.asarray(jt.values))
    np.testing.assert_array_equal(arr(pt.valid_mask), np.asarray(jt.valid_mask))
    same(pt.export_state()["valid"], state["valid"])
    valid_ids = np.nonzero(state["valid"])[0]
    np.testing.assert_array_equal(arr(pt.read_batch(valid_ids)), data[valid_ids])
    assert calls == []  # warm hits
    np.testing.assert_array_equal(arr(pt.read_batch(np.arange(n))),
                                  np.asarray(jt.read_batch(np.arange(n))))
    assert sorted(calls[0].tolist()) == np.nonzero(~state["valid"])[0].tolist()
    with pytest.raises(ValueError, match="checkpoint shape"):
        PortTable(n + 1, load, row_shape=row_shape, dtype=dtype, device="cpu").import_state(state)


def test_port_tables_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortTable(8, lambda ids: ids)

    class Svc(pcore.ComputeService):
        def load(self, ids):
            return np.asarray(ids, np.float32)

        @pcore.compute_method(table=pcore.TableBacking(rows=8, batch="load"))
        async def get(self, i: int) -> float:
            return float(i)

    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcore.memo_table_of(Svc(pcore.FusionHub()).get)
