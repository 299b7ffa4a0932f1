"""Parity of the port's checkpoints (``stl_fusion_tpu_torch/checkpoint``) with
the JAX package's: 11 of the 12 cases of ``tests/test_checkpoint.py`` (the
graph snapshot, hub warm boot with its edges, live-wins restores, the
checkpoint + op-log resume, the manager's rotation, the memo table across a
process restart, a diverged key layout, the restored scalar node's row
hook, the snapshot envelope, the manager's fallback past a torn latest,
``save_durable`` and the snapshot floor), each run as one scenario through
both packages with the reference's assertions, their observations (values
read, compute counts, restore counts, decoded snapshot contents but their
random versions and times) required EQUAL. Left out: ``:637``
(``cluster.warm_rejoin``, ROADMAP A.9).

Besides: a graph snapshot written by either package loads into the other,
with equal arrays and equal waves after; ``save_graph`` taken right after a
lane burst and right after a mesh burst on a backend equals the JAX
package's snapshot taken at the same point; and the
``examples/hello_cart_durable.py`` flow runs through both packages.
Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import stl_fusion_tpu
import stl_fusion_tpu_torch
from stl_fusion_tpu_torch.graph.synthetic import power_law_dag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ns(pkg):
    name = pkg.__name__
    imp = __import__
    ns = types.SimpleNamespace(name=name, port=name == "stl_fusion_tpu_torch", **{
        m: imp(f"{name}.{m}", fromlist=["_"])
        for m in ("core", "commands", "oplog", "checkpoint", "graph", "parallel")})
    ns.durable = imp(f"{name}.checkpoint.durable", fromlist=["_"])
    ser = imp(f"{name}.utils.serialization", fromlist=["_"])
    ns.wire_type, ns.dumps = ser.wire_type, ser.dumps
    ns.DeviceGraph = ns.graph.DeviceGraph
    ns.cpu = {"device": "cpu"} if ns.port else {}
    core = ns.core
    ns.DB, ns.PRICES = {}, {}

    class CartService(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.compute_calls = 0

        @core.compute_method
        async def price(self, pid: str) -> float:
            self.compute_calls += 1
            return ns.PRICES.get(pid, 0.0)

        @core.compute_method
        async def total(self) -> float:
            self.compute_calls += 1
            return (await self.price("apple")) + (await self.price("pear"))

    @ns.wire_type("TwinCkptSet")
    @dataclasses.dataclass(frozen=True)
    class CkptSet:
        key: str
        value: int

    class ValueService(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.compute_calls = 0

        @core.compute_method
        async def get(self, key: str) -> int:
            self.compute_calls += 1
            return ns.DB.get(key, 0)

        @ns.commands.command_handler
        async def set_value(self, command: CkptSet):
            if core.is_invalidating():
                await self.get(command.key)
                return
            ns.DB[command.key] = command.value

    ns.CartService, ns.CkptSet, ns.ValueService = CartService, CkptSet, ValueService
    return ns


NS = {"jax": _ns(stl_fusion_tpu), "port": _ns(stl_fusion_tpu_torch)}


async def both(scenario, *args):
    got = []
    for ns in NS.values():
        ns.DB.clear()
        ns.PRICES.clear()
        ns.PRICES.update({"apple": 2.0, "pear": 3.0})
        hub = ns.core.FusionHub()
        old = ns.core.set_default_hub(hub)
        try:
            got.append(await scenario(ns, *args))
        finally:
            ns.core.set_default_hub(old)
    assert got[0] == got[1], got
    return got[1]


def contents(snap):
    """A hub snapshot's decoded contents without its random versions and
    times: the nodes (service, method, args, value) and the edges between
    them by node."""
    nodes = [(n["s"], n["m"], repr(n["a"]), repr(n["o"])) for n in snap["nodes"]]
    edges = sorted((nodes[d], nodes[u]) for d, u, _ in snap["edges"])
    tables = [(t["s"], t["m"], t["state"]["valid"].tolist(), t["state"]["values"].tolist())
              for t in snap.get("tables", ())]
    return sorted(nodes), edges, tables


def _graph_arrays(g):
    m, n = g.n_edges, g.n_nodes
    return (n, m, g._h_edge_src[:m].tolist(), g._h_edge_dst[:m].tolist(),
            g._h_edge_dst_epoch[:m].tolist(), g._h_node_epoch[:n].tolist(),
            np.asarray(g.invalid_mask()).tolist())


# ---------------------------------------------------------------- device graph
async def test_device_graph_snapshot_roundtrip(tmp_path):
    async def run(ns):
        g = ns.DeviceGraph(node_capacity=16, edge_capacity=16, **ns.cpu)
        g.add_nodes(6)
        g.add_edges(np.array([0, 1, 0, 0]), np.array([1, 2, 3, 4]))
        g.bump_epochs(np.array([5]))
        g.run_wave([0])
        path = str(tmp_path / f"{ns.name}.npz")
        ns.checkpoint.save_graph(g, path)
        g2 = ns.checkpoint.load_graph(path, **ns.cpu)
        assert _graph_arrays(g2) == _graph_arrays(g)
        seen = [_graph_arrays(g2), int(g2.run_wave([0]))]
        g2.bump_epochs(np.array([1, 2]))
        g2.add_edges(np.array([1]), np.array([2]))
        seen.append(int(g2.run_wave([1])))
        assert seen[1] == 0 and seen[2] >= 1
        return seen
    await both(run)


# ---------------------------------------------------------------- hub warm boot
async def test_hub_checkpoint_warm_boot_and_edges(tmp_path):
    async def run(ns):
        hub = ns.core.FusionHub()
        svc = hub.add_service(ns.CartService(hub))
        assert await svc.total() == 5.0
        path = str(tmp_path / f"{ns.name}.bin")
        snap = ns.checkpoint.HubCheckpoint.save(hub, path, oplog_position=7)
        assert len(snap["nodes"]) == 3 and len(snap["edges"]) == 2
        hub2 = ns.core.FusionHub()
        svc2 = hub2.add_service(ns.CartService(hub2))
        result = ns.checkpoint.HubCheckpoint.restore(hub2, path)
        seen = [result.count, result.edges, result.oplog_position, await svc2.total(),
                svc2.compute_calls]
        assert seen == [3, 2, 7, 5.0, 0]
        total_node = await ns.core.capture(lambda: svc2.total())
        ns.PRICES["apple"] = 10.0
        with ns.core.invalidating():
            await svc2.price("apple")
        seen += [total_node.is_invalidated, await svc2.total(), svc2.compute_calls]
        assert seen[-3:] == [True, 13.0, 2]
        return seen, contents(snap)
    await both(run)


async def test_restore_skips_unknown_and_prefers_live(tmp_path):
    async def run(ns):
        hub = ns.core.FusionHub()
        svc = hub.add_service(ns.CartService(hub))
        await svc.total()
        path = str(tmp_path / f"{ns.name}.bin")
        ns.checkpoint.HubCheckpoint.save(hub, path)
        hub2 = ns.core.FusionHub()
        svc2 = hub2.add_service(ns.CartService(hub2))
        ns.PRICES["apple"] = 99.0
        seen = [await svc2.price("apple")]
        result = ns.checkpoint.HubCheckpoint.restore(hub2, path)
        seen += [await svc2.price("apple"), await svc2.total()]
        r3 = ns.checkpoint.HubCheckpoint.restore(ns.core.FusionHub(), path, services={})
        seen += [r3.count, r3.skipped, len(result.computeds)]
        assert seen[:3] == [99.0, 99.0, 102.0] and seen[3] == 0 and seen[4] == seen[5]
        return seen
    await both(run)


# ---------------------------------------------------------------- oplog resume
async def test_checkpoint_plus_oplog_resume(tmp_path):
    async def run(ns):
        core, oplog = ns.core, ns.oplog
        ns.DB.update({"x": 1, "y": 2})
        log_store = oplog.InMemoryOperationLog()
        notifier = oplog.LocalChangeNotifier()
        hub_a = core.FusionHub()
        svc_a = hub_a.add_service(ns.ValueService(hub_a))
        hub_a.commander.add_service(svc_a)
        reader_a = oplog.attach_operation_log(hub_a.commander, log_store, notifier)
        hub_b = core.FusionHub()
        svc_b = hub_b.add_service(ns.ValueService(hub_b))
        hub_b.commander.add_service(svc_b)
        reader_b = oplog.attach_operation_log(hub_b.commander, log_store, notifier)
        assert await svc_b.get("x") == 1 and await svc_b.get("y") == 2
        path = str(tmp_path / f"{ns.name}.bin")
        ns.checkpoint.HubCheckpoint.save(hub_b, path, oplog_position=reader_b.watermark)
        await reader_b.stop()
        del hub_b, svc_b
        await hub_a.commander.call(ns.CkptSet("x", 42))
        hub_b2 = core.FusionHub()
        svc_b2 = hub_b2.add_service(ns.ValueService(hub_b2))
        hub_b2.commander.add_service(svc_b2)
        restored = ns.checkpoint.HubCheckpoint.restore(hub_b2, path)
        node_x = await core.capture(lambda: svc_b2.get("x"))
        seen = [restored.count, node_x.value, svc_b2.compute_calls]
        reader_b2 = oplog.attach_operation_log(hub_b2.commander, log_store, notifier,
                                               start_position=restored.oplog_position)
        try:
            await asyncio.wait_for(node_x.when_invalidated(), 5.0)
            seen += [await svc_b2.get("x"), await svc_b2.get("y"), svc_b2.compute_calls]
            assert seen == [2, 1, 0, 42, 2, 1]
            return seen
        finally:
            await reader_b2.stop()
            await reader_a.stop()
    await both(run)


# ---------------------------------------------------------------- manager
async def test_checkpoint_manager_rotation(tmp_path):
    async def run(ns):
        hub = ns.core.FusionHub()
        svc = hub.add_service(ns.CartService(hub))
        await svc.total()
        mgr = ns.checkpoint.CheckpointManager(str(tmp_path / ns.name / "ckpts"), keep=2)
        seen = [mgr.restore_latest(ns.core.FusionHub()) is None]
        seen += [mgr.save(hub, oplog_position=i) for i in (1, 2, 3)]
        seen.append(mgr._steps())
        hub2 = ns.core.FusionHub()
        hub2.add_service(ns.CartService(hub2))
        result = mgr.restore_latest(hub2)
        seen += [result.oplog_position, result.count]
        assert seen == [True, 1, 2, 3, [2, 3], 3, 3]
        return seen
    await both(run)


# ------------------------------------------------------------------ MemoTable
TABLE_SNAPSHOT_SCRIPT = r"""
import asyncio, os, sys
sys.path.insert(0, sys.argv[2])
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "PKG" == "stl_fusion_tpu":
    import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np
from PKG.checkpoint import HubCheckpoint
from PKG.core import FusionHub, memo_table_of, set_default_hub
from MODULE import Users, NamedUsers

async def main():
    hub = FusionHub(); set_default_hub(hub)
    users = Users(hub); named = NamedUsers(hub)
    hub.add_service(users, "users"); hub.add_service(named, "named")
    table = memo_table_of(users.balance)
    table.read_batch(np.arange(16))
    table.invalidate([3])
    memo_table_of(named.balance).read_keys(["alice", "bob"])
    HubCheckpoint.save(hub, sys.argv[1])
    print("saved", flush=True)

asyncio.run(main())
"""

SERVICE_MODULE = '''
import numpy as np
from PKG.core import ComputeService, TableBacking, compute_method


class Users(ComputeService):
    def __init__(self, hub=None):
        super().__init__(hub)
        self.db = {i: float(i) for i in range(16)}
        self.loads = 0

    def load(self, ids):
        self.loads += len(ids)
        return np.array([self.db[int(i)] for i in ids], dtype=np.float32)

    @compute_method(table=TableBacking(rows=16, batch="load"DEVKW))
    async def balance(self, uid: int) -> float:
        return self.db[uid]


class NamedUsers(ComputeService):
    def __init__(self, hub=None):
        super().__init__(hub)
        self.db = {"alice": 1.0, "bob": 2.0, "carol": 3.0}
        self.loads = 0

    def load(self, names):
        self.loads += len(names)
        return np.array([self.db[n] for n in names], dtype=np.float32)

    @compute_method(table=TableBacking(rows=8, batch="load", keys=True DEVKW))
    async def balance(self, name: str) -> float:
        return self.db[name]
'''


def _floats(x):
    return np.asarray(x).astype(np.float64).tolist()


async def test_memo_table_survives_restart(tmp_path):
    """Snapshot in one process (running the package under test), restore
    in this one: warm hits, the stale row refreshes on touch, the key
    layout survives, and invalidation propagates both ways after."""
    async def run(ns):
        import importlib

        mod = f"twin_ckpt_service_{'port' if ns.port else 'jax'}"
        dev = ', device="cpu"' if ns.port else ""
        (tmp_path / f"{mod}.py").write_text(
            SERVICE_MODULE.replace("PKG", ns.name).replace('"load"DEVKW', f'"load"{dev}')
            .replace("keys=True DEVKW", f"keys=True{dev}"))
        snap_path = tmp_path / f"{mod}.ckpt"
        script = tmp_path / f"{mod}_save.py"
        script.write_text(TABLE_SNAPSHOT_SCRIPT.replace("PKG", ns.name).replace("MODULE", mod))
        env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{os.environ.get('PYTHONPATH', '')}")
        proc = await asyncio.to_thread(
            subprocess.run, [sys.executable, str(script), str(snap_path), REPO],
            capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr
        sys.path.insert(0, str(tmp_path))
        try:
            svc_mod = importlib.import_module(mod)
            core = ns.core
            hub = core.FusionHub()
            old = core.set_default_hub(hub)
            try:
                users = svc_mod.Users(hub)
                named = svc_mod.NamedUsers(hub)
                hub.add_service(users, "users")
                hub.add_service(named, "named")
                result = ns.checkpoint.HubCheckpoint.restore(hub, str(snap_path))
                table = core.memo_table_of(users.balance)
                seen = [result.tables, _floats(table.read_batch([1, 5, 9])), users.loads]
                users.db[3] = 33.0
                seen += [_floats(table.read_batch([3])), users.loads]
                ntable = core.memo_table_of(named.balance)
                seen += [_floats(ntable.read_keys(["alice", "bob"])), named.loads]
                node = await core.capture(lambda: users.balance(5))
                users.db[5] = 55.0
                table.invalidate([5])
                seen += [node.is_invalidated, _floats(table.read_batch([5]))]
                node2 = await core.capture(lambda: named.balance("alice"))
                named.db["alice"] = 11.0
                node2.invalidate()
                seen.append(_floats(ntable.read_keys(["alice"])))
                assert seen == [2, [1.0, 5.0, 9.0], 0, [33.0], 1, [1.0, 2.0], 0, True,
                                [55.0], [11.0]]
                return seen
            finally:
                core.set_default_hub(old)
        finally:
            sys.path.remove(str(tmp_path))
    await both(run)


async def test_table_restore_refuses_diverged_key_layout(tmp_path):
    async def run(ns):
        core = ns.core

        class Named(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.db = {"alice": 1.0, "bob": 2.0, "carol": 3.0}
                self.loads = 0

            def load(self, names):
                self.loads += len(names)
                return np.array([self.db[n] for n in names], dtype=np.float32)

            @core.compute_method(table=core.TableBacking(rows=8, batch="load", keys=True,
                                                         **ns.cpu))
            async def balance(self, name: str) -> float:
                return self.db[name]

        hub_a = core.FusionHub()
        old = core.set_default_hub(hub_a)
        try:
            a = Named(hub_a)
            hub_a.add_service(a, "named")
            core.memo_table_of(a.balance).read_keys(["alice", "bob"])
            path = str(tmp_path / f"{ns.name}.bin")
            ns.checkpoint.HubCheckpoint.save(hub_a, path)
            hub_b = core.FusionHub()
            core.set_default_hub(hub_b)
            b = Named(hub_b)
            hub_b.add_service(b, "named")
            tb = core.memo_table_of(b.balance)
            tb.read_keys(["carol"])
            result = ns.checkpoint.HubCheckpoint.restore(hub_b, path)
            seen = [result.tables, _floats(tb.read_keys(["alice", "bob", "carol"]))]
            assert seen == [0, [1.0, 2.0, 3.0]]
            return seen
        finally:
            core.set_default_hub(old)
    await both(run)


async def test_restored_scalar_node_marks_table_row_stale(tmp_path):
    async def run(ns):
        core = ns.core

        class Users(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.db = {i: float(i) for i in range(8)}

            def load(self, ids):
                return np.array([self.db[int(i)] for i in ids], dtype=np.float32)

            @core.compute_method(table=core.TableBacking(rows=8, batch="load", **ns.cpu))
            async def balance(self, uid: int) -> float:
                return self.db[uid]

        hub_a = core.FusionHub()
        old = core.set_default_hub(hub_a)
        try:
            a = Users(hub_a)
            hub_a.add_service(a, "users")
            assert await a.balance(2) == 2.0
            core.memo_table_of(a.balance).read_batch(np.arange(8))
            path = str(tmp_path / f"{ns.name}.bin")
            snap = ns.checkpoint.HubCheckpoint.save(hub_a, path)
            hub_b = core.FusionHub()
            core.set_default_hub(hub_b)
            b = Users(hub_b)
            hub_b.add_service(b, "users")
            result = ns.checkpoint.HubCheckpoint.restore(hub_b, path)
            assert result.tables == 1 and result.count >= 1
            b.db[2] = 222.0
            with core.invalidating():
                await b.balance(2)
            seen = [result.tables, result.count, await b.balance(2),
                    _floats(core.memo_table_of(b.balance).read_batch([2]))]
            assert seen[2:] == [222.0, [222.0]]
            return seen, contents(snap)
        finally:
            core.set_default_hub(old)
    await both(run)


# ---------------------------------------------------------------- durability
def test_snapshot_envelope_checksum_header_and_legacy(tmp_path):
    got = []
    for ns in NS.values():
        d = tmp_path / ns.name
        d.mkdir()
        durable = ns.durable
        snap = {"format": 1, "nodes": [], "edges": [],
                "oplog": {"watermark": 41, "commit_floor": 123.5}}
        path = str(d / "snap.bin")
        durable.write_snapshot_file(path, snap)
        assert not any(n.startswith("snap.bin.tmp") for n in os.listdir(d))
        header = durable.read_snapshot_header(path)
        seen = [header["watermark"], header["commit_floor"],
                durable.read_snapshot_file(path)["oplog"]["watermark"]]
        blob = open(path, "rb").read()
        torn = str(d / "torn.bin")
        with open(torn, "wb") as f:
            f.write(blob[:-7])
        with pytest.raises(durable.CorruptSnapshotError):
            durable.read_snapshot_file(torn)
        flipped = bytearray(blob)
        flipped[-3] ^= 0xFF
        with open(str(d / "flip.bin"), "wb") as f:
            f.write(bytes(flipped))
        with pytest.raises(durable.CorruptSnapshotError):
            durable.read_snapshot_file(str(d / "flip.bin"))
        legacy = str(d / "legacy.bin")
        with open(legacy, "wb") as f:
            f.write(ns.dumps({"format": 1, "nodes": [], "edges": [], "oplog_position": 9}))
        seen += [durable.read_snapshot_header(legacy),
                 durable.read_snapshot_file(legacy)["oplog_position"], len(blob)]
        assert seen[:5] == [41, 123.5, 41, None, 9]
        got.append(seen)
    assert got[0] == got[1]


async def test_manager_falls_back_past_corrupt_latest(tmp_path):
    async def run(ns):
        hub = ns.core.FusionHub()
        svc = hub.add_service(ns.CartService(hub))
        await svc.total()
        mgr = ns.checkpoint.CheckpointManager(str(tmp_path / ns.name / "ckpts"), keep=3)
        s1 = mgr.save(hub, oplog_position=1)
        s2 = mgr.save(hub, oplog_position=2)
        latest = mgr.path_of(s2)
        blob = open(latest, "rb").read()
        with open(latest, "wb") as f:
            f.write(blob[: len(blob) // 2])
        open(os.path.join(mgr.directory, "fusion-ckpt-9.bin.tmp123"), "wb").close()
        hub2 = ns.core.FusionHub()
        hub2.add_service(ns.CartService(hub2))
        result = mgr.restore_latest(hub2)
        seen = [result.count, result.oplog_position, mgr.corrupt_skipped,
                os.path.exists(f"{latest}.corrupt"), mgr._steps() == [s1],
                bool(mgr.events.recent_of("snapshot_corrupt"))]
        assert seen == [3, 1, 1, True, True, True]
        return seen
    await both(run)


async def test_save_durable_snapshot_floor_and_corrupt_header(tmp_path):
    async def run(ns):
        import time as _time

        core, oplog, durable = ns.core, ns.oplog, ns.durable
        ns.DB.update({"x": 1})
        log_store = oplog.InMemoryOperationLog()
        notifier = oplog.LocalChangeNotifier()
        hub = core.FusionHub()
        svc = hub.add_service(ns.ValueService(hub))
        hub.commander.add_service(svc)
        reader = oplog.attach_operation_log(hub.commander, log_store, notifier,
                                            start_reader=False)
        try:
            await svc.get("x")
            await hub.commander.call(ns.CkptSet("x", 5))
            await reader.read_new()
            assert log_store.last_index() >= 1
            mgr = ns.checkpoint.CheckpointManager(str(tmp_path / ns.name / "ckpts"), keep=3)
            t0 = _time.time()
            step = mgr.save_durable(hub, reader=reader, log_store=log_store)
            header = durable.read_snapshot_header(mgr.path_of(step))
            seen = [header["watermark"] == reader.watermark]
            floor = mgr.snapshot_floor()
            assert floor is not None and floor <= _time.time() + 1
            mgr.save_durable(hub, reader=reader, log_store=log_store)
            assert mgr.snapshot_floor() == floor or mgr.snapshot_floor() <= floor + (
                _time.time() - t0 + 1)
            with open(mgr.path_of(97), "wb") as f:
                f.write(b"FUSNAP2 nonsense\n")
            seen.append(mgr.snapshot_floor() is not None)
            mgr.keep = 10
            step2 = mgr.save(hub, oplog_position=reader.watermark)
            seen += [durable.read_snapshot_header(mgr.path_of(step2))["commit_floor"],
                     mgr.snapshot_floor()]
            os.remove(mgr.path_of(step2))
            step3 = mgr.save(hub, oplog_position=log_store.last_index(), log_store=log_store)
            seen += [durable.read_snapshot_header(mgr.path_of(step3))["commit_floor"] is not None,
                     mgr.snapshot_floor() > 0.0]
            first = log_store.read_after(0, limit=1)[0]
            step4 = mgr.save(hub, oplog_position=0, log_store=log_store)
            seen.append(durable.read_snapshot_header(mgr.path_of(step4))["commit_floor"]
                        == first.commit_time)
            os.remove(mgr.path_of(step4))
            bare = {"format": 1, "oplog_position": 2, "nodes": [], "edges": [], "tables": []}
            durable.write_snapshot_file(mgr.path_of(98), bare)
            seen.append(mgr.snapshot_floor())
            os.remove(mgr.path_of(98))
            with open(mgr.path_of(99), "wb") as f:
                f.write(ns.dumps(bare))
            seen.append(mgr.snapshot_floor())
            os.remove(mgr.path_of(99))
            seen.append(mgr.snapshot_floor() > 0.0)
            assert seen == [True, True, None, 0.0, True, True, True, 0.0, 0.0, True]
            return seen
        finally:
            await reader.stop()
    await both(run)


# ---------------------------------------------------------------- across the packages
def _built_graph(ns, n=3000, seed=4):
    """A power-law DAG with stale edges and an invalid set, in ``ns``'s
    DeviceGraph."""
    src, dst = power_law_dag(n, avg_degree=3, seed=seed)
    g = ns.DeviceGraph(node_capacity=n, edge_capacity=len(src) + 16, **ns.cpu)
    g.add_nodes(n)
    g.add_edges(src, dst)
    rng = np.random.default_rng(seed)
    g.bump_epochs(rng.choice(n, size=n // 50, replace=False))
    g.run_waves_union([rng.choice(n, size=20, replace=False).tolist()], mirror="off")
    return g


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_snapshot_loads_across_packages(tmp_path, writer):
    """A ``.npz`` written by ``writer`` loads into both packages: equal
    arrays, and the same union wave after on each gives equal counts and
    ids (the reader's own load of the file is the reference)."""
    path = str(tmp_path / "graph.npz")
    g = _built_graph(NS[writer])
    NS[writer].checkpoint.save_graph(g, path)
    with np.load(path) as z:
        assert int(z["format"]) == 1 and z["edge_src"].dtype == np.int32
        assert z["invalid"].dtype == bool and z["node_epoch"].dtype == np.int32
    loaded = {k: ns.checkpoint.load_graph(path, **ns.cpu) for k, ns in NS.items()}
    assert _graph_arrays(loaded["jax"]) == _graph_arrays(loaded["port"]) == _graph_arrays(g)
    for g2 in loaded.values():
        assert g2._h_edge_src[g2.n_edges:].tolist() == [g2.n_cap] * (g2.e_cap - g2.n_edges)
    seeds = np.random.default_rng(9).choice(g.n_nodes, size=40, replace=False).tolist()
    waves = {k: g2.run_waves_union([seeds], mirror="off") for k, g2 in loaded.items()}
    assert int(waves["jax"][0]) == int(waves["port"][0]) > 0
    np.testing.assert_array_equal(np.asarray(waves["jax"][1]), np.asarray(waves["port"][1]))
    assert _graph_arrays(loaded["jax"]) == _graph_arrays(loaded["port"])


def _stack(ns, n, src, dst):
    core = ns.core
    hub = core.FusionHub()
    backend = ns.graph.TpuGraphBackend(hub, node_capacity=n + 16, edge_capacity=len(src) + 64,
                                       **ns.cpu)

    class Rows(core.ComputeService):
        def load(self, ids):
            return np.asarray(ids, dtype=np.float32)

        @core.compute_method(table=core.TableBacking(rows=n, batch="load", **ns.cpu))
        async def row(self, i: int) -> float:
            return float(i)

    svc = Rows(hub)
    hub.add_service(svc, "rows")
    table = core.memo_table_of(svc.row)
    block = backend.bind_table_rows(table)
    backend.declare_row_edges(block, src, block, dst)
    table.read_batch(np.arange(n))
    backend.cascade_rows_batch(block, [n - 1])  # some rows already stale
    return hub, backend, block


@pytest.mark.parametrize("burst", ["lanes", "mesh"])
def test_save_graph_after_a_burst_matches_jax(tmp_path, burst):
    """``save_graph`` right after a lane burst (``cascade_rows_lanes``, the
    topo mirror) or a mesh burst (``cascade_rows_lanes_sharded`` on 8
    shards, whose blocked mask stays on the device between bursts) holds
    the same arrays as the JAX package's snapshot taken at the same point,
    and the backend's host mirror of the invalid set."""
    n = 600
    src, dst = power_law_dag(n, avg_degree=3.0, seed=8)
    rng = np.random.default_rng(8)
    groups = [rng.choice(n, size=4, replace=False).tolist() for _ in range(40)]
    got = {}
    for k, ns in NS.items():
        old = ns.core.set_default_hub(None)
        try:
            hub, backend, block = _stack(ns, n, src, dst)
            if burst == "lanes":
                counts = backend.cascade_rows_lanes(block, groups)
            else:
                mesh = (ns.parallel.graph_mesh(8, device="cpu") if ns.port
                        else ns.parallel.graph_mesh())
                counts = backend.cascade_rows_lanes_sharded(block, groups, mesh)
            path = str(tmp_path / f"{k}.npz")
            ns.checkpoint.save_graph(backend.graph, path)
            with np.load(path) as z:
                arrays = {key: z[key].tolist() for key in z.files}
            assert arrays["invalid"] == backend.graph._h_invalid[:n].tolist()
            got[k] = (np.asarray(counts).tolist(), arrays)
        finally:
            ns.core.set_default_hub(old)
    assert got["jax"] == got["port"]
    assert sum(got["port"][0]) > 0 and any(got["port"][1]["invalid"])


# ---------------------------------------------------------------- the durable example
async def test_hello_cart_durable_flow(tmp_path):
    """``examples/hello_cart_durable.py`` through each package: products
    in sqlite under the atomic operation scope, a checkpoint, an edit from
    another host while the first is down, the warm restart (no recompute)
    and the log replay from the watermark that invalidates exactly the
    stale entry."""
    async def run(ns):
        core, oplog = ns.core, ns.oplog

        @ns.wire_type("TwinDurableEditProduct")
        @dataclasses.dataclass(frozen=True)
        class EditProduct:
            id: str
            price: float

        class ProductDal:
            def __init__(self, path):
                self.db = oplog.ScopedSqliteDb(path)
                self.db.executescript(
                    "CREATE TABLE IF NOT EXISTS products (id TEXT PRIMARY KEY, price REAL)")

            def get(self, pid):
                row = self.db.execute("SELECT price FROM products WHERE id=?", (pid,)).fetchone()
                return row[0] if row else None

            def upsert(self, pid, price):
                self.db.execute(
                    "INSERT INTO products VALUES (?,?) ON CONFLICT(id) DO UPDATE SET "
                    "price=excluded.price", (pid, price))
                self.db.commit()

        class ProductService(core.ComputeService):
            def __init__(self, dal, hub=None):
                super().__init__(hub)
                self.dal = dal
                self.db_reads = 0

            @core.compute_method
            async def get_price(self, pid: str) -> float:
                self.db_reads += 1
                return self.dal.get(pid) or 0.0

            @ns.commands.command_handler
            async def edit(self, command: EditProduct):
                if core.is_invalidating():
                    await self.get_price(command.id)
                    return
                self.dal.upsert(command.id, command.price)

        class CartService(core.ComputeService):
            def __init__(self, products, hub=None):
                super().__init__(hub)
                self.products = products

            @core.compute_method
            async def total(self, *pids) -> float:
                return sum([await self.products.get_price(p) for p in pids])

        def make_host(db_path, log_store, notifier, attach_log=True):
            hub = core.FusionHub()
            products = hub.add_service(ProductService(ProductDal(db_path), hub))
            carts = hub.add_service(CartService(products, hub))
            hub.commander.add_service(products)
            oplog.attach_db_operation_scope(hub.commander, db_path)
            reader = (oplog.attach_operation_log(hub.commander, log_store, notifier)
                      if attach_log else None)
            return hub, products, carts, reader

        d = tmp_path / ns.name
        d.mkdir()
        db_path = str(d / "shared.sqlite")
        log_store = oplog.SqliteOperationLog(db_path)
        notifier = oplog.LocalChangeNotifier()
        ckpt_path = str(d / "host.ckpt")
        hub1, products1, carts1, reader1 = make_host(db_path, log_store, notifier)
        await hub1.commander.call(EditProduct("apple", 2.0))
        await hub1.commander.call(EditProduct("banana", 0.5))
        seen = [await carts1.total("apple", "apple", "banana"), products1.db_reads]
        snap = ns.checkpoint.HubCheckpoint.save(hub1, ckpt_path,
                                                oplog_position=log_store.last_index(),
                                                log_store=log_store)
        await reader1.stop()
        del hub1, products1, carts1
        hub2, _p2, _c2, reader2 = make_host(db_path, log_store, notifier)
        await hub2.commander.call(EditProduct("apple", 3.0))
        await reader2.stop()
        hub1b, products1b, carts1b, _ = make_host(db_path, log_store, notifier, attach_log=False)
        restored = ns.checkpoint.HubCheckpoint.restore(hub1b, ckpt_path)
        node = await core.capture(lambda: carts1b.total("apple", "apple", "banana"))
        seen += [restored.count, node.value, products1b.db_reads]
        reader1b = oplog.attach_operation_log(hub1b.commander, log_store, notifier,
                                              start_position=restored.oplog_position)
        try:
            await asyncio.wait_for(node.when_invalidated(), 10.0)
            seen += [await carts1b.total("apple", "apple", "banana"), products1b.db_reads,
                     log_store.last_index()]
        finally:
            await reader1b.stop()
            log_store.close()
        assert seen[0] == 4.5 and seen[3:5] == [4.5, 0] and seen[5:7] == [6.5, 1]
        return seen, contents(snap)
    await both(run)
