"""Parity of the port's operation log and multi-host reader
(``stl_fusion_tpu_torch/oplog``, over ``commands`` and ``operations``) with
the JAX package's: the 21 cases of ``tests/test_oplog.py`` (cross-host
invalidation over in-memory and sqlite logs, watermark replay, own
operations, trim, the atomic sqlite scope in a subprocess that crashes
between the write and the append, the cross-process writer, multi-host
chaos, torn-log quarantine and index gaps, the trimmer's guards, the
invalidating sink, the external batch as one lane burst, read-your-writes
beside a reader's batch, cancellation mid-batch, WAL), each run as one
scenario through both packages with the reference's assertions, their
observations (values read, ``is_invalidated`` flags, handled counts,
watermarks, quarantined ranges, log records by command, agent and order,
not uuids) required EQUAL. Subprocess writers run the package under test.
The lane-burst case also runs at 20,000 nodes of ``power_law_dag`` with a
real graph backend on each side (a table bound as one row block), and
requires equal per-group counts, union and stale rows. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
import dataclasses
import os
import random
import sqlite3
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

import stl_fusion_tpu
import stl_fusion_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ns(pkg):
    """A package's modules and this file's per-package types (each package
    keeps its own wire registry, so each gets its own command classes)."""
    name = pkg.__name__
    imp = __import__
    mods = {m: imp(f"{name}.{m}", fromlist=["_"]) for m in (
        "core", "commands", "oplog", "checkpoint", "graph", "diagnostics")}
    ns = types.SimpleNamespace(name=name, **mods)
    ns.pipeline = imp(f"{name}.operations.pipeline", fromlist=["_"])
    ns.durable = imp(f"{name}.checkpoint.durable", fromlist=["_"])
    ns.wire_type = imp(f"{name}.utils.serialization", fromlist=["_"]).wire_type
    core, commands = ns.core, ns.commands
    ns.DB = {}

    @ns.wire_type("TwinSetValue")
    @dataclasses.dataclass(frozen=True)
    class SetValue:
        key: str
        value: int

    class ValueService(core.ComputeService):
        @core.compute_method
        async def get(self, key: str) -> int:
            return ns.DB.get(key, 0)

        @commands.command_handler
        async def set_value(self, command: SetValue):
            if core.is_invalidating():
                await self.get(command.key)
                return
            ns.DB[command.key] = command.value

    ns.SetValue, ns.ValueService = SetValue, ValueService
    return ns


NS = {"jax": _ns(stl_fusion_tpu), "port": _ns(stl_fusion_tpu_torch)}


async def both(scenario, *args):
    """Run ``scenario(ns, *args)`` for each package under a fresh default
    hub with an empty DB; the observations must be equal."""
    got = []
    for ns in NS.values():
        ns.DB.clear()
        hub = ns.core.FusionHub()
        old = ns.core.set_default_hub(hub)
        try:
            got.append(await scenario(ns, *args))
        finally:
            ns.core.set_default_hub(old)
    assert got[0] == got[1], got
    return got[1]


def make_host(ns, log_store, notifier):
    hub = ns.core.FusionHub()
    svc = ns.ValueService(hub)
    hub.commander.add_service(svc)
    reader = ns.oplog.attach_operation_log(hub.commander, log_store, notifier)
    return hub, svc, reader


def records(log_store, agents):
    """The log's records by command, agent label and order (no uuids)."""
    return [(type(r.command).__name__, dataclasses.asdict(r.command)
             if dataclasses.is_dataclass(r.command) else r.command,
             agents.get(r.agent_id, "?"), r.index) for r in log_store.read_after(0)]


async def test_cross_host_invalidation_in_memory():
    async def run(ns):
        log_store = ns.oplog.InMemoryOperationLog()
        notifier = ns.oplog.LocalChangeNotifier()
        hub_a, svc_a, reader_a = make_host(ns, log_store, notifier)
        hub_b, svc_b, reader_b = make_host(ns, log_store, notifier)
        try:
            seen = [await svc_b.get("x")]
            node_b = await ns.core.capture(lambda: svc_b.get("x"))
            await hub_a.commander.call(ns.SetValue("x", 42))
            await asyncio.wait_for(node_b.when_invalidated(), 5.0)
            seen += [await svc_b.get("x"), await svc_a.get("x")]
            assert seen == [0, 42, 42]
            agents = {hub_a.commander.operations.agent.id: "a"}
            return seen, records(log_store, agents)
        finally:
            await reader_a.stop()
            await reader_b.stop()
    await both(run)


async def test_cross_host_invalidation_sqlite(tmp_path):
    async def run(ns):
        log_store = ns.oplog.SqliteOperationLog(str(tmp_path / f"{ns.name}.sqlite"))
        notifier = ns.oplog.LocalChangeNotifier()
        hub_a, svc_a, reader_a = make_host(ns, log_store, notifier)
        hub_b, svc_b, reader_b = make_host(ns, log_store, notifier)
        try:
            seen = [await svc_b.get("k")]
            node_b = await ns.core.capture(lambda: svc_b.get("k"))
            await hub_a.commander.call(ns.SetValue("k", 7))
            await asyncio.wait_for(node_b.when_invalidated(), 5.0)
            seen += [await svc_b.get("k"), log_store.last_index()]
            assert seen == [0, 7, 1]
            return seen, records(log_store, {hub_a.commander.operations.agent.id: "a"})
        finally:
            await reader_a.stop()
            await reader_b.stop()
            log_store.close()
    await both(run)


async def test_restarted_host_replays_from_watermark(tmp_path):
    async def run(ns):
        log_store = ns.oplog.SqliteOperationLog(str(tmp_path / f"{ns.name}.sqlite"))
        hub_a, svc_a, reader_a = make_host(ns, log_store, ns.oplog.LocalChangeNotifier())
        try:
            await hub_a.commander.call(ns.SetValue("w", 1))
        finally:
            await reader_a.stop()
        ns.DB["w"] = 1
        hub_b = ns.core.FusionHub()
        svc_b = ns.ValueService(hub_b)
        hub_b.commander.add_service(svc_b)
        hub_b.commander.attach_operations_pipeline()
        reader_b = ns.oplog.OperationLogReader(log_store, hub_b.commander.operations,
                                               start_from_end=False)
        try:
            node = await ns.core.capture(lambda: svc_b.get("w"))
            seen = [node.is_consistent, await reader_b.read_new(), node.is_invalidated]
            assert seen == [True, 1, True]
            return seen
        finally:
            await reader_b.stop()
            log_store.close()
    await both(run)


async def test_own_operations_not_replayed():
    async def run(ns):
        log_store = ns.oplog.InMemoryOperationLog()
        hub_a, svc_a, reader_a = make_host(ns, log_store, ns.oplog.LocalChangeNotifier())
        try:
            await hub_a.commander.call(ns.SetValue("self", 1))
            await asyncio.sleep(0.1)
            seen = [reader_a.external_seen, log_store.last_index()]
            assert seen == [0, 1]
            return seen
        finally:
            await reader_a.stop()
    await both(run)


async def test_log_trim():
    async def run(ns):
        log_store = ns.oplog.InMemoryOperationLog()
        for i in range(5):
            log_store.append(ns.oplog.OperationRecord(f"op{i}", "agent", float(i), None, ()))
        seen = [log_store.trim_before(3.0), [r.id for r in log_store.read_after(0)]]
        assert seen == [3, ["op3", "op4"]]
        return seen
    await both(run)


# ------------------------------------------------------------ atomic scope

ATOMIC_HOST = r'''
import asyncio, dataclasses, os, sys
sys.path.insert(0, os.environ["REPO"])
from PKG.core import ComputeService, FusionHub, compute_method, is_invalidating
from PKG.commands import command_handler
from PKG.oplog import ScopedSqliteDb, attach_db_operation_scope
from PKG.utils.serialization import wire_type

DB_PATH = os.environ["DB"]
CRASH = os.environ.get("CRASH", "")

@wire_type("TwinAtomicEdit")
@dataclasses.dataclass(frozen=True)
class Edit:
    id: str
    price: float

class Products(ComputeService):
    def __init__(self, hub=None):
        super().__init__(hub)
        self.db = ScopedSqliteDb(DB_PATH)
        self.db.executescript("CREATE TABLE IF NOT EXISTS products (id TEXT PRIMARY KEY, price REAL)")

    @compute_method
    async def get(self, pid: str) -> float:
        row = self.db.execute("SELECT price FROM products WHERE id=?", (pid,)).fetchone()
        return row[0] if row else 0.0

    @command_handler
    async def edit(self, command: Edit):
        if is_invalidating():
            await self.get(command.id)
            return
        self.db.execute(
            "INSERT INTO products VALUES (?,?) ON CONFLICT(id) DO UPDATE SET price=excluded.price",
            (command.id, command.price),
        )
        self.db.commit()
        if CRASH == "mid":
            os._exit(1)

async def main():
    hub = FusionHub()
    svc = hub.add_service(Products(hub))
    hub.commander.add_service(svc)
    attach_db_operation_scope(hub.commander, DB_PATH)
    await hub.commander.call(Edit("apple", 9.0))
    if CRASH == "after":
        os._exit(1)
    print("price", await svc.get("apple"))

asyncio.run(main())
'''


def _run_script(ns, script, **env_extra):
    env = dict(os.environ, REPO=REPO, **env_extra)
    return subprocess.run([sys.executable, "-c", script.replace("PKG", ns.name)], env=env,
                          capture_output=True, text=True, timeout=120)


def _read_shared(path):
    conn = sqlite3.connect(path)
    try:
        try:
            products = conn.execute("SELECT id, price FROM products").fetchall()
        except sqlite3.OperationalError:
            products = []
        try:
            ops = conn.execute("SELECT id FROM operations").fetchall()
        except sqlite3.OperationalError:
            ops = []
        return products, len(ops)
    finally:
        conn.close()


def _atomic(ns, tmp_path, crash):
    db = str(tmp_path / f"{ns.name}-{crash or 'none'}.sqlite")
    res = _run_script(ns, ATOMIC_HOST, DB=db, CRASH=crash)
    return res, db


def test_atomic_scope_crash_between_write_and_append_loses_nothing(tmp_path):
    got = []
    for ns in NS.values():
        res, db = _atomic(ns, tmp_path, "mid")
        assert res.returncode == 1, res.stderr
        products, ops = _read_shared(db)
        assert products == [] and ops == 0
        got.append((res.returncode, products, ops))
    assert got[0] == got[1]


def test_atomic_scope_crash_after_commit_keeps_both(tmp_path):
    got = []
    for ns in NS.values():
        res, db = _atomic(ns, tmp_path, "after")
        assert res.returncode == 1, res.stderr
        products, ops = _read_shared(db)
        assert products == [("apple", 9.0)] and ops == 1
        got.append((res.returncode, products, ops))
    assert got[0] == got[1]


def test_atomic_scope_normal_flow_and_replay(tmp_path):
    got = []
    for ns in NS.values():
        res, db = _atomic(ns, tmp_path, "")
        assert res.returncode == 0, res.stderr
        assert "price 9.0" in res.stdout
        products, ops = _read_shared(db)
        assert products == [("apple", 9.0)] and ops == 1

        @ns.wire_type("TwinAtomicEdit")
        @dataclasses.dataclass(frozen=True)
        class Edit:
            id: str
            price: float

        log_store = ns.oplog.SqliteOperationLog(db)
        try:
            recs = log_store.read_after(0)
            assert len(recs) == 1 and recs[0].command == Edit("apple", 9.0)
            got.append((products, [(r.index, dataclasses.asdict(r.command)) for r in recs]))
        finally:
            log_store.close()
    assert got[0] == got[1]


async def test_atomic_scope_rollback_on_handler_failure(tmp_path):
    async def run(ns):
        db_path = str(tmp_path / f"{ns.name}-roll.sqlite")
        core = ns.core

        @ns.wire_type("TwinRollEdit")
        @dataclasses.dataclass(frozen=True)
        class RollEdit:
            id: str
            boom: bool = False

        class Svc(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.db = ns.oplog.ScopedSqliteDb(db_path)
                self.db.executescript("CREATE TABLE IF NOT EXISTS t (id TEXT PRIMARY KEY)")

            @core.compute_method
            async def has(self, pid: str) -> bool:
                return self.db.execute("SELECT 1 FROM t WHERE id=?", (pid,)).fetchone() is not None

            @ns.commands.command_handler
            async def edit(self, command: RollEdit):
                if core.is_invalidating():
                    await self.has(command.id)
                    return
                self.db.execute("INSERT INTO t VALUES (?)", (command.id,))
                self.db.commit()
                if command.boom:
                    raise RuntimeError("handler failed after write")

        hub = core.FusionHub()
        svc = hub.add_service(Svc(hub))
        hub.commander.add_service(svc)
        ns.oplog.attach_db_operation_scope(hub.commander, db_path)
        with pytest.raises(RuntimeError):
            await hub.commander.call(RollEdit("x", boom=True))
        seen = [await svc.has("x")]
        conn = sqlite3.connect(db_path)
        seen.append(conn.execute("SELECT COUNT(*) FROM operations").fetchone()[0])
        conn.close()
        await hub.commander.call(RollEdit("y"))
        node = await core.capture(lambda: svc.has("y"))
        seen.append(node.value)
        assert seen == [False, 0, True]
        return seen
    await both(run)


# ------------------------------------------------ cross-PROCESS multi-host

async def test_file_change_notifier_cross_instance(tmp_path):
    async def run(ns):
        path = str(tmp_path / f"{ns.name}.touch")
        writer = ns.oplog.FileChangeNotifier(path)
        reader = ns.oplog.FileChangeNotifier(path)
        wake = reader.subscribe()
        writer.notify()
        seen = [reader.poll(), wake.is_set()]
        wake.clear()
        seen += [reader.poll(), wake.is_set()]
        writer.notify()
        seen += [reader.poll(), wake.is_set()]
        assert seen == [True, True, False, False, True, True]
        return seen
    await both(run)


CROSS_WRITER = r'''
import asyncio, dataclasses, os, sys
sys.path.insert(0, os.environ["REPO"])
from PKG.core import ComputeService, FusionHub, compute_method, is_invalidating
from PKG.commands import command_handler
from PKG.oplog import (FileChangeNotifier, ScopedSqliteDb, SqliteOperationLog,
                       attach_db_operation_scope, attach_operation_log)
from PKG.utils.serialization import wire_type

DB_PATH = os.environ["DB"]

@wire_type("TwinXProcSet")
@dataclasses.dataclass(frozen=True)
class XSet:
    key: str
    value: int

class Values(ComputeService):
    def __init__(self, hub=None):
        super().__init__(hub)
        self.db = ScopedSqliteDb(DB_PATH)
        self.db.executescript("CREATE TABLE IF NOT EXISTS vals (k TEXT PRIMARY KEY, v INTEGER)")

    @compute_method
    async def get(self, key: str) -> int:
        row = self.db.execute("SELECT v FROM vals WHERE k=?", (key,)).fetchone()
        return row[0] if row else 0

    @command_handler
    async def set_value(self, command: XSet):
        if is_invalidating():
            await self.get(command.key)
            return
        self.db.execute("INSERT INTO vals VALUES (?,?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                        (command.key, command.value))
        self.db.commit()

async def main():
    hub = FusionHub()
    svc = hub.add_service(Values(hub))
    hub.commander.add_service(svc)
    attach_db_operation_scope(hub.commander, DB_PATH)
    log_store = SqliteOperationLog(DB_PATH)
    reader = attach_operation_log(hub.commander, log_store,
                                  FileChangeNotifier(DB_PATH + ".touch"))
    await hub.commander.call(XSet("x", 41))
    await reader.stop()
    log_store.close()

asyncio.run(main())
'''


async def test_cross_process_write_invalidates_host_computed(tmp_path):
    """Process A, a real subprocess running the package under test with its
    own agent id, commits under the atomic scope; this process, host B,
    invalidates through the shared log and the FileChangeNotifier."""
    async def run(ns):
        core = ns.core
        db_path = str(tmp_path / f"{ns.name}-x.sqlite")

        @ns.wire_type("TwinXProcSet")
        @dataclasses.dataclass(frozen=True)
        class XSet:
            key: str
            value: int

        class Values(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.db = ns.oplog.ScopedSqliteDb(db_path)
                self.db.executescript(
                    "CREATE TABLE IF NOT EXISTS vals (k TEXT PRIMARY KEY, v INTEGER)")

            @core.compute_method
            async def get(self, key: str) -> int:
                row = self.db.execute("SELECT v FROM vals WHERE k=?", (key,)).fetchone()
                return row[0] if row else 0

            @ns.commands.command_handler
            async def set_value(self, command: XSet):
                if core.is_invalidating():
                    await self.get(command.key)
                    return
                self.db.execute(
                    "INSERT INTO vals VALUES (?,?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                    (command.key, command.value))
                self.db.commit()

        hub = core.FusionHub()
        svc = hub.add_service(Values(hub))
        hub.commander.add_service(svc)
        ns.oplog.attach_db_operation_scope(hub.commander, db_path)
        log_store = ns.oplog.SqliteOperationLog(db_path)
        notifier = ns.oplog.FileChangeNotifier(db_path + ".touch")
        reader = ns.oplog.attach_operation_log(hub.commander, log_store, notifier)
        reader.poll_period = 0.05
        try:
            seen = [await svc.get("x")]
            node = await core.capture(lambda: svc.get("x"))
            res = await asyncio.to_thread(_run_script, ns, CROSS_WRITER, DB=db_path)
            assert res.returncode == 0, res.stderr
            await asyncio.wait_for(node.when_invalidated(), 30.0)
            seen += [await svc.get("x"), reader.external_seen]
            assert seen == [0, 41, 1]
            return seen, records(log_store, {})
        finally:
            await reader.stop()
            log_store.close()
    await both(run)


# ------------------------------------------------ multi-host chaos

async def test_multihost_chaos_convergence():
    """Commands land on either host while each host's reader is killed and
    restarted from its watermark; both hosts converge to the DB, and both
    hosts' graphs pass the ``validate_hub`` sweep (I1-I5)."""
    async def run(ns):
        out = []
        for seed in (3, 4):
            ns.DB.clear()
            log_store = ns.oplog.InMemoryOperationLog()
            notifier = ns.oplog.LocalChangeNotifier()
            hub_a, svc_a, reader_a = make_host(ns, log_store, notifier)
            hub_b, svc_b, reader_b = make_host(ns, log_store, notifier)
            readers = {"a": reader_a, "b": reader_b}
            hubs = {"a": hub_a, "b": hub_b}
            svcs = {"a": svc_a, "b": svc_b}
            rnd = random.Random(seed)
            keys = ["k1", "k2", "k3"]
            counter = 0
            try:
                for host in ("a", "b"):
                    for k in keys:
                        await svcs[host].get(k)
                for _ in range(50):
                    action = rnd.random()
                    host = rnd.choice(["a", "b"])
                    k = rnd.choice(keys)
                    if action < 0.5:
                        counter += 1
                        await hubs[host].commander.call(ns.SetValue(k, counter))
                    elif action < 0.7:
                        await svcs[host].get(k)
                    else:
                        old = readers[host]
                        position = old.watermark
                        await old.stop()
                        new = ns.oplog.OperationLogReader(
                            log_store, hubs[host].commander.operations, notifier,
                            start_position=position)
                        new.poll_period = 0.02
                        new.start()
                        readers[host] = new
                    await asyncio.sleep(rnd.random() * 0.003)
                loop = asyncio.get_event_loop()
                for host in ("a", "b"):
                    for k in keys:
                        want = ns.DB.get(k, 0)
                        deadline = loop.time() + 30.0
                        while (await svcs[host].get(k)) != want:
                            assert loop.time() < deadline, (seed, host, k, want)
                            await asyncio.sleep(0.05)
                ns.diagnostics.validate_hub(hub_a).require()
                ns.diagnostics.validate_hub(hub_b).require()
                out.append((seed, dict(sorted(ns.DB.items())), log_store.last_index()))
            finally:
                for r in readers.values():
                    await r.stop()
        return out
    await both(run)


# ------------------------------------------------ torn-log quarantine

async def _write_ops(ns, tmp_path, keys):
    path = str(tmp_path / f"{ns.name}-ops.sqlite")
    log_store = ns.oplog.SqliteOperationLog(path)
    hub_a, svc_a, reader_a = make_host(ns, log_store, ns.oplog.LocalChangeNotifier())
    await reader_a.stop()
    for i, k in enumerate(keys):
        await hub_a.commander.call(ns.SetValue(k, i + 1))
    return path, log_store


def _cold_boot_reader(ns, log_store):
    hub_b = ns.core.FusionHub()
    svc_b = ns.ValueService(hub_b)
    hub_b.commander.add_service(svc_b)
    hub_b.commander.attach_operations_pipeline()
    reader_b = ns.oplog.OperationLogReader(log_store, hub_b.commander.operations,
                                           start_from_end=False)
    return hub_b, svc_b, reader_b


def _ranges(reader):
    return [(r.first_index, r.last_index, r.reason, r.clamps_trimmer,
             r.commit_floor is not None) for r in reader.quarantined]


async def test_reader_quarantines_corrupt_entry_and_resumes(tmp_path):
    async def run(ns):
        keys = ["c1", "c2", "c3"]
        path, log_store = await _write_ops(ns, tmp_path, keys)
        conn = sqlite3.connect(path)
        conn.execute(
            "UPDATE operations SET command_json = substr(command_json, 1, 4) WHERE idx = 2")
        conn.commit()
        conn.close()
        hub_b, svc_b, reader_b = _cold_boot_reader(ns, log_store)
        try:
            nodes = {k: await ns.core.capture(lambda k=k: svc_b.get(k)) for k in keys}
            seen = [await reader_b.read_new(), reader_b.corrupt_seen, reader_b.watermark,
                    [(r[0], r[1]) for r in _ranges(reader_b)],
                    nodes["c1"].is_invalidated, nodes["c3"].is_invalidated,
                    await svc_b.get("c1"), await svc_b.get("c3")]
            assert seen == [2, 1, 3, [(2, 2)], True, True, 1, 3]
            trimmer = ns.oplog.OperationLogTrimmer(log_store, max_age=0.0,
                                                   quarantine_guard=reader_b)
            trimmed = trimmer.trim_once()
            assert trimmed <= 1 and trimmer.clamped_trims == 1
            remaining = [r.index for r in log_store.read_after(0)]
            assert 2 in remaining and 3 in remaining
            unguarded = ns.oplog.OperationLogTrimmer(log_store, max_age=0.0).trim_once()
            assert unguarded == len(remaining) and log_store.read_after(0) == []
            return seen, trimmed, remaining, unguarded
        finally:
            await reader_b.stop()
            log_store.close()
    await both(run)


async def test_reader_detects_index_gap_and_resumes(tmp_path):
    async def run(ns):
        keys = ["g1", "g2", "g3", "g4"]
        path, log_store = await _write_ops(ns, tmp_path, keys)
        conn = sqlite3.connect(path)
        conn.execute("DELETE FROM operations WHERE idx = 2")
        conn.commit()
        conn.close()
        hub_b, svc_b, reader_b = _cold_boot_reader(ns, log_store)
        try:
            seen = [await reader_b.read_new(), reader_b.gaps_seen, _ranges(reader_b),
                    reader_b.watermark, reader_b.quarantine_floor()]
            assert seen[:2] == [3, 1] and seen[3] == 4 and seen[4] is None
            assert seen[2][0][:2] == (2, 2) and not seen[2][0][3] and seen[2][0][4]
            trimmer = ns.oplog.OperationLogTrimmer(log_store, max_age=0.0,
                                                   quarantine_guard=reader_b)
            seen += [trimmer.trim_once(), trimmer.clamped_trims]
            assert seen[-2:] == [3, 0]
            return seen
        finally:
            await reader_b.stop()
            log_store.close()
    await both(run)


async def test_trimmer_resumes_normal_gc_without_quarantine(tmp_path):
    async def run(ns):
        path, log_store = await _write_ops(ns, tmp_path, ["n1", "n2"])
        hub_b, svc_b, reader_b = _cold_boot_reader(ns, log_store)
        try:
            await reader_b.read_new()
            seen = [reader_b.quarantined, reader_b.quarantine_floor()]
            trimmer = ns.oplog.OperationLogTrimmer(log_store, max_age=0.0,
                                                   quarantine_guard=reader_b)
            seen += [trimmer.trim_once(), trimmer.clamped_trims]
            assert seen == [[], None, 2, 0]
            return seen
        finally:
            await reader_b.stop()
            log_store.close()
    await both(run)


# ------------------------------------------------------ lane-packed batch replay

async def test_invalidating_sink_collects_without_cascading():
    async def run(ns):
        hub = ns.core.FusionHub()
        old = ns.core.set_default_hub(hub)
        try:
            svc = ns.ValueService(hub)
            hub.commander.add_service(svc)
            node = await ns.core.capture(lambda: svc.get("s"))
            sink = []
            with ns.core.invalidating(sink=sink):
                await svc.get("s")
            seen = [sink == [node], node.is_consistent]
            node.invalidate()
            seen.append(node.is_invalidated)
            assert seen == [True, True, True]
            return seen
        finally:
            ns.core.set_default_hub(old)
    await both(run)


def _backend(ns, hub, **kw):
    if ns.name == "stl_fusion_tpu_torch":
        kw["device"] = "cpu"
    return ns.graph.TpuGraphBackend(hub, **kw)


async def test_external_batch_replays_as_one_lane_burst():
    async def run(ns):
        core = ns.core
        log_store = ns.oplog.InMemoryOperationLog()
        notifier = ns.oplog.LocalChangeNotifier()
        hub_a, svc_a, reader_a = make_host(ns, log_store, notifier)
        hub_b = core.FusionHub()
        old = core.set_default_hub(hub_b)
        backend = _backend(ns, hub_b)
        svc_b = ns.ValueService(hub_b)
        hub_b.commander.add_service(svc_b)
        reader_b = ns.oplog.attach_operation_log(hub_b.commander, log_store, notifier,
                                                 start_reader=False)
        try:
            keys = [f"k{i}" for i in range(8)]

            class Agg(core.ComputeService):
                @core.compute_method
                async def total(self) -> int:
                    return sum([await svc_b.get(k) for k in keys])

            agg = Agg(hub_b)
            total_node = await core.capture(lambda: agg.total())
            nodes = {k: await core.capture(lambda k=k: svc_b.get(k)) for k in keys}
            for i, k in enumerate(keys[:5]):
                await hub_a.commander.call(ns.SetValue(k, 100 + i))
            waves_before = backend.waves_run
            dev_before = backend.device_invalidations
            seen = [await reader_b.read_new(), backend.waves_run - waves_before,
                    backend.device_invalidations - dev_before]
            assert seen[:2] == [5, 5] and seen[2] > 0
            for k in keys[:5]:
                assert nodes[k].is_invalidated or backend._pending[backend.id_for(nodes[k])]
            seen += [total_node.is_invalidated, nodes["k7"].is_invalidated, await agg.total()]
            assert seen[3:] == [True, False, sum(100 + i for i in range(5))]
            return seen
        finally:
            await reader_a.stop()
            await reader_b.stop()
            core.set_default_hub(old)
    await both(run)


LANE_N = 20_000


async def test_external_batch_lane_burst_at_20000_nodes():
    """The reader's batch replay at 20,000 nodes of ``power_law_dag`` (a
    table bound as one row block, its edges declared, the topo mirror
    built) with a real graph backend on each side: 256 operations of 8
    rows from host A (no backend) replay on host B as ONE lane burst; the
    per-group counts, the union, the stale rows and the values read back
    must be equal across the packages."""
    from stl_fusion_tpu_torch.graph.synthetic import power_law_dag
    from stl_fusion_tpu_torch.live_path import make_dag_service

    src, dst = power_law_dag(LANE_N, avg_degree=3, seed=7)

    async def run(ns):
        core = ns.core
        port = ns.name == "stl_fusion_tpu_torch"
        if port:
            to_device = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        else:
            import jax.numpy as jnp

            to_device = jnp.asarray
        dag_type = make_dag_service(core, LANE_N, to_device)
        spec = dag_type.node.__compute_method_def__.table
        if port:
            spec.device = "cpu"
        hub_b = core.FusionHub()
        backend = _backend(ns, hub_b, node_capacity=LANE_N + 64,
                           edge_capacity=len(src) + 4096)
        svc_b = dag_type(hub_b)
        hub_b.add_service(svc_b, "dag")
        table = core.memo_table_of(svc_b.node)
        block = backend.bind_table_rows(table)
        backend.declare_row_edges(block, src, block, dst)
        backend.warm_block_on_device(block)
        backend.flush()
        backend.build_topo_mirror()
        base = svc_b.base

        @ns.wire_type("TwinRowsSet")
        @dataclasses.dataclass(frozen=True)
        class RowsSet:
            rows: tuple
            value: float

        def serve(hub, dag):
            async def rows_set(command):
                if core.is_invalidating():
                    for r in command.rows:
                        await dag.node(int(r))
                    return
                base[np.asarray(command.rows, np.int64)] = command.value
                svc_b._base_dev = None  # the device loader re-uploads base

            hub.commander.add_handler(rows_set, command_type=RowsSet)

        hub_a = core.FusionHub()
        dag_a = dag_type(hub_a)
        dag_a.base = base
        serve(hub_a, dag_a)
        serve(hub_b, svc_b)
        log_store = ns.oplog.InMemoryOperationLog()
        ns.oplog.attach_operation_log(hub_a.commander, log_store, start_reader=False)
        reader = ns.oplog.attach_operation_log(hub_b.commander, log_store, start_reader=False)
        rng = np.random.default_rng(5)
        # rows of the graph's upper half: closures that stop short of the
        # whole graph, so the union and the stale rows tell lanes apart
        groups = [LANE_N // 2 + rng.choice(LANE_N // 2, size=8, replace=False)
                  for _ in range(256)]
        rows = np.unique(np.concatenate(groups))
        nodes = [await core.capture(lambda: svc_b.node(int(r))) for r in rows]
        backend.flush()
        for i, g in enumerate(groups):
            await hub_a.commander.call(RowsSet(tuple(g.tolist()), float(1_000_000 + i)))
        bursts = []
        lanes = backend.invalidate_cascade_batch_lanes
        backend.invalidate_cascade_batch_lanes = lambda gs: bursts.append(lanes(gs)) or bursts[-1]
        handled = await reader.read_new()
        assert handled == 256 and len(bursts) == 1 and len(nodes) == rows.size
        counts = np.asarray(bursts[0]).tolist()
        union = np.nonzero(backend.graph._h_invalid[:LANE_N])[0].tolist()
        stale = np.nonzero(np.asarray(table._stale_host))[0].tolist()
        got = np.asarray(table.read_batch(rows)).tolist()
        scalar = [await svc_b.node(int(r)) for r in rows]
        assert got == base[rows].tolist() and scalar == got
        assert sum(counts) > 0 and 0 < len(union) < LANE_N
        return counts, union, stale, got

    await both(run)


async def test_concurrent_local_command_cascades_despite_reader_batch():
    async def run(ns):
        hub = ns.core.FusionHub()
        old = ns.core.set_default_hub(hub)
        try:
            hub.commander.attach_operations_pipeline()
            svc = ns.ValueService(hub)
            hub.commander.add_service(svc)
            node = await ns.core.capture(lambda: svc.get("rw"))
            entered = asyncio.Event()
            release = asyncio.Event()

            async def fake_reader():
                groups = []
                with ns.pipeline.batch_cascade_scope(groups.append):
                    entered.set()
                    await release.wait()
                return groups

            task = asyncio.ensure_future(fake_reader())
            await asyncio.wait_for(entered.wait(), 5.0)
            await hub.commander.call(ns.SetValue("rw", 9))
            seen = [node.is_invalidated, await svc.get("rw")]
            release.set()
            seen.append(await task)
            assert seen == [True, 9, []]
            return seen
        finally:
            ns.core.set_default_hub(old)
    await both(run)


async def test_reader_cancellation_mid_batch_applies_collected_groups():
    async def run(ns):
        core = ns.core
        log_store = ns.oplog.InMemoryOperationLog()
        hub_a, svc_a, reader_a = make_host(ns, log_store, None)
        await reader_a.stop()
        hub_b = core.FusionHub()
        old = core.set_default_hub(hub_b)
        backend = _backend(ns, hub_b)
        svc_b = ns.ValueService(hub_b)
        hub_b.commander.add_service(svc_b)
        reader_b = ns.oplog.attach_operation_log(hub_b.commander, log_store, None,
                                                 start_reader=False)
        try:
            nodes = {k: await core.capture(lambda k=k: svc_b.get(k)) for k in ("c1", "c2", "c3")}
            for k in ("c1", "c2", "c3"):
                await hub_a.commander.call(ns.SetValue(k, 5))
            blocked = asyncio.Event()
            release = asyncio.Event()
            seen_ops = [0]

            async def blocker(operation, is_local):
                if not is_local:
                    seen_ops[0] += 1
                    if seen_ops[0] == 2:
                        blocked.set()
                        await release.wait()

            hub_b.commander.operations.completion_listeners.append(blocker)
            task = asyncio.ensure_future(reader_b.read_new())
            await asyncio.wait_for(blocked.wait(), 5.0)
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            applied = [nodes[k].is_invalidated or bool(backend._pending[backend.id_for(nodes[k])])
                       for k in ("c1", "c2")]
            seen = [applied, reader_b.watermark, await svc_b.get("c1")]
            assert seen[0] == [True, True] and seen[2] == 5
            return seen
        finally:
            await reader_b.stop()
            core.set_default_hub(old)
    await both(run)


# ------------------------------------------------------------ durability

def test_sqlite_wal_mode_and_concurrent_append_read(tmp_path):
    got = []
    for ns in NS.values():
        path = str(tmp_path / f"{ns.name}-wal.sqlite")
        writer_log = ns.oplog.SqliteOperationLog(path)
        reader_log = ns.oplog.SqliteOperationLog(path)
        assert writer_log.journal_mode == "wal", writer_log.journal_mode
        n_ops = 200
        errors = []
        seen_max = [0]

        def write():
            try:
                for i in range(n_ops):
                    writer_log.append(
                        ns.oplog.OperationRecord(f"op{i}", "writer", float(i + 1), None, ()))
            except Exception as e:  # noqa: BLE001 — the regression under test
                errors.append(e)

        def read():
            try:
                while seen_max[0] < n_ops and not errors:
                    rows = reader_log.read_after(0)
                    if rows:
                        seen_max[0] = max(seen_max[0], rows[-1].index)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=write), threading.Thread(target=read)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        try:
            assert errors == [] and seen_max[0] == n_ops
            assert writer_log.last_index() == n_ops
            recs = reader_log.read_after(0)
            assert len(recs) == n_ops
            got.append([(r.id, r.index, r.commit_time) for r in recs])
        finally:
            writer_log.close()
            reader_log.close()
    assert got[0] == got[1]


def test_trimmer_respects_min_of_quarantine_and_snapshot_floors(tmp_path):
    class QGuard:
        def __init__(self, floor):
            self._floor = floor

        def quarantine_floor(self):
            return self._floor

    got = []
    for ns in NS.values():
        def fresh_log():
            log_store = ns.oplog.InMemoryOperationLog()
            for i in range(6):
                log_store.append(ns.oplog.OperationRecord(f"t{i}", "agent", float(i), None, ()))
            return log_store

        mgr = ns.checkpoint.CheckpointManager(str(tmp_path / ns.name / "ckpts"))
        ns.durable.write_snapshot_file(
            mgr.path_of(1),
            {"format": 1, "nodes": [], "edges": [],
             "oplog": {"watermark": 2, "commit_floor": 2.0}})
        seen = [mgr.snapshot_floor()]
        log_store = fresh_log()
        trimmer = ns.oplog.OperationLogTrimmer(log_store, max_age=0.0,
                                               quarantine_guard=QGuard(4.0), snapshot_guard=mgr)
        seen += [trimmer.trim_once(), trimmer.clamped_trims, trimmer.snapshot_clamped_trims,
                 [r.index for r in log_store.read_after(0)]]
        log_store = fresh_log()
        trimmer = ns.oplog.OperationLogTrimmer(log_store, max_age=0.0,
                                               quarantine_guard=QGuard(1.0), snapshot_guard=mgr)
        seen += [trimmer.trim_once(), trimmer.snapshot_clamped_trims,
                 [r.index for r in log_store.read_after(0)]]
        empty_mgr = ns.checkpoint.CheckpointManager(str(tmp_path / ns.name / "empty"))
        log_store = fresh_log()
        trimmer = ns.oplog.OperationLogTrimmer(log_store, max_age=0.0, snapshot_guard=empty_mgr)
        seen += [trimmer.trim_once(), trimmer.snapshot_clamped_trims]
        assert seen == [2.0, 2, 1, 1, [3, 4, 5, 6], 1, 0, [2, 3, 4, 5, 6], 6, 0]
        got.append(seen)
    assert got[0] == got[1]
