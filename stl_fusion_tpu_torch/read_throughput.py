"""Twin of ``perf/read_throughput.py``: memoized read throughput over 1000
users, the reference's ``PerformanceTest.cs`` configuration.

    from stl_fusion_tpu_torch.read_throughput import run_read
    record = run_read()                 # the table on the CUDA device
    record = run_read(sizes=quick_sizes(), device="cpu")

N concurrent readers issue random ``users.get(id)`` calls against a sqlite
DAL of ``USER_COUNT`` users while one mutator does a read-modify-write every
10 ms. The modes are the script's, in its order and under its record keys:

- ``fusion_scalar`` — the scalar ``@compute_method`` path, the reference's
  loop shape; ``fusion_scalar_hot`` — the same service read from a
  precomputed id sequence (the framework's hit path);
- ``fusion_rpc_client`` — a compute client reads over the in-memory RPC
  transport (client-cache hits between the server's invalidations);
- ``fusion_rpc_vectorized`` / ``fusion_rpc_vectorized_hits`` — a
  ``RemoteTable`` reads batches of ``65,536`` ids from the served memo
  table, with the mutator and without;
- ``no_fusion`` — no memoization, every read a DB hit;
- ``fusion_vectorized`` — ``memo_table_of(users.get).read_batch`` of host
  id batches (``262,144``); ``fusion_vectorized_device_ids`` — batches of
  ``1,048,576`` ids drawn on the table's device (``torch.randint`` with a
  ``torch.Generator`` of the reader's seed), so no id crosses the host;
- ``fusion_device_chained`` — 64 gathers of ``1,048,576`` random ids on the
  device, queued back to back with one readback at the end (the script's
  ``lax.scan``): the device's own read rate.

Each mode ends with an exactness check the script lacks
(:class:`ReadCheckFailed` otherwise): every reader got ``iterations ×
batch`` rows; once the mutator stops, every user read through the mode's
surface (the scalar service, the RPC client, ``read_batch`` of all ids, the
``RemoteTable``) equals the DAL's row; the chain's readback equals the same
gathers done in plain torch on the CPU. The chain sums each gather in
float64, so the sums are exact and the comparison is equality.

``api`` runs the scenario through another package with this one's API (the
parity tests pass the JAX package's modules); ``sizes`` overrides the
script's iteration counts and batches (:data:`SIZES`; :func:`quick_sizes` is
``--quick``'s tenth). The script's ``--workers`` (scalar readers in N OS
processes) is not part of the twin.
"""
from __future__ import annotations

import asyncio
import os
import random
import sqlite3
import tempfile
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device

__all__ = ["MODES", "ReadApi", "ReadCheckFailed", "SIZES", "port_api", "quick_sizes",
           "run_read"]

USER_COUNT = 1000
#: the mutator's pause between writes (the reference's 10 ms)
MUTATOR_PERIOD_S = 0.01
#: readers a mode runs concurrently (the script's ``readers=4``)
READERS = 4
#: the script's modes, in its order (the record keys of their ops/s)
MODES = ("fusion_scalar", "fusion_scalar_hot", "fusion_rpc_client", "fusion_rpc_vectorized",
         "fusion_rpc_vectorized_hits", "no_fusion", "fusion_vectorized",
         "fusion_vectorized_device_ids", "fusion_device_chained")
#: the modes that touch no table (host-only)
HOST_MODES = ("fusion_scalar", "fusion_scalar_hot", "fusion_rpc_client", "no_fusion")
#: the script's iteration counts, and ``(iterations, batch)`` of the batched
#: modes, at full size (``--quick`` divides each by 10)
SIZES = {
    "fusion_scalar": 250_000, "fusion_scalar_hot": 250_000, "fusion_rpc_client": 100_000,
    "fusion_rpc_vectorized": (200, 65_536), "fusion_rpc_vectorized_hits": (400, 65_536),
    "no_fusion": 20_000, "fusion_vectorized": (100, 262_144),
    "fusion_vectorized_device_ids": (64, 1_048_576), "fusion_device_chained": (64, 1_048_576),
}
#: the seconds the exactness check waits for a pushed invalidation to land
CONVERGE_S = 10.0


class ReadCheckFailed(AssertionError):
    """A mode's exactness check failed."""


def quick_sizes() -> dict:
    """``--quick``'s sizes: the script divides each count by 10, and the
    batches of the local vectorized modes and the chain too."""
    return {"fusion_scalar": 25_000, "fusion_scalar_hot": 25_000, "fusion_rpc_client": 10_000,
            "fusion_rpc_vectorized": (20, 65_536), "fusion_rpc_vectorized_hits": (40, 65_536),
            "no_fusion": 2_000, "fusion_vectorized": (10, 26_214),
            "fusion_vectorized_device_ids": (6, 104_857), "fusion_device_chained": (64, 104_857)}


class ReadApi(NamedTuple):
    """What the scenario needs of a package: its ``core``, ``client`` and
    ``rpc`` modules, the ``TableBacking``'s extra arguments, the device id
    draws of a reader (``(seed, iterations, batch)`` → the batches, on the
    table's device), the device chain (``(table, n, batch)`` → ``(ops,
    seconds, readback, plain)``), a table result → numpy conversion and a
    device sync."""

    core: Any
    client: Any
    rpc: Any
    table_kwargs: dict
    device_ids: Callable[[int, int, int], Any]
    chain: Callable[[Any, int, int], tuple]
    to_host: Callable[[Any], np.ndarray]
    sync: Callable[[], None]
    name: str


def port_api(device=None) -> ReadApi:
    """This package with its tables on ``device`` (``cuda`` unless given)."""
    from . import client, core, rpc

    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def device_ids(seed: int, iterations: int, batch: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for _ in range(iterations):
            yield torch.randint(0, USER_COUNT, (batch,), generator=gen, device=dev,
                                dtype=torch.int32)

    return ReadApi(core, client, rpc, {"device": dev}, device_ids,
                   lambda table, n, batch: device_chain(table, n, batch, sync),
                   lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
                   sync, f"stl_fusion_tpu_torch on {dev}")


def device_chain(table, n_chained: int, batch: int, sync: Callable[[], None]) -> tuple:
    """``n_chained`` gathers of ``batch`` random ids (``default_rng(7)``, as
    the script draws them) from the table's values, each summed in float64
    into one device accumulator: queued back to back with one readback at
    the end. Returns ``(ops, seconds, readback, plain)``, ``plain`` the same
    gathers in plain torch on the CPU."""
    values = table.values
    rng = np.random.default_rng(7)
    id_np = rng.integers(0, table.n_rows, size=(n_chained, batch)).astype(np.int32)
    ids = torch.from_numpy(id_np).to(values.device)

    def run_all() -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float64, device=values.device)
        for i in range(n_chained):
            acc += values.index_select(0, ids[i]).sum(dtype=torch.float64)
        return acc

    float(run_all())  # warm
    sync()
    t0 = time.perf_counter()
    got = float(run_all())  # the one readback
    elapsed = time.perf_counter() - t0
    cpu_values, cpu_ids = values.cpu(), torch.from_numpy(id_np)
    plain = float(sum(cpu_values.index_select(0, cpu_ids[i]).sum(dtype=torch.float64)
                      for i in range(n_chained)))
    return n_chained * batch, elapsed, got, plain


# ---------------------------------------------------------------- the DAL
def make_db(path: str) -> None:
    db = sqlite3.connect(path)
    db.execute("CREATE TABLE users (id INTEGER PRIMARY KEY, name TEXT, email TEXT)")
    db.executemany(
        "INSERT INTO users VALUES (?, ?, ?)",
        [(i, f"user{i}", f"{i}@example.com") for i in range(USER_COUNT)],
    )
    db.commit()
    db.close()


class UserDal:
    """The sqlite DAL every service shares."""

    def __init__(self, path: str):
        self.db = sqlite3.connect(path)
        self.reads = 0

    def get(self, uid: int):
        self.reads += 1
        row = self.db.execute("SELECT id, name, email FROM users WHERE id=?", (uid,)).fetchone()
        return {"id": row[0], "name": row[1], "email": row[2]} if row else None

    def get_many(self, ids: np.ndarray):
        self.reads += len(ids)
        marks = ",".join("?" * len(ids))
        rows = self.db.execute(
            f"SELECT id, email FROM users WHERE id IN ({marks})", [int(i) for i in ids]
        ).fetchall()
        by_id = {r[0]: r for r in rows}
        # numeric projection for the device table: (id, len(email)) per row
        return np.array([[i, len(by_id[int(i)][1])] for i in ids], dtype=np.float32)

    def truth(self) -> np.ndarray:
        """Every user's projected row, read without counting."""
        rows = self.db.execute("SELECT id, email FROM users ORDER BY id").fetchall()
        return np.array([[r[0], len(r[1])] for r in rows], dtype=np.float32)

    def update_email(self, uid: int, email: str) -> None:
        self.db.execute("UPDATE users SET email=? WHERE id=?", (email, uid))
        self.db.commit()


def user_service_class(api: ReadApi):
    """The memoized user service of ``api``'s package: scalar gets keep
    per-key nodes, bulk reads ride ``memo_table_of(svc.get).read_batch``
    refreshed through ``get_rows``."""
    core = api.core

    class FusionUserService(core.ComputeService):
        def __init__(self, dal: UserDal, hub=None):
            super().__init__(hub)
            self.dal = dal

        def get_rows(self, ids: np.ndarray) -> np.ndarray:
            return self.dal.get_many(ids)

        @core.compute_method(table=core.TableBacking(rows=USER_COUNT, batch="get_rows",
                                                     row_shape=(2,), **api.table_kwargs))
        async def get(self, uid: int):
            return self.dal.get(uid)

        async def update_email(self, uid: int, email: str) -> None:
            self.dal.update_email(uid, email)
            with core.invalidating():
                await self.get(uid)

    return FusionUserService


class PlainUserService:
    """No memoization: every read is a DB hit."""

    def __init__(self, dal: UserDal):
        self.dal = dal

    async def get(self, uid: int):
        return self.dal.get(uid)

    async def update_email(self, uid: int, email: str) -> None:
        self.dal.update_email(uid, email)


# ---------------------------------------------------------------- the modes
def make_mutator(service, stop: asyncio.Event, read_first: bool = False):
    """The 10 ms read-modify-write mutator every mode churns with."""

    async def mutator():
        rnd = random.Random(1)
        count = 0
        while not stop.is_set():
            uid = rnd.randrange(USER_COUNT)
            if read_first:
                user = await service.get(uid)
                assert user is not None
            count += 1
            await service.update_email(uid, f"{count}@counter.org")
            try:
                await asyncio.wait_for(stop.wait(), MUTATOR_PERIOD_S)
            except asyncio.TimeoutError:
                pass

    return mutator


async def run_scalar(service, iterations: int, mutate: bool, mutator_service=None):
    """The reference's ``Test()`` body: the readers and one mutator."""
    stop = asyncio.Event()
    mutator = make_mutator(mutator_service or service, stop, read_first=True)

    async def reader(n: int, count: int) -> int:
        rnd = random.Random(n)
        ok = 0
        for _ in range(count):
            uid = rnd.randrange(USER_COUNT)
            user = await service.get(uid)
            if user is not None and user["id"] == uid:
                ok += 1
        return ok

    warm = max(iterations // 4, 1)  # the reference runs iterations/4 first
    await asyncio.gather(*(reader(100 + i, warm) for i in range(READERS)))
    mut = asyncio.ensure_future(mutator()) if mutate else None
    t0 = time.perf_counter()
    results = await asyncio.gather(*(reader(i, iterations) for i in range(READERS)))
    elapsed = time.perf_counter() - t0
    stop.set()
    if mut:
        await mut
    _require(all(r == iterations for r in results), f"scalar readers got {results}, "
             f"not {iterations} each")
    return READERS * iterations, elapsed


async def run_scalar_hot(service, iterations: int):
    """The scalar loop over a precomputed id sequence, the mutator churning."""
    stop = asyncio.Event()
    ids = [(i * 7919) % USER_COUNT for i in range(min(iterations, 100_000))]
    mutator = make_mutator(service, stop)

    async def reader(count: int) -> int:
        ok = 0
        for _ in range(max(count // len(ids), 1)):
            for uid in ids:
                if await service.get(uid) is not None:
                    ok += 1
        return ok

    for i in range(USER_COUNT):  # warm every key
        await service.get(i)
    m = asyncio.ensure_future(mutator())
    t0 = time.perf_counter()
    counts = await asyncio.gather(*[reader(iterations) for _ in range(READERS)])
    dt = time.perf_counter() - t0
    stop.set()
    await m
    want = max(iterations // len(ids), 1) * len(ids)
    _require(all(c == want for c in counts), f"hot readers got {counts}, not {want} each")
    return sum(counts), dt


async def run_vectorized(api: ReadApi, service, iterations: int, batch: int, mutate: bool,
                         device_ids: bool = False):
    """The same workload, columnar: bulk reads through the table behind
    ``@compute_method(table=...)``, the mutator the scalar write path."""
    table = api.core.memo_table_of(service.get)
    table.read_batch(np.arange(USER_COUNT))  # warm
    stop = asyncio.Event()
    mutator = make_mutator(service, stop)

    async def reader_host(n: int) -> int:
        rng = np.random.default_rng(n)
        ok = 0
        for i in range(iterations):
            ids = rng.integers(0, USER_COUNT, size=batch).astype(np.int32)
            ok += table.read_batch(ids).shape[0]
            if i % 8 == 0:
                await asyncio.sleep(0)  # yield so the mutator runs
        return ok

    async def reader_device(n: int) -> int:
        ok = 0
        for i, ids in enumerate(api.device_ids(n, iterations, batch)):
            ok += table.read_batch(ids).shape[0]
            if i % 8 == 0:
                await asyncio.sleep(0)
        return ok

    reader = reader_device if device_ids else reader_host
    await reader(100)  # warm
    mut = asyncio.ensure_future(mutator()) if mutate else None
    t0 = time.perf_counter()
    results = await asyncio.gather(*(reader(i) for i in range(READERS)))
    api.sync()  # the queued gathers are done
    elapsed = time.perf_counter() - t0
    stop.set()
    if mut:
        await mut
    _require(all(r == iterations * batch for r in results),
             f"vectorized readers got {results}, not {iterations * batch} each")
    return READERS * iterations * batch, elapsed


async def run_rpc_client(api: ReadApi, path: str, iterations: int, mutate: bool):
    """A compute client reads ``users.get`` over the in-memory RPC transport
    while the mutator writes on the server's service. Returns ``(ops,
    seconds)`` after the client's reads equal the DAL."""
    rpc, client = api.rpc, api.client
    dal = UserDal(path)
    service = user_service_class(api)(dal, api.core.FusionHub())
    server_rpc = rpc.RpcHub("perf-server")
    client.install_compute_call_type(server_rpc)
    server_rpc.add_service("users", service)
    client_rpc = rpc.RpcHub("perf-client")
    client.install_compute_call_type(client_rpc)
    rpc.RpcTestTransport(client_rpc, server_rpc)
    users = client.compute_client("users", client_rpc, api.core.FusionHub())
    try:
        ops, dt = await run_scalar(users, iterations, mutate, mutator_service=service)

        async def mismatches():
            truth = dal.truth()
            out = 0
            for uid in range(USER_COUNT):
                user = await users.get(uid)
                out += user["id"] != uid or len(user["email"]) != int(truth[uid, 1])
            return out

        await _converge(mismatches, "the RPC client's reads")
        return ops, dt
    finally:
        await client_rpc.stop()
        await server_rpc.stop()


async def run_rpc_vectorized(api: ReadApi, path: str, iterations: int, batch: int,
                             mutate: bool):
    """A ``RemoteTable`` client reads id batches from the served memo table
    (one RPC a stale batch, local gathers after that) while the mutator
    invalidates rows server-side. Returns ``(ops, seconds, rpc round
    trips)`` after the remote reads of every id equal the DAL."""
    core, client, rpc = api.core, api.client, api.rpc
    dal = UserDal(path)
    service = user_service_class(api)(dal, core.FusionHub())
    table = core.memo_table_of(service.get)
    server_rpc = rpc.RpcHub("perf-table-server")
    client.RemoteTableHost(server_rpc).expose("users", table)
    client_rpc = rpc.RpcHub("perf-table-client")
    rpc.RpcTestTransport(client_rpc, server_rpc)
    remote = client.RemoteTable(client_rpc, "default", "users")
    stop = asyncio.Event()

    async def mutator():
        uid = 0
        while not stop.is_set():
            await service.update_email(uid % USER_COUNT, f"m{uid}@x.com")
            uid += 1
            await asyncio.sleep(MUTATOR_PERIOD_S)

    async def reader(n: int) -> int:
        rng = np.random.default_rng(n)
        ops = 0
        for _ in range(iterations):
            ids = rng.integers(0, USER_COUNT, size=batch)
            ops += len(await remote.read_batch(ids))
        return ops

    try:
        mut = asyncio.ensure_future(mutator()) if mutate else None
        t0 = time.perf_counter()
        counts = await asyncio.gather(*(reader(n) for n in range(READERS)))
        dt = time.perf_counter() - t0
        if mut is not None:
            stop.set()
            await mut
        _require(all(c == iterations * batch for c in counts),
                 f"remote readers got {counts}, not {iterations * batch} each")
        rpc_reads = remote.remote_reads

        async def mismatches():
            got = np.asarray(await remote.read_batch(np.arange(USER_COUNT)))
            return int((got != dal.truth()).any(axis=1).sum())

        await _converge(mismatches, "the RemoteTable's rows")
        return sum(counts), dt, rpc_reads
    finally:
        remote.dispose()
        await client_rpc.stop()
        await server_rpc.stop()


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ReadCheckFailed(what)


async def _converge(mismatches, what: str) -> None:
    """Wait (up to :data:`CONVERGE_S`) for the pushed invalidations: 0 rows
    may differ from the DAL."""
    deadline = time.perf_counter() + CONVERGE_S
    while True:
        bad = await mismatches()
        if not bad:
            return
        _require(time.perf_counter() < deadline,
                 f"{what}: {bad} users differ from the DAL {CONVERGE_S} s after the mutator stopped")
        await asyncio.sleep(0.02)


def _table_equals_dal(api: ReadApi, service, dal: UserDal, what: str) -> np.ndarray:
    """``read_batch`` of every id (host ids) equals the DAL; returns it."""
    table = api.core.memo_table_of(service.get)
    got = api.to_host(table.read_batch(np.arange(USER_COUNT)))
    bad = int((got != dal.truth()).any(axis=1).sum())
    _require(bad == 0, f"{what}: read_batch of every id differs from the DAL in {bad} rows")
    return got


async def _scalar_equals_dal(service, dal: UserDal, what: str) -> None:
    truth = dal.truth()
    reads = dal.reads
    bad = 0
    for uid in range(USER_COUNT):
        user = await service.get(uid)
        bad += user["id"] != uid or len(user["email"]) != int(truth[uid, 1])
    dal.reads = reads  # the check's own recomputes are not the mode's
    _require(bad == 0, f"{what}: {bad} users differ from the DAL")


# ---------------------------------------------------------------- the run
def run_read(modes: Sequence[str] = MODES, sizes: Optional[dict] = None, device=None,
             api: Optional[ReadApi] = None, mutate: bool = True) -> dict:
    """Run ``modes`` (the script's, in its order) at ``sizes`` (default the
    script's full :data:`SIZES`); ``mutate=False`` runs every mode without
    its mutator. Returns ``{mode: ops/s}`` under the script's keys, the
    speedups where their modes ran, and ``modes``: each mode's ``ops``,
    ``seconds``, ``db_reads`` (the DAL's reads during the mode, where it
    has one), ``rpc_reads`` (the remote table's round trips), and for the
    local vectorized modes ``final_rows`` (``read_batch`` of every id after
    the mutator stopped) and for the chain its ``readback``. Prints
    nothing."""
    api = api if api is not None else port_api(device)
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"unknown read mode {mode!r}; modes are {MODES}")
    full = dict(SIZES, **(sizes or {}))
    work = tempfile.mkdtemp(prefix="fusion-read-")
    path = os.path.join(work, "perf-users.sqlite")
    make_db(path)
    try:
        return asyncio.run(_run(api, path, [m for m in MODES if m in modes], full, mutate))
    finally:
        for name in os.listdir(work):
            os.remove(os.path.join(work, name))
        os.rmdir(work)


async def _run(api: ReadApi, path: str, modes: list, sizes: dict, mutate: bool) -> dict:
    core = api.core
    old = core.set_default_hub(core.FusionHub())
    out: dict = {"modes": {}}

    def note(mode, ops, dt, dal=None, reads0=0, rpc_reads=None):
        out[mode] = ops / dt
        out["modes"][mode] = {"ops": ops, "seconds": dt,
                              "db_reads": None if dal is None else dal.reads - reads0,
                              "rpc_reads": rpc_reads}

    service_cls = user_service_class(api)
    try:
        dal = UserDal(path)
        users = service_cls(dal, core.FusionHub())
        if "fusion_scalar" in modes:
            ops, dt = await run_scalar(users, sizes["fusion_scalar"], mutate)
            await _scalar_equals_dal(users, dal, "fusion_scalar")
            note("fusion_scalar", ops, dt, dal)
        if "fusion_scalar_hot" in modes:
            reads0 = dal.reads
            ops, dt = await run_scalar_hot(users, sizes["fusion_scalar_hot"])
            await _scalar_equals_dal(users, dal, "fusion_scalar_hot")
            note("fusion_scalar_hot", ops, dt, dal, reads0)
        if "fusion_rpc_client" in modes:
            ops, dt = await run_rpc_client(api, path, sizes["fusion_rpc_client"], mutate)
            note("fusion_rpc_client", ops, dt)
        for mode, mut in (("fusion_rpc_vectorized", mutate), ("fusion_rpc_vectorized_hits", False)):
            if mode in modes:
                iters, batch = sizes[mode]
                ops, dt, rpc_reads = await run_rpc_vectorized(api, path, iters, batch, mut)
                note(mode, ops, dt, rpc_reads=rpc_reads)
        if "no_fusion" in modes:
            dal2 = UserDal(path)
            plain = PlainUserService(dal2)
            ops, dt = await run_scalar(plain, sizes["no_fusion"], mutate)
            note("no_fusion", ops, dt, dal2)
            await _scalar_equals_dal(plain, dal2, "no_fusion")
        vec_users = None
        for mode, on_device in (("fusion_vectorized", False),
                                ("fusion_vectorized_device_ids", True)):
            if mode in modes:
                dal3 = UserDal(path)
                svc = service_cls(dal3, core.FusionHub())
                iters, batch = sizes[mode]
                ops, dt = await run_vectorized(api, svc, iters, batch, mutate, on_device)
                note(mode, ops, dt, dal3)
                out["modes"][mode]["final_rows"] = _table_equals_dal(api, svc, dal3, mode)
                if vec_users is None:
                    vec_users = svc
        if "fusion_device_chained" in modes:
            if vec_users is None:
                vec_users = service_cls(UserDal(path), core.FusionHub())
            table = core.memo_table_of(vec_users.get)
            table.read_batch(np.arange(USER_COUNT))
            n_chained, batch = sizes["fusion_device_chained"]
            ops, dt, got, plain = api.chain(table, n_chained, batch)
            _require(got == plain, f"fusion_device_chained: the readback {got!r} differs from "
                                   f"the plain gathers' {plain!r}")
            note("fusion_device_chained", ops, dt)
            out["modes"]["fusion_device_chained"]["readback"] = got
        if "fusion_scalar" in out and "no_fusion" in out:
            out["speedup_scalar_vs_none"] = out["fusion_scalar"] / out["no_fusion"]
        if "fusion_vectorized" in out and "no_fusion" in out:
            out["speedup_vectorized_vs_none"] = out["fusion_vectorized"] / out["no_fusion"]
        return out
    finally:
        core.set_default_hub(old)
