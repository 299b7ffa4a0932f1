"""Twin of ``perf/fanout_path.py``: the 10M live burst meeting the RPC layer.

    from stl_fusion_tpu_torch.fanout_path import run_fanout
    record = run_fanout()               # 10M rows on the CUDA device
    record = run_fanout(n_nodes=20_000, device="cpu")

The server is the live twin's stack (``live_path.py``'s ``DagTable`` bound as
one row block over ``power_law_dag(n, 3, seed=7)``, warmed on the device,
the topo mirror built) behind an ``RpcHub`` that serves the service as
``"dag"`` with the ``$sys-c`` compute call type and a
:class:`~.rpc.fanout.ComputeFanoutIndex` on the backend's newly hooks.
``clients`` fusion clients, each on its own ``FusionHub`` and ``RpcHub``
over ``RpcTestTransport(wire_codec=True)`` (the first ``tcp_clients`` of
them over ``rpc/tcp.py`` on 127.0.0.1 instead), hold ``keys_per_client``
``$sys-c`` subscriptions each on tail rows (``n - 1 - choice(n // 4)`` from
``default_rng(97)``). A lane burst (``cascade_rows_lanes``) of ``groups``
groups (the keys round-robin plus ``seeds_per_group`` deep seeds from
``n // 10`` each) fences them; the record holds when each client observed
its fence. Modes, the A/B the script runs: ``perkey`` (one awaited
``$sys-c.invalidate`` frame a subscription, ``coalesce_invalidations``
off, no index) and ``coalesced`` (the newly mask drains through the index
into per-peer outboxes, one ``$sys-c.invalidate_batch`` frame a drain).

Defaults are the script's (``FANOUT_CLIENTS=100``, ``FANOUT_KEYS=16``,
``FANOUT_ROUNDS=2``, ``FANOUT_GROUPS=32``, ``FANOUT_SEEDS_PER_GROUP=4``,
``FANOUT_DEG=3``, both modes, ``FANOUT_LONE_SAMPLES=24``, the wire codec
on) at ``FANOUT_NODES=10_000_000``. The port's own additions, each checked
where it runs: ``outside_keys`` more keys a client drawn outside the
bursts' union (the dense wave of every group's seeds from a settled
state), which no burst may fence (0 by default); ``tcp_clients`` (0); the
host-led leg (:meth:`FanoutRun.host_led`). Every round holds its fenced
(client, key) set equal to the subscribed keys inside the union, every
subscription fenced by one entry (the mask drain and the watch backstop
never both ship it), every fenced key's re-read equal to the server's
value, and the mode's frames (no batch frame in ``perkey``; fewer batch
frames than subscriptions in ``coalesced``).

:class:`FanoutRun` runs on a stack that is already built (``ctx``, the
live twin's observer context: ``backend``, ``block``, ``table``, ``svc``,
``n``), so a caller with the live stack builds no second graph.
``api`` runs the scenario through another package with this one's API (the
parity tests pass the JAX package's modules). ``checked(fn)`` runs each
check wave (``fn`` leaves the graph's invalid state as it found it);
``around_burst(mode, round, fn)`` runs each timed burst.
"""
from __future__ import annotations

import asyncio
import importlib
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .graph.synthetic import power_law_dag
from .live_path import make_dag_service

__all__ = ["FanoutApi", "FanoutRun", "port_api", "run_fanout"]

N_NODES = 10_000_000
GRAPH_SEED = 7
KEY_SEED = 97
#: the script's ``FANOUT_TIMEOUT_S``: the longest wait for a round's fences
TIMEOUT_S = 600.0
#: the script's modes, in its order
MODES = ("perkey", "coalesced")


class FanoutApi(NamedTuple):
    """What the scenario needs of a package: its ``core``, ``graph``,
    ``rpc`` and ``client`` modules, the backend's extra arguments, a numpy
    → device-array conversion for the loader's base table, and a device
    sync."""

    core: Any
    graph: Any
    rpc: Any
    client: Any
    backend_kwargs: dict
    to_device: Callable[[np.ndarray], Any]
    sync: Callable[[], None]
    name: str


def port_api(device=None) -> FanoutApi:
    """This package on ``device`` (``cuda`` unless given)."""
    from . import client, core, graph, rpc

    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return FanoutApi(core, graph, rpc, client, {"device": dev},
                     lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), sync,
                     f"stl_fusion_tpu_torch on {dev}")


def build_stack(api: FanoutApi, n: int, edges=None, deg: float = 3,
                edge_headroom: int = 65536) -> dict:
    """The script's server stack on a fresh hub (made the default hub):
    the ``DagTable`` block warmed on the device and the topo mirror."""
    core = api.core
    src, dst = edges if edges is not None else power_law_dag(n, avg_degree=deg, seed=GRAPH_SEED)
    hub = core.FusionHub()
    core.set_default_hub(hub)
    backend = api.graph.TpuGraphBackend(hub, node_capacity=n + 64,
                                        edge_capacity=len(src) + edge_headroom,
                                        **api.backend_kwargs)
    svc = make_dag_service(core, n, api.to_device)(hub)
    hub.add_service(svc, "dag")
    table = core.memo_table_of(svc.node)
    api.sync()
    t0 = time.perf_counter()
    block = backend.bind_table_rows(table)
    backend.declare_row_edges(block, src, block, dst)
    backend.warm_block_on_device(block)
    backend.flush()
    api.sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    backend.graph.build_topo_mirror()
    api.sync()
    return {"backend": backend, "block": block, "table": table, "svc": svc, "n": n,
            "build_s": build_s, "mirror_build_s": time.perf_counter() - t0}


def percentiles(samples_ms):
    arr = np.asarray(samples_ms, dtype=np.float64)
    if arr.size == 0:
        return None, None
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))


async def settle(seconds: float = 0.05) -> None:
    """Let queued tasks (outbox drains, fence deliveries) run."""
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        await asyncio.sleep(0.005)


def dispatch_mark(backend) -> tuple:
    """Where the backend's wave profiler stands, for :func:`dispatches_since`."""
    prof = backend.profiler
    return prof.waves_recorded, prof.flushes_recorded, backend.waves_run


def dispatches_since(backend, mark: tuple, into: Optional[dict] = None) -> dict:
    """The backend's device waves since ``mark`` (added to ``into``), from
    its wave profiler: the journal flushes replayed, the waves recorded, the
    logical waves run, and for each wave kind (``lanes``, ``union``,
    ``icasc`` — a flush's expansion of host-led marks —, ...) its
    dispatches, seeds and newly invalid rows. ``kinds`` is None when the
    profiler's ring no longer holds every wave since ``mark``."""
    prof = backend.profiler
    waves, flushes, run = mark
    new = prof.waves_recorded - waves
    out = into if into is not None else {"flushes": 0, "waves": 0, "waves_run": 0, "kinds": {}}
    out["flushes"] += prof.flushes_recorded - flushes
    out["waves"] += new
    out["waves_run"] += backend.waves_run - run
    if new > len(prof.recent()):
        out["kinds"] = None
    elif out["kinds"] is not None:
        for rec in prof.recent(new) if new else []:
            k = out["kinds"].setdefault(rec["kind"], {"dispatches": 0, "seeds": 0, "newly": 0})
            k["dispatches"] += 1
            k["seeds"] += rec["seeds"]
            k["newly"] += rec["newly"]
    return out


class Observer:
    """Counts client-observed fences with SYNC callbacks (the callback runs
    inside the client node's invalidation, the moment a reader would see
    staleness), keyed by (client, key)."""

    def __init__(self):
        self.hits: list = []
        self.remaining = 0
        self.event = asyncio.Event()

    def arm(self, count: int) -> None:
        self.hits = []
        self.remaining = count
        self.event.clear()

    def hit(self, client: int, key: int) -> None:
        self.hits.append((client, key, time.perf_counter()))
        self.remaining -= 1
        if self.remaining <= 0:
            self.event.set()


class Client:
    """One fusion client: its own FusionHub, RpcHub and transport. Every
    ``$sys-c`` invalidation entry it receives is counted by call id."""

    def __init__(self, api: FanoutApi, i: int, server_rpc, tcp_port=None):
        self.i = i
        self.fusion = api.core.FusionHub()
        self.rpc = api.rpc.RpcHub(f"client-{i}")
        api.client.install_compute_call_type(self.rpc)
        if tcp_port is None:
            self.transport = "memory"
            api.rpc.RpcTestTransport(self.rpc, server_rpc, wire_codec=True)
        else:
            self.transport = "tcp"
            tcp = importlib.import_module(api.rpc.__name__ + ".tcp")
            self.rpc.client_connector = tcp.tcp_client_connector("127.0.0.1", tcp_port,
                                                                 client_id=f"c{i}")
        self.proxy = api.client.compute_client("dag", self.rpc, self.fusion, peer_ref=f"c{i}")
        self.capture = api.core.capture
        self.keys = np.empty(0, dtype=np.int64)  # subscribed keys inside the union
        self.outside = np.empty(0, dtype=np.int64)  # keys outside every burst's union
        self.nodes: dict = {}
        self.entries: dict = {}  # call id -> invalidation entries received
        loads = importlib.import_module(api.rpc.__name__.rsplit(".", 1)[0]
                                        + ".utils.serialization").loads
        inner = self.rpc.compute_system_handler

        def counting(peer, message):
            if message.method == "invalidate":
                ids = [loads(message.argument_data)[0]]
            elif message.method == "invalidate_batch":
                ids = [e[0] for e in loads(message.argument_data)[0]]
            else:
                ids = []
            for cid in ids:
                self.entries[cid] = self.entries.get(cid, 0) + 1
            inner(peer, message)

        self.rpc.compute_system_handler = counting

    async def subscribe(self, observer: Observer, base: np.ndarray, keys=None) -> None:
        """(Re-)read each key; a new node reports its fence to ``observer``.
        A key whose node is still consistent keeps it (no second handler).
        Every value read must be the server's."""
        for k in (np.concatenate([self.keys, self.outside]) if keys is None else keys).tolist():
            node = await self.capture(lambda k=k: self.proxy.node(int(k)))
            if node.value != float(base[k]):
                raise AssertionError(f"fanout: client {self.i} read {node.value} for key {k}, "
                                     f"the server holds {float(base[k])}")
            if self.nodes.get(k) is not node:
                self.nodes[k] = node
                node.on_invalidated(lambda _c, k=k: observer.hit(self.i, k))


class FanoutRun:
    """The scenario on a built stack ``ctx``: :meth:`start`, then
    :meth:`run_mode` per mode, :meth:`host_led`, :meth:`lone_ab`, and
    :meth:`close`."""

    def __init__(self, api: FanoutApi, ctx: dict, clients: int = 100,
                 keys_per_client: int = 16, groups: int = 32, seeds_per_group: int = 4,
                 outside_keys: int = 0, tcp_clients: int = 0,
                 checked: Optional[Callable] = None, around_burst: Optional[Callable] = None):
        self.api = api
        self.backend, self.block, self.table, self.svc = (ctx["backend"], ctx["block"],
                                                          ctx["table"], ctx["svc"])
        self.n = int(ctx["n"])
        self.n_clients, self.keys_per_client = clients, keys_per_client
        self.n_groups, self.seeds_per_group = groups, seeds_per_group
        self.outside_keys, self.tcp_clients = outside_keys, tcp_clients
        self.checked = checked or (lambda fn: fn())
        self.around_burst = around_burst or (lambda mode, rnd, fn: fn())
        self.rng = np.random.default_rng(KEY_SEED)
        self.metrics = importlib.import_module(api.rpc.__name__.rsplit(".", 1)[0]
                                               + ".diagnostics").global_metrics
        self.observer = Observer()
        self.clients: list = []
        self.server_rpc = self.fanout_index = self.tcp_server = None

    # ------------------------------------------------------------------ set-up
    async def start(self) -> dict:
        api, backend, block, n = self.api, self.backend, self.block, self.n
        t0 = time.perf_counter()
        self.server_rpc = api.rpc.RpcHub("server")
        api.client.install_compute_call_type(self.server_rpc)
        self.server_rpc.add_service("dag", self.svc)
        self.fanout_index = api.rpc.install_compute_fanout(self.server_rpc, backend)
        port = None
        if self.tcp_clients:
            tcp = importlib.import_module(api.rpc.__name__ + ".tcp")
            self.tcp_server = await tcp.RpcTcpServer(self.server_rpc, "127.0.0.1", 0).start()
            port = self.tcp_server.port
        # the script's draws, in its order: the keys, then the deep seeds
        all_keys = n - 1 - self.rng.choice(n // 4, size=self.n_clients * self.keys_per_client,
                                           replace=False)
        self.clients = []
        for i in range(self.n_clients):
            c = Client(api, i, self.server_rpc, port if i < self.tcp_clients else None)
            c.keys = np.sort(all_keys[i * self.keys_per_client:(i + 1) * self.keys_per_client])
            self.clients.append(c)
        self.groups = [list() for _ in range(self.n_groups)]
        for j, k in enumerate(all_keys.tolist()):
            self.groups[j % self.n_groups].append(int(k))
        self.deep = self.rng.choice(n // 10, size=(self.n_groups, self.seeds_per_group),
                                    replace=False)
        for gi in range(self.n_groups):
            self.groups[gi].extend(int(s) for s in self.deep[gi])
        # the script's untimed warm of the lane, lone and refresh programs
        backend.cascade_rows_lanes(block, self.groups)
        backend.refresh_block_on_device(block)
        backend.cascade_rows_batch(block, [n - 1])
        backend.refresh_block_on_device(block)
        backend.flush()
        self.settle_block()
        # the bursts' union: the dense wave of every group's seeds
        self.union = self.closure(np.concatenate([np.asarray(g) for g in self.groups]))
        outside = np.nonzero(~self.union)[0]
        if self.outside_keys:
            if outside.size < self.n_clients * self.outside_keys:
                raise AssertionError(f"fanout: only {outside.size} rows lie outside the union")
            drawn = self.rng.choice(outside, size=self.n_clients * self.outside_keys,
                                    replace=False)
            for i, c in enumerate(self.clients):
                c.outside = np.sort(drawn[i * self.outside_keys:(i + 1) * self.outside_keys])
        if not self.union[all_keys].all():
            raise AssertionError("fanout: a subscribed key is outside its own burst's union")
        return {"start_s": time.perf_counter() - t0, "union": int(self.union.sum()),
                "outside_union": int(outside.size)}

    def closure(self, rows) -> np.ndarray:
        """The dense wave's newly set from ``rows`` (block rows) on the
        settled graph, as a bool mask over rows; the wave's invalid state
        is cleared after it."""
        dg, base, n = self.backend.graph, self.block.base, self.n

        def wave():
            if dg._h_invalid[base:base + n].any():
                raise AssertionError("fanout: the check wave needs a settled graph")
            _, ids = dg.run_waves_union([(base + np.asarray(rows, np.int64)).tolist()],
                                        mirror="off")
            dg.clear_invalid()
            return ids

        ids = np.asarray(self.checked(wave), dtype=np.int64) - base
        mask = np.zeros(n, dtype=bool)
        mask[ids[(ids >= 0) & (ids < n)]] = True
        return mask

    def settle_block(self) -> None:
        """Every row valid and every invalid bit clear (the block refresh,
        then ``read_batch`` of what a scalar recompute left stale)."""
        backend, table, dg, base, n = (self.backend, self.table, self.backend.graph,
                                       self.block.base, self.n)
        for _ in range(3):
            backend.flush()
            backend.refresh_block_on_device(self.block)
            backend.flush()
            stale = np.nonzero(table._stale_host)[0]
            if stale.size:
                table.read_batch(stale)
                backend.flush()
            if not table.stale_count() and not dg._h_invalid[base:base + n].any():
                return
        raise AssertionError(f"fanout: {table.stale_count()} rows stale after settling")

    def dispatch_mark(self) -> tuple:
        return dispatch_mark(self.backend)

    def dispatches_since(self, mark: tuple, into: Optional[dict] = None) -> dict:
        return dispatches_since(self.backend, mark, into)

    def delivery_hist(self):
        """The system's own ``fusion_e2e_delivery_ms`` histogram (server
        wave apply → client invalidation apply), which the clients record."""
        return self.metrics().histogram("fusion_e2e_delivery_ms",
                                        help="server wave apply -> client invalidation apply")

    def set_mode(self, mode: str) -> None:
        coalesced = mode == "coalesced"
        self.server_rpc.coalesce_invalidations = coalesced
        self.server_rpc.compute_fanout = self.fanout_index if coalesced else None

    async def subscribe_all(self, keys_of=None) -> float:
        t0 = time.perf_counter()
        await asyncio.gather(*(c.subscribe(self.observer, self.svc.base,
                                           None if keys_of is None else keys_of(c))
                               for c in self.clients))
        return time.perf_counter() - t0

    def take_fences(self, want: set, what: str) -> list:
        """The fences observed since the last arm must be exactly ``want``
        (client, key) pairs, each by one invalidation entry."""
        got = [(c, k) for c, k, _ in self.observer.hits]
        if len(got) != len(set(got)) or set(got) != want:
            extra, missing = set(got) - want, want - set(got)
            raise AssertionError(f"fanout: {what} fenced {len(got)} of {len(want)} "
                                 f"(extra {sorted(extra)[:5]}, missing {sorted(missing)[:5]})")
        entries = [v for c in self.clients for v in c.entries.values()]
        if len(entries) != len(want) or any(v != 1 for v in entries):
            raise AssertionError(f"fanout: {what} shipped {sum(entries)} invalidation entries "
                                 f"on {len(entries)} calls for {len(want)} fences")
        for c in self.clients:
            c.entries.clear()
        return [t for _, _, t in self.observer.hits]

    # ------------------------------------------------------------------ modes
    async def run_mode(self, mode: str, rounds: int) -> dict:
        """``rounds`` subscribe → burst → observe cycles in ``mode``."""
        backend, block, server_rpc = self.backend, self.block, self.server_rpc
        self.set_mode(mode)
        snap = server_rpc.fanout_stats()
        # this mode's slice of the system's delivery histogram, which also
        # holds the other mode's and the lone probes' samples
        delivery_hist = self.delivery_hist()
        delivery_cp = delivery_hist.checkpoint()
        dispatches = None
        want = {(c.i, int(k)) for c in self.clients for k in c.keys.tolist()}
        is_tcp = {c.i for c in self.clients if c.transport == "tcp"}
        rec_rounds = []
        totals = {"fanout_s": 0.0, "burst_s": 0.0, "churn_flush_s": 0.0, "inv": 0}
        staleness, delivery, tcp_delivery = [], [], []
        for rnd in range(rounds):
            mark = self.dispatch_mark()
            before = server_rpc.fanout_stats()
            self.observer.arm(len(want))
            sub_s = await self.subscribe_all()
            await settle()
            t0 = time.perf_counter()
            backend.flush()  # the re-subscriptions' recompute journal, untimed
            flush_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            counts = self.around_burst(mode, rnd,
                                       lambda: backend.cascade_rows_lanes(block, self.groups))
            t_burst = time.perf_counter()
            await asyncio.wait_for(self.observer.event.wait(), TIMEOUT_S)
            t_all = time.perf_counter()
            await settle()  # a fence shipped twice, or outside the union, lands here
            times = self.take_fences(want, f"{mode} round {rnd}")
            after = server_rpc.fanout_stats()
            frames = after["batch_frames_sent"] - before["batch_frames_sent"]
            keys_sent = after["batch_keys_sent"] - before["batch_keys_sent"]
            if mode == "perkey" and frames:
                raise AssertionError(f"fanout: perkey round {rnd} sent {frames} batch frames")
            if mode == "coalesced" and not 0 < frames < len(want):
                raise AssertionError(f"fanout: coalesced round {rnd} sent {frames} batch "
                                     f"frames for {len(want)} subscriptions")
            st = [(t - t0) * 1e3 for t in times]
            dv = [(t - t_burst) * 1e3 for t in times]
            staleness += st
            delivery += dv
            tcp_delivery += [(t - t_burst) * 1e3 for c, _, t in self.observer.hits if c in is_tcp]
            inv = int(np.asarray(counts).sum())
            totals["fanout_s"] += t_all - t_burst
            totals["burst_s"] += t_burst - t0
            totals["churn_flush_s"] += flush_s
            totals["inv"] += inv
            rec_rounds.append({
                "mode": mode, "round": rnd, "burst_ms": (t_burst - t0) * 1e3,
                "fanout_ms": (t_all - t_burst) * 1e3, "subscribe_ms": sub_s * 1e3,
                "churn_flush_ms": flush_s * 1e3, "inv": inv, "subscriptions": len(want),
                "frames": frames, "keys_per_frame": keys_sent / frames if frames else None,
                "staleness_ms_p50_p99": percentiles(st),
                "delivery_ms_p50_p99": percentiles(dv),
                "messages_sent": after["messages_sent"] - before["messages_sent"]})
            # consistency for the next round: the device refresh
            backend.refresh_block_on_device(block)
            backend.flush()
            await settle()
            dispatches = self.dispatches_since(mark, dispatches)
        stats = server_rpc.fanout_stats()
        delta = {k: stats[k] - snap.get(k, 0) for k in (
            "invalidations_posted", "invalidations_coalesced", "batch_frames_sent",
            "batch_keys_sent", "messages_sent")}
        fenced = len(want) * rounds
        frames = delta["batch_frames_sent"]
        st50, st99 = percentiles(staleness)
        dv50, dv99 = percentiles(delivery)
        tcp50, tcp99 = percentiles(tcp_delivery)
        return {
            "rounds": rec_rounds,
            # the system's own delivery numbers for this mode: they agree
            # with the harness's delivery_ms_p50/p99 to bucket resolution
            "system_delivery_ms": delivery_hist.since(delivery_cp),
            "dispatches": dispatches,
            "clients_fenced_total": fenced,
            "clients_fenced_per_s": fenced / totals["fanout_s"] if totals["fanout_s"] else None,
            "fanout_s": totals["fanout_s"], "burst_s": totals["burst_s"],
            "churn_flush_s": totals["churn_flush_s"], "burst_inv_total": totals["inv"],
            "staleness_ms_p50": st50, "staleness_ms_p99": st99,
            "delivery_ms_p50": dv50, "delivery_ms_p99": dv99,
            "tcp_delivery_ms_p50": tcp50, "tcp_delivery_ms_p99": tcp99,
            "batch_frames": frames,
            "keys_per_frame": delta["batch_keys_sent"] / frames if frames else None,
            "coalesce_ratio": delta["invalidations_posted"] / frames if frames else None,
            "invalidations_posted": delta["invalidations_posted"],
            "messages_sent": delta["messages_sent"],
        }

    # ------------------------------------------------------------------ host-led
    async def host_led(self, row: Optional[int] = None) -> dict:
        """One deep seed row invalidated host-side (``invalidating()`` on
        ``svc.node``), coalesced: its table row expands at the next flush
        (one seed: the lat mirror when one is built and the closure fits
        its caps, which ``lat_waves`` counts; else the topo sweep).
        The fenced subscriptions must equal the dense wave's closure of the
        row intersected with the subscribed keys."""
        core, backend = self.api.core, self.backend
        self.set_mode("coalesced")
        row = int(self.deep[0][0]) if row is None else int(row)
        self.observer.arm(1 << 60)
        await self.subscribe_all()
        await settle()
        self.settle_block()
        closure = self.closure([row])
        want = {(c.i, int(k)) for c in self.clients
                for k in np.concatenate([c.keys, c.outside]).tolist() if closure[k]}
        node = await core.capture(lambda: self.svc.node(row))
        self.settle_block()
        self.observer.arm(len(want))
        before = self.server_rpc.fanout_stats()
        lat0 = backend.graph.lat_waves
        mark = self.dispatch_mark()
        t0 = time.perf_counter()
        with core.invalidating():
            await self.svc.node(row)
        backend.flush()
        t_flush = time.perf_counter()
        if want:
            await asyncio.wait_for(self.observer.event.wait(), TIMEOUT_S)
        t_all = time.perf_counter()
        await settle()
        self.take_fences(want, "the host-led leg")
        after = self.server_rpc.fanout_stats()
        dispatches = self.dispatches_since(mark)
        del node
        self.settle_block()
        return {"row": row, "closure": int(closure.sum()), "fenced": sorted(want),
                "lat_waves": backend.graph.lat_waves - lat0, "dispatches": dispatches,
                "invalidate_to_flushed_ms": (t_flush - t0) * 1e3,
                "fanout_ms": (t_all - t_flush) * 1e3,
                "frames": after["batch_frames_sent"] - before["batch_frames_sent"]}

    # ------------------------------------------------------------------ lone
    async def lone_ab(self, samples: int) -> dict:
        """The script's single-client single-key A/B, modes alternating per
        sample, on the first in-memory client: each sample one
        ``cascade_rows_batch(block, [key])`` whose subscriber must be
        fenced."""
        backend, block = self.backend, self.block
        client = next(c for c in self.clients if c.transport == "memory")
        key = int(client.keys[0])
        lat_ms = {"coalesced": [], "perkey": []}
        dispatches = None
        for i in range(samples * 2):
            mark = self.dispatch_mark()
            mode = ("coalesced", "perkey")[i % 2]
            self.set_mode(mode)
            self.observer.arm(1)
            await client.subscribe(self.observer, self.svc.base, keys=np.asarray([key]))
            await settle(0.01)
            backend.flush()
            t0 = time.perf_counter()
            backend.cascade_rows_batch(block, [key])
            await asyncio.wait_for(self.observer.event.wait(), 30.0)
            lat_ms[mode].append((time.perf_counter() - t0) * 1e3)
            backend.refresh_block_on_device(block)
            backend.flush()
            await settle(0.005)
            self.take_fences({(client.i, key)}, f"lone sample {i}")
            dispatches = self.dispatches_since(mark, dispatches)
        out = {}
        for mode, arr in lat_ms.items():
            out[f"{mode}_lone_ms_p50"], out[f"{mode}_lone_ms_p99"] = percentiles(arr)
        out["lone_samples_per_mode"] = samples
        out["lone_dispatches"] = dispatches
        return out

    async def close(self) -> None:
        for c in self.clients:
            await c.rpc.stop()
        if self.tcp_server is not None:  # before the hub: its handlers wait on the peers
            await self.tcp_server.stop()
        if self.server_rpc is not None:
            await self.server_rpc.stop()
        if self.fanout_index is not None:
            self.fanout_index.dispose()


def run_fanout(n_nodes: int = N_NODES, deg: float = 3, clients: int = 100,
               keys_per_client: int = 16, rounds: int = 2, groups: int = 32,
               seeds_per_group: int = 4, modes: Sequence[str] = MODES, lone_samples: int = 24,
               outside_keys: int = 0, tcp_clients: int = 0, edges=None, device=None,
               api: Optional[FanoutApi] = None, ctx: Optional[dict] = None) -> dict:
    """Build the stack (unless ``ctx`` is given), run the script's modes,
    the host-led leg and the lone A/B; returns the record with
    the script's keys (``{mode}_clients_fenced_per_s``,
    ``coalesced_vs_perkey_speedup``, ``{mode}_lone_ms_p50``, ...) and the
    per-round records under ``rounds``. Prints nothing."""
    api = api if api is not None else port_api(device)
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"unknown fanout mode {mode!r}; modes are {MODES}")
    return asyncio.run(_run(api, ctx, n_nodes, deg, edges, dict(
        clients=clients, keys_per_client=keys_per_client, groups=groups,
        seeds_per_group=seeds_per_group, outside_keys=outside_keys, tcp_clients=tcp_clients),
        rounds, list(modes), lone_samples))


async def _run(api, ctx, n, deg, edges, kw, rounds, modes, lone_samples) -> dict:
    core = api.core
    old = core.set_default_hub(ctx["backend"].hub if ctx is not None else core.FusionHub())
    try:
        if ctx is None:
            ctx = build_stack(api, n, edges, deg,
                              edge_headroom=max(65536, 8 * kw["clients"]
                                                * kw["keys_per_client"] * rounds))
        run = FanoutRun(api, ctx, **kw)
        record = {"metric": "fanout_path", "package": api.name, "nodes": run.n,
                  "edges": int(ctx["backend"].edge_count), "clients": run.n_clients,
                  "keys_per_client": run.keys_per_client,
                  "subscriptions": run.n_clients * run.keys_per_client, "rounds": rounds,
                  "lane_groups": run.n_groups, "wire_codec": True,
                  "build_s": ctx.get("build_s"), "mirror_build_s": ctx.get("mirror_build_s")}
        try:
            record.update(await run.start())
            results = {mode: await run.run_mode(mode, rounds) for mode in modes}
            record["rounds"] = [r for m in modes for r in results[m].pop("rounds")]
            record["host_led"] = await run.host_led()
            if lone_samples > 0:
                record.update(await run.lone_ab(lone_samples))
        finally:
            await run.close()
        a = results.get("coalesced", {}).get("clients_fenced_per_s")
        b = results.get("perkey", {}).get("clients_fenced_per_s")
        record["coalesced_vs_perkey_speedup"] = a / b if a and b else None
        record.update({f"{m}_{k}": v for m, r in results.items() for k, v in r.items()})
        return record
    finally:
        core.set_default_hub(old)
