"""Twin of ``perf/edge_path.py``: a million simulated sessions behind the live burst.

    from stl_fusion_tpu_torch.edge_path import run_edge
    record = run_edge()                 # 2M rows on the CUDA device
    record = run_edge(n_nodes=20_000, sessions=2_000, keys=64, edge_nodes=2,
                      workers=1, device="cpu")

The server is the live twin's stack (``live_path.py``'s ``DagTable`` bound as
one row block over ``power_law_dag(n, 3, seed=7)``, warmed on the device,
the topo mirror built) behind an ``RpcHub`` that serves the service as
``"dag"`` with the ``$sys-c`` compute call type, a
:class:`~.rpc.fanout.ComputeFanoutIndex` on the backend's newly hooks and,
on the ``block`` value plane, a :class:`~.rpc.fanout.WaveValuePublisher`.
``edge_nodes`` :class:`~.edge.EdgeNode` gateways, each on its own
``FusionHub`` and ``RpcHub`` over ``RpcTestTransport(wire_codec=True)``,
each hold ONE upstream subscription per distinct key: ``keys`` tail rows
(``n - 1 - choice(n // 4)`` from ``default_rng(523)``), subscribed by one
probe session an edge over every key. ``sessions`` simulated end-user
sessions (``sessions // edge_nodes`` an edge) pick ``keys_per_session``
keys each by zipf ``zipf``; with ``workers`` > 0 they live in each edge's
:class:`~.edge.EdgeWorkerPool` (``workers`` OS processes an edge that get
each fenced frame's bytes once and pay the per-session envelope), else in
the parent. A lane burst (``cascade_rows_lanes``) of ``groups`` groups (the
keys round-robin plus ``seeds_per_group`` deep seeds from ``n // 10`` each)
fences every key, after one untimed warm burst before the edges exist.

Defaults are the script's (``EDGE_NODES=4``, ``EDGE_SESSIONS=1_000_000``,
``EDGE_KEYS=512``, ``EDGE_KEYS_PER_SESSION=2``, ``EDGE_ZIPF=1.1``,
``EDGE_ROUNDS=2``, ``EDGE_GROUPS=16``, ``EDGE_SEEDS_PER_GROUP=2``, the wire
codec on, ``EDGE_WORKERS=2``, ``EDGE_FAN_WORKERS=2``,
``EDGE_VALUE_PLANE=block``, ``EDGE_ACCEPT_PLANE=send_fds``, the smoke leg)
at ``EDGE_GRAPH_NODES=2_000_000``. The script's hard asserts are checks
here, each raising :class:`EdgeCheckFailed`, and each held on EVERY round
(the script holds the delivery total over all rounds):

- each edge holds exactly ``keys`` upstream subscriptions and the server's
  index ``edge_nodes * keys``;
- every expected delivery arrives, exactly: each worker's and each edge's
  probe deliveries equal their subscriptions (every key is a seed of the
  burst, so inside its union), and every key's subscription advanced by
  exactly one version to the server's value;
- zero evictions, and no worker process died or stalled (a stats poll
  that times out raises; nothing carries on in the parent in its place);
- on the ``batch`` and ``block`` planes no per-key upstream re-read on the
  measured bursts; on ``block`` no upstream RPC at all (no
  ``recompute_batch`` frame), every fence a block hit and no publisher
  fallback fence;
- encodes between ``edge_nodes * keys`` and the distinct fanned (key,
  version) pairs plus that, each edge too, and deliveries per encode above
  the script's floor (``min(100, max(2, subscriptions / (2 * edge_nodes *
  keys)))``, 100 at the defaults).

Two delivery clocks, never mixed: the system's own
``fusion_edge_delivery_ms`` histogram (from the server's wave-apply stamp,
which is taken when the host apply starts, to client-visible; the workers'
samples merge in at each stats poll), diffed a round; and a harness clock
that starts when the burst returns: each probe session's delivery
(``harness_delivery_ms``, one a key an edge) and each worker's completion
(``worker_done_ms``, the first 20 ms stats poll that shows the worker's
round delivered).

:class:`EdgeRun` runs on a stack that is already built (``ctx``, the live
twin's observer context: ``backend``, ``block``, ``table``, ``svc``,
``n``), so a caller with the live stack builds no second graph. ``api``
runs the scenario through another package with this one's API (the parity
tests pass the JAX package's modules). ``around_burst(round, fn)`` runs
each measured burst.
"""
from __future__ import annotations

import asyncio
import gc
import json
import time
import urllib.parse
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .device import resolve_device
from .fanout_path import build_stack, dispatch_mark, dispatches_since, percentiles, settle

__all__ = ["EdgeApi", "EdgeCheckFailed", "EdgeRun", "port_api", "run_edge"]

N_NODES = 2_000_000
KEY_SEED = 523
#: the script's ``EDGE_TIMEOUT_S``: the longest wait for a round's deliveries
TIMEOUT_S = 600.0
VALUE_PLANES = ("block", "batch", "perkey")
ACCEPT_PLANES = ("send_fds", "reuseport")
#: the harness polls the workers' delivery counts this often
POLL_S = 0.02


class EdgeCheckFailed(AssertionError):
    """One of the script's hard asserts failed."""


class EdgeApi(NamedTuple):
    """What the scenario needs of a package: its ``core``, ``graph``,
    ``rpc``, ``client``, ``edge`` and ``diagnostics`` modules, the
    backend's extra arguments, a numpy → device-array conversion for the
    loader's base table, and a device sync."""

    core: Any
    graph: Any
    rpc: Any
    client: Any
    edge: Any
    diagnostics: Any
    backend_kwargs: dict
    to_device: Callable[[np.ndarray], Any]
    sync: Callable[[], None]
    name: str


def port_api(device=None) -> EdgeApi:
    """This package on ``device`` (``cuda`` unless given)."""
    from . import client, core, diagnostics, edge, graph, rpc

    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return EdgeApi(core, graph, rpc, client, edge, diagnostics, {"device": dev},
                   lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), sync,
                   f"stl_fusion_tpu_torch on {dev}")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise EdgeCheckFailed(f"edge path: {what}")


async def until(pred, timeout_s: float, what: str) -> None:
    deadline = time.perf_counter() + timeout_s
    while not pred():
        if time.perf_counter() > deadline:
            raise EdgeCheckFailed(f"edge path: timed out waiting for {what}")
        await asyncio.sleep(0.01)


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def zipf_weights(n: int, a: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = 1.0 / ranks**a
    return w / w.sum()


class Observer:
    """Counts fence deliveries to an edge's in-parent sessions (one shared
    sink an edge) and when each arrived on the host clock."""

    def __init__(self):
        self.fenced = 0
        self.expected = 0
        self.times: list = []
        self.event = asyncio.Event()

    def arm(self, expected: int) -> None:
        self.fenced = 0
        self.expected = expected
        self.times = []
        self.event.clear()

    def sink(self, frame) -> None:
        # fence frames carry the wave-apply origin timestamp; initial
        # attach frames do not and stay uncounted
        if frame[4] is not None:
            self.fenced += 1
            self.times.append(time.perf_counter())
            if self.fenced >= self.expected:
                self.event.set()


class Edge:
    """One in-process edge gateway: its own fusion hub, RpcHub, transport
    (the wire codec) and :class:`~.edge.EdgeNode`, a shared delivery
    observer, and optionally a worker pool."""

    def __init__(self, api: EdgeApi, i: int, server_rpc, wire_codec: bool, fan_workers: int,
                 value_plane: str):
        self.i = i
        self.fusion = api.core.FusionHub()
        self.rpc = api.rpc.RpcHub(f"edge-{i}")
        api.client.install_compute_call_type(self.rpc)
        api.rpc.RpcTestTransport(self.rpc, server_rpc, wire_codec=wire_codec,
                                 client_name=f"e{i}")
        self.node = api.edge.EdgeNode("dag", self.rpc, self.fusion, name=f"edge-{i}",
                                      fan_workers=fan_workers,
                                      reread_batch=value_plane != "perkey",
                                      value_blocks=value_plane == "block")
        self.observer = Observer()
        self.pool = None
        #: per-worker subscriptions, and the deliveries before the round
        self.worker_expected: list = []
        self.worker_base: list = []

    async def worker_delivered(self) -> list:
        """Each worker's deliveries since the round's arm (one stats round
        trip, which also merges the workers' delivery histograms into the
        process registry); a worker process that exited fails the run."""
        stats = await self.pool.stats()
        for w in self.pool._workers:
            require(w.proc.poll() is None,
                    f"edge {self.i}: worker {w.index} exited ({w.proc.returncode})")
        return [s["deliveries"] - b for s, b in zip(stats, self.worker_base)]


class EdgeRun:
    """The scenario on a built stack ``ctx``: :meth:`start`, then
    :meth:`run_rounds`, :meth:`gates`, :meth:`smoke` and :meth:`close`."""

    def __init__(self, api: EdgeApi, ctx: dict, edge_nodes: int = 4, sessions: int = 1_000_000,
                 keys: int = 512, keys_per_session: int = 2, zipf: float = 1.1, groups: int = 16,
                 seeds_per_group: int = 2, wire_codec: bool = True, workers: int = 2,
                 fan_workers: int = 2, value_plane: str = "block",
                 accept_plane: str = "send_fds", around_burst: Optional[Callable] = None):
        if value_plane not in VALUE_PLANES:
            raise ValueError(f"value_plane must be one of {VALUE_PLANES}, got {value_plane!r}")
        if accept_plane not in ACCEPT_PLANES:
            raise ValueError(f"accept_plane must be one of {ACCEPT_PLANES}, "
                             f"got {accept_plane!r}")
        self.api = api
        self.backend, self.block, self.table, self.svc = (ctx["backend"], ctx["block"],
                                                          ctx["table"], ctx["svc"])
        self.n = int(ctx["n"])
        self.n_edges, self.n_sessions, self.n_keys = edge_nodes, sessions, keys
        self.keys_per_session, self.zipf = keys_per_session, zipf
        self.n_groups, self.seeds_per_group = groups, seeds_per_group
        self.wire_codec, self.n_workers, self.fan_workers = wire_codec, workers, fan_workers
        self.value_plane, self.accept_plane = value_plane, accept_plane
        self.around_burst = around_burst or (lambda rnd, fn: fn())
        self.rng = np.random.default_rng(KEY_SEED)
        self.edges: list = []
        self.server_rpc = self.fanout_index = self.publisher = None
        self.dispatches: dict = {}

    # ------------------------------------------------------------------ set-up
    async def start(self) -> dict:
        """The script's set-up, in its order: the server hub, the keys and
        groups, the untimed warm burst, the edges and their pools, the
        upstream subscriptions, then the sessions."""
        api, backend, block, n = self.api, self.backend, self.block, self.n
        # edge nodes export into the process registry: those of earlier
        # runs in this process must not count in this run's scrape
        gc.collect()
        self.server_rpc = api.rpc.RpcHub("server")
        api.client.install_compute_call_type(self.server_rpc)
        self.server_rpc.add_service("dag", self.svc)
        self.fanout_index = api.rpc.install_compute_fanout(self.server_rpc, backend)
        if self.value_plane == "block":
            self.publisher = api.rpc.install_value_publisher(self.server_rpc)
        # distinct keys: tail rows (shallow own closures; the deep seeds
        # give the wave its full-scale walk)
        self.key_rows = np.sort(n - 1 - self.rng.choice(n // 4, size=self.n_keys, replace=False))
        self.key_specs = [("node", int(r)) for r in self.key_rows]
        self.groups = [list() for _ in range(self.n_groups)]
        for j, r in enumerate(self.key_rows.tolist()):
            self.groups[j % self.n_groups].append(int(r))
        deep = self.rng.choice(n // 10, size=(self.n_groups, self.seeds_per_group),
                               replace=False)
        for gi in range(self.n_groups):
            self.groups[gi].extend(int(s) for s in deep[gi])
        mark = dispatch_mark(backend)
        t0 = time.perf_counter()
        backend.cascade_rows_lanes(block, self.groups)
        backend.refresh_block_on_device(block)
        backend.flush()
        api.sync()
        warm_s = time.perf_counter() - t0
        self.dispatches["warm"] = dispatches_since(backend, mark)

        rss_before = rss_mb()
        self.edges = [Edge(api, i, self.server_rpc, self.wire_codec, self.fan_workers,
                           self.value_plane) for i in range(self.n_edges)]
        if self.n_workers > 0:
            for e in self.edges:
                e.pool = await api.edge.EdgeWorkerPool(
                    e.node, workers=self.n_workers, accept_plane=self.accept_plane).start()
        mark = dispatch_mark(backend)
        t0 = time.perf_counter()
        # one probe session an edge over every key primes the upstream
        # subscriptions; the sessions proper ride the same subscriptions
        for e in self.edges:
            e.node.attach(self.key_specs, sink=e.observer.sink, track_versions=False)
        for e in self.edges:
            await until(lambda e=e: len(e.node._subs) == self.n_keys
                        and all(s.version >= 1 for s in e.node._subs.values()),
                        TIMEOUT_S, f"edge {e.i} upstream warm")
        subscribe_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        weights = zipf_weights(self.n_keys, self.zipf)
        self.per_edge = self.n_sessions // self.n_edges
        sim_subs = 0
        for e in self.edges:
            picks = self.rng.choice(self.n_keys, size=(self.per_edge, self.keys_per_session),
                                    p=weights)
            if self.n_workers > 0:
                # sessions round-robin over the edge's worker processes;
                # each worker holds the per-session envelope prefixes, the
                # parent only the subscription counts a worker
                counts = [dict() for _ in range(self.n_workers)]
                for si, row in enumerate(picks):
                    c = counts[si % self.n_workers]
                    for k in set(row.tolist()):
                        spec = self.key_specs[k]
                        c[spec] = c.get(spec, 0) + 1
                e.worker_expected = []
                for w, cmap in enumerate(counts):
                    e.worker_expected.append(await e.pool.add_sim_sessions(w, cmap))
                sim_subs += sum(e.worker_expected)
            else:
                for row in picks:
                    e.node.attach([self.key_specs[k] for k in set(row.tolist())],
                                  sink=e.observer.sink, track_versions=False,
                                  replay_current=False)
        attach_s = time.perf_counter() - t0
        self.per_edge_rss_mb = (rss_mb() - rss_before) / self.n_edges
        parent_sessions = sum(len(e.node._sessions) for e in self.edges)
        self.total_sessions = parent_sessions + (self.per_edge * self.n_edges
                                                 if self.n_workers > 0 else 0)
        self.expected_per_round = sum(sub.session_count for e in self.edges
                                      for sub in e.node._subs.values()) + sim_subs
        # ONE upstream subscription per distinct key an edge, and the
        # server sees edges x keys subscriptions, not sessions x keys
        for e in self.edges:
            require(len(e.node._subs) == self.n_keys,
                    f"edge {e.i} holds {len(e.node._subs)} upstream subs, want {self.n_keys}")
        await until(lambda: self.fanout_index.subscriptions == self.n_edges * self.n_keys,
                    TIMEOUT_S, "server-side subscription registration")
        self.dispatches["subscribe"] = dispatches_since(backend, mark)
        # the first-burst gate: the warm subscribe storm already rides the
        # value plane (per-key re-reads at most one a key)
        self.warm_counts = self.upstream_counts()
        if self.value_plane in ("batch", "block"):
            require(self.warm_counts["per_key"] <= self.n_edges * self.n_keys,
                    f"first-burst per-key re-reads {self.warm_counts['per_key']} exceed "
                    f"{self.n_edges * self.n_keys} keys: the batched path never engaged")
            require(self.warm_counts["batches"] >= self.n_edges,
                    f"no recompute_batch frames on the warm subscribe "
                    f"({self.warm_counts['batches']})")
        return {"warm_burst_s": warm_s, "subscribe_s": subscribe_s, "attach_s": attach_s,
                "attach_sessions_per_s": self.total_sessions / attach_s if attach_s else None,
                "subscribers": self.total_sessions, "sessions_per_edge": self.per_edge,
                "subscriptions": self.expected_per_round,
                "upstream_subs_per_edge": [len(e.node._subs) for e in self.edges],
                "server_subscriptions": self.fanout_index.subscriptions,
                "per_edge_rss_mb": self.per_edge_rss_mb}

    def upstream_counts(self) -> dict:
        return {"rpcs": sum(e.node.upstream_rpcs for e in self.edges),
                "per_key": sum(e.node.per_key_rereads for e in self.edges),
                "batches": sum(e.node.reread_batches for e in self.edges),
                "block_hits": sum(e.node.block_hits for e in self.edges),
                "fences": sum(e.node.upstream_fences for e in self.edges)}

    def delivery_hist(self):
        return self.api.diagnostics.global_metrics().histogram(
            "fusion_edge_delivery_ms",
            help="server fence (wave apply) -> edge session client-visible")

    # ------------------------------------------------------------------ rounds
    async def run_rounds(self, rounds: int) -> dict:
        """``rounds`` measured bursts, each checked exactly."""
        backend, block = self.backend, self.block
        hist = self.delivery_hist()
        base = np.asarray(self.svc.base)
        rec_rounds = []
        fanout_s = burst_s = 0.0
        deliveries = 0
        dispatches = None
        for rnd in range(rounds):
            # every upstream subscription re-registered (the last round's
            # fences unindexed them until each edge's re-read landed)
            await until(lambda: self.fanout_index.subscriptions == self.n_edges * self.n_keys,
                        TIMEOUT_S, f"round {rnd} re-subscription")
            backend.flush()
            versions = {(e.i, k): sub.version for e in self.edges
                        for k, sub in e.node._subs.items()}
            for e in self.edges:
                e.observer.arm(sum(sub.session_count for sub in e.node._subs.values()))
                if e.pool is not None:
                    e.worker_base = [s["deliveries"] for s in await e.pool.stats()]
            before = self.upstream_counts()
            mark = dispatch_mark(backend)
            cp = hist.checkpoint()
            t0 = time.perf_counter()
            counts = self.around_burst(rnd, lambda: backend.cascade_rows_lanes(block,
                                                                               self.groups))
            t_burst = time.perf_counter()
            await asyncio.wait_for(asyncio.gather(*(e.observer.event.wait()
                                                    for e in self.edges)), TIMEOUT_S)
            t_probe = time.perf_counter()
            done_ms = {}
            if self.n_workers > 0:
                # the worker processes reach their round quota in
                # parallel; each poll also merges their histograms
                deadline = time.perf_counter() + TIMEOUT_S
                while len(done_ms) < self.n_edges * self.n_workers:
                    for e in self.edges:
                        got = await e.worker_delivered()
                        now = time.perf_counter()
                        for w, (d, want) in enumerate(zip(got, e.worker_expected)):
                            if d >= want and (e.i, w) not in done_ms:
                                done_ms[(e.i, w)] = (now - t_burst) * 1e3
                    if time.perf_counter() > deadline:
                        raise EdgeCheckFailed(f"edge path: timed out waiting for round {rnd} "
                                              "worker deliveries")
                    if len(done_ms) < self.n_edges * self.n_workers:
                        await asyncio.sleep(POLL_S)
            t_all = time.perf_counter()
            delivery = hist.since(cp)
            await settle()  # a frame delivered twice lands here
            worker_round = 0
            for e in self.edges:
                require(e.observer.fenced == e.observer.expected,
                        f"round {rnd}: edge {e.i} probe deliveries {e.observer.fenced} != "
                        f"{e.observer.expected}")
                if e.pool is not None:
                    got = await e.worker_delivered()
                    require(got == e.worker_expected,
                            f"round {rnd}: edge {e.i} worker deliveries {got} != "
                            f"{e.worker_expected}")
                    worker_round += sum(got)
                for k, sub in e.node._subs.items():
                    require(sub.version == versions[(e.i, k)] + 1,
                            f"round {rnd}: edge {e.i} key {k} went from version "
                            f"{versions[(e.i, k)]} to {sub.version}, want one fence")
                    frame = sub.last_frame
                    row = int(sub.args[0])
                    require(frame is not None and frame[5] is None and frame[4] is not None
                            and frame[2] == float(base[row]),
                            f"round {rnd}: edge {e.i} key {k} serves {frame}, the server "
                            f"holds {float(base[row])}")
            for e in self.edges:
                require(len(e.node._subs) == self.n_keys,
                        f"round {rnd}: edge {e.i} holds {len(e.node._subs)} upstream subs, "
                        f"want {self.n_keys}")
            round_total = sum(e.observer.fenced for e in self.edges) + worker_round
            require(round_total == self.expected_per_round,
                    f"round {rnd}: deliveries {round_total} != expected "
                    f"{self.expected_per_round}")
            evictions = self.evictions()
            require(evictions == 0, f"round {rnd}: {evictions} sessions were evicted")
            after = self.upstream_counts()
            delta = {k: after[k] - before[k] for k in after}
            if self.value_plane in ("batch", "block"):
                require(delta["per_key"] == 0,
                        f"round {rnd}: {delta['per_key']} per-key upstream re-read RPCs")
            if self.value_plane == "block":
                require(delta["rpcs"] == 0,
                        f"round {rnd}: {delta['rpcs']} upstream re-read RPCs on a block-warm "
                        f"burst ({delta['batches']} recompute_batch frames)")
                require(delta["block_hits"] == self.n_edges * self.n_keys,
                        f"round {rnd}: block hits {delta['block_hits']} != "
                        f"{self.n_edges * self.n_keys} fences")
                require(self.publisher.stats()["fallback_fences"] == 0,
                        f"round {rnd}: the publisher fell back to plain fences "
                        f"({self.publisher.stats()['fallback_fences']})")
            probe_ms = [(t - t_burst) * 1e3 for e in self.edges for t in e.observer.times]
            h50, h99 = percentiles(probe_ms)
            burst_s += t_burst - t0
            fanout_s += t_all - t_burst
            deliveries += round_total
            rec_rounds.append({
                "round": rnd, "inv": int(np.asarray(counts).sum()),
                "burst_ms": (t_burst - t0) * 1e3, "fanout_ms": (t_all - t_burst) * 1e3,
                "probe_fanout_ms": (t_probe - t_burst) * 1e3, "deliveries": round_total,
                "deliveries_per_s": round_total / (t_all - t_burst),
                "system_delivery_ms": delivery,
                "system_delivery_ms_p50_p99": [delivery.get("p50"), delivery.get("p99")],
                "harness_delivery_ms_p50_p99": [h50, h99],
                "harness_delivery_samples": len(probe_ms),
                "worker_done_ms": sorted(done_ms.values()),
                "upstream": delta,
                "block_hit_ratio": delta["block_hits"] / delta["fences"]
                if delta["fences"] else None})
            backend.refresh_block_on_device(block)
            backend.flush()
            await settle()
            dispatches = dispatches_since(backend, mark, dispatches)
        self.dispatches["rounds"] = dispatches
        self.rounds = rounds
        return {"rounds": rec_rounds, "burst_s": burst_s, "fanout_s": fanout_s,
                "fenced_total": deliveries,
                "fenced_per_s": deliveries / fanout_s if fanout_s else None}

    def evictions(self) -> int:
        out = sum(e.node.evictions for e in self.edges)
        for e in self.edges:
            if e.pool is not None:
                out += sum(w.last_stats.get("evictions", 0) for w in e.pool._workers
                           if w.last_stats)
        return out

    # ------------------------------------------------------------------ gates
    async def gates(self) -> dict:
        """The script's value-plane and amortization gates over the
        measured rounds."""
        final = self.upstream_counts()
        warm = self.warm_counts
        measured = {k: final[k] - warm[k] for k in final}
        worker_rss, worker_deliveries = [], 0
        for e in self.edges:
            if e.pool is not None:
                for s in await e.pool.stats():
                    worker_rss.append(s.get("rss_mb", 0.0))
                    worker_deliveries += s.get("deliveries", 0)
        evictions = self.evictions()
        require(evictions == 0, f"{evictions} sessions were evicted mid-run")
        # encodes ~ distinct fanned (key, version) pairs (a sub's version
        # counts exactly its fanned versions) and far below deliveries
        encodes = sum(e.node.frames_encoded for e in self.edges)
        versions = sum(sub.version for e in self.edges for sub in e.node._subs.values())
        deliveries = sum(e.node.deliveries for e in self.edges) + worker_deliveries
        require(encodes >= self.n_edges * self.n_keys,
                f"the serialize-once cache never engaged (encodes {encodes})")
        for e in self.edges:
            v = sum(sub.version for sub in e.node._subs.values())
            require(e.node.frames_encoded <= v + self.n_keys,
                    f"edge {e.i}: per-session encode re-entry: {e.node.frames_encoded} "
                    f"encodes for {v} fanned (key, version) pairs")
        ratio = deliveries / encodes if encodes else 0.0
        floor = min(100.0, max(2.0, self.expected_per_round / (self.n_edges * self.n_keys * 2)))
        require(ratio >= floor, f"encode ratio {ratio:.1f} below floor {floor:.1f} "
                                f"({deliveries} deliveries / {encodes} encodes)")
        batches = sum(e.node.reread_batches for e in self.edges)
        return {"upstream_rpcs_per_burst": measured["rpcs"] / self.rounds if self.rounds
                else None,
                "per_key_rereads_measured": measured["per_key"],
                "reread_batches_measured": measured["batches"],
                "block_hits_measured": measured["block_hits"],
                "block_hit_ratio": measured["block_hits"] / measured["fences"]
                if measured["fences"] else None,
                "reread_batch_size": sum(e.node.reread_batch_keys for e in self.edges) / batches
                if batches else None,
                "upstream_rpcs_total": final["rpcs"], "per_key_rereads_total": final["per_key"],
                "reread_fallbacks": sum(e.node.reread_fallbacks for e in self.edges),
                "block_hits_total": final["block_hits"],
                "publisher": self.publisher.stats() if self.publisher is not None else None,
                "frames_encoded": encodes, "encodes_per_edge": [e.node.frames_encoded
                                                                for e in self.edges],
                "fanned_versions": versions, "deliveries_total": deliveries,
                "encode_ratio": ratio, "encode_ratio_floor": floor, "evictions": evictions,
                "coalesced_frames": sum(e.node.coalesced_frames for e in self.edges),
                "per_worker_rss_mb": worker_rss,
                "upstream_subs_per_edge": [len(e.node._subs) for e in self.edges],
                "server_subscriptions": self.fanout_index.subscriptions}

    # ------------------------------------------------------------------ smoke
    async def smoke(self) -> dict:
        """A real ``EdgeHttpServer`` on the first edge with live SSE
        consumers over TCP loopback (and a WebSocket consumer where
        ``websockets`` is installed), one burst, a scrape of ``/metrics``
        and, with a pool, one consumer through the pool's listener."""
        api, backend, block = self.api, self.backend, self.block
        edge = self.edges[0]
        node = edge.node
        nodes = [e.node for e in self.edges]
        expected_upstream = self.n_edges * self.n_keys
        http = await api.edge.EdgeHttpServer(node, heartbeat_interval=5.0).start()
        key_specs = [(sub.method, *sub.args) for sub in list(node._subs.values())[:2]]
        keys_q = urllib.parse.quote(json.dumps([list(k) for k in key_specs]))
        try:
            import websockets  # noqa: F401  (optional: the WebSocket leg)
            ws_leg = None
        except ImportError:
            ws_leg = "not run: websockets not installed"
        ws_server = ws_conn = None
        writers = []
        mark = dispatch_mark(backend)
        try:
            if ws_leg is None:
                from websockets.asyncio.client import connect as ws_connect

                ws_server = await api.edge.EdgeWebSocketServer(node,
                                                               heartbeat_interval=5.0).start()
                ws_conn = await ws_connect(ws_server.url)
                await ws_conn.send(json.dumps({"keys": [list(k) for k in key_specs]}))
                hello = json.loads(await asyncio.wait_for(ws_conn.recv(), 30.0))
                require("hello" in hello, f"smoke: bad WebSocket hello {hello}")
                replay = json.loads(await asyncio.wait_for(ws_conn.recv(), 30.0))
                require(len(replay.get("frames", [])) >= 1,
                        f"smoke: WebSocket replay missing ({replay})")
            readers = []
            for _ in range(2):
                reader, writer = await asyncio.open_connection(http.host, http.port)
                writers.append(writer)
                await _sse_open(reader, writer, keys_q)
                readers.append(reader)
            for reader in readers:
                hello = await _read_event(reader)
                require(hello.get("event") == "hello", f"smoke: bad hello {hello}")
                for _ in key_specs:
                    ev = await _read_event(reader)
                    require(ev.get("event") == "update", f"smoke: bad initial {ev}")
            await until(lambda: self.fanout_index.subscriptions == expected_upstream,
                        TIMEOUT_S, "smoke re-subscription")
            backend.flush()
            per_key_before = sum(nd.per_key_rereads for nd in nodes)
            rpcs_before = sum(nd.upstream_rpcs for nd in nodes)
            backend.cascade_rows_lanes(block, self.groups)
            seen = []
            for reader in readers:
                ev = await _read_event(reader)
                require(ev.get("event") == "update", f"smoke: bad update {ev}")
                seen.append(json.loads(ev["data"]))
            require(all("t0" in d for d in seen), "smoke: frames lost the origin timestamp")
            ws_update_frames = None
            if ws_conn is not None:
                deadline = time.perf_counter() + 30.0
                while ws_update_frames is None:
                    require(time.perf_counter() < deadline, "smoke: WebSocket update never came")
                    msg = json.loads(await asyncio.wait_for(ws_conn.recv(), 30.0))
                    frames = msg.get("frames")
                    if frames and any(f.get("t0") is not None for f in frames):
                        ws_update_frames = len(frames)
                ws_leg = {"consumers": 1, "update_frames": ws_update_frames}
            per_key_after = sum(nd.per_key_rereads for nd in nodes)
            if self.value_plane != "perkey":
                require(per_key_after <= expected_upstream,
                        f"smoke: {per_key_after} per-key re-reads exceed the "
                        f"{expected_upstream} distinct-key total")
            if self.value_plane == "block":
                require(per_key_after == per_key_before,
                        f"smoke: {per_key_after - per_key_before} per-key re-read(s) on a "
                        "block-served burst")
                await until(lambda: sum(nd.block_hits for nd in nodes) > 0, 30.0,
                            "smoke: value-block hits")
                require(sum(nd.upstream_rpcs for nd in nodes) == rpcs_before,
                        "smoke: upstream re-read RPCs on a block-served burst")
            metrics = await self._scrape(http)
            sessions = metrics.get("fusion_edge_sessions", 0)
            subs = metrics.get("fusion_edge_upstream_subscriptions", 0)
            require(sessions >= 1, f"smoke: fusion_edge_sessions missing ({metrics})")
            require(metrics.get("fusion_edge_delivery_ms_count", 0) > 0,
                    "smoke: the edge delivery histogram is empty")
            # every edge of the process exports into one registry: the total
            # is edges x distinct keys, never sessions x keys
            require(subs == expected_upstream,
                    f"smoke: upstream subscriptions {subs} != distinct-key total "
                    f"{expected_upstream}")
            enc = metrics.get("fusion_edge_frames_encoded_total", 0)
            deliv = (metrics.get("fusion_edge_deliveries_total", 0)
                     + metrics.get("fusion_edge_worker_deliveries_total", 0))
            versions = sum(sub.version for nd in nodes for sub in nd._subs.values())
            slack = sum(len(nd._subs) for nd in nodes)
            require(enc > 0, "smoke: fusion_edge_frames_encoded_total missing or zero")
            require(enc <= versions + slack, f"smoke: per-session encode re-entry: {enc} "
                                             f"encodes for {versions} fanned pairs")
            require(deliv >= 2 * enc, f"smoke: encode amortization not engaged: {deliv} "
                                      f"deliveries for {enc} encodes")
            workers = None
            if edge.pool is not None:
                port = await edge.pool.listen()
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                writers.append(writer)
                await _sse_open(reader, writer, keys_q)
                hello = await _read_event(reader)
                require(hello.get("event") == "hello", f"smoke: bad worker hello {hello}")
                replays = [await _read_event(reader) for _ in key_specs]
                require(all(ev.get("event") == "update" for ev in replays),
                        f"smoke: bad worker replay {replays}")
                require(all("t0" not in json.loads(ev["data"]) for ev in replays),
                        "smoke: the worker replay leaked the stale fence origin_ts")
                stats = await edge.pool.stats()
                workers = {"workers": len(stats),
                           "worker_deliveries": sum(s["deliveries"] for s in stats)}
        finally:
            for w in writers:
                w.close()
            if ws_conn is not None:
                await ws_conn.close()
            if ws_server is not None:
                await ws_server.stop()
            await http.stop()
        backend.refresh_block_on_device(block)
        backend.flush()
        self.dispatches["smoke"] = dispatches_since(backend, mark)
        return {"sse_consumers": len(readers), "ws_leg": ws_leg,
                "block_hits": sum(nd.block_hits for nd in nodes),
                "per_key_rereads": per_key_after, "metrics_sessions": sessions,
                "metrics_upstream_subs": subs,
                "metrics_delivery_count": metrics.get("fusion_edge_delivery_ms_count"),
                "metrics_frames_encoded": enc, "metrics_deliveries": deliv,
                "worker_pool": workers}

    @staticmethod
    async def _scrape(http) -> dict:
        """``GET /metrics`` over real HTTP: the ``fusion_edge_*`` samples."""
        reader, writer = await asyncio.open_connection(http.host, http.port)
        writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), 30.0)
        writer.close()
        metrics = {}
        for line in raw.decode("utf-8", "replace").splitlines():
            if line.startswith("fusion_edge_"):
                name, _, value = line.partition(" ")
                try:
                    metrics[name] = float(value)
                except ValueError:
                    pass
        return metrics

    async def close(self) -> None:
        for e in self.edges:
            await e.node.close()  # stops the edge's worker pool too
            await e.rpc.stop()
        if self.server_rpc is not None:
            await self.server_rpc.stop()
        if self.publisher is not None:
            self.publisher.dispose()
        if self.fanout_index is not None:
            self.fanout_index.dispose()


async def _sse_open(reader, writer, keys_q: str) -> None:
    writer.write(f"GET /edge/sse?keys={keys_q} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    while True:
        line = (await asyncio.wait_for(reader.readline(), 30.0)).decode()
        require(line != "", "smoke: the SSE connection closed during its headers")
        if line in ("\r\n", "\n"):
            return


async def _read_event(reader) -> dict:
    fields = {}
    while True:
        line = (await asyncio.wait_for(reader.readline(), 30.0)).decode()
        require(line != "", "smoke: the SSE stream closed early")
        if line in ("\n", "\r\n"):
            if fields:
                return fields
            continue
        if line.startswith(":"):
            continue
        name, _, value = line.rstrip("\n").partition(":")
        fields[name] = value.strip()


def run_edge(n_nodes: int = N_NODES, deg: float = 3, edge_nodes: int = 4,
             sessions: int = 1_000_000, keys: int = 512, keys_per_session: int = 2,
             zipf: float = 1.1, rounds: int = 2, groups: int = 16, seeds_per_group: int = 2,
             wire_codec: bool = True, workers: int = 2, fan_workers: int = 2,
             value_plane: str = "block", accept_plane: str = "send_fds", smoke: bool = True,
             edges=None, device=None,
             api: Optional[EdgeApi] = None, ctx: Optional[dict] = None) -> dict:
    """Build the stack (unless ``ctx`` is given), run the script's rounds,
    gates and smoke leg; returns the record with the script's keys
    (``fenced_per_s``, ``delivery_ms_p50``/``p99`` of the last round on the
    system's histogram, ``encode_ratio``, ``per_edge_rss_mb``, ...), the
    harness clock's, the per-round records under ``rounds`` and each leg's
    device waves by kind under ``dispatches``. Prints nothing."""
    api = api if api is not None else port_api(device)
    kw = dict(edge_nodes=edge_nodes, sessions=sessions, keys=keys,
              keys_per_session=keys_per_session, zipf=zipf, groups=groups,
              seeds_per_group=seeds_per_group, wire_codec=wire_codec, workers=workers,
              fan_workers=fan_workers, value_plane=value_plane, accept_plane=accept_plane)
    return asyncio.run(_run(api, ctx, n_nodes, deg, edges, kw, rounds, smoke))


async def _run(api, ctx, n, deg, edges, kw, rounds, smoke) -> dict:
    core = api.core
    old = core.set_default_hub(ctx["backend"].hub if ctx is not None else core.FusionHub())
    try:
        if ctx is None:
            ctx = build_stack(api, n, edges, deg, edge_headroom=max(
                65536, 8 * kw["edge_nodes"] * kw["keys"] * (rounds + 2)))
        run = EdgeRun(api, ctx, **kw)
        record = {"metric": "edge_path", "package": api.name, "graph_nodes": run.n,
                  "edges_graph": int(ctx["backend"].edge_count), "edge_nodes": run.n_edges,
                  "distinct_keys": run.n_keys, "keys_per_session": run.keys_per_session,
                  "zipf_a": run.zipf, "rounds": rounds, "lane_groups": run.n_groups,
                  "seeds_per_group": run.seeds_per_group, "wire_codec": run.wire_codec,
                  "edge_workers": run.n_workers, "fan_workers": run.fan_workers,
                  "accept_plane": run.accept_plane if run.n_workers else None,
                  "value_plane": run.value_plane, "build_s": ctx.get("build_s"),
                  "mirror_build_s": ctx.get("mirror_build_s")}
        try:
            record.update(await run.start())
            rec = await run.run_rounds(rounds)
            record.update(rec)
            last = rec["rounds"][-1] if rec["rounds"] else {}
            record["delivery_ms_p50"], record["delivery_ms_p99"] = last.get(
                "system_delivery_ms_p50_p99", [None, None])
            record["harness_delivery_ms_p50"], record["harness_delivery_ms_p99"] = last.get(
                "harness_delivery_ms_p50_p99", [None, None])
            record.update(await run.gates())
            if smoke:
                record["smoke"] = await run.smoke()
        finally:
            await run.close()
        record["dispatches"] = run.dispatches
        return record
    finally:
        core.set_default_hub(old)
