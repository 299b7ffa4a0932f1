"""Parity of the port's sharded wave (``stl_fusion_tpu_torch.parallel``) and its
live mesh bridge with the JAX package's, on the conftest's 8-device virtual
CPU mesh against a port mesh of 8 CPU shards. The same numpy graphs, epochs
and seeds go to both packages and to a union-rule BFS oracle. Tolerance:
exact — masks bit-identical, counts and ids equal. Each case is the port
counterpart of one in ``tests/test_sharded_wave.py``, run on both packages."""
import torch_threads  # noqa: F401 — one torch thread a test process
import functools
from collections import deque

import numpy as np
import pytest

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu.parallel as jpar
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.graph as pgraph
import stl_fusion_tpu_torch.parallel as ppar
from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu_torch.ops import wave as tw
from stl_fusion_tpu_torch.ops.bitops import pack_bits

from test_device_graph import random_dag

N_DEV = 8
PKGS = ["jax", "port"]


def _mesh(pkg):
    return jpar.graph_mesh() if pkg == "jax" else ppar.graph_mesh(N_DEV, device="cpu")


def _sharded(pkg, src, dst, n, **kw):
    par = jpar if pkg == "jax" else ppar
    return par.ShardedDeviceGraph(src, dst, n, mesh=_mesh(pkg), **kw)


def _dense(pkg, src, dst, n):
    if pkg == "jax":
        g = jgraph.DeviceGraph(node_capacity=n, edge_capacity=len(src) + 1)
    else:
        g = pgraph.DeviceGraph(node_capacity=n, edge_capacity=len(src) + 1, device="cpu")
    g.add_nodes(n)
    g.add_edges(src, dst)
    return g


def union_oracle(n, src, dst, edge_epoch, node_epoch, invalid, seeds):
    """BFS with the union rule: every seed conducts, already-invalid seeds
    do not count, an edge fires only into a valid dependent whose epoch
    matches the edge's. Returns (newly count, final invalid mask)."""
    adj = [[] for _ in range(n)]
    for s, d, ep in zip(src.tolist(), dst.tolist(), edge_epoch.tolist()):
        adj[s].append((d, ep))
    inv = np.array(invalid[:n], dtype=bool)
    before = inv.copy()
    q = deque(sorted(set(int(s) for s in seeds)))
    inv[list(q)] = True
    while q:
        u = q.popleft()
        for d, ep in adj[u]:
            if not inv[d] and node_epoch[d] == ep:
                inv[d] = True
                q.append(d)
    return int((inv & ~before).sum()), inv


def _state(seed, n):
    """A random DAG captured at epoch 0, ~10% of nodes bumped since (their
    in-edges are stale) and ~4% already invalid."""
    rng = np.random.default_rng(seed)
    arr = np.asarray(random_dag(rng, n, avg_deg=3.0), dtype=np.int32)
    src, dst = arr[:, 0], arr[:, 1]
    node_epoch = np.zeros(n, np.int32)
    node_epoch[rng.choice(n, n // 10, replace=False)] = 1
    invalid = np.zeros(n, bool)
    invalid[rng.choice(n, n // 25, replace=False)] = True
    return rng, src, dst, np.zeros(len(src), np.int32), node_epoch, invalid


# ------------------------------------------------------------------ waves
@pytest.mark.parametrize(
    "seed,n,jax_exchanges",
    [(0, 500, ("packed",)), (7, 500, ("packed",)), (1, 613, ("packed", "bool")),
     (13, 613, ("packed", "bool")), (5, 500, ("ring", "bool"))],
    ids=["oracle-0", "oracle-7", "packed-613-1", "packed-613-13", "ring-500-5"],
)
def test_sharded_wave_matches_oracle_and_jax(seed, n, jax_exchanges):
    """Three waves from the resident state (stale edges, pre-invalid rows,
    seeds that may be invalid already): every port exchange and the JAX
    exchanges agree with the oracle. n=613 is not a multiple of 32*n_dev."""
    rng, src, dst, eep, nep, inv = _state(seed, n)
    kw = dict(edge_dst_epoch=eep, node_epoch=nep, invalid=inv)
    graphs = {("port", ex): _sharded("port", src, dst, n, exchange=ex, **kw)
              for ex in ppar.sharded_wave.EXCHANGES}
    graphs.update({("jax", ex): _sharded("jax", src, dst, n, exchange=ex, **kw)
                   for ex in jax_exchanges})
    state = inv.copy()
    for _ in range(3):
        seeds = rng.choice(n, size=6, replace=False).tolist()
        want_count, state = union_oracle(n, src, dst, eep, nep, state, seeds)
        for key, g in graphs.items():
            assert g.run_wave(seeds) == want_count, key
            np.testing.assert_array_equal(g.invalid_mask(), state, err_msg=str(key))


@functools.lru_cache(maxsize=None)
def _jax_waves_on(n_dev, seed=21, n=613):
    """Three waves of the JAX sharded wave on an ``n_dev``-device mesh:
    (graph state, seed lists, [(count, mask)] per wave)."""
    rng, src, dst, eep, nep, inv = _state(seed, n)
    seeds = [rng.choice(n, size=5, replace=False).tolist() for _ in range(3)]
    g = jpar.ShardedDeviceGraph(src, dst, n, mesh=jpar.graph_mesh(n_dev), edge_dst_epoch=eep,
                                node_epoch=nep, invalid=inv)
    out = [(g.run_wave(s), g.invalid_mask()) for s in seeds]
    return (src, dst, eep, nep, inv), seeds, out


@pytest.mark.parametrize("exchange", ["packed", "ring", "bool"])
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_one_launch_level_matches_jax_sharded_wave(n_dev, exchange):
    """The port's level, one wave_expand_shards call for all shards (its
    plain version on the CPU), against the JAX sharded wave on a mesh of
    the same size, for every exchange: counts and masks after each wave,
    and one launch-form call per level."""
    (src, dst, eep, nep, inv), seeds, want = _jax_waves_on(n_dev)
    g = ppar.ShardedDeviceGraph(src, dst, len(nep), mesh=ppar.graph_mesh(n_dev, device="cpu"),
                                edge_dst_epoch=eep, node_epoch=nep, invalid=inv,
                                exchange=exchange)
    for s, (count, mask) in zip(seeds, want):
        assert g.run_wave(s) == count
        np.testing.assert_array_equal(g.invalid_mask(), mask)


def test_wave_expand_shards_plain_is_per_shard_merged_levels():
    """wave_expand_shards on a shared 1-D frontier and on 2-D rows equals a
    wave_expand_merge_plain per shard; rows are ``width`` words, a multiple
    of 4, with the padding words zero."""
    import torch

    n_dev = 3
    rng, src, dst, eep, nep, inv = _state(4, 300)
    mesh = ppar.graph_mesh(n_dev, device="cpu")
    frontier = torch.from_numpy(rng.random(n_dev * 32 * 4) < 0.2)
    words = pack_bits(frontier)
    for shared in (True, False):
        g = ppar.ShardedDeviceGraph(src, dst, 300, mesh=mesh, edge_dst_epoch=eep,
                                    node_epoch=nep, invalid=inv)
        ref = [x.clone() for x in g.g.invalid]
        table = tw.ShardTable(*g.g)
        assert table.width % 4 == 0 and table.width >= table.words
        fw = words if shared else torch.stack([words] * n_dev)
        got, count = tw.wave_expand_shards(fw, table, g.n_global)
        want = 0
        for d in range(n_dev):
            nx, lit = tw.wave_expand_merge_plain(words, ref[d], g.g.node_epoch[d], g.g.edge_src[d],
                                                 g.g.edge_dst_local[d], g.g.edge_dst_epoch[d])
            assert torch.equal(got[d, :table.words], nx)
            assert not got[d, table.words:].any()
            assert torch.equal(g.g.invalid[d], ref[d])
            want += int(lit)
        assert int(count) == want and want > 0
    with pytest.raises(ValueError, match="cover"):
        tw.wave_expand_shards(words[:1], table, g.n_global)
    with pytest.raises(ValueError, match="one row per shard"):
        tw.wave_expand_shards(torch.stack([words] * 2), table, g.n_global)


@pytest.mark.parametrize("pkg", PKGS)
def test_union_rule_invalid_seed_still_fires(pkg):
    """An already-invalid seed conducts but does not count (the dense
    run_wave gates it instead)."""
    src, dst = np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    invalid = np.array([True, False, False])
    g = _sharded(pkg, src, dst, 3, invalid=invalid)
    assert g.run_wave([0]) == 2
    assert g.invalid_mask().tolist() == [True, True, True]
    dense = _dense(pkg, src, dst, 3)
    dense.mark_invalid(np.array([0], np.int32))
    assert dense.run_wave([0]) == 0


def test_sharded_matches_single_device():
    rng = np.random.default_rng(42)
    n = 400
    arr = np.asarray(random_dag(rng, n, avg_deg=4.0), dtype=np.int32)
    src, dst = arr[:, 0], arr[:, 1]
    graphs = {(pkg, kind): (_sharded if kind == "sharded" else _dense)(pkg, src, dst, n)
              for pkg in PKGS for kind in ("single", "sharded")}
    for wave_seed in (3, 11, 200):
        seeds = rng.choice(n, size=wave_seed % 13 + 1, replace=False).tolist()
        counts = {k: g.run_wave(seeds) for k, g in graphs.items()}
        assert len(set(counts.values())) == 1, counts
        want = graphs[("jax", "single")].invalid_mask()
        for k, g in graphs.items():
            np.testing.assert_array_equal(g.invalid_mask(), want, err_msg=str(k))


@pytest.mark.parametrize("pkg", PKGS)
def test_sharded_wave_idempotent(pkg):
    edges = np.array([[0, 1], [1, 2], [2, 3]], dtype=np.int32)
    sg = _sharded(pkg, edges[:, 0], edges[:, 1], 4)
    assert sg.run_wave([0]) == 4
    assert sg.run_wave([0]) == 0
    sg.clear_invalid()
    assert sg.run_wave([2]) == 2  # 2 and 3 only


def test_chained_waves_match_per_wave_runs():
    """run_waves_chained == W separate run_wave calls with resets, on both
    packages, with the same counts."""
    n = 512
    src, dst = power_law_dag(n, avg_degree=3.0, seed=3)
    rng = np.random.default_rng(5)
    seed_mat = np.zeros((4, n), dtype=bool)
    for i in range(4):
        seed_mat[i, rng.choice(n, size=16, replace=False)] = True
    results = {}
    for pkg in PKGS:
        a = _sharded(pkg, src, dst, n)
        per_wave = []
        for i in range(4):
            a.clear_invalid()
            per_wave.append(a.run_wave(np.flatnonzero(seed_mat[i]).tolist()))
        b = _sharded(pkg, src, dst, n)
        total, counts = b.run_waves_chained(seed_mat)
        assert counts.tolist() == per_wave and total == sum(per_wave)
        np.testing.assert_array_equal(b.invalid_mask(), a.invalid_mask())
        results[pkg] = (per_wave, b.invalid_mask())
    assert results["port"][0] == results["jax"][0]
    np.testing.assert_array_equal(results["port"][1], results["jax"][1])


def test_port_chain_without_reset_accumulates():
    """reset_between=False chains each wave over the previous one's state,
    like run_wave calls in a row; a prepared seed matrix gives the same."""
    n = 512
    src, dst = power_law_dag(n, avg_degree=3.0, seed=4)
    rng = np.random.default_rng(6)
    seed_mat = np.zeros((3, n), dtype=bool)
    for i in range(3):
        seed_mat[i, rng.choice(n, size=8, replace=False)] = True
    a = _sharded("port", src, dst, n)
    per_wave = [a.run_wave(np.flatnonzero(row).tolist()) for row in seed_mat]
    b = _sharded("port", src, dst, n, exchange="ring")
    total, counts = b.run_waves_chained(b.prepare_seed_mat(seed_mat), reset_between=False)
    assert counts.tolist() == per_wave and total == sum(per_wave)
    np.testing.assert_array_equal(b.invalid_mask(), a.invalid_mask())


# ------------------------------------------------------------------ O(wave) collect
def test_sharded_collect_matches_wave_and_mask_diff():
    """run_wave_collect returns exactly the newly-invalidated ids of the
    equivalent run_wave, with the invalid state RESIDENT between calls,
    and the same ids on both packages."""
    rng = np.random.default_rng(11)
    n = 500
    edges = []
    for d in range(1, n):
        for s in rng.choice(d, size=min(int(rng.integers(0, 4)), d), replace=False):
            edges.append((int(s), d))
    arr = np.asarray(edges, dtype=np.int32)
    seeds = [rng.choice(n, size=6, replace=False).tolist() for _ in range(2)]
    got = {}
    for pkg in PKGS:
        a = _sharded(pkg, arr[:, 0], arr[:, 1], n, exchange="ring" if pkg == "port" else "packed")
        b = _sharded(pkg, arr[:, 0], arr[:, 1], n)
        got[pkg] = []
        for wave_seeds in seeds:
            before = b.invalid_mask().copy()
            count, ids, over = a.run_wave_collect(wave_seeds)
            b.run_wave(wave_seeds)
            np.testing.assert_array_equal(a.invalid_mask(), b.invalid_mask())
            want = np.nonzero(b.invalid_mask() & ~before)[0]
            np.testing.assert_array_equal(ids, want)  # ascending global order
            assert count == len(want) and not over
            got[pkg].append(ids.tolist())
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("cap", [16, 200])
def test_sharded_collect_overflow_flag(cap):
    """count > cap sets overflow and returns the full cap buffer; padding
    seeds (>= n_global) are dropped and padding rows never come back."""
    n = 200
    src = np.arange(n - 1, dtype=np.int32)  # a chain: one seed reaches all
    dst = np.arange(1, n, dtype=np.int32)
    got = {}
    for pkg in PKGS:
        g = _sharded(pkg, src, dst, n)
        count, ids, overflow = g.run_wave_collect([0, g.n_global], cap=cap)
        assert count == n and overflow == (n > cap)
        assert g.invalid_mask().all()
        got[pkg] = (count, ids.tolist(), overflow)
    assert got["port"] == got["jax"]
    assert got["port"][1] == list(range(min(cap, n)))


def test_from_numpy_state_next_wave_matches_jax():
    """A JAX graph's state after a wave, carried across as numpy, gives the
    port graph the same mask and the same next wave."""
    rng, src, dst, eep, nep, inv = _state(21, 700)
    jg = _sharded("jax", src, dst, 700, edge_dst_epoch=eep, node_epoch=nep, invalid=inv)
    jg.run_wave(rng.choice(700, size=5, replace=False).tolist())
    pg = ppar.ShardedDeviceGraph.from_numpy_state(
        jg.g._asdict(), _mesh("port"), n_nodes=jg.n_nodes, exchange="ring")
    assert (pg.n_local, pg.n_global, pg.e_shard) == (jg.n_local, jg.n_global, jg.e_shard)
    np.testing.assert_array_equal(pg.invalid_mask(), jg.invalid_mask())
    seeds = rng.choice(700, size=5, replace=False).tolist()
    assert pg.run_wave(seeds) == jg.run_wave(seeds)
    np.testing.assert_array_equal(pg.invalid_mask(), jg.invalid_mask())


# ------------------------------------------------------------------ the live bridge
def test_version_counters_match_jax():
    """The state the bridge reads: ``_struct_version`` and
    ``invalid_version`` move exactly as the JAX package's do, and a no-op
    wave moves neither."""
    import jax.numpy as jnp
    import torch

    src, dst = power_law_dag(300, avg_degree=3.0, seed=9)

    def frontier(g, pkg):
        f = np.zeros(g.n_cap + 1, bool)
        f[4] = True
        return jnp.asarray(f) if pkg == "jax" else torch.from_numpy(f)

    steps = [
        lambda g, pkg: g.add_nodes(300),
        lambda g, pkg: g.add_edges(src, dst),
        lambda g, pkg: g.run_wave([0]),
        lambda g, pkg: g.run_waves_union([[0]]),  # no-op: everything lit is invalid
        lambda g, pkg: g.clear_invalid(),
        lambda g, pkg: g.run_waves_union([[5], [7]]),
        lambda g, pkg: g.run_wave_collect([299]),
        lambda g, pkg: g.run_wave_collect([299]),  # no-op
        lambda g, pkg: g.run_waves_chained([[1], [2]]),
        lambda g, pkg: g.mark_invalid(np.array([3], np.int32)),
        lambda g, pkg: g.clear_invalid_ids(np.array([3], np.int32)),
        lambda g, pkg: g.bump_epochs(np.array([10, 11], np.int32)),
        lambda g, pkg: g.compact(),
        lambda g, pkg: g.run_wave_frontier(frontier(g, pkg)),
    ]
    versions = {}
    for pkg in PKGS:
        g = (jgraph.DeviceGraph(512, 2048) if pkg == "jax"
             else pgraph.DeviceGraph(512, 2048, device="cpu"))
        versions[pkg] = []
        for step in steps:
            step(g, pkg)
            versions[pkg].append((g._struct_version, g.invalid_version))
    assert versions["port"] == versions["jax"]
    assert versions["port"][3] == versions["port"][2]  # the no-op union
    assert versions["port"][7] == versions["port"][6]  # the no-op collect


def _chain_service(core, k=None):
    class Chain(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.data = {i: i for i in range(k or 0)}

        @core.compute_method
        async def base(self, i: int) -> int:
            return self.data.get(i, i)

        @core.compute_method
        async def mid(self, i: int) -> int:
            if k:
                return await self.base(i) + await self.base((i + 1) % k)
            return await self.base(i) + 1

        @core.compute_method
        async def top(self, i: int) -> int:
            return await self.mid(i) + 1

    return Chain


def _world(pkg):
    core, graph = (jcore, jgraph) if pkg == "jax" else (pcore, pgraph)
    hub = core.FusionHub()
    old = core.set_default_hub(hub)
    backend = graph.TpuGraphBackend(hub, **({} if pkg == "jax" else {"device": "cpu"}))
    return core, hub, old, backend


@pytest.mark.parametrize("pkg", PKGS)
async def test_sharded_bridge_resident_state_skips_full_sync(pkg):
    """Consecutive mesh bursts pay no full invalid-state sync: set_invalid
    fires only on the first burst and after a host-led change; a no-op
    dense wave does not force one."""
    core, hub, old, backend = _world(pkg)
    mesh = _mesh(pkg)
    try:
        svc = _chain_service(core)(hub)
        tops = [await core.capture(lambda i=i: svc.top(i)) for i in range(6)]
        bases = [await core.capture(lambda i=i: svc.base(i)) for i in range(6)]

        sharded = backend.sharded_mirror(mesh)
        assert backend.sharded_mirror(mesh) is sharded  # fingerprint-cached
        sync_calls = []
        orig_set_invalid = sharded.set_invalid
        sharded.set_invalid = lambda mask: (sync_calls.append(1), orig_set_invalid(mask))[1]

        def burst(i):
            return backend.invalidate_cascade_batch_sharded([bases[i]], mesh)

        assert [burst(0), burst(1), burst(2)] == [3, 3, 3]
        assert len(sync_calls) == 1  # only the FIRST burst synced
        assert bases[0].is_invalidated or backend._pending[backend.id_for(bases[0])]
        assert tops[1].is_invalidated or backend._pending[backend.id_for(tops[1])]
        assert burst(0) == 0 and len(sync_calls) == 1  # idempotent, resident
        # a NO-OP dense wave must not force a re-sync
        assert backend.invalidate_cascade_batch([bases[0]]) == 0
        assert burst(5) == 3 and len(sync_calls) == 1
        # a HOST-led invalid-state change → exactly one full re-sync
        backend.graph.mark_invalid(np.asarray([backend.id_for(bases[3])], dtype=np.int32))
        assert burst(4) == 3 and len(sync_calls) == 2
        # the marked seed doesn't count but still fires its dependents
        assert burst(3) == 2 and burst(3) == 0 and len(sync_calls) == 2
    finally:
        core.set_default_hub(old)


async def _chaos(pkg, chaos_seed):
    """Random live mutations, mirror rebuilds, dense and mesh bursts, and a
    failure injected between the mesh wave and the host apply; every burst
    is held against the union oracle. Returns the per-burst counts."""
    core, hub, old, backend = _world(pkg)
    mesh = _mesh(pkg)
    rng = np.random.default_rng(chaos_seed)
    k = 24
    got_counts = []
    try:
        svc = _chain_service(core, k)(hub)
        for i in range(k):
            await svc.top(i)

        def oracle_burst(seed_nids):
            dg = backend.graph
            n, m = dg.n_nodes, dg.n_edges
            return union_oracle(n, dg._h_edge_src[:m], dg._h_edge_dst[:m],
                                dg._h_edge_dst_epoch[:m], dg._h_node_epoch[:n],
                                dg._h_invalid[:n], seed_nids)

        async def live_computed(kind, i):
            fn = {"base": svc.base, "mid": svc.mid, "top": svc.top}[kind]
            return await core.capture(lambda: fn(i))

        def check(got, want, step):
            want_count, want_mask = want
            assert got == want_count, (pkg, step, got, want_count)
            dg = backend.graph
            np.testing.assert_array_equal(dg._h_invalid[: dg.n_nodes], want_mask)
            np.testing.assert_array_equal(dg.invalid_mask(), want_mask)
            got_counts.append(got)

        injected = 0
        for step in range(70):
            action = rng.choice(["burst", "read", "write", "mark", "mirror", "fail"])
            i = int(rng.integers(0, k))
            if action == "read":
                await svc.top(i)  # recomputes anything invalid → epoch bumps
            elif action == "write":
                svc.data[i] += 1
                with core.invalidating():
                    await svc.base(i)
            elif action == "mark":
                c = await live_computed(str(rng.choice(["base", "mid"])), i)
                c.invalidate()
            elif action == "mirror":
                backend.sharded_mirror(mesh)
            elif action == "fail":
                c = await live_computed("base", i)
                sharded = backend.sharded_mirror(mesh)
                orig = sharded.run_wave_collect

                def boom(*a, _orig=orig, _g=sharded, **kw):
                    _g.run_wave_collect = _orig
                    _orig(*a, **kw)  # the mesh wave RUNS...
                    raise ConnectionError("injected between wave and apply")

                sharded.run_wave_collect = boom
                with pytest.raises(ConnectionError):
                    backend.invalidate_cascade_batch_sharded([c], mesh)
                injected += 1
                # the retry of the SAME seed re-syncs and cascades exactly
                backend.flush()
                want = oracle_burst([backend.id_for(c)])
                check(backend.invalidate_cascade_batch_sharded([c], mesh), want, step)
            else:
                kinds = rng.choice(["base", "mid", "top"], size=int(rng.integers(1, 4)))
                cs = [await live_computed(str(kd), int(rng.integers(0, k))) for kd in kinds]
                backend.flush()
                want = oracle_burst([backend.id_for(c) for c in cs])
                if rng.random() < 0.5:
                    got = backend.invalidate_cascade_batch_sharded(cs, mesh)
                else:
                    got = backend.invalidate_cascade_batch(cs)
                check(got, want, step)
        assert injected > 0, "chaos run never exercised the failure injection"
        return got_counts
    finally:
        core.set_default_hub(old)


async def test_sharded_bridge_chaos_interleaving():
    jax_counts = await _chaos("jax", 1234)
    port_counts = await _chaos("port", 1234)
    assert port_counts == jax_counts and len(port_counts) > 5


# ------------------------------------------------------------------ port-only contracts
def test_graph_mesh_and_its_limits():
    assert ppar.graph_mesh(N_DEV, device="cpu").size == N_DEV
    assert ppar.graph_mesh(devices=["cpu"] * 3).size == 3
    assert ppar.graph_mesh(2, devices=["cpu"] * 3).size == 2
    assert ppar.GRAPH_AXIS == jpar.GRAPH_AXIS == "graph"
    import torch

    with pytest.raises(NotImplementedError, match="A.10"):
        ppar.Mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(ValueError, match="unknown exchange"):
        ppar.build_sharded_wave(_mesh("port"), 256, exchange="a2a")
    with pytest.raises(ValueError, match="n_local % 32"):
        ppar.build_sharded_wave(_mesh("port"), 8 * 40, exchange="ring")


def test_wave_expand_takes_a_global_frontier_and_local_words():
    """A shard's level: global source ids read a frontier wider than the
    shard's own invalid words; a frontier too short for max(edge_src)+1
    bits is refused, with or without the caller's bound."""
    import torch

    t = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    frontier = torch.zeros(4, dtype=torch.int32)
    frontier[3] = 1 << 2  # global node 98
    invalid, node_epoch = torch.zeros(2, dtype=torch.int32), torch.zeros(33, dtype=torch.int32)
    node_epoch[32] = -2
    src, dst, ep = t(98, 98, 0), t(5, 32, 32), t(0, 0, -1)  # a real edge, dummy, padding
    before = tw.launches
    nxt = tw.wave_expand(frontier, invalid, node_epoch, src, dst, ep, n_src=128)
    assert nxt.tolist() == [1 << 5, 0] and tw.launches == before
    with pytest.raises(ValueError, match="max\\(edge_src\\)"):
        tw.wave_expand(frontier[:3], invalid, node_epoch, src, dst, ep)
    with pytest.raises(ValueError, match="max\\(edge_src\\)"):
        tw.wave_expand(frontier, invalid, node_epoch, src, dst, ep, n_src=129)
    with pytest.raises(ValueError, match="n_cap\\+1"):
        tw.wave_expand(frontier, invalid[:1], node_epoch, src, dst, ep)


def test_backend_mesh_slices_still_raise():
    backend = pgraph.TpuGraphBackend(pcore.FusionHub(), device="cpu")
    # the row-block mesh cascade is ported (A.3): a bound row seeds a mesh wave
    from stl_fusion_tpu_torch.ops.memo_table import MemoTable

    block = backend.bind_table_rows(
        MemoTable(4, lambda ids: np.asarray(ids, np.float32), device="cpu"))
    assert backend.cascade_rows_batch_sharded(block, [0]) == 1
    # the row-block mesh lane burst is ported too (A.9's first part): row 0
    # is already invalid, so its lane is blocked and counts nothing
    assert backend.cascade_rows_lanes_sharded(block, [[0], [1]]).tolist() == [0, 1]
    # the routed mesh is ported too (A.9's second part): a bound row seeds a
    # routed wave on the default mesh, one shard on the backend's device
    from stl_fusion_tpu_torch.cluster import ShardMap

    backend.enable_mesh_routing(ShardMap.initial(["m0"], n_shards=8))
    assert backend.cascade_rows_batch_routed(block, [1]) == 0  # row 1 is already invalid
    assert backend.routed_mirror()["graph"].mesh.size == 1
    # the default sharded mirror is one shard on the backend's device
    assert backend.sharded_mirror().mesh.size == 1
