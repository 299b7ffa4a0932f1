"""Parity of the port's packed mesh wave (``stl_fusion_tpu_torch/parallel/
packed_wave.py``: ``PackedShardedGraph``, ``build_packed_sharded_wave``, the
gated lane burst), the backend's packed mesh mirror
(``packed_mirror``, ``invalidate_cascade_batch_lanes_sharded``,
``cascade_rows_lanes_sharded``), the ``packed_pull`` level's plain version
and the mesh and pull legs of the ``bench.py`` twin, with the JAX package's.
The JAX side runs on the conftest's 8 virtual CPU devices, the port on
``graph_mesh(8, device="cpu")`` unless a case says otherwise; the same numpy
graphs and seeds go to both (and to the per-wave BFS oracle of
``tests/test_device_graph.py``). Tolerance: exact — masks and words
bit-identical; counts, ids, flags and tables equal. Each case named after
one in ``tests/test_sharded_wave.py`` or ``tests/test_routed_wave.py`` is its
port counterpart, run on both packages."""
import torch_threads  # noqa: F401 — one torch thread a test process
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu.parallel as jpar
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.graph as pgraph
import stl_fusion_tpu_torch.parallel as ppar
from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu_torch import bench as pbench
from stl_fusion_tpu_torch.ops import packed_pull as ppp
from stl_fusion_tpu_torch.ops.bitops import pack_bits, unpack_bits

from test_device_graph import python_wave_oracle, random_dag

PKGS = {"jax": (jcore, jgraph, jpar), "port": (pcore, pgraph, ppar)}


def _mesh(pkg):
    return jpar.graph_mesh() if pkg == "jax" else ppar.graph_mesh(8, device="cpu")


def _packed(pkg, src, dst, n, **kw):
    return PKGS[pkg][2].PackedShardedGraph(src, dst, n, mesh=_mesh(pkg), **kw)


def _backend(pkg, hub, **kw):
    return PKGS[pkg][1].TpuGraphBackend(hub, **kw, **({"device": "cpu"} if pkg == "port" else {}))


def _words(pg):
    """The invalid words of either package's graph as numpy."""
    inv = pg.invalid
    return inv.numpy() if isinstance(inv, torch.Tensor) else np.asarray(inv)


def _oracle(n, src, dst, seeds):
    return python_wave_oracle(n, list(zip(src.tolist(), dst.tolist())), [0] * len(src),
                              np.zeros(n, np.int32), np.zeros(n, bool), seeds)


# ------------------------------------------------------------------ the wave
@pytest.mark.parametrize("seed", [0, 9])
def test_packed_sharded_wave_matches_jax_and_oracle(seed):
    """32 packed waves in one mesh pass: every lane's closure equals the
    oracle on both packages, the totals and the words are equal."""
    rng = np.random.default_rng(seed)
    n = 400
    arr = np.asarray(random_dag(rng, n, avg_deg=3.0), dtype=np.int32)
    src, dst = arr[:, 0], arr[:, 1]
    seed_lists = [rng.choice(n, size=5, replace=False).tolist() for _ in range(32)]
    graphs = {pkg: _packed(pkg, src, dst, n) for pkg in PKGS}
    totals = {pkg: g.run_waves(seed_lists) for pkg, g in graphs.items()}
    assert totals["port"] == totals["jax"]
    np.testing.assert_array_equal(_words(graphs["port"]), _words(graphs["jax"]))
    expected_total = 0
    for w, seeds in enumerate(seed_lists):
        want = _oracle(n, src, dst, seeds)
        for pkg, g in graphs.items():
            np.testing.assert_array_equal(g.invalid_mask(wave=w), want, err_msg=f"{pkg} {w}")
        expected_total += int(want.sum())
    assert totals["port"] == expected_total
    assert graphs["port"].last_stats["levels"] >= 1


def test_packed_sharded_wave_idempotent_and_incremental():
    src = np.array([0, 0, 1], dtype=np.int32)
    dst = np.array([1, 2, 3], dtype=np.int32)
    for pkg in PKGS:
        pg = _packed(pkg, src, dst, 4)
        assert pg.run_waves([[0]]) == 4, pkg
        # the second run lights nothing new, so it reports 0
        assert pg.run_waves([[0]]) == 0, pkg
        assert pg.invalid_mask().sum() == 4  # the cumulative mask is unchanged
        pg.clear_invalid()
        assert pg.run_waves([[1]]) == 2  # 1 and 3 only
        assert not pg.invalid_mask()[0] and not pg.invalid_mask()[2]


def test_packed_sharded_multiword_and_chained():
    """words=2 packs 64 waves per pass; chained batches equal separate runs,
    on both packages."""
    rng = np.random.default_rng(21)
    n = 300
    arr = np.asarray(random_dag(rng, n, avg_deg=3.0), dtype=np.int32)
    src, dst = arr[:, 0], arr[:, 1]
    seed_lists = [rng.choice(n, size=4, replace=False).tolist() for _ in range(64)]
    batch2_lists = [rng.choice(n, size=4, replace=False).tolist() for _ in range(64)]
    out = {}
    for pkg in PKGS:
        pg = _packed(pkg, src, dst, n, words=2)
        total = pg.run_waves(seed_lists)
        expected = 0
        for i, seeds in enumerate(seed_lists):
            want = _oracle(n, src, dst, seeds)
            np.testing.assert_array_equal(pg.invalid_mask(wave=i), want, err_msg=f"{pkg} {i}")
            expected += int(want.sum())
        assert total == expected
        pg2 = _packed(pkg, src, dst, n, words=2)
        stacked = np.stack([np.asarray(pg2.seeds_to_bits(seed_lists)),
                            np.asarray(pg2.seeds_to_bits(batch2_lists))])
        chained_total, per_batch = pg2.run_wave_batches(stacked)
        pg3 = _packed(pkg, src, dst, n, words=2)
        sep = [pg3.run_waves(seed_lists)]
        pg3.clear_invalid()
        sep.append(pg3.run_waves(batch2_lists))
        assert per_batch.tolist() == sep and chained_total == sum(sep)
        out[pkg] = (total, chained_total, per_batch.tolist(), _words(pg2))
    assert out["port"][:3] == out["jax"][:3]
    np.testing.assert_array_equal(out["port"][3], out["jax"][3])


@pytest.mark.parametrize("words", [1, 3, 16])
def test_packed_pull_level_and_wave_match_jax(words):
    """One level of ``packed_pull_level_plain`` against the JAX level body
    (``packed_wave.py:97-104``, written out in jnp), and a whole wave of the
    port's ``build_packed_sharded_wave`` against the JAX package's, at k =
    10 with dead slots, pad rows and the sign-bit lane set."""
    rng = np.random.default_rng(words)
    n, k = 640, 10
    in_src = rng.integers(0, n, size=(n, k)).astype(np.int32)
    in_src[n - 40:] = n - 41  # pad rows point at the null row, as the mirror's do
    node_epoch = rng.integers(0, 3, size=n).astype(np.int32)
    node_epoch[n - 41:] = -2
    edge_epoch = np.where(rng.random((n, k)) < 0.5, node_epoch[:, None],
                          node_epoch[:, None] + 1).astype(np.int32)
    edge_epoch[rng.random((n, k)) < 0.2] = -1  # pad slots
    is_real = np.zeros(n, bool)
    is_real[: n - 100] = True
    frontier = rng.integers(-(2**31), 2**31, size=(n, words), dtype=np.int64).astype(np.int32)
    frontier[rng.random(n) < 0.7] = 0
    frontier[:, 0] |= np.int32(-(2**31))  # lane 31
    invalid = rng.integers(-(2**31), 2**31, size=(n, words), dtype=np.int64).astype(np.int32)
    invalid[rng.random(n) < 0.5] = 0

    # the JAX level body, line for line
    live = jnp.asarray(edge_epoch) == jnp.asarray(node_epoch)[:, None]
    f = jnp.asarray(frontier)[jnp.asarray(in_src)]
    contrib = jnp.where(live[:, :, None], f, 0)
    fire = contrib[:, 0]
    for j in range(1, k):
        fire = fire | contrib[:, j]
    fire = fire & ~jnp.asarray(invalid)
    want_inv = np.asarray(jnp.asarray(invalid) | fire)

    inv_t = torch.from_numpy(invalid.copy())
    got = ppp.packed_pull_level_plain(torch.from_numpy(in_src), torch.from_numpy(edge_epoch),
                                      torch.from_numpy(node_epoch), torch.from_numpy(frontier),
                                      inv_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(fire))
    np.testing.assert_array_equal(inv_t.numpy(), want_inv)

    # the whole wave, seeded with `frontier` over `invalid`
    jwave = jpar.build_packed_sharded_wave(jpar.graph_mesh())
    jinv, jcounts = jwave(jnp.asarray(frontier), jnp.asarray(in_src), jnp.asarray(edge_epoch),
                          jnp.asarray(node_epoch), jnp.asarray(is_real), jnp.asarray(invalid))
    pwave = ppar.build_packed_sharded_wave(ppar.graph_mesh(8, device="cpu"))
    stats = {}
    pinv, pcounts = pwave(torch.from_numpy(frontier), torch.from_numpy(in_src),
                          torch.from_numpy(edge_epoch), torch.from_numpy(node_epoch),
                          torch.from_numpy(is_real), torch.from_numpy(invalid.copy()), stats)
    np.testing.assert_array_equal(pinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    assert stats["levels"] >= 2


def _words_np(rng, shape):
    return rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)


def _garbage_scratch(monkeypatch, seed):
    """``run_pull_wave``'s frontier buffers and summaries come filled with
    random words: a wave can only be right if it reads no row of them that
    it has not written (a frontier row under a clear bit)."""
    rng = np.random.default_rng(seed)
    fresh = ppp._wave_buffers

    def buffers(invalid):
        out = fresh(invalid)
        for t in out:
            t.copy_(torch.from_numpy(_words_np(rng, tuple(t.shape))))
        return out
    monkeypatch.setattr(ppp, "_wave_buffers", buffers)


@pytest.mark.parametrize("words", [1, 3, 16])
def test_packed_pull_summary_level_and_wave_match_jax(words, monkeypatch):
    """The fired summary. One level of ``packed_pull`` on the CPU given the
    previous level's summary, with garbage in every frontier row whose bit
    is clear, against the JAX level body (``packed_wave.py:97-104``, written
    out in jnp) on the frontier with those rows zero: invalid, counts, the
    flag, the new summary (the rows that fire) and next on those rows, the
    other rows of next untouched; then a whole wave of the port's
    ``build_packed_sharded_wave`` with its scratch filled with garbage
    against the JAX package's, at k = 10 with dead slots and pad rows."""
    rng = np.random.default_rng(50 + words)
    n, k = 640, 10
    in_src = rng.integers(0, n, size=(n, k)).astype(np.int32)
    in_src[n - 40:] = n - 41
    node_epoch = rng.integers(0, 3, size=n).astype(np.int32)
    node_epoch[n - 41:] = -2
    edge_epoch = np.where(rng.random((n, k)) < 0.5, node_epoch[:, None],
                          node_epoch[:, None] + 1).astype(np.int32)
    edge_epoch[rng.random((n, k)) < 0.2] = -1
    is_real = rng.random(n) < 0.85
    lit = rng.random(n) < 0.3
    frontier = np.where(lit[:, None], _words_np(rng, (n, words)), 0).astype(np.int32)
    frontier[:, 0] |= np.where(lit, np.int32(-(2**31)), 0).astype(np.int32)  # lane 31
    garbage = np.where(lit[:, None], frontier, _words_np(rng, (n, words))).astype(np.int32)
    invalid = _words_np(rng, (n, words))
    invalid[rng.random(n) < 0.5] = 0

    live = jnp.asarray(edge_epoch) == jnp.asarray(node_epoch)[:, None]
    contrib = jnp.where(live[:, :, None], jnp.asarray(frontier)[jnp.asarray(in_src)], 0)
    fire = contrib[:, 0]
    for j in range(1, k):
        fire = fire | contrib[:, j]
    fire = np.asarray(fire & ~jnp.asarray(invalid))
    fired = (fire != 0).any(axis=1)

    t = torch.from_numpy
    inv, nxt = t(invalid.copy()), torch.full((n, words), 7, dtype=torch.int32)
    counts = torch.zeros(words, dtype=torch.int32)
    flags = torch.tensor([1, 0], dtype=torch.int32)
    summary_out = torch.full((-(-n // 32),), 12345, dtype=torch.int32)
    ppp.packed_pull(t(in_src), t(edge_epoch), t(node_epoch), t(is_real), t(garbage), nxt, inv,
                    counts, flag_in=flags[:1], flag_out=flags[1:],
                    summary_in=pack_bits(t(lit)), summary_out=summary_out)
    np.testing.assert_array_equal(inv.numpy(), invalid | fire)
    popc = np.vectorize(lambda x: bin(int(x) & 0xFFFFFFFF).count("1"))
    np.testing.assert_array_equal(counts.numpy(), popc(fire[is_real]).sum(axis=0))
    assert int(flags[1]) == int(fired.any()) == 1
    np.testing.assert_array_equal(unpack_bits(summary_out, n).numpy(), fired)
    np.testing.assert_array_equal(nxt.numpy()[fired], fire[fired])
    assert (nxt.numpy()[~fired] == 7).all()

    jwave = jpar.build_packed_sharded_wave(jpar.graph_mesh())
    jinv, jcounts = jwave(jnp.asarray(frontier), jnp.asarray(in_src), jnp.asarray(edge_epoch),
                          jnp.asarray(node_epoch), jnp.asarray(is_real), jnp.asarray(invalid))
    _garbage_scratch(monkeypatch, words)
    pwave = ppar.build_packed_sharded_wave(ppar.graph_mesh(8, device="cpu"))
    stats = {}
    pinv, pcounts = pwave(t(frontier), t(in_src), t(edge_epoch), t(node_epoch), t(is_real),
                          t(invalid.copy()), stats)
    np.testing.assert_array_equal(pinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    assert stats["levels"] >= 2


def test_packed_patch_batch_equals_sequential():
    """``patch_batch`` (one batch) ≡ the sequential ``patch_bumps`` /
    ``patch_adds``, on both packages, and the port's tables equal JAX's."""
    n = 2000
    src, dst = power_law_dag(n, avg_degree=3.0, seed=11)
    rng = np.random.default_rng(4)
    bumps1 = rng.choice(n, size=8, replace=False)
    bumps2 = rng.choice(n, size=8, replace=False)  # may overlap bumps1
    u = rng.integers(0, n - 1, size=12)
    v = u + 1
    ep = np.zeros(12, dtype=np.int64)
    merged = np.concatenate([np.unique(bumps1), np.unique(bumps2)])
    tables = {}
    for pkg in PKGS:
        a = _packed(pkg, src, dst, n, slack=4)
        b = _packed(pkg, src, dst, n, slack=4)
        a.patch_bumps(bumps1)
        a.patch_bumps(bumps2)
        assert a.patch_adds(u, v, ep)
        assert b.patch_batch(merged, u, v, ep)
        for name in ("node_epoch", "in_src", "edge_epoch"):
            assert np.array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)))
        assert np.array_equal(a.h_node_epoch, b.h_node_epoch)
        assert b.patches == 1 and a.patches == 3
        tables[pkg] = [np.asarray(getattr(b, name)) for name in
                       ("node_epoch", "in_src", "edge_epoch", "h_in_src", "h_edge_epoch")]
    for x, y in zip(tables["port"], tables["jax"]):
        np.testing.assert_array_equal(x, y)


def test_port_host_patch_truth_does_not_alias_the_device_tables():
    """On the CPU a tensor made from a numpy array may share its memory: the
    host patch truth must be a real copy, or a host splice would reach the
    device tables before the scatter."""
    src = np.array([0, 1], dtype=np.int32)
    dst = np.array([1, 2], dtype=np.int32)
    pg = _packed("port", src, dst, 3, slack=2)
    before = pg.in_src.clone()
    pg.h_in_src[:] = 7
    pg.h_edge_epoch[:] = 7
    assert torch.equal(pg.in_src, before) and int(pg.edge_epoch.max()) < 7


# ------------------------------------------------------------------ gated lanes
@pytest.mark.parametrize("cap", [5, 65536])
def test_run_gated_lanes_matches_jax_with_overflow(cap):
    """``run_gated_lanes`` at a cap the union overflows (and one it does
    not): the same per-group counts, overflow flag, union ids and blocked
    mask as JAX, across two chunks (``max_words=1``: 32 groups a chunk) from
    a pre-blocked state."""
    rng = np.random.default_rng(17)
    n = 500
    arr = np.asarray(random_dag(rng, n, avg_deg=3.0), dtype=np.int32)
    src, dst = arr[:, 0], arr[:, 1]
    groups = [rng.choice(n, size=3, replace=False).tolist() for _ in range(40)]
    groups[5] = []
    pre = np.zeros(n, bool)
    pre[rng.choice(n, size=40, replace=False)] = True
    res = {}
    for pkg in PKGS:
        pg = _packed(pkg, src, dst, n, slack=2)
        blocked0 = pg.put_blocked(pre)
        counts, ids, blocked2, over = pg.run_gated_lanes(groups, blocked0, cap=cap, max_words=1)
        mask = (pg.blocked_host(blocked2) if pkg == "port" else np.asarray(blocked2))
        res[pkg] = (counts, ids, mask, over)
        if pkg == "port":  # the input mask is left as it was
            np.testing.assert_array_equal(pg.blocked_host(blocked0)[:n], pre)
    (jc, jids, jmask, jover), (pc, pids, pmask, pover) = res["jax"], res["port"]
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pmask, jmask)
    assert pover == jover == (cap == 5)
    if cap == 5:
        assert pids is None and jids is None
    else:
        np.testing.assert_array_equal(pids, jids)
        np.testing.assert_array_equal(np.sort(pids), np.nonzero(pmask[:n] & ~pre)[0])


async def _chain_hub(pkg):
    core = PKGS[pkg][0]
    hub = core.FusionHub()
    old = core.set_default_hub(hub)
    backend = _backend(pkg, hub)

    class Chain(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.data = {i: i for i in range(16)}

        @core.compute_method
        async def base(self, i: int) -> int:
            return self.data[i]

        @core.compute_method
        async def mid(self, i: int) -> int:
            return await self.base(i) + await self.base((i + 1) % 16)

        @core.compute_method
        async def top(self, i: int) -> int:
            return await self.mid(i) + 1

    svc = Chain(hub)
    for i in range(16):
        await svc.top(i)
    bases = [await core.capture(lambda i=i: svc.base(i)) for i in range(16)]
    # a pre-existing invalidation the lanes must treat as blocked
    bases[3].invalidate()
    return core, old, backend, bases


async def test_mesh_lane_burst_matches_single_chip_lanes():
    """``invalidate_cascade_batch_lanes_sharded`` ≡ the single-device lane
    path: the same per-group counts and the same applied state from the same
    pre-state, on JAX's and the port's mesh, and the port's single-device
    lanes equal to both."""
    runs = {}
    for pkg, sharded in (("jax", True), ("port", True), ("port", False)):
        core, old, backend, bases = await _chain_hub(pkg)
        try:
            groups = [[bases[0]], [bases[3], bases[5]], [], [bases[0], bases[7]]]
            if sharded:
                counts = backend.invalidate_cascade_batch_lanes_sharded(groups, _mesh(pkg))
            else:
                counts = backend.invalidate_cascade_batch_lanes(groups)
            runs[(pkg, sharded)] = (counts, backend.graph._h_invalid[: backend.graph.n_nodes].copy())
        finally:
            core.set_default_hub(old)
    want_counts, want_state = runs[("jax", True)]
    for key, (counts, state) in runs.items():
        np.testing.assert_array_equal(counts, want_counts, err_msg=str(key))
        np.testing.assert_array_equal(state, want_state, err_msg=str(key))


@pytest.mark.parametrize("uploaded", [True, False])
def test_mark_invalid_words_equals_mark_invalid(uploaded):
    """The mesh burst's apply, ``DeviceGraph.mark_invalid_words``, leaves the
    same host mirror, device words and version as ``mark_invalid`` of the
    same ids, on an uploaded device copy and on one still to be built; its
    words may run past the graph's nodes (the mesh's padded rows)."""
    from stl_fusion_tpu_torch.ops.bitops import pack_bits

    rng = np.random.default_rng(11)
    src, dst = np.asarray(random_dag(rng, 100, 3), dtype=np.int32).T
    graphs = []
    for _ in range(2):
        g = pgraph.DeviceGraph(128, 512, device="cpu")
        g.add_nodes(100)
        g.add_edges(src, dst)
        g.mark_invalid(np.arange(0, 100, 7, dtype=np.int32))
        if uploaded:
            g.device_arrays()
        graphs.append(g)
    ids = np.unique(rng.integers(0, 100, 30)).astype(np.int32)
    mask = np.zeros(104, dtype=bool)
    mask[ids] = True
    by_ids, by_words = graphs
    by_ids.mark_invalid(ids)
    got = by_words.mark_invalid_words(pack_bits(torch.from_numpy(mask)))
    np.testing.assert_array_equal(got, mask[:100])
    np.testing.assert_array_equal(by_words._h_invalid, by_ids._h_invalid)
    assert by_words.invalid_version == by_ids.invalid_version
    assert torch.equal(by_words.device_arrays().invalid, by_ids.device_arrays().invalid)


async def test_mesh_lane_burst_resident_blocked_state():
    """Consecutive mesh lane bursts ride the resident blocked mask (no full
    sync), a host-led change forces exactly one re-sync, and idempotence
    holds across the resident state — on both packages."""
    for pkg in PKGS:
        core = PKGS[pkg][0]
        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            backend = _backend(pkg, hub)

            class Chain(core.ComputeService):
                @core.compute_method
                async def base(self, i: int) -> int:
                    return i

                @core.compute_method
                async def top(self, i: int) -> int:
                    return await self.base(i) + 1

            svc = Chain(hub=hub)
            tops = [await core.capture(lambda i=i: svc.top(i)) for i in range(8)]
            bases = [await core.capture(lambda i=i: svc.base(i)) for i in range(8)]

            def lanes(groups):
                return backend.invalidate_cascade_batch_lanes_sharded(groups).tolist()

            assert lanes([[bases[0]]]) == [2], pkg
            entry = backend._packed_mirror
            assert "invalid_version" in entry
            v = entry["invalid_version"]
            assert lanes([[bases[1]]]) == [2]
            assert backend._packed_mirror is entry
            assert entry["invalid_version"] != v
            assert lanes([[bases[0]]]) == [0]  # blocked seeds: empty lanes
            assert tops[0].is_invalidated or backend._pending[backend.id_for(tops[0])]
            backend.graph.mark_invalid(np.asarray([backend.id_for(bases[2])], dtype=np.int32))
            assert lanes([[bases[3]]]) == [2]
            # the marked seed does not count but still conducts: top(2)
            assert lanes([[bases[2]]]) == [1]
            assert lanes([[bases[2]]]) == [0]
        finally:
            core.set_default_hub(old)


async def test_packed_mirror_patches_structural_churn():
    """Structural churn PATCHES the packed mesh mirror in place (bumps
    scattered, adds spliced into slack slots): lane bursts stay exact on the
    churned topology with no rebuild; only slot overflow rebuilds. Both
    packages, counts and patch counters equal; the port's patch batches
    counted on its ``global_metrics()``."""
    from stl_fusion_tpu_torch.diagnostics.metrics import global_metrics

    batches = global_metrics().counter("fusion_mirror_patch_batches_total")
    trace = {}
    for pkg in PKGS:
        core = PKGS[pkg][0]
        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            n = 400
            backend = _backend(pkg, hub, node_capacity=n, edge_capacity=16 * n)
            dg = backend.graph
            dg.add_nodes(n)
            dg.add_edges(np.arange(n - 1), np.arange(1, n))  # chain
            mesh = _mesh(pkg)
            steps = trace.setdefault(pkg, [])
            b0 = batches.value

            def lanes(groups):
                return backend._lanes_sharded_nids([list(g) for g in groups], mesh).tolist()

            steps.append(lanes([[0], [n // 2]]))
            assert steps[-1] == [n, n - n // 2]
            entry0 = backend._packed_mirror
            pg = entry0["graph"]
            dg.clear_invalid()
            dg.add_edges(np.array([10]), np.array([300]))  # a shortcut patches in place
            steps.append(lanes([[10]]))
            assert backend._packed_mirror is entry0 and pg.patches >= 1
            assert steps[-1] == [n - 10] and entry0["fp"] is None
            dg.clear_invalid()
            dg.bump_epochs(np.array([150]))  # severs 150's chain in-edge
            steps.append(lanes([[20]]))
            assert backend._packed_mirror is entry0 and steps[-1] == [130]
            dg.clear_invalid()
            dg.add_edges(np.array([149]), np.array([150]))  # recaptured: chain restored
            steps.append(lanes([[20]]))
            assert backend._packed_mirror is entry0 and steps[-1] == [n - 20]
            steps.append(pg.patches)
            if pkg == "port":
                assert batches.value == b0 + 3
            dg.clear_invalid()
            width = pg.k  # slot overflow (k + slack new in-edges on one row) → rebuild
            dg.add_edges(np.arange(width + 1, dtype=np.int64),
                         np.full(width + 1, 399, dtype=np.int64))
            steps.append(lanes([[399]]))
            assert steps[-1] == [1] and backend._packed_mirror is not entry0
            dg.clear_invalid()
            steps.append(lanes([[0]]))
            assert steps[-1] == [n]  # the rebuilt mirror serves the churned topology
        finally:
            core.set_default_hub(old)
    assert trace["port"] == trace["jax"]


async def test_cascade_rows_lanes_sharded_matches_jax_and_single_device():
    """``cascade_rows_lanes_sharded`` on a table-backed row block: the same
    per-group counts, union and stale rows as JAX's, and as the port's
    single-device ``cascade_rows_lanes`` from the same state."""
    n = 600
    src, dst = power_law_dag(n, avg_degree=3.0, seed=8)
    rng = np.random.default_rng(8)
    groups = [rng.choice(n, size=4, replace=False).tolist() for _ in range(40)]
    out = {}
    for pkg, sharded in (("jax", True), ("port", True), ("port", False)):
        core = PKGS[pkg][0]
        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            backend = _backend(pkg, hub, node_capacity=n + 16, edge_capacity=len(src) + 64)

            class Rows(core.ComputeService):
                def load(self, ids):
                    return np.asarray(ids, dtype=np.float32)

                @core.compute_method(table=core.TableBacking(
                    rows=n, batch="load", **({"device": "cpu"} if pkg == "port" else {})))
                async def row(self, i: int) -> float:
                    return float(i)

            svc = Rows(hub)
            hub.add_service(svc, "rows")
            table = core.memo_table_of(svc.row)
            block = backend.bind_table_rows(table)
            backend.declare_row_edges(block, src, block, dst)
            table.read_batch(np.arange(n))
            backend.cascade_rows_batch(block, [n - 1])  # some rows already stale
            if sharded:
                counts = backend.cascade_rows_lanes_sharded(block, groups, _mesh(pkg))
            else:
                counts = backend.cascade_rows_lanes(block, groups)
            out[(pkg, sharded)] = (counts, backend.graph._h_invalid[:n].copy(),
                                   np.asarray(table._stale_host).copy())
        finally:
            core.set_default_hub(old)
    want = out[("jax", True)]
    for key, got in out.items():
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y, err_msg=str(key))


# ------------------------------------------------------------------ the bench twin
N_BENCH = 20_000


@pytest.fixture(scope="module")
def jax_bench():
    import bench

    return bench


@pytest.mark.parametrize("packed", [True, False])
def test_bench_run_sharded_matches_bench_py(jax_bench, monkeypatch, packed):
    """The twin's ``run_sharded`` (both branches) against ``bench.py``'s at
    20,000 nodes from the same rng: equal ``total_invalidated`` and
    ``counts_head``."""
    monkeypatch.setenv("FUSION_BENCH_SHARDED_PACKED", "1" if packed else "0")
    monkeypatch.setenv("FUSION_BENCH_WORDS", "16")
    want = jax_bench.run_sharded(N_BENCH, 3, 40, 20, np.random.default_rng(3))
    got = pbench.run_sharded(N_BENCH, 3, 40, 20, np.random.default_rng(3), packed=packed,
                             device="cpu")
    assert got["total_invalidated"] == want["total_invalidated"]
    assert got["counts_head"] == want["counts_head"]
    assert got["waves"] == want["waves"] == (512 if packed else 20)
    assert got["mesh_devices"] == 8 and got["packed"] == packed


def test_bench_pull_kernel_matches_bench_py(jax_bench, monkeypatch):
    """``run_single_chip(kernel="pull")`` against ``bench.py``'s
    ``FUSION_BENCH_KERNEL=pull`` leg at 20,000 nodes from the same rng, the
    latency legs off on both: equal ``total_invalidated`` and
    ``counts_head`` (the cumulative real popcount of each batch)."""
    monkeypatch.setenv("FUSION_BENCH_KERNEL", "pull")
    monkeypatch.setenv("FUSION_BENCH_LATENCY", "0")
    want = jax_bench.run_single_chip(N_BENCH, 3, 40, 64, np.random.default_rng(5))
    got = pbench.run_single_chip(N_BENCH, 3, 40, 64, np.random.default_rng(5), kernel="pull",
                                 lat_samples=0, device="cpu")
    assert got["kernel"] == want["kernel"] == "pull"
    assert got["total_invalidated"] == want["total_invalidated"]
    assert got["counts_head"] == want["counts_head"]
    assert got["waves"] == want["waves"] == 64 and got["wave_ms_p99"] is None


def test_live_mesh_loop_matches_jax():
    """The live twin's blocking loop with each burst a
    ``cascade_rows_lanes_sharded`` on 8 shards, through both packages: per
    round the refresh, the per-group counts, the stale set and the host
    invalid mirror equal; the packed mirror built once and patched after."""
    from stl_fusion_tpu_torch.live_path import LiveApi, port_api, run_live
    from test_torch_live import SHAPE, Recorder, _same_events

    jax_api = LiveApi(jcore, jgraph, {}, jnp.asarray, lambda: None, "stl_fusion_tpu (JAX)")
    runs = {}
    for name, api in (("jax", jax_api), ("port", port_api("cpu"))):
        backends = []
        mesh = _mesh(name)

        def burst(backend, block, group_ids):
            return backend.cascade_rows_lanes_sharded(block, group_ids, mesh)

        class Keep(Recorder):
            def after_burst(self, ctx, rnd, group_ids, counts, stats):
                super().after_burst(ctx, rnd, group_ids, counts, stats)
                entry = ctx["backend"]._packed_mirror
                self.events.append(("mesh", rnd, entry["graph"].patches, entry["fp"] is None))
                backends.append(entry)

        recorder = Keep()
        rec = run_live(**SHAPE, api=api, observer=recorder, loops=[("blocking", 3, burst)])
        runs[name] = (rec, recorder.events, backends)
    (want, want_events, want_entries), (got, got_events, got_entries) = runs["jax"], runs["port"]
    _same_events(got_events, want_events)
    assert got["live_total_inv"] == want["live_total_inv"] > 0
    assert all(e is got_entries[0] for e in got_entries)  # one build, patched after
    assert got_entries[0]["graph"].mesh.size == 8 and got_entries[0]["graph"].patches >= 2
