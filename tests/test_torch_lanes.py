"""Parity of the port's lane bursts, adaptive passes and sequenced lone waves
with the JAX package's: ``DeviceGraph.run_waves_lanes`` (per-group counts
and the union mask, chunking, lane 31, pre-invalid seeds that conduct),
``TpuGraphBackend.invalidate_cascade_batch_lanes`` through a real hub, the
lane epilogue's plain version against JAX ``topo_mirror_finish_lanes_step``,
adaptive against fixed sweep passes, ``run_waves_lanes_chain`` and
``run_waves_union_seq`` with its overflow rerun. The same numpy-made graphs
and seeds go through both packages. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.graph as pgraph
from stl_fusion_tpu.graph.device_graph import DeviceGraph as JaxDeviceGraph
from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu.ops import topo_wave as jtw
from stl_fusion_tpu_torch.graph import DeviceGraph
from stl_fusion_tpu_torch.ops import topo_wave as ptw
from stl_fusion_tpu_torch.ops.bitops import pack_mask_host, unpack_words_host


def random_dag(rng, n, avg_deg=3.0):
    """Edges src → dst with src < dst (``tests/test_device_graph.py``'s)."""
    src, dst = [], []
    for d in range(1, n):
        k = min(rng.poisson(avg_deg), d)
        if k > 0:
            src.extend(int(s) for s in rng.choice(d, size=k, replace=False))
            dst.extend([d] * k)
    return np.asarray(src, np.int32), np.asarray(dst, np.int32)


def _pair(n, src, dst, bumped=(), pre_invalid=(), build=False):
    graphs = (JaxDeviceGraph(node_capacity=n, edge_capacity=len(src) + 64),
              DeviceGraph(node_capacity=n, edge_capacity=len(src) + 64, device="cpu"))
    for g in graphs:
        g.add_nodes(n)
        g.add_edges(src, dst)
        g.bump_epochs(np.asarray(bumped, np.int32))
        g.mark_invalid(np.asarray(pre_invalid, np.int32))
        if build:
            g.build_topo_mirror()
    return graphs


def _lanes(graphs, groups, **kw):
    (jc, jmask), (pc, pmask) = (g.run_waves_lanes(groups, **kw) for g in graphs)
    assert pc.dtype == np.int64 and pmask.dtype == bool
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pmask, jmask)
    jg, pg = graphs
    np.testing.assert_array_equal(pg.invalid_mask(), jg.invalid_mask())
    np.testing.assert_array_equal(pg._h_invalid, jg._h_invalid)
    assert (pg.mirror_bursts, pg.mirror_rebuilds) == (jg.mirror_bursts, jg.mirror_rebuilds)
    return pc, pmask


@pytest.mark.parametrize("seed,n_groups", [(0, 7), (1, 40), (2, 70)])
def test_lane_burst_matches_jax_and_per_group_dense(seed, n_groups):
    """Per-group counts and the union over epoch-churned dead edges and a
    dirty pre-burst state; > 32 groups pack several words (lane 31 is the
    sign bit of word 0); every group equals its own dense wave."""
    rng = np.random.default_rng(seed)
    n = 240
    src, dst = random_dag(rng, n)
    bumped = rng.choice(n, size=n // 10, replace=False)
    pre = rng.choice(n, size=n // 8, replace=False)
    groups = [rng.choice(n, size=int(rng.integers(1, 6)), replace=False).tolist()
              for _ in range(n_groups)]
    groups[0] = []  # an empty group is a 0-count lane
    if n_groups > 32:
        groups[31] = [int(np.setdiff1d(np.arange(n), pre)[0])]
    graphs = _pair(n, src, dst, bumped, pre)
    counts, mask = _lanes(graphs, groups)
    assert graphs[1].mirror_bursts == 1 + (n_groups > 512)
    want_union = np.zeros(n, bool)
    for gi, group in enumerate(groups):
        dense = DeviceGraph(node_capacity=n, edge_capacity=len(src) + 64, device="cpu")
        dense.add_nodes(n)
        dense.add_edges(src, dst)
        dense.bump_epochs(bumped)
        dense.mark_invalid(pre)
        before = dense.invalid_mask()
        c, _ = dense.run_waves_union([group], mirror="off") if group else (0, None)
        assert counts[gi] == c, gi
        want_union |= dense.invalid_mask() & ~before
    np.testing.assert_array_equal(mask[:n], want_union)
    if n_groups > 32:
        assert counts[31] >= 1


def test_lane_burst_chunking_and_pre_invalid_seeds_conduct():
    """``max_words=1``: chunks of 32 apply in order, each against the state
    the earlier ones left; a pre-invalid seed conducts into its still-valid
    dependents without counting itself."""
    rng = np.random.default_rng(3)
    n = 120
    src, dst = random_dag(rng, n)
    graphs = _pair(n, src, dst, pre_invalid=[0, 1, 2])
    groups = [[int(i)] for i in rng.integers(0, n, size=80)]
    groups[5] = [0]
    counts, _ = _lanes(graphs, groups, max_words=1)
    # three chunks ride one chain program, as in JAX
    assert graphs[1].mirror_bursts == 3 and graphs[1].last_lanes_info == graphs[0].last_lanes_info \
        == {"depth": 3, "dispatches": 1}
    # group 5 seeds pre-invalid 0: it conducts into 0's valid dependents
    dense = DeviceGraph(node_capacity=n, edge_capacity=len(src) + 64, device="cpu")
    dense.add_nodes(n)
    dense.add_edges(src, dst)
    dense.mark_invalid(np.array([0, 1, 2]))
    assert counts[5] == dense.run_waves_union([[0]], mirror="off")[0] > 0


def test_lane_burst_at_64_words_matches_jax():
    """ROADMAP C.1: ``max_words=64`` with 1,100 groups packs 64 words a
    row (2,048 lanes: lane_finish at W = 64, which the card's kernel takes
    in column chunks); counts and the union equal JAX's, and every 97th
    group equals its own dense wave."""
    rng = np.random.default_rng(11)
    n = 600
    src, dst = random_dag(rng, n)
    graphs = _pair(n, src, dst, bumped=rng.choice(n, 30, replace=False),
                   pre_invalid=rng.choice(n, 40, replace=False))
    groups = [rng.choice(n, size=int(rng.integers(1, 4)), replace=False).tolist()
              for _ in range(1100)]
    counts, mask = _lanes(graphs, groups, max_words=64)
    assert graphs[1].mirror_bursts == 1 and graphs[1].last_lanes_info == {
        "depth": 1, "dispatches": 1}
    assert counts[1099] >= 1 and mask.any()
    for gi in range(0, 1100, 97):
        dense = DeviceGraph(node_capacity=n, edge_capacity=len(src) + 64, device="cpu")
        dense.add_nodes(n)
        dense.add_edges(src, dst)
        dense.bump_epochs(graphs[1]._h_node_epoch[:n].nonzero()[0].astype(np.int32))
        dense.mark_invalid(np.nonzero(graphs[0]._h_invalid[:n] & ~mask[:n])[0])
        assert counts[gi] == dense.run_waves_union([groups[gi]], mirror="off")[0], gi


def test_lane_burst_on_a_patched_mirror_and_bad_seeds():
    rng = np.random.default_rng(5)
    n = 300
    src, dst = power_law_dag(n, avg_degree=3.0, seed=5)
    graphs = _pair(n, src, dst, build=True)
    for g in graphs:  # churn: a bump with recapture, and forward appends
        g.bump_epochs(np.array([200]))
        g.add_edges(src[dst == 200], dst[dst == 200])
        g.add_edges(np.array([3, 7]), np.array([250, 299]))
    groups = [rng.choice(n, size=4, replace=False).tolist() for _ in range(40)]
    _lanes(graphs, groups)
    assert graphs[1].mirror_patches == graphs[0].mirror_patches == 1
    assert graphs[1].mirror_rebuilds == 1
    with pytest.raises(ValueError, match="seed ids"):
        graphs[1].run_waves_lanes([[0], [n + 5]])


def test_lanes_chain_matches_jax():
    rng = np.random.default_rng(9)
    n = 200
    src, dst = random_dag(rng, n)
    graphs = _pair(n, src, dst, build=True)
    stages = [[rng.choice(n, 3, replace=False).tolist() for _ in range(s)] for s in (5, 40, 1)]
    (jc, jm), (pc, pm) = (g.run_waves_lanes_chain(stages) for g in graphs)
    for a, b in zip(pc, jc):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pm, jm):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(graphs[1].invalid_mask(), graphs[0].invalid_mask())
    assert graphs[1].mirror_bursts == graphs[0].mirror_bursts == 3


def test_finish_lanes_plain_matches_jax():
    """The lane epilogue on random swept bits: virtual rows, pre-invalid
    rows, lane 31; counts, union count, newly mask and the dense state."""
    rng = np.random.default_rng(2)
    n_real, n_virtual, words = 700, 200, 2
    n_tot = n_real + n_virtual
    n_cap = 1024
    perm = np.full(n_tot + 1, n_cap, np.int32)
    rows = rng.permutation(n_tot)[:n_real]
    perm[rows] = rng.permutation(n_real)
    is_real = np.zeros(n_tot + 1, bool)
    is_real[rows] = True
    bits = rng.integers(-(2**31), 2**31, size=(n_tot + 1, words), dtype=np.int32)
    bits[rng.random(n_tot + 1) < 0.6] = 0
    bits[n_tot] = 0
    pre = np.zeros(n_cap + 1, bool)
    pre[rng.choice(n_real, 150, replace=False)] = True
    g2, lane_counts, union_count, packed = jtw.topo_mirror_finish_lanes_step(n_tot, words)(
        jnp.asarray(is_real), jnp.asarray(perm), jnp.asarray(pre), jnp.asarray(bits))
    g_words = torch.from_numpy(pack_mask_host(pre))
    t = torch.from_numpy
    _, p_counts, p_union, p_newly = ptw.topo_mirror_finish_lanes_step(n_tot, words)(
        t(is_real), t(perm), g_words, t(bits))
    np.testing.assert_array_equal(p_counts.numpy(), np.asarray(lane_counts))
    assert int(p_union) == int(union_count) > 0 and int(p_counts[31]) > 0
    np.testing.assert_array_equal(unpack_words_host(p_newly.numpy(), n_cap + 1),
                                  np.unpackbits(np.asarray(packed).view(np.uint8),
                                                count=n_cap + 1, bitorder="little").astype(bool))
    np.testing.assert_array_equal(unpack_words_host(g_words.numpy(), n_cap + 1), np.asarray(g2))
    # lane_finish takes the plain version on CPU tensors
    g_again = torch.from_numpy(pack_mask_host(pre))
    got = ptw.lane_finish(t(bits), t(is_real), t(perm), g_again)
    assert torch.equal(got[0], p_counts) and torch.equal(g_again, g_words)


@pytest.mark.parametrize("words", [1, 2, 16])
def test_finish_lanes_identity_form_matches_jax(words):
    """The lane epilogue's identity form (no row map: row r is node r, the
    packed mesh burst's rows) against JAX ``topo_mirror_finish_lanes_step``
    with ``perm = arange(rows)``: 1,003 rows (not a multiple of 32) over 40
    dense words (more than the rows need), padded rows not real, pre-invalid
    rows, lane 31; and against the port's row-map form on the same data."""
    rng = np.random.default_rng(17 + words)
    n_rows, n_real, n_words = 1003, 990, 40
    is_real = np.zeros(n_rows, bool)
    is_real[:n_real] = True
    bits = rng.integers(-(2**31), 2**31, size=(n_rows, words), dtype=np.int32)
    bits[rng.random(n_rows) < 0.5] = 0
    bits[rng.random(n_rows) < 0.05, 0] = np.int32(-(2**31))
    pre = np.zeros(32 * n_words, bool)
    pre[rng.choice(n_real, 120, replace=False)] = True
    perm = np.arange(n_rows, dtype=np.int32)
    g2, lane_counts, union_count, packed = jtw.topo_mirror_finish_lanes_step(n_rows - 1, words)(
        jnp.asarray(is_real), jnp.asarray(perm), jnp.asarray(pre), jnp.asarray(bits))
    t = torch.from_numpy
    got = {}
    for form, rows in (("identity", None), ("row map", t(perm))):
        g_words = t(pack_mask_host(pre))
        counts, union, newly = ptw.lane_finish(t(bits), t(is_real), rows, g_words)
        got[form] = (counts, union, newly, g_words)
    counts, union, newly, g_words = got["identity"]
    np.testing.assert_array_equal(counts.numpy(), np.asarray(lane_counts))
    assert int(union) == int(union_count) > 0 and int(counts[31]) > 0
    np.testing.assert_array_equal(unpack_words_host(newly.numpy(), 32 * n_words),
                                  np.unpackbits(np.asarray(packed).view(np.uint8),
                                                count=32 * n_words, bitorder="little")
                                  .astype(bool))
    np.testing.assert_array_equal(unpack_words_host(g_words.numpy(), 32 * n_words),
                                  np.asarray(g2))
    for a, b in zip(got["identity"], got["row map"]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dense words"):
        ptw.lane_finish(t(bits), t(is_real), None, torch.zeros(31, dtype=torch.int32))


def two_chain_pair():
    """Two chains and a cross edge that violates the frozen level order: the
    patched mirror needs 2 passes (``tests/test_async_wave.py``'s graph)."""
    graphs = (JaxDeviceGraph(node_capacity=128, edge_capacity=256),
              DeviceGraph(node_capacity=128, edge_capacity=256, device="cpu"))
    for g in graphs:
        g.add_nodes(64)
        g.add_edges(np.arange(31), np.arange(1, 32))
        g.add_edges(np.arange(32, 63), np.arange(33, 64))
        g.build_topo_mirror()
        g.add_edges([31], [33])
        g.run_waves_union([[0]])
        g.clear_invalid()
        g._topo_mirror["lat"] = None  # the sweep route
    return graphs


def test_adaptive_passes_match_fixed_and_are_counted():
    for g in two_chain_pair():
        m = g._topo_mirror
        assert m["passes"] == 2
        c_fixed, ids_fixed = g.run_waves_union([[0]])
        g.clear_invalid()
        g.set_adaptive_passes(True)
        assert m["passes"] == 0
        stages0 = g.adaptive_stages
        c_ad, ids_ad = g.run_waves_union([[0]])
        assert int(c_ad) == int(c_fixed) == 63
        assert sorted(ids_ad.tolist()) == sorted(ids_fixed.tolist())
        assert g.adaptive_stages == stages0 + 1
        g.set_adaptive_passes(False)
        assert m["passes"] == 2
    from stl_fusion_tpu_torch.diagnostics.metrics import global_metrics

    assert global_metrics().snapshot().get("fusion_wave_adaptive_stages_total", 0) > 0


def test_adaptive_survives_mirror_rebuild():
    for g in two_chain_pair():
        g.set_adaptive_passes(True)
        g.build_topo_mirror(force=True)
        assert g._topo_mirror["passes"] == 0
        g.set_adaptive_passes(False)
        g.build_topo_mirror(force=True)
        assert g._topo_mirror["passes"] == 1


def test_adaptive_lanes_match_fixed_and_jax():
    graphs = two_chain_pair()
    out = {}
    for mode in (False, True):
        for g in graphs:
            g.clear_invalid()
            g.set_adaptive_passes(mode)
        (jc, _), (pc, pm) = (g.run_waves_lanes_chain([[[0]], [[32]]]) for g in graphs)
        assert [c.tolist() for c in pc] == [c.tolist() for c in jc]
        np.testing.assert_array_equal(graphs[1].invalid_mask(), graphs[0].invalid_mask())
        out[mode] = ([c.tolist() for c in pc], graphs[1].invalid_mask())
        groups = [[0], [32], [5, 40], [33]]
        _lanes(graphs, groups)
    assert out[True][0] == out[False][0] == [[63], [1]]
    np.testing.assert_array_equal(out[True][1], out[False][1])


def test_adaptive_lanes_chain_matches_fixed():
    """``tests/test_async_wave.py::test_adaptive_lanes_chain_matches_fixed``
    through both packages: the chain of two stages under fixed and adaptive
    passes gives the same counts and mask, and reports JAX's dispatch count,
    ``ceil(depth / 8)`` (a 10-stage chain: 2)."""
    graphs = two_chain_pair()
    for g in graphs:
        c_fixed, _ = g.run_waves_lanes_chain([[[0]], [[32]]])
        mask_fixed = g.invalid_mask().copy()
        assert g.last_lanes_info == {"depth": 2, "dispatches": 1}
        g.clear_invalid()
        g.set_adaptive_passes(True)
        stages0 = g.adaptive_stages
        c_ad, _ = g.run_waves_lanes_chain([[[0]], [[32]]])
        assert g.adaptive_stages == stages0 + 1  # one count per dispatch call, as JAX
        np.testing.assert_array_equal(g.invalid_mask(), mask_fixed)
        assert np.asarray(c_ad).tolist() == np.asarray(c_fixed).tolist() == [[63], [1]]
        g.clear_invalid()
        stages = [[[i]] for i in range(0, 60, 6)]
        counts, masks = g.run_waves_lanes_chain(stages)
        assert g.last_lanes_info == {"depth": 10, "dispatches": 2}
        g.out = ([c.tolist() for c in counts], [m[:64] for m in masks], g.invalid_mask())
    (jc, jm, ji), (pc, pm, pi) = (g.out for g in graphs)
    assert pc == jc
    for a, b in zip(pm, jm):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pi, ji)


def test_multi_chunk_lane_burst_rides_the_chain_as_jax():
    """A burst of more than ``32 * max_words`` groups on a fusible mirror is
    one chain of chunks, as in JAX: the same counts and union, and the
    chain's depth and dispatch count in ``last_lanes_info``."""
    rng = np.random.default_rng(17)
    n = 300
    src, dst = random_dag(rng, n)
    graphs = _pair(n, src, dst, build=True)
    groups = [rng.choice(n, size=3, replace=False).tolist() for _ in range(70)]
    _lanes(graphs, groups, max_words=1)
    assert graphs[1].last_lanes_info == graphs[0].last_lanes_info == {"depth": 3,
                                                                      "dispatches": 1}


def _seq_pair(n, seed):
    src, dst = power_law_dag(n, avg_degree=3.0, seed=seed)
    return _pair(n, src, dst, build=True), src, dst


def test_seq_chain_matches_jax_and_sequential_calls():
    graphs, src, dst = _seq_pair(600, 13)
    rng = np.random.default_rng(21)
    waves = [rng.choice(600, size=2, replace=False).tolist() for _ in range(12)]
    (jc, jids), (pc, pids) = (g.run_waves_union_seq(waves) for g in graphs)
    assert pc.dtype == np.int64 and pc.tolist() == jc.tolist()
    np.testing.assert_array_equal(np.sort(pids), np.sort(jids))
    assert graphs[1].lat_waves == graphs[0].lat_waves == 12
    seq = DeviceGraph(node_capacity=600, edge_capacity=len(src) + 64, device="cpu")
    seq.add_nodes(600)
    seq.add_edges(src, dst)
    seq.build_topo_mirror()
    assert [seq.run_waves_union([w])[0] for w in waves] == pc.tolist()
    np.testing.assert_array_equal(seq.invalid_mask(), graphs[1].invalid_mask())
    np.testing.assert_array_equal(graphs[1].invalid_mask(), graphs[0].invalid_mask())


def test_seq_chain_overflow_waves_rerun_on_sweep(monkeypatch):
    monkeypatch.setattr(DeviceGraph, "LAT_CAP", 64)
    monkeypatch.setattr(JaxDeviceGraph, "LAT_CAP", 64)
    graphs, _, _ = _seq_pair(2000, 7)
    n = 2000
    (jc, jids), (pc, pids) = (g.run_waves_union_seq([[0], [n - 5]]) for g in graphs)
    assert pc.tolist() == jc.tolist() and pc[0] > 64  # wave 0 overflowed, re-ran on the sweep
    np.testing.assert_array_equal(np.sort(pids), np.sort(jids))
    np.testing.assert_array_equal(graphs[1].invalid_mask(), graphs[0].invalid_mask())
    assert (graphs[1].mirror_bursts, graphs[1].lat_waves) == (
        graphs[0].mirror_bursts, graphs[0].lat_waves)


def test_seq_chain_without_lat_is_a_host_loop():
    graphs, _, _ = _seq_pair(300, 5)
    for g in graphs:
        g._topo_mirror["lat"] = None
    (jc, _), (pc, _) = (g.run_waves_union_seq([[1], [2, 3], []]) for g in graphs)
    assert pc.tolist() == jc.tolist()
    assert graphs[1].lat_waves == graphs[0].lat_waves == 0


async def _backend_lanes(core, graph, kw):
    hub = core.FusionHub()
    old = core.set_default_hub(hub)
    try:
        backend = graph.TpuGraphBackend(hub, **kw)

        class Chain(core.ComputeService):
            @core.compute_method
            async def base(self, i: int) -> int:
                return i

            @core.compute_method
            async def mid(self, i: int) -> int:
                return await self.base(i) + 1

            @core.compute_method
            async def top(self, i: int) -> int:
                return await self.mid(i) + 1

        svc = Chain(hub=hub)
        tops = [await core.capture(lambda i=i: svc.top(i)) for i in range(8)]
        bases = [await core.capture(lambda i=i: svc.base(i)) for i in range(8)]
        mids = [await core.capture(lambda i=i: svc.mid(i)) for i in range(8)]
        tops[2].on_invalidated(lambda c: None)
        out = {"counts": backend.invalidate_cascade_batch_lanes([[bases[i]] for i in range(6)])}
        out["top2_eager"] = tops[2].is_invalidated
        out["pending"] = backend._pending[: backend.node_count].copy()
        out["fresh"] = [(await core.capture(lambda i=i: svc.top(i))) is not tops[i]
                        for i in range(8)]
        await svc.top(7)
        out["overlap"] = backend.invalidate_cascade_batch_lanes([[mids[7]], [bases[7]]])
        last = backend.profiler.recent(1)[0]
        out["record"] = {k: last.get(k) for k in ("kind", "groups", "fused_depth")}
        out["mirror_bursts"] = backend.graph.mirror_bursts
        return out
    finally:
        core.set_default_hub(old)


async def test_backend_lane_burst_matches_jax():
    jout = await _backend_lanes(jcore, jgraph, {})
    pout = await _backend_lanes(pcore, pgraph, {"device": "cpu"})
    np.testing.assert_array_equal(pout["counts"], [3] * 6)
    np.testing.assert_array_equal(pout["overlap"], [2, 3])  # groups are snapshot-independent
    assert pout["fresh"] == [True] * 6 + [False, False]
    assert pout["top2_eager"] and pout["mirror_bursts"] == 2
    for key in jout:
        if isinstance(jout[key], np.ndarray):
            np.testing.assert_array_equal(pout[key], jout[key], err_msg=key)
        else:
            assert pout[key] == jout[key], key


def test_fused_lanes_and_chain_steps_match_jax():
    """The step functions under their JAX names on one mirror: the lane
    burst and a 3-stage chain (stage i sees stages < i), at 2 passes."""
    rng = np.random.default_rng(4)
    n = 400
    src, dst = power_law_dag(n, avg_degree=3.0, seed=4)
    graphs = _pair(n, src, dst, build=True, pre_invalid=rng.choice(n, 40, replace=False))
    jm, pm = (g._topo_mirror for g in graphs)
    n_tot, starts = pm["n_tot"], pm["level_starts"]
    assert jm["n_tot"] == n_tot and jm["level_starts"] == starts
    mats = np.full((3, 64, 4), n_tot, np.int32)
    for d in range(3):
        for lane in range(64):
            mats[d, lane, :3] = pm["inv_perm"][rng.choice(n, 3, replace=False)]
    jg, pg = graphs
    j_inv = jg.device_arrays().invalid
    p_inv = pg.device_arrays().invalid.clone()
    j_out = jtw.topo_mirror_fused_lanes_chain_step(starts, n_tot, 2, 2, 3)(
        jm["garrays"], jm["node_epoch0"], jm["perm_clipped"], j_inv, jnp.asarray(mats))
    p_out = ptw.topo_mirror_fused_lanes_chain_step(starts, n_tot, 2, 2, 3)(
        pm["garrays"], pm["node_epoch0"], pm["perm_clipped"], p_inv, torch.from_numpy(mats))
    np.testing.assert_array_equal(p_out[1].numpy(), np.asarray(j_out[1]))
    for d in range(3):
        np.testing.assert_array_equal(
            unpack_words_host(p_out[2][d].numpy(), pg.n_cap + 1),
            np.unpackbits(np.asarray(j_out[2][d]).view(np.uint8), count=jg.n_cap + 1,
                          bitorder="little").astype(bool))
    np.testing.assert_array_equal(unpack_words_host(p_out[0].numpy(), pg.n_cap + 1),
                                  np.asarray(j_out[0]))
    # one stage alone is the fused lanes step
    p_inv = pg.device_arrays().invalid.clone()
    _, counts, union, newly = ptw.topo_mirror_fused_lanes_step(starts, n_tot, 2, 2)(
        pm["garrays"], pm["node_epoch0"], pm["perm_clipped"], p_inv, torch.from_numpy(mats[0]))
    j1 = jtw.topo_mirror_fused_lanes_step(starts, n_tot, 2, 2)(
        jm["garrays"], jm["node_epoch0"], jm["perm_clipped"], j_inv, jnp.asarray(mats[0]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j1[1]))
    assert int(union) == int(j1[2]) > 0
