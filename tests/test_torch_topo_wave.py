"""Parity of the port's topo sweep (``stl_fusion_tpu_torch/ops/topo_wave.py``)
and host packers (``ops/pull_wave.py``) with the JAX package's: the same
graphs and seeds, made with numpy, go through both. Tolerance: exact — the
built arrays, ``perm`` and ``level_starts`` are identical (native against
native, numpy against numpy), and the sweep's bits and per-word counts
equal JAX ``build_topo_wave32``'s. On the CPU the port's sweep runs its
plain version; the kernel is held against it on the card
(``tests/test_torch_gpu.py``)."""
import torch_threads  # noqa: F401 — one torch thread a test process
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu.ops import pull_wave as jpw
from stl_fusion_tpu.ops import topo_wave as jtw
from stl_fusion_tpu_torch.graph import DeviceGraph
from stl_fusion_tpu_torch.ops import pull_wave as ppw
from stl_fusion_tpu_torch.ops import topo_wave as ptw


def _same_graph(a, b):
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        else:
            assert x == y, field


@pytest.mark.parametrize("use_native,quantize,slack", [
    (True, True, 0), (True, False, 0), (False, True, 0), (False, False, 0),
    (True, True, 2), (False, True, 2),
])
def test_build_topo_graph_matches_jax(use_native, quantize, slack):
    src, dst = power_law_dag(1500, avg_degree=3.0, seed=4)
    kw = dict(k=4, use_native=use_native, quantize=quantize, slack=slack)
    _same_graph(jtw.build_topo_graph(src, dst, 1500, **kw),
                ptw.build_topo_graph(src, dst, 1500, **kw))


def test_high_fan_in_collectors_match_jax():
    """500 sources into one sink ≫ k: virtual collector rows exist and the
    renumbering is the same in both packages."""
    src = np.concatenate([np.arange(500), [500]]).astype(np.int32)
    dst = np.concatenate([np.full(500, 500), [501]]).astype(np.int32)
    for native in (True, False):
        a = jtw.build_topo_graph(src, dst, 502, k=4, use_native=native)
        b = ptw.build_topo_graph(src, dst, 502, k=4, use_native=native)
        assert b.n_tot > 502
        _same_graph(a, b)


def test_native_levels_match_numpy():
    from stl_fusion_tpu_torch.ops.ell_wave import build_ell

    src, dst = power_law_dag(4000, avg_degree=3.0, seed=17)
    ell = build_ell(dst, src, 4000, k=4)
    assert np.array_equal(ptw._levels_native(ell.ell_dst, ell.n_tot, 4),
                          ptw._levels_numpy(ell.ell_dst, ell.n_tot, 4))


def _jax_sweep(graph, seed_lists, words):
    state0, wave = jtw.build_topo_wave32(graph, words=words)
    state, count = wave(jnp.asarray(jtw.topo_seeds_to_bits(graph, seed_lists, words=words)),
                        state0)
    return np.asarray(state.invalid_bits), np.asarray(count)


def _port_sweep(graph, seed_lists, words):
    state0, wave = ptw.build_topo_wave32(graph, words=words, device="cpu")
    bits = torch.from_numpy(ptw.topo_seeds_to_bits(graph, seed_lists, words=words))
    state, count = wave(bits, state0)
    return state.invalid_bits.numpy(), count.numpy()


@pytest.mark.parametrize("words", [1, 2])
def test_sweep_matches_jax_build_topo_wave32(words):
    src, dst = power_law_dag(3000, avg_degree=3.0, seed=11)
    rng = np.random.default_rng(words)
    seed_lists = [rng.choice(3000, size=5, replace=False) for _ in range(32 * words)]
    jg = jtw.build_topo_graph(src, dst, 3000, k=4)
    pg = ptw.build_topo_graph(src, dst, 3000, k=4)
    jbits, jcount = _jax_sweep(jg, seed_lists, words)
    pbits, pcount = _port_sweep(pg, seed_lists, words)
    np.testing.assert_array_equal(pbits, jbits)
    assert pcount.shape == jcount.shape == (() if words == 1 else (words,))
    np.testing.assert_array_equal(pcount, jcount)
    assert int(pcount.sum()) > 0


def _reachable(src, dst, seeds):
    adj = {}
    for s, d in zip(src, dst):
        adj.setdefault(int(s), []).append(int(d))
    seen, stack = set(int(s) for s in seeds), [int(s) for s in seeds]
    while stack:
        for v in adj.get(stack.pop(), ()):
            if v not in seen:
                seen.add(v)
                stack.append(v)
    return seen


def test_deep_chain_single_sweep():
    """A 900-deep chain completes in ONE sweep; every lane equals the host
    closure, lane 31 (the sign bit) included — the oracle JAX's own
    ``test_deep_chain_single_sweep`` holds ``build_topo_wave32`` to (its
    900-level program takes ~20 s to compile on the CPU, so it is not run
    again here; the sweeps of both packages meet on the other cases)."""
    n = 900
    src, dst = np.arange(n - 1), np.arange(1, n)
    seed_lists = [[0]] + [[i] for i in range(1, 32)]
    graph = ptw.build_topo_graph(src, dst, n, k=4)
    _same_graph(jtw.build_topo_graph(src, dst, n, k=4), graph)
    assert len(graph.level_starts) - 1 == n
    pbits, pcount = _port_sweep(graph, seed_lists, 1)
    assert int(pcount) == sum(len(_reachable(src, dst, s)) for s in seed_lists)
    real = np.nonzero(graph.is_real[: graph.n_tot])[0]
    for lane in range(32):
        got = {int(graph.perm[r]) for r in real if (int(pbits[r]) >> lane) & 1}
        assert got == _reachable(src, dst, seed_lists[lane])


def test_idempotent_and_epoch_gating_match_jax():
    src, dst = power_law_dag(500, avg_degree=3.0, seed=3)
    pg, jg = ptw.build_topo_graph(src, dst, 500), jtw.build_topo_graph(src, dst, 500)
    p0, pwave = ptw.build_topo_wave32(pg, device="cpu")
    j0, jwave = jtw.build_topo_wave32(jg)
    seeds = [[1, 2, 3]]
    pb = torch.from_numpy(ptw.topo_seeds_to_bits(pg, seeds))
    jb = jnp.asarray(jtw.topo_seeds_to_bits(jg, seeds))
    j1, jc1 = jwave(jb, j0)
    p1, pc1 = pwave(pb, p0)
    assert int(pc1) == int(jc1) > 0
    j2, jc2 = jwave(jb, j1)
    p2, pc2 = pwave(pb, p1)
    assert int(pc2) == int(jc2) == 0  # already invalid: nothing new
    np.testing.assert_array_equal(p2.invalid_bits.numpy(), np.asarray(j2.invalid_bits))
    # a bumped row's in-edges (captured at epoch 0) are dead
    blocked = sorted(_reachable(src, dst, [1]) - {1})
    b_new = int(pg.inv_perm[blocked[0]])
    p_bumped = ptw.topo_init_state(pg.n_tot, device="cpu")
    p_bumped.node_epoch[b_new] = 1
    j0b, _ = jtw.build_topo_wave32(jg)
    j_bumped = j0b._replace(node_epoch=j0b.node_epoch.at[b_new].set(1))
    seeds1 = [[1]]
    p3, pc3 = pwave(torch.from_numpy(ptw.topo_seeds_to_bits(pg, seeds1)), p_bumped)
    j3, jc3 = jwave(jnp.asarray(jtw.topo_seeds_to_bits(jg, seeds1)), j_bumped)
    assert not (int(p3.invalid_bits[b_new]) & 1)
    assert int(pc3) == int(jc3)
    np.testing.assert_array_equal(p3.invalid_bits.numpy(), np.asarray(j3.invalid_bits))


def test_multi_pass_sweeps_match_jax():
    """``run_topo_sweep_passes`` (start_level 0, seeds on the first pass
    only) with blocked rows (epoch -3)."""
    src, dst = power_law_dag(800, avg_degree=3.0, seed=5)
    pg = ptw.build_topo_graph(src, dst, 800, k=4, slack=2)
    jg = jtw.build_topo_graph(src, dst, 800, k=4, slack=2)
    rng = np.random.default_rng(2)
    seeds = np.zeros(pg.n_tot + 1, np.int32)
    seeds[pg.inv_perm[rng.choice(800, 6, replace=False)]] = 1
    epochs = np.zeros(pg.n_tot + 1, np.int32)
    epochs[pg.inv_perm[rng.choice(800, 40, replace=False)]] = -3
    epochs[pg.n_tot] = -2
    jstate = jtw.run_topo_sweep_passes(jg.level_starts, jtw.topo_graph_arrays(jg),
                                       jnp.asarray(seeds), jnp.asarray(epochs), 2)
    pstate = ptw.run_topo_sweep_passes(pg.level_starts, ptw.topo_graph_arrays(pg, "cpu"),
                                       torch.from_numpy(seeds), torch.from_numpy(epochs), 2)
    np.testing.assert_array_equal(pstate.invalid_bits.numpy(), np.asarray(jstate.invalid_bits))


def test_mirror_gate_and_finish_match_jax():
    """The gate and finish steps on the port's PACKED dense words against
    JAX's bool array: the same blocked epochs, seed bits, count, ids (topo
    order) and dense invalid state."""
    from stl_fusion_tpu_torch.ops.bitops import pack_mask_host, unpack_words_host

    src, dst = power_law_dag(600, avg_degree=3.0, seed=9)
    g = ptw.build_topo_graph(src, dst, 600, k=4, slack=2)
    n_cap, n_tot = 1023, g.n_tot
    rng = np.random.default_rng(4)
    dense = np.zeros(n_cap + 1, bool)
    dense[rng.choice(600, 60, replace=False)] = True
    perm_clipped = np.clip(g.perm, 0, n_cap).astype(np.int32)
    seed_new = g.inv_perm[rng.choice(600, 8, replace=False)].astype(np.int32)
    epoch0 = np.zeros(n_tot + 1, np.int32)
    epoch0[n_tot] = -2
    pga = ptw.topo_graph_arrays(g, "cpu")
    jga = jtw.topo_graph_arrays(g)
    words = torch.from_numpy(pack_mask_host(dense))
    pe, ps = ptw.topo_mirror_gate_step(n_tot)(pga.is_real, torch.from_numpy(epoch0),
                                              torch.from_numpy(perm_clipped), words,
                                              torch.from_numpy(seed_new))
    je, js = jtw.topo_mirror_gate_step(n_tot)(jga.is_real, jnp.asarray(epoch0),
                                              jnp.asarray(perm_clipped), jnp.asarray(dense),
                                              jnp.asarray(seed_new))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    pstate = ptw.run_topo_sweep_passes(g.level_starts, pga, ps, pe, 1)
    jstate = jtw.run_topo_sweep_passes(g.level_starts, jga, js, je, 1)
    for cap in (4, 4096):
        w = words.clone()
        pw, pc, pids, pover = ptw.topo_mirror_finish_step(cap, n_tot)(
            pga.is_real, torch.from_numpy(perm_clipped), w, pstate.invalid_bits)
        jd, jc, jids, jover = jtw.topo_mirror_finish_step(cap, n_tot)(
            jga.is_real, jnp.asarray(perm_clipped), jnp.asarray(dense), jstate.invalid_bits)
        assert pc == int(jc) > 4 and pover == bool(jover) == (cap == 4)
        np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(unpack_words_host(pw.numpy(), n_cap + 1), np.asarray(jd))


def test_seed_width_mismatch_raises():
    g = ptw.build_topo_graph(np.array([0]), np.array([1]), 2)
    state, wave = ptw.build_topo_wave32(g, words=2, device="cpu")
    with pytest.raises(ValueError, match="width"):
        wave(torch.zeros(g.n_tot + 1, dtype=torch.int32), state)


def test_plain_sweep_counts_no_launch_on_cpu():
    before = ptw.launches
    src, dst = power_law_dag(200, avg_degree=3.0, seed=1)
    g = ptw.build_topo_graph(src, dst, 200)
    state, wave = ptw.build_topo_wave32(g, device="cpu")
    wave(torch.from_numpy(ptw.topo_seeds_to_bits(g, [[0]])), state)
    assert ptw.launches == before


def test_empty_graph_builds_trivially():
    pg = ptw.build_topo_graph(np.empty(0, np.int32), np.empty(0, np.int32), 0)
    _same_graph(jtw.build_topo_graph(np.empty(0, np.int32), np.empty(0, np.int32), 0), pg)
    assert pg.n_tot == 0 and pg.n_real == 0
    dg = DeviceGraph(device="cpu")
    dg.build_topo_mirror()  # no nodes yet: must not raise
    count, ids = dg.run_waves_union([[]])
    assert count == 0 and ids.size == 0 and dg.mirror_bursts == 1


@pytest.mark.parametrize("words", [1, 2])
def test_packers_match_jax(words):
    """Every lane of every word, 31 and 63 (the sign bits) included."""
    rng = np.random.default_rng(words)
    lists = [rng.choice(100, size=int(rng.integers(0, 6)), replace=False)
             for _ in range(32 * words)]
    id_map = rng.permutation(101)
    for kw in ({}, {"id_map": id_map}):
        got = ppw.pack_seed_words(101, lists, words=words, **kw)
        want = jpw.pack_seed_words(101, lists, words=words, **kw)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    lane_last = 32 * words - 1
    lists[lane_last] = [7]
    bits = ppw.pack_seed_words(101, lists, words=words)
    word = bits[7] if words == 1 else bits[7, words - 1]
    assert word < 0  # lane 31 of the last word is the int32 sign bit
    np.testing.assert_array_equal(ppw.seeds_to_bits(100, lists[:32]),
                                  jpw.seeds_to_bits(100, lists[:32]))
    groups = [lists[i] for i in range(0, 32 * words, 3)]
    for kw in ({}, {"id_map": id_map}):
        (gm, gw), (wm, ww) = (ppw.pack_lane_matrix(groups, 100, 100, **kw),
                              jpw.pack_lane_matrix(groups, 100, 100, **kw))
        assert gw == ww
        np.testing.assert_array_equal(gm, wm)
    with pytest.raises(ValueError, match="seed ids"):
        ppw.pack_lane_matrix([[100]], 100, 100)
