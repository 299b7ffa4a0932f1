"""Parity of the port's bit-packed dense wave (``stl_fusion_tpu_torch.ops.wave``)
with the JAX package's ``ops/wave.py`` on a small power-law DAG with random
epoch bumps (stale edges) and pre-invalid nodes. Inputs come from a numpy
seed and go to both packages. Tolerance: exact — masks are bit-identical,
counts, ids and depths equal. ``tests/test_torch_gpu.py`` holds the CUDA
``wave_expand`` against its plain version on the card."""
import torch_threads  # noqa: F401 — one torch thread a test process
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu.ops import wave as jw
from stl_fusion_tpu_torch.ops import wave as tw
from stl_fusion_tpu_torch.ops.bitops import pack_bits, unpack_bits

N, N_CAP, E_CAP = 200, 256, 1024


def _graph(seed):
    """Numpy graph state: power-law edges captured at epoch 0, then ~10%
    of nodes bumped (their in-edges go stale) and ~5% marked invalid."""
    rng = np.random.default_rng(seed)
    src, dst = power_law_dag(N, avg_degree=3, seed=seed)
    e = len(src)
    es = np.full(E_CAP, N_CAP, np.int32)
    ed = np.full(E_CAP, N_CAP, np.int32)
    ee = np.full(E_CAP, -1, np.int32)
    es[:e], ed[:e], ee[:e] = src, dst, 0
    ne = np.zeros(N_CAP + 1, np.int32)
    ne[N_CAP] = -2
    ne[rng.choice(N, N // 10, replace=False)] += 1
    inv = np.zeros(N_CAP + 1, bool)
    inv[rng.choice(N, N // 20, replace=False)] = True
    return rng, (es, ed, ee, ne, inv)


def _jax_g(state):
    es, ed, ee, ne, inv = state
    return jw.GraphArrays(*(jnp.asarray(a.copy()) for a in (es, ed, ee, ne, inv)))


def _port_g(state, n_live=None):
    es, ed, ee, ne, inv = state
    t = [torch.from_numpy(a.copy()) for a in (es, ed, ee, ne)]
    return tw.GraphArrays(*t, invalid=pack_bits(torch.from_numpy(inv.copy())), n_live=n_live)


def _port_mask(g):
    return unpack_bits(g.invalid, g.n_cap + 1).numpy()


def _seeds(rng, k):
    ids = rng.choice(N, k, replace=False).astype(np.int32)
    return ids, np.array(jw.seeds_to_frontier(N_CAP, jnp.asarray(ids)))


def test_seeds_to_frontier_matches_jax():
    ids = np.array([-1, 0, 5, 5, 255, 256, 9999, -7], dtype=np.int32)
    want = np.asarray(jw.seeds_to_frontier(N_CAP, jnp.asarray(ids)))
    got = tw.seeds_to_frontier(N_CAP, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_wave_matches_jax(seed):
    rng, state = _graph(seed)
    _, frontier = _seeds(rng, 3)
    jg, jc = jw.run_wave(jnp.asarray(frontier), _jax_g(state))
    pg, pc = tw.run_wave(torch.from_numpy(frontier), _port_g(state))
    assert pc == int(jc)
    np.testing.assert_array_equal(_port_mask(pg), np.asarray(jg.invalid))


@pytest.mark.parametrize("seed", [0, 3])
def test_run_wave_with_stats_matches_jax(seed):
    rng, state = _graph(seed)
    _, frontier = _seeds(rng, 2)
    jg, jc, jd = jw.run_wave_with_stats(jnp.asarray(frontier), _jax_g(state))
    pg, pc, pd = tw.run_wave_with_stats(torch.from_numpy(frontier), _port_g(state, n_live=600))
    assert (pc, pd) == (int(jc), int(jd))
    np.testing.assert_array_equal(_port_mask(pg), np.asarray(jg.invalid))


@pytest.mark.parametrize("cap", [512, 8])
def test_run_wave_collect_matches_jax(cap):
    rng, state = _graph(4)
    _, frontier = _seeds(rng, 4)
    jg, jc, jids, jo = jw.run_wave_collect(jnp.asarray(frontier), _jax_g(state), cap)
    pg, pc, pids, po = tw.run_wave_collect(torch.from_numpy(frontier), _port_g(state), cap)
    assert pc == int(jc) and po == bool(jo)
    if cap == 8:
        assert po  # the small cap must overflow on this graph
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(_port_mask(pg), np.asarray(jg.invalid))


def test_run_waves_chained_matches_jax():
    rng, state = _graph(5)
    mat = np.full((4, 3), -1, np.int32)
    for i, k in enumerate((1, 3, 2, 0)):
        mat[i, :k] = rng.choice(N, k, replace=False)
    mat[2, 0] = mat[1, 0]  # a wave re-seeding what an earlier one lit
    jg, jcounts, jnewly = jw.run_waves_chained(jnp.asarray(mat), _jax_g(state))
    pg, pcounts, pnewly = tw.run_waves_chained(torch.from_numpy(mat), _port_g(state))
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(pnewly.numpy(), np.asarray(jnewly))
    np.testing.assert_array_equal(_port_mask(pg), np.asarray(jg.invalid))


@pytest.mark.parametrize("seed", [6, 7])
def test_run_waves_union_matches_jax(seed):
    """Seeds that are already invalid still conduct."""
    rng, state = _graph(seed)
    pre_invalid = np.nonzero(state[4][:N])[0][:3].astype(np.int32)
    fresh = rng.choice(N, 4, replace=False).astype(np.int32)
    ids = np.full(16, -1, np.int32)
    ids[:7] = np.concatenate([pre_invalid, fresh])
    jg, jc, jnewly = jw.run_waves_union(jnp.asarray(ids), _jax_g(state))
    pg, pc, pnewly = tw.run_waves_union(torch.from_numpy(ids), _port_g(state))
    assert pc == int(jc)
    np.testing.assert_array_equal(pnewly.numpy(), np.asarray(jnewly))
    np.testing.assert_array_equal(_port_mask(pg), np.asarray(jg.invalid))


@pytest.mark.parametrize("seed", [8, 9])
def test_wave_expand_plain_matches_one_jax_wave_step(seed):
    rng, state = _graph(seed)
    frontier = np.zeros(N_CAP + 1, bool)
    frontier[rng.choice(N, 40, replace=False)] = True
    j_next, jg = jw.wave_step(jnp.asarray(frontier), _jax_g(state))
    es, ed, ee, ne, inv = (torch.from_numpy(a.copy()) for a in state)
    nxt_w = tw.wave_expand_plain(pack_bits(torch.from_numpy(frontier)), pack_bits(inv), ne, es, ed, ee)
    np.testing.assert_array_equal(unpack_bits(nxt_w, N_CAP + 1).numpy(), np.asarray(j_next))
    p_next, pg = tw.wave_step(torch.from_numpy(frontier), _port_g(state))
    np.testing.assert_array_equal(p_next.numpy(), np.asarray(j_next))
    np.testing.assert_array_equal(_port_mask(pg), np.asarray(jg.invalid))


def _merge_case(seed, n_dup, n_live_extra):
    """A level's inputs with every edge case of the merged kernel: stale
    epochs and pre-invalid dependents (``_graph``), duplicate edges copied
    into the padding, a dependent reached by several frontier nodes, a
    frontier holding invalid nodes, padding edges inside the live prefix,
    and a live prefix that is not a multiple of 4."""
    rng, (es, ed, ee, ne, inv) = _graph(seed)
    e = int((es < N_CAP).sum())
    dup = rng.choice(e, n_dup, replace=False)
    es[e:e + n_dup], ed[e:e + n_dup], ee[e:e + n_dup] = es[dup], ed[dup], ee[dup]
    n_live = e + n_dup + n_live_extra  # the extra slots are padding edges
    n_live += n_live % 4 == 0  # a ragged tail for the kernel's scalar path
    frontier = np.zeros(N_CAP + 1, bool)
    frontier[rng.choice(N, 50, replace=False)] = True
    frontier[np.nonzero(inv[:N])[0][:3]] = True
    return frontier, (es, ed, ee, ne, inv), n_live


@pytest.mark.parametrize(
    "seed,n_dup,n_live_extra", [(8, 0, 0), (9, 7, 2), (10, 13, 1), (11, 40, 3)]
)
def test_wave_expand_merge_plain_matches_one_jax_wave_step(seed, n_dup, n_live_extra):
    """The merged level (next frontier, invalid |= next, popcount(next))
    equals one JAX wave_step, through the plain version and through the
    public wrapper on CPU tensors, which launches no kernel."""
    frontier, state, n_live = _merge_case(seed, n_dup, n_live_extra)
    j_next, jg = jw.wave_step(jnp.asarray(frontier), _jax_g(state))
    j_next, j_inv = np.asarray(j_next), np.asarray(jg.invalid)
    for fn in (tw.wave_expand_merge_plain, tw.wave_expand_merge):
        g = _port_g(state, n_live=n_live)
        before = tw.launches
        nxt_w, count = fn(pack_bits(torch.from_numpy(frontier)), g.invalid, g.node_epoch,
                          *g.live_edges())
        assert tw.launches == before
        np.testing.assert_array_equal(unpack_bits(nxt_w, N_CAP + 1).numpy(), j_next)
        np.testing.assert_array_equal(_port_mask(g), j_inv)
        assert count.dtype == torch.int64 and int(count) == int(j_next.sum())
