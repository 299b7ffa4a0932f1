"""Parity of the port's pull wave (``stl_fusion_tpu_torch/ops/pull_wave.py``:
``build_pull_graph``, ``build_pull_wave32``, its level the ``packed_pull``
kernel's plain version on the CPU) with the JAX package's. The same numpy
graphs and seeds go through both and through the per-wave BFS oracle of
``tests/test_device_graph.py``. Tolerance: exact — the pull tables identical
(native against native, numpy against numpy: the two packers number
virtual ids differently), the invalid words bit-identical, the counts
equal. Each case is the port counterpart of one in ``tests/test_pull_wave.py``,
run on both packages."""
import torch_threads  # noqa: F401 — one torch thread a test process
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu.ops import pull_wave as jpw
from stl_fusion_tpu_torch.ops import packed_pull as ppp
from stl_fusion_tpu_torch.ops import pull_wave as ppw
from stl_fusion_tpu_torch.ops.bitops import pack_bits, unpack_bits

from test_device_graph import python_wave_oracle


def _same_tables(a, b):
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        else:
            assert x == y, field


def _both_waves(g, bits):
    """One 32-wave pull on each package from a fresh state: (JAX invalid
    words, JAX count, port invalid words, port count, port stats)."""
    jstate, jwave = jpw.build_pull_wave32(g)
    jstate, jtotal = jwave(jnp.asarray(bits), jstate)
    pstate, pwave = ppw.build_pull_wave32(g, device="cpu")
    stats = {}
    pstate, ptotal = pwave(torch.from_numpy(bits), pstate, stats)
    assert ptotal.dtype == torch.int32 and ptotal.dim() == 0
    return np.asarray(jstate.invalid_bits), int(jtotal), pstate.invalid_bits.numpy(), \
        int(ptotal), stats


@pytest.mark.parametrize("use_native", [True, False])
def test_pull_wave32_matches_jax_and_oracle_per_bit(use_native):
    rng = np.random.default_rng(5)
    n = 1500
    src, dst = power_law_dag(n, avg_degree=3.0, seed=5)
    jg = jpw.build_pull_graph(src, dst, n, k=8) if use_native else \
        jpw.build_ell(dst, src, n, k=8, use_native=False)
    pg = ppw.build_pull_graph(src, dst, n, k=8) if use_native else \
        ppw.build_ell(dst, src, n, k=8, use_native=False)
    _same_tables(jg, pg)

    seed_sets = [rng.choice(n, size=4, replace=False).tolist() for _ in range(32)]
    bits = ppw.seeds_to_bits(pg.n_tot, seed_sets)
    np.testing.assert_array_equal(bits, jpw.seeds_to_bits(jg.n_tot, seed_sets))
    jinv, jtotal, pinv, ptotal, stats = _both_waves(pg, bits)
    np.testing.assert_array_equal(pinv, jinv)
    assert ptotal == jtotal and stats["levels"] >= 1 and stats["syncs"] >= 1

    edges = list(zip(src.tolist(), dst.tolist()))
    expected_total = 0
    for w in range(32):
        want = python_wave_oracle(
            n, edges, [0] * len(edges), np.zeros(n, np.int32), np.zeros(n, bool), seed_sets[w]
        )
        got = (pinv[:n] >> w) & 1 if w < 31 else (pinv[:n] < 0).astype(int)
        np.testing.assert_array_equal(got.astype(bool), want, err_msg=f"wave {w}")
        expected_total += int(want.sum())
    assert ptotal == expected_total


def test_pull_wave_high_fan_in_virtual_collectors():
    # node 50 depends on 40 nodes (in-degree 40 > k) → virtual collectors
    src = np.arange(40, dtype=np.int32)
    dst = np.full(40, 50, dtype=np.int32)
    g = ppw.build_pull_graph(src, dst, 51, k=4)
    _same_tables(jpw.build_pull_graph(src, dst, 51, k=4), g)
    assert g.n_tot > g.n_real
    bits = ppw.seeds_to_bits(g.n_tot, [[7]])  # seed node 7 in wave 0
    jinv, jtotal, pinv, ptotal, _ = _both_waves(g, bits)
    np.testing.assert_array_equal(pinv, jinv)
    assert pinv[7] == 1 and pinv[50] == 1  # cascaded through collectors
    assert ptotal == jtotal == 2  # virtual hops not counted


def test_pull_wave_counts_cumulative_bits_and_keeps_the_null_row_clear():
    """The pull wave's count is every real invalid bit after the wave (not
    only the new ones), and the null row never fires even when seeded: a
    second wave from the first one's state, on both packages."""
    n = 300
    src, dst = power_law_dag(n, avg_degree=3.0, seed=3)
    g = ppw.build_pull_graph(src, dst, n, k=8)
    rng = np.random.default_rng(3)
    first = ppw.seeds_to_bits(g.n_tot, [rng.choice(n, 3, replace=False) for _ in range(32)])
    second = ppw.seeds_to_bits(g.n_tot, [rng.choice(n, 3, replace=False) for _ in range(32)])
    second[g.n_tot] = -1  # the null row seeded in every lane
    jstate, jwave = jpw.build_pull_wave32(g)
    pstate, pwave = ppw.build_pull_wave32(g, device="cpu")
    for bits in (first, second):
        jstate, jtotal = jwave(jnp.asarray(bits), jstate)
        pstate, ptotal = pwave(torch.from_numpy(bits), pstate)
        np.testing.assert_array_equal(pstate.invalid_bits.numpy(), np.asarray(jstate.invalid_bits))
        assert int(ptotal) == int(jtotal)
    real = pstate.invalid_bits.numpy()[:n].view(np.uint32)
    assert int(ptotal) == sum(bin(int(x)).count("1") for x in real)


def test_pull_wave_summary_mode_with_the_null_row_matches_jax(monkeypatch):
    """The fired summary at W = 1 with the null row. One level of
    ``packed_pull`` on the CPU (the null row's fire forced to 0) given the
    previous level's summary, with garbage in every row whose bit is clear,
    against JAX's pull level body (``pull_wave.py:160-167``, in jnp) on the
    frontier with those rows zero; then ``build_pull_wave32`` with the
    wave's scratch filled with garbage and the null row seeded, against
    the JAX package's: words and count."""
    n = 400
    src, dst = power_law_dag(n, avg_degree=3.0, seed=8)
    g = ppw.build_pull_graph(src, dst, n, k=8)
    rng = np.random.default_rng(8)
    pstate, pwave = ppw.build_pull_wave32(g, device="cpu")
    in_src, edge_epoch, is_real = pwave.garrays
    n_rows, n_tot = in_src.shape[0], g.n_tot

    def rand():
        return rng.integers(-(2**31), 2**31, n_rows, dtype=np.int64).astype(np.int32)
    lit = rng.random(n_rows) < 0.4
    lit[n_tot] = True  # a seeded null row conducts for one level, as in JAX
    frontier = np.where(lit, rand() | 1, 0).astype(np.int32)
    garbage = np.where(lit, frontier, rand()).astype(np.int32)
    invalid = np.where(rng.random(n_rows) < 0.5, rand(), 0).astype(np.int32)

    live = jnp.asarray(edge_epoch.numpy()) == jnp.asarray(pstate.node_epoch.numpy())[:, None]
    contrib = jnp.where(live, jnp.asarray(frontier)[jnp.asarray(in_src.numpy())], 0)
    fire = contrib[:, 0]
    for j in range(1, in_src.shape[1]):
        fire = fire | contrib[:, j]
    fire = np.asarray((fire & ~jnp.asarray(invalid)).at[n_tot].set(0))

    t = torch.from_numpy
    inv, nxt = t(invalid.copy()).view(-1, 1), torch.full((n_rows, 1), 7, dtype=torch.int32)
    counts = torch.zeros(1, dtype=torch.int32)
    summary_out = torch.full((-(-n_rows // 32),), 12345, dtype=torch.int32)
    ppp.packed_pull(in_src, edge_epoch, pstate.node_epoch, is_real, t(garbage).view(-1, 1), nxt,
                    inv, counts, null_row=n_tot, summary_in=pack_bits(t(lit)),
                    summary_out=summary_out)
    np.testing.assert_array_equal(inv.view(-1).numpy(), invalid | fire)
    fired = fire != 0
    np.testing.assert_array_equal(unpack_bits(summary_out, n_rows).numpy(), fired)
    np.testing.assert_array_equal(nxt.view(-1).numpy()[fired], fire[fired])
    assert (nxt.view(-1).numpy()[~fired] == 7).all() and not fired[n_tot]

    bits = ppw.seeds_to_bits(g.n_tot, [rng.choice(n, 3, replace=False) for _ in range(32)])
    bits[g.n_tot] = -1  # the null row seeded in every lane
    jstate, jwave = jpw.build_pull_wave32(g)
    jstate, jtotal = jwave(jnp.asarray(bits), jstate)
    seeded = np.random.default_rng(9)
    fresh = ppp._wave_buffers

    def buffers(invalid):
        out = fresh(invalid)
        for b in out:
            b.copy_(t(seeded.integers(-(2**31), 2**31, tuple(b.shape),
                                      dtype=np.int64).astype(np.int32)))
        return out
    monkeypatch.setattr(ppp, "_wave_buffers", buffers)
    stats = {}
    pstate, ptotal = pwave(t(bits), pstate, stats)
    np.testing.assert_array_equal(pstate.invalid_bits.numpy(), np.asarray(jstate.invalid_bits))
    assert int(ptotal) == int(jtotal) and stats["levels"] >= 2
