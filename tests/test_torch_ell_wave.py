"""Parity of the port's ELL builders and lone-wave lat kernels
(``stl_fusion_tpu_torch/ops/ell_wave.py``) with the JAX package's: the same
graphs, seeds and states, made with numpy, go through both. Tolerance:
exact — tables identical (native against native, numpy against numpy), and
every wave's count, overflow flag, wave id list and invalid state equal."""
import torch_threads  # noqa: F401 — one torch thread a test process
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu.ops import ell_wave as jew
from stl_fusion_tpu_torch.ops import ell_wave as pew
from stl_fusion_tpu_torch.ops.bitops import pack_mask_host, unpack_words_host


def _same_ell(a, b):
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        else:
            assert x == y, field


@pytest.mark.parametrize("use_native", [True, False])
def test_build_ell_and_widen_match_jax(use_native):
    src, dst = power_law_dag(1500, avg_degree=3.0, seed=2)
    hub_src = np.concatenate([src, np.zeros(40, np.int32)])  # a hub: forwarding trees
    hub_dst = np.concatenate([dst, np.arange(1000, 1040, dtype=np.int32)])
    a = jew.build_ell(hub_src, hub_dst, 1500, k=4, use_native=use_native)
    b = pew.build_ell(hub_src, hub_dst, 1500, k=4, use_native=use_native)
    assert b.n_tot > b.n_real
    _same_ell(a, b)
    _same_ell(jew.widen_ell(a, 2), pew.widen_ell(b, 2))
    assert pew.widen_ell(b, 0) is b


def _lat_pair(g, **kw):
    return jew.build_ell_lat_wave(g, **kw), pew.build_ell_lat_wave(g, device="cpu", **kw)


@pytest.mark.parametrize("static", [False, True])
def test_lat_wave_matches_jax_across_churn(static):
    rng = np.random.default_rng(6)
    n = 2500
    src, dst = power_law_dag(n, avg_degree=3.0, seed=6)
    g = pew.build_ell(src, dst, n, k=4)
    (js, jwave), (ps, pwave) = _lat_pair(g, lcap=4096, cap=8192, assume_static_epochs=static)
    for i in range(4):
        seeds = np.full(12, -1, np.int32)
        seeds[:9] = rng.choice(n, size=9, replace=False)
        seeds[9] = seeds[0]  # a duplicate
        js, jc, jover = jwave(jnp.asarray(seeds), js)
        ps, pc, pover = pwave(torch.from_numpy(seeds), ps)
        assert (pc, pover) == (int(jc), bool(jover))
        np.testing.assert_array_equal(pew.invalid_mask(ps), jew.invalid_mask(js), err_msg=str(i))
        if i in (1, 2):  # churn: everything consistent again, O(1)
            js, ps = jew.advance_epoch(js), pew.advance_epoch(ps)
    assert ps.epoch == 3


def test_lat_wave_shallow_seeds_small_caps_match_jax():
    n = 20000
    src, dst = power_law_dag(n, avg_degree=3.0, seed=1)
    g = pew.build_ell(src, dst, n, k=4)
    (js, jwave), (ps, pwave) = _lat_pair(g, lcap=512, cap=4096, assume_static_epochs=True)
    rng = np.random.default_rng(3)
    for _ in range(3):
        seeds = (n - 1 - rng.choice(n // 10, 64, replace=False)).astype(np.int32)
        js, jc, jover = jwave(jnp.asarray(seeds), jew.advance_epoch(js))
        ps, pc, pover = pwave(torch.from_numpy(seeds), pew.advance_epoch(ps))
        assert (pc, pover) == (int(jc), bool(jover)) and pc >= 64 and not pover
        np.testing.assert_array_equal(pew.invalid_mask(ps), jew.invalid_mask(js))


def test_lat_wave_overflow_leaves_state_untouched():
    src = np.zeros(300, dtype=np.int32)  # one hub with 300 dependents
    dst = np.arange(1, 301, dtype=np.int32)
    g = pew.build_ell(src, dst, 301, k=4)
    (js, jwave), (ps, pwave) = _lat_pair(g, lcap=64, cap=128)
    before = ps.inv_stamp.clone()
    js, jc, jover = jwave(jnp.asarray(np.array([0], np.int32)), js)
    ps, pc, pover = pwave(torch.tensor([0], dtype=torch.int32), ps)
    assert pover and bool(jover) and pc == int(jc) == 0
    assert torch.equal(ps.inv_stamp, before)
    assert not pew.invalid_mask(ps)[:301].any()


def test_static_epochs_precondition_checked():
    g = pew.build_ell(np.array([0]), np.array([1]), 2, k=4)
    g = g._replace(ell_epoch=np.where(g.ell_dst != g.n_tot, 3, -1).astype(np.int32))
    with pytest.raises(ValueError, match="assume_static_epochs"):
        pew.build_ell_lat_wave(g, assume_static_epochs=True, device="cpu")


def _live_case(seed):
    """A live lat mirror with hubs (virtual forwarding nodes), bumped
    epochs (dead slots), an invalid state and seeds, some already invalid."""
    rng = np.random.default_rng(seed)
    n, n_cap = 1500, 2047
    src, dst = power_law_dag(n, avg_degree=3.0, seed=seed)
    src = np.concatenate([src, np.full(30, 5, np.int32)])
    dst = np.concatenate([dst, np.arange(600, 630, dtype=np.int32)])
    lat = pew.widen_ell(pew.build_ell(src, dst, n, k=4), 2)
    node_epoch = np.zeros(n_cap + 1, np.int32)
    node_epoch[n_cap] = -2
    ell_epoch = jew.ell_live_epoch_init(n, n_cap)(jnp.asarray(lat.ell_dst),
                                                  jnp.asarray(node_epoch))
    node_epoch[rng.choice(n, 60, replace=False)] += 1  # their captured in-edges die
    invalid = np.zeros(n_cap + 1, bool)
    invalid[rng.choice(n, 80, replace=False)] = True
    seeds = np.full(32, lat.n_tot, np.int32)
    pick = rng.choice(n, 6, replace=False)
    pick[0] = np.nonzero(invalid)[0][0]  # a pre-invalid seed conducts, never counts
    seeds[:6] = pick
    seeds[6] = pick[1]  # a duplicate
    seeds[7] = -1  # out of range: dropped
    return n, n_cap, lat, node_epoch, np.array(ell_epoch), invalid, seeds


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("caps", [(512, 4096), (4, 8)])
def test_live_union_step_matches_jax(seed, caps):
    n, n_cap, lat, node_epoch, ell_epoch, invalid, seeds = _live_case(seed)
    lcap, cap = caps
    np.testing.assert_array_equal(  # the slot epochs, derived from the bumped epochs
        pew.ell_live_epoch_init(n, n_cap)(torch.from_numpy(lat.ell_dst),
                                          torch.from_numpy(node_epoch)).numpy(),
        np.asarray(jew.ell_live_epoch_init(n, n_cap)(jnp.asarray(lat.ell_dst),
                                                     jnp.asarray(node_epoch))))
    jstep = jew.ell_live_union_step(lat.n_tot, n, n_cap, lcap, cap)
    pstep = pew.ell_live_union_step(lat.n_tot, n, n_cap, lcap, cap)
    jinv, jc, jacc, jover = jstep(jnp.asarray(lat.ell_dst), jnp.asarray(ell_epoch),
                                  jnp.asarray(node_epoch), jnp.asarray(invalid),
                                  jnp.asarray(seeds))
    words = torch.from_numpy(pack_mask_host(invalid))
    pinv, pc, pacc, pover = pstep(torch.from_numpy(lat.ell_dst), torch.from_numpy(ell_epoch),
                                  torch.from_numpy(node_epoch), words, torch.from_numpy(seeds))
    assert pinv is words  # committed in place
    assert (pc, pover) == (int(jc), bool(jover))
    assert pover == (caps == (4, 8))
    np.testing.assert_array_equal(pacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(unpack_words_host(pinv.numpy(), n_cap + 1), np.asarray(jinv))
    if not pover:
        newly = unpack_words_host(pinv.numpy(), n_cap + 1) & ~invalid
        assert pc == newly.sum() > 0
        np.testing.assert_array_equal(pacc.numpy()[:pc], np.nonzero(newly)[0])
