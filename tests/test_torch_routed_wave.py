"""Parity of the port's routed mesh (``cluster/placement.py``,
``parallel/routed_wave.py`` with its level as ``ops/routed_wave.py``'s
``routed_level``, the backend's routed half, ``cluster/router.py`` and
``cluster/rebalancer.py``) with the JAX package's.

Each case runs one reference test of ``tests/test_routed_wave.py`` (every
case but ``test_packed_patch_batch_equals_sequential``, which
``tests/test_torch_packed_wave.py`` runs) twice through
``test_torch_edge.run_case``: as the reference module on JAX's 8 virtual
CPU devices, and as its source on the port with ``graph_mesh()`` made 8
logical shards on the CPU. The reference's assertions hold on both, and
each package's observations must be EQUAL: call results and errors, and for
every ``RoutedShardedGraph`` the case builds its ``stats()`` (levels,
``spec_levels``, the cross-host words, bucket resizes, shard moves and the
capacities the layout decides) and its final invalid rows.

The ``routed_level`` cases hold the kernel's plain version against JAX's
level on each exchange and on the speculative form, before and after an
in-place bucket resize: seeds whose every row beyond one level is already
invalid make JAX's whole wave exactly one level. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import numpy as np
import pytest
import torch

import stl_fusion_tpu.cluster as jcluster
import stl_fusion_tpu.parallel as jparallel
from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu_torch.cluster import DevicePlacement, ShardMap
from stl_fusion_tpu_torch.ops.routed_wave import routed_level, routed_seed, slot_width
from stl_fusion_tpu_torch.parallel import RoutedShardedGraph, graph_mesh
from test_torch_edge import run_case

#: the reference's meshes as logical shards on the CPU
MESH = [("graph_mesh()", 'graph_mesh(devices=["cpu"] * 8)')]


def _routed_counters(g):
    return {**g.stats(), "invalid": np.flatnonzero(g.invalid_mask()).tolist()}


#: every routed graph a case builds: its stats and final invalid rows
ROUTED = (("parallel.routed_wave", "RoutedShardedGraph", _routed_counters),)

ROUTED_CASES = [
    "test_placement_geometry_and_determinism",
    "test_placement_move_keeps_unmoved_slots_and_same_dev_shards",
    "test_placement_off_mesh_members_have_no_slots",
    "test_placement_host_axis_geometry",
    "test_placement_host_aware_moves_prefer_same_host_and_are_deterministic",
    "test_hier_chain_equals_sequential_and_patches_apply",
    "test_hier_kill_join_moves_shards_preserving_state",
    "test_routed_chain_equals_sequential_waves",
    "test_routed_kill_join_moves_shards_preserving_state",
    "test_routed_patch_batch_is_one_dispatch_and_oracle_exact",
    "test_routed_patch_overflow_reports_rebuild_when_resizes_exhausted",
    "test_routed_patch_overflow_resizes_in_place_and_stays_oracle_exact",
    "test_mesh_shard_snapshot_survives_reshard",
    "test_rebalancer_moves_device_shards_on_epoch",
    "test_explain_names_the_shard_hop",
    "test_clocksync_offset_estimation_and_fallback",
    "test_clock_probe_rides_connect_and_corrects_delivery",
    "test_overlapped_routed_chains_keep_device_state",
    "test_single_shard_move_repacks_remote_consumers",
]


@pytest.mark.parametrize("test", ROUTED_CASES)
def test_routed_case(test, tmp_path):
    run_case("test_routed_wave", test, patches=MESH, recorded=ROUTED, tmp_path=tmp_path)


@pytest.mark.parametrize("exchange", ["a2a", "tree", "gather"])
def test_routed_wave_matches_bfs_oracle(exchange):
    run_case("test_routed_wave", "test_routed_wave_matches_bfs_oracle", patches=MESH,
             recorded=ROUTED, exchange=exchange)


@pytest.mark.parametrize("dph", [2, 4])
def test_hier_exchange_matches_bfs_oracle_and_counts_cross_words(dph):
    run_case("test_routed_wave", "test_hier_exchange_matches_bfs_oracle_and_counts_cross_words",
             patches=MESH, recorded=ROUTED, dph=dph)


@pytest.mark.parametrize("exchange", ["a2a", "hier"])
def test_backend_mesh_routing_pipeline_and_reshard_chaos(exchange):
    run_case("test_routed_wave", "test_backend_mesh_routing_pipeline_and_reshard_chaos",
             patches=MESH, recorded=ROUTED, exchange=exchange)


# ---------------------------------------------------------------- routed_level
N = 4000


def _one_level_state(n, src, dst, seeds):
    """An invalid mask under which a wave from ``seeds`` runs exactly one
    level: every row but the seeds and their out-neighbours is invalid."""
    keep = np.zeros(n, dtype=bool)
    keep[seeds] = True
    keep[dst[np.isin(src, seeds)]] = True
    return ~keep


def _level_graphs(exchange, dph, depth):
    src, dst = power_law_dag(N, avg_degree=3.0, seed=3)
    rng = np.random.default_rng(5)
    seeds = rng.choice(N // 4, size=40, replace=False)
    inv0 = _one_level_state(N, src, dst, seeds)
    epoch = np.zeros(N, dtype=np.int32)
    epoch[rng.choice(N, size=N // 50, replace=False)] = 1  # stale edges never fire
    kw = dict(edge_dst_epoch=np.zeros(len(dst), np.int32), node_epoch=epoch, invalid=inv0,
              exchange=exchange, exchange_async=depth > 0, async_depth=max(depth, 1))
    jpl = jcluster.DevicePlacement.build(jcluster.ShardMap.initial(["a", "b"], n_shards=32), 8,
                                         N, devices_per_host=dph)
    ppl = DevicePlacement.build(ShardMap.initial(["a", "b"], n_shards=32), 8, N,
                                devices_per_host=dph)
    jg = jparallel.RoutedShardedGraph(src, dst, N, jpl, mesh=jparallel.graph_mesh(), **kw)
    pg = RoutedShardedGraph(src, dst, N, ppl, mesh=graph_mesh(devices=["cpu"] * 8), **kw)
    return jg, pg, src, dst, seeds, inv0


def _plain_level(pg, seeds, spec=False):
    """One ``routed_level`` (plain version, on the CPU) from the seed rows:
    (the rows it lit as node ids, the shards' counts)."""
    f = pg._words_of_rows(pg.perm[seeds])
    inv = pg.g_invalid.clone()
    nxt = torch.zeros_like(f)
    out = torch.zeros(slot_width(pg.n_dev), dtype=torch.int64)
    w = pg._wave
    routed_seed(f, inv, out.clone(), pg.n_dev, pg.w_local)  # the seeds block, as in a wave
    x, stride, cross = (f, pg.w_local, None) if spec else w.exchange(f)
    routed_level(x, stride, cross, w.layout, w.nepoch, inv, nxt, out, spec=spec)
    rows = np.flatnonzero(np.unpackbits(nxt[:-1].numpy().view(np.uint8), bitorder="little"))
    return np.sort(pg.inv_perm[rows]), out.numpy()


@pytest.mark.parametrize("exchange,dph", [("a2a", None), ("tree", None), ("gather", None),
                                          ("hier", 4), ("hier", 2)])
@pytest.mark.parametrize("resized", [False, True], ids=["built", "resized"])
def test_routed_level_plain_equals_jax_level(exchange, dph, resized):
    jg, pg, src, dst, seeds, inv0 = _level_graphs(exchange, dph, depth=0)
    if resized:
        # an in-place resize: the capacities change, no per-edge array
        for g in (jg, pg):
            assert g._try_grow("bucket", g.bucket_cap + 1)
            if exchange == "hier":
                assert g._try_grow("hbucket", g.hbucket_cap + 1)
        assert pg._wave.layout.icap == pg.bucket_cap == jg.bucket_cap
    ids, counts = _plain_level(pg, seeds)
    count, want, over = jg.run_wave_collect(seeds.tolist())
    assert not over and count == len(ids) + int((~inv0[seeds]).sum())
    fresh = seeds[~inv0[seeds]]
    assert np.array_equal(ids, np.setdiff1d(np.sort(want), fresh))
    assert counts[pg.n_dev] == len(ids) == counts[: pg.n_dev].sum()
    assert len(ids) > 100


@pytest.mark.parametrize("exchange,dph", [("a2a", None), ("hier", 4)])
def test_routed_level_spec_form_equals_jax_async_level(exchange, dph):
    """The speculative form lights exactly the level's rows whose firing
    edge has a source on the destination's own shard; with the merge that
    follows it, JAX's one-epoch async wave (``async_depth=1``)."""
    jg, pg, src, dst, seeds, inv0 = _level_graphs(exchange, dph, depth=1)
    spec_ids, _ = _plain_level(pg, seeds, spec=True)
    all_ids, _ = _plain_level(pg, seeds)
    count, want, _over = jg.run_wave_collect(seeds.tolist())
    fresh = seeds[~inv0[seeds]]
    assert np.array_equal(all_ids, np.setdiff1d(np.sort(want), fresh))
    owner = pg.perm // pg.n_local
    local = owner[src] == owner[dst]
    lit = np.isin(src, seeds) & local & np.isin(dst, all_ids)
    assert np.array_equal(spec_ids, np.unique(dst[lit]))
    assert 0 < len(spec_ids) < len(all_ids)
    assert jg.spec_levels_total == 1


def _odd_layout_graphs(n, exchange, dph, empty_dev=3):
    """JAX's and the port's routed graph on ``n`` nodes laid out as the
    kernel's awkward cases are: device ``empty_dev`` receives no edge (its
    shard has no live slot) and ``e_cap`` is not a multiple of 4 (the edge
    headroom picked for it), so every other shard's slots start off a
    16-byte boundary somewhere. Seeds and invalid state as
    :func:`_level_graphs`: one level from the seeds."""
    src, dst = power_law_dag(n, avg_degree=3.0, seed=3)
    jpl = jcluster.DevicePlacement.build(jcluster.ShardMap.initial(["a", "b"], n_shards=32), 8,
                                         n, devices_per_host=dph)
    ppl = DevicePlacement.build(ShardMap.initial(["a", "b"], n_shards=32), 8, n,
                                devices_per_host=dph)
    perm, _inv = ppl.permutation()
    keep = perm[dst] // ppl.n_local != empty_dev
    src, dst = src[keep], dst[keep]
    counts = np.bincount(perm[dst] // ppl.n_local, minlength=8)
    m = int(counts.max())
    headroom = 1.3
    while (int(m * headroom) + 32) % 4 == 0:
        headroom += 1.0 / m
    rng = np.random.default_rng(5)
    seeds = rng.choice(n // 4, size=max(40, n // 100), replace=False)
    inv0 = _one_level_state(n, src, dst, seeds)
    epoch = np.zeros(n, dtype=np.int32)
    epoch[rng.choice(n, size=n // 50, replace=False)] = 1  # stale edges never fire
    kw = dict(edge_dst_epoch=np.zeros(len(dst), np.int32), node_epoch=epoch, invalid=inv0,
              exchange=exchange, edge_headroom=headroom)
    jg = jparallel.RoutedShardedGraph(src, dst, n, jpl, mesh=jparallel.graph_mesh(), **kw)
    pg = RoutedShardedGraph(src, dst, n, ppl, mesh=graph_mesh(devices=["cpu"] * 8), **kw)
    assert pg.e_cap == jg.e_cap and pg.e_cap % 4 != 0
    assert pg._dev_edge_count[empty_dev] == 0 and pg._dev_edge_count.min(initial=1) == 0
    return jg, pg, seeds, inv0


@pytest.mark.parametrize("n,exchange,dph", [(4000, "a2a", None), (200_000, "a2a", None),
                                            (200_000, "hier", 4), (200_000, "gather", None)])
def test_routed_level_plain_equals_jax_level_on_odd_layouts(n, exchange, dph):
    """The plain level against JAX's level where the kernel's tiles meet
    the layout's edges: ``e_cap`` not a multiple of 4, one shard with no
    live edges, and the wider graph (200,000 nodes, ~75,000 live slots a
    shard) the card cases run the kernel on."""
    jg, pg, seeds, inv0 = _odd_layout_graphs(n, exchange, dph)
    ids, counts = _plain_level(pg, seeds)
    count, want, over = jg.run_wave_collect(seeds.tolist())
    assert not over and count == len(ids) + int((~inv0[seeds]).sum())
    fresh = seeds[~inv0[seeds]]
    assert np.array_equal(ids, np.setdiff1d(np.sort(want), fresh))
    assert counts[pg.n_dev] == len(ids) == counts[: pg.n_dev].sum()
    assert counts[3] == 0 and len(ids) > 100
