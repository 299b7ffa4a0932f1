"""Parity of the port's ``DeviceGraph`` dense path with the JAX package's:
the same op sequence (growth past capacity, epoch bumps with duplicate ids,
marks, clears, compaction, every wave entry point — both before the device
copy exists and as in-place patches after it) runs on both, and the invalid
masks, counts and ids must be identical. Also ``from_numpy_state``: a JAX
graph's staging arrays carried into the port. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import numpy as np
import pytest

from stl_fusion_tpu.graph import DeviceGraph as JaxDeviceGraph
from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu_torch.graph import DeviceGraph

STATE_KEYS = ("_h_edge_src", "_h_edge_dst", "_h_edge_dst_epoch", "_h_node_epoch",
              "_h_invalid", "n_nodes", "n_edges", "n_cap", "e_cap")


def _pair(node_capacity=16, edge_capacity=16):
    return (JaxDeviceGraph(node_capacity, edge_capacity),
            DeviceGraph(node_capacity, edge_capacity, device="cpu"))


def _same(jg, pg):
    np.testing.assert_array_equal(pg.invalid_mask(), jg.invalid_mask())
    np.testing.assert_array_equal(pg._h_node_epoch, jg._h_node_epoch)
    assert (pg.n_cap, pg.e_cap, pg.n_nodes, pg.n_edges) == (jg.n_cap, jg.e_cap, jg.n_nodes, jg.n_edges)


def _both(graphs, method, *args, **kwargs):
    jg, pg = graphs
    return getattr(jg, method)(*args, **kwargs), getattr(pg, method)(*args, **kwargs)


@pytest.mark.parametrize("seed", [0, 1])
def test_op_sequence_matches_jax(seed):
    rng = np.random.default_rng(seed)
    graphs = jg, pg = _pair()
    n = 150
    src, dst = power_law_dag(n, avg_degree=3, seed=seed)
    _both(graphs, "add_nodes", n)  # grows nodes past capacity 16
    half = len(src) // 2
    _both(graphs, "add_edges", src[:half], dst[:half])  # grows edges
    _both(graphs, "bump_epochs", np.array([3, 3, 7, 7, 7, 20], np.int32))  # duplicates
    _both(graphs, "add_edges", src[half:], dst[half:])
    _both(graphs, "mark_invalid", rng.choice(n, 5, replace=False))
    _same(jg, pg)
    a, b = _both(graphs, "run_wave", [0, 1], with_stats=True)
    assert a == b
    _same(jg, pg)
    # the device copy now exists: these patch it in place
    _both(graphs, "bump_epochs", rng.choice(n, 12).astype(np.int32))
    _both(graphs, "clear_invalid_ids", rng.choice(n, 30, replace=False))
    _both(graphs, "add_edges", rng.integers(0, 50, 9).astype(np.int32),
          rng.integers(60, n, 9).astype(np.int32))
    _both(graphs, "mark_invalid", rng.choice(n, 3, replace=False))
    _same(jg, pg)
    (jc, jids), (pc, pids) = _both(graphs, "run_wave_collect", [int(rng.integers(n))], cap=4096)
    assert jc == pc
    np.testing.assert_array_equal(pids, jids)
    _same(jg, pg)
    seeds = [[int(x)] for x in rng.choice(n, 3, replace=False)] + [[]]
    (jcounts, jnewly), (pcounts, pnewly) = _both(graphs, "run_waves_chained", seeds)
    np.testing.assert_array_equal(pcounts, jcounts)
    np.testing.assert_array_equal(pnewly, jnewly)
    _same(jg, pg)
    _both(graphs, "bump_epochs", rng.choice(n, 40, replace=False).astype(np.int32))
    removed = _both(graphs, "compact")
    assert removed[0] == removed[1] > 0
    (jc, jnewly), (pc, pnewly) = _both(graphs, "run_waves_union", [[0], [5, 9]])
    assert jc == pc
    np.testing.assert_array_equal(pnewly, jnewly)
    _same(jg, pg)
    _both(graphs, "clear_invalid")
    _same(jg, pg)


def test_collect_overflow_falls_back_to_mask_matches_jax():
    graphs = jg, pg = _pair(256, 1024)
    src, dst = power_law_dag(200, avg_degree=3, seed=3)
    _both(graphs, "add_nodes", 200)
    _both(graphs, "add_edges", src, dst)
    (jc, jids), (pc, pids) = _both(graphs, "run_wave_collect", [0], cap=8)
    assert jc == pc > 8
    np.testing.assert_array_equal(pids, jids)
    _same(jg, pg)


def test_bulk_invalid_update_matches_jax():
    """A mark batch larger than the packed mask uploads the host mask."""
    graphs = jg, pg = _pair(64, 64)
    _both(graphs, "add_nodes", 60)
    _both(graphs, "add_edges", np.arange(59, dtype=np.int32), np.arange(1, 60, dtype=np.int32))
    _both(graphs, "run_wave", [])  # builds the device copy
    _both(graphs, "mark_invalid", np.arange(0, 60, 2, dtype=np.int32))
    _same(jg, pg)
    assert _both(graphs, "run_wave", [1]) == (1, 1)  # 1 → 2 blocked (invalid)
    _same(jg, pg)


def test_from_numpy_state_round_trip():
    jg = JaxDeviceGraph(64, 64)
    src, dst = power_law_dag(300, avg_degree=3, seed=4)
    jg.add_nodes(300)
    jg.add_edges(src, dst)
    jg.bump_epochs(np.arange(10, 300, 7, dtype=np.int32))
    jg.mark_invalid(np.array([2, 3, 250], np.int32))
    pg = DeviceGraph.from_numpy_state({k: getattr(jg, k) for k in STATE_KEYS}, device="cpu")
    _same(jg, pg)
    jg._h_node_epoch[0] += 5  # the port holds its own copy
    assert pg._h_node_epoch[0] != jg._h_node_epoch[0]
    jg._h_node_epoch[0] -= 5
    graphs = (jg, pg)
    (jc, jids), (pc, pids) = _both(graphs, "run_wave_collect", [0, 1], cap=8192)
    assert jc == pc
    np.testing.assert_array_equal(pids, jids)
    _same(jg, pg)


def test_mirror_methods_name_their_slice(monkeypatch, tmp_path):
    """The lane chain, the super-round and the disk mirror cache (A.4/A.5)
    are ported: a chain dispatches and harvests, a super-round deeper than
    ``SUPER_DEPTH_MAX`` is refused, and a mirror build with
    ``FUSION_MIRROR_CACHE`` set saves instead of raising."""
    pg = DeviceGraph(device="cpu")
    pg.add_nodes(2)
    pg.add_edges([0], [1])
    monkeypatch.setenv("FUSION_MIRROR_CACHE", str(tmp_path))
    pg.build_topo_mirror()
    assert pg.mirror_cache_misses == 1
    pending = pg.dispatch_waves_lanes_chain([[[0]]])
    counts, masks = pg.harvest_waves_lanes_chain(pending)
    assert [c.tolist() for c in counts] == [[2]] and masks[0][:2].tolist() == [True, True]
    with pytest.raises(ValueError, match="SUPER_DEPTH_MAX"):
        pg.dispatch_waves_superround(np.zeros((65, 32, 1), np.int32), [1] * 65, {}, 1)
    pg._mirror_cache_writer.join(20)


def test_add_edges_rejects_ids_the_kernels_cannot_index():
    pg = DeviceGraph(16, 16, device="cpu")
    pg.add_nodes(4)
    with pytest.raises(ValueError, match="node ids"):
        pg.add_edges([0, -1], [1, 2])
    with pytest.raises(ValueError, match="node ids"):
        pg.add_edges([0], [pg.n_cap + 1])
    assert pg.n_edges == 0
