"""Parity of the port's mirror patch path with the JAX package's: the cases
of ``tests/test_mirror_patch.py`` (the disk cache's round trip included) run the same op
sequence on a JAX ``DeviceGraph`` and on the port's, and every burst's count
and newly id set, the invalid masks and the counters ``mirror_patches``,
``mirror_rebuilds``, ``mirror_bursts``, ``lat_waves``, ``passes`` and
``n_viol`` must be identical; the JAX file's expected values are asserted on
the port too. Level-preserving adds and bump + recapture patch in place,
level violations cost extra passes (past 3 a background re-level starts,
past 8 the log breaks), in-degree overflow and post-build nodes break the
log. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import numpy as np
import pytest

from stl_fusion_tpu.graph.device_graph import DeviceGraph as JaxDeviceGraph
from stl_fusion_tpu_torch.graph import DeviceGraph

COUNTERS = ("mirror_patches", "mirror_rebuilds", "mirror_bursts", "lat_waves")


class Both:
    """The same calls on a JAX graph (``j``) and the port's (``p``)."""

    def __init__(self, node_capacity, edge_capacity):
        self.j = JaxDeviceGraph(node_capacity=node_capacity, edge_capacity=edge_capacity)
        self.p = DeviceGraph(node_capacity=node_capacity, edge_capacity=edge_capacity,
                             device="cpu")

    def __getattr__(self, name):
        def call(*args, **kw):
            return getattr(self.j, name)(*args, **kw), getattr(self.p, name)(*args, **kw)
        return call

    def mirror(self, key, default=None):
        """``key`` of both mirrors, required equal; the port's value."""
        jm, pm = self.j._topo_mirror, self.p._topo_mirror
        jv = None if jm is None else jm.get(key, default)
        pv = None if pm is None else pm.get(key, default)
        assert pv == jv, (key, pv, jv)
        return pv

    def same(self):
        for name in COUNTERS:
            assert getattr(self.p, name) == getattr(self.j, name), name
        self.mirror("passes", 1)
        self.mirror("n_viol", 0)
        assert (self.p._async_rebuild is None) == (self.j._async_rebuild is None)
        np.testing.assert_array_equal(self.p.invalid_mask(), self.j.invalid_mask())
        np.testing.assert_array_equal(self.p._h_invalid[: self.p.n_nodes],
                                      self.j._h_invalid[: self.j.n_nodes])

    def burst(self, seeds):
        (jc, jids), (pc, pids) = self.run_waves_union([seeds])
        assert int(pc) == int(jc)
        np.testing.assert_array_equal(np.sort(pids), np.sort(jids))
        self.same()
        return pc

    def add(self, src, dst):
        self.add_edges(np.asarray(src), np.asarray(dst))

    def join_rebuild(self):
        for g in (self.j, self.p):
            g._async_rebuild["thread"].join(30)


def chain(n=64, build=True):
    b = Both(n, 8 * n)
    b.add_nodes(n)
    b.add(np.arange(n - 1), np.arange(1, n))
    if build:
        b.build_topo_mirror()
    return b


def parallel_chains(n_nodes, chains, cap=128):
    """``chains`` (start, length) runs, each a chain, on one graph."""
    b = Both(cap, 512)
    b.add_nodes(n_nodes)
    for a, ln in chains:
        b.add(np.arange(a, a + ln - 1), np.arange(a + 1, a + ln))
    b.build_topo_mirror()
    return b


def test_level_preserving_edge_add_patches_in_place():
    b = chain()
    b.add([10], [50])
    assert b.burst([10]) == 54
    assert (b.p.mirror_patches, b.p.mirror_rebuilds, b.p.mirror_bursts) == (1, 1, 1)
    b.clear_invalid()
    assert b.burst([50]) == 14


def test_bump_and_recapture_patches_in_place():
    b = chain()
    b.bump_epochs(np.array([30]))
    b.add([29], [30])
    assert b.burst([0]) == 64
    assert (b.p.mirror_patches, b.p.mirror_rebuilds, b.p.mirror_bursts) == (1, 1, 1)


def test_bump_without_recapture_severs_edge():
    b = chain()
    b.bump_epochs(np.array([30]))
    assert b.burst([0]) == 30 and b.p.mirror_patches == 1


def test_level_violating_edge_patches_with_extra_pass():
    b = parallel_chains(64, [(0, 32), (32, 32)], cap=64)
    b.add([31], [33])
    assert b.burst([0]) == 63
    assert b.mirror("passes") == 2 and b.p.mirror_bursts == 1
    b.clear_invalid()
    jm, pm = b.build_topo_mirror()
    assert pm is b.p._topo_mirror and b.p.mirror_rebuilds == 1
    b.build_topo_mirror(force=True)
    assert b.p.mirror_rebuilds == 2 and b.mirror("passes", 1) == 1
    assert b.burst([0]) == 63 and b.p.mirror_bursts == 2


def test_violation_chain_needs_passes_and_self_maintains():
    b = parallel_chains(80, [(16 * c, 16) for c in range(5)])
    b.add([15], [17])
    b.add([31], [33])
    assert b.burst([0]) == 16 + 15 + 15 and b.mirror("passes") == 3
    b.clear_invalid()
    b.add([47], [49])
    assert b.burst([0]) == 16 + 15 + 15 + 15 and b.mirror("passes") == 4
    assert b.p._async_rebuild is None
    b.clear_invalid()
    b.add([15], [34])  # the fourth violation starts the background re-level
    c3 = b.burst([0])
    assert b.mirror("passes") == 5 and b.p._async_rebuild is not None
    b.join_rebuild()
    assert b.poll_topo_mirror_rebuild() == (True, True)
    assert b.mirror("passes", 1) == 1
    b.clear_invalid()
    assert b.burst([0]) == c3 and b.p.mirror_bursts == 4
    b.clear_invalid()
    for i in range(9):  # past the hard cap of 8: the log breaks, dense serves
        b.add([63], [64 + i])
    assert b.burst([0]) == c3 + 16 and b.p.mirror_bursts == 4


def test_in_degree_overflow_breaks():
    b = Both(32, 256)
    b.add_nodes(8)
    b.add([0, 1, 2, 3], [7, 7, 7, 7])
    b.build_topo_mirror()
    b.add([4, 5], [7, 7])  # the two slack columns absorb these
    assert b.burst([4]) == 2 and (b.p.mirror_patches, b.p.mirror_bursts) == (1, 1)
    b.clear_invalid()
    b.add([6], [7])  # no free slot left: the log breaks
    assert b.burst([6]) == 2 and b.p.mirror_bursts == 1


def test_post_build_node_edge_breaks():
    b = chain(16)
    b.add_nodes(1)
    b.add([15], [16])
    assert b.burst([0]) == 17 and b.p.mirror_bursts == 0
    assert b.p._topo_mirror["lat"] is None  # a broken log drops the lat mirror


def _backbone(n, rng, extras, cap=4):
    """Chain 0→…→n-1 (level(v) == v) plus random forward edges under an
    in-degree cap, as ``tests/test_mirror_patch.py::chain_backbone_graph``."""
    b = Both(n, 16 * n)
    b.add_nodes(n)
    b.add(np.arange(n - 1), np.arange(1, n))
    indeg = np.ones(n, dtype=np.int64)
    indeg[0] = 0
    added = 0
    while added < extras:
        v = int(rng.integers(1, n))
        if indeg[v] >= cap:
            continue
        b.add([int(rng.integers(0, v))], [v])
        indeg[v] += 1
        added += 1
    return b, indeg


def _churn(b, indeg, rng, n, adds, bumps, cap=4):
    for _ in range(adds):
        v = int(rng.integers(1, n))
        if indeg[v] >= cap:
            continue
        b.add([int(rng.integers(0, v))], [v])
        indeg[v] += 1
    for _ in range(bumps):
        v = int(rng.integers(1, n))
        b.bump_epochs(np.array([v]))
        u = int(rng.integers(0, v))
        srcs = [u, v - 1] if u != v - 1 else [v - 1]
        b.add(srcs, [v] * len(srcs))
        indeg[v] = len(srcs)


def test_patch_then_lane_burst_matches_jax():
    rng = np.random.default_rng(11)
    n = 120
    b, indeg = _backbone(n, rng, extras=100)
    b.build_topo_mirror()
    _churn(b, indeg, rng, n, adds=10, bumps=5)
    groups = [rng.choice(n, size=3, replace=False).tolist() for _ in range(33)]
    (jc, jmask), (pc, pmask) = b.run_waves_lanes(groups)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pmask, jmask)
    assert b.p.mirror_patches >= 1 and b.p.mirror_rebuilds == 1
    b.same()


def test_randomized_patch_equivalence_with_gated_state():
    rng = np.random.default_rng(7)
    n = 80
    b, indeg = _backbone(n, rng, extras=80)
    b.build_topo_mirror()
    for _ in range(6):
        _churn(b, indeg, rng, n, adds=3, bumps=2)
        b.burst(rng.choice(n, size=4, replace=False).tolist())
    assert b.p.mirror_rebuilds == 1 and b.p.mirror_bursts == 6


def test_async_rebuild_dissolves_violations_and_catches_up():
    b = parallel_chains(80, [(0, 32), (32, 32), (64, 16)])
    b.add([31], [33])
    assert b.burst([0]) == 63 and b.mirror("passes") == 2
    assert b.start_topo_mirror_rebuild() == (True, True)
    assert b.start_topo_mirror_rebuild() == (False, False)
    b.add([2], [68])  # recorded in the catch-up log
    b.join_rebuild()
    assert b.poll_topo_mirror_rebuild() == (True, True)
    assert b.p.mirror_rebuilds == 2
    b.clear_invalid()
    assert b.burst([0]) == 63 + 12
    assert b.mirror("n_viol", 0) == 0 and b.mirror("passes", 1) == 1
    b.clear_invalid()
    assert b.burst([70]) == 10 and b.p.mirror_bursts == 3


def test_async_rebuild_superseded_by_forced_rebuild_is_discarded():
    b = chain(32)
    assert b.start_topo_mirror_rebuild() == (True, True)
    b.join_rebuild()
    b.build_topo_mirror(force=True)
    rebuilds = b.p.mirror_rebuilds
    assert b.poll_topo_mirror_rebuild() == (False, False)
    assert b.p.mirror_rebuilds == rebuilds
    assert b.burst([0]) == 32 and b.p.mirror_bursts == 1


def test_async_rebuild_snapshots_the_epochs():
    """A bump after the rebuild started must not leak into the new lat
    mirror's slot epochs (the port's device epochs mutate in place, so the
    snapshot is a copy): the bumped node's old in-edge stays dead, its
    recaptured one live."""
    b = chain(32)
    for g in (b.j, b.p):
        g._topo_mirror["lat"] = None  # the rebuild builds a fresh lat
    assert b.start_topo_mirror_rebuild() == (True, True)
    b.bump_epochs(np.array([20]))  # 19 -> 20 dies
    b.join_rebuild()
    assert b.poll_topo_mirror_rebuild() == (True, True)
    assert b.burst([10]) == 10  # 10..19: the lat route stops at the dead edge
    b.clear_invalid()
    b.add([19], [20])  # recaptured at the new epoch
    assert b.burst([10]) == 22 and b.p.lat_waves == 2


def test_bump_recapture_retires_and_recounts_violations():
    b = parallel_chains(64, [(0, 32), (32, 32)], cap=64)
    b.add([31], [33])
    assert b.burst([0]) == 63 and b.mirror("passes") == 2
    for _ in range(6):
        b.clear_invalid()
        b.bump_epochs(np.array([33]))
        b.add([32, 31], [33, 33])
        assert b.burst([0]) == 63
        assert b.mirror("n_viol") == 1 and b.mirror("passes") == 2
    assert b.p.mirror_rebuilds == 1 and b.p.mirror_bursts == 7


def test_add_edges_delta_records_unpadded_batch():
    b = chain()
    b.device_arrays()
    assert b.p._mirror_deltas == b.j._mirror_deltas == []
    b.add([1, 2, 3], [10, 20, 30])
    assert len(b.p._mirror_deltas) == len(b.j._mirror_deltas) == 1
    for g in (b.j, b.p):
        kind, (src, dst, eps) = g._mirror_deltas[0]
        assert kind == "add"
        assert src.tolist() == [1, 2, 3] and dst.tolist() == [10, 20, 30]
        assert eps.tolist() == [0, 0, 0]
    b.bump_epochs(np.array([5, 5, 3]))
    for g in (b.j, b.p):
        kind, ids = g._mirror_deltas[1]
        assert kind == "bump" and ids.tolist() == [3, 5]


def test_aux_delta_logs_see_the_same_stream():
    b = chain(16, build=False)
    jlog, plog = b.register_aux_delta_log(cap=3)
    b.add([0], [5])
    b.bump_epochs(np.array([5]))
    assert [k for k, _ in plog["deltas"]] == [k for k, _ in jlog["deltas"]] == ["add", "bump"]
    b.add([1, 2], [6, 7])
    b.add([3], [8])  # past the cap: the log breaks and empties
    assert plog["broken"] and jlog["broken"] and plog["deltas"] == jlog["deltas"] == []
    b.j.drop_aux_delta_log(jlog)
    b.p.drop_aux_delta_log(plog)
    assert b.p._aux_delta_logs == b.j._aux_delta_logs == []


def test_lat_carried_across_forced_relevel_and_blocked_by_pending_deltas():
    """``tests/test_lat_union.py``'s two carry cases: a patched-current lat
    rides a forced re-level; a pending delta blocks the carry."""
    for patch_first in (True, False):
        b = chain()
        lat0 = b.p._topo_mirror["lat"]
        b.add([10], [50])
        if patch_first:
            jv, pv = b._mirror_valid()
            assert jv and pv
        b.build_topo_mirror(force=True)
        assert (b.p._topo_mirror["lat"] is lat0) == patch_first
        assert (b.j._topo_mirror["lat"] is not None) and b.burst([10]) == 54
        assert b.p.lat_waves == 1


def _wait_for(path_glob, tmp_path, timeout=20.0):
    """The entries matching ``path_glob`` under their final names, waited
    for: the JAX package's ``np.savez`` writes ``<path>.tmp.npz`` first and
    renames it when done, so a ``*.npz`` glob also sees the half-written
    file."""
    import time

    def landed():
        return [p for p in tmp_path.glob(path_glob) if not p.name.endswith(".tmp.npz")]

    deadline = time.time() + timeout
    while not landed() and time.time() < deadline:
        time.sleep(0.05)
    return landed()


def test_mirror_disk_cache_is_not_ported(monkeypatch, tmp_path):
    """The disk mirror cache is ported now: ``enable_program_cache`` sets
    ``FUSION_MIRROR_CACHE`` by default, as JAX's does, and a mirror build
    with it set saves an entry in the port's own format (never a ``.npz``
    the JAX package would read) instead of raising."""
    from stl_fusion_tpu_torch.graph import enable_program_cache

    monkeypatch.delenv("FUSION_MIRROR_CACHE", raising=False)
    info = enable_program_cache(str(tmp_path))
    assert info["mirror_cache_dir"] == str(tmp_path / "mirror")
    assert info["jax_cache_dir"] is None and info["enabled"]
    g = DeviceGraph(16, 64, device="cpu")
    g.add_nodes(4)
    g.add_edges(np.array([0, 1]), np.array([1, 2]))
    g.build_topo_mirror()
    assert g.mirror_cache_misses == 1 and g.mirror_cache_hits == 0
    g._mirror_cache_writer.join(20)
    saved = list((tmp_path / "mirror").iterdir())
    assert len(saved) == 1 and saved[0].name.endswith(DeviceGraph.MIRROR_CACHE_SUFFIX)
    assert not list((tmp_path / "mirror").glob("*.npz"))


def test_mirror_disk_cache_roundtrip(tmp_path, monkeypatch):
    """JAX's ``test_mirror_disk_cache_roundtrip``: a second graph over the
    same live edge set loads the built tables (a cache hit, no host build)
    and serves the same waves as the JAX package, and the loaded mirror
    still patches in place. Both packages share the cache root and never
    read each other's entries."""
    monkeypatch.setenv("FUSION_MIRROR_CACHE", str(tmp_path))
    n = 96
    src, dst = np.arange(n - 1), np.arange(1, n)

    def fresh():
        b = Both(n, 8 * n)
        b.add_nodes(n)
        b.add(src, dst)
        return b

    b1 = fresh()
    b1.build_topo_mirror()
    assert _wait_for("*.npz", tmp_path), "the JAX cache save did not land"
    assert _wait_for("*" + DeviceGraph.MIRROR_CACHE_SUFFIX, tmp_path), \
        "the port's cache save did not land"
    assert (b1.p.mirror_cache_misses, b1.p.mirror_cache_hits) == (1, 0)
    b2 = fresh()
    b2.build_topo_mirror()
    assert (b2.p.mirror_cache_hits, b2.j.mirror_cache_hits) == (1, 1)
    assert b2.p._topo_mirror["lat"] is not None
    assert b2.p._topo_mirror["level_starts"] == b1.p._topo_mirror["level_starts"]
    assert b1.burst([10]) == n - 10
    assert b2.burst([10]) == n - 10
    assert b2.p.lat_waves == 1  # the loaded lat mirror served the lone wave
    # a cache-loaded mirror still patches in place
    b2.add([5], [60])
    b2.clear_invalid()
    assert b2.burst([5]) == n - 5
    assert b2.p.mirror_patches == 1 and b2.p.mirror_rebuilds == 1
    # a corrupt entry is a miss, and is removed
    entry = next(tmp_path.glob("*" + DeviceGraph.MIRROR_CACHE_SUFFIX))
    entry.write_bytes(b"not a mirror")
    g = DeviceGraph(node_capacity=n, edge_capacity=8 * n, device="cpu")
    g.add_nodes(n)
    g.add_edges(src, dst)
    g.build_topo_mirror()
    assert (g.mirror_cache_hits, g.mirror_cache_misses) == (0, 1)
    assert g.run_waves_union([[10]])[0] == n - 10
