"""Parity of the port's resident super-rounds (``graph/superround.py``, and
``ops/topo_wave.py::topo_mirror_superround_step`` under it) with the JAX
package's: the cases of ``tests/test_superround.py`` on the single-device
lanes route, each run as one scenario through both packages on the same
numpy-made DAG (``power_law_dag(800, 3, seed=7)``, a table-backed service
with a device loader) and the same seeded bursts, with JAX's assertions
held on both and the results required EQUAL: per-group counts, per-round
fence sets (the ``newly_hooks`` stream), invalid masks, table values,
validity and staleness. A super-round of K rounds must also equal K
sequential ``cascade_rows_lanes`` + ``refresh_block_on_device`` pairs of
the same package. On the CPU every program runs its plain composition (the
card's CUDA graph capture is held by ``tests/test_torch_gpu.py``). The
routed-mesh super-round (``test_routed_superround_zero_host_relay_reentries``)
runs on JAX's 8 virtual CPU devices and on 8 logical shards on the CPU, its
per-round counts, fences and final state EQUAL. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.graph as pgraph
from stl_fusion_tpu.diagnostics import global_metrics as jax_metrics
from stl_fusion_tpu.graph.synthetic import power_law_dag
from stl_fusion_tpu.ops import topo_wave as jtw
from stl_fusion_tpu_torch.diagnostics.metrics import global_metrics as port_metrics
from stl_fusion_tpu_torch.graph import device_graph as pdg
from stl_fusion_tpu_torch.graph import program_cache as ppc
from stl_fusion_tpu_torch.ops import topo_wave as ptw
from stl_fusion_tpu_torch.ops.bitops import pack_mask_host, unpack_words_host

N = 800
SRC, DST = power_law_dag(N, avg_degree=3, seed=7)

JAX = ("jax", jcore, jgraph, {}, jnp.asarray)
PORT = ("port", pcore, pgraph, {"device": "cpu"}, lambda a: torch.from_numpy(np.asarray(a)))


def make_stack(pkg):
    """``tests/test_superround.py``'s stack through one package."""
    _name, core, graph, kw, to_dev = pkg

    class Dag(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.base = np.arange(N, dtype=np.float32)
            self._base_dev = None

        def load(self, ids):
            return self.base[np.asarray(ids, dtype=np.int64)]

        def load_dev(self, ids, base_dev):
            return base_dev[ids]

        def load_dev_args(self):
            if self._base_dev is None:
                self._base_dev = to_dev(self.base)
            return (self._base_dev,)

        @core.compute_method(table=core.TableBacking(
            rows=N, batch="load", device_batch="load_dev", device_args="load_dev_args"))
        async def node(self, i: int) -> float:
            return float(self.base[i])

    hub = core.FusionHub()
    backend = graph.TpuGraphBackend(hub, node_capacity=N + 8, edge_capacity=len(SRC) + 512, **kw)
    svc = Dag(hub)
    hub.add_service(svc, "dag")
    table = core.memo_table_of(svc.node)
    block = backend.bind_table_rows(table)
    backend.declare_row_edges(block, SRC, block, DST)
    backend.warm_block_on_device(block)
    backend.flush()
    backend.graph.build_topo_mirror()
    return hub, backend, svc, table, block


def round_bursts(k, groups=4, seeds=3, rng=None):
    rng = rng if rng is not None else np.random.default_rng(20260804)
    return [[rng.choice(N, size=seeds, replace=False).tolist() for _ in range(groups)]
            for _ in range(k)]


def fence_collector(backend):
    """Every wave application's (seq, newly-set)."""
    seen = []

    def hook(newly):
        if isinstance(newly, np.ndarray) and newly.dtype == np.bool_:
            ids = frozenset(np.nonzero(newly)[0].tolist())
        else:
            ids = frozenset(int(i) for i in newly)
        if ids:
            seen.append((backend.last_wave_seq, ids))

    backend.newly_hooks.append(hook)
    return seen


def values(table):
    v = table._values
    return np.array(v.cpu() if isinstance(v, torch.Tensor) else v)


def valid(table):
    v = table.valid_mask
    return np.array(v.cpu() if isinstance(v, torch.Tensor) else v)


def state(backend, table):
    return {"invalid": np.asarray(backend.graph.invalid_mask()), "values": values(table),
            "valid": valid(table), "stale": table._stale_host.copy(),
            "stale_count": table.stale_count()}


def same(got, want):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, list) and w and isinstance(w[0], np.ndarray):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=key)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, (key, g, w)


def both(scenario, *args):
    """The scenario through JAX, then through the port; results EQUAL."""
    want, got = scenario(JAX, *args), scenario(PORT, *args)
    same(got, want)
    return got


def sequential(pkg, bursts):
    """The twin: one ``cascade_rows_lanes`` + ``refresh_block_on_device``
    pair per round."""
    core = pkg[1]
    hub, b, _s, table, blk = make_stack(pkg)
    old = core.set_default_hub(hub)
    try:
        fences = fence_collector(b)
        counts = []
        for groups in bursts:
            counts.append(b.cascade_rows_lanes(blk, groups))
            b.refresh_block_on_device(blk)
        return counts, [ids for _seq, ids in fences], state(b, table)
    finally:
        core.set_default_hub(old)


# ---------------------------------------------------------------- the op
def test_superround_step_matches_jax_op():
    """``topo_mirror_superround_step`` on one mirror: the same graph, invalid
    state, values, validity, loader table and K=3 seed tensors through JAX's
    ``lax.scan`` and the port's plain rounds; the outputs and the port's
    in-place state EQUAL JAX's returned state."""
    rng = np.random.default_rng(4)
    n_tot_nodes, base, n_rows = N, 0, N
    topo_j = jtw.build_topo_graph(SRC, DST, n_tot_nodes, k=4, slack=2)
    topo_p = ptw.build_topo_graph(SRC, DST, n_tot_nodes, k=4, slack=2)
    np.testing.assert_array_equal(topo_p.in_src, topo_j.in_src)
    n_tot = topo_j.n_tot
    n_cap = 1024
    invalid = np.zeros(n_cap + 1, bool)
    invalid[rng.choice(N, 40, replace=False)] = True
    vals = rng.integers(-50, 50, size=N).astype(np.float32)
    fresh = rng.integers(100, 200, size=N).astype(np.float32)
    val = rng.random(N) < 0.5
    words = 2
    mats = np.full((3, 32 * words, 4), n_tot, np.int32)
    for d in range(3):
        for lane in range(40):
            ids = rng.choice(N, 3, replace=False)
            mats[d, lane, :3] = topo_j.inv_perm[ids]
    perm_clipped = np.clip(topo_j.perm, 0, n_cap).astype(np.int32)
    for update_valid in (True, False):
        gj = jtw.topo_graph_arrays(topo_j)
        ne0 = jnp.zeros(n_tot + 1, jnp.int32).at[n_tot].set(-2)
        prog = jtw.topo_mirror_superround_step(topo_j.level_starts, n_tot, words, 1, base,
                                               n_rows, lambda ids, f: f[ids], update_valid)
        inv_j, vals_j, valid_j, lc_j, pk_j = jax.device_get(prog(
            jnp.asarray(vals), jnp.asarray(val), gj, ne0, jnp.asarray(perm_clipped),
            jnp.asarray(invalid), jnp.asarray(mats), jnp.asarray(fresh)))
        gp = ptw.topo_graph_arrays(topo_p, "cpu")
        ne0p = torch.zeros(n_tot + 1, dtype=torch.int32)
        ne0p[n_tot] = -2
        words_t = torch.from_numpy(pack_mask_host(invalid))
        vals_t, valid_t = torch.from_numpy(vals.copy()), torch.from_numpy(val.copy())
        step = ptw.topo_mirror_superround_step(topo_p.level_starts, n_tot, words, 1, base,
                                               n_rows, lambda ids, f: f[ids], update_valid)
        out = step(vals_t, valid_t, gp, ne0p, torch.from_numpy(perm_clipped), words_t,
                   torch.from_numpy(mats), torch.from_numpy(fresh))
        assert out[0] is words_t and out[1] is vals_t and out[2] is valid_t  # in place
        np.testing.assert_array_equal(out[3].numpy(), lc_j)
        np.testing.assert_array_equal(out[4].numpy().view(np.uint32), pk_j)
        np.testing.assert_array_equal(unpack_words_host(words_t.numpy(), n_cap + 1), inv_j)
        np.testing.assert_array_equal(vals_t.numpy(), vals_j)
        np.testing.assert_array_equal(valid_t.numpy(), valid_j)
        assert lc_j.sum() > 0
        assert np.array_equal(valid_j, val) != update_valid  # validity moved iff updated


# ---------------------------------------------------------------- oracle
@pytest.mark.parametrize("k", [1, 2, 4])
def test_superround_matches_sequential_rounds(k):
    """super-round(depth K) ≡ K sequential (burst → refresh) pairs, in each
    package and across them: counts, invalid masks, memo columns, fence
    sets, and each round under its own seq; the profiler record carries the
    fused identity."""
    bursts = round_bursts(k)

    def scenario(pkg):
        core = pkg[1]
        hub, b, _s, table, blk = make_stack(pkg)
        old = core.set_default_hub(hub)
        try:
            fences = fence_collector(b)
            prog = b.enable_super_rounds(blk, depth=k)
            ticket = prog.dispatch(prog.stage(bursts))
            per_burst = ticket.harvest()
            assert prog.superrounds_dispatched == 1
            assert prog.eager_rounds == 0 and prog.faults == 0
            seq_counts, seq_fences, seq_state = sequential(pkg, bursts)
            assert [c.tolist() for c in per_burst] == [c.tolist() for c in seq_counts]
            same(state(b, table), seq_state)
            assert [ids for _seq, ids in fences] == seq_fences
            seqs = [seq for seq, _ids in fences]
            assert seqs == sorted(seqs)
            assert len(set(seqs)) == sum(1 for c in per_burst if int(c.sum()))
            rec = [r for r in b.profiler._ring if r["kind"] == "superround"][-1]
            assert rec["fused_depth"] == k and rec["dispatches"] == 1
            assert rec["seq_span"][1] - rec["seq_span"][0] == k - 1
            return {"counts": list(per_burst), "fences": [ids for _seq, ids in fences],
                    "cleared": prog.cleared_total, **state(b, table)}
        finally:
            core.set_default_hub(old)

    both(scenario)


def test_double_buffered_staging_overlaps_inflight_superround():
    """stage() for super-round N+1 runs while N is in flight; dispatch(N+1)
    harvests N; the state equals the sequential twin across both."""
    r1 = round_bursts(2, rng=np.random.default_rng(1))
    r2 = round_bursts(2, rng=np.random.default_rng(2))

    def scenario(pkg):
        core = pkg[1]
        hub, b, _s, table, blk = make_stack(pkg)
        old = core.set_default_hub(hub)
        try:
            prog = b.enable_super_rounds(blk, depth=2)
            t1 = prog.dispatch(prog.stage(r1))
            assert len(prog._inflight) == 1 and not t1.done
            staged2 = prog.stage(r2)  # packed with t1 still in flight
            t2 = prog.dispatch(staged2)  # harvests t1 (MAX_INFLIGHT=1)
            assert t1.done and not t2.done
            prog.drain()
            assert t2.done and prog.harvests == 2
            assert prog.occupancy() >= 0.0 and prog.stats()["wall_s"] > 0
            got = [c for t in (t1, t2) for c in t.per_burst]
            seq_counts, _f, seq_state = sequential(pkg, r1 + r2)
            assert [c.tolist() for c in got] == [c.tolist() for c in seq_counts]
            np.testing.assert_array_equal(values(table), seq_state["values"])
            return {"counts": got, **state(b, table)}
        finally:
            core.set_default_hub(old)

    both(scenario)


def test_journal_entry_with_inflight_superround_forces_harvest():
    """A journal entry between dispatches forces the in-flight harvest
    BEFORE flush — counted — and the host-led invalidation still lands."""

    def scenario(pkg):
        core = pkg[1]
        hub, b, _svc, table, blk = make_stack(pkg)
        old = core.set_default_hub(hub)
        try:
            prog = b.enable_super_rounds(blk, depth=2)
            t1 = prog.dispatch(prog.stage(round_bursts(2)))
            table.invalidate([int(N - 1)])  # journals an icasc while in flight
            t2 = prog.dispatch(prog.stage(round_bursts(2, rng=np.random.default_rng(9))))
            assert prog.journal_forced_harvests == 1
            assert t1.done
            prog.drain()
            assert t2.done
            assert not b.graph._h_invalid[blk.base: blk.end()].any()
            assert table.stale_count() == 0
            assert float(values(table)[N - 1]) == float(N - 1)
            return {"counts": t1.per_burst + t2.per_burst, **state(b, table)}
        finally:
            core.set_default_hub(old)

    both(scenario)


def test_relevel_between_stage_and_dispatch_restages():
    """A mirror rebuild after stage() re-permutes NEW ids: dispatch re-packs
    the buffer (counted), never dispatching the stale ids."""
    bursts = round_bursts(1)

    def scenario(pkg):
        core = pkg[1]
        hub, b, _svc, table, blk = make_stack(pkg)
        old = core.set_default_hub(hub)
        try:
            prog = b.enable_super_rounds(blk, depth=1)
            staged = prog.stage(bursts)
            b.graph.build_topo_mirror(force=True)  # re-level: new inv_perm
            per_burst = prog.dispatch(staged).harvest()
            assert prog.restages == 1 and prog.eager_rounds == 0
            seq_counts, _f, _st = sequential(pkg, bursts)
            assert per_burst[0].tolist() == seq_counts[0].tolist()
            return {"counts": per_burst, **state(b, table)}
        finally:
            core.set_default_hub(old)

    both(scenario)


# ---------------------------------------------------------------- faults
def test_harvest_fault_contained_and_values_stay_truth(monkeypatch):
    """A fault in the readback half: the half-run chain cleared block bits
    in program, so containment re-stales and refreshes the block, and the
    rounds re-run on the counted eager path; values stay truth."""
    bursts = round_bursts(2, rng=np.random.default_rng(6))

    def scenario(pkg):
        core = pkg[1]
        hub, b, _svc, table, blk = make_stack(pkg)
        old = core.set_default_hub(hub)
        try:
            prog = b.enable_super_rounds(blk, depth=2)
            ticket = prog.dispatch(prog.stage(bursts))
            arm = {"on": True}
            if pkg is JAX:
                real, owner, name = jax.device_get, jax, "device_get"
            else:
                real, owner, name = pdg.fetch_outputs, pdg, "fetch_outputs"

            def flaky(x):
                if arm.pop("on", None):
                    raise RuntimeError("injected harvest fault")
                return real(x)

            monkeypatch.setattr(owner, name, flaky)
            per_burst = ticket.harvest()  # contained, never raises
            monkeypatch.setattr(owner, name, real)
            assert ticket.fallback and prog.faults == 1 and prog.eager_rounds == 2
            _c, _f, seq_state = sequential(pkg, bursts)
            np.testing.assert_array_equal(values(table), seq_state["values"])
            np.testing.assert_array_equal(np.asarray(b.graph.invalid_mask()), seq_state["invalid"])
            assert len(per_burst) == 2
            return {"counts": per_burst, **state(b, table)}
        finally:
            core.set_default_hub(old)

    both(scenario)


def test_mid_superround_fault_falls_back_to_counted_eager_path():
    """The watchdog's ``inject_fault_next`` at dispatch: the fault is
    contained (the block re-staled and refreshed, the rounds re-run on the
    counted eager path under the pre-minted seqs, the watchdog degraded),
    and the final set and values equal the sequential twin's."""
    bursts = round_bursts(3, rng=np.random.default_rng(5))

    def scenario(pkg):
        core = pkg[1]
        resilience = importlib.import_module(f"{core.__name__.split('.')[0]}.resilience")
        hub, b, _svc, table, blk = make_stack(pkg)
        old = core.set_default_hub(hub)
        try:
            wd = b.attach_watchdog(resilience.WaveWatchdog(recovery_bursts=1))
            prog = b.enable_super_rounds(blk, depth=3)
            wd.inject_fault_next()
            ticket = prog.dispatch(prog.stage(bursts))
            assert ticket.done and ticket.fallback
            assert prog.faults == 1 and prog.eager_rounds == 3
            assert wd.faults == 1
            _c, _f, seq_state = sequential(pkg, bursts)
            np.testing.assert_array_equal(np.asarray(b.graph.invalid_mask()),
                                          seq_state["invalid"])
            np.testing.assert_array_equal(values(table), seq_state["values"])
            assert table.stale_count() == seq_state["stale_count"]
            return {"counts": ticket.per_burst, **state(b, table), **wd.snapshot()}
        finally:
            core.set_default_hub(old)

    both(scenario)


def test_capture_failure_takes_the_counted_eager_path(monkeypatch):
    """A program that cannot be captured (``ChainProgram.dispatch`` raising
    ``NotFusible``, as a failed CUDA graph capture does) takes JAX's
    counted eager path: every round counted in ``eager_rounds``, the
    results those of the sequential pairs."""
    bursts = round_bursts(3, rng=np.random.default_rng(12))

    def refuse(self, *a, **kw):
        raise ppc.NotFusible("chain program capture failed: injected")

    monkeypatch.setattr(ppc.ChainProgram, "dispatch", refuse)
    hub, b, _svc, table, blk = make_stack(PORT)
    old = pcore.set_default_hub(hub)
    try:
        prog = b.enable_super_rounds(blk, depth=3)
        ticket = prog.dispatch(prog.stage(bursts))
        assert ticket.done and ticket.fallback
        assert prog.eager_rounds == 3 and prog.faults == 0 and prog.superrounds_dispatched == 0
        counts, _f, seq_state = sequential(PORT, bursts)
        assert [c.tolist() for c in ticket.per_burst] == [c.tolist() for c in counts]
        same(state(b, table), seq_state)
    finally:
        pcore.set_default_hub(old)


# ---------------------------------------------------------------- barrier
def test_drain_barrier_and_pipeline_drain_cover_superrounds():
    """drain() resolves everything in flight; WavePipeline.drain() covers
    the super-round plane too."""

    def scenario(pkg):
        core, graph = pkg[1], pkg[2]
        hub, b, _svc, table, blk = make_stack(pkg)
        old = core.set_default_hub(hub)
        try:
            prog = b.enable_super_rounds(blk, depth=2)
            t = prog.dispatch(prog.stage(round_bursts(2)))
            assert not t.done
            assert prog.drain() == 1 and t.done and len(prog._inflight) == 0
            pipe = graph.WavePipeline(b, fuse_depth=4)
            t2 = prog.dispatch(prog.stage(round_bursts(2, rng=np.random.default_rng(3))))
            assert not t2.done
            pipe.drain()  # the one barrier covers both planes
            assert t2.done and len(prog._inflight) == 0
            pipe.dispose()
            return {"counts": t.per_burst + t2.per_burst, **state(b, table)}
        finally:
            core.set_default_hub(old)

    both(scenario)


def test_superround_metrics_exported():
    import gc

    def scenario(pkg):
        core = pkg[1]
        metrics = jax_metrics if pkg is JAX else port_metrics
        gc.collect()  # drop other tests' weak-registered collectors
        hub, b, _svc, table, blk = make_stack(pkg)
        old = core.set_default_hub(hub)
        try:
            prog = b.enable_super_rounds(blk, depth=2)
            before = dict(metrics()._collect())
            prog.dispatch(prog.stage(round_bursts(2)))
            prog.drain()
            collected = metrics()._collect()

            def delta(name):
                return collected.get(name, 0) - before.get(name, 0)

            out = {name: delta(name) for name in (
                "fusion_superround_dispatches_total", "fusion_superround_rounds_total",
                "fusion_superround_eager_rounds_total", "fusion_superround_faults_total")}
            assert out["fusion_superround_dispatches_total"] == 1
            assert out["fusion_superround_rounds_total"] == 2
            assert out["fusion_superround_eager_rounds_total"] == 0
            assert "fusion_superround_occupancy" in collected
            assert "fusion_superround_host_stall_ms" in collected
            prog.dispose()
            assert b.super_rounds is None
            return out
        finally:
            core.set_default_hub(old)

    both(scenario)


def test_routed_superround_raises_naming_its_slice():
    """The routed branch (mesh mode) is ported: with routing on and the
    routed mirror built, the back buffer packs through the mirror's row
    permutation (it deferred to the dispatch before the mirror existed)."""
    from stl_fusion_tpu_torch.cluster import ShardMap
    from stl_fusion_tpu_torch.graph.superround import StagedSeeds
    from stl_fusion_tpu_torch.parallel import graph_mesh

    hub, b, _svc, _table, blk = make_stack(PORT)
    b.enable_mesh_routing(ShardMap.initial(["m0", "m1"], n_shards=32),
                          mesh=graph_mesh(devices=["cpu"] * 8))
    prog = b.enable_super_rounds(blk, depth=1)
    staged = StagedSeeds([[[0, 5]]], [[0, 5]], [1], routed=True)
    prog._pack_routed(staged)
    assert staged.routed_staged is None  # no routed mirror yet
    graph = b.routed_mirror()["graph"]
    prog._pack_routed(staged)
    assert staged.routed_staged["stages"] == 1
    assert staged.routed_staged["mat"][0, :2].tolist() == graph.perm[[0, 5]].tolist()
    with pytest.raises(ValueError, match="already"):
        b.enable_super_rounds(blk)


# ---------------------------------------------------------------- routed mesh
def routed_superround(pkg):
    """``tests/test_superround.py::test_routed_superround_zero_host_relay_reentries``
    through one package: 2 rounds of 2 groups in ONE routed chain dispatch,
    equal to one union wave a round on the single-device twin."""
    name, core = pkg[0], pkg[1]
    cluster = importlib.import_module(f"{core.__name__.rsplit('.', 1)[0]}.cluster")
    parallel = importlib.import_module(f"{core.__name__.rsplit('.', 1)[0]}.parallel")
    mesh = parallel.graph_mesh() if name == "jax" else parallel.graph_mesh(devices=["cpu"] * 8)
    bursts = round_bursts(2, groups=2, rng=np.random.default_rng(11))
    hub_a, b_a, _s, table_a, blk_a = make_stack(pkg)
    old = core.set_default_hub(hub_a)
    try:
        fences = fence_collector(b_a)
        b_a.enable_mesh_routing(cluster.ShardMap.initial(["m0", "m1"], n_shards=32), mesh=mesh)
        prog = b_a.enable_super_rounds(blk_a, depth=2)
        ticket = prog.dispatch(prog.stage(bursts))
        prog.drain()
        got = [int(c.sum()) for c in ticket.per_burst]
        assert prog.superrounds_dispatched == 1
        assert prog.eager_rounds == 0 and prog.faults == 0
        routed_graph = b_a._routed_mirror["graph"]
        assert routed_graph.waves_run >= 2
        assert ticket.routed_pending["dispatches"] == 1
        out = {"counts": got, "fences": [ids for _seq, ids in fences],
               "stats": {k: v for k, v in routed_graph.stats().items()}, **state(b_a, table_a)}
        assert table_a.stale_count() == 0
    finally:
        core.set_default_hub(old)
    hub_b, b_b, _s2, table_b, blk_b = make_stack(pkg)
    old = core.set_default_hub(hub_b)
    try:
        want = []
        for groups in bursts:
            want.append(b_b.cascade_rows_batch(blk_b, sorted({x for g in groups for x in g})))
        b_b.refresh_block_on_device(blk_b)
        assert got == want
        same({k: out[k] for k in ("invalid", "values")},
             {"invalid": np.asarray(b_b.graph.invalid_mask()), "values": values(table_b)})
    finally:
        core.set_default_hub(old)
    return out


def test_routed_superround_zero_host_relay_reentries():
    both(routed_superround)
