"""Parity of the live twin (``stl_fusion_tpu_torch/live_path.py``: the
blocking loop of ``perf/live_path.py``, its super-round loop and its chain
loop) with the same loops run through the JAX package: 20,000 nodes, 3
rounds, 64 lane groups, 200 churn edges a round (at this size 2,000 would
overflow mirror rows every round and force rebuilds; 200 patches in, as
2,000 do at 10M). The loop is one function; ``run_live(api=...)`` drives it
through either package. Blocking: per round the per-group counts, the rows
refreshed and the invalid count before, the table's stale set and values
after the refresh and after the burst, and the mirror's patch, rebuild and
pass counts must be EQUAL, and so must the lone waves' and the sequenced
waves' results. Nonblocking: per harvested super-round the per-round
counts, the stale set, the values and the host invalid mirror, and the
loop's totals and counters must be EQUAL. Both runs end with the restore
leg (``LIVE_RESTORE``: ``save_graph`` of the live graph, ``load_graph`` of
the snapshot), whose snapshot bytes must be EQUAL too. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stl_fusion_tpu.checkpoint as jckpt
import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
from stl_fusion_tpu_torch.checkpoint import load_graph
from stl_fusion_tpu_torch.live_path import LiveApi, port_api, run_live

SHAPE = dict(n_nodes=20_000, rounds=3, lane_groups=64, edge_churn=200, lat_waves=8)


def _values(table):
    v = table.values
    return np.array(v.cpu() if isinstance(v, torch.Tensor) else v)


class Recorder:
    """Everything the loop exposes, per event, as numpy."""

    def __init__(self):
        self.events = []

    def after_warm(self, ctx):
        self.events.append(("warm", _values(ctx["table"]), ctx["table"].stale_count()))

    def after_seq(self, ctx, batches, counts):
        self.events.append(("seq", batches, np.asarray(counts)))

    def after_refresh(self, ctx, rnd, refreshed, invalid_before):
        t = ctx["table"]
        self.events.append(("refresh", rnd, int(refreshed), invalid_before,
                            t._stale_host.copy(), _values(t)))

    def after_burst(self, ctx, rnd, group_ids, counts, stats):
        t, g = ctx["table"], ctx["backend"].graph
        self.events.append(("burst", rnd, np.asarray(counts), t._stale_host.copy(),
                            t.stale_count(), g._h_invalid[: g.n_nodes].copy(), stats))


    def before_dispatch(self, ctx, mode, k, group_ids):
        t = ctx["table"]
        self.events.append(("dispatch", mode, k, t._stale_host.copy(), _values(t)))

    def after_harvest(self, ctx, mode, per_burst):
        t, g = ctx["table"], ctx["backend"].graph
        self.events.append(("harvest", mode, [np.asarray(c) for c in per_burst],
                            t._stale_host.copy(), t.stale_count(), _values(t),
                            g._h_invalid[: g.n_nodes].copy()))


def _run(api, **kw):
    rec = Recorder()
    record = run_live(**SHAPE, api=api, observer=rec, **kw)
    return record, rec.events


def _same_events(got_events, want_events):
    assert [e[0] for e in got_events] == [e[0] for e in want_events]
    for g, w in zip(got_events, want_events):
        for a, b in zip(g, w):
            if isinstance(b, list):
                assert len(a) == len(b), g[0]
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y, err_msg=g[0])
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=g[0])
            else:
                assert a == b, (g[0], a, b)


JAX_API = LiveApi(jcore, jgraph, {}, jnp.asarray, lambda: None, "stl_fusion_tpu (JAX)", jckpt)


def test_live_twin_matches_jax_run_of_the_same_loop():
    want, want_events = _run(JAX_API, nonblocking=False)
    got, got_events = _run(port_api("cpu"), nonblocking=False)
    assert [e[0] for e in got_events].count("burst") == SHAPE["rounds"]
    _same_events(got_events, want_events)
    for key in ("nodes", "edges", "mirror_levels", "live_wave_lat_served", "live_wave_seq_counts",
                "live_total_inv", "live_churn_edges", "mirror_patches", "mirror_rebuilds",
                "mirror_bursts", "snapshot_bytes"):
        assert got[key] == want[key], key
    # the restore leg ran through both packages
    assert got["snapshot_bytes"] > 0 and got["restore_s"] is not None
    assert want["restore_s"] is not None
    for g, w in zip(got["rounds"], want["rounds"]):
        for key in ("refreshed", "newly", "patched", "rebuilds", "mirror_bursts", "passes",
                    "scalar_rows"):
            assert g[key] == w[key], (g["round"], key)
    # the churn patched into the mirror and every burst rode it
    assert got["mirror_patches"] >= SHAPE["rounds"]
    assert all(r["rebuilds"] == 0 and r["mirror_bursts"] == 1 for r in got["rounds"])
    assert got["live_total_inv"] > 0 and got["rounds"][1]["refreshed"] > 0


@pytest.mark.parametrize("super_rounds", [True, False])
def test_nonblocking_live_twin_matches_jax(super_rounds):
    """``LIVE_NONBLOCKING=1`` with ``LIVE_SUPER_ROUNDS`` on (the default) and
    off, at ``LIVE_FUSE_DEPTH=3``: the warm super-round, then one
    super-round of all 3 rounds, through both packages."""
    want, want_events = _run(JAX_API, super_rounds=super_rounds)
    got, got_events = _run(port_api("cpu"), super_rounds=super_rounds)
    assert got["live_mode"] == ("superround" if super_rounds else "chain")
    assert [e[0] for e in got_events].count("harvest") == 1
    _same_events(got_events, want_events)
    for key in ("live_total_inv", "live_fused_chain_dispatches", "live_eager_fallback_rounds",
                "live_churn_edges", "churn_rows_recomputed", "mirror_patches",
                "mirror_rebuilds", "mirror_bursts", "live_superround", "live_fuse_depth"):
        assert got[key] == want[key], key
    assert got["live_eager_fallback_rounds"] == 0 and got["live_fused_chain_dispatches"] == 1
    assert got["live_total_inv"] > 0
    if super_rounds:
        for key in ("live_superround_dispatches", "live_superround_eager_rounds",
                    "live_superround_faults", "live_superround_restages",
                    "live_superround_forced_harvests"):
            assert got[key] == want[key], key
        assert got["superround_programs"]["uncaptured"] == 0


def test_live_loops_run_one_after_another_on_one_stack(tmp_path):
    """``loops``: the blocking, super-round and chain loops on one built
    stack (``chip_smoke.py``'s ``live_sr_10m`` runs this shape at 10M
    rows): each loop reports its mode and lights rows, and no nonblocking
    round falls back to the eager path. The restore leg leaves its
    snapshot at ``snapshot_path`` (``write_10m`` loads it), and it loads
    with the live graph's counts."""
    path = str(tmp_path / "graph.npz")
    rec = run_live(**SHAPE, device="cpu", snapshot_path=path,
                   loops=[("blocking", 2), ("superround", 3), ("chain", 3)])
    assert os.path.getsize(path) == rec["snapshot_bytes"]
    restored = load_graph(path, device="cpu")
    assert (restored.n_nodes, int(restored.n_edges)) == (rec["nodes"], rec["edges"])
    modes = [r["live_mode"] for r in rec["loops"]]
    assert modes == ["blocking", "superround", "chain"]
    assert rec["live_mode"] == "blocking" and rec["loops"][0]["live_rounds"] == 2
    assert all(r["live_total_inv"] > 0 for r in rec["loops"])
    assert rec["loops"][1]["live_superround_eager_rounds"] == 0
    assert rec["loops"][1]["live_superround_dispatches"] == 1
    assert rec["loops"][2]["live_eager_fallback_rounds"] == 0
    assert set(rec["cold_start"]["programs"]) == {"superround", "chain"}


def test_live_async_twin_matches_jax():
    """``LIVE_ASYNC=1``: the super-round loop's sweeps run adaptively (a
    device-side fixed point, counted stages), then the stall microbench
    (the fixed pass count against the adaptive sweep) records
    ``fusion_mesh_level_stall_ms``; through both packages."""
    want, want_events = _run(JAX_API, live_async=True)
    got, got_events = _run(port_api("cpu"), live_async=True)
    _same_events(got_events, want_events)
    for key in ("live_total_inv", "live_fused_chain_dispatches", "live_eager_fallback_rounds",
                "mirror_patches", "mirror_rebuilds", "live_async", "live_adaptive_stages"):
        assert got[key] == want[key], key
    assert got["live_async"] and got["live_adaptive_stages"] > 0
    assert got["live_level_stall_ms"] is not None and got["live_level_stall_ms"] >= 0
    assert not any("LIVE_ASYNC" in c for c in got["cut"])
