"""Parity of the live twin (``stl_fusion_tpu_torch/live_path.py``, the
blocking loop of ``perf/live_path.py``) with the same loop run through the
JAX package: 20,000 nodes, 3 rounds, 64 lane groups, 200 churn edges a
round (at this size 2,000 would overflow mirror rows every round and force
rebuilds; 200 patches in, as 2,000 do at 10M). The loop is one function;
``run_live(api=...)`` drives it through either package. Per round the
per-group counts, the rows refreshed and the invalid count before, the
table's stale set and values after the refresh and after the burst, and the
mirror's patch, rebuild and pass counts must be EQUAL, and so must the
lone waves' and the sequenced waves' results. Tolerance: exact."""
import jax.numpy as jnp
import numpy as np
import torch

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
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


def _run(api):
    rec = Recorder()
    record = run_live(**SHAPE, api=api, observer=rec)
    return record, rec.events


def test_live_twin_matches_jax_run_of_the_same_loop():
    jax_api = LiveApi(jcore, jgraph, {}, jnp.asarray, lambda: None, "stl_fusion_tpu (JAX)")
    want, want_events = _run(jax_api)
    got, got_events = _run(port_api("cpu"))
    assert [e[0] for e in got_events] == [e[0] for e in want_events]
    assert [e[0] for e in got_events].count("burst") == SHAPE["rounds"]
    for g, w in zip(got_events, want_events):
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=g[0])
            else:
                assert a == b, (g[0], a, b)
    for key in ("nodes", "edges", "mirror_levels", "live_wave_lat_served", "live_wave_seq_counts",
                "live_total_inv", "live_churn_edges", "mirror_patches", "mirror_rebuilds",
                "mirror_bursts"):
        assert got[key] == want[key], key
    for g, w in zip(got["rounds"], want["rounds"]):
        for key in ("refreshed", "newly", "patched", "rebuilds", "mirror_bursts", "passes",
                    "scalar_rows"):
            assert g[key] == w[key], (g["round"], key)
    # the churn patched into the mirror and every burst rode it
    assert got["mirror_patches"] >= SHAPE["rounds"]
    assert all(r["rebuilds"] == 0 and r["mirror_bursts"] == 1 for r in got["rounds"])
    assert got["live_total_inv"] > 0 and got["rounds"][1]["refreshed"] > 0
