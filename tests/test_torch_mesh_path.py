"""Parity of the mesh twin (``stl_fusion_tpu_torch/mesh_path.py``, the twin
of ``perf/mesh_path.py``) with the same legs run through the JAX package:
the static leg at 100,000 nodes and 500 seeds a wave, the async A/B at
20,000 nodes and the live leg at the script's 20,000 rows with 4 latency
samples, on JAX's 8 virtual CPU devices and on 8 logical shards on the
CPU. Both runs must pass every gate of the script (no violation), and the
waves' totals and levels, the async A/B's levels and merge epochs, the
live leg's per-wave counts, shard moves, routed waves and fan-out relays
and the routed graphs' layout must be EQUAL. No timing is compared.
Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import stl_fusion_tpu.parallel as jparallel
from stl_fusion_tpu_torch.mesh_path import CUT, MeshApi, run_mesh

JAX_API = MeshApi("stl_fusion_tpu", lambda n: jparallel.graph_mesh(n_devices=n), {},
                  lambda: None, "stl_fusion_tpu (JAX)")
LEGS = dict(static=dict(n=100_000, seeds=500), async_ab=dict(n=20_000),
            live=dict(lat_samples=4), run_async=True)
#: the routed graph's keys its layout and its waves decide
LAYOUT = ("n_global", "e_cap", "bucket_cap", "hbucket_cap", "placement_epoch", "waves_run",
          "exchange_levels_total", "shard_moves", "cross_words_per_level")


def test_mesh_twin_matches_jax():
    want = run_mesh(api=JAX_API, **LEGS)
    got = run_mesh(device="cpu", **LEGS)
    assert want["violations"] == [] and got["violations"] == []
    assert got["ok"] and got["cut"] == list(CUT)
    for key in ("wave_totals", "wave_levels", "exchange_levels", "total_invalidated",
                "oracle_exact", "edges"):
        assert got["static"][key] == want["static"][key], key
    for key in ("sync_levels", "async_merge_epochs", "levels_reclaimed", "quiescence_checks",
                "spec_levels_total", "oracle_exact", "totals"):
        assert got["async_ab"][key] == want["async_ab"][key], key
    for key in ("wave_counts", "reshard_moves", "reshard_epoch", "routed_waves",
                "exchange_levels", "oracle_divergence", "external_client_fences",
                "mesh_member_relays", "dcn_fallback_relays"):
        assert got["live"][key] == want["live"][key], key
    for key in ("fused_dispatches", "eager_waves", "waves_submitted"):
        assert got["live"]["pipeline"][key] == want["live"]["pipeline"][key], key
    for leg in ("static", "live"):
        g = got[leg].get("stats") or got[leg]["routed_stats"]
        w = want[leg].get("stats") or want[leg]["routed_stats"]
        assert {k: g[k] for k in LAYOUT} == {k: w[k] for k in LAYOUT}, leg
    assert got["live"]["reshard_moves"] > 0 and got["async_ab"]["levels_reclaimed"] > 0
