"""Parity of the port's asynchronous routed wave (``exchange_async``: the
speculative local levels of ``routed_level``'s ``spec`` form between
counted-quiescence merge epochs) with the JAX package's.

Each case runs one reference test of ``tests/test_async_wave.py`` (every
case but the three adaptive-pass ones, which ``tests/test_torch_lanes.py``
runs) through ``test_torch_edge.run_case``: the reference module on JAX's
virtual CPU devices, and its source on the port with the meshes made
logical shards on the CPU and the super-round stack's device loader made
torch. The reference's assertions hold on both, and every
``RoutedShardedGraph``'s ``stats()`` (merge epochs, ``spec_levels``,
quiescence checks, fallbacks) and final invalid rows must be EQUAL.
Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import pytest

from test_torch_edge import run_case
from test_torch_routed_wave import MESH, ROUTED

#: the reference's meshes as logical shards on the CPU, its loader torch
PATCHES = MESH + [
    ("graph_mesh(n_devices=6)", 'graph_mesh(devices=["cpu"] * 6)'),
    ("import jax.numpy as jnp\n", "import torch\n"),
    ("self._base_dev = jnp.asarray(self.base)", "self._base_dev = torch.from_numpy(self.base)"),
    ("TpuGraphBackend(\n        hub, ", 'TpuGraphBackend(\n        hub, device="cpu", '),
]

CASES = [
    "test_async_deep_chain_reclaims_barriers_strictly",
    "test_async_hier_plane_matches_host_bfs",
    "test_async_chain_dispatch_and_patch_stay_exact",
    "test_three_host_gather_fallback_keeps_async_exact",
    "test_tree_fallback_is_counted_not_silent",
    "test_pow2_tree_does_not_count_a_fallback",
    "test_straggler_shard_deep_chain_converges_exactly",
    "test_fault_mid_async_superround_is_contained",
    "test_clean_async_superround_matches_sync_superround",
    "test_level_stall_gauge_is_max_aggregated",
    "test_quiescence_counter_tracks_merge_epochs",
]


@pytest.mark.parametrize("test", CASES)
def test_async_case(test):
    run_case("test_async_wave", test, patches=PATCHES, recorded=ROUTED)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_async_matches_sync_and_host_bfs(depth):
    run_case("test_async_wave", "test_async_matches_sync_and_host_bfs", patches=PATCHES,
             recorded=ROUTED, depth=depth)
