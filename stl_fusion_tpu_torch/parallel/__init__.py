"""Mesh execution: the logical-shard mesh, the sharded invalidation wave,
the bit-packed sharded wave (``PackedShardedGraph``: ``32*words`` waves per
pass, the mesh's lane bursts) and the cluster-routed wave
(``RoutedShardedGraph``: CSR shards placed by the cluster shard map, the
frontier exchanged between shards each level). Meshes across cards wait for
ROADMAP A.10."""
from .mesh import GRAPH_AXIS, Mesh, graph_mesh
from .packed_wave import PackedShardedGraph, build_packed_sharded_wave
from .routed_wave import RoutedShardedGraph, build_routed_wave
from .sharded_wave import ShardedDeviceGraph, ShardedGraphArrays, build_sharded_wave

__all__ = [
    "GRAPH_AXIS",
    "Mesh",
    "graph_mesh",
    "PackedShardedGraph",
    "RoutedShardedGraph",
    "ShardedDeviceGraph",
    "ShardedGraphArrays",
    "build_packed_sharded_wave",
    "build_routed_wave",
    "build_sharded_wave",
]
