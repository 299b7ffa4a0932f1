"""Mesh execution: the logical-shard mesh, the sharded invalidation wave and
the bit-packed sharded wave (``PackedShardedGraph``: ``32*words`` waves per
pass, the mesh's lane bursts). Meshes across cards wait for ROADMAP A.10."""
from .mesh import GRAPH_AXIS, Mesh, graph_mesh
from .packed_wave import PackedShardedGraph, build_packed_sharded_wave
from .sharded_wave import ShardedDeviceGraph, ShardedGraphArrays, build_sharded_wave

__all__ = [
    "GRAPH_AXIS",
    "Mesh",
    "graph_mesh",
    "PackedShardedGraph",
    "ShardedDeviceGraph",
    "ShardedGraphArrays",
    "build_packed_sharded_wave",
    "build_sharded_wave",
]
