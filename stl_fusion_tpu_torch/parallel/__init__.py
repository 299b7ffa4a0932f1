"""Mesh execution: the logical-shard mesh and the sharded invalidation wave.

``PackedShardedGraph`` (``packed_wave.py``) is not ported yet: it needs the
ELL and pull waves of ROADMAP A.4. Meshes across cards wait for ROADMAP
A.10."""
from .mesh import GRAPH_AXIS, Mesh, graph_mesh
from .sharded_wave import ShardedDeviceGraph, ShardedGraphArrays, build_sharded_wave

__all__ = [
    "GRAPH_AXIS",
    "Mesh",
    "graph_mesh",
    "ShardedDeviceGraph",
    "ShardedGraphArrays",
    "build_sharded_wave",
]
