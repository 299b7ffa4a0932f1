"""Cluster control plane: the epoch-versioned shard map and the
``ShardMovedError`` rejection the command bridges raise and heal on; the
shard map's device half (``DevicePlacement``, the layout the routed mesh
wave builds on); the shard-map router with its server-side guard and client
glue; and the rebalancer, which fences moved keys and moves the mesh's
device shards in the same epoch change. Membership, warm rejoin, the mesh
controller and the multi-host mesh are not ported yet (ROADMAP A.9)."""
from .placement import DevicePlacement, PlacementError
from .rebalancer import ClusterRebalancer
from .router import (
    EPOCH_HEADER,
    FAILOVER_HEADER,
    SHARD_HEADER,
    ShardMapRouter,
    install_cluster_client,
    install_cluster_guard,
)
from .shard_map import DEFAULT_SHARDS, ShardMap, ShardMovedError

__all__ = [
    "ClusterRebalancer",
    "DEFAULT_SHARDS",
    "DevicePlacement",
    "PlacementError",
    "EPOCH_HEADER",
    "FAILOVER_HEADER",
    "SHARD_HEADER",
    "ShardMap",
    "ShardMapRouter",
    "ShardMovedError",
    "install_cluster_client",
    "install_cluster_guard",
]
