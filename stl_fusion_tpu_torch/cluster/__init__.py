"""Cluster control plane: the epoch-versioned shard map and the
``ShardMovedError`` rejection the command bridges raise and heal on.
Membership, routing, rebalancing, warm rejoin, device placement and the
multi-host mesh are not ported yet (ROADMAP A.9)."""
from .shard_map import DEFAULT_SHARDS, ShardMap, ShardMovedError

__all__ = ["DEFAULT_SHARDS", "ShardMap", "ShardMovedError"]
