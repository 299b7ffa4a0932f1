"""Epoch-versioned shard map — the cluster's one routing truth.

The reference's only scaling story is a user-pluggable consistent-hash call
router over a STATIC pool (samples/MultiServerRpc/Program.cs:58-76); our
port was faithfully static: sha1-mod-N over a fixed peer list, so one
member change silently remapped ~(N-1)/N of all keys. This module replaces
that with the two-level mapping every elastic system converges on:

    key --sha1 mod V--> virtual shard --rendezvous hashing--> owner member

- **V virtual shards** (default 256): the unit of movement and of cache
  fencing. A key's shard NEVER changes; only shard→member assignments do.
- **Rendezvous (highest-random-weight) hashing** per shard: owner = the
  member with the highest sha1(member|shard) score. Removing a member moves
  EXACTLY the shards it owned (~V/N); adding one moves ~V/(N+1) — the
  minimal-movement property the modulo router lacked, with no ring state to
  replicate (the assignment is a pure function of the member set).
- **Epochs**: every membership change mints ``epoch + 1``. Epochs totally
  order maps; routers/guards compare epochs, never member lists.
- **Wire-serializable and tiny**: only ``(epoch, members, n_shards)``
  travels — the V-entry assignment is derived deterministically on both
  ends (sha1, never the salted builtin ``hash()``, so it is identical
  across processes and restarts).

``diff(old, new)`` is THE primitive everything else consumes: the
rebalancer fences exactly the moved shards' client caches, tests assert
minimal movement through it, and the flight recorder journals it.

Pure module by design: stdlib + utils only (rpc/client/core import it
function-locally without cycles).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

from ..utils.errors import register_exception_type
from ..utils.serialization import register_wire_type

__all__ = ["DEFAULT_SHARDS", "ShardMap", "ShardMovedError"]

DEFAULT_SHARDS = 256


def _score(member: str, shard: int) -> int:
    """Rendezvous weight of ``member`` for ``shard`` — sha1-based so the
    ranking is stable across processes, restarts, and PYTHONHASHSEED."""
    digest = hashlib.sha1(f"{member}|{shard}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


@dataclass(frozen=True)
class ShardMap:
    """One immutable epoch of the cluster's shard assignment."""

    epoch: int
    members: Tuple[str, ...]
    n_shards: int = DEFAULT_SHARDS

    # ------------------------------------------------------------------ build
    @staticmethod
    def initial(members: Sequence[str], n_shards: int = DEFAULT_SHARDS, epoch: int = 0) -> "ShardMap":
        """Bootstrap map. Epoch 0 by convention: a joiner's seed view, which
        ANY coordinator-minted map (epoch ≥ 1) overrides."""
        return ShardMap(epoch=epoch, members=tuple(sorted(set(members))), n_shards=n_shards)

    def with_members(self, members: Sequence[str]) -> "ShardMap":
        """The next epoch for a changed member set (identical sets still
        bump — an epoch is a membership DECISION, not a diff)."""
        return ShardMap(
            epoch=self.epoch + 1,
            members=tuple(sorted(set(members))),
            n_shards=self.n_shards,
        )

    # ------------------------------------------------------------------ lookup
    @cached_property
    def assignment(self) -> Tuple[str, ...]:
        """shard id → owner member (derived, deterministic, cached)."""
        if not self.members:
            return ()
        return tuple(
            max(self.members, key=lambda m, s=shard: (_score(m, s), m))
            for shard in range(self.n_shards)
        )

    def shard_of(self, key: str) -> int:
        digest = hashlib.sha1(str(key).encode()).digest()
        return int.from_bytes(digest[:8], "big") % self.n_shards

    def owner_of_shard(self, shard: int) -> Optional[str]:
        assignment = self.assignment
        return assignment[shard % self.n_shards] if assignment else None

    def owner_of(self, key: str) -> Optional[str]:
        return self.owner_of_shard(self.shard_of(key))

    def owners_for_shard(self, shard: int, count: int = 2) -> Tuple[str, ...]:
        """The first ``count`` members in the shard's rendezvous order —
        entry 0 is the owner, entry 1 the read-failover replica."""
        if not self.members:
            return ()
        ranked = sorted(
            self.members, key=lambda m: (_score(m, shard % self.n_shards), m), reverse=True
        )
        return tuple(ranked[:count])

    def replica_of_shard(self, shard: int) -> Optional[str]:
        owners = self.owners_for_shard(shard, 2)
        return owners[1] if len(owners) > 1 else None

    @property
    def coordinator(self) -> Optional[str]:
        """Deterministic single coordinator: the lowest member id. A control
        -plane convention, NOT consensus — CLUSTER.md documents what that
        does and does not guarantee."""
        return min(self.members) if self.members else None

    # ------------------------------------------------------------------ diff
    @staticmethod
    def diff(old: "ShardMap", new: "ShardMap") -> Tuple[int, ...]:
        """Shard ids whose owner changed between two maps (deterministic,
        ascending) — the fence set the rebalancer drives."""
        if old.n_shards != new.n_shards:
            return tuple(range(new.n_shards))
        a, b = old.assignment, new.assignment
        if not a or not b:
            return tuple(range(new.n_shards)) if a != b else ()
        return tuple(s for s in range(new.n_shards) if a[s] != b[s])

    # ------------------------------------------------------------------ wire
    def to_wire(self) -> dict:
        return {"epoch": self.epoch, "members": list(self.members), "n_shards": self.n_shards}

    @staticmethod
    def from_wire(d: dict) -> "ShardMap":
        return ShardMap(
            epoch=int(d["epoch"]),
            members=tuple(d["members"]),
            n_shards=int(d.get("n_shards", DEFAULT_SHARDS)),
        )

    def __repr__(self) -> str:
        return (
            f"ShardMap(epoch={self.epoch}, members={list(self.members)}, "
            f"V={self.n_shards})"
        )


# assignment is derived — only (epoch, members, n_shards) travels
register_wire_type(
    ShardMap,
    to_dict=lambda m: m.to_wire(),
    from_dict=ShardMap.from_wire,
)


class ShardMovedError(Exception):
    """A call landed on a member that does not own its key's shard (or the
    owner is unreachable for a command). Carries the rejecting side's
    CURRENT map so the caller can apply-and-retry once.

    Travels over the ``$sys.error`` ExceptionInfo channel, which transports
    only ``(type_name, message)`` — so the map rides embedded in the
    message string (``...|map={json}``) and the single-argument constructor
    re-parses it on the receiving side. Registered as a known exception
    type, so both ends that imported this module reconstruct the real class
    (a cluster-unaware process sees a plain ``RemoteError``, which is fine:
    no cluster, no retry logic)."""

    _MARK = "|map="

    def __init__(self, message: str = "", shard_map: Optional[ShardMap] = None):
        if shard_map is not None and self._MARK not in message:
            message = f"{message}{self._MARK}{json.dumps(shard_map.to_wire(), separators=(',', ':'))}"
        super().__init__(message)
        self.map_wire: Optional[dict] = None
        if self._MARK in message:
            try:
                self.map_wire = json.loads(message.partition(self._MARK)[2])
            except (ValueError, TypeError):
                self.map_wire = None

    @property
    def shard_map(self) -> Optional[ShardMap]:
        if self.map_wire is None:
            return None
        try:
            return ShardMap.from_wire(self.map_wire)
        except (KeyError, ValueError, TypeError):
            return None


register_exception_type(ShardMovedError)
