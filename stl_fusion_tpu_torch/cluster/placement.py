"""DevicePlacement — the shard map's device half.

The control plane routes *calls*: a :class:`~.shard_map.ShardMap` maps
keys → virtual shards → member processes. This module extends the SAME
epoch-versioned assignment down one more level, onto the accelerator mesh:

    virtual shard --rendezvous(member)--> member --rendezvous(device)-->
    device slot --> a fixed-width row block of the mesh-sharded CSR mirror

so a cluster member's shard-map assignment also PINS its slice of the
device graph ("retires the single-device-graph-per-hub
assumption"). The properties the routed wave kernel leans on:

- **Fixed shard geometry.** Node ids partition into V contiguous id ranges
  (``ids_per_shard``); each shard occupies ONE fixed-width device slot
  (``slot_rows``, 32-aligned for the packed frontier words). Moving a
  shard therefore moves exactly one row block — state for unmoved shards
  never relocates and never leaves the device.
- **Slot stability across epochs.** :meth:`moved_to` keeps every unmoved
  shard in its existing slot and first-fit-places only the moved shards on
  their new owner's devices. A reshard is O(moved), not O(V).
- **Determinism.** Device choice within a member is rendezvous-hashed
  (sha1, like the member assignment itself), so every process derives the
  same placement from the same ``(ShardMap, mesh shape)`` — nothing but
  the tiny ShardMap travels on the wire.

``mesh_members`` names which cluster members are co-located on THIS mesh
(ICI domain). Shards owned by members outside it have no device slot here:
their invalidations cross hosts and take the RPC relay — the DCN fallback
path (rpc/fanout.py counts it) — instead of the collective exchange.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .shard_map import ShardMap

__all__ = ["DevicePlacement", "PlacementError"]


class PlacementError(RuntimeError):
    """The placement cannot host the request (slot overflow ⇒ the caller
    rebuilds with more headroom, exactly like a mirror-patch overflow)."""


def _dev_score(member: str, device: int, shard: int) -> int:
    digest = hashlib.sha1(f"{member}|dev{device}|{shard}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


@dataclass
class DevicePlacement:
    """One epoch of shard → device-slot assignment for a node capacity.

    Mutable ONLY through :meth:`moved_to` (which returns a new placement
    sharing geometry) — the arrays themselves are the routed graph's
    layout contract and are treated as frozen once a graph is built."""

    shard_map: ShardMap
    n_dev: int
    n_nodes: int
    #: members co-located on this mesh, in DEVICE ORDER: member i owns the
    #: contiguous device range [i*dpm, (i+1)*dpm)
    mesh_members: Tuple[str, ...]
    ids_per_shard: int = 0
    slot_rows: int = 0
    slots_per_dev: int = 0
    #: the HOST axis: host h owns the contiguous device range
    #: [h*devices_per_host, (h+1)*devices_per_host) — cluster/multihost.py
    #: verifies this against the real process layout at bring-up. 0 means
    #: single host (every device local), the pre-multihost default.
    devices_per_host: int = 0
    #: shard → owning device (-1: owner member is off-mesh → DCN relay)
    shard_dev: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    #: shard → slot index on its device (-1 when off-mesh)
    shard_slot: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    moves: int = 0  # cumulative device-shard moves along this lineage

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(
        shard_map: ShardMap,
        n_dev: int,
        n_nodes: int,
        mesh_members: Optional[Sequence[str]] = None,
        slot_headroom: float = 1.5,
        devices_per_host: Optional[int] = None,
    ) -> "DevicePlacement":
        """Derive the placement for a map + mesh. ``mesh_members`` defaults
        to ALL members (single-host cluster: the whole map lives on this
        mesh). ``slot_headroom`` over-provisions per-device slots so a
        reshard can first-fit moved shards without a rebuild.
        ``devices_per_host`` declares the host axis (default: all devices
        one host) — the hierarchical exchange and host-aware reshard move
        costs key off it."""
        members = tuple(mesh_members) if mesh_members is not None else shard_map.members
        if not members:
            raise PlacementError("placement needs at least one mesh member")
        if n_dev < len(members) or n_dev % len(members):
            raise PlacementError(
                f"{n_dev} devices do not split evenly over {len(members)} mesh members"
            )
        dph = n_dev if not devices_per_host else int(devices_per_host)
        if dph <= 0 or n_dev % dph:
            raise PlacementError(
                f"{n_dev} devices do not split into {devices_per_host}-device hosts"
            )
        V = shard_map.n_shards
        ids_per_shard = max(-(-n_nodes // V), 1)
        slot_rows = max((ids_per_shard + 31) // 32 * 32, 32)
        p = DevicePlacement(
            shard_map=shard_map,
            n_dev=n_dev,
            n_nodes=n_nodes,
            mesh_members=members,
            ids_per_shard=ids_per_shard,
            slot_rows=slot_rows,
            shard_dev=np.full(V, -1, np.int32),
            shard_slot=np.full(V, -1, np.int32),
            devices_per_host=dph,
        )
        member_set = set(members)
        dpm = n_dev // len(members)
        member_devs = {m: range(i * dpm, (i + 1) * dpm) for i, m in enumerate(members)}
        # deterministic slot fill: device choice is rendezvous-hashed per
        # (member, device, shard); slots fill in shard order
        next_slot = np.zeros(n_dev, np.int64)
        assignment = shard_map.assignment
        for s in range(V):
            owner = assignment[s] if assignment else None
            if owner not in member_set:
                continue  # off-mesh: the DCN relay owns this shard's traffic
            dev = max(member_devs[owner], key=lambda d: _dev_score(owner, d, s))
            p.shard_dev[s] = dev
            p.shard_slot[s] = next_slot[dev]
            next_slot[dev] += 1
        peak = int(next_slot.max()) if n_dev else 0
        p.slots_per_dev = max(int(np.ceil(peak * slot_headroom)), peak, 1)
        return p

    # ------------------------------------------------------------------ geometry
    @property
    def n_local(self) -> int:
        return self.slots_per_dev * self.slot_rows

    @property
    def n_global(self) -> int:
        return self.n_dev * self.n_local

    @property
    def epoch(self) -> int:
        return self.shard_map.epoch

    @property
    def n_hosts(self) -> int:
        dph = self.devices_per_host or self.n_dev
        return self.n_dev // dph

    def host_of_device(self, dev: int) -> int:
        return int(dev) // (self.devices_per_host or self.n_dev)

    def cross_host_moves(self, moves: Sequence[Tuple[int, int, int]]) -> int:
        """How many of a :meth:`moved_to` move list's row-block transfers
        cross a host boundary — the DCN leg of a reshard (the host-aware
        candidate ranking exists to minimize this)."""
        return sum(
            1
            for _s, old, new in moves
            if old >= 0 and new >= 0 and self.host_of_device(old) != self.host_of_device(new)
        )

    def shard_of_node(self, node_id: int) -> int:
        return int(node_id) // self.ids_per_shard

    def member_of_device(self, dev: int) -> str:
        dpm = self.n_dev // len(self.mesh_members)
        return self.mesh_members[dev // dpm]

    def on_mesh(self, shard: int) -> bool:
        return bool(self.shard_dev[shard] >= 0)

    def row_of_shard(self, shard: int) -> int:
        """First global row of a shard's device slot."""
        dev = int(self.shard_dev[shard])
        if dev < 0:
            raise PlacementError(f"shard {shard} is off-mesh (DCN-relayed)")
        return dev * self.n_local + int(self.shard_slot[shard]) * self.slot_rows

    def permutation(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(perm, inv)``: node id → global device row, and row → node id
        (-1 on pad / off-mesh rows). Vectorized over all on-mesh shards."""
        perm = np.full(self.n_nodes, -1, np.int64)
        inv = np.full(self.n_global, -1, np.int64)
        V = self.shard_map.n_shards
        for s in range(V):
            if self.shard_dev[s] < 0:
                continue
            lo = s * self.ids_per_shard
            hi = min(lo + self.ids_per_shard, self.n_nodes)
            if hi <= lo:
                continue
            base = self.row_of_shard(s)
            rows = np.arange(base, base + (hi - lo), dtype=np.int64)
            perm[lo:hi] = rows
            inv[rows] = np.arange(lo, hi, dtype=np.int64)
        return perm, inv

    # ------------------------------------------------------------------ reshard
    def moved_to(
        self, new_map: ShardMap, mesh_members: Optional[Sequence[str]] = None
    ) -> Tuple["DevicePlacement", List[Tuple[int, int, int]]]:
        """The next placement for ``new_map``, keeping every unmoved shard
        in its current slot. Returns ``(placement, moves)`` where each move
        is ``(shard, old_dev, new_dev)`` (old_dev/new_dev may be -1 for a
        shard entering/leaving this mesh). Raises :class:`PlacementError`
        when a destination device has no free slot — the caller rebuilds
        the routed graph from scratch (counted, never silent)."""
        members = tuple(mesh_members) if mesh_members is not None else self.mesh_members
        if not members or self.n_dev % len(members):
            raise PlacementError("mesh membership changed shape; rebuild required")
        # member → device ranges re-derive for the NEW member set (a kill
        # hands the departed member's devices to the survivors; a join
        # carves ranges back out). Unmoved shards keep their existing
        # device slots regardless — the ranges steer only moved shards, so
        # a membership change moves exactly the diff'd shards' row blocks.
        nxt = DevicePlacement(
            shard_map=new_map,
            n_dev=self.n_dev,
            n_nodes=self.n_nodes,
            mesh_members=members,
            ids_per_shard=self.ids_per_shard,
            slot_rows=self.slot_rows,
            slots_per_dev=self.slots_per_dev,
            shard_dev=self.shard_dev.copy(),
            shard_slot=self.shard_slot.copy(),
            moves=self.moves,
            devices_per_host=self.devices_per_host,
        )
        member_set = set(members)
        dpm = self.n_dev // len(members)
        dph = self.devices_per_host or self.n_dev
        member_devs = {m: range(i * dpm, (i + 1) * dpm) for i, m in enumerate(members)}
        moved = sorted(ShardMap.diff(self.shard_map, new_map))
        moved_set = set(moved)
        assignment = new_map.assignment
        # occupancy per device, from the carried slots
        used: Dict[int, set] = {d: set() for d in range(self.n_dev)}
        for s in range(new_map.n_shards):
            if nxt.shard_dev[s] >= 0 and s not in moved_set:
                used[int(nxt.shard_dev[s])].add(int(nxt.shard_slot[s]))

        def ranked(owner: str, s: int, old_dev: int) -> List[int]:
            """The new owner's devices in preference order: rendezvous
            score descending, SAME-HOST candidates first when the shard
            already has rows resident (a reshard must
            not needlessly turn an intra-host slot reassignment into a
            cross-host DCN transfer)."""
            devs = sorted(
                member_devs[owner], key=lambda d: _dev_score(owner, d, s), reverse=True
            )
            if old_dev < 0 or dph >= self.n_dev:
                return devs
            oh = old_dev // dph
            return [d for d in devs if d // dph == oh] + [
                d for d in devs if d // dph != oh
            ]

        moves: List[Tuple[int, int, int]] = []
        # pass 1: a moved shard whose PREFERRED device equals its old one
        # keeps its slot outright — no row block moves, but its slot must
        # be claimed before pass 2 first-fits genuinely moving shards
        cands: Dict[int, List[int]] = {}
        for s in moved:
            owner = assignment[s] if assignment else None
            if owner not in member_set:
                cands[s] = []
                continue
            cands[s] = ranked(owner, s, int(nxt.shard_dev[s]))
            if cands[s][0] == int(nxt.shard_dev[s]):
                used[cands[s][0]].add(int(nxt.shard_slot[s]))
        for s in moved:
            old_dev = int(nxt.shard_dev[s])
            devs = cands[s]
            if not devs:
                nxt.shard_dev[s] = -1
                nxt.shard_slot[s] = -1
                if old_dev >= 0:
                    moves.append((s, old_dev, -1))
                continue
            if devs[0] == old_dev:
                continue  # ownership changed hands, the rows never move
            # scan the ranked candidates for the first with a free slot
            # (landing back on old_dev keeps the rows in place)
            placed = False
            for dev in devs:
                if dev == old_dev and int(nxt.shard_slot[s]) not in used[dev]:
                    used[dev].add(int(nxt.shard_slot[s]))
                    placed = True
                    break
                slot = next(
                    (k for k in range(self.slots_per_dev) if k not in used[dev]), None
                )
                if slot is not None:
                    used[dev].add(slot)
                    nxt.shard_dev[s] = dev
                    nxt.shard_slot[s] = slot
                    moves.append((s, old_dev, dev))
                    placed = True
                    break
            if not placed:
                raise PlacementError(
                    f"no free slot on any of member {assignment[s]!r}'s devices "
                    f"for moved shard {s} (slots_per_dev={self.slots_per_dev})"
                )
        nxt.moves = self.moves + len(moves)
        return nxt, moves

    def snapshot(self) -> dict:
        on_mesh = int((self.shard_dev >= 0).sum())
        return {
            "epoch": self.epoch,
            "n_dev": self.n_dev,
            "hosts": self.n_hosts,
            "devices_per_host": self.devices_per_host or self.n_dev,
            "mesh_members": list(self.mesh_members),
            "ids_per_shard": self.ids_per_shard,
            "slot_rows": self.slot_rows,
            "slots_per_dev": self.slots_per_dev,
            "shards_on_mesh": on_mesh,
            "shards_off_mesh": self.shard_map.n_shards - on_mesh,
            "moves": self.moves,
        }
