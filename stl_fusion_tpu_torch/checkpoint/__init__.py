"""Checkpoint/resume — durable snapshots of the computed graph.

The reference has no training-style checkpoints; its two restart-survival
mechanisms are (a) the persistent client computed cache, version-flushed and
synchronized after boot (Client/Caching/ClientComputedCache.cs:10-49), and
(b) the DB operation log as the durable source of invalidation truth, replayed
from a commit-time watermark (Operations/DbOperationLogReader.cs:36-77).
SURVEY §5.4 maps both onto this build as: **checkpoint = snapshot of
(graph + versions + values) plus op-log offset**. This module implements that:

- :func:`save_graph` / :func:`load_graph` — raw DeviceGraph array snapshots
  (npz) for standalone bench-scale graphs with no host registry.
- :class:`HubCheckpoint` — warm-boot snapshots of a FusionHub's computed
  state: every live, consistent, serializable compute-method result with its
  version, the host dependency edges between them, and the op-log position.
  ``restore`` re-creates the nodes as CONSISTENT computeds (reads hit warm
  immediately), re-links the dependency edges (so cascading invalidation
  works from turn one), and returns the op-log position to resume the
  reader from — replaying external operations committed after the snapshot
  invalidates exactly the entries that went stale while the host was down.
- :class:`CheckpointManager` — numbered snapshots in a directory with
  ``latest()`` lookup, the orbax-style save/restore loop without the
  training-framework dependency surface. The manager is the
  durability layer proper: snapshots are checksummed + fsynced (see
  checkpoint/durable.py for the envelope), ``restore_latest`` falls back
  PAST a corrupt/torn latest snapshot to the newest valid one (quarantine-
  logging what it skipped), ``save_durable`` captures the epoch-consistent
  ``(shard-map epoch, oplog watermark)`` state the cluster warm-rejoin
  path (cluster/rejoin.py) restores, and ``snapshot_floor()`` feeds the
  oplog trimmer's clamp so a replay tail is never trimmed away.
"""
from __future__ import annotations

import logging
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.computed import Computed
from ..core.hub import FusionHub
from ..core.inputs import ComputeMethodInput, KwArgsTail
from ..graph.device_graph import DeviceGraph
from ..utils.ltag import LTag
from ..utils.result import Result
from ..utils.serialization import encode, decode
from .durable import (
    CorruptSnapshotError,
    DurableHubState,
    atomic_write,
    read_snapshot_file,
    read_snapshot_header,
    write_snapshot_file,
)

log = logging.getLogger("stl_fusion_tpu_torch")

# distinguishes "caller did not choose a floor" from an explicit None
_FLOOR_UNSET = object()

__all__ = [
    "save_graph",
    "load_graph",
    "save_mesh_shards",
    "restore_mesh_shards",
    "CorruptSnapshotError",
    "DurableHubState",
    "HubCheckpoint",
    "RestoreResult",
    "CheckpointManager",
]

_FORMAT_VERSION = 1


from ..utils.serialization import deep_tuple as _deep_tuple


# ---------------------------------------------------------------- device graph
def save_graph(graph: DeviceGraph, path: str) -> None:
    """Snapshot a DeviceGraph's authoritative host arrays (live prefixes
    only). Written through :func:`durable.atomic_write` so a crash
    mid-save never leaves a truncated npz where the last good snapshot
    stood. The layout (keys, dtypes, ``format``) is the JAX package's, so
    a snapshot written by either package loads into the other.

    While the device copy is live the device words are authoritative for
    the invalid state (a ``run_wave_frontier(sync_host=False)`` leaves the
    host copy behind them; every other wave path keeps both equal), so the
    invalid set is read back from them."""
    if graph._g is not None and not graph._dirty:
        invalid = graph.invalid_mask()
    else:
        invalid = graph._h_invalid[: graph.n_nodes]

    def _write(f):
        np.savez_compressed(
            f,
            format=np.int32(_FORMAT_VERSION),
            n_nodes=np.int64(graph.n_nodes),
            n_edges=np.int64(graph.n_edges),
            edge_src=graph._h_edge_src[: graph.n_edges],
            edge_dst=graph._h_edge_dst[: graph.n_edges],
            edge_dst_epoch=graph._h_edge_dst_epoch[: graph.n_edges],
            node_epoch=graph._h_node_epoch[: graph.n_nodes],
            invalid=invalid,
        )

    atomic_write(path, _write)


def load_graph(path: str, device=None) -> DeviceGraph:
    """Rebuild a DeviceGraph from :func:`save_graph` output (this package's
    or the JAX package's) on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``). Device arrays re-materialize lazily on first use
    (the mirror derives from host state)."""
    with np.load(path) as z:
        n_nodes = int(z["n_nodes"])
        n_edges = int(z["n_edges"])
        graph = DeviceGraph(
            node_capacity=max(n_nodes, 16), edge_capacity=max(n_edges, 16), device=device
        )
        graph.add_nodes(n_nodes)
        graph._h_node_epoch[:n_nodes] = z["node_epoch"]
        graph._h_invalid[:n_nodes] = z["invalid"]
        # edges carry their recorded capture epochs (stale edges stay stale);
        # any entry at/above the old capacity was a dummy-slot pad — re-point
        # it at the NEW dummy slot
        src = z["edge_src"].copy()
        dst = z["edge_dst"].copy()
        src[src >= n_nodes] = graph.n_cap
        dst[dst >= n_nodes] = graph.n_cap
        graph.add_edges(src, dst, dst_epoch=z["edge_dst_epoch"])
    graph._dirty = True
    return graph


# ----------------------------------------------------------- mesh shard state
def save_mesh_shards(routed_graph, path: str) -> int:
    """Snapshot a routed mesh mirror's node state keyed PER VIRTUAL SHARD:
    the unit that survives a reshard. The restoring process
    re-pins each shard under whatever :class:`~..cluster.placement.
    DevicePlacement` it derives from ITS current map — a warm restart
    after a reshard lands every
    shard's epochs/invalid marks on the right device regardless of how
    the slots moved in between. Returns the number of shards written."""
    snap = routed_graph.export_shard_state()
    shards = sorted(snap["shards"])
    offs = np.zeros(len(shards) + 1, dtype=np.int64)
    eps, invs = [], []
    for i, s in enumerate(shards):
        ep, inv = snap["shards"][s]
        offs[i + 1] = offs[i] + len(ep)
        eps.append(ep)
        invs.append(inv)

    def _write(f):
        np.savez_compressed(
            f,
            format=np.int32(_FORMAT_VERSION),
            map_epoch=np.int64(snap["epoch"]),
            n_nodes=np.int64(snap["n_nodes"]),
            n_shards=np.int64(snap["n_shards"]),
            shard_ids=np.asarray(shards, dtype=np.int64),
            offsets=offs,
            node_epoch=np.concatenate(eps) if eps else np.empty(0, np.int32),
            invalid=np.concatenate(invs) if invs else np.empty(0, bool),
        )

    atomic_write(path, _write)
    return len(shards)


def restore_mesh_shards(routed_graph, path: str) -> dict:
    """Re-pin a :func:`save_mesh_shards` snapshot onto a live routed graph
    under ITS placement. Shards the snapshot lacks (or that moved off this
    mesh) keep their built state. Returns ``{"restored": n, "map_epoch":
    e}`` — the caller compares ``map_epoch`` against its current epoch to
    decide what the rejoin fence must cover."""
    with np.load(path) as z:
        shard_ids = z["shard_ids"]
        offs = z["offsets"]
        ep = z["node_epoch"]
        inv = z["invalid"]
        snap = {
            "epoch": int(z["map_epoch"]),
            "n_nodes": int(z["n_nodes"]),
            "n_shards": int(z["n_shards"]),
            "shards": {
                int(s): (ep[offs[i] : offs[i + 1]], inv[offs[i] : offs[i + 1]])
                for i, s in enumerate(shard_ids)
            },
        }
    restored = routed_graph.import_shard_state(snap)
    return {"restored": restored, "map_epoch": snap["epoch"]}


# ---------------------------------------------------------------- hub snapshot
def _service_name(hub: FusionHub, service: Any) -> str:
    """Stable name for a service: explicit str key in the hub container,
    else its type name (deterministic across restarts for one-instance-per-
    class services, which is the framework's normal shape)."""
    for key, svc in hub._services.items():
        if svc is service:
            return key if isinstance(key, str) else key.__name__
    return type(service).__name__


def _services_by_name(hub: FusionHub) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, svc in hub._services.items():
        out[key if isinstance(key, str) else key.__name__] = svc
    return out


@dataclass
class RestoreResult:
    """Outcome of :meth:`HubCheckpoint.restore`.

    Holds STRONG references to the restored computeds — the registry interns
    weakly, so drop this object only once something else (keep-alive timers,
    dependents, states) anchors the entries you care about.
    """

    computeds: List[Computed] = field(default_factory=list)
    skipped: int = 0
    edges: int = 0
    tables: int = 0  # MemoTables restored warm (columnar twin state)
    oplog_position: int = 0
    saved_at: float = 0.0
    # -- durable-state extras (zero/None for legacy snapshots) --
    epoch: int = 0  # shard-map epoch the snapshot was taken under
    snapshot_map: Optional[dict] = None  # wire-form ShardMap at snapshot time
    commit_floor: Optional[float] = None  # oldest trim-safe commit time
    subscriptions: int = 0  # live fan-out subscriptions at snapshot time

    @property
    def count(self) -> int:
        return len(self.computeds)

    @property
    def watermark(self) -> int:
        """Alias for ``oplog_position`` in durable-state terms."""
        return self.oplog_position


class HubCheckpoint:
    """Snapshot/restore of a hub's warm computed state (SURVEY §5.4)."""

    @staticmethod
    def snapshot(
        hub: FusionHub,
        oplog_position: int = 0,
        *,
        commit_floor: Any = _FLOOR_UNSET,
        log_store: Any = None,
    ) -> dict:
        """Capture every live CONSISTENT compute-method node whose arguments
        and value serialize. Error outputs and mid-compute nodes are skipped
        (they recompute cold — same rule as the reference's client cache,
        which only persists successful results).

        ``commit_floor``/``log_store`` control the trim-safety floor stamped
        in the snapshot header — see ``_capture_floor`` for the rules. The
        default (neither given) stamps NO floor, which makes
        ``snapshot_floor()`` clamp every trim while the snapshot is
        retained: safe, observable (``snapshot_clamped_trims``), but the
        log grows. Deployments that trim should pass ``log_store`` (or use
        ``CheckpointManager.save_durable``, which derives the floor from
        the reader)."""
        nodes: List[dict] = []
        index_of: Dict[Any, int] = {}
        live = hub.registry.live_computeds()
        skipped = 0
        for c in live:
            if not c.is_consistent or not isinstance(c.input, ComputeMethodInput):
                skipped += 1
                continue
            out = c._output
            if out is None or out.has_error:
                skipped += 1
                continue
            service = c.input.service
            svc_name = _service_name(hub, service)
            method_name = c.input.method_def.original.__name__
            try:
                entry = {
                    "s": svc_name,
                    "m": method_name,
                    "a": encode(list(c.input.args)),
                    "v": int(c.version),
                    "o": encode(out.value),
                }
            except TypeError:
                skipped += 1  # unserializable args/value — recomputes cold
                continue
            index_of[c.input] = len(nodes)
            nodes.append(entry)
        # host dependency edges among snapshot nodes: (dependent, used,
        # used-version) — the version lets restore detect that a LIVE node
        # displaced the snapshotted dependency and the dependent is stale
        edges: List[Tuple[int, int, int]] = []
        for c in live:
            di = index_of.get(c.input)
            if di is None:
                continue
            for used in c.used:
                ui = index_of.get(used.input)
                if ui is not None:
                    edges.append((di, ui, int(used.version)))
        return {
            "format": _FORMAT_VERSION,
            "saved_at": time.time(),
            "oplog_position": int(oplog_position),
            "oplog": {
                "watermark": int(oplog_position),
                "commit_floor": HubCheckpoint._capture_floor(
                    int(oplog_position), commit_floor, log_store
                ),
            },
            "nodes": nodes,
            "edges": edges,
            "tables": HubCheckpoint._snapshot_tables(hub),
            "skipped": skipped,
        }

    @staticmethod
    def _capture_floor(watermark: int, commit_floor: Any, log_store: Any):
        """The trim-safety floor for a snapshot at ``watermark`` — the
        commit time of the OLDEST oplog entry its replay tail needs.

        An explicit ``commit_floor`` wins (the caller read it off a
        reader). With a ``log_store`` the floor is derived from the log
        itself: the first record ABOVE the watermark, or the capture
        instant when the tail is empty (entries appended later commit at
        or after now). With neither, None — a caller-supplied watermark
        may LAG the log head, and a floor of now would let the trimmer
        delete the lagging tail replay still needs, so no floor is the
        only safe answer (``snapshot_floor()`` turns it into a
        clamp-every-trim)."""
        if commit_floor is not _FLOOR_UNSET:
            return commit_floor
        if log_store is not None:
            try:
                tail = log_store.read_after(watermark, limit=1)
            except Exception:  # noqa: BLE001 — corrupt head row: no floor
                return None
            return tail[0].commit_time if tail else time.time()
        return None

    @staticmethod
    def _snapshot_tables(hub: FusionHub) -> List[dict]:
        """Columnar twin state: every MATERIALIZED MemoTable
        behind a table-backed compute method — values, per-row validity,
        version, and (for codec-backed tables) the interned key layout, so
        a warm boot serves ``read_batch``/``read_keys`` hits without
        re-fetching a single row."""
        tables: List[dict] = []
        for service in hub._services.values():
            svc_name = _service_name(hub, service)
            for mname in dir(type(service)):
                method = getattr(type(service), mname, None)
                mdef = getattr(method, "__compute_method_def__", None)
                if mdef is None or mdef.table is None:
                    continue
                table = mdef.peek_table(service)
                if table is None:
                    continue  # never materialized: nothing to save
                entry = {"s": svc_name, "m": mname, "state": table.export_state()}
                codec = table.key_codec
                if codec is not None:
                    entry["keys"] = encode([list(codec.decode(r)) for r in range(len(codec))])
                tables.append(entry)
        return tables

    @staticmethod
    def _restore_tables(hub: FusionHub, services: Dict[str, Any], snap: dict) -> int:
        restored = 0
        for entry in snap.get("tables", ()):
            service = services.get(entry["s"])
            if service is None:
                log.warning("checkpoint: service %r missing; table skipped", entry["s"])
                continue
            method = getattr(service, entry["m"], None)
            mdef = getattr(method, "__compute_method_def__", None)
            if mdef is None or mdef.table is None:
                log.warning("checkpoint: %s.%s is not table-backed; skipped",
                            entry["s"], entry["m"])
                continue
            table = mdef.get_table(service)  # fresh wiring: hooks + codec
            if table.key_codec is not None:
                # re-intern the saved key layout IN ORDER so saved rows land
                # on the same ids (wire transport turns tuples into lists —
                # deep-tuple them back into hashable keys). If ANY key lands
                # on a different row — something was interned before the
                # restore, or the codec overflowed — the saved value arrays
                # would map to the WRONG keys: leave the table cold (it
                # refetches correctly) rather than serve silently wrong rows
                layout_ok = True
                try:
                    for row, args in enumerate(decode(entry.get("keys", []))):
                        if table.key_codec.acquire(_deep_tuple(args)) != row:
                            layout_ok = False
                            break
                except KeyError:
                    layout_ok = False
                if not layout_ok:
                    log.warning(
                        "checkpoint: table %s.%s key layout diverged from the "
                        "snapshot (keys interned before restore?); left cold",
                        entry["s"], entry["m"],
                    )
                    continue
            try:
                table.import_state(entry["state"])
            except ValueError as e:
                log.warning("checkpoint: table %s.%s shape mismatch (%s); "
                            "left cold", entry["s"], entry["m"], e)
                continue
            restored += 1
        return restored

    @staticmethod
    def save(
        hub: FusionHub,
        path: str,
        oplog_position: int = 0,
        *,
        commit_floor: Any = _FLOOR_UNSET,
        log_store: Any = None,
    ) -> dict:
        """Snapshot + persist atomically: temp file, fsync, rename, payload
        checksum in the header (checkpoint/durable.py). A crash at ANY
        point leaves either the previous snapshot or a temp file the
        restore path never looks at — never a truncated ``path``.

        Pass ``log_store`` (or an explicit ``commit_floor``) so the
        snapshot carries a trim-safety floor; without one it clamps every
        trim while retained (see ``HubCheckpoint.snapshot``)."""
        snap = HubCheckpoint.snapshot(
            hub, oplog_position, commit_floor=commit_floor, log_store=log_store
        )
        write_snapshot_file(path, snap)
        return snap

    @staticmethod
    def restore(
        hub: FusionHub,
        path: str,
        services: Optional[Dict[str, Any]] = None,
    ) -> RestoreResult:
        """Warm-boot ``hub`` from a snapshot file.

        Each snapshot node becomes a registered CONSISTENT computed carrying
        its ORIGINAL version, so op-log replay's version-matched invalidation
        semantics hold across the restart. Dependency edges re-link through
        the normal ``add_used`` path, which also feeds the device mirror
        hooks — the device CSR rebuilds itself from restored host truth.

        ``services`` maps snapshot service names to live instances; defaults
        to the hub's service container keyed by type name.

        Raises :class:`CorruptSnapshotError` for a torn/garbled file —
        ``CheckpointManager.restore_latest`` catches it and falls back to
        the next-newest snapshot.
        """
        snap = read_snapshot_file(path)
        if snap.get("format") != _FORMAT_VERSION:
            raise CorruptSnapshotError(
                f"unsupported checkpoint format {snap.get('format')!r}"
            )
        if services is None:
            services = _services_by_name(hub)
        cluster = DurableHubState.cluster_of(snap)
        result = RestoreResult(
            oplog_position=DurableHubState.watermark_of(snap),
            saved_at=float(snap.get("saved_at", 0.0)),
            epoch=int(cluster.get("epoch", 0) or 0),
            snapshot_map=cluster.get("shard_map"),
            commit_floor=(snap.get("oplog") or {}).get("commit_floor"),
            subscriptions=len(snap.get("subscriptions", ())),
        )
        restored: List[Optional[Computed]] = []
        for entry in snap["nodes"]:
            c = HubCheckpoint._restore_node(hub, services, entry)
            restored.append(c)
            if c is None:
                result.skipped += 1
            else:
                result.computeds.append(c)
        # tables restore BEFORE the edge-version invalidation loop: the
        # restored nodes carry the scalar→table mark_row_stale hook (they are
        # created through ComputeMethodFunction.create_computed), so any
        # provably-stale invalidation below must find the warm rows already
        # materialized and mark them stale — not land on a cold table and
        # then get overwritten by a later warm import
        result.tables = HubCheckpoint._restore_tables(hub, services, snap)
        for di, ui, used_version in snap.get("edges", ()):
            dep, used = restored[di], restored[ui]
            if dep is None or used is None:
                continue
            dep.add_used(used)
            result.edges += 1
            if int(used.version) != used_version:
                # a live computed displaced the snapshotted dependency: the
                # dependent's warm value was produced against a version that
                # no longer exists — it is provably stale
                dep.invalidate(immediately=True)
        return result

    @staticmethod
    def _restore_node(hub: FusionHub, services: Dict[str, Any], entry: dict) -> Optional[Computed]:
        service = services.get(entry["s"])
        if service is None:
            log.warning("checkpoint: service %r not registered; node skipped", entry["s"])
            return None
        method = getattr(service, entry["m"], None)
        method_def = getattr(method, "__compute_method_def__", None)
        if method_def is None:
            log.warning("checkpoint: %s.%s is not a compute method; node skipped",
                        entry["s"], entry["m"])
            return None
        args = tuple(decode(entry["a"]))
        if not (args and type(args[-1]) is KwArgsTail):  # already canonical
            try:
                # snapshots from before a key-normalization change store
                # args under the OLD canonical form (e.g. a defaulted
                # call's short tuple); re-normalizing keeps restored nodes
                # reachable by post-restore reads instead of orphaning them
                args = method_def.bind_args(service, args, {})
            except Exception:  # noqa: BLE001 — legacy key: keep raw
                pass
        function = method_def.get_function(service)
        input = ComputeMethodInput(method_def, service, args, function)
        existing = hub.registry.get(input)
        if existing is not None and existing.is_consistent:
            return existing  # live state wins over the snapshot
        # route through the function's create_computed — NOT a bare
        # Computed() — so restored nodes carry the same lifecycle hooks a
        # freshly computed node gets (in particular the table-backed
        # scalar→table mark_row_stale hook; a bare node would let post-
        # restore invalidations recompute the scalar while read_batch/
        # read_keys kept serving the stale warm row forever)
        computed = function.create_computed(input, LTag(entry["v"]))
        computed.try_set_output(Result.ok(decode(entry["o"])))
        hub.registry.register(computed)
        computed.renew_timeouts(True)  # arm keep-alive so warm entries survive
        return computed


# ---------------------------------------------------------------- manager
class CheckpointManager:
    """Numbered hub snapshots in a directory: ``fusion-ckpt-{n}.bin``.

    The durability contract: saves are atomic + checksummed
    (checkpoint/durable.py), ``restore_latest`` falls back past corrupt or
    torn snapshots to the newest VALID one (quarantining what it skipped
    as ``*.corrupt`` so the evidence survives for operators but never
    blocks the next restore), and ``snapshot_floor()`` hands the oplog
    trimmer the oldest commit time any retained snapshot's replay tail
    still needs — trimming past it would strand a warm rejoin."""

    _PATTERN = re.compile(r"fusion-ckpt-(\d+)\.bin$")

    def __init__(self, directory: str, keep: int = 3, events=None):
        self.directory = directory
        self.keep = keep
        if events is None:
            from ..resilience.events import global_events

            events = global_events()
        self.events = events
        self.saves = 0
        self.corrupt_skipped = 0
        # headerless (legacy v1) files need a FULL read to tell restorable
        # from garbage; the trimmer calls snapshot_floor() every GC cycle,
        # so the verdict is cached per (path, mtime, size)
        self._legacy_probe: Dict[str, Tuple[float, int, bool]] = {}
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = self._PATTERN.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def path_of(self, step: int) -> str:
        return os.path.join(self.directory, f"fusion-ckpt-{step}.bin")

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _rotate(self) -> None:
        for old in self._steps()[: -self.keep]:
            try:
                os.remove(self.path_of(old))
            except OSError:
                pass

    def save(
        self,
        hub: FusionHub,
        oplog_position: int = 0,
        *,
        commit_floor: Any = _FLOOR_UNSET,
        log_store: Any = None,
    ) -> int:
        step = (self.latest_step() or 0) + 1
        HubCheckpoint.save(
            hub,
            self.path_of(step),
            oplog_position,
            commit_floor=commit_floor,
            log_store=log_store,
        )
        self.saves += 1
        self._rotate()
        return step

    def save_durable(
        self,
        hub: FusionHub,
        *,
        reader=None,
        log_store=None,
        member=None,
        router=None,
        rpc_hub=None,
    ) -> int:
        """Save the epoch-consistent durable snapshot: the hub body keyed
        to ``(shard-map epoch, oplog watermark)`` plus live fan-out
        subscriptions — what :func:`~stl_fusion_tpu_torch.cluster.rejoin.
        warm_rejoin` restores. Any cluster/oplog handle may be None (a
        standalone hub snapshots with epoch 0)."""
        snap = DurableHubState.snapshot(
            hub,
            reader=reader,
            log_store=log_store,
            member=member,
            router=router,
            rpc_hub=rpc_hub,
        )
        step = (self.latest_step() or 0) + 1
        write_snapshot_file(self.path_of(step), snap)
        self.saves += 1
        self._rotate()
        return step

    def _quarantine(self, step: int, error: Exception) -> None:
        """Skip-and-log a snapshot restore_latest could not trust: ledger
        event + rename to ``*.corrupt`` (kept on disk as evidence, invisible
        to ``_steps`` so it never blocks the fallback again)."""
        self.corrupt_skipped += 1
        path = self.path_of(step)
        log.warning("checkpoint: snapshot %s unreadable (%s); falling back",
                    path, error)
        self.events.record("snapshot_corrupt", f"{os.path.basename(path)}: {error}")
        try:
            os.replace(path, f"{path}.corrupt")
        except OSError:
            pass

    def restore_latest(
        self, hub: FusionHub, services: Optional[Dict[str, Any]] = None
    ) -> Optional[RestoreResult]:
        """Restore from the newest VALID snapshot: corrupt/torn files are
        quarantined and the walk falls back to the next-newest. Returns
        None when no restorable snapshot exists (cold boot)."""
        for step in reversed(self._steps()):
            try:
                return HubCheckpoint.restore(hub, self.path_of(step), services)
            except CorruptSnapshotError as e:
                self._quarantine(step, e)
            except FileNotFoundError:
                continue  # rotated away between _steps() and open
            except OSError as e:
                # transient I/O error (EIO under load, NFS hiccup) on a
                # possibly-VALID snapshot: fall back for this restore but
                # leave the file in place — quarantining would permanently
                # demote a good snapshot over a one-off read failure
                log.warning("checkpoint: snapshot %s unreadable (%s); "
                            "skipping without quarantine", self.path_of(step), e)
                self.events.record(
                    "snapshot_skipped",
                    f"{os.path.basename(self.path_of(step))}: {e}",
                )
        return None

    def snapshot_floor(self) -> Optional[float]:
        """Oldest oplog commit time a retained snapshot still needs for
        its replay tail — the trimmer's snapshot clamp (min over retained
        READABLE headers: a snapshot the restore walk would quarantine
        contributes nothing, so a corrupt file never pins GC forever).
        None when no durable snapshot exists."""
        floors = []
        for step in self._steps():
            path = self.path_of(step)
            header = read_snapshot_header(path)
            if header is None:
                # no v2 header: either garbage (restore would quarantine
                # it — contributes nothing) or a RESTORABLE legacy v1 file,
                # which restore_latest happily loads; only the full read
                # can tell them apart, and a restorable snapshot with no
                # floor must clamp ALL trims or the trimmer eats the tail
                # its warm rejoin needs. The full read is cached per
                # (mtime, size): the trimmer polls this every GC cycle and
                # legacy payloads can be large.
                if self._probe_legacy(path):
                    return 0.0
                continue
            floor = header.get("commit_floor")
            if floor is None:
                # v2 but FLOOR-LESS: a plain save() with no log_store/
                # commit_floor (the snapshot's watermark may lag the head,
                # so no floor is derivable). Replay needs are unbounded
                # below — no trim is safe while it is retained. None would
                # instead mean "no clamp" and lose the tail; deployments
                # that trim should snapshot via save_durable or pass
                # log_store= (see HubCheckpoint.snapshot).
                return 0.0
            floors.append(floor)
        return min(floors) if floors else None

    def _probe_legacy(self, path: str) -> bool:
        """Whether a headerless snapshot file is RESTORABLE legacy v1 (it
        must clamp trims) as opposed to garbage (it must not pin the log).
        One full read per (mtime, size); a transient OSError is NOT cached
        — it says nothing about the file."""
        try:
            st = os.stat(path)
        except OSError:
            return False
        key = (st.st_mtime, st.st_size)
        cached = self._legacy_probe.get(path)
        if cached is not None and (cached[0], cached[1]) == key:
            return cached[2]
        try:
            read_snapshot_file(path)
            verdict = True
        except CorruptSnapshotError:
            verdict = False
        except OSError:
            return False
        self._legacy_probe[path] = (key[0], key[1], verdict)
        return verdict
