"""DeviceGraph — host-managed container around the device CSR mirror.

Port of the dense path of ``stl_fusion_tpu/graph/device_graph.py``:
capacity-padded device arrays (layout in ``ops/wave.py``), batched edge
ingestion, epoch bumps on recompute, and the wave API. Host numpy staging
is authoritative for structure; the device copy is rebuilt from it when
dirty and patched in place otherwise.

Capacities double on growth, as in the JAX package. PyTorch runs eagerly and
compiles nothing per shape, so the port drops the JAX package's pow2 padding
of id batches (it only limited XLA recompiles). Edges are append-only with
tombstoning by epoch until :meth:`DeviceGraph.compact`.

The invalid state lives on the device as packed int32 words (node ``i`` is
bit ``i & 31`` of word ``i >> 5``) and on the host as a bool mask.

The topo and lat mirrors (:meth:`DeviceGraph.build_topo_mirror`): once built
and still matching the live edge set, ``run_waves_union(mirror="auto")``
sends a burst of ≤ ``LAT_SEED_MAX`` seeds to the lat mirror's O(closure)
lone wave (``ops/ell_wave.py``) and every other burst, or a lat overflow, to
one depth-free topo sweep (``ops/topo_wave.py``). The port keeps no patch
log: any structural change that alters the live edge set makes the mirror
stale (the fingerprint check of :func:`check_structure_cache`), and bursts
take the dense path until the mirror is built again — the same answers the
JAX package gets by patching. The patch path, the async rebuild, the disk
cache, adaptive passes and the lane paths are later slices (ROADMAP A.4/A.5).
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bitops import ids_to_word_masks, pack_mask_host, unpack_words_host
from ..ops.ell_wave import build_ell, ell_live_epoch_init, ell_live_union_step, widen_ell
from ..ops.topo_wave import (
    build_topo_graph,
    run_topo_sweep_passes,
    topo_graph_arrays,
    topo_mirror_finish_step,
    topo_mirror_gate_step,
)
from ..ops.wave import (
    GraphArrays,
    run_wave,
    run_wave_collect,
    run_wave_with_stats,
    run_waves_chained_packed,
    run_waves_union_packed,
    seeds_to_frontier,
)

__all__ = ["DeviceGraph", "check_structure_cache"]

_MIRROR_SLICE = "ROADMAP A.4/A.5 (mirror patch path, async rebuild, lanes; resident live loop)"


def _round_up_pow2(x: int) -> int:
    n = 1
    while n < x:
        n <<= 1
    return n


def _not_ported(what: str):
    raise NotImplementedError(f"DeviceGraph.{what} is not ported yet: {_MIRROR_SLICE}")


def check_structure_cache(entry: dict, struct_version: int, fp_fn) -> bool:
    """The shared freshness check for structure-fingerprint caches (the
    backend's sharded mirror; the topo mirror once ported): O(1) when the
    entry was already validated — or already known stale — at this
    struct_version, at most one O(edges) fingerprint hash per structural
    mutation otherwise. Mutates ``entry['validated_at']``/``['missed_at']``."""
    if entry["validated_at"] == struct_version:
        return True
    if entry.get("missed_at") == struct_version:
        return False
    if fp_fn() == entry["fp"]:
        entry["validated_at"] = struct_version
        return True
    entry["missed_at"] = struct_version
    return False


class DeviceGraph:
    def __init__(self, node_capacity: int = 1024, edge_capacity: int = 4096, device=None):
        self.device = resolve_device(device)
        self.n_cap = _round_up_pow2(max(node_capacity, 16))
        self.e_cap = _round_up_pow2(max(edge_capacity, 16))
        self.n_nodes = 0  # dense ids [0, n_nodes)
        self.n_edges = 0  # live prefix of edge arrays
        # host staging (authoritative for structure)
        self._h_edge_src = np.full(self.e_cap, self.n_cap, dtype=np.int32)
        self._h_edge_dst = np.full(self.e_cap, self.n_cap, dtype=np.int32)
        self._h_edge_dst_epoch = np.full(self.e_cap, -1, dtype=np.int32)
        self._h_node_epoch = np.zeros(self.n_cap + 1, dtype=np.int32)
        self._h_node_epoch[self.n_cap] = -2  # dummy slot never version-matches
        self._h_invalid = np.zeros(self.n_cap + 1, dtype=bool)  # host-authoritative
        self._g: Optional[GraphArrays] = None  # device copy, built lazily
        self._dirty = True
        self._init_versions()

    LAT_SEED_MAX = 256  # ≤ this many union seeds route via the lat mirror
    LAT_K = 4  # lat out-ELL build width (virtual trees bound fan-out)
    LAT_LCAP = 512
    LAT_CAP = 8192
    # guaranteed-free slots per mirror row (topo in-rows and lat out-rows), as
    # in the JAX package: the tables keep its shapes, which its patch path (a
    # later slice) splices new edges into
    PATCH_SLACK = 2

    def _init_versions(self) -> None:
        # bumped on every structural mutation: a structure cache remembers
        # the version it was last validated (or missed) at, so it pays the
        # O(edges) fingerprint check at most once per mutation
        self._struct_version = 0
        # bumped on every change to the INVALID state (waves that lit
        # something, marks, clears, epoch bumps): the sharded live bridge
        # reads it to know whether its resident mesh copy is still current
        self.invalid_version = 0
        self._topo_mirror: Optional[dict] = None  # see build_topo_mirror
        self.mirror_rebuilds = 0  # topo mirror builds
        self.mirror_bursts = 0  # bursts served by a mirror (topo or lat)
        self.lat_waves = 0  # unions served by the lat mirror

    @classmethod
    def from_numpy_state(cls, state: dict, device=None) -> "DeviceGraph":
        """Adopt a JAX ``DeviceGraph``'s host staging arrays (``_h_edge_src``,
        ``_h_edge_dst``, ``_h_edge_dst_epoch``, ``_h_node_epoch``,
        ``_h_invalid``, ``n_nodes``, ``n_edges``, ``n_cap``, ``e_cap``) — the
        port's counterpart of carrying weights across. Arrays are copied."""
        g = cls.__new__(cls)
        g.device = resolve_device(device)
        g.n_cap, g.e_cap = int(state["n_cap"]), int(state["e_cap"])
        g.n_nodes, g.n_edges = int(state["n_nodes"]), int(state["n_edges"])
        g._h_edge_src = np.array(state["_h_edge_src"], dtype=np.int32)
        g._h_edge_dst = np.array(state["_h_edge_dst"], dtype=np.int32)
        g._h_edge_dst_epoch = np.array(state["_h_edge_dst_epoch"], dtype=np.int32)
        g._h_node_epoch = np.array(state["_h_node_epoch"], dtype=np.int32)
        g._h_invalid = np.array(state["_h_invalid"], dtype=bool)
        if g._h_edge_src.shape != (g.e_cap,) or g._h_node_epoch.shape != (g.n_cap + 1,):
            raise ValueError("from_numpy_state: array shapes do not match n_cap/e_cap")
        g._g = None
        g._dirty = True
        g._init_versions()
        return g

    # ------------------------------------------------------------------ build
    def add_nodes(self, count: int) -> np.ndarray:
        """Allocate ``count`` dense node ids."""
        start = self.n_nodes
        self.n_nodes += count
        self._struct_version += 1  # n_nodes is part of the fingerprint
        if self.n_nodes > self.n_cap:
            self._grow_nodes(self.n_nodes)
        return np.arange(start, self.n_nodes, dtype=np.int32)

    def add_edges(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        dst_epoch: Optional[np.ndarray] = None,
    ) -> None:
        """Append dependency edges src(used) → dst(dependent) in batch.

        ``dst_epoch`` defaults to each dependent's CURRENT epoch — the
        "edge is valid for this version" capture rule."""
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        k = len(src)
        if k and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) > self.n_cap):
            # the kernels index bit vectors and epochs by these ids unchecked
            raise ValueError(f"add_edges: node ids must lie in [0, {self.n_cap}]")
        if self.n_edges + k > self.e_cap:
            self._grow_edges(self.n_edges + k)
        if dst_epoch is None:
            dst_epoch = self._h_node_epoch[dst]
        dst_epoch = np.broadcast_to(np.asarray(dst_epoch, dtype=np.int32), dst.shape)
        start = self.n_edges
        sl = slice(start, start + k)
        self._h_edge_src[sl] = src
        self._h_edge_dst[sl] = dst
        self._h_edge_dst_epoch[sl] = dst_epoch
        self.n_edges += k
        if self._g is not None and not self._dirty:
            # incremental device append into the padded slots: a slice copy,
            # no full re-upload of the edge arrays
            self._g.edge_src[sl] = self._upload(self._h_edge_src[sl])
            self._g.edge_dst[sl] = self._upload(self._h_edge_dst[sl])
            self._g.edge_dst_epoch[sl] = self._upload(self._h_edge_dst_epoch[sl])
            self._g = self._g._replace(n_live=self.n_edges)
        else:
            self._dirty = True
        self._struct_version += 1

    def bump_epochs(self, node_ids: np.ndarray) -> None:
        """Nodes recomputed: new epoch ⇒ their stale in-edges go dead, and
        their invalid flag clears. Ids are UNIQUE-ified first: the host fancy
        ``+=`` applies once per unique id while a device ``index_add_`` adds
        once per occurrence — a duplicated batch would diverge the copies."""
        node_ids = np.unique(np.asarray(node_ids, dtype=np.int32))
        if node_ids.size == 0:
            return
        self._h_node_epoch[node_ids] += 1
        self._h_invalid[node_ids] = False
        self._struct_version += 1
        self.invalid_version += 1
        if self._g is not None and not self._dirty:
            ids = self._upload(node_ids).long()
            self._g.node_epoch.index_add_(
                0, ids, torch.ones(len(node_ids), dtype=torch.int32, device=self.device)
            )
            self._device_invalid_update(node_ids, False)
        else:
            self._dirty = True

    def mark_invalid(self, node_ids: np.ndarray) -> None:
        """Externally-observed invalidations (host-led waves) → mirror state."""
        node_ids = np.asarray(node_ids, dtype=np.int32)
        if node_ids.size == 0:
            return
        self._h_invalid[node_ids] = True
        self.invalid_version += 1
        self._device_invalid_update(node_ids, True)

    def clear_invalid_ids(self, node_ids: np.ndarray) -> None:
        """Refreshed rows are consistent again WITHOUT an epoch bump."""
        node_ids = np.asarray(node_ids, dtype=np.int32)
        if node_ids.size == 0:
            return
        self._h_invalid[node_ids] = False
        self.invalid_version += 1
        self._device_invalid_update(node_ids, False)

    def _device_invalid_update(self, node_ids: np.ndarray, value: bool) -> None:
        """Apply a host-side invalid change to the device words. Small
        batches rewrite only the words they touch (one scatter of per-word
        OR masks, each word once); a batch whose ids outweigh the packed
        mask uploads the host-authoritative mask instead."""
        if self._g is None or self._dirty:
            return
        inv = self._g.invalid
        if node_ids.size > inv.shape[0]:
            inv.copy_(self._upload(pack_mask_host(self._h_invalid)))
            return
        words, masks = ids_to_word_masks(node_ids)
        w = self._upload(words)
        m = self._upload(masks)
        inv[w] = (inv[w] | m) if value else (inv[w] & ~m)

    def _grow_nodes(self, need: int) -> None:
        new_cap = _round_up_pow2(need)
        node_epoch = np.zeros(new_cap + 1, dtype=np.int32)
        node_epoch[: self.n_cap] = self._h_node_epoch[: self.n_cap]
        node_epoch[new_cap] = -2
        invalid = np.zeros(new_cap + 1, dtype=bool)
        invalid[: self.n_cap] = self._h_invalid[: self.n_cap]
        # re-point padded edges at the new dummy slot
        self._h_edge_src[self._h_edge_src == self.n_cap] = new_cap
        self._h_edge_dst[self._h_edge_dst == self.n_cap] = new_cap
        self._h_node_epoch = node_epoch
        self._h_invalid = invalid
        self.n_cap = new_cap
        self._dirty = True

    def _grow_edges(self, need: int) -> None:
        new_cap = _round_up_pow2(need)
        for name in ("_h_edge_src", "_h_edge_dst"):
            arr = np.full(new_cap, self.n_cap, dtype=np.int32)
            arr[: self.n_edges] = getattr(self, name)[: self.n_edges]
            setattr(self, name, arr)
        epoch = np.full(new_cap, -1, dtype=np.int32)
        epoch[: self.n_edges] = self._h_edge_dst_epoch[: self.n_edges]
        self._h_edge_dst_epoch = epoch
        self.e_cap = new_cap
        self._dirty = True

    # ------------------------------------------------------------------ device sync
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → a FRESH device tensor. ``torch.from_numpy`` aliases
        the numpy buffer, and on the CPU ``.to`` would keep that alias; the
        staging arrays are later mutated in place (epoch ``+=``, edge
        splices, invalid marks), so an aliased device copy would absorb
        those writes on top of its own updates. ``copy=True`` always copies."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, copy=True)

    def device_arrays(self) -> GraphArrays:
        """Materialize (or reuse) the device copy; host staging is
        authoritative for structure AND invalid state at rebuild time."""
        if self._g is None or self._dirty:
            self._g = GraphArrays(
                edge_src=self._upload(self._h_edge_src),
                edge_dst=self._upload(self._h_edge_dst),
                edge_dst_epoch=self._upload(self._h_edge_dst_epoch),
                node_epoch=self._upload(self._h_node_epoch),
                invalid=self._upload(pack_mask_host(self._h_invalid)),
                n_live=self.n_edges,
            )
            self._dirty = False
        return self._g

    def _seed_frontier(self, seed_ids) -> torch.Tensor:
        ids = self._upload(np.asarray(seed_ids, dtype=np.int32).reshape(-1))
        return seeds_to_frontier(self.n_cap, ids)

    # ------------------------------------------------------------------ waves
    def run_wave(self, seed_ids: Sequence[int], with_stats: bool = False):
        """Cascade from ``seed_ids``; returns newly-invalidated count
        (+ BFS depth with stats). The device arrays keep the result state."""
        g = self.device_arrays()
        seeds = self._seed_frontier(seed_ids)
        if with_stats:
            self._g, count, depth = run_wave_with_stats(seeds, g)
            self._sync_invalid_back()
            return count, depth
        self._g, count = run_wave(seeds, g)
        self._sync_invalid_back()
        return count

    def run_wave_collect(
        self, seed_ids: Sequence[int], cap: int = 8192
    ) -> Tuple[int, np.ndarray]:
        """Cascade from ``seed_ids`` and return (count, newly-invalidated
        node ids in ascending order) with an O(wave) readback; only on
        overflow (count > cap) does it read back the packed mask. The host
        ``_h_invalid`` copy is patched from the ids."""
        g = self.device_arrays()
        self._g, count, ids, overflow = run_wave_collect(self._seed_frontier(seed_ids), g, cap)
        return count, self._patch_host_invalid(count, ids.cpu().numpy(), overflow)

    def _patch_host_invalid(self, count: int, ids: np.ndarray, overflow: bool) -> np.ndarray:
        """Apply a compacted-wave readback to ``_h_invalid``: the id buffer
        when it fit, otherwise a mask diff against the device words (read
        back bit-packed). Returns the newly-invalid ids."""
        if count or overflow:
            self.invalid_version += 1
        if overflow:
            dev_mask = unpack_words_host(self._g.invalid.cpu().numpy(), len(self._h_invalid))
            newly = dev_mask & ~self._h_invalid
            newly_ids = np.nonzero(newly)[0].astype(np.int32)
            self._h_invalid |= newly
        else:
            newly_ids = ids[:count] if count else np.empty(0, np.int32)
            self._h_invalid[newly_ids] = True
        return newly_ids

    def run_waves_chained(self, seed_id_lists: Sequence[Sequence[int]]):
        """Chain many seed waves, each over the state the previous one left.
        Returns (per-wave counts int64[W], union newly ids)."""
        g = self.device_arrays()
        width = max((len(s) for s in seed_id_lists), default=1)
        mat = np.full((len(seed_id_lists), max(width, 1)), -1, dtype=np.int32)
        for i, s in enumerate(seed_id_lists):
            mat[i, : len(s)] = np.asarray(s, dtype=np.int32)
        self._g, counts, newly_w = run_waves_chained_packed(self._upload(mat), g)
        newly = unpack_words_host(newly_w.cpu().numpy(), self.n_cap + 1)  # 1 bit/node
        if newly.any():  # a no-op wave leaves the version alone
            self.invalid_version += 1
        self._h_invalid |= newly
        return counts.numpy().astype(np.int64), np.nonzero(newly)[0].astype(np.int32)

    def run_waves_union(self, seed_id_lists: Sequence[Sequence[int]], mirror: str = "auto"):
        """Union cascade for a burst of seed waves: ONE expansion from all
        seeds together. Returns (total newly count, union newly ids).

        ``mirror``: "auto" rides the topo mirror when one was built with
        :meth:`build_topo_mirror` and the live edge set still matches it: a
        burst of at most ``LAT_SEED_MAX`` seeds runs the lat mirror's lone
        wave (ids come back ascending), any other burst — or a lat overflow —
        one depth-free topo sweep (ids in topo-row order); "off" forces the
        dense BFS path."""
        if mirror not in ("auto", "off"):
            raise ValueError(f"mirror must be 'auto' or 'off', got {mirror!r}")
        flat = [np.asarray(s, dtype=np.int64).reshape(-1) for s in seed_id_lists]
        flat = np.concatenate(flat) if flat else np.empty(0, np.int64)
        if mirror == "auto" and self._mirror_valid():
            m = self._topo_mirror
            # out-of-contract seed ids (unallocated slots) only the dense
            # path can represent: those bursts fall through to it
            if not len(flat) or (flat.min() >= 0 and flat.max() < m["n_nodes"]):
                if 0 < len(flat) <= self.LAT_SEED_MAX:
                    res = self._run_lat_union(m["lat"], flat)
                    if res is not None:
                        return res
                return self._run_mirror_union(flat)
        g = self.device_arrays()
        self._g, count, newly_w = run_waves_union_packed(self._upload(flat.astype(np.int32)), g)
        newly = unpack_words_host(newly_w.cpu().numpy(), self.n_cap + 1)  # 1 bit/node
        if newly.any():  # a no-op wave leaves the version alone
            self.invalid_version += 1
        self._h_invalid |= newly
        return count, np.nonzero(newly)[0].astype(np.int32)

    def run_wave_frontier(self, seed_frontier: torch.Tensor, sync_host: bool = False) -> int:
        """Wave from a prebuilt bool frontier (bench hot path — the host copy
        of the invalid state stays stale unless ``sync_host``)."""
        g = self.device_arrays()
        self.invalid_version += 1
        self._g, count = run_wave(seed_frontier, g)
        if sync_host:
            self._sync_invalid_back()
        return count

    def _sync_invalid_back(self) -> None:
        """After a device wave the device invalid words are newer — pull
        them bit-packed."""
        self.invalid_version += 1
        self._h_invalid = unpack_words_host(self._g.invalid.cpu().numpy(), self.n_cap + 1)

    # ------------------------------------------------------------------ topo and lat mirrors
    def _live_edge_fingerprint(self):
        """(live src, live dst, fingerprint) of the CURRENT live edge set
        (epoch-matched edges only). The fingerprint covers each live edge's
        captured epoch too, which the lat mirror's slots carry: a recompute
        that recaptures the same edges at new epochs changes it, as does any
        append of a live edge, epoch bump that kills an in-edge, or node
        allocation; ``compact`` (dead edges only) does not. (JAX hashes the
        ids alone and keeps the lat slots current through its patch log.)"""
        m = self.n_edges
        live = self._h_node_epoch[self._h_edge_dst[:m]] == self._h_edge_dst_epoch[:m]
        src = self._h_edge_src[:m][live]
        dst = self._h_edge_dst[:m][live]
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64(self.n_nodes).tobytes())
        h.update(src.tobytes())
        h.update(dst.tobytes())
        h.update(self._h_edge_dst_epoch[:m][live].tobytes())
        return src, dst, h.digest()

    def _mirror_valid(self) -> bool:
        """Is the built mirror usable RIGHT NOW? O(1) at a structure version
        already validated (or known stale); otherwise one fingerprint check
        per structural change. A stale mirror stays stale until
        :meth:`build_topo_mirror` runs again (no patch log in the port)."""
        m = self._topo_mirror
        if m is None:
            return False
        return check_structure_cache(
            m, self._struct_version, lambda: self._live_edge_fingerprint()[2]
        )

    def build_topo_mirror(self, k: int = 4, cap: int = 65536, force: bool = False) -> dict:
        """Build (or refresh) the topo mirror of the LIVE edge set: the
        level-ordered in-ELL (``ops/topo_wave.py``, ``k`` in-slots plus
        ``PATCH_SLACK``) that runs a whole burst in ONE depth-free sweep, and
        the lat mirror (the out-ELL of ``ops/ell_wave.py``, ``LAT_K`` plus
        ``PATCH_SLACK``) for lone waves. Synchronous; rebuilt only when the
        live-edge fingerprint changed (or ``force``). Bursts read and write
        the dense device invalid words directly, so the states never
        diverge; epoch checks inside the mirror are unneeded because it holds
        exactly the live edges."""
        cached = self._topo_mirror
        same = cached is not None and cached["cap"] == cap and cached["k"] == k
        if not force and same and self._mirror_valid():
            return cached
        src, dst, fp = self._live_edge_fingerprint()
        if not force and same and cached["fp"] == fp:
            cached["validated_at"] = self._struct_version
            cached.pop("missed_at", None)
            return cached
        topo = build_topo_graph(src, dst, self.n_nodes, k=k, slack=self.PATCH_SLACK)
        lat = widen_ell(build_ell(src, dst, self.n_nodes, k=self.LAT_K), self.PATCH_SLACK)
        return self._install_topo_mirror(topo, lat, k, cap, fp)

    def _install_topo_mirror(self, topo, lat, k: int, cap: int, fp) -> dict:
        """Upload a built ``TopoGraph`` and its lat ``EllGraph`` as the
        active mirror, valid at the current structure version."""
        self.mirror_rebuilds += 1
        n_tot = topo.n_tot
        node_epoch0 = torch.zeros(n_tot + 1, dtype=torch.int32, device=self.device)
        node_epoch0[n_tot] = -2
        self._topo_mirror = {
            "fp": fp,
            "cap": cap,
            "k": k,
            "validated_at": self._struct_version,
            "n_nodes": self.n_nodes,
            "n_tot": n_tot,
            "inv_perm": topo.inv_perm,
            "garrays": topo_graph_arrays(topo, self.device),
            "node_epoch0": node_epoch0,
            # original id per topo row, clipped into the dense arrays (virtual
            # rows would index past n_cap; is_real masks them)
            "perm_clipped": self._upload(np.clip(topo.perm, 0, self.n_cap).astype(np.int32)),
            "level_starts": topo.level_starts,
            "levels": len(topo.level_starts) - 1,
            "lat": self._materialize_lat(lat),
        }
        return self._topo_mirror

    def _materialize_lat(self, lat) -> dict:
        """Device half of the lat mirror: upload the out-ELL id table and
        derive each slot's captured epoch on the device from the resident
        epochs (the edge snapshot and the epochs are of the same moment)."""
        g = self.device_arrays()
        ell_dst = self._upload(lat.ell_dst)
        return {
            "n_tot": lat.n_tot,
            "n_real": lat.n_real,
            "k": lat.k,
            "ell_dst": ell_dst,
            "ell_epoch": ell_live_epoch_init(lat.n_real, self.n_cap)(ell_dst, g.node_epoch),
        }

    def _run_lat_union(self, lat: dict, flat_ids: np.ndarray):
        """Small union wave on the lat mirror. Returns (count, newly real
        ids ascending) or None on capacity overflow (state untouched; the
        caller runs the topo sweep)."""
        g = self.device_arrays()
        ids = np.full(self.LAT_SEED_MAX, lat["n_tot"], dtype=np.int32)
        ids[: len(flat_ids)] = flat_ids
        step = ell_live_union_step(
            lat["n_tot"], lat["n_real"], self.n_cap, self.LAT_LCAP, self.LAT_CAP
        )
        _, count, acc, over = step(lat["ell_dst"], lat["ell_epoch"], g.node_epoch, g.invalid,
                                   self._upload(ids))
        if over:
            return None
        self.mirror_bursts += 1
        self.lat_waves += 1
        # acc is sorted ascending: the real ids (< n_real) are its prefix
        newly = acc[:count].cpu().numpy().astype(np.int32)
        if count:
            self.invalid_version += 1
            self._h_invalid[newly] = True
        return count, newly

    def _run_mirror_union(self, flat_ids: np.ndarray):
        """A union burst as one topo sweep: gate (dense-BFS blocking through
        the sweep's epochs) → ``run_topo_sweep_passes`` → finish (count,
        compact, write back into the dense words)."""
        m = self._topo_mirror
        n_tot = m["n_tot"]
        g = self.device_arrays()
        garrays = m["garrays"]
        new_ids = self._upload(m["inv_perm"][flat_ids].astype(np.int32))
        node_epoch, seed_bits = topo_mirror_gate_step(n_tot)(
            garrays.is_real, m["node_epoch0"], m["perm_clipped"], g.invalid, new_ids
        )
        # one pass: a freshly built mirror has no level-violating edges
        state = run_topo_sweep_passes(m["level_starts"], garrays, seed_bits, node_epoch, 1)
        _, count, out_ids, overflow = topo_mirror_finish_step(m["cap"], n_tot)(
            garrays.is_real, m["perm_clipped"], g.invalid, state.invalid_bits
        )
        self.mirror_bursts += 1
        return count, self._patch_host_invalid(count, out_ids.cpu().numpy(), overflow)

    # ------------------------------------------------------------------ later slices
    def start_topo_mirror_rebuild(self, *args, **kwargs):
        _not_ported("start_topo_mirror_rebuild")

    def poll_topo_mirror_rebuild(self, *args, **kwargs):
        _not_ported("poll_topo_mirror_rebuild")

    def set_adaptive_passes(self, *args, **kwargs):
        _not_ported("set_adaptive_passes")

    def run_waves_union_seq(self, *args, **kwargs):
        _not_ported("run_waves_union_seq")

    def run_waves_lanes(self, *args, **kwargs):
        _not_ported("run_waves_lanes")

    def run_waves_lanes_chain(self, *args, **kwargs):
        _not_ported("run_waves_lanes_chain")

    def dispatch_waves_lanes_chain(self, *args, **kwargs):
        _not_ported("dispatch_waves_lanes_chain")

    def harvest_waves_lanes_chain(self, *args, **kwargs):
        _not_ported("harvest_waves_lanes_chain")

    def dispatch_waves_superround(self, *args, **kwargs):
        _not_ported("dispatch_waves_superround")

    def register_aux_delta_log(self, *args, **kwargs):
        _not_ported("register_aux_delta_log")

    # ------------------------------------------------------------------ readback
    def invalid_mask(self) -> np.ndarray:
        g = self.device_arrays()
        return unpack_words_host(g.invalid.cpu().numpy(), self.n_nodes)

    def invalid_ids(self) -> np.ndarray:
        return np.nonzero(self.invalid_mask())[0].astype(np.int32)

    def clear_invalid(self) -> None:
        self.invalid_version += 1
        g = self.device_arrays()
        g.invalid.zero_()
        self._h_invalid = np.zeros(self.n_cap + 1, dtype=bool)

    def compact(self) -> int:
        """Drop dead edges (epoch-mismatched) — the pruner sweep. Returns
        removed count."""
        live = (
            self._h_node_epoch[self._h_edge_dst[: self.n_edges]]
            == self._h_edge_dst_epoch[: self.n_edges]
        )
        removed = int((~live).sum())
        if removed == 0:
            return 0
        k = int(live.sum())
        for name in ("_h_edge_src", "_h_edge_dst", "_h_edge_dst_epoch"):
            arr = getattr(self, name)
            kept = arr[: self.n_edges][live]
            pad_val = self.n_cap if name != "_h_edge_dst_epoch" else -1
            arr[:k] = kept
            arr[k : self.n_edges] = pad_val
        self.n_edges = k
        self._dirty = True
        self._struct_version += 1
        return removed
