"""Explicit graph-invariant checks — the build's race-detection story.

The reference has no sanitizer; its correctness rests on a locking
discipline (per-node monitor, per-input single-flight locks, the
double-checked Read→Lock→RetryRead pattern) plus scattered debug assertions
. This build makes the discipline *checkable*: ``validate_hub``
sweeps the registry and verifies the structural invariants that the locking
is supposed to preserve, and ``validate_mirror`` cross-checks the device CSR
mirror against host truth. Tests and stress suites call these after
hammering the graph; long-running hosts can sample them periodically (they
only take the per-node locks briefly, never the compute locks).

Invariants checked (references are the reference's enforcement points):
- I1  state/output coherence: CONSISTENT ⇒ output set; COMPUTING ⇒ no
      output (TrySetOutput, Computed.cs:141-160).
- I2  edge symmetry: for every consistent dependent d and u in d.used,
      (d.input, d.version) ∈ u.used_by — the AddUsed/AddUsedBy pairing
      (Computed.cs:347-377).
- I3  no forward edges from invalidated nodes: an INVALIDATED node's used
      set is empty (invalidation clears edges, Computed.cs:204-217).
- I4  registry interning: every registry entry resolves to a computed whose
      input equals its key (ComputedRegistry.Register, :72-105).
- I5  stale used_by entries must be version-mismatched: a used_by entry
      whose (input, version) resolves to a LIVE CONSISTENT computed of the
      SAME version must be a real dependent edge (otherwise an invalidation
      would be lost — the wave-correctness invariant).
- M1  mirror epoch coherence: device node_epoch == host mirror bookkeeping
      for every mapped node (after flush).
- M2  mirror invalidation superset: an invalidated host node that is mapped
      is marked invalid on device OR has a pending journal entry.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List

if TYPE_CHECKING:
    from ..core.hub import FusionHub
    from ..graph.backend import TpuGraphBackend

__all__ = ["InvariantViolation", "InvariantReport", "validate_hub", "validate_mirror"]


def _sample_items(items: list, sample: float, rng) -> list:
    """``rng.sample`` selection of a ``sample`` fraction — O(selected)
    picks, not an O(n) per-item coin-flip pass (the auditor runs this on
    the event loop every cycle)."""
    if sample >= 1.0 or not items:
        return items
    import random

    rng = rng if rng is not None else random.Random()
    k = max(int(len(items) * sample), 1)
    return rng.sample(items, k) if k < len(items) else items


class InvariantViolation(AssertionError):
    """Raised by ``*.require()`` when a sweep found violations."""


@dataclass
class InvariantReport:
    checked_nodes: int = 0
    checked_edges: int = 0
    violations: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def require(self) -> "InvariantReport":
        if self.violations:
            head = "\n  ".join(self.violations[:20])
            more = f"\n  … +{len(self.violations) - 20} more" if len(self.violations) > 20 else ""
            raise InvariantViolation(
                f"{len(self.violations)} graph invariant violation(s):\n  {head}{more}"
            )
        return self

    def merge(self, other: "InvariantReport") -> "InvariantReport":
        self.checked_nodes += other.checked_nodes
        self.checked_edges += other.checked_edges
        self.violations.extend(other.violations)
        return self


def validate_hub(
    hub: "FusionHub", sample: float = 1.0, rng=None
) -> InvariantReport:
    """Sweep the registry and check I1-I5. Safe to run concurrently with
    reads/invalidations — it tolerates in-flight transitions by re-reading
    node state around each check (a node may legally change state mid-sweep;
    only *stable* contradictions are reported).

    ``sample < 1.0`` checks a random fraction of nodes — the ONLINE shape
    (diagnostics.auditor): a live process amortizes the full sweep over
    cycles instead of stalling its loop on one O(graph) pass. Edge checks
    still follow every edge of a sampled node, so a violation anywhere is
    eventually found with probability → 1 over cycles. Selection is
    ``rng.sample`` (O(selected)), never a per-item coin flip — the
    remaining O(n) is the C-level snapshot of the map, the irreducible
    cost of a consistent view."""
    from ..core.consistency import ConsistencyState  # local: avoid cycle

    report = InvariantReport()
    registry = hub.registry
    with registry._lock:
        items = list(registry._map.items())
    items = _sample_items(items, sample, rng)

    for input, ref in items:
        c = ref()
        if c is None:
            continue  # dead entry; weakref callback will reap it
        report.checked_nodes += 1

        # I4: interning coherence
        if c.input != input:
            report.violations.append(f"I4: registry key {input!r} maps to node of {c.input!r}")

        state = c._state
        out = c._output
        # I1: state/output coherence (re-read state to tolerate races)
        if state == ConsistencyState.CONSISTENT and out is None and c._state == state:
            report.violations.append(f"I1: {c!r} CONSISTENT without output")
        if state == ConsistencyState.COMPUTING and out is not None and c._state == state:
            report.violations.append(f"I1: {c!r} COMPUTING but has output")

        with c._lock:
            used = list(c._used)
            state_now = c._state
        if state_now == ConsistencyState.INVALIDATED:
            # I3: invalidation clears forward edges
            if used:
                report.violations.append(f"I3: invalidated {c!r} still lists {len(used)} deps")
            continue
        # I2: edge symmetry for live dependents
        for u in used:
            report.checked_edges += 1
            with u._lock:
                has_back = (c.input, c.version) in u._used_by
                u_state = u._state
            if not has_back and c._state != ConsistencyState.INVALIDATED:
                if u_state != ConsistencyState.INVALIDATED:
                    report.violations.append(
                        f"I2: {c!r} uses {u!r} but has no used_by back-edge"
                    )

        # I5: used_by entries that resolve to a live same-version node must
        # be real dependents (else a cascade would skip them)
        with c._lock:
            back_edges = list(c._used_by)
        for (dep_input, dep_version) in back_edges:
            d = registry.get(dep_input)
            if d is None or d.version != dep_version:
                continue  # stale entry — legal, pruner's job
            if d.is_invalidated:
                continue
            with d._lock:
                forward = c in d._used
            if not forward and not d.is_invalidated and not c.is_invalidated:
                report.violations.append(
                    f"I5: {c!r} lists dependent {d!r} which does not use it"
                )
    return report


def validate_mirror(
    backend: "TpuGraphBackend", sample: float = 1.0, rng=None
) -> InvariantReport:
    """Flush pending events, then check M1-M2 device↔host coherence.

    ``sample < 1.0`` checks a random fraction of mapped nodes (the online
    auditor shape — a live 10M-node mirror must not stall the event loop
    on one O(n) Python pass; selection is O(selected) via ``rng.sample``);
    the flush itself is cheap when the journal is empty."""
    import numpy as np

    report = InvariantReport()
    backend.flush()
    graph = backend.graph
    invalid = graph.invalid_mask()
    with backend._lock:
        items = list(backend._id_by_input.items())
    items = _sample_items(items, sample, rng)
    for input, nid in items:
        ref = backend._computed_by_id.get(nid)
        c = ref() if ref is not None else None
        if c is None:
            continue
        report.checked_nodes += 1
        if nid >= graph.n_nodes:
            report.violations.append(f"M1: node id {nid} out of range for {input!r}")
            continue
        if c.is_invalidated and not bool(invalid[nid]) and not backend._journal:
            report.violations.append(
                f"M2: host-invalidated {input!r} (nid {nid}) not invalid on device"
            )
    return report
