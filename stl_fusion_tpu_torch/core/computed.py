"""Computed[T] — one memoized result + its edges in the dependency DAG.

Re-expression of src/Stl.Fusion/Computed.cs:28-450. A node is
``(input, version: LTag, output: Result, consistency_state)`` plus two edge
sets:
- ``_used`` — nodes this one depends on (STRONG refs: dependencies outlive
  dependents, Computed.cs:33);
- ``_used_by`` — ``(input, version)`` pairs of dependents (WEAK by design —
  resolved through the registry at invalidation time, and the version match
  means a recomputed dependent is never re-invalidated by a stale edge,
  Computed.cs:212-217).

Key invariants carried over from the reference:
- invalidation is idempotent and never raises (Computed.cs:220-229);
- a node invalidated while COMPUTING defers via ``invalidate_on_set_output``
  (the flag dance, Computed.cs:173-178);
- "dependencies that didn't finish aren't dependencies": adding an edge to an
  already-invalidated dependency invalidates the dependent instead
  (Computed.cs:347-363).

The cascade here is an explicit work-stack (no recursion limit); each node
invalidated also feeds the device-graph mirror via the hub hook, so the TPU
CSR copy stays coherent (stl_fusion_tpu.graph).
"""
from __future__ import annotations

import asyncio
import logging
import threading
from typing import TYPE_CHECKING, Any, AsyncIterator, Callable, Generic, List, Optional, Set, Tuple, TypeVar

from ..diagnostics.flight_recorder import RECORDER
from ..diagnostics.tracing import current_cause_id
from ..utils.ltag import LTag
from ..utils.result import Result
from .consistency import ConsistencyState
from .context import OPT_GET_EXISTING, CallOptions, ComputeContext, get_current
from .options import ComputedOptions

if TYPE_CHECKING:
    from .inputs import ComputedInput

T = TypeVar("T")
log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["Computed", "LAZY_WAVE_DETAIL"]

_INF = float("inf")

#: flight-journal detail stamped when a PENDING device-wave invalidation
#: (the unwatched lazy tier) is materialized on host — the wave's identity
#: is not recorded per-node (only the bit), but the MECHANISM is known and
#: explain() must not mislabel it "host-led" (diagnostics/explain.py keys
#: on this string)
LAZY_WAVE_DETAIL = "lazy device-wave invalidation materialized (wave identity not recorded per-node)"


class Computed(Generic[T]):
    __slots__ = (
        "input",
        "version",
        "options",
        "_state",
        "_output",
        "_used",
        "_used_by",
        "_invalidated_handlers",
        "_invalidate_on_set_output",
        "_delayed_invalidation_pending",
        "_lock",
        "_backend_nid",
        "_invalidation_cause",
        "_ka_renewed_until",
        "_ka_skip",
        "__weakref__",
    )

    def __init__(self, input: "ComputedInput", version: LTag, options: Optional[ComputedOptions] = None):
        self.input = input
        self.version = version
        self.options = options or ComputedOptions.DEFAULT
        self._state: int = int(ConsistencyState.COMPUTING)
        self._output: Optional[Result] = None
        self._used: Set["Computed"] = set()
        self._used_by: Set[Tuple["ComputedInput", LTag]] = set()
        self._invalidated_handlers: Optional[List[Callable[["Computed"], None]]] = None
        self._invalidate_on_set_output = False
        self._delayed_invalidation_pending = False
        self._lock = threading.Lock()
        self._backend_nid: Optional[int] = None  # device-mirror node id
        #: cause id of the wave/mutation that invalidated this node (trace
        #: propagation) — stamped by the backend's eager apply; None
        #: for plain host-led invalidations outside any wave
        self._invalidation_cause: Optional[str] = None
        self._ka_renewed_until = 0.0  # keep-alive renewal throttle window
        self._ka_skip = 0  # hit-count renewal amortizer (see renew_timeouts)

    # ------------------------------------------------------------------ state
    def _pending_probe(self) -> bool:
        """True iff a device wave invalidated this node but the host hasn't
        materialized it yet (graph/backend.py lazy tier). Near-free when no
        device mirror is attached (``_backend_nid is None``)."""
        nid = self._backend_nid
        if nid is None:
            return False
        backend = self.input.function.hub._graph_backend
        return backend is not None and bool(backend._pending[nid])

    @property
    def consistency_state(self) -> ConsistencyState:
        if self._state == ConsistencyState.CONSISTENT and self._pending_probe():
            return ConsistencyState.INVALIDATED
        return ConsistencyState(self._state)

    @property
    def is_consistent(self) -> bool:
        return self._state == ConsistencyState.CONSISTENT and not self._pending_probe()

    @property
    def is_invalidated(self) -> bool:
        s = self._state
        return s == ConsistencyState.INVALIDATED or (
            s == ConsistencyState.CONSISTENT and self._pending_probe()
        )

    @property
    def output(self) -> Result:
        out = self._output
        if out is None:
            raise RuntimeError(f"{self!r} has no output yet (still computing)")
        return out

    @property
    def value(self) -> T:
        return self.output.value

    @property
    def error(self) -> Optional[BaseException]:
        out = self._output
        return out.error if out is not None else None

    def assert_consistency_state_is_not(self, state: ConsistencyState) -> None:
        if self._state == state:
            raise RuntimeError(f"{self!r}: unexpected consistency state {state.name}")

    # ------------------------------------------------------------------ output
    def try_set_output(self, output: Result) -> bool:
        """COMPUTING → CONSISTENT. False if the node already left COMPUTING.
        (reference: Computed.cs:141-160)"""
        with self._lock:
            if self._state != ConsistencyState.COMPUTING:
                return False
            self._output = output
            self._state = int(ConsistencyState.CONSISTENT)
            invalidate_now = self._invalidate_on_set_output
        if RECORDER.enabled:
            RECORDER.note("computed", key=repr(self.input))
        if invalidate_now:
            self.invalidate(immediately=True)
        else:
            self._start_auto_invalidation(output)
        return True

    def _start_auto_invalidation(self, output: Result) -> None:
        # errors are memoized too, but self-heal after a short delay
        # (reference: TransientErrorInvalidationDelay, ComputedOptions.cs)
        delay = (
            self.options.transient_error_invalidation_delay
            if output.has_error
            else self.options.auto_invalidation_delay
        )
        if delay == _INF:
            return
        if delay <= 0:
            self.invalidate(immediately=True)
        else:
            self._hub().timeouts.schedule_invalidate(self, delay)

    # ------------------------------------------------------------------ invalidation
    def invalidate(self, immediately: bool = False) -> bool:
        """Invalidate this node and cascade through ``_used_by``.

        Returns True if THIS call transitioned the node (idempotent, never
        raises — reference Computed.cs:162-230). Without ``immediately``, a
        configured ``invalidation_delay`` debounces the wave.
        """
        if self._state == ConsistencyState.INVALIDATED:
            return False
        if self._state == ConsistencyState.CONSISTENT and self._pending_probe():
            # a device wave already computed this node's transitive closure
            # (version-matched dependents included) — materialize locally,
            # no host cascade needed
            return self.invalidate_local(_detail=LAZY_WAVE_DETAIL)
        delay = self.options.invalidation_delay
        if not immediately and delay > 0:
            with self._lock:
                if self._state == ConsistencyState.INVALIDATED or self._delayed_invalidation_pending:
                    return False
                self._delayed_invalidation_pending = True
            self._hub().timeouts.schedule_invalidate(self, delay)
            return True

        transitioned = False
        # host-led cascades stamp their cause from the open tracing span
        # (the SAME id format device waves mint at _begin_wave), so an
        # explain() chain works even when no device mirror is attached
        host_cause = current_cause_id()
        stack: List["Computed"] = [self]
        while stack:
            node = stack.pop()
            with node._lock:
                state = node._state
                if state == ConsistencyState.INVALIDATED:
                    continue
                if state == ConsistencyState.COMPUTING:
                    # the flag dance: invalidate as soon as the output lands
                    node._invalidate_on_set_output = True
                    continue
                node._state = int(ConsistencyState.INVALIDATED)
                handlers = node._invalidated_handlers
                node._invalidated_handlers = None
                used = list(node._used)
                node._used.clear()
                used_by = list(node._used_by)
                node._used_by.clear()
            if node is self:
                transitioned = True
            if host_cause is not None:
                node._invalidation_cause = host_cause
            if RECORDER.enabled:
                RECORDER.note(
                    "invalidated", key=repr(node.input), cause=node._invalidation_cause
                )
            hub = node._hub()
            hub.timeouts.cancel(node)
            if handlers:
                for h in handlers:
                    try:
                        h(node)
                    except Exception:  # noqa: BLE001 — invalidation never throws
                        log.exception("invalidation handler failed for %r", node)
            # edge cleanup: we no longer depend on anything
            for u in used:
                u._remove_used_by(node)
            # cascade: version-matched dependents only
            for inp, ver in used_by:
                c = inp.get_existing_computed()
                if c is not None and c.version == ver:
                    stack.append(c)
            hub.on_invalidated(node)
        return transitioned

    def invalidate_eventually(self) -> bool:
        """GraphBLAS-style NONBLOCKING invalidate: enqueue this
        node as a seed in the hub's wave pipeline instead of cascading now.
        The transitive closure materializes when the pipeline's next fused
        chain is harvested — ``pipeline.drain()`` is the barrier; until
        then this node (and its dependents) still read consistent. The lazy
        accumulator batches seeds arriving between dispatches, so N calls
        cost one fused device dispatch, not N.

        Falls back to ``invalidate(immediately=True)`` when no pipeline is
        attached (``FusionHub.enable_nonblocking``), so call sites can
        adopt the nonblocking form unconditionally. Returns True when the
        invalidation was enqueued or applied."""
        backend = self.input.function.hub._graph_backend
        pipeline = getattr(backend, "pipeline", None) if backend is not None else None
        if pipeline is None:
            return self.invalidate(immediately=True)
        pipeline.submit([self])
        return True

    def invalidate_local(self, _detail: Optional[str] = None) -> bool:
        """Single-node invalidation WITHOUT cascading — used when a device
        wave already computed the full transitive closure and the host just
        applies it (stl_fusion_tpu.graph.TpuGraphBackend). ``_detail`` rides
        into the flight-journal event: lazy materializations pass
        :data:`LAZY_WAVE_DETAIL` so explain() can say "device wave,
        materialized lazily" instead of mislabeling them host-led."""
        with self._lock:
            state = self._state
            if state == ConsistencyState.INVALIDATED:
                return False
            if state == ConsistencyState.COMPUTING:
                self._invalidate_on_set_output = True
                return False
            self._state = int(ConsistencyState.INVALIDATED)
            handlers = self._invalidated_handlers
            self._invalidated_handlers = None
            used = list(self._used)
            self._used.clear()
            self._used_by.clear()
        if RECORDER.enabled:
            # cause was stamped by the backend's eager apply (device waves)
            # when one exists; the wave seq auto-stamps from the recorder's
            # current_wave context during wave application
            RECORDER.note(
                "invalidated",
                key=repr(self.input),
                cause=self._invalidation_cause,
                detail=_detail,
            )
        hub = self._hub()
        hub.timeouts.cancel(self)
        if handlers:
            for h in handlers:
                try:
                    h(self)
                except Exception:  # noqa: BLE001
                    log.exception("invalidation handler failed for %r", self)
        for u in used:
            u._remove_used_by(self)
        hub.on_invalidated(self)
        return True

    def on_invalidated(self, handler: Callable[["Computed"], None]) -> None:
        """Attach an invalidation handler; fires immediately if already invalid."""
        if self._state == ConsistencyState.CONSISTENT and self._pending_probe():
            # materialize the pending device invalidation so the handler
            # observes (and fires on) the real state
            self.invalidate_local(_detail=LAZY_WAVE_DETAIL)
        fire_now = False
        with self._lock:
            if self._state == ConsistencyState.INVALIDATED:
                fire_now = True
            else:
                if self._invalidated_handlers is None:
                    self._invalidated_handlers = []
                self._invalidated_handlers.append(handler)
        if not fire_now and self._backend_nid is not None:
            # device waves must apply this node eagerly now that someone
            # is observing it (graph/backend.py two-tier application)
            backend = self._hub().graph_backend
            if backend is not None:
                backend.mark_watched(self)
        if fire_now:
            try:
                handler(self)
            except Exception:  # noqa: BLE001
                log.exception("invalidation handler failed for %r", self)

    def when_invalidated(self) -> "asyncio.Future[Computed]":
        """Awaitable completing when this node is invalidated
        (≈ ComputedExt.WhenInvalidated, ComputedExt.cs:99-125)."""
        loop = asyncio.get_event_loop()
        fut: "asyncio.Future[Computed]" = loop.create_future()

        def handler(c: "Computed") -> None:
            def done() -> None:
                if not fut.done():
                    fut.set_result(c)

            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is loop:
                done()
            else:
                loop.call_soon_threadsafe(done)

        self.on_invalidated(handler)
        return fut

    # ------------------------------------------------------------------ edges
    def add_used(self, used: "Computed") -> None:
        """Record that THIS (computing) node depends on ``used``.

        Called on the dependent while its compute body runs
        (reference AddUsed/AddUsedBy, Computed.cs:347-377).
        """
        with self._lock:
            if self._state == ConsistencyState.INVALIDATED:
                return  # our wave already passed; edge is pointless
        if not used._try_add_used_by(self.input, self.version):
            # dependency already invalidated ⇒ we are stale before we finish
            self.invalidate(immediately=True)
            return
        with self._lock:
            if self._state == ConsistencyState.INVALIDATED:
                used._remove_used_by(self)
                return
            self._used.add(used)
        self._hub().on_edge_added(self, used)

    def _try_add_used_by(self, input: "ComputedInput", version: LTag) -> bool:
        with self._lock:
            if self._state == ConsistencyState.INVALIDATED:
                return False
            self._used_by.add((input, version))
            return True

    def _remove_used_by(self, dependent: "Computed") -> None:
        with self._lock:
            self._used_by.discard((dependent.input, dependent.version))

    def prune_used_by(self) -> int:
        """Drop ``_used_by`` edges whose dependent no longer resolves to the
        recorded version (reference PruneUsedBy, Computed.cs:400-419).
        Returns the number of edges removed."""
        with self._lock:
            stale = [
                e
                for e in self._used_by
                if (c := e[0].get_existing_computed()) is None or c.version != e[1]
            ]
            for e in stale:
                self._used_by.discard(e)
            return len(stale)

    @property
    def used(self) -> Tuple["Computed", ...]:
        with self._lock:
            return tuple(self._used)

    @property
    def used_by_count(self) -> int:
        with self._lock:
            return len(self._used_by)

    # ------------------------------------------------------------------ access
    def renew_timeouts(self, is_new: bool) -> None:
        """Refresh keep-alive on access (reference Computed.cs:248-262).

        Doubly amortized: (a) a hit-count skip — only every 16th access
        even LOOKS at the clock (≈ the reference's StochasticCounter-gated
        renewal, Computed.cs:248-262 + StochasticCounter.cs), so the
        memoized-hit fast path usually costs one int compare; (b) the timer
        wheel already snaps deadlines to a duration/64 grid, so renewals
        inside one grid cell cannot move the deadline. Worst case the
        deadline lags 16 accesses + one grid cell — the same slack class
        the reference's probabilistic renewal accepts."""
        if self._state == ConsistencyState.INVALIDATED:
            return
        if not is_new:
            k = self._ka_skip
            if k > 0:
                self._ka_skip = k - 1
                return
            self._ka_skip = 15
        d = self.options.min_cache_duration
        if d > 0:
            timeouts = self._hub().timeouts
            now = timeouts.clock.now()  # the HUB clock — TestClock-coherent
            if not is_new and now < self._ka_renewed_until:
                return
            self._ka_renewed_until = now + d / 64.0
            timeouts.keep_alive(self, d, now=now)

    async def update(self) -> "Computed[T]":
        """Return the latest consistent node for this input, recomputing if
        needed (reference Computed.Update, Computed.cs:277-295)."""
        if self.is_consistent:
            return self
        return await self.input.function.invoke(self.input, used_by=None, context=ComputeContext.DEFAULT)

    async def use(self) -> T:
        """Value of the latest consistent node, registering a dependency edge
        from the currently-computing node (reference Use, Computed.cs:297-305)."""
        ctx = ComputeContext.current()
        if ctx.call_options & OPT_GET_EXISTING:
            raise RuntimeError("Computed.use() is not allowed inside a peek/invalidate scope")
        usedby = get_current()
        if self.is_consistent:
            if usedby is not None:
                usedby.add_used(self)
            self.renew_timeouts(False)
            return self.output.value
        computed = await self.input.function.invoke(self.input, used_by=usedby, context=ctx)
        return computed.output.value

    async def when(self, predicate: Callable[[T], bool], poll_delay: float = 0.05) -> "Computed[T]":
        """Await a consistent node whose value satisfies ``predicate``
        (≈ ComputedExt.When, ComputedExt.cs:166-205)."""
        computed = self
        while True:
            computed = await computed.update()
            out = computed.output
            if not out.has_error and predicate(out.value):
                return computed
            await computed.when_invalidated()

    async def changes(self) -> AsyncIterator["Computed[T]"]:
        """Stream of consistent nodes over time
        (≈ ComputedExt.Changes, ComputedExt.cs:209-231)."""
        computed = self
        while True:
            computed = await computed.update()
            yield computed
            await computed.when_invalidated()

    # ------------------------------------------------------------------ internals
    def _hub(self):
        return self.input.function.hub

    def __repr__(self) -> str:
        return (
            f"Computed({self.input!r}, {self.version}, "
            f"{ConsistencyState(self._state).name})"
        )
