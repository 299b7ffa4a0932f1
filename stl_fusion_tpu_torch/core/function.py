"""FunctionBase — the compute pipeline: Read → Lock → RetryRead → Compute → Store.

Re-expression of src/Stl.Fusion/Function.cs:31-115 and
Internal/ComputedExt.cs:10-76. One FunctionBase exists per compute method /
state; ``invoke`` is the single entry point that:

1. READ — lock-free registry probe; a consistent hit registers the
   dependency edge and returns immediately (the 50M-ops/sec path in the
   reference's benchmark);
2. LOCK — per-input async lock so concurrent misses compute once
   (single-flight);
3. RETRY-READ — re-probe under the lock (someone may have computed while we
   waited);
4. COMPUTE — run the user body with this node as the ambient
   dependency-capture root;
5. STORE — register the node, attach the caller's edge, renew timers.

Call modes (CallOptions) divert before compute: INVALIDATE invalidates the
existing node and returns it; GET_EXISTING peeks without computing.
"""
from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Optional

from ..utils.ltag import LTag
from ..utils.result import Result
from .computed import Computed
from .context import (
    OPT_GET_EXISTING,
    OPT_INVALIDATE_BIT,
    CallOptions,
    ComputeContext,
    change_current,
)
from .options import ComputedOptions

if TYPE_CHECKING:
    from .hub import FusionHub
    from .inputs import ComputedInput

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["FunctionBase", "ComputeMethodFunction"]


class FunctionBase:
    def __init__(self, hub: "FusionHub", options: Optional[ComputedOptions] = None):
        self.hub = hub
        self.options = options or ComputedOptions.DEFAULT

    # ------------------------------------------------------------------ invoke
    async def invoke(
        self,
        input: "ComputedInput",
        used_by: Optional[Computed],
        context: Optional[ComputeContext] = None,
    ) -> Optional[Computed]:
        context = context or ComputeContext.current()

        # READ
        existing = self.hub.registry.get(input)
        hit = self._try_use_existing(existing, context, used_by)
        if hit is not None or context.call_options & OPT_GET_EXISTING:
            return hit

        # LOCK
        async with self.hub.registry.input_locks.lock(input):
            # RETRY-READ (peek: the same logical access as the READ above —
            # monitors must not count it twice)
            existing = self.hub.registry.peek(input)
            hit = self._try_use_existing_from_lock(existing, context, used_by)
            if hit is not None:
                return hit
            # COMPUTE + STORE
            computed = await self.compute(input, existing)
        self._use_new(computed, context, used_by)
        return computed

    async def invoke_and_strip(
        self,
        input: "ComputedInput",
        used_by: Optional[Computed],
        context: Optional[ComputeContext] = None,
    ):
        context = context or ComputeContext.current()
        computed = await self.invoke(input, used_by, context)
        if computed is None:
            return None
        if context.call_options & OPT_GET_EXISTING:
            # peek/invalidate modes return the (possibly stale) value without
            # raising memoized errors; callers wanting the node use capture
            out = computed._output
            return out.value_or_default if out is not None else None
        return computed.output.value

    # ------------------------------------------------------------------ hit paths
    def _try_use_existing(
        self,
        existing: Optional[Computed],
        context: ComputeContext,
        used_by: Optional[Computed],
    ) -> Optional[Computed]:
        opts = context.call_options
        if opts & OPT_INVALIDATE_BIT:
            if existing is not None:
                sink = context.invalidation_sink
                if sink is not None:
                    # batch replay: collect; the caller cascades the whole
                    # group on device in one lane burst
                    sink.append(existing)
                else:
                    existing.invalidate()
                context.try_capture(existing)
            return existing
        if opts & OPT_GET_EXISTING:
            if existing is not None:
                context.try_capture(existing)
                existing.renew_timeouts(False)
            return existing
        if existing is None or not existing.is_consistent:
            # note: is_consistent is pending-aware — a device-wave-invalidated
            # node reads as inconsistent here without host materialization;
            # the recompute's register() displacement finishes the cleanup
            # (graph/backend.py two-tier application)
            return None
        self._use_existing(existing, context, used_by)
        return existing

    def _try_use_existing_from_lock(
        self,
        existing: Optional[Computed],
        context: ComputeContext,
        used_by: Optional[Computed],
    ) -> Optional[Computed]:
        if existing is None or not existing.is_consistent:
            return None
        self._use_existing(existing, context, used_by)
        return existing

    def _use_existing(
        self, existing: Computed, context: ComputeContext, used_by: Optional[Computed]
    ) -> None:
        if used_by is not None:
            used_by.add_used(existing)
        existing.renew_timeouts(False)
        context.try_capture(existing)

    def _use_new(
        self, computed: Computed, context: ComputeContext, used_by: Optional[Computed]
    ) -> None:
        if used_by is not None:
            used_by.add_used(computed)
        computed.renew_timeouts(True)
        context.try_capture(computed)

    # ------------------------------------------------------------------ compute
    async def compute(self, input: "ComputedInput", existing: Optional[Computed]) -> Computed:
        version = self.hub.version_generator.next(existing.version if existing is not None else None)
        computed = self.create_computed(input, version)
        self.hub.registry.register(computed)
        with change_current(computed):
            try:
                value = await self.produce_value(input, computed)
                computed.try_set_output(Result.ok(value))
            except asyncio.CancelledError:
                # a cancelled compute never becomes a cached value
                computed.invalidate(immediately=True)
                raise
            except Exception as e:  # noqa: BLE001 — errors are memoized
                computed.try_set_output(Result.err(e))
        return computed

    def create_computed(self, input: "ComputedInput", version: LTag) -> Computed:
        return Computed(input, version, self.options)

    async def produce_value(self, input: "ComputedInput", computed: Computed):
        """Run the user computation; subclasses override."""
        raise NotImplementedError


class ComputeMethodFunction(FunctionBase):
    """FunctionBase over a ``@compute_method``-decorated body
    (≈ ComputeMethodFunction<T>, Interception/ComputeMethodFunctionBase.cs)."""

    def __init__(self, hub: "FusionHub", method_def):
        super().__init__(hub, method_def.options)
        self.method_def = method_def

    def create_computed(self, input, version):
        computed = super().create_computed(input, version)
        method_def = self.method_def
        if method_def.table is not None:
            args = getattr(input, "args", ())
            if method_def.table.covers(args):
                # scalar → table coherence rides the NODE, so every
                # invalidation path (invalidating() replay, dependency
                # cascade, timed/auto invalidation) marks the columnar row
                # stale — not just explicit replays. The table's own
                # handler finds this node already invalid, so no cycle.
                # The row resolves LAZILY (codec peek, never allocating):
                # the columnar side may intern this key only after the
                # node was created — or never, in which case there is no
                # row to mark.
                service = input.service

                def mark_row_stale(_node) -> None:
                    table = method_def.peek_table(service)
                    if table is not None:
                        row = method_def.row_for_args(args, table)
                        if row is not None:
                            table.invalidate([row])

                computed.on_invalidated(mark_row_stale)
        return computed

    async def produce_value(self, input, computed):
        return await input.invoke_original()

    def __repr__(self) -> str:
        return f"ComputeMethodFunction({self.method_def.name})"
