"""The operations pipeline — commands become replayable invalidations.

Re-expression of src/Stl.Fusion/Operations/Internal/* as commander filters
at the reference's priority ordering
(FusionOperationsCommandHandlerPriority.cs):

1. ``OperationReprocessor`` (outermost) — transient-failure retry,
   MaxRetryCount=3, exponential backoff (Reprocessing/OperationReprocessor.cs:24-30);
2. ``TransientOperationScopeProvider`` — wraps every top-level non-completion,
   non-invalidating command in an Operation; on success notifies completion
   (TransientOperationScopeProvider.cs:12-46);
3. ``NestedCommandLogger`` — records nested commands into the enclosing
   operation so replay reaches them (NestedCommandLogger.cs);
4. ``OperationCompletionNotifier`` — dedups by operation id then fans out to
   listeners (OperationCompletionNotifier.cs:38-89);
5. ``CompletionProducer`` — turns a completed operation into a
   ``Completion`` command — the SAME path for local and external (other-host)
   operations (CompletionProducer.cs:29-51);
6. ``PostCompletionInvalidator`` — THE invalidation source: re-invokes the
   original command (+ logged nested commands) inside ``invalidating()``;
   compute methods hit during the replay invalidate their cached nodes
   (PostCompletionInvalidator.cs:28-115).

Handlers opt into replay with the reference idiom::

    @command_handler
    async def edit(self, cmd: EditCommand):
        if is_invalidating():
            await self.get(cmd.id)      # marks get(id) invalid
            return
        ...actual mutation...
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING, Any, Callable, List, Optional

import contextlib
import contextvars

from ..core.context import invalidating, is_invalidating
from ..utils.collections import RecentlySeenMap
from ..utils.errors import TransientError
from .operation import AgentInfo, Completion, Operation

if TYPE_CHECKING:
    from ..commands.commander import Commander
    from ..commands.context import CommandContext

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "OperationsHost",
    "attach_operations",
    "current_operation",
    "pinned_operation_scope",
]

# priority constants (higher runs earlier), mirroring the reference ordering
PRIORITY_REPROCESSOR = 100
PRIORITY_SCOPE_PROVIDER = 90
PRIORITY_NESTED_LOGGER = 80
PRIORITY_POST_COMPLETION_INVALIDATOR = 50


class InvalidationInfoProvider:
    """Decides whether a completed command's invalidation replay should run
    (≈ Operations/InvalidationInfoProvider.cs:20-46). Replay is skipped when
    the final handler is bound to a remote proxy (FusionClient /
    RoutingComputeProxy) — the OWNING host replays and pushes invalidation
    over RPC, so a local replay would double-invalidate through stale local
    state — or when the command type opts out via
    ``__requires_invalidation__ = False``."""

    def __init__(self, commander: "Commander"):
        self.commander = commander

    def requires_invalidation(self, command: Any) -> bool:
        if getattr(type(command), "__requires_invalidation__", True) is False:
            return False
        try:
            chain = self.commander.registry.resolve(command)
        except LookupError:
            return False
        final_fn = chain[-1].fn
        # remote-proxy methods are __getattr__ closures tagged with
        # __fusion_remote_proxy__ (client_function.py / service_modes.py);
        # bound methods of a proxy-ish object are covered by __self__
        target = getattr(final_fn, "__fusion_remote_proxy__", None)
        if target is None:
            target = getattr(final_fn, "__self__", None)
            wrapped = getattr(final_fn, "__wrapped__", None)
            if wrapped is not None:
                target = getattr(wrapped, "__self__", target)
        from ..client.client_function import FusionClient
        from ..client.service_modes import RoutingComputeProxy

        return not isinstance(target, (FusionClient, RoutingComputeProxy))


class OperationsHost:
    """Per-hub operations services: agent identity, completion notifier,
    completion listeners (the op-log writer subscribes here too)."""

    def __init__(self, commander: "Commander"):
        self.commander = commander
        self.agent = AgentInfo()
        self._seen = RecentlySeenMap(capacity=100_000, max_age=600.0)
        self.invalidation_info = InvalidationInfoProvider(commander)
        #: listeners: async (operation, is_local) — CompletionProducer + op-log
        self.completion_listeners: List[Callable] = [self._completion_producer]
        #: called just before a local operation completes (op-log persistence)
        self.commit_listeners: List[Callable] = []

    # -- OperationCompletionNotifier --------------------------------------
    async def notify_completed(self, operation: Operation, is_local: bool = True) -> bool:
        """Dedup by operation id, then fan out (reference
        OperationCompletionNotifier.cs:47-89). Returns False if seen before."""
        if not self._seen.try_add(operation.id):
            return False
        # local ⇔ from-local-agent assertion (reference :58-65)
        if is_local != (operation.agent_id == self.agent.id):
            log.warning(
                "operation %s locality mismatch: is_local=%s agent=%s self=%s",
                operation.id, is_local, operation.agent_id, self.agent.id,
            )
        for listener in list(self.completion_listeners):
            try:
                await listener(operation, is_local)
            except Exception:  # noqa: BLE001
                log.exception("operation completion listener failed")
        return True

    # -- CompletionProducer ------------------------------------------------
    async def _completion_producer(self, operation: Operation, is_local: bool) -> None:
        await self.commander.call(Completion(operation))


def attach_operations(commander: "Commander") -> OperationsHost:
    host = OperationsHost(commander)
    commander.operations = host  # type: ignore[attr-defined]

    # ---------------------------------------------------- OperationReprocessor
    async def operation_reprocessor(command: Any, context: "CommandContext"):
        if not context.is_outermost or isinstance(command, Completion) or is_invalidating():
            return await context.invoke_remaining_handlers()
        max_retries = 3
        tries = 0
        restart_index = context._index  # the chain position right below this filter
        while True:
            try:
                return await context.invoke_remaining_handlers()
            except TransientError:
                tries += 1
                if tries > max_retries:
                    raise
                delay = min(0.5 * (2 ** (tries - 1)), 3.0)  # 0.5 → 3s (reference :24-30)
                log.debug("transient failure, retry #%d of %r in %.2fs", tries, command, delay)
                await asyncio.sleep(delay)
                context._index = restart_index
                context.items.remove(Operation)  # a fresh operation per attempt

    # ---------------------------------------------- TransientOperationScopeProvider
    async def operation_scope_provider(command: Any, context: "CommandContext"):
        if isinstance(command, Completion) or is_invalidating() or _enclosing_operation(context) is not None:
            return await context.invoke_remaining_handlers()
        pin = _pinned_operation.get()
        if pin is not None:
            # the cluster commander pinned the operation identity: the SAME
            # op id across retries is what makes the journal dedup
            # exactly-once, and the cause id joins journal ↔ command span
            operation = Operation(
                command=command, agent_id=host.agent.id, id=pin[0], cause_id=pin[1]
            )
        else:
            operation = Operation(command=command, agent_id=host.agent.id)
        context.items.set(operation, key=Operation)
        result = await context.invoke_remaining_handlers()
        # success ⇒ commit + notify (errors propagate, no completion);
        # a DB operation scope (oplog/scope.py) stamps commit_time at its
        # actual transaction commit — don't overwrite it
        if operation.commit_time is None:
            operation.commit_time = time.time()
        for listener in list(host.commit_listeners):
            await listener(operation)
        await host.notify_completed(operation, is_local=True)
        return result

    # -------------------------------------------------------- NestedCommandLogger
    async def nested_command_logger(command: Any, context: "CommandContext"):
        if isinstance(command, Completion) or is_invalidating():
            return await context.invoke_remaining_handlers()
        parent_op = _enclosing_operation(context.outer)
        own_op = context.items.get(Operation)
        if parent_op is not None and own_op is None:
            parent_op.items.append(command)  # replay will reach this command
        return await context.invoke_remaining_handlers()

    # --------------------------------------------------- PostCompletionInvalidator
    async def post_completion_invalidator(completion: Completion, context: "CommandContext"):
        operation = completion.operation
        info = commander.operations.invalidation_info
        # gate per command: a top-level command that opts out (or routes to a
        # remote proxy) must not suppress replay of nested commands that DO
        # require local invalidation (reference PostCompletionInvalidator
        # replays each logged command on its own merits)
        to_replay = [
            c for c in (operation.command, *operation.items) if info.requires_invalidation(c)
        ]
        if to_replay:
            # contextvar-scoped: only the BATCH REPLAY task chain (the
            # op-log reader inside batch_cascade_scope) defers; a local
            # completion racing the reader on another task sees None and
            # cascades immediately — read-your-writes holds for local
            # callers no matter what the reader is doing
            collector = _batch_cascade_collector.get()
            group: Optional[List] = [] if collector is not None else None
            with invalidating(sink=group):
                for c in to_replay:
                    await _replay(commander, c)
            if collector is not None:
                collector(group)
        return await context.invoke_remaining_handlers()

    # ------------------------------------------------------- CompletionTerminator
    async def completion_terminator(completion: Completion, context: "CommandContext"):
        return None

    commander.registry.add_function(
        operation_reprocessor, command_type=object, priority=PRIORITY_REPROCESSOR, is_filter=True
    )
    commander.registry.add_function(
        operation_scope_provider, command_type=object, priority=PRIORITY_SCOPE_PROVIDER, is_filter=True
    )
    commander.registry.add_function(
        nested_command_logger, command_type=object, priority=PRIORITY_NESTED_LOGGER, is_filter=True
    )
    commander.registry.add_function(
        post_completion_invalidator,
        command_type=Completion,
        priority=PRIORITY_POST_COMPLETION_INVALIDATOR,
        is_filter=True,
    )
    commander.registry.add_function(completion_terminator, command_type=Completion)
    return host


_batch_cascade_collector: "contextvars.ContextVar[Optional[Callable]]" = (
    contextvars.ContextVar("batch_cascade_collector", default=None)
)

_pinned_operation: "contextvars.ContextVar[Optional[tuple]]" = contextvars.ContextVar(
    "fusion_pinned_operation", default=None
)


@contextlib.contextmanager
def pinned_operation_scope(operation_id: str, cause_id: Optional[str] = None):
    """Pin the identity of the NEXT top-level operation minted inside this
    task's await chain: the scope provider builds it with this
    ``operation_id`` (+ optional originating ``cause_id``) instead of a
    fresh uuid. The cluster commander wraps every routed execution in this
    so a retried command — reshard, host kill, duplicate client send —
    journals under ONE id, and replay dedup (``notify_completed`` +
    journal ``INSERT OR IGNORE``) makes the write exactly-once.
    Contextvar-scoped: concurrent commands are unaffected."""
    token = _pinned_operation.set((operation_id, cause_id))
    try:
        yield
    finally:
        _pinned_operation.reset(token)


@contextlib.contextmanager
def batch_cascade_scope(collector: Callable[[List], None]):
    """Within the CURRENT task's await chain, completion replays COLLECT
    each operation's INVALIDATE-mode hits as one group handed to
    ``collector`` instead of cascading host-side — the op-log reader wraps
    a batch in this and applies all groups as one device lane burst.
    Contextvar-scoped: concurrent tasks are unaffected."""
    token = _batch_cascade_collector.set(collector)
    try:
        yield
    finally:
        _batch_cascade_collector.reset(token)


def current_operation() -> Optional[Operation]:
    """The Operation enclosing the ambient command context, if any — the
    hook handlers use to stash pre-command state for the invalidation
    replay (≈ the reference's ``Operation.Items`` capture,
    DbAuthService.cs:54-58): append a marker command to ``op.items`` during
    execution and it is replayed inside ``invalidating()`` both locally and
    on other hosts (operation items ride the op log)."""
    from ..commands.context import current_command_context

    return _enclosing_operation(current_command_context())


def _enclosing_operation(context: Optional["CommandContext"]) -> Optional[Operation]:
    ctx = context
    while ctx is not None:
        op = ctx.items.get(Operation)
        if op is not None:
            return op
        ctx = ctx.outer
    return None


async def _replay(commander: "Commander", command: Any) -> None:
    """Re-invoke a command inside the ambient invalidating() scope; handler
    bodies run their ``if is_invalidating()`` branch."""
    try:
        await commander.call(command)
    except Exception:  # noqa: BLE001 — invalidation replay never throws outward
        log.exception("invalidation replay of %r failed", command)
