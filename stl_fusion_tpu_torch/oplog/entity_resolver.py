"""EntityResolver — batched entity loads.

Re-expression of src/Stl.Fusion.EntityFramework/DbEntityResolver.cs: when
many concurrent compute methods each resolve one entity by key, the resolver
coalesces them into one batched backend query per event-loop tick (the
reference batches via a background processor with a batch-size cap).

``resolve(key)`` returns the entity or None; concurrent calls for the same
key share one backend fetch. The backend is any async callable
``fetch_many(keys) -> {key: entity}`` — a DB query, an RPC, a shard lookup.
"""
from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Dict, Generic, Hashable, List, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

__all__ = ["EntityResolver"]


class EntityResolver(Generic[K, V]):
    def __init__(
        self,
        fetch_many: Callable[[List[K]], Awaitable[Dict[K, V]]],
        max_batch_size: int = 256,
    ):
        self._fetch_many = fetch_many
        self.max_batch_size = max_batch_size
        self._pending: Dict[K, "asyncio.Future[Optional[V]]"] = {}
        self._flush_scheduled = False
        #: in-flight flush tasks, retained (FL003): the loop holds tasks
        #: weakly and a collected flush would strand every batched waiter
        self._flush_tasks: set = set()
        self.batches = 0  # stats: backend round trips
        self.requests = 0

    async def resolve(self, key: K) -> Optional[V]:
        self.requests += 1
        fut = self._pending.get(key)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._pending[key] = fut
            if not self._flush_scheduled:
                self._flush_scheduled = True
                # flush on the next tick so same-tick callers join the batch
                asyncio.get_running_loop().call_soon(self._spawn_flush)
        return await asyncio.shield(fut)

    async def resolve_many(self, keys: List[K]) -> Dict[K, Optional[V]]:
        results = await asyncio.gather(*(self.resolve(k) for k in keys))
        return dict(zip(keys, results))

    def _spawn_flush(self) -> None:
        self._flush_scheduled = False
        if self._pending:
            task = asyncio.ensure_future(self._flush())
            self._flush_tasks.add(task)
            task.add_done_callback(self._flush_tasks.discard)

    async def _flush(self) -> None:
        while self._pending:
            batch_keys = list(self._pending.keys())[: self.max_batch_size]
            waiters = {k: self._pending.pop(k) for k in batch_keys}
            self.batches += 1
            try:
                found = await self._fetch_many(batch_keys)
            except Exception as e:  # noqa: BLE001 — propagate to every waiter
                for fut in waiters.values():
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for k, fut in waiters.items():
                if not fut.done():
                    fut.set_result(found.get(k))
