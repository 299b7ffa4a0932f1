"""Multitenancy — tenant registry, resolver, per-tenant workers.

Re-expression of src/Stl/Multitenancy/ (ITenantRegistry, ITenantResolver,
DefaultTenantResolver; default single-tenant registration
FusionBuilder.cs:126-132) and the per-tenant worker scaffolding of
src/Stl.Fusion.EntityFramework (DbTenantWorkerBase, DbWorkerBase,
IMultitenantDbContextFactory): each tenant gets its own operation-log
store and its own background readers, so invalidation traffic never
crosses tenant boundaries.

Tenant identity rides the Session's ``@tenantId`` suffix
(ext/session.py) — the resolver maps sessions to registered tenants.
"""
from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..utils.async_chain import WorkerBase
from .session import Session

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "Tenant",
    "TenantRegistry",
    "TenantResolver",
    "TenantNotFoundError",
    "PerTenantWorkerHost",
]


@dataclass(frozen=True)
class Tenant:
    id: str
    title: str = ""
    is_active: bool = True
    #: overload-plane lane flag: a priority (paying) tenant's
    #: attaches ride the edge AdmissionController's priority lane —
    #: admitted ahead of anonymous cold attaches and exempt from
    #: pressure shedding (EDGE.md "Overload behavior")
    priority: bool = False

    @property
    def is_default(self) -> bool:
        return self.id == ""


Tenant.DEFAULT = Tenant("")  # type: ignore[attr-defined]


class TenantNotFoundError(KeyError):
    pass


class TenantRegistry:
    """All known tenants. Single-tenant mode (the default) exposes just the
    default tenant — matching the reference's SingleTenantRegistry."""

    def __init__(self, single_tenant: bool = True):
        self.single_tenant = single_tenant
        self._tenants: Dict[str, Tenant] = {"": Tenant.DEFAULT}  # type: ignore[attr-defined]
        self._change_listeners: List[Callable[[Tenant, str], None]] = []

    @property
    def all_tenants(self) -> List[Tenant]:
        return list(self._tenants.values())

    @property
    def active_tenants(self) -> List[Tenant]:
        return [t for t in self._tenants.values() if t.is_active]

    def get(self, tenant_id: str) -> Tenant:
        tenant = self._tenants.get(tenant_id)
        if tenant is None:
            raise TenantNotFoundError(tenant_id)
        return tenant

    def try_get(self, tenant_id: str) -> Optional[Tenant]:
        return self._tenants.get(tenant_id)

    def add(self, tenant: Tenant) -> Tenant:
        if self.single_tenant and not tenant.is_default:
            raise ValueError("registry is in single-tenant mode")
        self._tenants[tenant.id] = tenant
        self._notify(tenant, "added")
        return tenant

    def remove(self, tenant_id: str) -> None:
        if tenant_id == "":
            raise ValueError("the default tenant cannot be removed")
        tenant = self._tenants.pop(tenant_id, None)
        if tenant is not None:
            self._notify(tenant, "removed")

    def on_change(self, listener: Callable[[Tenant, str], None]) -> None:
        """listener(tenant, "added"|"removed")"""
        self._change_listeners.append(listener)

    def _notify(self, tenant: Tenant, change: str) -> None:
        for listener in list(self._change_listeners):
            try:
                listener(tenant, change)
            except Exception:  # noqa: BLE001
                log.exception("tenant change listener failed")


class TenantResolver:
    """Session → Tenant (≈ DefaultTenantResolver): the session's
    ``@tenantId`` suffix selects the registered tenant; no suffix (or no
    session) resolves to the default tenant."""

    def __init__(self, registry: TenantRegistry):
        self.registry = registry

    def resolve(self, session: Optional[Session] = None) -> Tenant:
        if session is None or not session.tenant_id:
            return self.registry.get("")
        return self.registry.get(session.tenant_id)


class PerTenantWorkerHost:
    """Runs one worker per active tenant (≈ DbTenantWorkerBase): the
    factory builds a tenant's worker (e.g. its OperationLogReader); workers
    start for tenants present at ``start()`` and follow registry changes.
    """

    def __init__(self, registry: TenantRegistry, worker_factory: Callable[[Tenant], WorkerBase]):
        self.registry = registry
        self.worker_factory = worker_factory
        self.workers: Dict[str, WorkerBase] = {}
        self._orphans: List[WorkerBase] = []  # removed off-loop; stopped in stop()
        self._pending_adds: List[Tenant] = []  # added off-loop; started by flush_pending()
        self._started = False
        registry.on_change(self._on_tenant_change)

    def start(self) -> "PerTenantWorkerHost":
        self._started = True
        for tenant in self.registry.active_tenants:
            self._start_worker(tenant)
        self.flush_pending()
        return self

    def flush_pending(self) -> None:
        """Start workers for tenants added from outside the event loop
        (call from loop context, e.g. a periodic maintenance task)."""
        pending, self._pending_adds = self._pending_adds, []
        for tenant in pending:
            # re-check against the registry: the tenant may have been
            # removed (or the host stopped) since it was parked
            if self._started and self.registry.try_get(tenant.id) is not None:
                self._start_worker(tenant)

    async def stop(self) -> None:
        self._started = False
        self._pending_adds.clear()
        workers, self.workers = list(self.workers.values()), {}
        orphans, self._orphans = self._orphans, []
        for w in workers + orphans:
            await w.stop()

    def _start_worker(self, tenant: Tenant) -> None:
        if tenant.id in self.workers:
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            # registry mutated off-loop: a worker can't start here — park
            # the tenant until flush_pending() runs in loop context
            self._pending_adds.append(tenant)
            log.warning("tenant %s added off-loop; worker starts at flush_pending()", tenant.id)
            return
        worker = self.worker_factory(tenant)
        self.workers[tenant.id] = worker
        worker.start()

    def _on_tenant_change(self, tenant: Tenant, change: str) -> None:
        if not self._started:
            return
        if change == "added" and tenant.is_active:
            self._start_worker(tenant)
        elif change == "removed":
            self._pending_adds = [t for t in self._pending_adds if t.id != tenant.id]
            worker = self.workers.pop(tenant.id, None)
            if worker is None:
                return
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                # registry mutation off-loop (config reload thread): the
                # worker can't be stopped here — park it for stop()
                self._orphans.append(worker)
                log.warning("tenant %s removed off-loop; worker stops at host stop()", tenant.id)
                return
            task = loop.create_task(worker.stop())

            def observe(t: "asyncio.Task") -> None:
                if not t.cancelled() and t.exception() is not None:
                    log.error("tenant worker stop failed: %s", t.exception())

            task.add_done_callback(observe)
