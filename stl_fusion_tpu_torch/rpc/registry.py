"""Service/method registry.

Re-expression of src/Stl.Rpc/Configuration/RpcServiceRegistry.cs:9-50 +
RpcServiceDef/RpcMethodDef: name ↔ implementation mapping with conflict
checks, per-method metadata (no-wait), and the invocation path the inbound
side uses. A service is any object; its RPC surface is its public async
methods (or an explicit method list).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

__all__ = ["RpcMethodDef", "RpcServiceDef", "RpcServiceRegistry", "rpc_no_wait"]


def rpc_no_wait(fn: Callable) -> Callable:
    """Marks a method fire-and-forget (≈ RpcNoWait return type, RpcNoWait.cs):
    no call registration, no result message."""
    fn.__rpc_no_wait__ = True  # type: ignore[attr-defined]
    return fn


@dataclass(frozen=True)
class RpcMethodDef:
    name: str
    fn: Callable  # bound async callable
    no_wait: bool = False


class RpcServiceDef:
    def __init__(self, name: str, implementation: Any):
        self.name = name
        self.implementation = implementation
        self.methods: Dict[str, RpcMethodDef] = {}
        for mname in dir(type(implementation)):
            if mname.startswith("_"):
                continue
            attr = getattr(type(implementation), mname, None)
            if attr is None or not inspect.iscoroutinefunction(attr):
                continue
            bound = getattr(implementation, mname)
            self.methods[mname] = RpcMethodDef(
                mname, bound, no_wait=getattr(attr, "__rpc_no_wait__", False)
            )

    def method(self, name: str) -> RpcMethodDef:
        m = self.methods.get(name)
        if m is None and not name.startswith("_") and getattr(
            self.implementation, "__rpc_dynamic__", False
        ):
            # dynamic services (routing proxies) synthesize methods via
            # __getattr__. Never cached: remote callers control `name`, and
            # caching would let them grow this dict without bound.
            try:
                fn = getattr(self.implementation, name)
            except AttributeError:
                fn = None
            if fn is None or not inspect.iscoroutinefunction(fn):
                raise LookupError(f"method {self.name}.{name} is not registered")
            return RpcMethodDef(name, fn)
        if m is None:
            raise LookupError(f"method {self.name}.{name} is not registered")
        return m


class RpcServiceRegistry:
    def __init__(self):
        self._services: Dict[str, RpcServiceDef] = {}

    def add(self, name: str, implementation: Any) -> RpcServiceDef:
        if name in self._services:
            raise ValueError(f"service {name!r} is already registered")
        sd = RpcServiceDef(name, implementation)
        self._services[name] = sd
        return sd

    def get(self, name: str) -> Optional[RpcServiceDef]:
        return self._services.get(name)

    def require(self, name: str) -> RpcServiceDef:
        sd = self._services.get(name)
        if sd is None:
            raise LookupError(f"service {name!r} is not registered")
        return sd

    async def invoke(self, service: str, method: str, args: list) -> Any:
        return await self.require(service).method(method).fn(*args)

    def dump(self) -> str:
        lines = []
        for name, sd in sorted(self._services.items()):
            lines.append(f"{name} -> {type(sd.implementation).__name__}: "
                         + ", ".join(sorted(sd.methods)))
        return "\n".join(lines)
