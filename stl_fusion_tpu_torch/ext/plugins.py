"""Plugin host — discovery + capability metadata + dependency-ordered start.

Re-expression of src/Stl.Plugins/ (PluginHost.cs, FileSystemPluginFinder.cs,
Metadata/PluginSetInfo.cs): plugins are classes marked with ``@plugin``
carrying capability tags and dependency edges; a finder scans python
modules/packages for them; the host instantiates singletons in dependency
order and answers capability queries. BASELINE.json names this as the
backend registration point — e.g. alternative operation-log stores or
transports register themselves as plugins.
"""
from __future__ import annotations

import importlib
import logging
import pkgutil
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Type

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["plugin", "PluginInfo", "PluginSetInfo", "PluginHost", "find_plugins"]


@dataclass(frozen=True)
class PluginInfo:
    plugin_type: Type
    name: str
    capabilities: Tuple[str, ...] = ()
    dependencies: Tuple[str, ...] = ()  # names of plugins that must start first


def plugin(
    cls: Optional[Type] = None,
    *,
    name: Optional[str] = None,
    capabilities: Sequence[str] = (),
    dependencies: Sequence[str] = (),
):
    """Mark a class as a plugin (≈ the reference's plugin attribute +
    PluginInfo metadata)."""

    def decorate(klass: Type) -> Type:
        klass.__plugin_info__ = PluginInfo(  # type: ignore[attr-defined]
            klass,
            name or klass.__name__,
            tuple(capabilities),
            tuple(dependencies),
        )
        return klass

    return decorate(cls) if cls is not None else decorate


def find_plugins(module_names: Iterable[str], recurse: bool = True) -> List[PluginInfo]:
    """Scan modules (and optionally their submodules) for ``@plugin``
    classes (≈ FileSystemPluginFinder's assembly scan)."""
    infos: List[PluginInfo] = []
    seen_modules = set()

    def scan_module(mod) -> None:
        if mod.__name__ in seen_modules:
            return
        seen_modules.add(mod.__name__)
        for attr_name in dir(mod):
            attr = getattr(mod, attr_name, None)
            info = getattr(attr, "__plugin_info__", None)
            if isinstance(info, PluginInfo) and info.plugin_type is attr:
                if info not in infos:
                    infos.append(info)
        if recurse and hasattr(mod, "__path__"):
            for sub in pkgutil.iter_modules(mod.__path__):
                try:
                    scan_module(importlib.import_module(f"{mod.__name__}.{sub.name}"))
                except Exception:  # noqa: BLE001 — a broken module skips, not aborts
                    log.exception("plugin scan failed for %s.%s", mod.__name__, sub.name)

    for name in module_names:
        scan_module(importlib.import_module(name))
    return infos


@dataclass
class PluginSetInfo:
    """Immutable-ish metadata for a discovered plugin set (≈ PluginSetInfo)."""

    plugins: List[PluginInfo] = field(default_factory=list)

    @property
    def names(self) -> List[str]:
        return [p.name for p in self.plugins]

    def by_capability(self, capability: str) -> List[PluginInfo]:
        return [p for p in self.plugins if capability in p.capabilities]

    def get(self, name: str) -> Optional[PluginInfo]:
        for p in self.plugins:
            if p.name == name:
                return p
        return None

    def start_order(self) -> List[PluginInfo]:
        """Topological order by declared dependencies; cycles raise."""
        by_name = {p.name: p for p in self.plugins}
        order: List[PluginInfo] = []
        state: Dict[str, int] = {}  # 1 = visiting, 2 = done

        def visit(p: PluginInfo) -> None:
            mark = state.get(p.name, 0)
            if mark == 2:
                return
            if mark == 1:
                raise ValueError(f"plugin dependency cycle through {p.name!r}")
            state[p.name] = 1
            for dep in p.dependencies:
                dep_info = by_name.get(dep)
                if dep_info is None:
                    raise LookupError(f"plugin {p.name!r} depends on unknown {dep!r}")
                visit(dep_info)
            state[p.name] = 2
            order.append(p)

        for p in self.plugins:
            visit(p)
        return order


class PluginHost:
    """Instantiates plugins (singletons, dependency-ordered) and serves
    capability queries (≈ PluginHost)."""

    def __init__(
        self,
        infos: Sequence[PluginInfo],
        factory: Optional[Callable[[PluginInfo, "PluginHost"], Any]] = None,
    ):
        self.set_info = PluginSetInfo(list(infos))
        self._factory = factory or (lambda info, host: info.plugin_type())
        self._instances: Dict[str, Any] = {}
        for info in self.set_info.start_order():
            self._instances[info.name] = self._factory(info, self)

    @staticmethod
    def from_modules(module_names: Iterable[str], **kwargs) -> "PluginHost":
        return PluginHost(find_plugins(module_names), **kwargs)

    def get(self, name_or_type) -> Any:
        if isinstance(name_or_type, str):
            instance = self._instances.get(name_or_type)
        else:
            info = getattr(name_or_type, "__plugin_info__", None)
            instance = self._instances.get(info.name) if info else None
        if instance is None:
            raise LookupError(f"plugin {name_or_type!r} is not hosted")
        return instance

    def with_capability(self, capability: str) -> List[Any]:
        return [self._instances[p.name] for p in self.set_info.by_capability(capability)]

    def __contains__(self, name: str) -> bool:
        return name in self._instances

    def __len__(self) -> int:
        return len(self._instances)
