"""FusionHub — the composition root (≈ FusionBuilder + FusionInternalHub).

Re-expression of src/Stl.Fusion/FusionBuilder.cs:18-320 +
Internal/FusionInternalHub.cs, minus the DI container: a hub owns the
registry, version generator, clocks, timer wheels, the command pipeline
(attached by stl_fusion_tpu_torch.commands), and the optional device-graph mirror
(attached by stl_fusion_tpu_torch.graph). Services bind to a hub; a process-wide
default hub serves the common single-hub case.

The ``on_invalidated`` / ``on_edge_added`` hooks are the host→device feed:
the TPU graph backend subscribes here to keep the CSR mirror coherent with
the authoritative host graph.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional

from ..utils.ltag import LTagVersionGenerator, VersionGenerator
from ..utils.moment import MomentClockSet
from .registry import ComputedRegistry
from .settings import settings
from .timeouts import Timeouts

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = ["FusionHub", "default_hub", "set_default_hub"]


class FusionHub:
    def __init__(
        self,
        clocks: Optional[MomentClockSet] = None,
        version_generator: Optional[VersionGenerator] = None,
        timer_quanta: Optional[float] = None,
    ):
        self.clocks = clocks or MomentClockSet()
        self.version_generator = version_generator or LTagVersionGenerator()
        self.registry = ComputedRegistry()
        if timer_quanta is None:
            timer_quanta = settings.timer_quanta
        self.timeouts = Timeouts(self.clocks.cpu, quanta=timer_quanta)
        #: hooks feeding the device CSR mirror + diagnostics
        self.invalidated_hooks: List[Callable] = []
        self.edge_added_hooks: List[Callable] = []
        self._commander = None  # attached lazily by stl_fusion_tpu_torch.commands
        self._graph_backend = None  # attached by stl_fusion_tpu.graph
        self._services: dict = {}

    # -- service container (minimal DI) -----------------------------------
    def add_service(self, service, key=None):
        """Register a service instance under its type (or an explicit key)."""
        self._services[key or type(service)] = service
        if hasattr(service, "_bind_hub"):
            service._bind_hub(self)
        return service

    def get_service(self, key):
        svc = self._services.get(key)
        if svc is None:
            if isinstance(key, type):
                # interface lookup: first registration whose type subclasses key
                for k, v in self._services.items():
                    if isinstance(k, type) and issubclass(k, key):
                        return v
            raise KeyError(f"service {key!r} is not registered in this hub")
        return svc

    # -- command pipeline --------------------------------------------------
    @property
    def commander(self):
        if self._commander is None:
            from ..commands.commander import Commander

            self._commander = Commander(self)
        return self._commander

    # -- device graph mirror ----------------------------------------------
    @property
    def graph_backend(self):
        return self._graph_backend

    def attach_graph_backend(self, backend) -> None:
        self._graph_backend = backend

    # -- nonblocking wave pipeline ------------------------------------
    @property
    def wave_pipeline(self):
        """The attached :class:`~stl_fusion_tpu_torch.graph.WavePipeline`,
        or None while the hub runs blocking (one wave per dispatch)."""
        backend = self._graph_backend
        return getattr(backend, "pipeline", None) if backend is not None else None

    def enable_nonblocking(self, fuse_depth: int = 8, **kwargs):
        """Attach a nonblocking wave pipeline to the hub's graph backend:
        ``Computed.invalidate_eventually`` and the burst paths then
        accumulate seeds lazily and fuse consecutive waves into chained
        device dispatches, with fence fan-out overlapped against device
        execution (``graph/nonblocking.py``). Idempotent — returns the live
        pipeline when one is already attached. Requires a TpuGraphBackend
        (raises otherwise: with no device mirror there is nothing to
        fuse)."""
        backend = self._graph_backend
        if backend is None:
            raise RuntimeError("enable_nonblocking needs a TpuGraphBackend attached to this hub")
        if backend.pipeline is not None:
            return backend.pipeline
        from ..graph.nonblocking import WavePipeline

        return WavePipeline(backend, fuse_depth=fuse_depth, **kwargs)

    # -- host→device event feed -------------------------------------------
    def on_invalidated(self, computed) -> None:
        for h in self.invalidated_hooks:
            try:
                h(computed)
            except Exception:  # noqa: BLE001
                log.exception("invalidated hook failed")

    def on_edge_added(self, dependent, used) -> None:
        for h in self.edge_added_hooks:
            try:
                h(dependent, used)
            except Exception:  # noqa: BLE001
                log.exception("edge hook failed")


_default_hub: Optional[FusionHub] = None


def default_hub() -> FusionHub:
    global _default_hub
    if _default_hub is None:
        _default_hub = FusionHub()
    return _default_hub


def set_default_hub(hub: Optional[FusionHub]) -> Optional[FusionHub]:
    """Swap the process-default hub (tests use this for isolation)."""
    global _default_hub
    old = _default_hub
    _default_hub = hub
    return old
