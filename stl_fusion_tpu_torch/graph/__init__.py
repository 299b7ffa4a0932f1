"""Device graph mirror (dense path) and the hub backend that feeds it."""
from .backend import GraphBackend, TpuGraphBackend
from .device_graph import DeviceGraph

__all__ = ["DeviceGraph", "GraphBackend", "TpuGraphBackend"]
