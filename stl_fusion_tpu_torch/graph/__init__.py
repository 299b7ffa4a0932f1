"""Device graph mirror (dense path), the hub backend that feeds it, and the
backend's columnar row blocks."""
from .backend import GraphBackend, RowBlock, TpuGraphBackend
from .device_graph import DeviceGraph

__all__ = ["DeviceGraph", "GraphBackend", "RowBlock", "TpuGraphBackend"]
