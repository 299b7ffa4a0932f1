"""Device graph mirror, the hub backend that feeds it, the backend's columnar
row blocks, and the nonblocking planes: the wave pipeline and the resident
super-rounds."""
from .backend import GraphBackend, RowBlock, TpuGraphBackend
from .device_graph import DeviceGraph
from .nonblocking import WavePipeline, WaveTicket
from .program_cache import enable_program_cache, program_cache_stats
from .superround import SuperRoundProgram, SuperRoundTicket

__all__ = [
    "DeviceGraph",
    "GraphBackend",
    "RowBlock",
    "SuperRoundProgram",
    "SuperRoundTicket",
    "TpuGraphBackend",
    "WavePipeline",
    "WaveTicket",
    "enable_program_cache",
    "program_cache_stats",
]
