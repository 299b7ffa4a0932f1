"""Device ops of the invalidation wave: bit packing, the ``or_popcount``
finalizer, the BFS level (``wave_expand``: pure, merged, and for every shard
of a mesh at once), the ring all-gather, the topo sweep (``topo_wave``) and
the row block's refresh (``block_refresh``) and the packed pull level
(``packed_pull``), each hand-written kernel beside its plain PyTorch
version; the ELL builders and lone-wave lat programs (``ell_wave``), the
bit-packed seed packers and the pull wave (``pull_wave``), and the
columnar memo table (``memo_table``) with its scalar-graph bridge
(``memo_bridge``)."""
from .memo_bridge import MemoTableBridge
from .memo_table import MemoTable
from .wave import GraphArrays, run_wave, run_wave_with_stats, seeds_to_frontier, wave_step

__all__ = [
    "GraphArrays",
    "MemoTable",
    "MemoTableBridge",
    "run_wave",
    "run_wave_with_stats",
    "seeds_to_frontier",
    "wave_step",
]
