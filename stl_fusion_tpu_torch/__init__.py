"""stl_fusion_tpu_torch — the PyTorch/CUDA port of ``stl_fusion_tpu``.

It carries the cascading-invalidation wave end to end on an NVIDIA H100:
the computed-graph runtime (``core``), the device graph mirror, its topo
and lat mirrors and its backend (``graph``), the dense bit-packed BFS wave,
the topo sweep and the lone-wave lat programs (``ops``), the one-card mesh
and its packed mesh wave (``parallel``), the twin of ``bench.py``'s
single-chip and mesh legs (``bench``), and the write path: the command
pipeline (``commands`` + ``operations``), the durable operation log and
its multi-host reader (``oplog``) and graph and hub snapshots
(``checkpoint``), the distribution core (``rpc``, ``client``,
``testing``) and the edge tier (``edge``, ``ext``, the HTTP gateway), with
hand-written Hopper kernels (``csrc/``). Module names and layout
follow the JAX package so each counterpart is easy to find.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`stl_fusion_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"

from .utils import (  # noqa: F401
    AsyncEvent,
    LTag,
    Result,
    TestClock,
    TransientError,
)
from .checkpoint import (  # noqa: F401
    CheckpointManager,
    HubCheckpoint,
    load_graph,
    save_graph,
)
