"""RPC layer — distributed communication backend (SURVEY.md §2.4).

The HTTP gateway (``http_gateway.py``) and the session middleware
(``middleware.py``) import ``ext/session`` and are not ported yet
(ROADMAP A.7, second part)."""
from .calls import RpcCallTypeRegistry, RpcInboundCall, RpcOutboundCall
from .fanout import (
    ComputeFanoutIndex,
    WaveValuePublisher,
    install_compute_fanout,
    install_value_publisher,
)
from .hub import RpcClientProxy, RpcHub, consistent_hash_router
from .outbox import PeerOutbox
from .message import COMPUTE_SYSTEM_SERVICE, SYSTEM_SERVICE, VERSION_HEADER, RpcMessage
from .peer import ConnectionState, RpcClientPeer, RpcPeer, RpcServerPeer
from .registry import RpcMethodDef, RpcServiceDef, RpcServiceRegistry, rpc_no_wait
from .testing import RpcMultiServerTestTransport, RpcTestTransport

__all__ = [
    "ComputeFanoutIndex",
    "PeerOutbox",
    "WaveValuePublisher",
    "install_compute_fanout",
    "install_value_publisher",
    "RpcCallTypeRegistry",
    "RpcInboundCall",
    "RpcOutboundCall",
    "RpcClientProxy",
    "RpcHub",
    "consistent_hash_router",
    "COMPUTE_SYSTEM_SERVICE",
    "SYSTEM_SERVICE",
    "VERSION_HEADER",
    "RpcMessage",
    "ConnectionState",
    "RpcClientPeer",
    "RpcPeer",
    "RpcServerPeer",
    "RpcMethodDef",
    "RpcServiceDef",
    "RpcServiceRegistry",
    "rpc_no_wait",
    "RpcTestTransport",
    "RpcMultiServerTestTransport",
]
