"""RPC layer — distributed communication backend (SURVEY.md §2.4)."""
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
from .http_gateway import FusionHttpServer, HttpSessionMiddleware, RestClient, RestError
from .middleware import (
    bind_peer_session,
    call_logging_middleware,
    default_session_replacer_middleware,
    peer_session,
)
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
    "FusionHttpServer",
    "HttpSessionMiddleware",
    "RestClient",
    "RestError",
    "bind_peer_session",
    "call_logging_middleware",
    "default_session_replacer_middleware",
    "peer_session",
]
