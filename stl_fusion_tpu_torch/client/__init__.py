"""Fusion client layer — invalidation-aware caching RPC (SURVEY.md §2.5)."""
from .cache import (
    ClientComputedCache,
    FileClientComputedCache,
    InMemoryClientComputedCache,
    RpcCacheKey,
)
from .client_function import ClientComputed, ClientComputeMethodFunction, FusionClient, compute_client
from .compute_call import RpcInboundComputeCall, RpcOutboundComputeCall, install_compute_call_type
from .remote_table import TABLE_RPC_SERVICE, RemoteTable, RemoteTableHost
from .service_modes import RoutingComputeProxy, RpcServiceMode, add_fusion_service

__all__ = [
    "RoutingComputeProxy",
    "RpcServiceMode",
    "add_fusion_service",
    "ClientComputedCache",
    "FileClientComputedCache",
    "InMemoryClientComputedCache",
    "RpcCacheKey",
    "ClientComputed",
    "ClientComputeMethodFunction",
    "FusionClient",
    "compute_client",
    "RpcInboundComputeCall",
    "RpcOutboundComputeCall",
    "install_compute_call_type",
    "RemoteTable",
    "RemoteTableHost",
    "TABLE_RPC_SERVICE",
]
