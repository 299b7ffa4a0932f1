"""RpcMessage — the wire format.

Re-expression of src/Stl.Rpc/Infrastructure/RpcMessage.cs:3-35:
``{CallTypeId, CallId, Service, Method, ArgumentData, Headers}``. Arguments
travel pre-serialized (TextOrBytes ≈ bytes here) so the message envelope is
codec-agnostic; headers are (key, value) string pairs (the Fusion client
rides its ``@version`` LTag header here, FusionRpcHeaders.cs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..utils.serialization import wire_type

__all__ = [
    "RpcMessage",
    "SYSTEM_SERVICE",
    "COMPUTE_SYSTEM_SERVICE",
    "TABLE_SYSTEM_SERVICE",
    "DIAG_SYSTEM_SERVICE",
    "MEMBER_SYSTEM_SERVICE",
    "VERSION_HEADER",
]

SYSTEM_SERVICE = "$sys"
COMPUTE_SYSTEM_SERVICE = "$sys-c"
TABLE_SYSTEM_SERVICE = "$sys-t"  # per-TABLE row fences (remote_table.py)
DIAG_SYSTEM_SERVICE = "$sys-d"  # cross-peer introspection (diagnostics/explain.py)
MEMBER_SYSTEM_SERVICE = "$sys-m"  # cluster membership + shard-map frames (cluster/)
VERSION_HEADER = "@version"

CALL_TYPE_PLAIN = 0
CALL_TYPE_COMPUTE = 1


@wire_type
@dataclass(frozen=True)
class RpcMessage:
    call_type_id: int
    call_id: int
    service: str
    method: str
    argument_data: bytes
    headers: tuple = ()  # ((key, value), ...)

    def header(self, key: str) -> Optional[str]:
        for k, v in self.headers:
            if k == key:
                return v
        return None

    def __repr__(self) -> str:
        return (
            f"RpcMessage(#{self.call_id} {self.service}.{self.method} "
            f"type={self.call_type_id} {len(self.argument_data)}B)"
        )
