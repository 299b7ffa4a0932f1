"""Edge tier — million-subscriber live-query fan-out.

An :class:`EdgeNode` holds EXACTLY ONE upstream ``$sys-c`` subscription
per distinct key (riding the coalesced batch frames) and re-fans each
fence to thousands of downstream SSE/WebSocket sessions with per-session
bounded outboxes, latest-wins coalescing, slow-consumer eviction with
resume tokens, and shard-map-aware upstream affinity. The overload plane
 sits in front of it: an :class:`AdmissionController` with
per-tenant rate limits, priority lanes and pressure-fed shedding, plus
graceful :meth:`EdgeNode.drain` for rolling deploys. EDGE.md is the
runbook.
"""
from .admission import (
    AdmissionController,
    AdmissionDecision,
    AdmissionRejected,
    rejection_bytes,
)
from .gateway import DRAIN_KEY, EdgeNode
from .server import EdgeHttpServer, EdgeWebSocketServer
from .session import (
    EdgeSession,
    EncodedFrame,
    KeyedMailbox,
    LatestWinsMailbox,
    frame_to_dict,
    pump_payloads,
)
from .worker_pool import EdgeWorkerPool

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "AdmissionRejected",
    "DRAIN_KEY",
    "EdgeNode",
    "EdgeHttpServer",
    "EdgeWebSocketServer",
    "EdgeSession",
    "EdgeWorkerPool",
    "EncodedFrame",
    "KeyedMailbox",
    "LatestWinsMailbox",
    "frame_to_dict",
    "pump_payloads",
    "rejection_bytes",
]
