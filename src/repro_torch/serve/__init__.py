"""Serving layer (port of ``repro/serve``): the FliX-backed KV-page index
and the multi-tenant exactly-once batching gateway (DESIGN.md §13)."""

from repro_torch.serve.gateway import (
    DEADLINE_EXCEEDED,
    ENGINE_FAILURE,
    INVALID,
    QUEUE_FULL,
    RATE_LIMITED,
    SNAPSHOT_GONE,
    UNAVAILABLE,
    UNKNOWN_COMMIT,
    Gateway,
    GatewayError,
    PumpReport,
    Request,
    Ticket,
)
from repro_torch.serve.kv_index import PAGE_BITS, KVPageIndex, SnapshotGone, StepResult

__all__ = [
    "DEADLINE_EXCEEDED",
    "ENGINE_FAILURE",
    "INVALID",
    "PAGE_BITS",
    "QUEUE_FULL",
    "RATE_LIMITED",
    "SNAPSHOT_GONE",
    "UNAVAILABLE",
    "UNKNOWN_COMMIT",
    "Gateway",
    "GatewayError",
    "KVPageIndex",
    "PumpReport",
    "Request",
    "SnapshotGone",
    "StepResult",
    "Ticket",
]
