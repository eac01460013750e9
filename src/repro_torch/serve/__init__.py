"""Serving layer (port of ``repro/serve``): the FliX-backed KV-page index."""

from repro_torch.serve.kv_index import PAGE_BITS, KVPageIndex, SnapshotGone, StepResult

__all__ = ["PAGE_BITS", "KVPageIndex", "SnapshotGone", "StepResult"]
