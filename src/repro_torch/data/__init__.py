"""Deterministic, resumable, sharded synthetic data pipeline (port of
``repro/data``)."""

from repro_torch.data.pipeline import DataState, SyntheticLM, make_batch_iterator

__all__ = ["DataState", "SyntheticLM", "make_batch_iterator"]
