"""Modality frontend STUBS (port of ``repro/models/frontends.py``): the
``[vlm]``/``[audio]`` cells specify the transformer backbone only, and
``input_specs()`` provides precomputed patch/frame embeddings.

The stubs define the *shapes* the real frontends (SigLIP for paligemma-3b,
EnCodec for musicgen-medium) would emit, and a deterministic synthetic
generator for smoke tests and examples.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def prefix_spec(cfg: ModelConfig, batch: int) -> torch.Tensor | None:
    """The stub prefix embeddings' shape and dtype, as a tensor on the meta
    device (nothing allocated)."""
    if not cfg.frontend:
        return None
    return torch.empty((batch, cfg.frontend_len, cfg.d_model), dtype=torch.bfloat16,
                       device="meta")


def synthetic_prefix(gen: torch.Generator, cfg: ModelConfig, batch: int) -> torch.Tensor | None:
    """Deterministic fake patch/frame embeddings, drawn from ``gen`` on its
    device: ``N(0, 1) * 0.02`` in bfloat16."""
    if not cfg.frontend:
        return None
    x = torch.randn((batch, cfg.frontend_len, cfg.d_model), generator=gen, device=gen.device)
    return (x * 0.02).to(torch.bfloat16)
