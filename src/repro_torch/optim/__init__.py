"""The optimizer stack (port of ``repro/optim``): AdamW, global-norm
clipping, the cosine schedule, and int8 gradient compression with error
feedback."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    clip_by_global_norm_,
    cosine_schedule,
)
from repro_torch.optim.compress import (
    CompressState,
    compress_init,
    decompress_add,
    quantize_grads,
)

__all__ = [
    "AdamWState",
    "CompressState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "clip_by_global_norm_",
    "compress_init",
    "cosine_schedule",
    "decompress_add",
    "quantize_grads",
]
