"""Architecture configs for the assigned-architecture pool (port of
``repro/models/config.py``, kept field for field; it imports no JAX there
either, but the port keeps its own copy).

``ModelConfig`` describes the *exact* published architecture; ``padded(tp)``
derives the tensor-parallel deployment layout (head padding / kv duplication
— the standard trick inference engines use when ``tp > num_kv_heads``).
Padding inflates HLO FLOPs over MODEL_FLOPS; the roofline report shows the
ratio explicitly (EXPERIMENTS.md §Roofline).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 → d_model // num_heads
    # attention flavor
    attention: str = "full"      # full | swa | local_global
    window: int = 4096
    local_global_ratio: int = 0  # N local layers per 1 global (gemma3: 5)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # deployment transforms (set by padded() / build_cell, not by configs):
    moe_split: int = 1          # virtual-expert split for EP alignment when
                                # tp > num_experts (each expert's FFN splits
                                # into `split` column chunks = virtual experts)
    dispatch_spec: Any = None   # PartitionSpec for [E, C, D] MoE dispatch
                                # intermediates (EP × token-parallel)
    moe_impl: str = "gather"    # "gather" (pjit) | "a2a" (shard_map routing)
    moe_mesh: Any = None        # mesh for the a2a impl (set by build_cell)
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4
    attn_every: int = 0          # hybrid: shared attn block every N ssm layers
    # modality frontend stub
    frontend: str | None = None  # vision_stub | audio_stub
    frontend_len: int = 0        # prefix length supplied by the stub
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def padded(self, tp: int) -> "ModelConfig":
        """Deployment layout for ``tp``-way tensor parallelism.

        kv heads are duplicated up to ``tp`` when ``tp % kv == 0`` (vLLM-style
        replication), otherwise both head counts zero-pad to the next multiple
        of ``tp`` preserving an integral q-per-kv group.
        """
        vocab_pad = math.ceil(self.vocab_size / tp) * tp
        if tp <= 1:
            return self
        # EP alignment: when tp > E, split each expert's FFN into column
        # chunks so the virtual expert count matches the axis (vLLM-style).
        moe_split = 1
        if (
            self.family == "moe"
            and self.num_experts % tp != 0
            and tp % self.num_experts == 0
            and self.moe_d_ff % (tp // self.num_experts) == 0
        ):
            moe_split = tp // self.num_experts
        if self.num_heads == 0:
            return dataclasses.replace(self, vocab_size=vocab_pad)
        hq, hkv = self.num_heads, self.num_kv_heads
        if hkv % tp == 0:
            kv_pad = hkv
        elif tp % hkv == 0:
            kv_pad = tp
        else:
            kv_pad = math.ceil(hkv / tp) * tp
        group = max(1, math.ceil(hq / kv_pad))
        q_pad = kv_pad * group
        return dataclasses.replace(
            self,
            num_heads=q_pad,
            num_kv_heads=kv_pad,
            head_dim=self.resolved_head_dim,
            vocab_size=vocab_pad,
            moe_split=moe_split,
        )

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (CPU-runnable)."""
        small = dict(
            num_layers=2,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16 if self.num_heads else 0,
            window=min(self.window, 16),
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=32 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
            frontend_len=8 if self.frontend else 0,
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input shape cells (assigned to every architecture)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# long_500k is restricted to sub-quadratic archs (DESIGN.md §5): SSM/hybrid
# decode state, or SWA / local:global bounded KV.
LONG_CONTEXT_ARCHS = {
    "mamba2-1.3b",
    "zamba2-2.7b",
    "h2o-danube-3-4b",
    "gemma3-12b",
    "mixtral-8x22b",
}


def cells_for(arch: str) -> list[str]:
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        shapes.append("long_500k")
    return shapes
