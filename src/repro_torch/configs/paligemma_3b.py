"""paligemma-3b [vlm] — SigLIP (stub) + gemma backbone [arXiv:2407.07726; hf].

The vision tower is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings ([B, 256, d_model]); the backbone applies a
bidirectional prefix mask over them (PaliGemma's prefix-LM attention).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    attention="full",
    frontend="vision_stub",
    frontend_len=256,
    rope_theta=10_000.0,
)
