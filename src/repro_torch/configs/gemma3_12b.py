"""gemma3-12b [dense] — 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=240,
    attention="local_global",
    local_global_ratio=5,
    window=1024,
    rope_theta=1_000_000.0,
)
