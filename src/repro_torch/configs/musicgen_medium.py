"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

EnCodec is a STUB per the assignment: input_specs() supplies precomputed
conditioning frame embeddings as a prefix; the decoder operates on the
audio-token stream (vocab 2048).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    attention="full",
    frontend="audio_stub",
    frontend_len=64,
    rope_theta=10_000.0,
)
