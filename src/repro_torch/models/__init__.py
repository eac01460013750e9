"""The assigned-architecture model stack (port of ``repro/models``):
``config`` (the architectures' widths), ``layers`` (norms, RoPE, attention,
gated MLP), ``ssm`` (Mamba-2), ``moe`` (the flipped-dispatch MoE layer),
``transformer`` (init, forward, cache and decode of every family),
``frontends`` (the VLM/audio prefix stubs) and ``model`` (registry,
abstract shapes, the numpy carry-over of the reference's parameters and
the ``DecoderLM`` module).  ``moe_a2a`` (shard_map expert parallelism)
belongs to the sharding slice and is not ported."""
