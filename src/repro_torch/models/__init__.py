"""Model configurations (port of ``repro/models``): only ``config``, the
dataclass of an architecture's widths that the MoE dispatch path reads.
The reference's layers, transformer and MoE layer are not ported."""
