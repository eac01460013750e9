"""Durable FliX (port of ``repro/checkpoint``): canonical snapshots, the
write-ahead log and crash recovery; and the LM trainer's pytree
checkpoints (``save_pytree``, ``restore_pytree``, ``CheckpointManager``)."""

from repro_torch.checkpoint.durable import (
    DurableFliX,
    EngineBase,
    LocalEngine,
    ShardEngine,
    SnapshotCorruptionError,
    TieredEngine,
    load_snapshot_chain,
)
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    restore_pytree,
    save_pytree,
    tmp_sibling,
)
from repro_torch.checkpoint.serialize import (
    SnapshotFormatError,
    canonical_state_bytes,
    parse_canonical,
    state_digest,
    state_from_pairs,
)
from repro_torch.checkpoint.wal import WALCorruptionError, WriteAheadLog, replay

__all__ = [
    "CheckpointManager",
    "DurableFliX",
    "EngineBase",
    "LocalEngine",
    "ShardEngine",
    "SnapshotCorruptionError",
    "SnapshotFormatError",
    "TieredEngine",
    "WALCorruptionError",
    "WriteAheadLog",
    "canonical_state_bytes",
    "load_snapshot_chain",
    "parse_canonical",
    "replay",
    "restore_pytree",
    "save_pytree",
    "state_digest",
    "state_from_pairs",
    "tmp_sibling",
]
