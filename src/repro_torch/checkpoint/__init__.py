"""Durable FliX (port of ``repro/checkpoint``): canonical snapshots, the
write-ahead log and crash recovery.  The reference's pytree checkpoints of
the LM trainer are not ported here."""

from repro_torch.checkpoint.durable import (
    DurableFliX,
    EngineBase,
    LocalEngine,
    ShardEngine,
    SnapshotCorruptionError,
    TieredEngine,
    load_snapshot_chain,
)
from repro_torch.checkpoint.manager import tmp_sibling
from repro_torch.checkpoint.serialize import (
    SnapshotFormatError,
    canonical_state_bytes,
    parse_canonical,
    state_digest,
    state_from_pairs,
)
from repro_torch.checkpoint.wal import WALCorruptionError, WriteAheadLog, replay

__all__ = [
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
    "state_digest",
    "state_from_pairs",
    "tmp_sibling",
]
