"""FliX core: the flipped-indexing CDS on torch tensors."""

from repro_torch.core.state import (
    EMPTY,
    KEY_DTYPE,
    MAX_VALID,
    MIN_KEY,
    NOT_FOUND,
    VAL_DTYPE,
    FliXState,
    empty_state,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.core.batch import (
    bucket_of,
    bucket_slices,
    dedup_last_wins,
    gather_kv_sublists,
    gather_sublists,
    sort_batch,
)
from repro_torch.core.build import build, build_from_sorted, plan_geometry
from repro_torch.core.config import DEFAULT_MAX_RESULTS, ExecConfig, TileTable
from repro_torch.core.query import dense_range_scan, point_query, successor_query
from repro_torch.core.insert import insert, insert_safe, insert_with_slices
from repro_torch.core.delete import delete
from repro_torch.core.ops import (
    OP_DELETE,
    OP_INSERT,
    OP_NOP,
    OP_POINT,
    OP_RANGE,
    OP_SUCCESSOR,
    OpBatch,
    apply_ops,
    apply_ops_safe,
    make_ops,
    unsort,
)
from repro_torch.core.invariants import check_invariants, check_range_results
from repro_torch.core.restructure import (
    plan,
    restructure,
    restructure_auto,
    restructure_grow,
)

__all__ = [
    "DEFAULT_MAX_RESULTS",
    "EMPTY",
    "KEY_DTYPE",
    "MAX_VALID",
    "MIN_KEY",
    "NOT_FOUND",
    "OP_DELETE",
    "OP_INSERT",
    "OP_NOP",
    "OP_POINT",
    "OP_RANGE",
    "OP_SUCCESSOR",
    "VAL_DTYPE",
    "ExecConfig",
    "FliXState",
    "OpBatch",
    "TileTable",
    "apply_ops",
    "apply_ops_safe",
    "bucket_of",
    "bucket_slices",
    "build",
    "build_from_sorted",
    "check_invariants",
    "check_range_results",
    "dedup_last_wins",
    "delete",
    "dense_range_scan",
    "empty_state",
    "gather_kv_sublists",
    "gather_sublists",
    "insert",
    "insert_safe",
    "insert_with_slices",
    "make_ops",
    "plan",
    "plan_geometry",
    "point_query",
    "restructure",
    "restructure_auto",
    "restructure_grow",
    "sort_batch",
    "state_from_numpy",
    "state_to_numpy",
    "successor_query",
    "unsort",
]
