"""Kernel entry points on a state (port of ``repro/kernels/ops.py``).

The same signatures and return shapes as the reference's wrappers, with the
port's modes:

  * ``"auto"`` — the kernel: the CUDA kernel for a state on the card, its
                 plain torch version for a state on the CPU.
  * ``"ref"``  — the port's core function (``core.point_query``,
                 ``core.successor_query``, ``core.delete``, ``core.insert``,
                 the reference engine ``_apply_ops_reference``).

``"pallas"`` and ``"interpret"`` are the reference's TPU modes and raise
``ValueError``.  The TPU tiling knobs ``block_q`` and ``block_b`` (and
``grouped_matmul``'s ``block_t``, ``block_f`` and ``max_span``) are
accepted and ignored: the kernels behind these entry points choose their
own launch shape (``flix_apply`` here runs the single-buffer kernel; the
staged one takes ``block_b`` through ``ExecConfig``).
``grouped_matmul``'s ``"ref"`` is the port of ``ref.grouped_matmul_ref``,
whose rows outside every group take the clipped group where the kernel
leaves them zero (``kernels/grouped_matmul.py``).
"""

from __future__ import annotations

from repro_torch.core.config import DEFAULT_MAX_RESULTS
from repro_torch.core.state import FliXState
from repro_torch.kernels import grouped_matmul as _gmm
from repro_torch.kernels.flix_delete import flix_delete as _delete_kernel
from repro_torch.kernels.flix_insert import flix_insert as _insert_kernel
from repro_torch.kernels.flix_query import flix_point_query as _query_kernel
from repro_torch.kernels.flix_successor import flix_successor as _successor_kernel

_TILE_KNOBS = ("block_q", "block_b")


def _resolve(mode: str, blocks: dict, allowed=_TILE_KNOBS) -> str:
    unknown = sorted(set(blocks) - set(allowed))
    if unknown:
        raise TypeError(f"unexpected keyword arguments {unknown}")
    if mode in ("pallas", "interpret"):
        raise ValueError(
            f"mode={mode!r} runs the reference's Pallas kernels on a TPU; the "
            "port's modes are 'auto' (the CUDA kernel, or its plain version on "
            "the CPU) and 'ref' (the port's core function)"
        )
    if mode not in ("auto", "ref"):
        raise ValueError(f"unknown mode {mode!r}: expected 'auto' or 'ref'")
    return mode


def flix_point_query(state: FliXState, sorted_queries, *, mode: str = "auto", **blocks):
    """Point lookups of a sorted batch: value or NOT_FOUND per query."""
    if _resolve(mode, blocks) == "ref":
        from repro_torch.core.query import point_query

        return point_query(state, sorted_queries)
    return _query_kernel(
        state.keys, state.vals, state.node_max, state.mkba, sorted_queries
    )


def flix_successor(state: FliXState, sorted_queries, *, mode: str = "auto", **blocks):
    """Successor queries: (succ_key | EMPTY, succ_val | NOT_FOUND)."""
    if _resolve(mode, blocks) == "ref":
        from repro_torch.core.query import successor_query

        return successor_query(state, sorted_queries)
    return _successor_kernel(
        state.keys, state.vals, state.node_max, state.mkba, sorted_queries
    )


def flix_delete(state: FliXState, sorted_del_keys, *, mode: str = "auto", **blocks):
    """TL-Bulk deletion of a sorted batch.  Returns the new state."""
    if _resolve(mode, blocks, ("block_b",)) == "ref":
        from repro_torch.core.delete import delete

        return delete(state, sorted_del_keys)[0]
    return _delete_kernel(state, sorted_del_keys)


def grouped_matmul(x, w, group_offsets, *, mode: str = "auto", **blocks):
    """Ragged grouped GEMM: ``[T, F]`` float32, ``x[t] @ w[g]`` for the rows
    ``offs[g] <= t < offs[g+1]`` of ``x [T, D]`` and ``w [E, D, F]``."""
    if _resolve(mode, blocks, ("block_t", "block_f", "max_span")) == "ref":
        return _gmm.grouped_matmul_ref(x, w, group_offsets)
    return _gmm.grouped_matmul(x, w, group_offsets)


def flix_insert(state: FliXState, sorted_keys, sorted_vals, *, mode: str = "auto"):
    """TL-Bulk insertion.  Returns (new_state, per-bucket overflow counts):
    int32 [nb] from the kernel, the scalar overflowed-bucket count of
    ``core.insert``'s stats with ``mode="ref"``, as in the reference."""
    if _resolve(mode, {}) == "ref":
        from repro_torch.core.insert import insert

        new_state, stats = insert(state, sorted_keys, sorted_vals)
        return new_state, stats["overflowed_buckets"]
    return _insert_kernel(state, sorted_keys, sorted_vals)


def flix_apply(
    state: FliXState,
    ops,
    *,
    mode: str = "auto",
    max_results: int = DEFAULT_MAX_RESULTS,
    **blocks,
):
    """Fused mixed-batch apply: ``(state', results, stats)`` with the
    contract of ``core.ops.apply_ops``.  ``ops`` is a ``core.ops.OpBatch``."""
    if _resolve(mode, blocks) == "ref":
        from repro_torch.core.ops import _apply_ops_reference

        return _apply_ops_reference(state, ops, max_results=max_results)
    from repro_torch.kernels.flix_apply import flix_apply as _apply_kernel

    return _apply_kernel(state, ops.tag, ops.key, ops.val, max_results=max_results)
