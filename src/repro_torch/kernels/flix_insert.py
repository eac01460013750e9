"""TL-Bulk insertion kernel (port of ``repro/kernels/flix_insert.py``; paper
§4.3.2).

:func:`flix_insert_pass` runs ``csrc/flix_insert.cu``: persistent warps,
one bucket at a time each (the paper's mapping), with a two-slot
``cp.async`` ring per warp that stages the next bucket's rows that hold
keys (``num_nodes`` of them), its ``node_max`` row and its slice of the
sorted batch.  The slice bounds come from one ``torch.searchsorted`` of the
fences in the batch; a slice is cut at ``cap`` entries.  A bucket
upsert-merges its slice into its stripe with the original-node-region
re-chunk (the insert half of the update path it shares with the staged
stripe kernel, ``csrc/flix_warp.cuh``) and writes the new stripe, its
metadata and its overflow count.  On the CPU it runs
:func:`flix_insert_reference`, the same phases in torch
(``kernels/_phases.py``) over whole stripes.

Contract (``flix_insert_pallas``): the batch is sorted and holds each key
once; a stored key that reappears takes the incoming value; EMPTY slots of
the output carry value 0.  ``overflow[b]`` is 1 when bucket ``b``'s pieces
ran past its ``npb`` node slots, plus 1 when its slice held more than
``cap`` keys; the output state ORs ``overflow > 0`` into
``needs_restructure``, and its overflowed buckets are not to be trusted.
The kernel reads only the first ``num_nodes[b]`` rows of a bucket, which
holds for every state that keeps I1-I4 (the active nodes packed first).
"""

from __future__ import annotations

import torch

from repro_torch.core.batch import gather_kv_sublists
from repro_torch.core.state import FliXState, bucket_chunks
from repro_torch.kernels._launch import check, check_smem, launch
from repro_torch.kernels._phases import merge_chunk, row_metadata

_INPUTS = (
    "num_nodes",
    "keys",
    "vals",
    "node_max",
    "mkba",
    "sorted_keys",
    "sorted_vals",
)


def flix_insert_pass(
    num_nodes, keys, vals, node_max, mkba, sorted_keys, sorted_vals
):
    """Insert a sorted batch into every bucket.  The CUDA kernel on the
    card, :func:`flix_insert_reference` on the CPU.

    ``num_nodes`` [nb], ``keys``/``vals`` [nb, npb, ns], ``node_max``
    [nb, npb] and ``mkba`` [nb] are the state's planes (``num_nodes`` tells
    the kernel which rows hold keys); ``sorted_keys``/``sorted_vals`` [N]
    the batch.  Returns ``(keys, vals, node_count, node_max, num_nodes,
    overflow)``.
    """
    nb, npb, ns = keys.shape
    args = (num_nodes, keys, vals, node_max, mkba, sorted_keys, sorted_vals)
    dev = keys.device
    check(dev, _INPUTS, args)
    if (
        vals.shape != keys.shape
        or node_max.shape != (nb, npb)
        or mkba.shape != (nb,)
        or num_nodes.shape != (nb,)
    ):
        raise ValueError(
            "keys, vals, node_max, mkba and num_nodes disagree in geometry"
        )
    if sorted_keys.dim() != 1 or sorted_vals.shape != sorted_keys.shape:
        raise ValueError("sorted_keys and sorted_vals must be one column each")
    if dev.type == "cpu":
        return flix_insert_reference(*args)

    check_smem("flix_insert", "flix_insert_smem_bytes", npb, ns, dev)
    outs = (
        torch.empty_like(keys),
        torch.empty_like(vals),
        torch.empty_like(node_max),
        torch.empty_like(node_max),
        torch.empty((nb,), dtype=torch.int32, device=dev),
        torch.empty((nb,), dtype=torch.int32, device=dev),
    )
    ends = torch.searchsorted(sorted_keys, mkba, right=True, out_int32=True)
    launch(
        "flix_insert",
        "flix_insert_launch",
        dev,
        keys,
        vals,
        node_max,
        num_nodes,
        ends,
        sorted_keys,
        sorted_vals,
        *outs,
        nb,
        npb,
        ns,
    )
    return outs


def flix_insert_reference(
    num_nodes, keys, vals, node_max, mkba, sorted_keys, sorted_vals
):
    """Plain torch version of the insert pass: same inputs and outputs as
    :func:`flix_insert_pass`, run in bucket chunks over whole stripes, as
    the Pallas kernel reads them (``num_nodes`` is not read)."""
    nb, npb, ns = keys.shape
    S = npb * ns
    ends = torch.searchsorted(sorted_keys, mkba, right=True, out_int32=True)
    starts = torch.cat([torch.zeros_like(ends[:1]), ends[:-1]])
    out_k, out_v = torch.empty_like(keys), torch.empty_like(vals)
    cnt, mx = torch.empty_like(node_max), torch.empty_like(node_max)
    nn = torch.empty((nb,), dtype=torch.int32, device=keys.device)
    flow = torch.empty_like(nn)
    for c0, c1 in bucket_chunks(nb, 4 * S):
        B, Bv, _, true_counts = gather_kv_sublists(
            sorted_keys, sorted_vals, starts[c0:c1], ends[c0:c1], S
        )
        M, Mv, pieces = merge_chunk(
            keys[c0:c1].reshape(c1 - c0, S),
            vals[c0:c1].reshape(c1 - c0, S),
            node_max[c0:c1],
            B,
            Bv,
            npb,
            ns,
        )
        out_k[c0:c1] = M.reshape(c1 - c0, npb, ns)
        out_v[c0:c1] = Mv.reshape(c1 - c0, npb, ns)
        cnt[c0:c1], mx[c0:c1], nn[c0:c1] = row_metadata(out_k[c0:c1])
        flow[c0:c1] = (pieces > npb).to(torch.int32) + (true_counts > S).to(torch.int32)
    return out_k, out_v, cnt, mx, nn, flow


def flix_insert(state: FliXState, sorted_keys, sorted_vals):
    """TL-Bulk insertion of a sorted, deduplicated batch.  Returns
    ``(state', overflow)`` with ``overflow`` int32 [nb]; the caller retries
    on a restructured state when any bucket overflowed."""
    keys_in = sorted_keys.to(torch.int32).contiguous()
    vals_in = sorted_vals.to(torch.int32).contiguous()
    okeys, ovals, ocnt, omax, onn, overflow = flix_insert_pass(
        state.num_nodes,
        state.keys,
        state.vals,
        state.node_max,
        state.mkba,
        keys_in,
        vals_in,
    )
    new_state = FliXState(
        keys=okeys,
        vals=ovals,
        node_count=ocnt,
        node_max=omax,
        num_nodes=onn,
        mkba=state.mkba,
        needs_restructure=state.needs_restructure | (overflow > 0).any(),
    )
    return new_state, overflow
