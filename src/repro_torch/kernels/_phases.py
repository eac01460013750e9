"""Plain torch versions of the stripe phases of ``csrc/flix_phases.cuh``.

Each function runs one phase for a chunk of buckets at once (the leading
dimension), on ``[C, S]`` stripes with ``S = npb * ns``, and computes what
the device function computes: the same ranks, slots and metadata, value 0 at
every EMPTY slot it writes.  ``flix_apply``, ``flix_insert`` and
``flix_delete`` build their plain versions from them.
"""

from __future__ import annotations

import torch

from repro_torch.core.state import EMPTY


def _dest(rank, r, m_j, s_j, f_j, base_j, keep, npb, ns, dump):
    """The balanced re-chunk slot of each merged element (``chunk_dest``)."""
    m_r = torch.clamp(m_j.gather(1, r), min=1)
    s_r = torch.clamp(s_j.gather(1, r), min=1)
    rr = rank - f_j.gather(1, r)
    piece = (rr * s_r) // m_r
    start = (piece * m_r + s_r - 1) // s_r
    slot = base_j.gather(1, r) + piece
    return torch.where(keep & (slot < npb), slot * ns + (rr - start), dump).long()


def merge_chunk(A, Av, nmax, B, Bv, npb: int, ns: int):
    """``merge_phase``: upsert-merge each bucket's sorted, EMPTY-padded insert
    slice ``B``/``Bv`` [C, S] into its stripe ``A``/``Av`` [C, S] (chain
    order) with the region re-chunk.  Returns ``(M, Mv, pieces)``: the merged
    stripe and the number of pieces per bucket (more than ``npb`` means it
    overflowed and the pieces past the last slot were dropped)."""
    C, S = A.shape
    dev = A.device
    lane = torch.arange(S, dtype=torch.int32, device=dev)[None, :]

    # stripe keys not upserted, ranked by a scan
    validA = A != EMPTY
    lbB = torch.searchsorted(B, A)
    dup = validA & (B.gather(1, torch.clamp(lbB, max=S - 1)) == A)
    keepA = validA & ~dup
    incl = torch.cumsum(keepA, 1, dtype=torch.int32)
    exA = incl - keepA.to(torch.int32)
    kept_at = torch.where(keepA, exA, S).long()
    K = torch.full((C, S + 1), EMPTY, dtype=torch.int32, device=dev)
    K.scatter_(1, kept_at, A)
    K = K[:, :S].contiguous()

    validB = B != EMPTY
    onn_c = torch.clamp((nmax != EMPTY).sum(1) - 1, min=0)[:, None]
    regA = torch.minimum(torch.searchsorted(nmax, A), onn_c)
    regB = torch.minimum(torch.searchsorted(nmax, B), onn_c)
    m_j = torch.zeros((C, npb), dtype=torch.int32, device=dev)
    m_j.scatter_add_(1, regA, keepA.to(torch.int32))
    m_j.scatter_add_(1, regB, validB.to(torch.int32))
    s_j = (m_j + ns - 1) // ns
    f_j = torch.cumsum(m_j, 1, dtype=torch.int32) - m_j
    base_j = torch.cumsum(s_j, 1, dtype=torch.int32) - s_j

    rankA = exA + lbB.to(torch.int32)
    rankB = torch.searchsorted(K, B, out_int32=True) + lane
    destA = _dest(rankA, regA, m_j, s_j, f_j, base_j, keepA, npb, ns, S)
    destB = _dest(rankB, regB, m_j, s_j, f_j, base_j, validB, npb, ns, S)
    M = torch.full((C, S + 1), EMPTY, dtype=torch.int32, device=dev)
    Mv = torch.zeros((C, S + 1), dtype=torch.int32, device=dev)
    M.scatter_(1, destA, A)
    M.scatter_(1, destB, B)
    Mv.scatter_(1, destA, Av)
    Mv.scatter_(1, destB, Bv)
    return M[:, :S], Mv[:, :S], s_j.sum(1, dtype=torch.int32)


def slice_hits(del_keys, M, ds, de):
    """``mark_deletes``: the stored keys of ``M`` [C, S] that bucket ``c``'s
    slice ``del_keys[ds[c]:de[c]]`` of the ascending delete keys holds."""
    if del_keys.shape[0] == 0:
        return torch.zeros_like(M, dtype=torch.bool)
    C, S = M.shape
    # the first occurrence of a key in the batch; it lies in the slice iff
    # the key does, since a bucket's keys route only to its own slice
    p = torch.searchsorted(del_keys, M.reshape(-1), out_int32=True).reshape(C, S)
    found = del_keys[torch.clamp(p, max=del_keys.shape[0] - 1)] == M
    return (p >= ds[:, None]) & (p < de[:, None]) & found & (M != EMPTY)


def row_metadata(F):
    """(node_count, node_max, num_nodes) of ``F`` [C, npb, ns]: keys per row
    that are not EMPTY, the last key of each non-empty row, and the number
    of non-empty rows (``count_rows`` + ``write_stripe``)."""
    cnt = (F != EMPTY).sum(2, dtype=torch.int32)
    last = torch.clamp(cnt - 1, min=0).long()[..., None]
    mx = torch.where(cnt > 0, F.gather(2, last)[..., 0], EMPTY)
    return cnt, mx, (cnt > 0).sum(1, dtype=torch.int32)


def compact_chunk(M, Mv, hit, npb: int, ns: int):
    """``compact_phase``: drop the hits and EMPTY slots of ``M``/``Mv``
    [C, S], shift survivors left inside their node, drop emptied nodes from
    the chain.  Returns ``(F, Fv, node_count, node_max, num_nodes)`` with
    ``F``/``Fv`` shaped [C, npb, ns]."""
    C, S = M.shape
    dev = M.device
    lane = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    keep = (M != EMPTY) & ~hit
    ex = torch.cumsum(keep, 1, dtype=torch.int32) - keep.to(torch.int32)
    node_of = (lane // ns).expand(C, -1).long()
    in_node = ex - ex[:, ::ns].gather(1, node_of)
    cnt = keep.reshape(C, npb, ns).sum(2, dtype=torch.int32)
    slot = torch.cumsum(cnt > 0, 1, dtype=torch.int32) - 1
    dest = slot.gather(1, node_of) * ns + in_node
    dest = torch.where(keep, dest, S).long()
    F = torch.full((C, S + 1), EMPTY, dtype=torch.int32, device=dev)
    Fv = torch.zeros((C, S + 1), dtype=torch.int32, device=dev)
    F.scatter_(1, dest, M)
    Fv.scatter_(1, dest, Mv)
    F, Fv = F[:, :S].reshape(C, npb, ns), Fv[:, :S].reshape(C, npb, ns)
    return (F, Fv, *row_metadata(F))
