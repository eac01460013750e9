"""Deterministic, versioned serialization of ``FliXState`` (port of
``repro/checkpoint/serialize.py``).

The durability contract's unit of truth is the **canonical payload**: a
fixed little-endian header followed by the globally sorted live
``(key, value, expiry)`` triples.  Two states with the same *logical*
content — whatever their chain layout, geometry, successor cache,
restructure history or executor — serialize to identical bytes, and to the
reference's bytes for the same content.  Everything physical is excluded:
the successor cache, ``needs_restructure`` and the geometry (which travels
in the snapshot manifest as a rebuild hint).

Per-bucket **segments** are the incremental unit: bucket ``b``'s segment is
its live triples in ascending key order.  Fence disjointness (I3) makes the
in-order concatenation of all segments the global sorted triples, so a full
snapshot's payload *is* the canonical bytes and a delta snapshot replaces
individual bucket segments.

Canonicalization runs on the state's device: the per-row sort, the gathers
and the live mask are torch, and only the live triples and the segment
lengths are copied to the host (from a state on the CPU, such as a tiered
index's host view, nothing is copied).  Framing, checksums and parsing
are numpy.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch

from repro_torch.core.build import build_from_sorted, plan_geometry
from repro_torch.core.expiry import NO_EXPIRY
from repro_torch.core.state import EMPTY, FliXState, bucket_chunks, resolve_device

MAGIC = b"FLIXSNP1"
MAGIC_DELTA = b"FLIXDLT1"
# v2: the payload carries (key, value, expiry) TRIPLES — the expiry column
# is durable logical state (all NO_EXPIRY for states without TTLs).  v1
# payloads (pairs) are rejected.
FORMAT_VERSION = 2
_HEADER = struct.Struct("<8sII")  # magic, version, n_pairs (delta: n_buckets)
HEADER_SIZE = _HEADER.size

_LE32 = np.dtype("<i4")


class SnapshotFormatError(RuntimeError):
    """Raised when canonical bytes fail structural validation."""


def _host_i32(parts: list[torch.Tensor]) -> np.ndarray:
    if not parts:
        return np.zeros(0, _LE32)
    return torch.cat(parts).to(torch.int32).cpu().numpy().astype(_LE32, copy=False)


def bucket_segments(state: FliXState, buckets=None):
    """Canonical per-bucket segments: ``(lens, seg_keys, seg_vals,
    seg_exps)`` as host numpy arrays.

    ``lens[i]`` counts the live triples of the ``i``-th requested bucket;
    the segments are concatenated in request order, each ascending by key
    (little-endian int32).  A state without an expiry plane yields an
    all-``NO_EXPIRY`` ``seg_exps``.  ``buckets=None`` selects every bucket
    in fence order; a dirty list selects those rows on the device first, so
    an incremental snapshot copies O(churn) to the host.  The work runs
    where the state lives: a tiered index's host view
    (``core.residency.TieredFliX.host_view()``, a state on the CPU) is
    canonicalized on the host with no device transfer.

    Chain order (I1 + I2) is ascending apart from interior EMPTY padding,
    so one stable sort of each row canonicalizes it: EMPTY (int32 max)
    lands at the row tail, as under the reference's
    ``np.argsort(kind="stable")``, and the live prefix is the segment.
    """
    dev = state.keys.device
    nb, npb, ns = state.geometry
    keys, vals, exps = state.keys, state.vals, state.exps
    if buckets is not None:
        sel = torch.as_tensor(np.asarray(buckets, np.int64), device=dev)
        keys, vals = keys[sel], vals[sel]
        exps = None if exps is None else exps[sel]
    d, width = keys.shape[0], npb * ns
    k = keys.reshape(d, width)
    v = vals.reshape(d, width)
    e = None if exps is None else exps.reshape(d, width)
    lens, seg_k, seg_v, seg_e = [], [], [], []
    for c0, c1 in bucket_chunks(d, width):
        order = torch.argsort(k[c0:c1], dim=1, stable=True)
        ks = torch.gather(k[c0:c1], 1, order)
        live = ks != EMPTY
        lens.append(live.sum(dim=1, dtype=torch.int32))
        # row-major boolean selection keeps (bucket, ascending-key) order
        seg_k.append(ks[live])
        seg_v.append(torch.gather(v[c0:c1], 1, order)[live])
        if e is not None:
            seg_e.append(torch.gather(e[c0:c1], 1, order)[live])
    host_k = _host_i32(seg_k)
    host_e = _host_i32(seg_e) if e is not None else np.full_like(host_k, int(NO_EXPIRY))
    return _host_i32(lens), host_k, _host_i32(seg_v), host_e


def segment_crcs(lens, seg_keys, seg_vals, seg_exps) -> list[int]:
    """crc32 per bucket segment (keys ++ vals ++ exps bytes) — the
    manifest's per-bucket integrity words, updatable at dirty indices only.
    One running crc over the three slices gives the crc of their
    concatenation without building it."""
    kb = memoryview(np.ascontiguousarray(seg_keys, _LE32).tobytes())
    vb = memoryview(np.ascontiguousarray(seg_vals, _LE32).tobytes())
    eb = memoryview(np.ascontiguousarray(seg_exps, _LE32).tobytes())
    crc = zlib.crc32
    out = []
    start = 0
    for end in (np.cumsum(np.asarray(lens, np.int64)) * 4).tolist():
        out.append(crc(eb[start:end], crc(vb[start:end], crc(kb[start:end]))))
        start = end
    return out


def _le32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, _LE32))


def pairs_to_bytes(seg_keys, seg_vals, seg_exps=None) -> bytes:
    """Frame sorted live triples as the canonical payload (``seg_exps=None``
    writes the all-NO_EXPIRY column)."""
    ks, vs = _le32(seg_keys), _le32(seg_vals)
    es = np.full_like(ks, int(NO_EXPIRY)) if seg_exps is None else _le32(seg_exps)
    if ks.shape != vs.shape or ks.shape != es.shape or ks.ndim != 1:
        raise SnapshotFormatError("keys/vals/exps must be aligned 1-D arrays")
    return (
        _HEADER.pack(MAGIC, FORMAT_VERSION, ks.size)
        + ks.tobytes()
        + vs.tobytes()
        + es.tobytes()
    )


def canonical_state_bytes(state: FliXState) -> bytes:
    """THE deterministic serialization: header + sorted live triples."""
    _, seg_keys, seg_vals, seg_exps = bucket_segments(state)
    return pairs_to_bytes(seg_keys, seg_vals, seg_exps)


def state_digest(state: FliXState) -> str:
    """crc32 (hex) of the canonical payload — a cheap logical-state id."""
    return f"{zlib.crc32(canonical_state_bytes(state)):08x}"


def parse_canonical(data: bytes):
    """Decode a canonical payload back to ``(keys, vals, exps)`` numpy
    arrays, validating the header and framing (strict: trailing bytes
    reject)."""
    if len(data) < HEADER_SIZE:
        raise SnapshotFormatError("payload shorter than header")
    magic, version, n = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise SnapshotFormatError(f"bad magic {magic!r}")
    if version != FORMAT_VERSION:
        raise SnapshotFormatError(f"unsupported format version {version}")
    need = HEADER_SIZE + 3 * 4 * n
    if len(data) != need:
        raise SnapshotFormatError(f"payload length {len(data)} != {need}")
    keys = np.frombuffer(data, dtype=_LE32, count=n, offset=HEADER_SIZE)
    vals = np.frombuffer(data, dtype=_LE32, count=n, offset=HEADER_SIZE + 4 * n)
    exps = np.frombuffer(data, dtype=_LE32, count=n, offset=HEADER_SIZE + 8 * n)
    if n and not (np.diff(keys.astype(np.int64)) > 0).all():
        raise SnapshotFormatError("canonical keys must be strictly ascending")
    return keys.copy(), vals.copy(), exps.copy()


def pack_delta(bucket_idx, lens, seg_keys, seg_vals, seg_exps=None) -> bytes:
    """Frame a dirty-bucket diff: which buckets changed, their new segment
    lengths, and the replacement segments (concatenated in ``bucket_idx``
    order).  Same header discipline as the full payload."""
    bi, ln = _le32(bucket_idx), _le32(lens)
    ks, vs = _le32(seg_keys), _le32(seg_vals)
    es = np.full_like(ks, int(NO_EXPIRY)) if seg_exps is None else _le32(seg_exps)
    if bi.shape != ln.shape or bi.ndim != 1 or ks.shape != vs.shape:
        raise SnapshotFormatError("malformed delta arrays")
    if ks.shape != es.shape:
        raise SnapshotFormatError("malformed delta expiry column")
    if int(ln.sum()) != ks.size:
        raise SnapshotFormatError("delta lens do not cover the segments")
    return (
        _HEADER.pack(MAGIC_DELTA, FORMAT_VERSION, bi.size)
        + bi.tobytes()
        + ln.tobytes()
        + ks.tobytes()
        + vs.tobytes()
        + es.tobytes()
    )


def parse_delta(data: bytes):
    """Inverse of :func:`pack_delta` → ``(bucket_idx, lens, keys, vals,
    exps)``."""
    if len(data) < HEADER_SIZE:
        raise SnapshotFormatError("delta payload shorter than header")
    magic, version, d = _HEADER.unpack_from(data)
    if magic != MAGIC_DELTA:
        raise SnapshotFormatError(f"bad delta magic {magic!r}")
    if version != FORMAT_VERSION:
        raise SnapshotFormatError(f"unsupported format version {version}")
    if len(data) < HEADER_SIZE + 8 * d:
        raise SnapshotFormatError("delta payload truncated")
    bi = np.frombuffer(data, _LE32, d, HEADER_SIZE)
    ln = np.frombuffer(data, _LE32, d, HEADER_SIZE + 4 * d)
    n = int(ln.sum())
    need = HEADER_SIZE + 8 * d + 12 * n
    if len(data) != need:
        raise SnapshotFormatError(f"delta payload length {len(data)} != {need}")
    ks = np.frombuffer(data, _LE32, n, HEADER_SIZE + 8 * d)
    vs = np.frombuffer(data, _LE32, n, HEADER_SIZE + 8 * d + 4 * n)
    es = np.frombuffer(data, _LE32, n, HEADER_SIZE + 8 * d + 8 * n)
    return bi.copy(), ln.copy(), ks.copy(), vs.copy(), es.copy()


def state_from_pairs(
    keys,
    vals,
    exps=None,
    *,
    node_size: int = 32,
    nodes_per_bucket: int = 16,
    fill: float = 0.5,
    device=None,
) -> FliXState:
    """Deterministically rebuild a half-full state from sorted live triples,
    on ``device`` (the card unless the caller names another): the host
    arrays are copied there once and ``build_from_sorted`` runs there.

    The geometry hint comes from the snapshot manifest; the bucket count is
    re-planned from the live count and rounded up to a multiple of 8, as
    the reference does, so a rebuilt state has the reference's geometry.
    An ``exps`` column that is entirely ``NO_EXPIRY`` (or ``None``) rebuilds
    a state without an expiry plane — logically identical.
    """
    dev = resolve_device(device)
    keys = np.asarray(keys, np.int32)
    vals = np.asarray(vals, np.int32)
    if exps is not None:
        exps = np.asarray(exps, np.int32)
        if not (exps != int(NO_EXPIRY)).any():
            exps = None
    nb, npb, ns = plan_geometry(
        len(keys), node_size=node_size, nodes_per_bucket=nodes_per_bucket, fill=fill
    )
    nb = -(-nb // 8) * 8
    geometry = dict(num_buckets=nb, nodes_per_bucket=npb, node_size=ns, fill=fill)
    k = torch.from_numpy(np.ascontiguousarray(keys)).to(dev)
    built = build_from_sorted(k, torch.from_numpy(np.ascontiguousarray(vals)).to(dev), **geometry)
    if exps is None:
        return built
    built_e = build_from_sorted(k, torch.from_numpy(np.ascontiguousarray(exps)).to(dev), **geometry)
    col = torch.where(built.keys == EMPTY, NO_EXPIRY, built_e.vals)
    return dataclasses.replace(built, exps=col)
