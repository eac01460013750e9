"""Write-ahead op log (port of ``repro/checkpoint/wal.py``, numpy only):
checksummed record framing + torn-tail recovery.  The bytes on disk are the
reference's, record for record, so a log written by either package replays
in the other.

Each engine batch is framed and appended *before* ``apply_ops`` runs.
Record layout, all little-endian:

    u32 magic  u64 seq  u32 payload_len  u32 crc32(payload)  payload

The payload is the host-encoded sorted ``OpBatch`` plus its impl-relevant
parameters (``max_results``), so replay re-executes byte-for-byte the
batch that was logged.  Appends go through raw ``os.write`` (no userspace
buffering) and are fsynced before the engine sees the batch — the fsync
return is the durability boundary: an acknowledged op survives any
subsequent crash.

``fsync=False`` deliberately REMOVES that boundary: frames accumulate in
a userspace buffer and reach the filesystem only on rotate/close.  On a
real power failure the un-fsynced page cache is what gets lost; the
userspace buffer reproduces exactly that loss under a plain process
kill, which is how the negative crash-injection tests demonstrate the
suite catches a WAL without a durability boundary.

The log is segmented (``wal_<startseq>.log``, rotated at snapshots) so
retention can drop whole files once a full snapshot covers them.  Replay
tolerates exactly one torn region — an incomplete or checksum-failing
record at the physical tail of the newest segment (a crash mid-append) —
and truncates it; corruption anywhere else is never silently skipped.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

REC_MAGIC = 0x464C5857  # "FLXW"
_REC_HEADER = struct.Struct("<IQII")  # magic, seq, payload_len, crc32(payload)
REC_HEADER_SIZE = _REC_HEADER.size

_OPS_HEADER = struct.Struct("<II")  # n_ops, max_results
_META_LEN = struct.Struct("<I")  # optional trailing metadata blob length
_LE32 = np.dtype("<i4")

# High bit of the n_ops header word flags the TTL record form: the payload
# additionally carries the batch's virtual clock (one i64 word, sentinel
# ``_NO_NOW`` when the batch ran without an expire pass) and a fourth
# per-op array of expiry deadlines.  Records written without TTL state are
# byte-identical to the TTL-free framing, so such logs replay unchanged.
_TTL_BIT = 0x80000000
_NOW_WORD = struct.Struct("<q")
_NO_NOW = 2**63 - 1

_SEG_PREFIX = "wal_"
_SEG_SUFFIX = ".log"


class WALCorruptionError(RuntimeError):
    """Unrecoverable log damage (non-tail corruption, or a torn tail with
    truncation disabled)."""


def _noop_hook(event: str) -> None:
    return None


def write_all(fd: int, data) -> None:
    """``os.write`` until every byte lands: a short write that got fsynced
    and acknowledged would become non-tail corruption on the next append,
    which replay refuses wholesale."""
    view = memoryview(data)
    while len(view):
        view = view[os.write(fd, view) :]


def encode_ops(
    tag, key, val, max_results: int, meta: bytes = b"", *, exp=None, now=None
) -> bytes:
    """Frame one sorted batch (host arrays) as a WAL record payload.

    ``meta`` is an opaque caller blob logged WITH the batch — same fsync,
    same crc — so replay hands it back alongside the ops.  The serving
    gateway stores the batch's idempotency keys here: a request is durably
    deduplicable exactly iff its batch is durably replayable.  A record
    without the trailing length word decodes with ``meta = b""``.

    ``exp``/``now`` select the TTL record form (``_TTL_BIT``): the batch's
    per-op expiry deadlines and the virtual clock it executed under are
    logged so replay is time-deterministic — it re-runs each batch at the
    exact ``now`` the live engine used, never the replayer's wall clock.
    With both ``None`` the encoding is byte-identical to the legacy form.
    """
    t = np.ascontiguousarray(np.asarray(tag, _LE32))
    k = np.ascontiguousarray(np.asarray(key, _LE32))
    v = np.ascontiguousarray(np.asarray(val, _LE32))
    if not (t.shape == k.shape == v.shape) or t.ndim != 1:
        raise ValueError("tag/key/val must be aligned 1-D arrays")
    if exp is None and now is None:
        out = (
            _OPS_HEADER.pack(t.size, max_results)
            + t.tobytes()
            + k.tobytes()
            + v.tobytes()
        )
    else:
        if exp is None:
            raise ValueError("TTL record form requires an exp column")
        e = np.ascontiguousarray(np.asarray(exp, _LE32))
        if e.shape != t.shape:
            raise ValueError("exp must align with tag/key/val")
        out = (
            _OPS_HEADER.pack(t.size | _TTL_BIT, max_results)
            + _NOW_WORD.pack(_NO_NOW if now is None else int(now))
            + t.tobytes()
            + k.tobytes()
            + v.tobytes()
            + e.tobytes()
        )
    if meta:
        out += _META_LEN.pack(len(meta)) + meta
    return out


def decode_ops(payload: bytes):
    """Inverse of :func:`encode_ops` →
    ``(tag, key, val, max_results, meta, exp, now)``.

    Legacy (non-TTL) records decode with ``exp is None`` and ``now is
    None``; TTL records yield the logged expiry column and the virtual
    clock (``None`` if the batch ran without an expire pass).
    """
    if len(payload) < _OPS_HEADER.size:
        raise WALCorruptionError("op record shorter than its header")
    raw_n, max_results = _OPS_HEADER.unpack_from(payload)
    has_ttl = bool(raw_n & _TTL_BIT)
    n = raw_n & ~_TTL_BIT
    off = _OPS_HEADER.size
    now = None
    if has_ttl:
        if len(payload) < off + _NOW_WORD.size:
            raise WALCorruptionError("TTL op record missing its clock word")
        (now_raw,) = _NOW_WORD.unpack_from(payload, off)
        now = None if now_raw == _NO_NOW else int(now_raw)
        off += _NOW_WORD.size
    cols = 4 if has_ttl else 3
    need = off + cols * 4 * n
    if len(payload) == need:
        meta = b""
    elif len(payload) >= need + _META_LEN.size:
        (mlen,) = _META_LEN.unpack_from(payload, need)
        if len(payload) != need + _META_LEN.size + mlen:
            raise WALCorruptionError(
                f"op record metadata length {len(payload) - need} != {mlen}"
            )
        meta = payload[need + _META_LEN.size :]
    else:
        raise WALCorruptionError(f"op record length {len(payload)} != {need}")
    tag = np.frombuffer(payload, _LE32, n, off).copy()
    key = np.frombuffer(payload, _LE32, n, off + 4 * n).copy()
    val = np.frombuffer(payload, _LE32, n, off + 8 * n).copy()
    exp = np.frombuffer(payload, _LE32, n, off + 12 * n).copy() if has_ttl else None
    return tag, key, val, int(max_results), meta, exp, now


def segment_files(directory) -> list[tuple[int, Path]]:
    """(start_seq, path) for every segment, ascending by start seq."""
    out = []
    for p in Path(directory).glob(f"{_SEG_PREFIX}*{_SEG_SUFFIX}"):
        try:
            start = int(p.name[len(_SEG_PREFIX) : -len(_SEG_SUFFIX)])
        except ValueError:
            continue
        out.append((start, p))
    return sorted(out)


class WriteAheadLog:
    """Appender for the segmented op log (one per durable instance)."""

    def __init__(self, directory, *, fsync: bool = True, crash_hook=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self._hook = crash_hook or _noop_hook
        self._fd: int | None = None
        self._buffer = bytearray()

    # -- segment lifecycle ------------------------------------------------
    def open_segment(self, start_seq: int, *, path: Path | None = None) -> None:
        """Start appending to ``wal_<start_seq>.log`` (or reopen ``path``,
        e.g. the recovered newest segment after tail truncation)."""
        self.close()
        target = path or self.dir / f"{_SEG_PREFIX}{start_seq:012d}{_SEG_SUFFIX}"
        self._fd = os.open(target, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._fsync_dir()

    def rotate(self, start_seq: int) -> None:
        """Flush + close the current segment and start a fresh one."""
        self.open_segment(start_seq)

    def close(self) -> None:
        if self._fd is None:
            return
        if self._buffer:
            write_all(self._fd, bytes(self._buffer))
            self._buffer.clear()
        os.fsync(self._fd)
        os.close(self._fd)
        self._fd = None

    # -- the append path --------------------------------------------------
    def append(self, seq: int, payload: bytes) -> None:
        """Frame and durably append one record; returns only after the
        record is fsynced (``fsync=True``) — the ack/durability boundary."""
        if self._fd is None:
            raise RuntimeError("no open WAL segment (call open_segment first)")
        frame = (
            _REC_HEADER.pack(REC_MAGIC, seq, len(payload), zlib.crc32(payload))
            + payload
        )
        if not self.fsync:
            # negative-test mode: no durability boundary — a crash loses the
            # whole buffered run of acked records (see module docstring)
            self._buffer += frame
            self._hook("wal.append.buffered")
            return
        # two writes on purpose: the crash hook between them lets the fault
        # harness materialize a genuinely torn (half-written) record
        split = REC_HEADER_SIZE + len(payload) // 2
        write_all(self._fd, frame[:split])
        self._hook("wal.append.partial")
        write_all(self._fd, frame[split:])
        self._hook("wal.append.written")
        os.fsync(self._fd)
        self._hook("wal.append.durable")

    def tell(self) -> int:
        """End offset of the active segment, buffered frames included —
        the rollback point for :meth:`truncate_to`."""
        if self._fd is None:
            raise RuntimeError("no open WAL segment (call open_segment first)")
        return os.fstat(self._fd).st_size + len(self._buffer)

    def truncate_to(self, offset: int) -> None:
        """Roll the active segment back to ``offset``, undoing appends made
        after it.  The one legitimate caller is ``DurableFliX.apply`` when
        the engine fails AFTER the WAL ack: the logged-but-never-executed
        record must not survive into the durable history."""
        if self._fd is None:
            raise RuntimeError("no open WAL segment (call open_segment first)")
        size = os.fstat(self._fd).st_size
        if offset >= size:
            del self._buffer[offset - size :]
            return
        self._buffer.clear()
        os.ftruncate(self._fd, offset)
        os.fsync(self._fd)

    def _fsync_dir(self) -> None:
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def replay(directory, *, after_seq: int = 0, truncate_torn: bool = True):
    """Scan every segment in order → list of ``(seq, payload)`` records
    with ``seq > after_seq``.

    A torn tail — an incomplete frame or checksum-failing record at the
    physical end of the NEWEST segment — is the signature of a crash
    mid-append; it is truncated in place (and fsynced) so recovery is
    idempotent, or raises :class:`WALCorruptionError` when
    ``truncate_torn=False``.  Damage anywhere else (a bad record followed
    by readable ones, or in an older segment) always raises: that is
    storage corruption, not a crash artifact, and silently skipping it
    would replay a wrong history.
    """
    segs = segment_files(directory)
    records: list[tuple[int, bytes]] = []
    last_seq = None
    for si, (start, path) in enumerate(segs):
        data = path.read_bytes()
        off = 0
        while off < len(data):
            # a crash mid-append leaves a PREFIX of one valid frame reaching
            # the physical EOF of the newest segment — that, and only that,
            # is a tear.  A damaged record with readable bytes after it (or
            # in an older segment) is storage corruption.
            reason, is_tear, seq = None, False, None
            if off + REC_HEADER_SIZE > len(data):
                reason, is_tear = "incomplete record header", True
            else:
                magic, seq, plen, crc = _REC_HEADER.unpack_from(data, off)
                frame_end = off + REC_HEADER_SIZE + plen
                if magic != REC_MAGIC:
                    reason = f"bad record magic 0x{magic:08x}"
                elif frame_end > len(data):
                    reason, is_tear = "incomplete record payload", True
                else:
                    payload = data[off + REC_HEADER_SIZE : frame_end]
                    if zlib.crc32(payload) != crc:
                        reason = "record checksum mismatch"
                        is_tear = frame_end == len(data)
            if reason is not None:
                is_tear = is_tear and si == len(segs) - 1
                if is_tear and truncate_torn:
                    fd = os.open(path, os.O_WRONLY)
                    try:
                        os.ftruncate(fd, off)
                        os.fsync(fd)
                    finally:
                        os.close(fd)
                    break
                raise WALCorruptionError(
                    f"{path.name} @ {off}: {reason}"
                    + (" (torn tail; truncation disabled)" if is_tear else "")
                )
            if last_seq is not None and seq <= last_seq:
                raise WALCorruptionError(
                    f"{path.name} @ {off}: seq {seq} not increasing "
                    f"(previous {last_seq})"
                )
            last_seq = seq
            if seq > after_seq:
                records.append((seq, payload))
            off += REC_HEADER_SIZE + len(payload)
    return records
