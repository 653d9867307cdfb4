"""Container v3: chunked frame streams (``CSZH3`` magic), host only.

The layout, the CRCs and the salvage rules are the JAX package's
(``repro.core.frames``): the same header and payloads give the same bytes,
with and without sync markers, so either package reads the other's streams.

A v3 container is a sequence of *independently decodable* frames behind one
global header. Each frame is an opaque byte blob — for the compressor it is
a complete v1/v2 container of one shard/chunk, so every frame carries its
own header and section table and replays without any other frame — guarded
by a CRC32 and a length prefix. The layout is streaming-first:

    CSZH3\\n | u32 hlen | header (repro_torch.core.serial) |
    n x [ u64 size | u32 crc32 | frame bytes ] | u32 n_frames | CSZ3END\\n

Frames are length-prefixed (a writer never needs to know sizes up front,
so encode can overlap I/O), and the trailing count + end marker let a
reader detect truncation. The global header is a plain serial dict; the
compressor stores ``kind="chunks"`` plus the split geometry there, other
producers (gradient shards, KV-cache offload) store their own kinds.

Random access walks the length prefixes — n hops of 12 bytes each, no
payload parsing — so partial decode (``frames=[...]``) and out-of-order
decode cost nothing beyond the frames actually read.

Fault tolerance
---------------
Frames are the unit of salvage: one flipped bit destroys at most its own
frame, never the stream. Integrity failures raise the typed errors in
:mod:`repro_torch.core.errors` (all ``ValueError`` subclasses), and
:func:`scan_frames` recovers every intact frame from a damaged stream
together with a :class:`~repro_torch.core.errors.DamageReport`.

``FrameWriter(..., sync=True)`` additionally prefixes every frame record
with an 8-byte sync marker and a u32 sequence number (recorded as
``_sync`` in the global header, so readers know the record layout). Plain
streams resync after damage by a heuristic forward scan that must re-find
a (length, CRC)-consistent record; sync-marked streams resync by scanning
for the next marker — O(damage region), and the sequence number pins the
true index of every survivor even when whole frames vanished. Old v3
files (no ``_sync``) read unchanged, byte for byte.
"""
from __future__ import annotations

import io
import struct
import zlib

from .errors import (  # noqa: F401 - re-exported: frames' own error surface
    ContainerError,
    DamageReport,
    FrameCRCError,
    FrameSyncError,
    TruncatedContainerError,
)
from .serial import pack_obj, unpack_obj

MAGIC_V3 = b"CSZH3\n"
_END = b"CSZ3END\n"
_FRAME_PREFIX = struct.Struct("<QI")  # u64 size, u32 crc32
# sync-marked record: marker | u32 seq | u64 size | u32 crc32 | payload.
# The marker's first byte is non-ASCII so plain-text payloads can't
# shadow it; the CRC check is the real gate against false positives.
SYNC_MARKER = b"\xf5CSZ3F\r\n"
_SYNC_PREFIX = struct.Struct("<8sIQI")
_TRAILER_LEN = 4 + len(_END)  # u32 count + end marker


def is_v3(buf) -> bool:
    return bytes(buf[: len(MAGIC_V3)]) == MAGIC_V3


def _crc(b) -> int:
    return zlib.crc32(b) & 0xFFFFFFFF


class FrameWriter:
    """Streaming v3 writer over any ``write()``-able object.

    Frames are written (and flushed, when the sink supports it) as they are
    produced, so a slow consumer — disk writeback, a socket — overlaps with
    the encode of the next frame instead of waiting for the whole
    container. ``close()`` appends the trailing frame count + end marker;
    a stream without them is detectably truncated.

    ``sync=True`` writes the per-frame sync marker + sequence number (see
    module docstring) for O(damage) resync; the layout is declared in the
    global header, so it is self-describing.

    Usable as a context manager: a clean ``with`` exit finalizes the
    stream (``close()``); an exception inside the block *aborts* it
    instead — the trailer is deliberately not written, so the
    half-produced stream stays detectably truncated rather than
    masquerading as complete.
    """

    def __init__(self, f, header: dict | None = None, *, sync: bool = False):
        self._f = f
        self._n = 0
        self._closed = False
        self._sync = bool(sync)
        header = dict(header or {})
        if self._sync:
            header["_sync"] = 1
        hb = pack_obj(header)
        f.write(MAGIC_V3)
        f.write(struct.pack("<I", len(hb)))
        f.write(hb)

    def write_frame(self, frame: bytes) -> None:
        if self._closed:
            raise ValueError("FrameWriter is closed")
        if self._sync:
            self._f.write(_SYNC_PREFIX.pack(SYNC_MARKER, self._n, len(frame), _crc(frame)))
        else:
            self._f.write(_FRAME_PREFIX.pack(len(frame), _crc(frame)))
        self._f.write(frame)
        if hasattr(self._f, "flush"):
            self._f.flush()
        self._n += 1

    def close(self) -> int:
        """Finalize the stream; returns the frame count."""
        if not self._closed:
            self._f.write(struct.pack("<I", self._n))
            self._f.write(_END)
            if hasattr(self._f, "flush"):
                self._f.flush()
            self._closed = True
        return self._n

    def abort(self) -> int:
        """Stop writing WITHOUT finalizing: no trailer is appended, so the
        stream reads as truncated — the honest state for an interrupted
        producer. Returns the frames written so far."""
        self._closed = True
        return self._n

    def __enter__(self) -> FrameWriter:
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


def pack_frames(header: dict, frames, *, sync: bool = False) -> bytes:
    """One-shot v3 writer: global header + every frame, finalized."""
    bio = io.BytesIO()
    with FrameWriter(bio, header, sync=sync) as w:
        for fr in frames:
            w.write_frame(fr)
    return bio.getvalue()


def _parse_header(buf):
    """Magic + global header; returns (header, payload_offset, sync)."""
    if not is_v3(buf):
        raise ContainerError(f"bad container magic {bytes(buf[:6])!r}; expected {MAGIC_V3!r}")
    off = len(MAGIC_V3)
    if len(buf) < off + 4:
        raise TruncatedContainerError("truncated v3 container: stream ended inside the header length")
    (hlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    if len(buf) < off + hlen:
        raise TruncatedContainerError("truncated v3 container: stream ended inside the global header")
    try:
        header = unpack_obj(bytes(buf[off : off + hlen]))
    except Exception as e:
        raise ContainerError(f"unreadable v3 global header: {e}") from e
    return header, off + hlen, bool(header.get("_sync"))


def _trailer(buf):
    """Locate the trailer; returns (data_end, declared_count | None)."""
    if len(buf) >= _TRAILER_LEN and bytes(buf[-len(_END) :]) == _END:
        (n,) = struct.unpack_from("<I", buf, len(buf) - _TRAILER_LEN)
        return len(buf) - _TRAILER_LEN, int(n)
    return len(buf), None


def read_header(buf) -> dict:
    """Global header alone — parseable even when the frame region is
    damaged (the salvage consumers need the geometry it carries)."""
    header, _, _ = _parse_header(memoryview(buf))
    return header


def frame_table(buf) -> tuple[dict, list[tuple[int, int, int]]]:
    """Parse a v3 stream without touching frame payloads.

    Returns ``(header, table)`` where ``table[i] = (offset, size, crc32)``
    of frame ``i``'s payload. Raises on bad magic or a truncated stream
    (missing end marker / frame-count mismatch). For damaged streams use
    :func:`scan_frames`, which salvages instead of raising.
    """
    buf = memoryview(buf)
    header, off, sync = _parse_header(buf)
    end_at, declared = _trailer(buf)
    prefix = _SYNC_PREFIX if sync else _FRAME_PREFIX
    table = []
    while off < end_at:
        if off + prefix.size > end_at:
            raise TruncatedContainerError(
                f"truncated v3 container: frame {len(table)} prefix runs past the end marker"
            )
        if sync:
            marker, seq, size, crc = prefix.unpack_from(buf, off)
            if marker != SYNC_MARKER:
                raise FrameSyncError(f"bad sync marker at byte {off} (frame {len(table)})")
            if seq != len(table):
                raise FrameSyncError(f"sync sequence mismatch at byte {off}: {seq} != {len(table)}")
        else:
            size, crc = prefix.unpack_from(buf, off)
        off += prefix.size
        if off + size > end_at:
            raise TruncatedContainerError(
                f"truncated v3 container: frame {len(table)} runs past the end marker"
            )
        table.append((off, size, crc))
        off += size
    if declared is None or declared != len(table):
        raise TruncatedContainerError(
            f"truncated v3 container: end marker/frame count invalid "
            f"({declared} declared, {len(table)} found)"
        )
    return header, table


def read_frame(buf, table_entry: tuple[int, int, int], *, verify: bool = True) -> memoryview:
    """Extract one frame payload by its :func:`frame_table` entry.

    Returns a zero-copy ``memoryview`` of the payload (CRC-checked in
    place) — the decode stack is bytes-like-tolerant end to end, so the
    per-frame copy the old ``bytes()`` slice paid is gone. Call
    ``bytes(...)`` on the result if you need an owning copy.
    """
    off, size, crc = table_entry
    frame = memoryview(buf)[off : off + size]
    if verify and _crc(frame) != crc:
        raise FrameCRCError(f"frame CRC mismatch at offset {off} (corrupt container)", offset=off)
    return frame


def unpack_frames(buf, *, verify: bool = True) -> tuple[dict, list[memoryview]]:
    """Parse a whole v3 stream into ``(header, [frame bytes, ...])``."""
    header, table = frame_table(buf)
    return header, [read_frame(buf, t, verify=verify) for t in table]


# ----------------------------------------------------------------- salvage
def _plausible_record(buf, off: int, end_at: int):
    """Heuristic resync probe for plain (non-sync) streams: a record at
    ``off`` is accepted only if its declared length stays in-bounds AND
    the payload's CRC32 matches the prefix — a 2^-32 false-positive gate.
    Returns (size, crc) or None."""
    if off + _FRAME_PREFIX.size > end_at:
        return None
    size, crc = _FRAME_PREFIX.unpack_from(buf, off)
    # zero-size records are rejected during resync: crc32(b"") == 0, so any
    # 12 zero bytes would otherwise look like a valid empty frame
    if size == 0 or off + _FRAME_PREFIX.size + size > end_at:
        return None
    start = off + _FRAME_PREFIX.size
    if _crc(buf[start : start + size]) != crc:
        return None
    return size, crc


def scan_frames(buf, *, resync: bool = True, verify: bool = True):
    """Salvage pass over a (possibly damaged) v3 stream.

    Returns ``(good_frames, report)`` where ``good_frames`` is a list of
    ``(index, payload)`` for every frame that survived intact and
    ``report`` is a :class:`~repro_torch.core.errors.DamageReport`. Never raises
    for recoverable damage — only for an unreadable magic/global header,
    without which there is nothing to salvage against.

    ``index`` is the frame's true sequence number for sync-marked streams
    (the marker carries it); for plain streams it is positional, counting
    each damaged region as one lost frame — exact for single-frame damage,
    best-effort when a damaged region swallowed several frames.

    ``resync=False`` stops at the first damage (everything before it is
    still returned); ``resync=True`` scans forward for the next plausible
    record — the next sync marker, or for plain streams the next offset
    whose (length, CRC) pair is self-consistent — and keeps going.
    """
    buf = memoryview(buf)
    raw = bytes(buf)  # one copy; needed for marker .find() during resync
    header, off, sync = _parse_header(buf)
    end_at, declared = _trailer(buf)
    report = DamageReport(declared_frames=declared, truncated=declared is None)
    if declared is None:
        report.add("trailer", len(raw), detail="end marker missing (stream truncated or torn)")
    prefix = _SYNC_PREFIX if sync else _FRAME_PREFIX
    good: list[tuple[int, bytes]] = []
    idx = 0  # next expected index (positional for plain streams)

    def _resync(from_off: int) -> int | None:
        """Next plausible record offset after ``from_off``, or None."""
        if sync:
            pos = raw.find(SYNC_MARKER, from_off + 1, end_at)
            return pos if pos >= 0 else None
        for cand in range(from_off + 1, end_at - _FRAME_PREFIX.size + 1):
            if _plausible_record(buf, cand, end_at) is not None:
                return cand
        return None

    while off < end_at:
        damage_at = off
        seq = None
        if off + prefix.size > end_at:
            report.add("truncated", off, index=idx, detail="stream ended inside a frame prefix")
            report.frames_damaged += 1
            report.bytes_skipped += end_at - off
            break
        if sync:
            marker, seq, size, crc = prefix.unpack_from(buf, off)
            bad = marker != SYNC_MARKER
            kind = "sync"
            detail = "bad sync marker"
        else:
            size, crc = prefix.unpack_from(buf, off)
            bad = False
        if not bad and off + prefix.size + size > end_at:
            bad, kind, detail = True, "length", f"declared size {size} runs past the stream end"
        if not bad:
            start = off + prefix.size
            payload = raw[start : start + size]
            if verify and _crc(payload) != crc:
                bad, kind, detail = True, "crc", "payload CRC32 mismatch"
                # the record *structure* may still be intact (payload-only
                # damage): skip exactly this record and keep walking — if
                # the length was the damaged field, the next parse fails
                # and the resync below recovers
                report.add(kind, damage_at, index=seq if sync else idx, detail=detail)
                report.frames_damaged += 1
                report.bytes_skipped += prefix.size + size
                idx = (seq + 1) if sync else (idx + 1)
                off = start + size
                continue
            good.append(((seq if sync else idx), payload))
            report.frames_ok += 1
            idx = (seq + 1) if sync else (idx + 1)
            off = start + size
            continue
        # structural damage: bad marker or impossible length
        report.add(kind, damage_at, index=seq if sync else idx, detail=detail)
        report.frames_damaged += 1
        if not resync:
            report.bytes_skipped += end_at - damage_at
            break
        nxt = _resync(damage_at)
        if nxt is None:
            report.bytes_skipped += end_at - damage_at
            break
        report.bytes_skipped += nxt - damage_at
        if not sync:
            idx += 1  # assume the damaged region held one frame
        off = nxt
    if declared is not None and report.frames_ok + report.frames_damaged != declared:
        report.add(
            "trailer", end_at,
            detail=f"{declared} frames declared, {report.frames_ok} intact + {report.frames_damaged} damaged found",
        )
    return good, report


class FrameReader:
    """Streaming v3 reader over any ``read()``-able object.

    Parses the global header eagerly (``.header``); iterating yields frame
    payloads one at a time, CRC-checked, without buffering the rest of the
    stream — the decode loop can start before the producer finished
    writing later frames to the file.

    Degraded mode: :meth:`iter_frames` with ``on_error="skip"`` yields
    ``(index, payload)`` for intact frames only, recording damage in
    ``self.damage`` (a :class:`~repro_torch.core.errors.DamageReport`) instead
    of raising — a CRC-damaged frame is skipped by its length prefix and
    the stream keeps going; structural damage (a record that no longer
    parses) ends the iteration with the damage recorded, since a
    forward-only reader cannot scan backwards (use :func:`scan_frames`
    on a buffered stream for full resync).

    Usable as a context manager; exit closes the underlying stream.
    """

    def __init__(self, f, *, verify: bool = True):
        self._f = f
        self._verify = verify
        self.frames_read = 0  # intact frames yielded
        self._seen = 0        # records walked (intact + skipped): positional index
        self.damage = DamageReport()
        magic = f.read(len(MAGIC_V3))
        if magic != MAGIC_V3:
            raise ContainerError(f"bad container magic {magic!r}; expected {MAGIC_V3!r}")
        (hlen,) = struct.unpack("<I", f.read(4))
        hb = f.read(hlen)
        if len(hb) < hlen:
            raise TruncatedContainerError("truncated v3 container: stream ended inside the global header")
        self.header = unpack_obj(hb)
        self._sync = bool(self.header.get("_sync"))

    def close(self) -> None:
        if hasattr(self._f, "close"):
            self._f.close()

    def __enter__(self) -> FrameReader:
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _read_record(self):
        """One record: returns ("frame", seq, payload_len, crc),
        ("end", declared, None, None) or raises a typed error."""
        if self._sync:
            head = self._f.read(_SYNC_PREFIX.size)
            if len(head) >= _TRAILER_LEN and head[4 : 4 + len(_END)] == _END:
                (n,) = struct.unpack("<I", head[:4])
                return "end", n, None, None
            if len(head) < _SYNC_PREFIX.size:
                raise TruncatedContainerError("truncated v3 container: stream ended inside a frame prefix")
            marker, seq, size, crc = _SYNC_PREFIX.unpack(head)
            if marker != SYNC_MARKER:
                raise FrameSyncError(f"bad sync marker before frame {self.frames_read}")
            return "frame", seq, size, crc
        head = self._f.read(_FRAME_PREFIX.size)
        if len(head) < _FRAME_PREFIX.size:
            raise TruncatedContainerError("truncated v3 container: stream ended inside a frame prefix")
        # the trailer (u32 count + end marker) is exactly 12 bytes, the
        # same width as a frame prefix: detect it by the end marker
        if head[4:] == _END:
            (n,) = struct.unpack("<I", head[:4])
            return "end", n, None, None
        size, crc = _FRAME_PREFIX.unpack(head)
        return "frame", self._seen, size, crc

    def iter_frames(self, *, on_error: str = "raise"):
        """Yield ``(index, payload)`` per frame. ``on_error="skip"``
        records damage in ``self.damage`` and keeps going where possible
        instead of raising."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
        while True:
            try:
                kind, seq, size, crc = self._read_record()
            except ContainerError:
                if on_error == "raise":
                    raise
                self.damage.add("truncated", -1, index=self._seen,
                                detail="unreadable frame prefix; rest of stream abandoned")
                self.damage.truncated = True
                return
            if kind == "end":
                self.damage.declared_frames = seq
                if seq != self._seen:
                    if on_error == "raise":
                        raise TruncatedContainerError(
                            f"truncated v3 container: {seq} frames declared, {self._seen} read"
                        )
                    self.damage.add("trailer", -1, detail=f"{seq} declared, {self._seen} seen")
                return
            payload = self._f.read(size)
            if len(payload) < size:
                if on_error == "raise":
                    raise TruncatedContainerError("truncated v3 container: stream ended inside a frame")
                self.damage.add("truncated", -1, index=seq, detail="stream ended inside a frame")
                self.damage.frames_damaged += 1
                self.damage.truncated = True
                return
            self._seen += 1
            if self._verify and _crc(payload) != crc:
                if on_error == "raise":
                    raise FrameCRCError(f"frame {seq} CRC mismatch (corrupt container)", index=seq)
                self.damage.add("crc", -1, index=seq, detail="payload CRC32 mismatch")
                self.damage.frames_damaged += 1
                continue
            self.frames_read += 1
            self.damage.frames_ok += 1
            yield seq, payload

    def __iter__(self):
        for _, payload in self.iter_frames(on_error="raise"):
            yield payload
