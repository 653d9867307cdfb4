"""The benchmark's own reader (and, for the control, writer) of the compressor's container v2.

A frozen copy of the format, independent of the program: the harness reads
the bytes a compress call hands back to judge them (magic, header, section
table adding up to the buffer) and to count the work of the hf stage
(symbols in, payload bytes out) from the section headers, whatever the
program's own parser does later.

Container v2: ``b"CSZH2\\n"``, u32 header length, the header in a tagged
binary codec (one tag byte per value; i64 ints, f64 floats, u32-prefixed
strings, bytes, lists and dicts), u32 section count, one u64 size per
section, then the sections. Section 0 of an interp or Lorenzo container is
a lossless stream, LLP2: ``b"LLP2"``, a stage count, one record per stage
(flags byte, bit 0 = stored through; name length and name; u32 header
length and header), then the payload. Every stage header but ``zstd``'s
starts with the stage's input length as a u64.
"""
from __future__ import annotations

import struct

MAGIC = b"CSZH2\n"
LLP2 = b"LLP2"

_NONE, _FALSE, _TRUE, _INT, _FLOAT, _STR, _BYTES, _LIST, _DICT = range(9)


class ContainerFault(ValueError):
    """The bytes are not a well-formed container v2."""


def _unpack(buf, off: int):
    tag = buf[off]
    off += 1
    if tag == _NONE:
        return None, off
    if tag in (_TRUE, _FALSE):
        return tag == _TRUE, off
    if tag == _INT:
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if tag == _FLOAT:
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if tag in (_STR, _BYTES):
        (n,) = struct.unpack_from("<I", buf, off)
        raw = bytes(buf[off + 4: off + 4 + n])
        return (raw.decode() if tag == _STR else raw), off + 4 + n
    if tag == _LIST:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        out = []
        for _ in range(n):
            v, off = _unpack(buf, off)
            out.append(v)
        return out, off
    if tag == _DICT:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        out = {}
        for _ in range(n):
            (kl,) = struct.unpack_from("<I", buf, off)
            key = bytes(buf[off + 4: off + 4 + kl]).decode()
            out[key], off = _unpack(buf, off + 4 + kl)
        return out, off
    raise ContainerFault(f"bad header tag {tag} at offset {off - 1}")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(_NONE)
    elif obj is True or obj is False:
        out.append(_TRUE if obj else _FALSE)
    elif isinstance(obj, int):
        out.append(_INT)
        out += struct.pack("<q", obj)
    elif isinstance(obj, float):
        out.append(_FLOAT)
        out += struct.pack("<d", obj)
    elif isinstance(obj, str):
        out.append(_STR)
        out += struct.pack("<I", len(obj.encode())) + obj.encode()
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_BYTES)
        out += struct.pack("<I", len(obj)) + obj
    elif isinstance(obj, (list, tuple)):
        out.append(_LIST)
        out += struct.pack("<I", len(obj))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        out.append(_DICT)
        out += struct.pack("<I", len(obj))
        for k, v in obj.items():
            out += struct.pack("<I", len(k.encode())) + k.encode()
            _pack(out, v)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def pack(header: dict, sections: list) -> bytes:
    """A container v2 of ``header`` and ``sections`` (the control's writer)."""
    hb = bytearray()
    _pack(hb, header)
    out = bytearray(MAGIC) + struct.pack("<I", len(hb)) + hb + struct.pack("<I", len(sections))
    for s in sections:
        out += struct.pack("<Q", len(s))
    for s in sections:
        out += s
    return bytes(out)


def parse(buf) -> tuple[dict, list]:
    """(header, sections as memoryviews) of a container v2; raises
    :class:`ContainerFault` unless the section table adds up to the buffer."""
    mv = memoryview(buf)
    try:
        if bytes(mv[: len(MAGIC)]) != MAGIC:
            raise ContainerFault(f"bad magic {bytes(mv[:6])!r}")
        off = len(MAGIC)
        (hlen,) = struct.unpack_from("<I", mv, off)
        header, end = _unpack(mv, off + 4)
        if end != off + 4 + hlen or not isinstance(header, dict):
            raise ContainerFault("header length disagrees with its contents")
        off = end
        (nsec,) = struct.unpack_from("<I", mv, off)
        sizes = struct.unpack_from(f"<{nsec}Q", mv, off + 4)
        off += 4 + 8 * nsec
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise ContainerFault(f"truncated container: {e}") from None
    if off + sum(sizes) != len(mv):
        raise ContainerFault(f"sections add up to {off + sum(sizes)} B, the buffer has {len(mv)} B")
    sections = []
    for sz in sizes:
        sections.append(mv[off: off + sz])
        off += sz
    return header, sections


def stages(stream) -> list[dict]:
    """The stage records of an LLP2 stream, in encode order: name, whether
    stored through, the stage's input length (``n``; None for ``zstd``),
    and for every stage the bytes it handed on (the next kept stage's input,
    or the final payload)."""
    mv = memoryview(stream)
    if bytes(mv[:4]) != LLP2:
        raise ContainerFault("lossless stream without the LLP2 magic")
    try:
        recs, off = [], 5
        for _ in range(mv[4]):
            flags, nlen = struct.unpack_from("<BB", mv, off)
            name = bytes(mv[off + 2: off + 2 + nlen]).decode()
            off += 2 + nlen
            (hlen,) = struct.unpack_from("<I", mv, off)
            n = struct.unpack_from("<Q", mv, off + 4)[0] if hlen >= 8 and not flags & 1 else None
            recs.append({"name": name, "stored": bool(flags & 1), "n": n})
            off += 4 + hlen
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise ContainerFault(f"truncated LLP2 stream: {e}") from None
    payload = len(mv) - off
    kept = [r for r in recs if not r["stored"]]
    for i, r in enumerate(kept):
        nxt = kept[i + 1]["n"] if i + 1 < len(kept) else payload
        r["out"] = nxt
    return recs


def hf_bytes(buf) -> tuple[int, int]:
    """(symbols in, payload bytes out) of the hf stage of a container's
    lossless stream, from its section headers; (0, 0) without a kept hf."""
    header, sections = parse(buf)
    if header.get("mode") not in ("interp", "lorenzo"):
        return 0, 0
    for r in stages(sections[0]):
        if r["name"] == "hf" and not r["stored"]:
            return int(r["n"]), int(r["out"])
    return 0, 0
