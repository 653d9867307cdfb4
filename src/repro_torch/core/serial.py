"""Compact binary object codec for container headers.

A tiny tagged serializer over the JSON value model (None/bool/int/float/
str/bytes/list/dict). The binary container v2 header
(repro_torch.core.compressor) rides this codec, so headers stay a few dozen
bytes instead of a JSON blob and never depend on float repr round-tripping.
The layout is shared with the JAX package byte for byte, so containers
written by either package decode in the other.

Layout: one tag byte per value; ints are signed little-endian i64, floats
IEEE f64, str/bytes length-prefixed (u32), containers count-prefixed (u32).
Dict keys must be str. Numpy scalars are coerced to their Python types so
headers built from array metadata pack without ceremony.
"""
from __future__ import annotations

import struct

import numpy as np

_T_NONE, _T_FALSE, _T_TRUE, _T_INT, _T_FLOAT, _T_STR, _T_BYTES, _T_LIST, _T_DICT = range(9)


def pack_obj(obj) -> bytes:
    out = bytearray()
    _pack_into(out, obj)
    return bytes(out)


def _pack_into(out: bytearray, obj) -> None:
    if obj is None:
        out.append(_T_NONE)
    elif obj is True:
        out.append(_T_TRUE)
    elif obj is False:
        out.append(_T_FALSE)
    elif isinstance(obj, (int, np.integer)):
        out.append(_T_INT)
        out += struct.pack("<q", int(obj))
    elif isinstance(obj, (float, np.floating)):
        out.append(_T_FLOAT)
        out += struct.pack("<d", float(obj))
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(_T_STR)
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_T_BYTES)
        out += struct.pack("<I", len(obj))
        out += obj
    elif isinstance(obj, (list, tuple)):
        out.append(_T_LIST)
        out += struct.pack("<I", len(obj))
        for v in obj:
            _pack_into(out, v)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        out += struct.pack("<I", len(obj))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"dict keys must be str, got {type(k).__name__}")
            kb = k.encode()
            out += struct.pack("<I", len(kb))
            out += kb
            _pack_into(out, v)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def unpack_obj(buf: bytes):
    obj, off = _unpack_from(buf, 0)
    return obj


def _unpack_from(buf: bytes, off: int):
    tag = buf[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_TRUE:
        return True, off
    if tag == _T_FALSE:
        return False, off
    if tag == _T_INT:
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if tag == _T_FLOAT:
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if tag in (_T_STR, _T_BYTES):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        raw = bytes(buf[off : off + n])
        return (raw.decode() if tag == _T_STR else raw), off + n
    if tag == _T_LIST:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        out = []
        for _ in range(n):
            v, off = _unpack_from(buf, off)
            out.append(v)
        return out, off
    if tag == _T_DICT:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        out = {}
        for _ in range(n):
            (kl,) = struct.unpack_from("<I", buf, off)
            off += 4
            k = bytes(buf[off : off + kl]).decode()
            off += kl
            out[k], off = _unpack_from(buf, off)
        return out, off
    raise ValueError(f"bad tag byte {tag} at offset {off - 1}")
