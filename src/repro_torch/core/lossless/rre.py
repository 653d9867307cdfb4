"""RRE-k / RZE-k reducing stages with recursive bitmap compression (§5.2.3).

RREk: view the stream as k-byte symbols; a bitmap marks (1) symbols that
differ from their predecessor; marked symbols are kept, repeats dropped.
RZEk: same, but the bitmap marks non-zero symbols and zeros are dropped.
The bitmap itself is compressed recursively: non-zero bitmap *bytes* are
kept and indexed by a parent bitmap, until the top level is tiny.
"""
from __future__ import annotations

import numpy as np

_BITMAP_FLOOR = 64  # stop recursing below this many bytes


def _compress_bitmap(bits: np.ndarray):
    """bits: packed uint8 bitmap. Returns (top_bytes, [level_kept...], sizes)."""
    levels = []
    sizes = []
    cur = bits
    while cur.size > _BITMAP_FLOOR:
        nz = cur != 0
        kept = cur[nz]
        levels.append(kept)
        sizes.append(int(cur.size))
        cur = np.packbits(nz)
    return cur, levels[::-1], sizes[::-1]


def _decompress_bitmap(top: np.ndarray, levels, sizes):
    cur = top
    for kept, size in zip(levels, sizes):
        nz = np.unpackbits(cur, count=size).astype(bool)
        out = np.zeros(size, np.uint8)
        out[nz] = kept
        cur = out
    return cur


def _pack_kbytes(data: np.ndarray, k: int):
    n = data.size
    pad = (-n) % k
    if pad:
        data = np.concatenate([data, np.zeros(pad, np.uint8)])
    return data.reshape(-1, k), n


def _serialize(top, levels, sizes, kept: np.ndarray, n_orig: int, k: int, nsym: int):
    """Compact binary layout: the recursive-bitmap metadata (top bytes +
    per-level sizes) rides inside the payload, keeping the JSON header to
    three integers.

    payload = [u16 top_len][u16 n_levels][u64 sizes...][u64 lvl_sizes...]
              [top][levels...][kept]
    """
    header = {"n": int(n_orig), "k": int(k), "nsym": int(nsym)}
    meta = (
        np.asarray([top.size, len(levels)], "<u2").tobytes()
        + np.asarray(list(sizes) + [l.size for l in levels], "<u8").tobytes()
    )
    payload = b"".join([meta, top.tobytes()] + [l.tobytes() for l in levels] + [kept.tobytes()])
    return payload, header


def _deserialize(payload: bytes, header: dict):
    buf = np.frombuffer(payload, np.uint8)
    if "top" in header:  # legacy hex-in-JSON header (seed containers)
        top = np.frombuffer(bytes.fromhex(header["top"]), np.uint8)
        sizes = header["sizes"]
        lvl_sizes = header["lvl_sizes"]
        off = 0
    else:
        top_len, n_levels = np.frombuffer(payload[:4], "<u2")
        off = 4 + 8 * (2 * int(n_levels))
        szs = np.frombuffer(payload[4:off], "<u8")
        sizes = [int(s) for s in szs[: int(n_levels)]]
        lvl_sizes = [int(s) for s in szs[int(n_levels) :]]
        top = buf[off : off + int(top_len)]
        off += int(top_len)
    levels = []
    for ls in lvl_sizes:
        levels.append(buf[off : off + ls])
        off += ls
    kept = buf[off:]
    return top, levels, sizes, kept


def rre_encode(data: np.ndarray, k: int):
    data = np.ascontiguousarray(data, np.uint8)
    view, n = _pack_kbytes(data, k)
    nsym = view.shape[0]
    if nsym == 0:
        return _serialize(np.zeros(0, np.uint8), [], [], np.zeros(0, np.uint8), n, k, 0)
    diff = np.ones(nsym, bool)
    diff[1:] = (view[1:] != view[:-1]).any(axis=1)
    kept = view[diff].reshape(-1)
    bitmap = np.packbits(diff)
    top, levels, sizes = _compress_bitmap(bitmap)
    return _serialize(top, levels, sizes, kept, n, k, nsym)


def rre_decode(payload: bytes, header: dict) -> np.ndarray:
    top, levels, sizes, kept = _deserialize(payload, header)
    n, k, nsym = header["n"], header["k"], header["nsym"]
    if nsym == 0:
        return np.zeros(0, np.uint8)
    bitmap = _decompress_bitmap(top, levels, sizes)
    diff = np.unpackbits(bitmap, count=nsym).astype(bool)
    kview = kept.reshape(-1, k)
    idx = np.cumsum(diff) - 1
    out = kview[idx].reshape(-1)[: n]
    return out


def rze_encode(data: np.ndarray, k: int):
    data = np.ascontiguousarray(data, np.uint8)
    view, n = _pack_kbytes(data, k)
    nsym = view.shape[0]
    if nsym == 0:
        return _serialize(np.zeros(0, np.uint8), [], [], np.zeros(0, np.uint8), n, k, 0)
    nz = (view != 0).any(axis=1)
    kept = view[nz].reshape(-1)
    bitmap = np.packbits(nz)
    top, levels, sizes = _compress_bitmap(bitmap)
    return _serialize(top, levels, sizes, kept, n, k, nsym)


def rze_decode(payload: bytes, header: dict) -> np.ndarray:
    top, levels, sizes, kept = _deserialize(payload, header)
    n, k, nsym = header["n"], header["k"], header["nsym"]
    if nsym == 0:
        return np.zeros(0, np.uint8)
    bitmap = _decompress_bitmap(top, levels, sizes)
    nz = np.unpackbits(bitmap, count=nsym).astype(bool)
    out = np.zeros((nsym, k), np.uint8)
    out[nz] = kept.reshape(-1, k)
    return out.reshape(-1)[: n]
