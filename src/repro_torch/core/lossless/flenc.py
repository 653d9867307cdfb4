"""Fixed-length bit packing (the cuSZp2-like baseline's encoder), host numpy.

Zigzags int32 codes, splits them into blocks of 32 values and stores each
block at its largest bit width: cuSZp2's fixed-length encoding. The bytes
are the JAX package's (``repro.core.lossless.flenc``).
"""
from __future__ import annotations

import numpy as np

BLK = 32


def fl_encode(codes: np.ndarray):
    c = np.ascontiguousarray(codes, np.int64).reshape(-1)
    n = c.size
    z = ((c << 1) ^ (c >> 63)).astype(np.uint64)  # zigzag
    pad = (-n) % BLK
    if pad:
        z = np.concatenate([z, np.zeros(pad, np.uint64)])
    zb = z.reshape(-1, BLK)
    mx = zb.max(axis=1)
    bw = np.zeros(zb.shape[0], np.uint8)
    nzb = mx > 0
    bw[nzb] = np.floor(np.log2(mx[nzb].astype(np.float64))).astype(np.uint8) + 1
    lens = np.repeat(bw.astype(np.int64), BLK)[: z.size]
    total = int(lens.sum())
    out_bits = np.zeros(((total + 7) // 8) * 8, np.uint8)
    offs = np.cumsum(lens) - lens
    SLAB = 1 << 22
    for lo in range(0, z.size, SLAB):
        hi = min(z.size, lo + SLAB)
        L = lens[lo:hi]
        tot = int(L.sum())
        if tot == 0:
            continue
        reps = np.repeat(np.arange(lo, hi), L)
        j = np.arange(tot) - np.repeat(np.cumsum(L) - L, L)
        out_bits[offs[reps] + j] = ((z[reps] >> (L[reps] - 1 - j).astype(np.uint64)) & np.uint64(1)).astype(np.uint8)
    payload = bw.tobytes() + np.packbits(out_bits).tobytes()
    return payload, {"n": int(n), "nblk": int(zb.shape[0]), "bits": total}


def fl_decode(payload: bytes, header: dict) -> np.ndarray:
    n, nblk = header["n"], header["nblk"]
    bw = np.frombuffer(payload[:nblk], np.uint8)
    bits = np.unpackbits(np.frombuffer(payload[nblk:], np.uint8), count=header["bits"]).astype(np.uint64)
    lens = np.repeat(bw.astype(np.int64), BLK)
    offs = np.cumsum(lens) - lens
    z = np.zeros(nblk * BLK, np.uint64)
    maxw = int(bw.max()) if nblk else 0
    for w in range(1, maxw + 1):
        sel = np.flatnonzero(lens == w)
        if sel.size == 0:
            continue
        acc = np.zeros(sel.size, np.uint64)
        for j in range(w):
            acc = (acc << np.uint64(1)) | bits[offs[sel] + j]
        z[sel] = acc
    zz = z[:n]
    return ((zz >> np.uint64(1)).astype(np.int64) ^ -(zz & np.uint64(1)).astype(np.int64)).astype(np.int32)
