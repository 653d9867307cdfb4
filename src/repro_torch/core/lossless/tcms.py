"""TCMS-k: two's-complement -> magnitude-sign symbol transform (§5.2.3).

Bijective on all k-byte patterns: non-negative symbols pass through;
negative symbols become MSB | ~x (small negative magnitudes get small
sign-magnitude patterns), so streams clustered around zero concentrate
their set bits in the low bit-planes — feeding BIT/RRE/RZE stages.
"""
from __future__ import annotations

import numpy as np

_DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _view(data: np.ndarray, k: int):
    n = data.size
    pad = (-n) % k
    if pad:
        data = np.concatenate([data, np.zeros(pad, np.uint8)])
    return data.view(_DTYPES[k]), n


def tcms_encode(data: np.ndarray, k: int):
    data = np.ascontiguousarray(data, np.uint8)
    x, n = _view(data, k)
    bits = 8 * k
    msb = _DTYPES[k](1 << (bits - 1)) if bits < 64 else np.uint64(1 << 63)
    neg = (x & msb) != 0
    out = np.where(neg, (~x) ^ msb, x).astype(_DTYPES[k])
    # (~x) has MSB 0 when x is negative; ^msb sets it -> MSB flags sign.
    return out.view(np.uint8).tobytes(), {"n": int(n), "k": int(k)}


def tcms_decode(payload: bytes, header: dict) -> np.ndarray:
    k = header["k"]
    x = np.frombuffer(payload, np.uint8).view(_DTYPES[k])
    bits = 8 * k
    msb = _DTYPES[k](1 << (bits - 1)) if bits < 64 else np.uint64(1 << 63)
    neg = (x & msb) != 0
    out = np.where(neg, ~(x ^ msb), x).astype(_DTYPES[k])
    return out.view(np.uint8)[: header["n"]].copy()
