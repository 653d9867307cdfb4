"""BIT1: bit-plane shuffle (paper §5.2.3), the host stage (numpy).

Within each block, plane p (p = 0 is the MSB) fills bytes
``[p * block/8, (p+1) * block/8)``; byte q of plane p holds bit ``7-p`` of
input bytes ``8q .. 8q+7``, MSB-first as ``np.packbits`` packs it. The
stream is zero-padded to a whole number of blocks and the header is
``{n, block}``. After TCMS, the high planes are near-constant runs that
RRE1 collapses. The bytes are the JAX package's
(``repro.core.lossless.bitshuffle``); the device twin is
:func:`repro_torch.core.lossless.engine.bit1_encode_device`.
"""
from __future__ import annotations

import numpy as np

BLOCK = 8192


def bitshuffle_encode(data: np.ndarray, block: int = BLOCK):
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    n = data.size
    if n == 0:
        return b"", {"n": 0, "block": int(block)}
    pad = (-n) % block
    if pad:
        data = np.concatenate([data, np.zeros(pad, np.uint8)])
    arr = data.reshape(-1, block)
    bits = np.unpackbits(arr, axis=1).reshape(-1, block, 8)
    planes = np.packbits(bits.transpose(0, 2, 1).reshape(arr.shape[0], -1), axis=1)
    return planes.reshape(-1).tobytes(), {"n": int(n), "block": int(block)}


def bitshuffle_decode(payload, header: dict) -> np.ndarray:
    n, block = header["n"], header["block"]
    if n == 0:
        return np.zeros(0, np.uint8)
    arr = np.frombuffer(payload, np.uint8).reshape(-1, block)
    bits = np.unpackbits(arr, axis=1).reshape(-1, 8, block)
    out = np.packbits(bits.transpose(0, 2, 1).reshape(arr.shape[0], -1), axis=1)
    return out.reshape(-1)[:n].copy()
