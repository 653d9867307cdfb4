"""Seeded uint8 streams shared by the port's Huffman tests (numpy only, so
the card's tests import it too). Not a test file.

Kinds: ``uniform`` bytes; ``codes``, quantization-code-like (centered on
128 with runs of the center code and rare outliers at 0); ``one``, a
single symbol (a one-entry codebook of length 1); ``deep``, geometric
frequencies (symbol k with probability ~2^-(k+1)), whose Huffman tree is
deeper than 16 from a few hundred thousand symbols on, so the codebook is
length-limited to MAXLEN 16.
"""
import numpy as np

KINDS = ("uniform", "codes", "one", "deep")
LENGTHS = (0, 1, 1023, 1024, 1025, 300_001, 2_100_000)
DEEP_FROM = 300_001  # the deep stream's codebook reaches 16 bits from this length on


def stream(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng([n, KINDS.index(kind)])
    if kind == "uniform":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "one":
        return np.full(n, 128, np.uint8)
    if kind == "deep":
        return np.minimum(rng.geometric(0.5, n) - 1, 255).astype(np.uint8)
    d = np.clip(np.rint(rng.laplace(128, 1.5, n)), 1, 255).astype(np.uint8)
    d[rng.random(n) < 0.4] = 128
    d[rng.random(n) < 0.001] = 0
    return d


def damaged(payload: bytes, n: int, how: str) -> bytes:
    """``payload`` of an n-symbol hf stream with one bit flipped a third of
    the way into its bitstream (``flip``), or cut half way through it
    (``trunc``)."""
    bits0 = 256 + 2 * max(1, -(-n // 1024))
    if how == "flip":
        b = bytearray(payload)
        b[bits0 + (len(payload) - bits0) // 3] ^= 0x10
        return bytes(b)
    return payload[: bits0 + (len(payload) - bits0) // 2]
