"""Numpy emulations of the Huffman CUDA kernels (csrc/huffman.cu), step for
step as the kernels run them, against the JAX package's host coder
(``repro.core.lossless.huffman``, whose bytes its jitted device programs
equal: tests/test_torch_huffman.py) and the plain versions. The kernels
themselves run only on the card (tests/test_torch_cuda.py).

hf_decode: one lane per 1024-symbol chunk, from its byte offset; a window of
two big-endian words assembled from bytes (zero past the stream), refilled
when the clamped word index q = min(cur >> 5, qmax) moves; two symbols per
32-bit peek through the pair LUT; each lane stops at its chunk's symbol
count and stores 8 decoded bytes at a time (bytewise at its chunk's end).

hf_encode: hf_chunk_bytes, a warp per chunk, each lane summing the code
lengths of the chunk's symbols lane, lane + 32, ...; the exclusive byte
offsets by cumsum; hf_emit, a CTA of 256 threads per chunk, 4 consecutive
symbols a thread, a warp-then-block exclusive scan of the threads' bit
counts, every code ORed into the chunk's shared words, and the chunk's
bytes written big-endian at its byte offset, its u16 size into the table.
"""
import numpy as np
import pytest
import torch

import repro.core.lossless.huffman as rhf
import repro_torch.core.lossless.engine as teng
from torch_hf_streams import KINDS, LENGTHS, damaged, stream

CHUNK, EMIT_THREADS, WORDS = 1024, 256, 1024 * 16 // 32 + 1
M32 = np.uint64(0xFFFFFFFF)


def _u(x) -> np.uint64:
    return np.uint64(x)


def emulate_decode(bits: np.ndarray, offs: np.ndarray, lut: np.ndarray, maxlen: int, n: int) -> np.ndarray:
    nbytes = bits.size
    qmax = (nbytes + 11) // 4 - 1
    nchunks = offs.size
    lut = lut.astype(np.uint64)

    def be_word(q):
        w = np.zeros(q.shape, np.uint64)
        for i in range(4):
            b = q * 4 + i
            byte = bits[np.minimum(b, nbytes - 1)].astype(np.uint64) if nbytes else np.zeros(q.shape, np.uint64)
            w = (w << _u(8)) | np.where(b < nbytes, byte, _u(0))
        return w

    lane = np.arange(nchunks, dtype=np.int64)
    cnt = np.minimum(CHUNK, n - lane * CHUNK)
    steps = (cnt + 1) >> 1
    cur = offs.astype(np.uint64) * _u(8)
    wq = np.full(nchunks, -2, np.int64)
    w0 = np.zeros(nchunks, np.uint64)
    w1 = np.zeros(nchunks, np.uint64)
    acc = np.zeros(nchunks, np.uint64)
    out = np.zeros(n, np.uint8)
    shift = _u(32 - maxlen)

    def store(mask, base):  # bytes base..base+7 of each lane in mask, below its count
        for k in range(8):
            m = mask & (base + k < cnt)
            out[lane[m] * CHUNK + base[m] + k] = ((acc[m] >> _u(8 * k)) & _u(255)).astype(np.uint8)

    for t in range(CHUNK // 2):
        live = t < steps
        if not live.any():
            break
        q = np.minimum((cur >> _u(5)).astype(np.int64), qmax)
        r = cur & _u(31)
        miss = live & (q != wq)
        slide = miss & (q == wq + 1)
        w0 = np.where(slide, w1, np.where(miss, be_word(q), w0))
        w1 = np.where(miss, be_word(q + 1), w1)
        wq = np.where(miss, q, wq)
        peek = ((w0 << r) & M32) | ((w1 >> _u(1)) >> (_u(31) - r))
        e1 = lut[peek >> shift]
        ls1 = e1 >> _u(8)
        e2 = lut[((peek << ls1) & M32) >> shift]
        cur = np.where(live, cur + ls1 + (e2 >> _u(8)), cur)
        acc = np.where(live, acc | (((e1 & _u(255)) | ((e2 & _u(255)) << _u(8))) << _u(16 * (t & 3))), acc)
        if t & 3 == 3:
            store(live, np.full(nchunks, 2 * (t - 3)))
            acc = np.where(live, _u(0), acc)
    store((steps & 3) != 0, 2 * (steps & ~3))
    return out


def emulate_encode(data: np.ndarray, lens: np.ndarray, codes: np.ndarray):
    n = data.size
    nck = max(1, -(-n // CHUNK))
    m = nck * CHUNK
    idx = np.arange(m)
    ln = np.where(idx < n, lens[np.pad(data, (0, m - n))], 0).astype(np.int64)
    sym = np.pad(data, (0, m - n)).astype(np.int64)
    # hf_chunk_bytes: lane l sums symbols l + 32k; the warp's xor-shuffle sum
    lane_bits = ln.reshape(nck, CHUNK // 32, 32).sum(1)
    chunk_bytes = (lane_bits.sum(1) + 7) >> 3
    byte_off = np.cumsum(chunk_bytes) - chunk_bytes
    total = int(chunk_bytes.sum())
    payload = np.zeros(256 + 2 * nck + total, np.uint8)
    payload[:256] = lens
    # hf_emit: thread t holds symbols 4t..4t+3 of its chunk
    tl = ln.reshape(nck, EMIT_THREADS, 4)
    s = tl.sum(2)
    incl = np.cumsum(s.reshape(nck, EMIT_THREADS // 32, 32), 2)  # the warp's shuffle-up scan
    warp_tot = np.cumsum(incl[:, :, -1], 1)  # warp 0's scan of the warp totals
    warp_base = np.concatenate([np.zeros((nck, 1), np.int64), warp_tot[:, :-1]], 1)
    excl = (incl - s.reshape(incl.shape) + warp_base[:, :, None]).reshape(nck, EMIT_THREADS)
    p = excl[:, :, None] + np.cumsum(tl, 2) - tl  # each code's bit position in its chunk
    words = np.zeros((nck, WORDS), np.uint64)
    keep = tl > 0
    pk, lk = p[keep], tl[keep]
    ck = np.repeat(np.arange(nck), EMIT_THREADS * 4).reshape(tl.shape)[keep]
    v = codes[sym.reshape(tl.shape)[keep]].astype(np.uint64) << (64 - (pk & 31) - lk).astype(np.uint64)
    flat = words.reshape(-1)
    np.bitwise_or.at(flat, ck * WORDS + (pk >> 5), v >> _u(32))
    lo = v & M32
    np.bitwise_or.at(flat, (ck * WORDS + (pk >> 5) + 1)[lo != 0], lo[lo != 0])
    nbytes = (warp_tot[:, -1] + 7) >> 3
    assert np.array_equal(nbytes, chunk_bytes)
    payload[256:256 + 2 * nck] = np.stack([nbytes & 255, nbytes >> 8], 1).reshape(-1)
    for c in range(nck):
        i = np.arange(int(nbytes[c]))
        dst = 256 + 2 * nck + int(byte_off[c])
        payload[dst + i] = ((words[c, i >> 2] >> (24 - 8 * (i & 3)).astype(np.uint64)) & _u(255)).astype(np.uint8)
    return payload.tobytes(), chunk_bytes.astype("<u2")


def _decode_inputs(payload: bytes, n: int):
    buf = np.frombuffer(payload, np.uint8)
    nck = max(1, -(-n // CHUNK))
    lens = buf[:256].copy()
    _, lens, first_code, sym_table, offsets, counts = rhf.canonical_codes(lens)
    maxlen = int(lens.max())
    return maxlen, rhf._pair_lut(first_code, counts, sym_table, offsets, maxlen), buf[256 + 2 * nck:]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_encode_and_decode_emulations_equal_the_reference(kind, n):
    data = stream(kind, n)
    ref, rh = rhf.encode(data)
    lens = rhf.code_lengths(np.bincount(data, minlength=256))
    codes, lens, *_ = rhf.canonical_codes(lens)
    got, chunk_bytes = emulate_encode(data, lens, codes)
    assert got == ref and dict({"n": n}, **rhf.offset_table(chunk_bytes)) == rh
    if n:
        maxlen, lut, bits = _decode_inputs(ref, n)
        offs = np.frombuffer(rh["offs"], "<u4").astype(np.int64)
        assert np.array_equal(emulate_decode(bits, offs, lut, maxlen, n), data)


@pytest.mark.parametrize("how", ["flip", "trunc"])
def test_decode_emulation_equals_the_plain_decode_of_damaged_streams(how):
    """Word reads clamp as the plain version clamps them, so a damaged
    stream decodes to the plain version's bytes (pinned in
    tests/test_torch_huffman.py)."""
    n = 300_001
    ref, rh = rhf.encode(stream("codes", n))
    bad = damaged(ref, n, how)
    maxlen, lut, bits = _decode_inputs(bad, n)
    offs = np.frombuffer(rh["offs"], "<u4").astype(np.int64)
    plain = teng.hf_decode_device(torch.from_numpy(np.frombuffer(bad, np.uint8).copy()), rh).numpy()
    assert np.array_equal(emulate_decode(bits, offs, lut, maxlen, n), plain)


def test_decode_emulation_clamps_cursors_past_the_stream():
    """Chunk offsets past the stream's end (a damaged offset table) read
    the clamped, zero-padded last word, as the plain version does."""
    n = 5000
    ref, rh = rhf.encode(stream("codes", n))
    offs = np.frombuffer(rh["offs"], "<u4").astype(np.int64).copy()
    offs[2:] += 1 << 20
    bad_h = dict(rh, offs=offs.astype("<u4").tobytes())
    maxlen, lut, bits = _decode_inputs(ref, n)
    plain = teng.hf_decode_device(torch.from_numpy(np.frombuffer(ref, np.uint8).copy()), bad_h).numpy()
    assert np.array_equal(emulate_decode(bits, offs, lut, maxlen, n), plain)
