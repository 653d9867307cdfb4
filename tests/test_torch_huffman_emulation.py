"""Numpy emulations of the Huffman CUDA kernels (csrc/huffman.cu), step for
step as the kernels run them, against the JAX package's host coder
(``repro.core.lossless.huffman``, whose bytes its jitted device programs
equal: tests/test_torch_huffman.py) and the plain versions. The kernels
themselves run only on the card (tests/test_torch_cuda.py).

hf_decode: one lane per 1024-symbol chunk. The lane loads aligned 16-byte
words from the stream's base rounded down to 16 bytes (bytes outside the
stream read as zero, never loaded), one word ahead of a queue of
big-endian words, and peeks 32 bits with a funnel shift of a two-word
window; each peek's two symbols come from a first-level table of the top
11 bits (entries whose code is at most 11 bits long) or escape to the full
pair LUT; every 64 steps a lane's 128 decoded bytes go through shared
memory, from which the warp stores 16-byte pieces of its chunks, bytewise
at a chunk's end.

hf_encode: one launch. A warp per chunk, a lane 32 consecutive symbols from
two or three aligned 16-byte loads shifted by the input's misalignment; a
shuffle-up warp scan of the lanes' bit counts; tiles of 8 chunks take
indices from a ticket and find their byte offset by a decoupled look-back
over the tiles' status words, here with the tiles advancing in a seeded
random order; codes ORed two at a time into the chunk's shared words with
32-bit shifts; the
chunk's bytes written at their byte offset, bytewise at the unaligned edges
and as aligned 16-byte stores inside, never past the payload's capacity;
the bits' total, which the last tile writes from its look-back.
"""
import numpy as np
import pytest
import torch

import repro.core.lossless.huffman as rhf
import repro_torch.core.lossless.engine as teng
import repro_torch.core.lossless.huffman as thf
from torch_hf_streams import KINDS, LENGTHS, damaged, stream

CHUNK, SMALL_BITS, ENC_WARPS, WORDS = 1024, 11, 8, 1024 * 16 // 32 + 1
STAGE = 128  # decoded bytes a lane between the warp's stores
M32 = np.uint64(0xFFFFFFFF)
AGGREGATE, PREFIX, VALUE = 1 << 62, 2 << 62, (1 << 62) - 1


def _u(x) -> np.uint64:
    return np.uint64(x)


def _bswap(w: np.ndarray) -> np.ndarray:
    w = w.astype(np.uint64)
    return (((w & _u(255)) << _u(24)) | (((w >> _u(8)) & _u(255)) << _u(16)) | (((w >> _u(16)) & _u(255)) << _u(8))
            | (w >> _u(24)))


def load16(mem: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Each row: the 16 bytes of ``mem`` at [s, s + 16) as four little-endian
    words (uint64 holding 32 bits); bytes outside ``mem`` read as zero."""
    idx = np.asarray(s, np.int64)[:, None] + np.arange(16)
    ok = (idx >= 0) & (idx < mem.size)
    b = np.zeros(idx.shape, np.uint64)
    b[ok] = mem[idx[ok]]
    b = b.reshape(-1, 4, 4) << (_u(8) * np.arange(4, dtype=np.uint64))
    return b[:, :, 0] | b[:, :, 1] | b[:, :, 2] | b[:, :, 3]


# ------------------------------------------------------------------- decode
def first_level(lut: np.ndarray, maxlen: int):
    """The kernel's shared table: entry p is lut[p << (maxlen - k)] where its
    code is 1..k bits long, else 0 (an escape)."""
    kb = min(maxlen, SMALL_BITS)
    e = lut.astype(np.uint64)[np.arange(1 << kb) << (maxlen - kb)]
    length = e >> _u(8)
    return np.where((length >= 1) & (length <= kb), e, _u(0)), kb


def lookup(small: np.ndarray, kb: int, lut: np.ndarray, maxlen: int, peek: np.ndarray) -> np.ndarray:
    e = small[(peek >> _u(32 - kb)).astype(np.int64)]
    esc = e == 0
    e[esc] = lut.astype(np.uint64)[(peek[esc] >> _u(32 - maxlen)).astype(np.int64)]
    return e


def emulate_decode(bits: np.ndarray, offs: np.ndarray, lut: np.ndarray, maxlen: int, n: int,
                   align: int = 0) -> np.ndarray:
    """``bits`` starts ``align`` bytes past a 16-byte boundary."""
    nchunks = offs.size
    small, kb = first_level(lut, maxlen)
    lane = np.arange(nchunks, dtype=np.int64)
    cnt = np.minimum(CHUNK, n - lane * CHUNK)
    groups = (cnt + 15) >> 4
    start = (_u(align) + offs.astype(np.uint64)) * _u(8)
    vq = (start >> _u(7)).astype(np.int64)
    queue = _bswap(load16(bits, vq * 16 - align))
    ahead = load16(bits, (vq + 1) * 16 - align)  # in flight until the queue runs dry
    nq = np.full(nchunks, 4)

    def pop(m):
        nonlocal vq
        refill = m & (nq == 0)
        if refill.any():
            queue[refill] = _bswap(ahead[refill])
            nq[refill] = 4
            vq = np.where(refill, vq + 1, vq)
            ahead[refill] = load16(bits, (vq[refill] + 1) * 16 - align)
        w = queue[:, 0].copy()
        queue[m, :3] = queue[m, 1:]
        nq[m] -= 1
        return w

    skip = ((start >> _u(5)) & _u(3)).astype(np.int64)
    for i in range(3):
        pop(i < skip)
    every = np.ones(nchunks, bool)
    w0 = pop(every)
    w1 = pop(every)
    r = (start & _u(31)).astype(np.int64)
    out = np.zeros(n, np.uint8)

    def step():
        nonlocal w0, w1
        ru = r.astype(np.uint64)
        peek = ((w0 << ru) | ((w1 << ru) >> _u(32))) & M32  # __funnelshift_l(w1, w0, r)
        e1 = lookup(small, kb, lut, maxlen, peek)
        l1 = e1 >> _u(8)
        e2 = lookup(small, kb, lut, maxlen, (peek << l1) & M32)
        r[:] += (l1 + (e2 >> _u(8))).astype(np.int64)  # at most 32 bits: two codes of at most 16
        adv = r >= 32
        r[adv] -= 32
        w0 = np.where(adv, w1, w0)
        w1 = np.where(adv, pop(adv), w1)
        return (e1 & _u(255)) | ((e2 & _u(255)) << _u(8))

    # a warp runs as many rounds of 64 steps as its first lane's chunk needs
    warp_first = lane - lane % 32
    rounds = (np.minimum(CHUNK, n - warp_first * CHUNK) + STAGE - 1) // STAGE
    for rnd in range(int(rounds.max(initial=0))):
        live = rnd < rounds
        stage = np.zeros((nchunks, STAGE), np.uint8)  # the lanes' shared-memory rows
        for g in range(STAGE // 16):
            vals = []
            for _ in range(8):
                vals.append(np.where(live, step(), _u(0)))  # lanes of finished warps do not step
            v = np.stack(vals, 1)  # (lanes, 8) two bytes a step
            stage[:, 16 * g:16 * g + 16] = ((v[:, :, None] >> np.array([0, 8], np.uint64)) & _u(255)).reshape(-1, 16)
        for piece in range(STAGE // 16):  # the warp's 16-byte stores, bytewise past a chunk's count
            pos = rnd * STAGE + 16 * piece
            for k in range(16):
                m = live & (pos + k < cnt)
                out[lane[m] * CHUNK + pos + k] = stage[m, 16 * piece + k]
    return out


# ------------------------------------------------------------------- encode
def lookback(nb_tiles: np.ndarray, seed: int, resident: int = 6) -> np.ndarray:
    """The tiles' exclusive byte offsets by the kernel's decoupled look-back:
    CTAs start in a seeded random order (tickets in start order), at most
    ``resident`` at once, each advancing one action at a time chosen at
    random: take a ticket and publish its aggregate (a prefix for tile 0),
    read a 32-tile window (spinning while any word is unset), publish its
    inclusive prefix."""
    rng = np.random.default_rng(seed)
    ntiles = nb_tiles.size
    status = [0] * ntiles
    excl = np.full(ntiles, -1, np.int64)
    ticket, live = 0, []  # live: [tile, top, ex]
    while ticket < ntiles or live:
        if ticket < ntiles and len(live) < resident and (not live or rng.random() < 0.5):
            t, ticket = ticket, ticket + 1
            status[t] = (PREFIX if t == 0 else AGGREGATE) | int(nb_tiles[t])
            live.append([t, t - 1, 0])
            continue
        i = int(rng.integers(len(live)))
        t, top, ex = live[i]
        if top >= 0:
            window = [status[j] if j >= 0 else PREFIX for j in range(top, top - 32, -1)]
            if any(st >> 62 == 0 for st in window):
                continue  # spin
            pre = [k for k, st in enumerate(window) if st >> 62 == 2]
            stop = pre[0] if pre else 31
            ex += sum(st & VALUE for st in window[: stop + 1])
            live[i] = [t, top - 32, ex]
            if not pre:
                continue
        excl[t] = ex
        status[t] = PREFIX | (ex + int(nb_tiles[t]))
        live.pop(i)
    return excl


def emulate_encode(data: np.ndarray, lens: np.ndarray, codes: np.ndarray, align: int = 0, seed: int = 0,
                   counts=None, keep: dict | None = None):
    """``data`` starts ``align`` bytes past a 16-byte boundary; the payload
    is sized from ``counts`` (the data's histogram by default) and starts on
    a 16-byte boundary, filled with seeded junk before the launch (a write
    past it raises IndexError). Raises ValueError, as the wrapper does, when
    the counts were short; ``keep["payload"]`` is then the whole buffer."""
    n = data.size
    nck = max(1, -(-n // CHUNK))
    if counts is None:
        counts = np.bincount(data, minlength=256)
    cap = int(np.asarray(counts, np.int64) @ lens.astype(np.int64)) // 8 + nck
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, 256 + 2 * nck + cap, dtype=np.uint8)
    tab = (codes.astype(np.uint64) << _u(8)) | lens.astype(np.uint64)
    payload[:256] = (tab & _u(255)).astype(np.uint8)  # tile 0
    nt = -(-nck // ENC_WARPS)
    # lane (c, l): stream bytes [s, s + 32), from the aligned words at s - align, s + 16 - align (, s + 32 - align)
    s = (np.arange(nt * ENC_WARPS)[:, None] * CHUNK + 32 * np.arange(32)).reshape(-1)
    W = np.concatenate([load16(data, s - align), load16(data, s + 16 - align),
                        load16(data, s + 32 - align) if align else np.zeros((s.size, 4), np.uint64)], 1)
    q, sh = align >> 2, _u(8 * (align & 3))
    R = ((W[:, q:q + 8] >> sh) | ((W[:, q + 1:q + 9] << (_u(32) - sh)) & M32 if sh else 0)) & M32
    sym = ((R[:, :, None] >> (_u(8) * np.arange(4, dtype=np.uint64))) & _u(255)).reshape(-1, 32).astype(np.int64)
    valid = np.arange(32) < np.clip(n - s, 0, 32)[:, None]
    ln = np.where(valid, tab[sym] & _u(255), _u(0)).astype(np.int64)
    code = np.where(valid, tab[sym] >> _u(8), _u(0)).astype(np.uint64)  # pad symbols' entries are zero
    nbits = ln.sum(1).reshape(-1, 32)
    incl = nbits.copy()  # the shuffle-up scan
    for d in (1, 2, 4, 8, 16):
        up = np.zeros_like(incl)
        up[:, d:] = incl[:, :-d]
        incl = incl + up
    nb = (incl[:, 31] + 7) >> 3
    live = np.arange(nt * ENC_WARPS) < nck
    nb = np.where(live, nb, 0)
    payload[256:256 + 2 * nck] = np.stack([nb[:nck] & 255, nb[:nck] >> 8], 1).reshape(-1)
    nb_tiles = nb.reshape(nt, ENC_WARPS).sum(1)
    tile_excl = lookback(nb_tiles, seed)
    off = (tile_excl[:, None] + np.cumsum(nb.reshape(nt, ENC_WARPS), 1) - nb.reshape(nt, ENC_WARPS)).reshape(-1)
    # codes two at a time (at most 32 bits) ORed into the chunk's words: cur
    # is word w from bit nacc on; a clamped funnel shift gives the spill
    words = np.zeros(nt * ENC_WARPS * WORDS, np.uint64)
    p = (incl - nbits).reshape(-1)
    w = (np.repeat(np.arange(nt * ENC_WARPS), 32) * WORDS + (p >> 5)).astype(np.int64)
    nacc = p & 31
    cur = np.zeros(p.size, np.uint64)
    lane_live = np.repeat(live, 32)
    for k in range(0, 32, 2):
        l2 = ln[:, k + 1]
        lk = ln[:, k] + l2
        pair = (code[:, k] << l2.astype(np.uint64)) | code[:, k + 1]
        top = np.where(lk > 0, (pair << (32 - lk).astype(np.uint64)) & M32, _u(0))
        spill = (top << (32 - nacc).astype(np.uint64)) & M32  # __funnelshift_rc(0, top, nacc): 0 at nacc 0
        m = lane_live
        cur[m] |= top[m] >> nacc[m].astype(np.uint64)
        nacc[m] += lk[m]
        fl = m & (nacc >= 32)
        np.bitwise_or.at(words, w[fl], cur[fl])
        w[fl] += 1
        cur[fl] = spill[fl]
        nacc[fl] -= 32
    fl = lane_live & (nacc > 0)
    np.bitwise_or.at(words, w[fl], cur[fl])
    words = words.reshape(-1, WORDS)
    bits0 = 256 + 2 * nck

    def byte_of(c, i):
        return ((words[c, i >> 2] >> (_u(24) - _u(8) * (i & 3).astype(np.uint64))) & _u(255)).astype(np.uint8)

    for c in np.flatnonzero(live & (nb > 0)):
        size, o = int(nb[c]), int(off[c])
        dst = bits0 + o
        if o + size > cap:  # a short capacity: only the bytes that fit
            i = np.arange(min(size, max(cap - o, 0)))
            payload[dst + i] = byte_of(c, i)
            continue
        head = min((16 - dst % 16) % 16, size)
        blocks = (size - head) >> 4
        tail = head + 16 * blocks
        edge = np.concatenate([np.arange(head), np.arange(tail, size)])
        payload[dst + edge] = byte_of(c, edge)
        i0 = head + 16 * np.arange(blocks)
        m, bs = i0 >> 2, _u(8) * (i0 & 3).astype(np.uint64)
        for k in range(4):  # bswap(__funnelshift_l(buf[m + k + 1], buf[m + k], bs)), a 16-byte store
            be = ((words[c, m + k] << bs) | ((words[c, m + k + 1] << bs) >> _u(32))) & M32
            le = _bswap(be)
            for j in range(4):
                payload[dst + i0 + 4 * k + j] = ((le >> _u(8 * j)) & _u(255)).astype(np.uint8)
    total = int(tile_excl[-1] + nb_tiles[-1])  # the last tile's exclusive prefix plus its aggregate
    assert total == int(nb.sum())
    if keep is not None:
        keep["payload"] = payload
    if total > cap:
        raise ValueError(f"the symbol counts give {cap} bytes of bits, the input takes {total}")
    return payload[:bits0 + total].tobytes(), nb[:nck].astype("<u2")


def _decode_inputs(payload: bytes, n: int):
    buf = np.frombuffer(payload, np.uint8)
    nck = max(1, -(-n // CHUNK))
    lens = buf[:256].copy()
    _, lens, first_code, sym_table, offsets, counts = rhf.canonical_codes(lens)
    maxlen = int(lens.max())
    return maxlen, rhf._pair_lut(first_code, counts, sym_table, offsets, maxlen), buf[256 + 2 * nck:]


def _offs(header: dict) -> np.ndarray:
    return np.frombuffer(header["offs"], "<u4").copy()


def _codebook(data: np.ndarray):
    codes, lens, *_ = rhf.canonical_codes(rhf.code_lengths(np.bincount(data, minlength=256)))
    return lens, codes


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_encode_and_decode_emulations_equal_the_reference(kind, n):
    """The engine's inputs: the encode from a 16-aligned tensor, the decode
    of the bits where the payload puts them (256 + 2 * nchunks bytes in)."""
    data = stream(kind, n)
    ref, rh = rhf.encode(data)
    lens, codes = _codebook(data)
    got, chunk_bytes = emulate_encode(data, lens, codes, seed=n)
    assert got == ref and dict({"n": n}, **rhf.offset_table(chunk_bytes)) == rh
    if n:
        maxlen, lut, bits = _decode_inputs(ref, n)
        align = (256 + 2 * max(1, -(-n // CHUNK))) % 16
        assert np.array_equal(emulate_decode(bits, _offs(rh), lut, maxlen, n, align), data)


@pytest.mark.parametrize("how", ["flip", "trunc"])
def test_decode_emulation_equals_the_plain_decode_of_damaged_streams(how):
    """Bytes past the stream read as zero, as the plain version's clamp to
    its zero-padded last word gives, so a damaged stream decodes to the
    plain version's bytes (pinned in tests/test_torch_huffman.py)."""
    n = 300_001
    ref, rh = rhf.encode(stream("codes", n))
    bad = damaged(ref, n, how)
    maxlen, lut, bits = _decode_inputs(bad, n)
    plain = teng.hf_decode_device(torch.from_numpy(np.frombuffer(bad, np.uint8).copy()), rh).numpy()
    assert np.array_equal(emulate_decode(bits, _offs(rh), lut, maxlen, n, (256 + 2 * 293) % 16), plain)


def test_decode_emulation_clamps_cursors_past_the_stream():
    """Chunk offsets past the stream's end (a damaged offset table) read
    zeros, as the plain version's clamped, zero-padded last word does."""
    n = 5000
    ref, rh = rhf.encode(stream("codes", n))
    offs = _offs(rh)
    offs[2:] += 1 << 20
    offs[-1] = 0xFFFFFFFF
    bad_h = dict(rh, offs=offs.astype("<u4").tobytes())
    maxlen, lut, bits = _decode_inputs(ref, n)
    plain = teng.hf_decode_device(torch.from_numpy(np.frombuffer(ref, np.uint8).copy()), bad_h).numpy()
    assert np.array_equal(emulate_decode(bits, offs, lut, maxlen, n), plain)


def _lens_case(case: str) -> np.ndarray:
    if case in KINDS:
        return rhf.code_lengths(np.bincount(stream(case, 300_001), minlength=256))
    lens = np.zeros(256, np.uint8)
    if case == "maxlen1":  # two one-bit codes
        lens[[7, 200]] = 1
    elif case == "maxlen16":  # a complete code with 1..15-bit codes and two 16-bit ones
        lens[np.arange(17) * 3] = list(range(1, 16)) + [16, 16]
    else:  # "maxlen16-incomplete": the top of the table is empty
        lens[np.arange(16) * 5] = list(range(1, 16)) + [16]
    return lens


@pytest.mark.parametrize("case", list(KINDS) + ["maxlen1", "maxlen16", "maxlen16-incomplete"])
def test_first_level_lookup_equals_the_pair_lut_for_every_peek(case):
    """For every value of the top maxlen peek bits (the lookup reads no
    others), the first-level entry or its escape is the port's _pair_lut
    entry, which equals the JAX package's."""
    codes, lens, first_code, sym_table, offsets, counts = thf.canonical_codes(_lens_case(case))
    maxlen = int(lens.max())
    lut = thf._pair_lut(first_code, counts, sym_table, offsets, maxlen)
    assert np.array_equal(lut, rhf._pair_lut(first_code, counts, sym_table, offsets, maxlen))
    small, kb = first_level(lut, maxlen)
    top = np.arange(1 << maxlen, dtype=np.uint64)
    for low in (0, (1 << (32 - maxlen)) - 1):  # the bits below the top maxlen, all clear and all set
        peek = (top << _u(32 - maxlen)) | _u(low)
        assert np.array_equal(lookup(small, kb, lut, maxlen, peek), lut.astype(np.uint64))
    hits = small[(top >> _u(maxlen - kb)).astype(np.int64)] != 0
    assert hits.any() and (maxlen <= kb or not hits.all())  # codes longer than the table escape


@pytest.mark.parametrize("align", range(16))
def test_decode_emulation_at_every_alignment_of_the_bits(align):
    """The bits at each start alignment 0-15 of their 16-byte word decode to
    the input, and a truncated stream to the plain decode's bytes."""
    n = 20_000 + 1024 * align + 1
    data = stream("deep" if align % 2 else "codes", n)
    ref, rh = rhf.encode(data)
    maxlen, lut, bits = _decode_inputs(ref, n)
    assert np.array_equal(emulate_decode(bits, _offs(rh), lut, maxlen, n, align), data)
    bad = damaged(ref, n, "trunc")
    maxlen, lut, bits = _decode_inputs(bad, n)
    plain = teng.hf_decode_device(torch.from_numpy(np.frombuffer(bad, np.uint8).copy()), rh).numpy()
    assert np.array_equal(emulate_decode(bits, _offs(rh), lut, maxlen, n, align), plain)


@pytest.mark.parametrize("align", [1, 3, 7, 13])
def test_encode_emulation_of_a_view_at_an_odd_offset(align):
    """A ``data`` view ``align`` bytes past a 16-byte boundary (the lanes'
    shifted loads, the ragged tail), under tile orders from several seeds,
    encodes to the host coder's bytes; a short capacity writes nothing past
    it."""
    n = 40 * CHUNK + 333
    data = stream("uniform" if align == 13 else "codes", n)
    ref, rh = rhf.encode(data)
    lens, codes = _codebook(data)
    for seed in range(3):
        got, chunk_bytes = emulate_encode(data, lens, codes, align, seed)
        assert got == ref and dict({"n": n}, **rhf.offset_table(chunk_bytes)) == rh
    short, keep = np.bincount(data, minlength=256) // 2, {}
    with pytest.raises(ValueError):
        emulate_encode(data, lens, codes, align, 0, counts=short, keep=keep)
    got = keep["payload"].tobytes()
    assert len(got) == 256 + 2 * 41 + int(short @ lens.astype(np.int64)) // 8 + 41 and got == ref[:len(got)]
