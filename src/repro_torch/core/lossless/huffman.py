"""Canonical Huffman coding over uint8 symbols (the HF stage, §5.2).

This is the host reference coder. The device twins in
repro_torch.core.lossless.engine produce the same bytes; their histogram
comes from the histogram256 CUDA kernel. The 256-leaf tree build is
O(256 log 256) scalar work and runs host-side. The bitstream is chunked
(1024 symbols, byte-aligned per chunk) like cuSZ's coarse-grained layout so
decode parallelizes across chunks.

Hot-path architecture (vectorized word-level packing, cuSZ's reduce-merge
idea recast for numpy):

* **Codes are length-limited to 16 bits** (gentle Kraft repair that only
  lengthens the rarest codes), which keeps every per-symbol quantity in
  32-bit lanes — wide-integer elementwise numpy is several times slower on
  commodity hosts — and makes a complete (length, symbol) prefix LUT
  affordable.
* **encode**: one table gather yields ``len<<16 | code`` per symbol and a
  uint16 view splits the fields without shift/mask passes; a wrapping
  uint16 cumsum gives within-chunk bit offsets (per-chunk sums are < 2^14,
  so mod-2^16 differences are exact); adjacent symbols are reduce-merged
  into <=32-bit pairs; each pair is shifted into its one or two 32-bit
  big-endian output words; colliding word contributions are disjoint-bit,
  so OR == ADD and a segmented sum (cumsum + boundary gathers) materializes
  the words with no per-bit scatter and no ``ufunc.at``. The bit layout is
  identical to the historical per-bit ``np.packbits`` path. Large inputs
  are split at chunk boundaries across a small thread pool (numpy releases
  the GIL on these array passes); slab payloads concatenate byte-exactly.
* **decode** is vectorized across chunks: one aligned big-endian uint32
  window pair per step gives a 32-bit peek; a uint16 LUT over the top
  ``maxlen`` bits returns ``len<<8 | symbol`` directly (canonical codes of
  length l own the contiguous range ``[first_code[l] << (LB-l),
  (first_code[l]+count[l]) << (LB-l))``), and because codes are <=16 bits
  the same peek also resolves a *second* symbol (``ls1 + maxlen <= 32``) —
  two symbols per window gather. Output rows are written transposed so the
  per-step stores stay contiguous. Decode stays single-threaded: its per
  step vectors are chunk-count sized, too small to amortize GIL handoffs.
* the section header is compact binary (256 raw code-length bytes + one u16
  of payload bytes per chunk) carried inside the payload; the JSON header
  holds only ``{"n": ...}``.  Legacy hex-in-JSON headers (4096-symbol
  chunks, codes up to 24 bits) still decode via a generic slow path.
"""
from __future__ import annotations

import heapq
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

CHUNK = 1024
MAXLEN = 16  # length-limit so the (len,sym) LUT + 32-bit lanes cover every code
_LEGACY_CHUNK = 4096
_LEGACY_MAXLEN = 24
_TABLE = _LEGACY_MAXLEN  # canonical tables sized for the legacy maximum

_U0, _U1, _U5, _U8, _U16, _U31, _U32 = (np.uint32(x) for x in (0, 1, 5, 8, 16, 31, 32))

def _nworkers() -> int:
    """Slab-encode worker count: REPRO_HF_WORKERS overrides the cpu-based
    default (useful to pin benchmarks or to serialize under oversubscribed
    schedulers); invalid or non-positive values fall back to the default."""
    try:
        env = int(os.environ.get("REPRO_HF_WORKERS", "0"))
    except ValueError:
        env = 0
    return env if env > 0 else max(1, min(4, os.cpu_count() or 1))


_NWORKERS = _nworkers()
_PAR_MIN = 1 << 20  # encode bytes below this stay single-threaded
_SLAB_SYMS = 1 << 26  # keeps per-slab bit offsets < 2^30 (int32-view-safe)
_DECODE_GROUP_BYTES = 1 << 28  # payload span per u32-cursor decode group
_pool = None


def _executor() -> ThreadPoolExecutor:
    global _pool
    if _pool is None:
        _pool = ThreadPoolExecutor(max_workers=_NWORKERS)
    return _pool


def _reset_pool() -> None:
    """Drop the inherited pool in forked children: its worker threads do not
    survive fork, so reusing it would deadlock the next threaded encode.

    Registered via os.register_at_fork below — callers never need to (and
    must not be relied upon to) invoke this themselves; any fork started
    by any library picks up the cleanup automatically. The worker count is
    also re-read so a child can resize via REPRO_HF_WORKERS before its
    first encode."""
    global _pool, _NWORKERS
    _pool = None
    _NWORKERS = _nworkers()


if hasattr(os, "register_at_fork"):  # pragma: no branch - posix
    os.register_at_fork(after_in_child=_reset_pool)


def code_lengths(hist: np.ndarray) -> np.ndarray:
    """Huffman code length per symbol (0 for absent symbols), <= MAXLEN."""
    sym = np.flatnonzero(hist)
    if sym.size == 0:
        return np.zeros(256, np.uint8)
    if sym.size == 1:
        out = np.zeros(256, np.uint8)
        out[sym[0]] = 1
        return out
    heap = [(int(hist[s]), int(s), (int(s),)) for s in sym]
    heapq.heapify(heap)
    tick = 256
    depth = {int(s): 0 for s in sym}
    while len(heap) > 1:
        fa, _, la = heapq.heappop(heap)
        fb, _, lb = heapq.heappop(heap)
        for s in la + lb:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, tick, la + lb))
        tick += 1
    out = np.zeros(256, np.uint8)
    for s, d in depth.items():
        out[s] = d
    if out.max() > MAXLEN:
        out = _fix_kraft(out)
    return out


def _fix_kraft(lens: np.ndarray) -> np.ndarray:
    """Length-limit to MAXLEN: lengthen the rarest (longest) codes until the
    Kraft sum fits. Only sub-MAXLEN codes grow, and the longest such code
    belongs to the least frequent symbols, so the CR impact is minimal."""
    lens = np.minimum(lens.astype(np.int64), MAXLEN)
    used = lens > 0
    kraft = float(np.sum(np.where(used, 2.0 ** (-lens.astype(float)), 0.0)))
    while kraft > 1.0 + 1e-12:
        cand = np.where(used & (lens < MAXLEN), lens, -1)
        i = int(np.argmax(cand))
        kraft -= 2.0 ** (-float(lens[i]) - 1)
        lens[i] += 1
    return lens.astype(np.uint8)


def canonical_codes(lens: np.ndarray):
    """MSB-first canonical codewords: (codes u32, lens, first_code[l], sym_table, offsets[l])."""
    order = np.lexsort((np.arange(256), lens.astype(np.int64)))
    order = order[lens[order] > 0]
    codes = np.zeros(256, np.uint32)
    first_code = np.zeros(_TABLE + 2, np.uint32)
    counts = np.bincount(lens[lens > 0].astype(np.int64), minlength=_TABLE + 2)
    c = 0
    for l in range(1, _TABLE + 1):
        first_code[l] = c
        c = (c + int(counts[l])) << 1
    nxt = {l: int(first_code[l]) for l in range(1, _TABLE + 1)}
    for s in order:
        l = int(lens[s])
        codes[s] = nxt[l]
        nxt[l] += 1
    sym_table = order.astype(np.uint8)  # symbols sorted by (len, sym) == canonical order
    offsets = np.zeros(_TABLE + 2, np.int64)
    offsets[1:] = np.cumsum(counts)[:-1][: _TABLE + 1]
    return codes, lens, first_code, sym_table, offsets, counts


# --------------------------------------------------------------------- encode
def _encode_slab(d: np.ndarray, tbl: np.ndarray):
    """Encode one slab (any length; chunk grid local to the slab).

    Returns (payload bytes, chunk_bytes u16).
    """
    m0 = d.size
    nck = max(1, -(-m0 // CHUNK))
    m = nck * CHUNK
    half = CHUNK // 2
    if m != m0:  # pad to a full chunk grid; padded lanes carry zero-length codes
        d = np.concatenate([d, np.zeros(m - m0, np.uint8)])
    e = tbl[d]  # u32: len<<16 | code
    if m != m0:
        e[m0:] = 0
    # reduce-merge adjacent symbols into <=32-bit pairs (CHUNK is even, so
    # pairs never straddle a chunk boundary); ep rows = [c0, l0, c1, l1]
    ep = e.view("<u2").reshape(-1, 4)
    v2 = (ep[:, 0].astype(np.uint32) << ep[:, 3]) | ep[:, 2]
    l2 = ep[:, 1] + ep[:, 3]  # u16, <= 32
    # within-chunk bit offsets from the wrapping u16 pair-length cumsum
    # (per-chunk sums < 2^14, so mod-2^16 differences are exact)
    cum2 = np.cumsum(l2, dtype=np.uint16).reshape(nck, half)
    cbase = np.empty(nck, np.uint16)
    cbase[0] = 0
    cbase[1:] = cum2[:-1, -1]
    chunk_bytes = ((cum2[:, -1] - cbase).astype(np.int64) + 7) >> 3
    byte_off = np.zeros(nck + 1, np.int64)
    np.cumsum(chunk_bytes, out=byte_off[1:])
    total = int(byte_off[-1])
    s2rel = np.empty((nck, half), np.uint16)
    s2rel[:, 0] = 0
    s2rel[:, 1:] = cum2[:, :-1] - cbase[:, None]  # exclusive offset of pair j
    bitpos = s2rel.astype(np.uint32)
    bitpos += (byte_off[:-1, None] << 3).astype(np.uint32)
    bitpos = bitpos.reshape(-1)
    # word-level scatter: pair i covers bits [bitpos, bitpos+l2) of the
    # big-endian u32 word stream -> one or two word contributions
    sh = (bitpos & _U31) + l2
    spill = sh > 32
    s_left = _U0 - sh  # (32-sh) % 32 == (64-sh) % 32 once masked below
    s_left &= _U31
    sh &= _U31  # == sh-32 for spill lanes (sh <= 63); junk elsewhere, masked out
    lo = np.left_shift(v2, s_left, out=s_left)  # spill lanes: bits for word w+1
    hi = np.right_shift(v2, sh, out=sh)  # spill lanes: bits for word w
    np.copyto(hi, lo, where=~spill)  # non-spill lanes fit word w entirely
    np.copyto(lo, _U0, where=~spill)
    nwords = (total + 3) >> 2
    # word w holds pairs with bitpos in [32w, 32w+32); bitpos is sorted
    w32 = np.right_shift(bitpos, _U5, out=bitpos).view(np.int32)
    bounds = np.zeros(nwords + 1, np.int64)
    # zero-length pad pairs may sit one word past the end; dropping their
    # (zero) contributions is exact
    np.cumsum(np.bincount(w32, minlength=nwords)[:nwords], out=bounds[1:])
    words = _segment_sum(hi, bounds)
    words[1:] |= _segment_sum(lo, bounds)[:-1]  # lo lands one word later
    return words.astype(">u4").tobytes()[:total], chunk_bytes.astype("<u2")


def _segment_sum(vals: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Per-segment sums of u32 `vals` split at `bounds` (prefix-sum diff).

    Contributions within a word occupy disjoint bit ranges, so sums never
    carry (OR == ADD) and mod-2^32 prefix differences are exact."""
    csum = np.empty(vals.size + 1, np.uint32)
    csum[0] = 0
    np.cumsum(vals, out=csum[1:])
    g = csum[bounds]
    return g[1:] - g[:-1]


def encode(data: np.ndarray):
    """data: uint8 array. Returns (payload bytes, header dict).

    Payload = [256B code lengths][u16 payload bytes per chunk][bitstream];
    the JSON-visible header carries only the symbol count.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    nchunks = max(1, -(-n // CHUNK))
    nslabs = 1
    if n >= _PAR_MIN:
        nslabs = max(_NWORKERS, -(-n // _SLAB_SYMS))
    ck_per = -(-nchunks // nslabs)
    cuts = [min(i * ck_per * CHUNK, n) for i in range(nslabs + 1)]
    slabs = [data[cuts[i] : cuts[i + 1]] for i in range(nslabs) if cuts[i] < cuts[i + 1]] or [data]
    if len(slabs) > 1:
        hists = list(_executor().map(lambda s: np.bincount(s, minlength=256), slabs))
        hist = np.sum(hists, axis=0)
    else:
        hist = np.bincount(data, minlength=256)
    lens = code_lengths(hist)
    codes, lens, *_ = canonical_codes(lens)
    tbl = (lens.astype(np.uint32) << _U16) | codes
    if len(slabs) > 1:
        parts = list(_executor().map(lambda s: _encode_slab(s, tbl), slabs))
    else:
        parts = [_encode_slab(slabs[0], tbl)]
    bits = b"".join(p[0] for p in parts)
    chunk_bytes = np.concatenate([p[1] for p in parts])
    blob = lens.tobytes() + chunk_bytes.tobytes()
    return blob + bits, dict({"n": int(n)}, **offset_table(chunk_bytes))


def offset_table(chunk_bytes: np.ndarray) -> dict:
    """Per-chunk byte-offset header extension from the chunk sizes.

    ``{"offs": <u4 exclusive byte offset per chunk>}`` — the random-access
    table the device decoder gathers against (every chunk's bitstream
    start, so all chunks decode in parallel without replaying the size
    prefix sum serially). Omitted for payloads past the u32 range; headers
    without it (legacy streams) decode through the host reference path.
    """
    cum = np.cumsum(chunk_bytes.astype(np.int64))
    if cum.size and cum[-1] >= 1 << 32:
        return {}
    offs = np.zeros(cum.size, "<u4")
    offs[1:] = cum[:-1]
    return {"offs": offs.tobytes()}


# --------------------------------------------------------------------- decode
def _be32(bits: np.ndarray):
    """(be, beS1): native u32 views of the big-endian payload words with zero
    slack; beS1 is the next word pre-shifted right once, so the window
    combine `(be[q] << r) | (beS1[q] >> (31-r))` never needs a 32-bit shift."""
    pad = 8 + (-(bits.size + 8)) % 4
    buf = np.concatenate([bits, np.zeros(pad, np.uint8)])
    be = buf.view(">u4").astype(np.uint32)
    return be, be[1:] >> _U1


def _pair_lut(first_code, counts, sym_table, offsets, maxlen: int) -> np.ndarray:
    """uint16 LUT over the top `maxlen` peek bits: entry = len<<8 | symbol."""
    lut = np.zeros(1 << maxlen, np.uint16)
    for l in range(1, maxlen + 1):
        fc, cnt = int(first_code[l]), int(counts[l])
        if cnt == 0:
            continue
        syms = sym_table[int(offsets[l]) : int(offsets[l]) + cnt]
        ent = (np.uint16(l) << np.uint16(8)) | syms.astype(np.uint16)
        lut[fc << (maxlen - l) : (fc + cnt) << (maxlen - l)] = np.repeat(ent, 1 << (maxlen - l))
    return lut


def _span_pairs(be, beS1, cursors, outT, t0, t1, lut, shift_lut):
    """Decode symbols t0..t1-1 into transposed rows outT[t] (in place).

    One aligned u32 window pair per step yields a 32-bit peek; the LUT
    resolves (len, sym) for two consecutive symbols per peek (valid because
    maxlen <= 16, so ls1 + maxlen <= 32)."""
    t = t0
    while t < t1:
        q = cursors >> _U5
        r = cursors & _U31
        peek = (be[q] << r) | (beS1[q] >> (_U31 - r))
        e1 = lut[peek >> shift_lut]
        outT[t] = e1  # truncating store keeps the symbol byte
        ls1 = e1 >> _U8
        if t + 1 < t1:
            e2 = lut[(peek << ls1) >> shift_lut]
            outT[t + 1] = e2
            cursors += ls1 + (e2 >> _U8)
            t += 2
        else:
            cursors += ls1
            t += 1


def _span_generic(be, beS1, cursors, outT, t0, t1, lengths, base, sym_table):
    """One-symbol-per-step decode for legacy streams (codes up to 24 bits)."""
    t = t0
    while t < t1:
        q = cursors >> _U5
        r = cursors & _U31
        peek = (be[q] << r) | (beS1[q] >> (_U31 - r))
        ls = lengths(peek)
        cw = (peek >> (_U32 - ls.astype(np.uint32))).astype(np.int64)
        outT[t] = sym_table[base[ls] + cw]
        cursors += ls.astype(np.uint32)
        t += 1


def _length_lookup(first_code, counts, maxlen: int):
    """f(peek: 32-bit MSB-aligned u32) -> code length, for the legacy path."""
    # limit[l] = (first_code[l]+count[l]) << (32-l) is monotone over l; u64
    # because a complete tree has first_code[maxlen]+count[maxlen] == 2^maxlen,
    # so the top limit is exactly 2^32
    limits = np.zeros(maxlen, np.uint64)
    for l in range(1, maxlen + 1):
        limits[l - 1] = np.uint64((int(first_code[l]) + int(counts[l])) << (32 - l))
    return lambda peek: 1 + np.searchsorted(limits, peek.astype(np.uint64), side="right").astype(np.int64)


def decode(payload: bytes, header: dict) -> np.ndarray:
    n = int(header["n"])
    if n == 0:
        return np.zeros(0, np.uint8)
    legacy = "lens" in header
    if legacy:  # hex-in-JSON header from seed containers
        chunk = _LEGACY_CHUNK
        lens = np.frombuffer(bytes.fromhex(header["lens"]), np.uint8).copy()
        chunk_bytes = np.frombuffer(bytes.fromhex(header["chunk_bytes"]), np.uint32).astype(np.int64)
        bits = np.frombuffer(payload, np.uint8)
    else:
        chunk = CHUNK
        nchunks = max(1, -(-n // CHUNK))
        buf = np.frombuffer(payload, np.uint8)
        lens = buf[:256].copy()
        chunk_bytes = buf[256 : 256 + 2 * nchunks].view("<u2").astype(np.int64)
        bits = buf[256 + 2 * nchunks :]
    codes, lens, first_code, sym_table, offsets, counts = canonical_codes(lens)
    maxlen = int(lens.max())
    nchunks = chunk_bytes.size
    byte_off = np.zeros(nchunks + 1, np.int64)
    np.cumsum(chunk_bytes, out=byte_off[1:])
    be, beS1 = _be32(bits)
    if maxlen <= MAXLEN:
        lut = _pair_lut(first_code, counts, sym_table, offsets, maxlen)
        shift_lut = np.uint32(32 - maxlen)

        def span(bv, bsv, cur, o, t0, t1):
            _span_pairs(bv, bsv, cur, o, t0, t1, lut, shift_lut)

    else:  # legacy deep tree
        lengths = _length_lookup(first_code, counts, maxlen)
        base = offsets - first_code.astype(np.int64)

        def span(bv, bsv, cur, o, t0, t1):
            _span_generic(bv, bsv, cur, o, t0, t1, lengths, base, sym_table)

    n_last = n - chunk * (nchunks - 1)
    outT = np.zeros((chunk, nchunks), np.uint8)  # transposed: row store per step
    # the hot loop keeps bit cursors in u32; chunk groups whose payload span
    # exceeds the 32-bit cursor range are rebased onto a word-aligned origin
    # and decoded from offset views (one group for payloads < 256 MiB)
    group_bytes = _DECODE_GROUP_BYTES
    a = 0
    while a < nchunks:
        word0 = byte_off[a] >> 2  # aligned origin at/below the group start
        b = a + 1
        while b < nchunks and byte_off[b + 1] - (word0 << 2) <= group_bytes:
            b += 1
        cur = (byte_off[a:b] * 8 - (word0 << 5)).astype(np.uint32)
        bv, bsv, oT = be[word0:], beS1[word0:], outT[:, a:b]
        if b == nchunks:
            span(bv, bsv, cur, oT, 0, n_last)
            if b - a > 1 and n_last < chunk:
                span(bv, bsv, cur[:-1], oT[:, :-1], n_last, chunk)
        else:
            span(bv, bsv, cur, oT, 0, chunk)
        a = b
    out = np.ascontiguousarray(outT.T)
    if n_last == chunk:
        return out.reshape(-1)
    return np.concatenate([out[:-1].reshape(-1), out[-1, :n_last]])
