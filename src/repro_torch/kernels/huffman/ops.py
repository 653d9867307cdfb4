"""Wrappers of the Huffman encode and decode CUDA kernels (csrc/huffman.cu).

They replace no Pallas kernel but the JAX package's jitted device programs
of the hf stage: ``hf_decode`` its ``_hf_dec`` scan and ``hf_encode`` its
``_hf_emit_a`` / ``_hf_emit_b`` (``src/repro/core/lossless/engine.py``).
The bitstream is the host coder's (repro_torch.core.lossless.huffman):
1024-symbol chunks starting on byte boundaries, MSB-first codes of at most
16 bits, the payload ``[256 code lengths][u16 bytes per chunk][bits]``.
The codebook is built on the host; these take it as arrays.

On a CUDA tensor each wrapper launches its kernel or raises; a CPU tensor,
and only a CPU tensor, goes to the plain version beside it. ``LAUNCHES``
counts wrapper calls that launched.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..build import KernelError, count_launch, library

CHUNK = 1024  # symbols per chunk of the hf format
MAXLEN = 16  # the longest code the format allows
_M32 = 0xFFFFFFFF
LAUNCHES = {"hf_encode": 0, "hf_decode": 0}


def _on(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def hf_encode_plain(data: torch.Tensor, lens: np.ndarray, codes: np.ndarray):
    """Plain torch encode of a flat uint8 tensor under the codebook ``lens``
    / ``codes`` (256 entries each): the payload tensor and the chunk byte
    counts (host, ``<u2``). Merges adjacent symbols into <=32-bit pairs,
    takes per-chunk prefix sums of their lengths, and adds each pair's one
    or two 32-bit word contributions into int64 words with ``scatter_add_``:
    contributions to a word occupy disjoint bits, so the sum is their OR.
    The arithmetic the host coder does in uint32 runs in int64 with explicit
    32-bit masks: torch's uint32 lacks shifts."""
    d = data.reshape(-1)
    dev = d.device
    n = int(d.numel())
    nck = max(1, -(-n // CHUNK))
    m = nck * CHUNK
    half = CHUNK // 2
    sym = torch.zeros(m, dtype=torch.int64, device=dev)
    sym[:n] = d
    ln = _on(lens.astype(np.int64), dev)[sym]
    cw = _on(codes.astype(np.int64), dev)[sym]
    ln[n:] = 0  # pad lanes carry zero-length codes
    cw[n:] = 0
    ln, cw = ln.view(-1, 2), cw.view(-1, 2)
    v2 = (cw[:, 0] << ln[:, 1]) | cw[:, 1]  # pair value, <= 32 bits
    l2 = ln[:, 0] + ln[:, 1]
    del sym, ln, cw
    cum = l2.view(nck, half).cumsum(1)
    chunk_bytes = (cum[:, -1] + 7) >> 3
    byte_off = torch.zeros(nck + 1, dtype=torch.int64, device=dev)
    byte_off[1:] = chunk_bytes.cumsum(0)
    bitpos = ((cum - l2.view(nck, half)) + (byte_off[:-1] << 3)[:, None]).reshape(-1)
    del cum
    total = int(byte_off[-1])
    nwords = (total + 3) >> 2
    # pair bits [bitpos, bitpos+l2) of the big-endian word stream: word w
    # takes the high part, word w+1 the spill when it crosses a boundary
    sh = (bitpos & 31) + l2  # <= 63
    spill = sh > 32
    hi = torch.where(spill, v2 >> (sh - 32).clamp(min=0), v2 << (32 - sh).clamp(min=0))
    lo = torch.where(spill, (v2 << (64 - sh).clamp(max=63)) & _M32, torch.zeros_like(v2))
    w = bitpos >> 5
    del bitpos, sh, spill, v2, l2
    words = torch.zeros(nwords + 2, dtype=torch.int64, device=dev)
    words.scatter_add_(0, w, hi)
    words.scatter_add_(0, w + 1, lo)
    words = words[:nwords]
    bits = torch.stack([(words >> 24) & 255, (words >> 16) & 255, (words >> 8) & 255, words & 255], 1)
    bits = bits.to(torch.uint8).reshape(-1)[:total]
    cb = torch.stack([chunk_bytes & 255, chunk_bytes >> 8], 1).to(torch.uint8).reshape(-1)
    payload = torch.cat([_on(lens.astype(np.uint8), dev), cb, bits])
    return payload, chunk_bytes.cpu().numpy().astype("<u2")


def hf_decode_plain(bits: torch.Tensor, offs: torch.Tensor, lut: torch.Tensor, maxlen: int, n: int) -> torch.Tensor:
    """Plain torch decode of ``n`` symbols from the bitstream ``bits`` (the
    payload after its chunk table), each chunk from its byte offset in
    ``offs`` (uint32, as the header stores them, or int64), through the pair LUT ``lut`` (2^maxlen entries,
    ``len<<8 | sym``): all chunks in lockstep, two symbols per 32-bit peek.
    Word reads clamp to the zero-padded stream's last word."""
    dev = bits.device
    nchunks = int(offs.numel())
    lut = lut.to(torch.int64)
    pad = 8 + (-(int(bits.numel()) + 8)) % 4
    bits = torch.cat([bits, torch.zeros(pad, dtype=torch.uint8, device=dev)]).view(-1, 4).to(torch.int64)
    be = (bits[:, 0] << 24) | (bits[:, 1] << 16) | (bits[:, 2] << 8) | bits[:, 3]
    be_s1 = torch.cat([be[1:], be.new_zeros(1)]) >> 1  # next word, pre-shifted once
    qmax = int(be.numel()) - 1
    cur = offs.to(torch.int64) * 8
    shift = 32 - maxlen
    half = CHUNK // 2
    out = torch.empty((half, 2, nchunks), dtype=torch.uint8, device=dev)
    for t in range(half):  # lanes past their chunk's last symbol decode junk, trimmed below
        q = (cur >> 5).clamp_(max=qmax)
        r = cur & 31
        peek = ((be[q] << r) & _M32) | (be_s1[q] >> (31 - r))
        e1 = lut[peek >> shift]
        ls1 = e1 >> 8
        e2 = lut[((peek << ls1) & _M32) >> shift]
        cur = cur + ls1 + (e2 >> 8)
        out[t, 0] = (e1 & 255).to(torch.uint8)
        out[t, 1] = (e2 & 255).to(torch.uint8)
    return out.view(CHUNK, nchunks).t().reshape(-1)[:n]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("huffman")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hf_decode.argtypes = [vp, i64, vp, vp, i32, i64, i64, vp, vp]
    lib.hf_encode.argtypes = [vp, i64, vp, i64, vp, i64, vp, i64, vp, vp, vp]
    for fn in (lib.hf_decode, lib.hf_encode):
        fn.restype = ctypes.c_int
    lib.hf_encode_scratch_bytes.argtypes = [i64]
    lib.hf_encode_scratch_bytes.restype = i64
    return lib


def _is_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes a CPU or CUDA tensor, got {t.device}")
    return True


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name} launch failed with CUDA error {rc}")


def hf_encode(data: torch.Tensor, lens: np.ndarray, codes: np.ndarray, counts: np.ndarray):
    """Huffman-encode a flat uint8 tensor under the host codebook ``lens`` /
    ``codes``: the payload (on the input's device, bytes ==
    ``huffman.encode``'s) and the chunk byte counts (host, ``<u2``).

    ``counts``, the input's 256 symbol counts (the histogram the codebook
    was built from), size the payload exactly before the one launch; the
    CPU route does not need them. Counts that do not describe ``data`` raise
    ValueError after the kernel has written only inside the payload."""
    if not _is_cuda(data, "hf_encode"):
        return hf_encode_plain(data, lens, codes)
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError(f"hf_encode takes a contiguous 1-D uint8 tensor, got {data.dtype} {tuple(data.shape)}")
    if lens.shape != (256,) or codes.shape != (256,) or int(lens.max(initial=0)) > MAXLEN:
        raise ValueError("hf_encode takes 256 code lengths of at most 16 bits and 256 codes")
    counts = np.asarray(counts, np.int64).reshape(-1)
    if counts.shape != (256,):
        raise ValueError(f"hf_encode takes 256 symbol counts, got {counts.shape}")
    dev = data.device
    n = int(data.numel())
    nck = max(1, -(-n // CHUNK))
    cap = int(counts @ lens.astype(np.int64)) // 8 + nck  # each chunk rounds its bits up to a byte
    table = np.ascontiguousarray((codes.astype(np.uint32) << np.uint32(8)) | lens.astype(np.uint32))
    at = -(-(256 + 2 * nck + cap) // 8) * 8  # hf_encode's scratch, after the payload
    at_total = -(-2 * nck // 8) * 8  # where the bits' total lands in the host buffer, after the chunk table
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = int(lib.hf_encode_scratch_bytes(nck))
        buf = torch.empty(at + scratch, dtype=torch.uint8, device=dev)
        host = torch.empty(at_total + 8, dtype=torch.uint8, pin_memory=True)
        rc = lib.hf_encode(_ptr(data), n, table.ctypes.data_as(ctypes.c_void_p), nck, _ptr(buf[at:]), scratch,
                           _ptr(buf), cap, _ptr(host), _ptr(host[at_total:]), ctypes.c_void_p(stream))
        _raise_on(rc, "hf_encode")
        torch.cuda.current_stream(dev).synchronize()  # the one host read: the chunk table and the total
    count_launch(LAUNCHES, "hf_encode")
    h = host.numpy()
    total = int(h[at_total:].view("<i8")[0])
    if total > cap:
        raise ValueError(f"hf_encode: the symbol counts give {cap} bytes of bits, the input takes {total}")
    return buf[:256 + 2 * nck + total], h[:2 * nck].view("<u2")


def hf_decode(bits: torch.Tensor, offs: torch.Tensor, lut: torch.Tensor, maxlen: int, n: int) -> torch.Tensor:
    """Decode ``n`` uint8 symbols (on the input's device) from the bitstream
    ``bits``, chunk c from byte ``offs[c]`` (uint32, as the header stores
    them; the plain version also takes int64), through the pair LUT ``lut``
    (int16, 2^maxlen entries ``len<<8 | sym``); bytes == ``huffman.decode``'s,
    damaged streams included."""
    if not _is_cuda(bits, "hf_decode"):
        return hf_decode_plain(bits, offs, lut, maxlen, n)
    maxlen, n = int(maxlen), int(n)
    nchunks = max(1, -(-n // CHUNK))
    if bits.dtype != torch.uint8 or bits.dim() != 1 or not bits.is_contiguous():
        raise ValueError(f"hf_decode takes a contiguous 1-D uint8 bitstream, got {bits.dtype} {tuple(bits.shape)}")
    if not 0 < maxlen <= MAXLEN:
        raise ValueError(f"hf_decode takes code lengths 1-{MAXLEN}, got {maxlen}")
    if offs.dtype != torch.uint32 or offs.shape != (nchunks,) or offs.device != bits.device:
        raise ValueError(f"hf_decode takes {nchunks} uint32 chunk offsets on {bits.device}")
    if lut.dtype != torch.int16 or lut.shape != (1 << maxlen,) or lut.device != bits.device:
        raise ValueError(f"hf_decode takes an int16 LUT of {1 << maxlen} entries on {bits.device}")
    offs, lut = offs.contiguous(), lut.contiguous()
    out = torch.empty(n, dtype=torch.uint8, device=bits.device)
    if n == 0:
        return out
    with torch.cuda.device(bits.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(bits.device).cuda_stream)
        rc = _lib().hf_decode(_ptr(bits), int(bits.numel()), _ptr(offs), _ptr(lut), maxlen, n, nchunks, _ptr(out),
                              stream)
    _raise_on(rc, "hf_decode")
    count_launch(LAUNCHES, "hf_decode")
    return out
