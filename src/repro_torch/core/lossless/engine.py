"""Device twins of the lossless stages, as torch ops on the tensor's device.

Each ``<stage>_encode_device`` returns a payload tensor byte-for-byte equal
to the host encoder's, and each ``<stage>_decode_device`` the host
decoder's stream, so device-encoded sections drop into the same containers
and either package decodes them. Inputs and outputs are flat uint8
tensors; the tiny serial parts (the 256-leaf Huffman codebook, the
recursive bitmap levels of rre/rze) run on the host over a few bytes that
cross over.

* **hf** — frequencies from the histogram256 CUDA kernel
  (repro_torch.kernels.histogram); emission merges adjacent symbols into
  <=32-bit pairs, takes per-chunk prefix sums of their lengths, and adds
  each pair's one or two 32-bit word contributions into int64 words with
  ``scatter_add_``: contributions to a word occupy disjoint bits, so the
  sum is their OR and exact. Decode walks all 1024-symbol chunks in
  lockstep from the per-chunk byte offsets in the header (``offs``), two
  symbols per 32-bit peek through a (len<<8 | sym) prefix table.
* **rre/rze** — flags and MSB-first bitmap packing on the device; the kept
  rows are a boolean-mask gather. Streams with the legacy hex-in-JSON
  header, which carries the bitmap's top level, decode the same way.
* **tcms** — the bytewise sign-magnitude bijection.

The arithmetic that the host coder does in uint32 with wraparound runs
here in int64 with explicit 32-bit masks: torch's uint32 lacks shifts.

An hf stream whose header has no ``offs`` table (streams written before
the table existed) has no chunk entry points, so it decodes through the
host reference decoder; that route is chosen by the format, recorded as
``tel["hf_decode"] = "host-legacy"``, and is the only host route here.
"""
from __future__ import annotations

import numpy as np
import torch

from ...kernels.histogram import histogram256
from ..errors import ContainerError
from . import huffman as _hf
from . import rre as _rre

_M32 = 0xFFFFFFFF
_PACK_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.packbits bit order


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _bytes_t(raw: bytes, device) -> torch.Tensor:
    return _tensor(np.frombuffer(raw, np.uint8).copy(), device)


def _record(tel: dict | None, key: str, route: str) -> None:
    if tel is not None:
        tel[key] = route


# ----------------------------------------------------------------------- hf
def hf_encode_device(data: torch.Tensor):
    """Device Huffman encode; payload bytes == ``huffman.encode``'s."""
    d = data.reshape(-1)
    dev = d.device
    n = int(d.numel())
    lens = _hf.code_lengths(_host(histogram256(d)))
    codes, lens, *_ = _hf.canonical_codes(lens)
    nck = max(1, -(-n // _hf.CHUNK))
    m = nck * _hf.CHUNK
    half = _hf.CHUNK // 2
    sym = torch.zeros(m, dtype=torch.int64, device=dev)
    sym[:n] = d
    ln = _tensor(lens.astype(np.int64), dev)[sym]
    cw = _tensor(codes.astype(np.int64), dev)[sym]
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
    payload = torch.cat([_tensor(lens.astype(np.uint8), dev), cb, bits])
    return payload, dict({"n": n}, **_hf.offset_table(_host(chunk_bytes).astype("<u2")))


def hf_decode_device(payload: torch.Tensor, header: dict, tel: dict | None = None) -> torch.Tensor:
    """Device Huffman decode; bytes == ``huffman.decode``'s."""
    dev = payload.device
    n = int(header["n"])
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    offs = header.get("offs")
    if offs is None or "lens" in header:  # no chunk entry points in this format
        _record(tel, "hf_decode", "host-legacy")
        return _tensor(_hf.decode(_host(payload).tobytes(), header), dev)
    _record(tel, "hf_decode", "device")
    nchunks = -(-n // _hf.CHUNK)
    if len(offs) != 4 * nchunks:
        raise ContainerError(f"hf offset table has {len(offs) // 4} entries for {nchunks} chunks")
    lens = _host(payload[:256])
    maxlen = int(lens.max())
    if not 0 < maxlen <= _hf.MAXLEN:
        raise ContainerError(f"hf code lengths out of range (max {maxlen})")
    _, _, first_code, sym_table, offsets, counts = _hf.canonical_codes(lens.copy())
    lut = _tensor(_hf._pair_lut(first_code, counts, sym_table, offsets, maxlen).astype(np.int64), dev)
    bits = payload[256 + 2 * nchunks:]
    pad = 8 + (-(int(bits.numel()) + 8)) % 4
    bits = torch.cat([bits, torch.zeros(pad, dtype=torch.uint8, device=dev)]).view(-1, 4).to(torch.int64)
    be = (bits[:, 0] << 24) | (bits[:, 1] << 16) | (bits[:, 2] << 8) | bits[:, 3]
    be_s1 = torch.cat([be[1:], be.new_zeros(1)]) >> 1  # next word, pre-shifted once
    qmax = int(be.numel()) - 1
    cur = _tensor(np.frombuffer(offs, "<u4").astype(np.int64) * 8, dev)
    shift = 32 - maxlen
    half = _hf.CHUNK // 2
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
    return out.view(_hf.CHUNK, nchunks).t().reshape(-1)[:n]


# ------------------------------------------------------------------ rre/rze
def _packbits(flags: torch.Tensor) -> torch.Tensor:
    """MSB-first bit packing of a bool vector (np.packbits layout)."""
    pad = (-int(flags.numel())) % 8
    f = torch.cat([flags, flags.new_zeros(pad)]) if pad else flags
    wts = torch.tensor(_PACK_WEIGHTS, dtype=torch.int32, device=flags.device)
    return (f.view(-1, 8).to(torch.int32) * wts).sum(1).to(torch.uint8)


def _unpackbits(bitmap: torch.Tensor, count: int) -> torch.Tensor:
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bitmap.device)
    return ((bitmap.to(torch.int32)[:, None] >> shifts) & 1).reshape(-1)[:count].bool()


def _rr_encode_device(data: torch.Tensor, k: int, zero_mode: bool):
    d = data.reshape(-1)
    dev = d.device
    n = int(d.numel())
    nsym = -(-n // k)
    if nsym == 0:
        z = np.zeros(0, np.uint8)
        payload, header = _rre._serialize(z, [], [], z, n, k, 0)
        return _bytes_t(payload, dev), header
    pad = nsym * k - n
    view = (torch.cat([d, d.new_zeros(pad)]) if pad else d).view(nsym, k)
    if zero_mode:
        flags = (view != 0).any(1)
    else:
        flags = torch.ones(nsym, dtype=torch.bool, device=dev)
        flags[1:] = (view[1:] != view[:-1]).any(1)
    kept = view[flags].reshape(-1)
    top, levels, sizes = _rre._compress_bitmap(_host(_packbits(flags)))
    meta = (np.asarray([top.size, len(levels)], "<u2").tobytes()
            + np.asarray(list(sizes) + [lv.size for lv in levels], "<u8").tobytes())
    head = meta + top.tobytes() + b"".join(lv.tobytes() for lv in levels)
    return torch.cat([_bytes_t(head, dev), kept]), {"n": n, "k": k, "nsym": nsym}


def rre_encode_device(data, k: int):
    """Device RRE-k; payload bytes == ``rre.rre_encode``'s."""
    return _rr_encode_device(data, k, zero_mode=False)


def rze_encode_device(data, k: int):
    """Device RZE-k; payload bytes == ``rre.rze_encode``'s."""
    return _rr_encode_device(data, k, zero_mode=True)


def _rr_decode_device(payload: torch.Tensor, header: dict, zero_mode: bool):
    dev = payload.device
    n, k, nsym = int(header["n"]), int(header["k"]), int(header["nsym"])
    if nsym == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    if "top" in header:  # legacy hex-in-JSON header: top level and sizes sit in the header
        top = np.frombuffer(bytearray.fromhex(header["top"]), np.uint8)
        sizes, lvl_sizes, off = list(header["sizes"]), list(header["lvl_sizes"]), 0
    else:
        top_len, n_levels = (int(v) for v in _host(payload[:4]).view("<u2"))
        off = 4 + 16 * n_levels
        szs = _host(payload[4:off]).view("<u8")
        sizes = [int(s) for s in szs[:n_levels]]
        lvl_sizes = [int(s) for s in szs[n_levels:]]
        top = _host(payload[off : off + top_len])
        off += top_len
    meta = _host(payload[off : off + sum(lvl_sizes)])  # the bitmap recursion runs on the host
    levels, o = [], 0
    for ls in lvl_sizes:
        levels.append(meta[o : o + ls])
        o += ls
    bitmap = _rre._decompress_bitmap(top, levels, sizes)
    flags = _unpackbits(_tensor(bitmap, dev), nsym)
    kept = payload[off + o:].view(-1, k)
    if zero_mode:
        out = torch.zeros((nsym, k), dtype=torch.uint8, device=dev)
        out[flags] = kept
    else:
        out = kept[torch.cumsum(flags, 0) - 1]
    return out.reshape(-1)[:n]


def rre_decode_device(payload, header: dict, tel: dict | None = None):
    """Device RRE-k decode; bytes == ``rre.rre_decode``'s."""
    return _rr_decode_device(payload, header, False)


def rze_decode_device(payload, header: dict, tel: dict | None = None):
    """Device RZE-k decode; bytes == ``rre.rze_decode``'s."""
    return _rr_decode_device(payload, header, True)


# --------------------------------------------------------------------- tcms
def tcms_encode_device(data: torch.Tensor, k: int):
    """Device TCMS-k; payload bytes == ``tcms.tcms_encode``'s. Rows are
    little-endian k-byte symbols, so the sign lives in the last byte;
    ``~x`` bytewise is ``255 - x``."""
    d = data.reshape(-1)
    n = int(d.numel())
    pad = (-n) % k
    v = (torch.cat([d, d.new_zeros(pad)]) if pad else d).view(-1, k)
    neg = (v[:, -1] & 0x80) != 0
    out = torch.where(neg[:, None], 255 - v, v)
    out[:, -1] = torch.where(neg, out[:, -1] ^ 0x80, out[:, -1])
    return out.reshape(-1), {"n": n, "k": k}


def tcms_decode_device(payload: torch.Tensor, header: dict, tel: dict | None = None):
    """Device TCMS-k decode; bytes == ``tcms.tcms_decode``'s: ``~(x ^ msb)``."""
    n, k = int(header["n"]), int(header["k"])
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=payload.device)
    v = payload.reshape(-1, k)
    neg = (v[:, -1] & 0x80) != 0
    w = v.clone()
    w[:, -1] ^= 0x80
    out = torch.where(neg[:, None], 255 - w, v)
    return out.reshape(-1)[:n]
