"""Dataset write/read over container v3 frame streams, the JAX package's
format (``repro.io.rw``): a file either package writes, the other reads.

On-disk layout: one v3 stream (``CSZH3`` magic, see
:mod:`repro_torch.core.frames`) whose global header carries
``kind="dataset"``, the dataset attrs, and a per-variable manifest — name,
dims, shape, dtype, chunk grid, compression-spec string, and the index of
its first frame. Each chunk is one frame:

* lossy chunks are complete v1/v2 compressor containers, so every chunk
  decodes on its own through :meth:`repro_torch.core.Compressor.decompress`;
* lossless chunks are zlib-deflated raw bytes behind a small serial header
  (``RAWC`` tag), byte-identical on read for any dtype.

Reading one chunk of one variable touches that frame's bytes (and the
12-byte-per-frame table walk), never the rest of the file.

The compression argument is the canonical spec string
(``"lossy,<eb_mode>,<eb>[,key=value...]"``, parsed by
:meth:`repro_torch.core.CompressorSpec.from_string`) or ``"lossless"``, or
a :class:`~repro_torch.core.CompressorSpec`; a dict maps variable names to
their own. Compression and decompression run on the card unless the
caller passes ``device="cpu"``; arrays in and out are host numpy arrays.
Tracing: ``rawc.encode`` / ``rawc.decode`` span the lossless chunks; the
lossy chunks carry the compressor's spans.
"""
from __future__ import annotations

import os
import zlib

import numpy as np
from torch.profiler import record_function as span

from ..core import frames as frames_mod
from ..core.compressor import Compressor, CompressorSpec
from ..core.errors import SpecError
from ..core.serial import pack_obj, unpack_obj
from .dataset import Dataset, Variable, _default_dims

_RAW_TAG = b"RAWC"
FORMAT_VERSION = 1


# ----------------------------------------------------------------- specs
def parse_compression(spec) -> CompressorSpec | None:
    """A spec string or CompressorSpec in, a ``CompressorSpec`` out, or
    ``None`` for lossless (raw chunk frames); :class:`SpecError` on bad
    grammar."""
    if spec is None:
        return None
    if isinstance(spec, CompressorSpec):
        return spec
    if isinstance(spec, str):
        if spec.strip().lower() == "lossless":
            return None
        return CompressorSpec.from_string(spec)
    raise SpecError(f"compression must be a spec string or CompressorSpec, got {type(spec).__name__}")


def _spec_string(spec: CompressorSpec | None) -> str:
    return "lossless" if spec is None else spec.to_string()


# -------------------------------------------------------------- chunking
def _chunk_grid(shape: tuple[int, ...], chunks) -> tuple[int, ...]:
    """A chunk-shape request against a variable shape: ``None`` is one chunk
    for the whole variable, an int applies to every axis, a tuple gives
    per-axis chunk lengths (clamped to the shape)."""
    if not shape:
        return ()
    if chunks is None:
        return tuple(shape)
    if isinstance(chunks, (int, np.integer)):
        chunks = (int(chunks),) * len(shape)
    chunks = tuple(int(c) for c in chunks)
    if len(chunks) != len(shape):
        raise ValueError(f"chunks {chunks} does not match rank of shape {shape}")
    if any(c <= 0 for c in chunks):
        raise ValueError(f"chunk lengths must be positive, got {chunks}")
    return tuple(min(c, s) for c, s in zip(chunks, shape))


def _grid_counts(shape, chunk_shape):
    # a zero-length axis has zero chunks (the variable writes no frames)
    return tuple(-(-s // c) if c else 0 for s, c in zip(shape, chunk_shape))


def _chunk_slices(shape, chunk_shape):
    """Yield (grid_index, slice_tuple) over the chunk grid, C order."""
    counts = _grid_counts(shape, chunk_shape)
    for flat in range(int(np.prod(counts, dtype=np.int64)) if counts else 1):
        idx, rem = [], flat
        for n in reversed(counts):
            idx.append(rem % n)
            rem //= n
        idx = tuple(reversed(idx))
        yield idx, tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunk_shape, shape))


# ---------------------------------------------------------- chunk codecs
def _encode_chunk(arr: np.ndarray, spec: CompressorSpec | None, comp: Compressor | None) -> bytes:
    if spec is None:
        with span("rawc.encode"):
            hdr = pack_obj({"dtype": str(arr.dtype), "shape": list(arr.shape)})
            raw = zlib.compress(np.ascontiguousarray(arr).tobytes(), 6)
            return _RAW_TAG + len(hdr).to_bytes(4, "little") + hdr + raw
    return comp.compress(arr)


def _decode_chunk(payload, comp: Compressor) -> np.ndarray:
    payload = bytes(payload)
    if payload[:4] == _RAW_TAG:
        with span("rawc.decode"):
            hlen = int.from_bytes(payload[4:8], "little")
            hdr = unpack_obj(payload[8 : 8 + hlen])
            raw = zlib.decompress(payload[8 + hlen :])
            return np.frombuffer(raw, dtype=np.dtype(hdr["dtype"])).reshape(hdr["shape"])
    return comp.decompress(payload)


# ----------------------------------------------------------------- write
def write(dataset, path, *, compression="lossy,abs,1e-3,predictor=auto", chunks=None, sync: bool = False,
          device=None) -> dict:
    """Write a dataset to ``path`` as one chunked v3 container.

    ``dataset`` is a :class:`~repro_torch.io.Dataset` or a plain
    name -> ndarray mapping. ``compression`` is a spec string /
    :class:`~repro_torch.core.CompressorSpec` / ``"lossless"``, or a dict of
    per-variable overrides over those. ``chunks`` is a chunk shape
    (``None`` = whole variable, int, or per-axis tuple) or a per-variable
    dict of the same. The lossy chunks compress on ``device`` (the card by
    default). Returns the manifest (the global header that was written),
    with ``bytes_written`` added.
    """
    if not isinstance(dataset, Dataset):
        dataset = Dataset.from_arrays(dict(dataset))
    if not isinstance(compression, dict):
        compression = {None: compression}
    if not isinstance(chunks, dict):
        chunks = {None: chunks}
    default_spec = parse_compression(compression.get(None, "lossless"))

    manifest = []
    plans = []  # (variable, spec, chunk_shape) in manifest order
    frame_start = 0
    for name, var in dataset.items():
        spec = parse_compression(compression[name]) if name in compression else default_spec
        req = chunks.get(name, chunks.get(None))
        if name not in chunks and isinstance(req, (tuple, list)) and len(req) != var.data.ndim:
            req = None  # a dataset-wide chunk shape only applies where ranks match
        cshape = _chunk_grid(var.shape, req)
        counts = _grid_counts(var.shape, cshape) if cshape else ()
        n_chunks = int(np.prod(counts, dtype=np.int64)) if counts else 1
        manifest.append({
            "name": name, "dims": list(var.dims), "shape": list(var.shape),
            "dtype": str(var.dtype), "chunk_shape": list(cshape),
            "chunk_counts": list(counts), "n_chunks": n_chunks,
            "frame_start": frame_start, "spec": _spec_string(spec),
            "attrs": dict(var.attrs),
        })
        plans.append((var, spec, cshape))
        frame_start += n_chunks
    header = {"kind": "dataset", "version": FORMAT_VERSION, "attrs": dict(dataset.attrs), "variables": manifest}

    with open(path, "wb") as f:
        with frames_mod.FrameWriter(f, header, sync=sync) as w:
            for var, spec, cshape in plans:
                comp = Compressor(spec, device=device) if spec is not None else None
                if not cshape:  # scalar variable: one frame
                    w.write_frame(_encode_chunk(var.data.reshape(()), spec, comp))
                    continue
                for _, sl in _chunk_slices(var.shape, cshape):
                    w.write_frame(_encode_chunk(np.ascontiguousarray(var.data[sl]), spec, comp))
    out = dict(header)
    out["bytes_written"] = os.path.getsize(path)
    return out


# ------------------------------------------------------------------ read
def _load(path_or_buf):
    if isinstance(path_or_buf, (bytes, bytearray, memoryview)):
        return memoryview(path_or_buf)
    with open(path_or_buf, "rb") as f:
        return memoryview(f.read())


def _manifest(header: dict) -> dict:
    if header.get("kind") != "dataset":
        raise ValueError(f"not a repro.io dataset container (kind={header.get('kind')!r}); "
                         "plain compressor containers decode via Compressor.decompress")
    return {v["name"]: v for v in header["variables"]}


def manifest(path) -> dict:
    """The dataset's global header (attrs + per-variable manifest) without
    touching any chunk payload."""
    buf = _load(path)
    header, _ = frames_mod.frame_table(buf)
    _manifest(header)  # validates kind
    return header


def _assemble(meta: dict, payloads, comp: Compressor) -> np.ndarray:
    shape = tuple(meta["shape"])
    cshape = tuple(meta["chunk_shape"])
    if not shape or not cshape:
        return _decode_chunk(next(iter(payloads)), comp).reshape(shape)
    out = np.empty(shape, np.dtype(meta["dtype"]))
    for (_, sl), payload in zip(_chunk_slices(shape, cshape), payloads):
        chunk = _decode_chunk(payload, comp)
        out[sl] = chunk.reshape(tuple(s.stop - s.start for s in sl)).astype(out.dtype, copy=False)
    return out


def read_variable(path, name: str, *, chunks=None, device=None) -> np.ndarray:
    """Read one variable, or one chunk of it, by random access.

    ``chunks=None`` assembles the full variable. ``chunks=i`` (flat index)
    or ``chunks=(i, j, ...)`` (grid coordinates) reads that chunk's frame
    alone and returns its array; no other frame's payload is read or
    CRC-checked. Lossy chunks decode on ``device`` (the card by default).
    """
    buf = _load(path)
    header, table = frames_mod.frame_table(buf)
    meta = _manifest(header).get(name)
    if meta is None:
        raise KeyError(f"no variable {name!r}; have {list(_manifest(header))}")
    comp = Compressor(device=device)
    start, n = meta["frame_start"], meta["n_chunks"]
    if chunks is None:
        return _assemble(meta, (frames_mod.read_frame(buf, table[start + i]) for i in range(n)), comp)
    counts = tuple(meta["chunk_counts"])
    if isinstance(chunks, (int, np.integer)):
        flat = int(chunks)
    else:
        idx = tuple(int(i) for i in chunks)
        if len(idx) != len(counts) or any(not 0 <= i < c for i, c in zip(idx, counts)):
            raise IndexError(f"chunk index {idx} outside grid {counts}")
        flat = 0
        for i, c in zip(idx, counts):
            flat = flat * c + i
    if not 0 <= flat < n:
        raise IndexError(f"chunk {flat} outside [0, {n}) for variable {name!r}")
    chunk = _decode_chunk(frames_mod.read_frame(buf, table[start + flat]), comp)
    return chunk.astype(np.dtype(meta["dtype"]), copy=False)


def read(path, *, device=None) -> Dataset:
    """Read the whole dataset back: every variable assembled from its chunk
    frames (lossy chunks decode on ``device``, the card by default), dims
    and attrs restored from the manifest."""
    buf = _load(path)
    header, table = frames_mod.frame_table(buf)
    _manifest(header)  # validates kind
    comp = Compressor(device=device)
    ds = Dataset(attrs=dict(header.get("attrs") or {}))
    for meta in header["variables"]:
        start, n = meta["frame_start"], meta["n_chunks"]
        data = _assemble(meta, (frames_mod.read_frame(buf, table[start + i]) for i in range(n)), comp)
        dims = tuple(meta["dims"]) or _default_dims(meta["name"], data.ndim)
        ds[meta["name"]] = Variable(data, dims, dict(meta.get("attrs") or {}))
    return ds
