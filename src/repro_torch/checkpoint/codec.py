"""Tensor (de)serialization through the cuSZ-Hi codec, on the card.

The JAX package's checkpoint codec (``repro.checkpoint.codec``) with its
file format: the same payload bytes and the same meta keys and values, so
either package restores the other's leaves. Two modes per tensor:

  * lossless: raw bytes + zstd (bit-exact; the default for optimizer
    state and anything integer or small), stdlib zlib where the optional
    ``zstandard`` package does not import; the meta records which codec
    wrote the leaf so restore dispatches correctly;
  * error-bounded: the paper's full pipeline (plan-driven ``predictor=
    "auto"`` interpolation + orchestrated ``pipeline="auto"`` lossless
    stack) on float tensors reshaped to a 2-D field, written as chunked
    container v3 frames (``mode="cuszhi3"``): the field is split along its
    leading axis into ~``_FRAME_TARGET_BYTES`` chunks, each an
    independently decodable frame with its own plan and pipeline choice,
    streamed into the sink as each chunk's encode completes.

Leaves are torch tensors, numpy arrays or Python scalars. ``meta["dtype"]``
is the numpy name of the leaf's dtype, as the JAX package writes it
(``str(np.asarray(leaf).dtype)``): a Python ``float`` is ``float64``, an
``int`` ``int64``, and a ``torch.bfloat16`` leaf ``"bfloat16"``, stored
losslessly through a 16-bit view (numpy has no bfloat16).

Device: an error-bounded leaf compresses on the card from wherever it lives
(a card tensor is not copied to the host first) and :func:`decode_tensor`
returns a tensor on ``device``; both default to the card and raise where
CUDA is absent unless given ``device="cpu"``. A float64 leaf restores as
float64 on the device (the JAX package restores it on the host because JAX
disables 64-bit floats). With more than one card and a leading axis they
divide, the frames are encoded one shard per card (:func:`shard_compress`);
otherwise in sequence (:func:`chunk_compress`).

The ``compressd=`` route (and ``REPRO_COMPRESSD``) of the JAX package
waits for the compressd service, which is not ported (``ROADMAP.md``,
queue 1 item 4): the port raises before it writes anything, and never
writes the leaf another way.

Tracing: ``checkpoint.encode_leaf`` and ``checkpoint.decode_leaf`` span
each leaf; the compressor's spans nest inside them.
"""
from __future__ import annotations

import io
import os
import zlib

import numpy as np
import torch
from torch.profiler import record_function as span

try:  # optional dependency; zlib fallback keeps checkpoints working without it
    import zstandard
except ImportError:  # pragma: no cover - depends on the environment
    zstandard = None

from ..core import Compressor, CompressorSpec
from ..core import distributed as dist
from ..core.lossless import portable_pipelines
from ..core.retry import RetryingWriter

_ZSTD_LEVEL = 3
_ZLIB_LEVEL = 6
_EB_PIPELINE = "auto"  # orchestrated per-tensor pipeline selection
_LEGACY_EB_PIPELINE = "tp"  # checkpoints written before meta recorded the name
_FRAME_TARGET_BYTES = 4 << 20  # ~4 MiB of raw field per v3 frame


def _device(device) -> torch.device:
    """The device a checkpoint call runs on: the card unless ``device`` says otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; checkpoints are written and restored on the card "
                           "unless given device='cpu'")
    return dev


def _as_leaf(x):
    """A tensor (detached, where it lives) or a numpy array; Python and numpy
    scalars become 0-d arrays of numpy's dtype for them."""
    return x.detach() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dtype_name(x) -> str:
    """The numpy name of a leaf's dtype (``"bfloat16"`` for torch's)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=x.dtype).numpy().dtype)
    return str(x.dtype)


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else int(x.nbytes)


def _as_field(x):
    """Reshape an arbitrary tensor to >=2-D for the block predictor."""
    flat = x.reshape(-1)
    n = int(flat.shape[0])
    w = 1
    for cand in (4096, 2048, 1024, 512, 256, 128, 64):
        if n % cand == 0:
            w = cand
            break
    return flat.reshape(-1, w) if w > 1 else flat.reshape(1, -1)


def default_ckpt_spec(eb: float) -> str:
    """The canonical spec string the checkpoint codec compresses with at a
    given bound: plan-driven predictor, orchestrated pipeline, portable
    candidates only — a checkpoint must restore on machines without the
    optional codecs installed here (e.g. zstandard)."""
    cands = ":".join(portable_pipelines())
    return (f"lossy,rel,{eb:g},predictor=auto,pipeline={_EB_PIPELINE},"
            f"pipeline_candidates={cands}")


def _resolve_spec(eb: float, spec) -> CompressorSpec | None:
    """The error-bounded spec for this tensor, or ``None`` for lossless.

    Precedence: explicit ``spec=`` (spec string or CompressorSpec — also
    opts a tensor into error-bounded encoding on its own) > the
    ``REPRO_CKPT_SPEC`` env var (overrides *how* tensors already selected
    via ``eb > 0`` are compressed, never which) > the default built from
    ``eb``. Spec strings parse through ``CompressorSpec.from_string``."""
    if spec is not None:
        if isinstance(spec, str):
            spec = CompressorSpec.from_string(spec)
        return spec
    if eb <= 0:
        return None
    env = os.environ.get("REPRO_CKPT_SPEC")
    if env:
        return CompressorSpec.from_string(env)
    return CompressorSpec.from_string(default_ckpt_spec(eb))


def _n_frames(field) -> int:
    return int(max(1, min(field.shape[0], -(-_nbytes(field) // _FRAME_TARGET_BYTES))))


class _CountingSink:
    """Counts bytes and folds a running CRC32 over everything written —
    the per-leaf integrity record ``restore(strict=False)`` checks before
    attempting a decode."""

    def __init__(self, f):
        self._f = f
        self.nbytes = 0
        self.crc32 = 0

    def write(self, b):
        self._f.write(b)
        self.nbytes += len(b)
        self.crc32 = zlib.crc32(b, self.crc32) & 0xFFFFFFFF

    def flush(self):
        if hasattr(self._f, "flush"):
            self._f.flush()


def _raw_bytes(x) -> bytes:
    """The leaf's bytes in C order (a card tensor is copied to the host:
    the lossless codecs run there)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def encode_tensor_to(f, x, *, eb: float = 0.0, spec=None, retry: bool = True, compressd: str | None = None,
                     device=None) -> dict:
    """Encode ``x`` (a tensor, array or scalar) into file-like ``f``; returns
    the manifest meta (with ``bytes`` and a whole-payload ``crc32``). eb = 0
    -> lossless; eb > 0 -> value-range-relative bound on float32 and float64
    leaves of 4096 or more elements. ``spec`` (a canonical spec string or
    :class:`~repro_torch.core.CompressorSpec`) selects the full
    error-bounded configuration instead — the ``REPRO_CKPT_SPEC`` env var
    does the same for every ``eb > 0`` tensor without touching call sites;
    the spec string used lands in the manifest meta. ``device``: where an
    error-bounded leaf compresses, the card unless ``"cpu"``.

    The error-bounded path streams v3 frames into ``f`` as each chunk's
    encode completes — with per-frame sync markers, so a damaged leaf file
    salvages at O(damage) with exact chunk indices — and the lossless path
    writes one blob. ``retry=True`` (default) wraps ``f`` in
    :class:`repro_torch.core.retry.RetryingWriter`: transient ``OSError``
    from a flaky filesystem is retried with exponential backoff + jitter
    instead of killing the save; the retry count lands in the returned
    meta (``io_retries``) when nonzero.

    ``compressd`` (or the ``REPRO_COMPRESSD`` env var) raises
    ``NotImplementedError`` before anything is written: the service is not
    ported yet.
    """
    compressd = compressd or os.environ.get("REPRO_COMPRESSD") or None
    if compressd:
        raise NotImplementedError(
            f"compressd={compressd!r}: the compressd service is not ported to repro_torch yet "
            "(ROADMAP.md, queue 1 item 4); unset REPRO_COMPRESSD / compressd= to encode in process")
    dev = _device(device)
    x = _as_leaf(x)
    dtype = _dtype_name(x)
    meta = {"shape": [int(s) for s in x.shape], "dtype": dtype}
    rf = RetryingWriter(f) if retry else f
    sink = _CountingSink(rf)
    sp = _resolve_spec(eb, spec)
    with span("checkpoint.encode_leaf"):
        if sp is not None and dtype in ("float32", "float64") and int(np.prod(x.shape)) >= 4096:
            spec_str = sp.to_string()
            meta_eb = sp.eb if eb <= 0 else eb
            field = _as_field(x.to(torch.float32) if isinstance(x, torch.Tensor) else x.astype(np.float32))
            comp = Compressor(sp, device=dev)
            n_frames = _n_frames(field)
            ncards = torch.cuda.device_count() if dev.type == "cuda" else 1
            if ncards > 1 and field.shape[0] % ncards == 0:
                # device-parallel frames: one shard per card
                dist.shard_compress(field, dist.default_devices(), compressor=comp, out=sink, sync=True)
                n_frames = ncards
            else:
                dist.chunk_compress(field, n_chunks=n_frames, compressor=comp, out=sink, sync=True)
            plan = comp.last_plan  # last frame's plan (full per-frame plans ride the container)
            meta.update(mode="cuszhi3", eb=meta_eb, field_shape=[int(s) for s in field.shape],
                        pipeline=sp.pipeline, predictor=sp.predictor, spec=spec_str,
                        n_frames=n_frames, bytes=sink.nbytes, crc32=sink.crc32,
                        plan=None if plan is None else plan.to_header())
        else:
            raw = _raw_bytes(x)
            if zstandard is not None:
                meta.update(mode="zstd")
                sink.write(zstandard.ZstdCompressor(level=_ZSTD_LEVEL).compress(raw))
            else:
                meta.update(mode="zlib")
                sink.write(zlib.compress(raw, _ZLIB_LEVEL))
            meta["bytes"] = sink.nbytes
            meta["crc32"] = sink.crc32
    if retry and rf.retries:
        meta["io_retries"] = rf.retries
    return meta


def encode_tensor(x, *, eb: float = 0.0, spec=None, device=None) -> tuple[bytes, dict]:
    """In-memory :func:`encode_tensor_to`: returns ``(payload, meta)``."""
    bio = io.BytesIO()
    meta = encode_tensor_to(bio, x, eb=eb, spec=spec, device=device)
    return bio.getvalue(), meta


def decode_tensor(payload: bytes, meta: dict, *, device=None) -> torch.Tensor:
    """Inverse of :func:`encode_tensor`: a tensor of the leaf's shape and
    dtype on ``device`` (the card unless ``"cpu"``). Error-bounded leaves
    (``mode`` ``cuszhi3``, and the single-container ``cuszhi`` of older
    checkpoints) decode there; lossless ones decode on the host and move."""
    dev = _device(device)
    shape = tuple(int(s) for s in meta["shape"])
    name = meta["dtype"]
    with span("checkpoint.decode_leaf"):
        if meta["mode"] in ("cuszhi", "cuszhi3"):  # v3 frames decode through the same path
            pipeline = meta.get("pipeline", _LEGACY_EB_PIPELINE)
            comp = Compressor(CompressorSpec(eb=meta["eb"], pipeline=pipeline, autotune=False), device=dev)
            field = comp.decompress(payload, out="device")
            return field.reshape(-1)[: int(np.prod(shape))].reshape(shape).to(_torch_dtype(name))
        if meta["mode"] == "zlib":
            raw = zlib.decompress(payload)
        else:
            if zstandard is None:
                raise ImportError(
                    "checkpoint tensor was written with the optional 'zstandard' package; install it to restore"
                )
            raw = zstandard.ZstdDecompressor().decompress(payload)
        if name == "bfloat16":
            host = torch.from_numpy(np.frombuffer(raw, np.int16).copy()).view(torch.bfloat16)
        else:
            host = torch.from_numpy(np.frombuffer(raw, np.dtype(name)).copy())
        return host.reshape(shape).to(dev)
