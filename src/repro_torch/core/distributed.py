"""Chunked and sharded compression to container v3, and its parallel decode.

``chunk_compress`` splits a field along one axis at the JAX package's
``np.linspace`` bounds and writes one frame per chunk, each frame
``Compressor.compress`` of the chunk byte for byte, streaming to a sink.
``shard_compress`` is its parallel form: one worker thread per shard, each
on its own device under its own CUDA stream, and each frame again
``Compressor(spec, device=d).compress(chunk)`` byte for byte, so any mix of
sharded writers and single-field readers round-trips. ``shard_decompress``
decodes a v3 chunk stream, optionally on a thread pool that shares one
Compressor (its per-call records are per thread).

The JAX package runs its sharded compress under ``shard_map`` over a mesh
of devices; here the mesh is a list of ``torch.device``. The list may
repeat a device: ``devices=[cuda:0] * 4`` runs the four-shard body on one
card (four streams there), and ``devices=["cpu"] * 4`` on the CPU.

Nothing falls back. The JAX package replays the whole field through
``chunk_compress`` when its device pass fails; here a shard that fails
raises, and the stream is left without its trailer, so it reads as
truncated. The routing to ``chunk_compress`` for one device, an axis that
does not divide, or a predictor without a device path is the JAX
package's and is not a fallback.

Tracing: ``compress.frames`` spans the frame writes (CRC32 and the sink's
write); each chunk's compress and decode carry the compressor's spans.
"""
from __future__ import annotations

import io
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function as span

from . import frames
from .compressor import Compressor, CompressorSpec
from .errors import ContainerError


def _chunk_header(x_shape, axis: int, sizes, spec: CompressorSpec) -> dict:
    return {"kind": "chunks", "version": 3, "shape": list(x_shape), "axis": int(axis),
            "chunk_sizes": [int(s) for s in sizes], "eb_mode": spec.eb_mode}


def _chunk_bounds(n: int, n_chunks: int) -> np.ndarray:
    """The JAX package's chunk bounds along an axis of length ``n``."""
    return np.linspace(0, n, n_chunks + 1).astype(np.int64)


def _slice(ndim: int, axis: int, lo: int, hi: int) -> tuple:
    return tuple(slice(int(lo), int(hi)) if d == axis else slice(None) for d in range(ndim))


def _as_field(x):
    """A numpy array or a torch tensor, as given (a tensor keeps its device)."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ sequential
def chunk_compress(x, *, axis: int = 0, n_chunks: int | None = None, spec: CompressorSpec | None = None,
                   compressor: Compressor | None = None, out=None, sync: bool = False, **kw) -> bytes | int:
    """Host-sequential v3 producer: split along ``axis`` into ``n_chunks``
    chunks at ``np.linspace`` bounds, one frame per chunk
    (``Compressor.compress`` of the chunk, bit for bit).

    ``x`` is a numpy array or a tensor (a chunk moves to the compressor's
    device). ``compressor``, or ``Compressor(spec, **kw)`` (``kw`` may give
    ``device``), compresses every chunk, and its telemetry gathers theirs.
    ``out``: an optional file-like sink; frames are written and flushed as
    each chunk's encode completes, and the frame count is returned.
    Without ``out`` the packed v3 bytes are returned. ``sync=True`` writes
    per-frame sync markers (repro_torch.core.frames). A chunk that fails
    aborts the stream (no trailer, so it reads as truncated) and raises.
    """
    comp = compressor if compressor is not None else Compressor(spec, **kw)
    x = _as_field(x)
    n = int(x.shape[axis])
    n_chunks = max(1, min(n, n_chunks if n_chunks is not None else 1))
    bounds = _chunk_bounds(n, n_chunks)
    sink = out if out is not None else io.BytesIO()
    hold, comp._telemetry_hold = comp._telemetry_hold, True
    if not hold:  # a holding caller keeps its records
        comp.last_telemetry = None
    try:
        with frames.FrameWriter(sink, _chunk_header(x.shape, axis, np.diff(bounds), comp.spec), sync=sync) as w:
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                frame = comp.compress(x[_slice(x.ndim, axis, lo, hi)])
                with span("compress.frames"):  # the CRC and the write
                    w.write_frame(frame)
        nf = w.close()
    finally:
        comp._telemetry_hold = hold
    return nf if out is not None else sink.getvalue()


# ---------------------------------------------------------------- sharded
def default_devices() -> list[torch.device]:
    """Every visible CUDA device; raises where there is none (pass
    ``devices=["cpu"] * k`` to run the shards on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; shard_compress runs on the card unless given CPU devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _compress_shard(spec, device, plan_cache, x, sl, producer):
    """One shard: copy the chunk onto ``device`` and compress it there, under
    a stream of its own on a card. Returns (frame, telemetry, plan), read in
    the worker's thread (the records are per thread)."""
    comp = Compressor(spec, device=device, plan_cache=plan_cache)
    if device.type != "cuda":
        return comp.compress(x[sl]), comp.last_telemetry, comp.last_plan
    stream = torch.cuda.Stream(device)
    if producer is not None:  # the field was written on the caller's stream: wait for it
        stream.wait_stream(producer)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        frame = comp.compress(x[sl])  # the copy to the device and every kernel run on this stream
        stream.synchronize()
    return frame, comp.last_telemetry, comp.last_plan


def shard_compress(x, devices=None, *, axis: int = 0, spec: CompressorSpec | None = None,
                   compressor: Compressor | None = None, out=None, sync: bool = False, **kw):
    """Device-parallel v3 producer: ``len(devices)`` equal chunks of ``x``
    along ``axis``, one worker thread per chunk on its device (a CUDA stream
    of its own there), each frame ``Compressor(spec, device=d).compress``
    of its chunk byte for byte, so the stream equals
    ``chunk_compress(x, n_chunks=len(devices))``.

    ``devices``: a sequence of ``torch.device`` (or names), by default every
    visible CUDA device; it may repeat a device, as ``[cuda:0] * 4`` does
    to run four shards on one card. ``x``: a numpy array, a tensor, or a
    nested dict/list/tuple of them, which gives the same structure of
    containers (scalar leaves are rejected). ``compressor`` gives the spec
    and the plan cache; its telemetry and ``last_plan`` (the last shard's)
    gather the shards'. One device, an axis that ``len(devices)`` does not
    divide, or a predictor other than interp/auto routes to
    :func:`chunk_compress`, as in the JAX package. ``out``: an optional
    file-like sink; frames stream to it in order as they complete and the
    frame count is returned. A shard that fails raises; the stream is left
    without its trailer.
    """
    if not isinstance(x, (np.ndarray, torch.Tensor)):
        if out is not None:
            raise ValueError("out= takes a single container; it cannot hold a pytree of leaves — "
                             "stream each leaf separately")
        return _tree_map(x, lambda leaf: shard_compress(_leaf(leaf), devices, axis=axis, spec=spec,
                                                        compressor=compressor, sync=sync, **kw))
    devs = [torch.device(d) for d in (default_devices() if devices is None else devices)]
    if not devs:
        raise ValueError("shard_compress needs at least one device")
    comp = compressor if compressor is not None else Compressor(spec, device=devs[0], **kw)
    sp = comp.spec
    ndev, n = len(devs), int(x.shape[axis])
    if ndev == 1 or n % ndev != 0 or sp.predictor not in ("interp", "auto"):
        return chunk_compress(x, axis=axis, n_chunks=min(n, ndev), compressor=comp, out=out, sync=sync)
    k = n // ndev
    header = _chunk_header(x.shape, axis, [k] * ndev, sp)
    hold = comp._telemetry_hold
    if not hold:
        comp.last_telemetry = None
    tel = comp._telemetry()
    producers = {}
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        producers = {d: torch.cuda.current_stream(x.device) for d in devs if d.type == "cuda"}
    sink = out if out is not None else io.BytesIO()
    with ThreadPoolExecutor(max_workers=ndev) as ex:
        futures = [ex.submit(_compress_shard, sp, d, comp.plan_cache, x, _slice(x.ndim, axis, i * k, (i + 1) * k),
                             producers.get(d)) for i, d in enumerate(devs)]
        # a failing shard raises out of the writer, which then leaves the trailer off
        with frames.FrameWriter(sink, header, sync=sync) as w:
            for fut in futures:
                frame, stel, plan = fut.result()
                with span("compress.frames"):
                    w.write_frame(frame)
                tel["fallbacks"].extend(stel["fallbacks"])
                for key in ("pipeline", "plan_cache", "verify"):
                    if key in stel:
                        tel[key] = stel[key]
                if plan is not None:
                    comp.last_plan = plan
        nf = w.close()
    return nf if out is not None else sink.getvalue()


def _leaf(leaf):
    arr = _as_field(leaf)
    if arr.ndim == 0:  # scalar leaves (step counters, ...) are not fields
        raise TypeError(f"shard_compress pytree leaves must be arrays with ndim >= 1, got "
                        f"{type(leaf).__name__} shaped {tuple(arr.shape)}; filter scalar leaves out first")
    return arr


def _tree_map(tree, fn):
    """Map ``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        mapped = [_tree_map(v, fn) for v in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree)


# ------------------------------------------------------------- decompress
def _decode_workers() -> int:
    """Frame-decode threads: the ``REPRO_DECODE_WORKERS`` variable, else 1."""
    try:
        env = int(os.environ.get("REPRO_DECODE_WORKERS", "0"))
    except ValueError:
        env = 0
    return env if env > 0 else 1


def shard_decompress(buf, frames_sel=None, *, workers: int | None = None, on_error: str = "raise",
                     fill_value: float = 0.0, compressor: Compressor | None = None, out: str = "numpy",
                     device=None):
    """Decode a v3 chunk stream; ``frames_sel`` selects frames (any order).

    ``workers > 1`` decodes the frames on a thread pool that shares one
    Compressor (``compressor``, else ``Compressor(device=device)``); the
    workers run on the caller's current stream, so their kernels keep the
    caller's order, and the host work between them overlaps.
    ``workers=None`` reads ``REPRO_DECODE_WORKERS`` (default 1, the
    sequential ``Compressor.decompress``). ``on_error``, ``fill_value`` and
    ``out`` as in :meth:`Compressor.decompress`; the damage lands on the
    compressor's ``last_damage`` in the calling thread.
    """
    comp = compressor if compressor is not None else Compressor(device=device)
    if workers is None:
        workers = _decode_workers()
    if workers <= 1:
        return comp.decompress(buf, frames=frames_sel, on_error=on_error, fill_value=fill_value, out=out)
    if on_error not in ("raise", "skip", "fill"):
        raise ValueError(f"on_error must be 'raise', 'skip' or 'fill', got {on_error!r}")
    comp.last_damage = None
    header, payloads, report, idx = comp._v3_request(buf, frames_sel, on_error)
    stream = torch.cuda.current_stream(comp.device) if comp.device.type == "cuda" else None

    def one(i: int):
        p = payloads.get(i)
        if p is None:
            if on_error == "raise":
                raise ContainerError(f"frame {i} missing from v3 container")
            return None, None
        if stream is None:
            return comp._decode_frame(p, on_error, out)
        with torch.cuda.device(comp.device), torch.cuda.stream(stream):
            return comp._decode_frame(p, on_error, out)

    if not comp._telemetry_hold:
        comp.last_telemetry = None
    comp._telemetry()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        decoded = list(ex.map(one, idx))
    for i, (_, err) in zip(idx, decoded):  # in frame order, whatever order the workers finished in
        comp._note_decode_damage(report, i, err)
    return comp._assemble_v3(header, idx, [part for part, _ in decoded], report, on_error, fill_value, out)
