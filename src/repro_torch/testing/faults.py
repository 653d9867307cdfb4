"""Deterministic fault injectors for the chaos test suite.

Every injector is a pure function ``bytes -> bytes`` (or a thin wrapper
around a file object), parameterized so a committed fixture or a seeded
sweep reproduces the exact same damage forever. Storage faults model the
real failure modes of the v3 container stack:

* :func:`bit_flip` — a single flipped bit (media corruption);
* :func:`truncate_fraction` — the stream cut short (crash mid-transfer);
* :func:`torn_tail` — a torn write: the tail replaced by garbage the
  length of a partially-landed block (power loss inside ``write()``);
* :func:`corrupt_frame` / :func:`drop_frame` — frame-targeted damage for
  v3 streams (flip inside payload i / splice a whole record out);
* :class:`FlakyFile` — a file wrapper raising ``OSError`` on the Nth
  ``write()``/``read()`` call, driving the retry/backoff paths.

Seeding: :func:`fault_seed` reads ``REPRO_FAULTS`` (pinned in the CI
chaos lane) so randomized sweeps are reproducible across runs; pass the
result to :func:`fault_rng` / hypothesis / your own sampler.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def fault_seed(default: int = 20260808) -> int:
    """The chaos-suite seed: ``REPRO_FAULTS`` env var, or ``default``."""
    try:
        return int(os.environ.get("REPRO_FAULTS", default))
    except ValueError:
        return default


def fault_rng(seed: int | None = None) -> np.random.Generator:
    return np.random.default_rng(fault_seed() if seed is None else seed)


# ---------------------------------------------------------------- storage
def bit_flip(buf: bytes, offset: int, bit: int = 0) -> bytes:
    """Flip one bit at byte ``offset`` (negative offsets index from the end)."""
    b = bytearray(buf)
    b[offset] ^= 1 << (bit & 7)
    return bytes(b)


def truncate_fraction(buf: bytes, fraction: float) -> bytes:
    """Keep the first ``fraction`` of the stream (crash mid-transfer)."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction must be in [0, 1], got {fraction}")
    return bytes(buf[: int(len(buf) * fraction)])


def torn_tail(buf: bytes, fraction: float, *, garbage: int = 64, seed: int | None = None) -> bytes:
    """Torn write: truncate at ``fraction`` then append ``garbage`` bytes
    of seeded noise — the on-disk state after a write that half-landed."""
    kept = truncate_fraction(buf, fraction)
    noise = fault_rng(seed).integers(0, 256, size=garbage, dtype=np.uint8).tobytes()
    return kept + noise


# ----------------------------------------------------------- v3 targeted
def _v3_table(buf: bytes):
    from ..core import frames

    header, table = frames.frame_table(buf)
    sync = bool(header.get("_sync"))
    prefix = 24 if sync else 12  # sync: 8B marker + u32 seq + u64 size + u32 crc
    return table, prefix


def corrupt_frame(buf: bytes, index: int, *, offset: int = 0, bit: int = 0) -> bytes:
    """Flip one bit inside frame ``index``'s payload of a v3 stream."""
    table, _ = _v3_table(buf)
    off, size, _ = table[index]
    if not -size <= offset < size:
        raise ValueError(f"offset {offset} outside frame {index} (size {size})")
    return bit_flip(buf, off + (offset % size), bit)


def drop_frame(buf: bytes, index: int) -> bytes:
    """Splice frame ``index``'s whole record (prefix + payload) out of a
    v3 stream, leaving the trailer count untouched — the reader sees a
    consistent-looking stream whose declared count no longer matches."""
    table, prefix = _v3_table(buf)
    off, size, _ = table[index]
    return bytes(buf[: off - prefix]) + bytes(buf[off + size :])


# ----------------------------------------------------------- encoder fault
@contextlib.contextmanager
def perturb_quant_codes(*, n_calls: int = 1, delta: int = 5, frac: float = 0.01,
                        seed: int | None = None):
    """Arm the compressor's quantization-code fault hook for a ``with``
    block: the first ``n_calls`` predictor runs get ``frac`` of their
    *nonzero* codes shifted by ±``delta`` (clipped into [1, 255] so the
    code==0 <=> outlier invariant survives), after which the hook
    disarms. Each perturbed code lands the reconstruction ``delta * 2eb``
    away from its point — a genuine silent bound violation of the kind a
    predictor/engine bug would produce, which ``CompressorSpec(verify=
    "sample")`` must catch and repair (the repair re-encode runs after
    the hook disarms, so it is clean). Deterministic under
    :func:`fault_seed`; yields a stats dict (``calls``, ``perturbed``).

    The hook takes the block codes as a tensor on the compressor's device
    and draws its picks with numpy on a host copy, so the same codes and
    seed perturb the same points as the JAX package's injector; the codes
    go back to the device. Only an armed hook pays that round trip.
    """
    from ..core import compressor as _comp

    rng = fault_rng(seed)
    stats = {"calls": 0, "perturbed": 0}

    def hook(codes: torch.Tensor) -> torch.Tensor:
        if stats["calls"] >= n_calls:
            return codes
        stats["calls"] += 1
        orig = codes.cpu().numpy().reshape(-1)
        flat = orig.copy()
        nz = np.flatnonzero(flat != 0)
        if nz.size == 0:
            return codes
        k = max(1, int(nz.size * frac))
        pick = rng.choice(nz, size=min(k, nz.size), replace=False)
        shift = np.where(rng.random(pick.size) < 0.5, -delta, delta).astype(np.int32)
        moved = np.clip(flat[pick].astype(np.int32) + shift, 1, 255)
        # a shift that lands back on the original value would be a no-op;
        # push those to the other side
        same = moved == flat[pick]
        moved[same] = np.clip(flat[pick][same].astype(np.int32) - shift[same], 1, 255)
        flat[pick] = moved.astype(flat.dtype)
        stats["perturbed"] += int(np.count_nonzero(flat != orig))
        return torch.from_numpy(flat.reshape(tuple(codes.shape))).to(codes.device)

    prev = _comp._CODE_FAULT
    _comp._CODE_FAULT = hook
    try:
        yield stats
    finally:
        _comp._CODE_FAULT = prev


# ------------------------------------------------------------------- I/O
class FlakyFile:
    """File-object wrapper that raises on chosen calls.

    ``fail_calls``: 1-based call numbers (counted per wrapped op across
    the object's lifetime) that raise instead of performing the op;
    ``fail_ops``: which methods count/fail (default both ``write`` and
    ``read``); ``exc``: exception factory. The failure happens *before*
    the underlying call, so a retried op is safe to repeat — the
    transient-fault model the retry layer assumes.

        sink = FlakyFile(open(p, "wb"), fail_calls={2, 3})
        sink.write(a)   # ok          (call 1)
        sink.write(b)   # OSError     (call 2)
        sink.write(b)   # OSError     (call 3)
        sink.write(b)   # ok          (call 4) -> retry succeeds
    """

    def __init__(self, f, *, fail_calls=(), fail_ops=("write", "read"),
                 exc=lambda: OSError("injected transient I/O fault")):
        self._f = f
        self._fail_calls = set(int(c) for c in fail_calls)
        self._fail_ops = tuple(fail_ops)
        self._exc = exc
        self.calls = 0
        self.faults = 0

    def _gate(self, op: str):
        if op in self._fail_ops:
            self.calls += 1
            if self.calls in self._fail_calls:
                self.faults += 1
                raise self._exc()

    def write(self, b):
        self._gate("write")
        return self._f.write(b)

    def read(self, *a):
        self._gate("read")
        return self._f.read(*a)

    def flush(self):
        self._gate("flush")
        if hasattr(self._f, "flush"):
            return self._f.flush()

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if hasattr(self._f, "close"):
            self._f.close()
