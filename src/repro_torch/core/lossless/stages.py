"""Lossless stage registry — the extension point of the encoding layer.

A *stage* is one lossless transform over a uint8 stream:

* ``encode(data) -> (payload, header)`` / ``decode(payload, header)`` on
  numpy arrays (the host reference);
* ``pack_header`` / ``unpack_header`` — the compact binary form of the
  header dict embedded in the pipeline stream; the built-in packers write
  the JAX package's bytes exactly;
* ``estimate(stats) -> float`` — a cheap cost hook: predicted output bytes
  per input byte from sampled stream statistics
  (repro_torch.core.lossless.orchestrate.stream_stats), which the
  orchestrator ranks candidate pipelines by before its trial encodes;
* ``portable`` — decoding needs no optional package (False for ``zstd``);
* ``encode_device(t) -> (payload tensor, header)`` and
  ``decode_device(payload tensor, header, tel) -> tensor`` — torch twins in
  repro_torch.core.lossless.engine, byte-identical to the host stages, run
  on the tensor's device. ``tel`` is the caller's telemetry dict (or None),
  where a twin records a route that the stream's format decided. ``zstd``
  has none: it runs on the host.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import Callable

import numpy as np

from . import bitshuffle as _bit
from . import huffman as _hf
from . import rre as _rre
from . import tcms as _tcms

@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    encode: Callable[[np.ndarray], tuple]
    decode: Callable[[bytes, dict], np.ndarray]
    estimate: Callable[[dict], float]
    pack_header: Callable[[dict], bytes]
    unpack_header: Callable[[bytes], dict]
    portable: bool = True
    encode_device: Callable | None = None
    decode_device: Callable | None = None


_REGISTRY: dict[str, Stage] = {}


def _json_pack(hdr: dict) -> bytes:
    return json.dumps(hdr).encode()


def _json_unpack(raw: bytes) -> dict:
    return json.loads(raw.decode())


def register_stage(name: str, encode: Callable, decode: Callable, *,
                   estimate: Callable[[dict], float] | None = None,
                   pack_header: Callable[[dict], bytes] | None = None,
                   unpack_header: Callable[[bytes], dict] | None = None, portable: bool = True,
                   encode_device: Callable | None = None, decode_device: Callable | None = None,
                   overwrite: bool = False) -> Stage:
    """Register a lossless stage under ``name``; collisions raise unless ``overwrite=True``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"stage {name!r} is already registered "
                         f"(registered stages: {', '.join(sorted(_REGISTRY))}); pass overwrite=True to replace it")
    stage = Stage(name, encode, decode, estimate or _est_unit, pack_header or _json_pack,
                  unpack_header or _json_unpack, portable, encode_device, decode_device)
    _REGISTRY[name] = stage
    return stage


def get_stage(name: str) -> Stage:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown lossless stage {name!r}; "
                         f"registered stages: {', '.join(sorted(_REGISTRY))}") from None


# Binary header packers: the JAX package's layouts, byte for byte.
def _pack_hf(h):
    # versioned: the bare 8-byte form predates the per-chunk byte-offset
    # table ("offs"); streams without it decode through the host decoder
    offs = h.get("offs")
    if offs is None:
        return struct.pack("<Q", h["n"])
    return struct.pack("<QB", h["n"], 1) + offs


def _unpack_hf(raw):
    if len(raw) == 8:
        return {"n": struct.unpack_from("<Q", raw)[0]}
    n, ver = struct.unpack_from("<QB", raw)
    out = {"n": n}
    if ver == 1:
        out["offs"] = bytes(raw[9:])
    return out


def _pack_rre(h):
    return struct.pack("<QQB", h["n"], h["nsym"], h["k"])


def _unpack_rre(raw):
    n, nsym, k = struct.unpack_from("<QQB", raw)
    return {"n": n, "nsym": nsym, "k": k}


def _pack_bit(h):
    return struct.pack("<QI", h["n"], h["block"])


def _unpack_bit(raw):
    n, block = struct.unpack_from("<QI", raw)
    return {"n": n, "block": block}


def _pack_tcms(h):
    return struct.pack("<QB", h["n"], h["k"])


def _unpack_tcms(raw):
    n, k = struct.unpack_from("<QB", raw)
    return {"n": n, "k": k}


def _pack_zstd(h):
    return struct.pack("<B", 1 if h.get("c", "zstd") == "zlib" else 0)


def _unpack_zstd(raw):
    return {"c": "zlib" if raw[0] else "zstd"}


# Cost hooks: predicted output fraction (bytes out per byte in) from the
# sampled stats {n, entropy, zero_frac, run_frac, outlier_frac}. Crude on
# purpose (they ignore how earlier stages reshape the stream): the
# orchestrator refines the ranking with trial encodes.
def _est_hf(s):
    n = max(int(s.get("n", 1)), 1)
    # 256 B of code lengths, and per chunk 2 B of payload size + a 4 B offset entry
    table = (256.0 + 6.0 * (n // _hf.CHUNK + 1)) / n
    return min(1.0, s["entropy"] / 8.0 + table)


def _est_rre(k):
    def est(s):
        kept = 1.0 - float(s["run_frac"]) ** k
        return min(1.0, kept + 1.0 / (8.0 * k))

    return est


def _est_rze(k):
    def est(s):
        kept = 1.0 - float(s["zero_frac"]) ** k
        return min(1.0, kept + 1.0 / (8.0 * k))

    return est


def _est_unit(s):
    return 1.0  # bijective reshuffles (tcms, bit1) pay off downstream


def _est_zstd(s):
    return max(0.02, 0.85 * s["entropy"] / 8.0)


def _zstd_encode(data: np.ndarray):
    # zstandard is optional: without it the stage writes zlib and records the
    # codec it used, so decode dispatches on the stream, not on the machine
    try:
        import zstandard
    except ImportError:
        return zlib.compress(data.tobytes(), 6), {"c": "zlib"}
    return zstandard.ZstdCompressor(level=6).compress(data.tobytes()), {"c": "zstd"}


def _zstd_decode(payload, header: dict) -> np.ndarray:
    if header.get("c", "zstd") == "zlib":
        return np.frombuffer(zlib.decompress(payload), np.uint8)
    try:
        import zstandard
    except ImportError as e:
        raise ImportError("this stream was compressed with the optional 'zstandard' package; "
                          "install it to decode") from e
    return np.frombuffer(zstandard.ZstdDecompressor().decompress(payload), np.uint8)


def _engine(fn_name: str, **fixed):
    """Resolve a device twin lazily (the engine imports the kernels)."""
    def call(*args, _fn=fn_name, _fixed=fixed):
        from . import engine

        return getattr(engine, _fn)(*args, **_fixed)

    return call


def _register_builtins() -> None:
    register_stage("hf", _hf.encode, _hf.decode, estimate=_est_hf, pack_header=_pack_hf, unpack_header=_unpack_hf,
                   encode_device=_engine("hf_encode_device"), decode_device=_engine("hf_decode_device"))
    register_stage("bit1", _bit.bitshuffle_encode, _bit.bitshuffle_decode, estimate=_est_unit,
                   pack_header=_pack_bit, unpack_header=_unpack_bit, encode_device=_engine("bit1_encode_device"),
                   decode_device=_engine("bit1_decode_device"))
    # host only, and not portable: a stream written where zstandard imports needs it to decode
    register_stage("zstd", _zstd_encode, _zstd_decode, estimate=_est_zstd, pack_header=_pack_zstd,
                   unpack_header=_unpack_zstd, portable=False)
    for k in (1, 2, 4, 8):
        register_stage(f"rre{k}", (lambda d, k=k: _rre.rre_encode(d, k)), _rre.rre_decode, estimate=_est_rre(k),
                       pack_header=_pack_rre, unpack_header=_unpack_rre,
                       encode_device=_engine("rre_encode_device", k=k), decode_device=_engine("rre_decode_device"))
        register_stage(f"rze{k}", (lambda d, k=k: _rre.rze_encode(d, k)), _rre.rze_decode, estimate=_est_rze(k),
                       pack_header=_pack_rre, unpack_header=_unpack_rre,
                       encode_device=_engine("rze_encode_device", k=k), decode_device=_engine("rze_decode_device"))
        register_stage(f"tcms{k}", (lambda d, k=k: _tcms.tcms_encode(d, k)), _tcms.tcms_decode, estimate=_est_unit,
                       pack_header=_pack_tcms, unpack_header=_unpack_tcms,
                       encode_device=_engine("tcms_encode_device", k=k), decode_device=_engine("tcms_decode_device"))


_register_builtins()
