"""Lossless stage registry — the extension point of the encoding layer.

A *stage* is one lossless transform over a uint8 stream:

* ``encode(data) -> (payload, header)`` / ``decode(payload, header)`` on
  numpy arrays (the host reference);
* ``pack_header`` / ``unpack_header`` — the compact binary form of the
  header dict embedded in the pipeline stream; the built-in packers write
  the JAX package's bytes exactly;
* ``encode_device(t) -> (payload tensor, header)`` and
  ``decode_device(payload tensor, header, tel) -> tensor`` — torch twins in
  repro_torch.core.lossless.engine, byte-identical to the host stages, run
  on the tensor's device. ``tel`` is the caller's telemetry dict (or None),
  where a twin records a route that the stream's format decided.

The JAX package's ``bit1`` and ``zstd`` stages are not ported yet: looking
them up, or registering those names, raises
:class:`~repro_torch.core.errors.NotPortedError`.
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import Callable

import numpy as np

from ..errors import NotPortedError
from . import huffman as _hf
from . import rre as _rre
from . import tcms as _tcms

UNPORTED_STAGES = ("bit1", "zstd")


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    encode: Callable[[np.ndarray], tuple]
    decode: Callable[[bytes, dict], np.ndarray]
    pack_header: Callable[[dict], bytes]
    unpack_header: Callable[[bytes], dict]
    encode_device: Callable | None = None
    decode_device: Callable | None = None


_REGISTRY: dict[str, Stage] = {}


def _json_pack(hdr: dict) -> bytes:
    return json.dumps(hdr).encode()


def _json_unpack(raw: bytes) -> dict:
    return json.loads(raw.decode())


def register_stage(name: str, encode: Callable, decode: Callable, *,
                   pack_header: Callable[[dict], bytes] | None = None,
                   unpack_header: Callable[[bytes], dict] | None = None,
                   encode_device: Callable | None = None, decode_device: Callable | None = None,
                   overwrite: bool = False) -> Stage:
    """Register a lossless stage under ``name``; collisions raise unless ``overwrite=True``."""
    if name in UNPORTED_STAGES:
        raise NotPortedError(f"lossless stage {name!r} (its name is reserved for the JAX package's format)")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"stage {name!r} is already registered "
                         f"(registered stages: {', '.join(sorted(_REGISTRY))}); pass overwrite=True to replace it")
    stage = Stage(name, encode, decode, pack_header or _json_pack, unpack_header or _json_unpack,
                  encode_device, decode_device)
    _REGISTRY[name] = stage
    return stage


def get_stage(name: str) -> Stage:
    if name in UNPORTED_STAGES:
        raise NotPortedError(f"lossless stage {name!r}")
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


def _pack_tcms(h):
    return struct.pack("<QB", h["n"], h["k"])


def _unpack_tcms(raw):
    n, k = struct.unpack_from("<QB", raw)
    return {"n": n, "k": k}


def _engine(fn_name: str, **fixed):
    """Resolve a device twin lazily (the engine imports the kernels)."""
    def call(*args, _fn=fn_name, _fixed=fixed):
        from . import engine

        return getattr(engine, _fn)(*args, **_fixed)

    return call


def _register_builtins() -> None:
    register_stage("hf", _hf.encode, _hf.decode, pack_header=_pack_hf, unpack_header=_unpack_hf,
                   encode_device=_engine("hf_encode_device"), decode_device=_engine("hf_decode_device"))
    for k in (1, 2, 4, 8):
        register_stage(f"rre{k}", (lambda d, k=k: _rre.rre_encode(d, k)), _rre.rre_decode,
                       pack_header=_pack_rre, unpack_header=_unpack_rre,
                       encode_device=_engine("rre_encode_device", k=k), decode_device=_engine("rre_decode_device"))
        register_stage(f"rze{k}", (lambda d, k=k: _rre.rze_encode(d, k)), _rre.rze_decode,
                       pack_header=_pack_rre, unpack_header=_unpack_rre,
                       encode_device=_engine("rze_encode_device", k=k), decode_device=_engine("rze_decode_device"))
        register_stage(f"tcms{k}", (lambda d, k=k: _tcms.tcms_encode(d, k)), _tcms.tcms_decode,
                       pack_header=_pack_tcms, unpack_header=_unpack_tcms,
                       encode_device=_engine("tcms_encode_device", k=k), decode_device=_engine("tcms_decode_device"))


_register_builtins()
