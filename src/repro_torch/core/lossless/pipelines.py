"""Composable lossless pipelines over the stage registry (paper §5.2, Fig. 7).

A pipeline is a named sequence of registered stages. The port runs the
pipelines whose stages it has: CR mode ``hf -> rre4 -> tcms8 -> rze1``,
``hf`` alone, ``lvl`` and ``none``. The JAX package's pipelines that need
``bit1`` or ``zstd`` (tp, fz, fzh, crz) are known by name, so a spec that
names one still parses, but using one raises
:class:`~repro_torch.core.errors.NotPortedError`.

Device path: when ``encode`` receives a torch tensor, every stage runs its
torch twin on the tensor's device (repro_torch.core.lossless.engine) and
the stream chains between stages as a tensor; the bytes land on the host
once, in the packed stream. ``decode(buf, device=...)`` is the symmetric
read path. Either path gives the host path's bytes.

Stream format (LLP2, shared with the JAX package): ``b"LLP2"``, a stage
count, then one record per stage — flags byte (bit0 = store-through for a
stage that would have expanded the stream), name, binary-packed header —
then the final payload. Streams older than LLP2 (a u32 length-prefixed
JSON meta block) are detected by the missing magic and decode through the
same registry.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch
from torch.profiler import record_function as span

from ..errors import NotPortedError
from .stages import get_stage

_MAGIC = b"LLP2"

PIPELINES: dict[str, tuple] = {}  # name -> stage-name tuple (live registry)
# the JAX package's pipelines that need a stage this port does not have yet
UNPORTED_PIPELINES = {
    "tp": ("tcms1", "bit1", "rre1"),
    "fz": ("bit1", "rre1"),
    "crz": ("hf", "rre4", "tcms8", "rze1", "zstd"),
    "fzh": ("bit1", "rre1", "hf"),
}


def register_pipeline(name: str, stages, *, overwrite: bool = False) -> tuple:
    """Register a named pipeline; every stage must already be registered."""
    stages = tuple(stages)
    for s in stages:
        get_stage(s)  # raises with the registered-stage list on typos
    if name in PIPELINES and not overwrite and PIPELINES[name] != stages:
        raise ValueError(f"pipeline {name!r} is already registered as {PIPELINES[name]}; "
                         "pass overwrite=True to replace it")
    PIPELINES[name] = stages
    return stages


def get_pipeline(name: str) -> tuple:
    if name in UNPORTED_PIPELINES:
        raise NotPortedError(f"pipeline {name!r} {UNPORTED_PIPELINES[name]}")
    try:
        return PIPELINES[name]
    except KeyError:
        raise ValueError(f"unknown pipeline {name!r}; "
                         f"registered pipelines: {', '.join(sorted(PIPELINES))} (or 'auto')") from None


def known_pipeline(name: str) -> bool:
    """A pipeline name the spec grammar accepts (ported or not)."""
    return name in PIPELINES or name in UNPORTED_PIPELINES


register_pipeline("cr", ("hf", "rre4", "tcms8", "rze1"))
register_pipeline("hf", ("hf",))
register_pipeline("none", ())
register_pipeline("lvl", ("rre4", "hf", "rze1"))


def _resolve(pipeline) -> tuple:
    return get_pipeline(pipeline) if isinstance(pipeline, str) else tuple(pipeline)


def encode(data, pipeline: str | tuple) -> bytes:
    """Encode a uint8 stream: a numpy array runs the host stages, a torch
    tensor the stages' twins on its device."""
    stages = _resolve(pipeline)
    device = isinstance(data, torch.Tensor)
    cur = data.reshape(-1).to(torch.uint8) if device else np.ascontiguousarray(data, np.uint8).reshape(-1)
    recs = []
    for name in stages:
        st = get_stage(name)
        if device and st.encode_device is None:
            raise ValueError(f"stage {name!r} has no device twin; pass a numpy array to encode on the host")
        with span(f"{name}.encode"):
            if device:
                nxt, hdr = st.encode_device(cur)
                size = int(nxt.numel())
            else:
                payload, hdr = st.encode(cur)
                nxt = np.frombuffer(payload, np.uint8) if isinstance(payload, bytes) else payload
                size = nxt.size
        hb = st.pack_header(hdr)
        cur_size = int(cur.numel()) if device else cur.size
        if size + len(hb) >= cur_size and cur_size > 0:
            recs.append((name, 1, b""))  # stage expands: store-through
            continue
        recs.append((name, 0, hb))
        cur = nxt
    out = bytearray(_MAGIC)
    out += struct.pack("<B", len(recs))
    for name, flags, hb in recs:
        nb = name.encode()
        out += struct.pack("<BB", flags, len(nb)) + nb + struct.pack("<I", len(hb)) + hb
    out += cur.cpu().numpy().tobytes() if device else cur.tobytes()
    return bytes(out)


def _upload(buf, device) -> torch.Tensor:
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf.reshape(-1)
    return torch.from_numpy(arr.copy()).to(device)


def decode(buf, *, device=None, tel: dict | None = None):
    """Decode a pipeline stream back to the uint8 code stream.

    ``device=None`` runs the host stages and returns a numpy array; a torch
    device uploads the payload once and runs the stages' twins there,
    returning a uint8 tensor. ``tel`` receives the routes the twins record.
    """
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if mv[:4] == _MAGIC:
        nstages = mv[4]
        off = 5
        recs = []
        for _ in range(nstages):
            flags, nlen = struct.unpack_from("<BB", mv, off)
            off += 2
            name = bytes(mv[off : off + nlen]).decode()
            off += nlen
            (hlen,) = struct.unpack_from("<I", mv, off)
            off += 4
            if not flags & 1:  # store-through records carry no header
                recs.append((name, get_stage(name).unpack_header(bytes(mv[off : off + hlen]))))
            off += hlen
    else:
        # pre-LLP2 stream: u32 length-prefixed JSON meta with dict headers
        mlen = int.from_bytes(mv[:4], "little")
        meta = json.loads(bytes(mv[4 : 4 + mlen]))
        off = 4 + mlen
        recs = [(name, hdr) for name, hdr in zip(meta["stages"], meta["headers"]) if not hdr.get("_skip")]
    cur = mv[off:]
    if device is not None:
        cur = _upload(cur, device)
        for name, hdr in reversed(recs):
            st = get_stage(name)
            if st.decode_device is None:
                raise ValueError(f"stage {name!r} has no device twin; decode with device=None")
            with span(f"{name}.decode"):
                cur = st.decode_device(cur, hdr, tel)
        return cur
    for name, hdr in reversed(recs):
        out = get_stage(name).decode(cur, hdr)
        cur = out.tobytes() if isinstance(out, np.ndarray) else out
    return np.frombuffer(cur, np.uint8)
