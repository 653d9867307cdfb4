"""Composable lossless pipelines over the stage registry (paper §5.2, Fig. 7).

A pipeline is a named sequence of registered stages: CR mode
``hf -> rre4 -> tcms8 -> rze1``, ``crz`` (CR with a ``zstd`` tail), TP
mode ``tcms1 -> bit1 -> rre1``, the baselines' ``fz`` (``bit1 -> rre1``)
and ``fzh`` (``bit1 -> rre1 -> hf``), ``hf`` alone, ``lvl`` and ``none``.

Device path: when ``encode`` receives a torch tensor, every stage runs its
torch twin on the tensor's device (repro_torch.core.lossless.engine) and
the stream chains between stages as a tensor; the bytes land on the host
once, in the packed stream. A stage without a twin (``zstd``) takes the
stream to the host for the rest of the pipeline, as in the JAX package;
that hop is the format's, recorded in the caller's telemetry under
``host_stages``. ``decode(buf, device=...)`` is the symmetric read path:
host stages decode first on the host, and the stream goes up to the device
once, for the first stage with a twin. Either path gives the host path's
bytes. Besides each stage's ``<stage>.encode`` / ``<stage>.decode`` span,
the framing has its own: ``lossless.pack`` (the stage records, the stream's
download and the bytes), ``lossless.parse`` (the records and each stage's
header) and ``lossless.upload`` (the stream's host copy and its upload).

Stream format (LLP2, shared with the JAX package): ``b"LLP2"``, a stage
count, then one record per stage — flags byte (bit0 = store-through for a
stage that would have expanded the stream), name, binary-packed header —
then the final payload. A stage whose payload plus header is no smaller
than its input is stored through; bit1 and tcms1 never shrink a stream,
so in tp, fz and fzh they run on encode and are always stored through, and
no decode runs them. Streams older than LLP2 (a u32 length-prefixed
JSON meta block) are detected by the missing magic and decode through the
same registry.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch
from torch.profiler import record_function as span

from .stages import get_stage

_MAGIC = b"LLP2"

PIPELINES: dict[str, tuple] = {}  # name -> stage-name tuple (live registry)


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
    try:
        return PIPELINES[name]
    except KeyError:
        raise ValueError(f"unknown pipeline {name!r}; "
                         f"registered pipelines: {', '.join(sorted(PIPELINES))} (or 'auto')") from None


register_pipeline("cr", ("hf", "rre4", "tcms8", "rze1"))
register_pipeline("tp", ("tcms1", "bit1", "rre1"))
register_pipeline("hf", ("hf",))
register_pipeline("none", ())
register_pipeline("fz", ("bit1", "rre1"))
register_pipeline("crz", ("hf", "rre4", "tcms8", "rze1", "zstd"))
register_pipeline("fzh", ("bit1", "rre1", "hf"))
register_pipeline("lvl", ("rre4", "hf", "rze1"))


def _resolve(pipeline) -> tuple:
    return get_pipeline(pipeline) if isinstance(pipeline, str) else tuple(pipeline)


def _host_stage(tel: dict | None, record: str) -> None:
    if tel is not None and record not in tel.setdefault("host_stages", []):
        tel["host_stages"].append(record)


def encode(data, pipeline: str | tuple, *, tel: dict | None = None) -> bytes:
    """Encode a uint8 stream: a numpy array runs the host stages, a torch
    tensor the stages' twins on its device up to the first stage without
    one, which takes the stream to the host (recorded in ``tel``)."""
    stages = _resolve(pipeline)
    device = isinstance(data, torch.Tensor)
    cur = data.reshape(-1).to(torch.uint8) if device else np.ascontiguousarray(data, np.uint8).reshape(-1)
    recs = []
    for name in stages:
        st = get_stage(name)
        if device and st.encode_device is None:  # the stream drops to the host for good
            cur, device = cur.cpu().numpy(), False
            _host_stage(tel, f"{name}.encode")
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
    with span("lossless.pack"):
        out = bytearray(_MAGIC)
        out += struct.pack("<B", len(recs))
        for name, flags, hb in recs:
            nb = name.encode()
            out += struct.pack("<BB", flags, len(nb)) + nb + struct.pack("<I", len(hb)) + hb
        out += cur.cpu().numpy().tobytes() if device else cur.tobytes()
        return bytes(out)


def _upload(buf, device) -> torch.Tensor:
    with span("lossless.upload"):
        arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf.reshape(-1)
        return torch.from_numpy(arr.copy()).to(device)


def _host_bytes(cur):
    return cur.cpu().numpy().tobytes() if isinstance(cur, torch.Tensor) else cur


def decode(buf, *, device=None, tel: dict | None = None):
    """Decode a pipeline stream back to the uint8 code stream.

    ``device=None`` runs the host stages and returns a numpy array; a torch
    device runs the stages' twins there and returns a uint8 tensor: the
    stream goes up once, before the first stage with a twin, and a stage
    without one decodes on the host (recorded in ``tel``, which also
    receives the routes the twins record).
    """
    with span("lossless.parse"):
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
    for name, hdr in reversed(recs):
        st = get_stage(name)
        if device is not None and st.decode_device is not None:
            if not isinstance(cur, torch.Tensor):
                cur = _upload(cur, device)
            with span(f"{name}.decode"):
                cur = st.decode_device(cur, hdr, tel)
            continue
        if device is not None:
            _host_stage(tel, f"{name}.decode")
        out = st.decode(_host_bytes(cur), hdr)
        cur = out.tobytes() if isinstance(out, np.ndarray) else out
    if device is not None:
        return cur if isinstance(cur, torch.Tensor) else _upload(cur, device)
    return np.frombuffer(cur, np.uint8)


def encode_v1(data, pipeline: str | tuple) -> bytes:
    """The pre-LLP2 stream writer (the JAX package's, byte for byte): a u32
    length-prefixed JSON meta block with dict headers, host stages only.
    Kept to fabricate old streams. Binary header fields (hf's ``offs``
    table) cannot ride JSON and are left out, so such streams decode on
    the host."""
    stages = _resolve(pipeline)
    cur = np.ascontiguousarray(data, np.uint8).reshape(-1)
    headers = []
    for name in stages:
        payload, hdr = get_stage(name).encode(cur)
        hdr = {k: v for k, v in hdr.items() if not isinstance(v, (bytes, bytearray))}
        nxt = np.frombuffer(payload, np.uint8) if isinstance(payload, bytes) else payload
        if nxt.size + len(json.dumps(hdr)) >= cur.size and cur.size > 0:
            headers.append({"_skip": True})  # stage expands: store-through
            continue
        headers.append(hdr)
        cur = nxt
    meta = json.dumps({"stages": list(stages), "headers": headers}).encode()
    return len(meta).to_bytes(4, "little") + meta + cur.tobytes()
