"""cuSZ-Hi top-level compressor (the paper's full pipeline, §4-§5), PyTorch.

compress():  pad -> spline autotune -> interpolation predict+quantize over
17^ndim blocks (the interp encode CUDA kernel on the card) -> scatter codes
-> level reorder (Eq. 3) -> lossless pipeline (torch twins on the card) ->
container with anchors and outliers -> verify. decompress() replays the
same arithmetic from the codes (the interp decode CUDA kernel on the card).
``predictor="lorenzo"`` (the cuSZ-L and FZ-GPU baselines) replaces the
interp steps with the Lorenzo encode (the lorenzo3d CUDA kernel on the
card) and decodes by prefix sums.

The bytes are the JAX package's (``repro.core.compressor``): container v2
(``CSZH2\\n``, binary header, section table) is written, v1 (``CSZH1\\n``,
JSON header, by ``_sections_pack_v1``) too, and v1, v2 and v3 (``CSZH3\\n``,
chunked frames of v1/v2 containers, repro_torch.core.frames) are read; the
LLP2 stream framing and the spec-string grammar are the same, so a container
written by either package decodes in the other and
``CompressorSpec.from_string(s).to_string()`` agrees.

Device: ``Compressor(device=None)`` runs on ``"cuda"`` and raises when
CUDA is absent; ``device="cpu"`` runs the plain torch predictor and the
host lossless stages. On the card nothing falls back: a kernel that fails
to build or launch raises, and ``last_telemetry["fallbacks"]`` stays empty.
The one host route there is chosen by the format, not by an error: an hf
stream without per-chunk offsets (containers written before the offset
table existed) decodes on the host, recorded as
``last_telemetry["hf_decode"] == "host-legacy"``. Salvage of damaged bytes
(``decompress(on_error="skip"|"fill")``) drops or fills what does not
decode, as the JAX package does, but a kernel or device error
(:data:`DEVICE_ERRORS`) always propagates.

One Compressor may serve many threads at once: the per-call records
(``last_telemetry``, ``last_damage``, ``last_plan`` and the hold flag that
lets a nested call add to its caller's telemetry) live in a
``threading.local``, as in the JAX package.

Ported: ``predictor`` interp, auto (the per-level planner,
repro_torch.core.autotune.autotune_plan), lorenzo and offset1d;
``eb_mode`` rel, abs and pw_rel; ``psnr_target``; every registered
pipeline and ``pipeline="auto"`` (the orchestrator,
repro_torch.core.lossless.orchestrate); NaN/Inf ingest (the nfsafe and
nonfinite containers); an optional shared plan cache
(repro_torch.core.plancache); ``verify`` off/sample/full; every preset of
the JAX package; containers v1 and v2 written (v3 by
repro_torch.core.distributed), v1, v2 and v3 read, with v3's partial decode
(``frames=``) and salvage.

Tracing: each stage runs inside a ``torch.profiler.record_function``
span (``compress.blocks``, ``compress.plan_cache`` (the key and the
lookup), ``compress.autotune`` or ``compress.plan`` (the planner),
``compress.predict`` (also the Lorenzo and offset1d encodes),
``compress.scatter_reorder``, ``compress.orchestrate`` (the pipeline
choice: sample, stats and trial encodes), ``<stage>.encode``,
``compress.verify``, ``<stage>.decode``, ``decompress.blocks``,
``decompress.predict`` (also the Lorenzo and offset1d decodes),
``decompress.scatter``, and for v3 ``decompress.frames``: the frame table
and the CRC checks); a span records only while a profiler is active.

Error-bound contract: ||x - decompress(compress(x))||_inf <= eb_abs, with
eb_abs = eb * value_range(x) in the paper's default "rel" mode.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import threading
import time
import zlib

import numpy as np
import torch
from torch.profiler import record_function as span

from ..kernels import interp3d as _interp
from ..kernels import lorenzo3d as _lor
from ..kernels.build import KernelError
from . import blocks as blk
from . import frames as frames_mod
from . import lorenzo as lor
from .autotune import (DEFAULT_STRIDES, PredictorPlan, autotune, autotune_plan, levels_for_stride, plan_signature,
                       stats_bucket)
from .errors import BoundViolationError, ContainerError, DamageReport, FrameCRCError, SpecError
from .lossless import orchestrate, pipelines
from .lossless.engine import _packbits, _unpackbits
from .lossless.flenc import fl_decode, fl_encode
from .reorder import reorder_codes_batch, reorder_codes_batch_t, restore_codes_batch, restore_codes_batch_t
from .serial import pack_obj, unpack_obj
from .stencils import SPLINES, build_steps

MAGIC_V1 = b"CSZH1\n"
MAGIC = b"CSZH2\n"
MAGIC_V3 = frames_mod.MAGIC_V3

# Errors of the card or of a kernel launch: salvage (on_error="skip"/"fill")
# drops or fills damaged chunks, never these; they always propagate.
DEVICE_ERRORS = (KernelError, torch.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())

_PREDICTORS = ("interp", "auto", "lorenzo", "offset1d")
_BACKENDS = ("jax", "pallas")  # both mean the CUDA kernels on the card, the plain version on CPU
_ENGINES = ("auto", "numpy", "device")
_EB_MODES = ("rel", "abs", "pw_rel")
_VERIFY_MODES = ("off", "sample", "full")
_ANCHOR_STRIDES = (4, 8, 16)

# Bound verification: "sample" checks at most this many points (a
# deterministic stride sample over the flat field); a violation re-encodes
# at a halved bound up to _REPAIR_ATTEMPTS times, then raises.
_VERIFY_SAMPLE = 1 << 16
_REPAIR_ATTEMPTS = 3
_REPAIR_TIGHTEN = 0.5
# f32 reconstruction rounds, so a clean encode can land at eb * (1 + few ulp);
# a wrong code is >= 2eb off and clears this slack by orders of magnitude.
_VERIFY_SLACK = 1e-4

# ---------------------------------------------------------------- spec grammar
#     "lossy" "," <eb_mode> "," <number> { "," key "=" value }
#     "lossy" "," "psnr"    "," <target_dB> { "," key "=" value }
# Tuple-valued keys join their items with ":", booleans are "true"/"false";
# to_string() emits the head plus the sorted non-default key=value pairs.
_SPEC_TUPLE_FIELDS = {"splines", "schemes", "pipeline_candidates", "plan_anchor_strides"}
_SPEC_BOOL_FIELDS = {"autotune", "reorder"}


def _spec_parse_value(key: str, raw: str):
    if key in _SPEC_BOOL_FIELDS:
        low = raw.strip().lower()
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off"):
            return False
        raise SpecError(f"spec key {key!r} expects a boolean, got {raw!r}")
    if key in _SPEC_TUPLE_FIELDS:
        items = tuple(t.strip() for t in raw.split(":") if t.strip())
        if not items:
            raise SpecError(f"spec key {key!r} expects ':'-joined items, got {raw!r}")
        if key == "plan_anchor_strides":
            try:
                return tuple(int(t) for t in items)
            except ValueError as e:
                raise SpecError(f"spec key {key!r} expects integers, got {raw!r}") from e
        return items
    if key == "anchor_stride":
        try:
            return int(raw)
        except ValueError as e:
            raise SpecError(f"spec key {key!r} expects an integer, got {raw!r}") from e
    if key in ("eb", "psnr_target"):
        try:
            return float(raw)
        except ValueError as e:
            raise SpecError(f"spec key {key!r} expects a number, got {raw!r}") from e
    return raw.strip()


def _spec_format_value(key: str, value) -> str:
    if key in _SPEC_BOOL_FIELDS:
        return "true" if value else "false"
    if key in _SPEC_TUPLE_FIELDS:
        return ":".join(str(v) for v in value)
    if isinstance(value, float):
        return repr(value)  # shortest round-tripping float repr
    return str(value)


@dataclasses.dataclass(frozen=True)
class CompressorSpec:
    eb: float = 1e-3
    eb_mode: str = "rel"                  # "rel": eb * value range (paper); "abs"
    predictor: str = "interp"             # interp | auto | lorenzo | offset1d
    pipeline: str = "cr"                  # a registered pipeline, or "auto"
    anchor_stride: int = 16               # 16 = cuSZ-Hi; 8 = cuSZ-I layout
    autotune: bool = True
    splines: tuple = ("cubic", "cubic", "cubic", "cubic")
    schemes: tuple = ("md", "md", "md", "md")
    reorder: bool = True
    backend: str = "jax"                  # jax | pallas: the CUDA kernels on the card either way
    engine: str = "auto"                  # lossless engine: auto (device on the card) | numpy | device
    pipeline_candidates: tuple | None = None
    plan_anchor_strides: tuple = DEFAULT_STRIDES
    psnr_target: float | None = None
    verify: str = "sample"

    def __post_init__(self):
        if self.verify not in _VERIFY_MODES:
            raise ValueError(f"unknown verify mode {self.verify!r}; one of {_VERIFY_MODES}")
        if self.pipeline != "auto" and self.pipeline not in pipelines.PIPELINES:
            raise ValueError(f"unknown pipeline {self.pipeline!r}; registered pipelines: "
                             f"{', '.join(sorted(pipelines.PIPELINES))} (or 'auto')")
        if self.pipeline_candidates is not None and not self.pipeline_candidates:
            raise ValueError("pipeline_candidates must be None or a non-empty sequence of pipeline names")
        for nm in self.pipeline_candidates or ():
            if nm not in pipelines.PIPELINES:
                raise ValueError(f"unknown pipeline {nm!r} in pipeline_candidates")
        if self.predictor not in _PREDICTORS:
            raise ValueError(f"unknown predictor {self.predictor!r}; one of {_PREDICTORS}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {_BACKENDS}")
        if self.engine not in _ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; one of {_ENGINES}")
        if self.eb_mode not in _EB_MODES:
            raise ValueError(f"unknown eb_mode {self.eb_mode!r}; one of {_EB_MODES}")
        for st in (self.anchor_stride,) + tuple(self.plan_anchor_strides):
            if st not in _ANCHOR_STRIDES:
                raise ValueError(f"unsupported anchor stride {st}; one of {_ANCHOR_STRIDES}")
        for s in self.splines:
            if s not in SPLINES:
                raise ValueError(f"unknown spline {s!r}; one of {SPLINES}")
        for s in self.schemes:
            if s != "md" and s != "1d" and not s.startswith("1d-"):
                raise ValueError(f"unknown scheme {s!r}; 'md', '1d', or '1d-<perm>'")
        if self.eb_mode == "pw_rel" and not (self.eb > 0):
            raise ValueError(f"eb_mode='pw_rel' needs eb > 0, got {self.eb}")
        if self.psnr_target is not None:
            if not (float(self.psnr_target) > 0) or not np.isfinite(self.psnr_target):
                raise ValueError(f"psnr_target must be a positive finite dB value, got {self.psnr_target}")
            if self.eb_mode == "pw_rel":
                raise ValueError("psnr_target is incompatible with eb_mode='pw_rel' "
                                 "(the eb search runs in the abs-bound domain)")

    @property
    def levels(self) -> tuple:
        return levels_for_stride(self.anchor_stride)

    @classmethod
    def from_string(cls, spec: str) -> "CompressorSpec":
        """Parse ``"lossy,<eb_mode>,<eb>[,key=value...]"`` or
        ``"lossy,psnr,<target>[,key=value...]"``; raises :class:`SpecError`."""
        parts = [p.strip() for p in str(spec).split(",")]
        if not parts or not parts[0]:
            raise SpecError("empty compression spec")
        if parts[0] == "lossless":
            raise SpecError(
                "'lossless' is a dataset-level spec (raw chunk storage, see repro.io); "
                "CompressorSpec is error-bounded — use 'lossy,<mode>,<eb>'")
        if parts[0] != "lossy":
            raise SpecError(f"compression spec must start with 'lossy', got {parts[0]!r} (full spec: {spec!r})")
        if len(parts) < 3:
            raise SpecError(f"lossy spec needs 'lossy,<mode>,<value>', got {spec!r}")
        mode = parts[1]
        kw: dict = {}
        if mode == "psnr":
            kw["psnr_target"] = _spec_parse_value("psnr_target", parts[2])
        elif mode in _EB_MODES:
            kw["eb_mode"] = mode
            kw["eb"] = _spec_parse_value("eb", parts[2])
        else:
            raise SpecError(f"unknown error-bound mode {mode!r}; one of {', '.join(_EB_MODES)} or 'psnr'")
        allowed = {f.name for f in dataclasses.fields(cls)}
        for tok in parts[3:]:
            if "=" not in tok:
                raise SpecError(f"expected key=value, got {tok!r} (full spec: {spec!r})")
            key, _, raw = tok.partition("=")
            key = key.strip()
            if key not in allowed:
                raise SpecError(f"unknown spec key {key!r}; allowed: {', '.join(sorted(allowed))}")
            if key in kw:
                raise SpecError(f"duplicate spec key {key!r} in {spec!r}")
            kw[key] = _spec_parse_value(key, raw)
        try:
            return cls(**kw)
        except SpecError:
            raise
        except (ValueError, TypeError) as e:
            raise SpecError(f"invalid compression spec {spec!r}: {e}") from e

    def to_string(self) -> str:
        """Canonical spec string: ``from_string(spec.to_string()) == spec``."""
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        if (self.psnr_target is not None and self.eb == defaults["eb"]
                and self.eb_mode == defaults["eb_mode"]):
            head = f"lossy,psnr,{_spec_format_value('psnr_target', self.psnr_target)}"
            skip = {"eb", "eb_mode", "psnr_target"}
        else:
            head = f"lossy,{self.eb_mode},{_spec_format_value('eb', self.eb)}"
            skip = {"eb", "eb_mode"}
        pairs = []
        for name in sorted(defaults):
            if name in skip:
                continue
            value = getattr(self, name)
            if value == defaults[name] or value is None:
                continue
            pairs.append(f"{name}={_spec_format_value(name, value)}")
        return ",".join([head] + pairs)


def _sections_pack(header: dict, sections: list[bytes]) -> bytes:
    """Container v2: binary header + u32/u64 section table."""
    hb = pack_obj(header)
    out = bytearray(MAGIC)
    out += struct.pack("<I", len(hb))
    out += hb
    out += struct.pack("<I", len(sections))
    for s in sections:
        out += struct.pack("<Q", len(s))
    for s in sections:
        out += s
    return bytes(out)


def _sections_pack_v1(header: dict, sections: list[bytes]) -> bytes:
    """Container v1 (JSON header, sizes inline), the JAX package's legacy
    writer, kept to fabricate old containers."""
    header = dict(header, _sizes=[len(s) for s in sections])
    hj = json.dumps(header).encode()
    return MAGIC_V1 + len(hj).to_bytes(8, "little") + hj + b"".join(sections)


def _sections_unpack(buf: bytes):
    """(header, sections) of a v2 or v1 container."""
    if buf[: len(MAGIC)] == MAGIC:
        off = len(MAGIC)
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = unpack_obj(buf[off : off + hlen])
        off += hlen
        (nsec,) = struct.unpack_from("<I", buf, off)
        off += 4
        sizes = struct.unpack_from(f"<{nsec}Q", buf, off)
        off += 8 * nsec
        sections = []
        for sz in sizes:
            sections.append(buf[off : off + sz])
            off += sz
        return header, sections
    if buf[: len(MAGIC_V1)] == MAGIC_V1:
        off = len(MAGIC_V1)
        hlen = int.from_bytes(buf[off : off + 8], "little")
        off += 8
        header = json.loads(bytes(buf[off : off + hlen]))
        off += hlen
        sections = []
        for sz in header["_sizes"]:
            sections.append(buf[off : off + sz])
            off += sz
        return header, sections
    raise ContainerError(f"bad container magic {bytes(buf[:6])!r}; expected {MAGIC!r} or {MAGIC_V1!r}")


def _spatial_view(x: torch.Tensor):
    """Fold >3-D tensors into (batch, spatial<=3)."""
    nd = min(x.dim(), 3)
    spatial = tuple(int(s) for s in x.shape[x.dim() - nd :])
    batch = int(np.prod(x.shape[: x.dim() - nd], dtype=np.int64)) if x.dim() > nd else 1
    return x.reshape((batch,) + spatial), spatial


def _median_f32(v: torch.Tensor) -> float:
    """``np.median`` of a float32 vector: the middle value, or for an even
    count the float32 mean of the two middle values (``torch.median`` would
    give the lower one)."""
    s = torch.sort(v).values
    n = int(s.numel())
    if n % 2:
        return float(s[n // 2])
    return float((s[n // 2 - 1] + s[n // 2]) / 2)


class _PerCallState(threading.local):
    """Per-thread records of a (possibly shared) Compressor: telemetry,
    damage report, winning plan and the hold flag, so that concurrent
    calls never see each other's state. ``last_*`` and ``_telemetry_hold``
    are views over it."""

    telemetry = None
    damage = None
    plan = None
    hold = False


class Compressor:
    def __init__(self, spec: CompressorSpec | None = None, *, device=None, plan_cache=None, **kw):
        self.spec = spec or CompressorSpec(**kw)
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; Compressor runs on the card unless given device='cpu'")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"Compressor runs on 'cuda' or 'cpu', got {dev}")
        self.device = dev
        # optional repro_torch.core.plancache.PlanCache, shareable across
        # compressors: a recurring field signature replays its tuning outcome
        self.plan_cache = plan_cache
        # per-thread call records (_PerCallState):
        #   last_plan: the winning PredictorPlan of this thread's last
        #     predictor="auto" compress();
        #   last_telemetry: reset by compress() and decompress() unless held:
        #     backend, engine, device, fallbacks (always empty: nothing falls
        #     back), pipeline, verify, plan_cache ("hit"/"miss"), nonfinite,
        #     psnr_search, decode timing, and the routes the stream format
        #     chose (hf_decode, host_stages);
        #   last_damage: reset by decompress(); under on_error="skip"/"fill"
        #     the DamageReport and per-chunk intact mask of a salvaged
        #     container (None when intact);
        #   _telemetry_hold: a nested call (verify's decode, a v3 frame, a
        #     chunk of chunk_compress) adds to its caller's telemetry.
        self._call = _PerCallState()

    @property
    def last_plan(self):
        return self._call.plan

    @last_plan.setter
    def last_plan(self, value):
        self._call.plan = value

    @property
    def last_telemetry(self):
        return self._call.telemetry

    @last_telemetry.setter
    def last_telemetry(self, value):
        self._call.telemetry = value

    @property
    def last_damage(self):
        return self._call.damage

    @last_damage.setter
    def last_damage(self, value):
        self._call.damage = value

    @property
    def _telemetry_hold(self):
        return self._call.hold

    @_telemetry_hold.setter
    def _telemetry_hold(self, value):
        self._call.hold = bool(value)

    @property
    def _device_engine(self) -> bool:
        return self.spec.engine == "device" or (self.spec.engine == "auto" and self.device.type == "cuda")

    def _telemetry(self) -> dict:
        if self.last_telemetry is None:
            self.last_telemetry = {"backend": self.spec.backend, "engine": self.spec.engine,
                                   "device": str(self.device), "fallbacks": []}
        return self.last_telemetry

    def _record_fallback(self, point: str, src: str, dst: str, err: Exception) -> None:
        """The JAX package's fallback record. No path of the port calls it
        to carry on past a failure: a failing kernel or device raises."""
        self._telemetry()["fallbacks"].append({"point": point, "from": src, "to": dst, "error": repr(err)})

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _abs_eb(self, x: torch.Tensor) -> float:
        if self.spec.eb_mode == "abs":
            return float(self.spec.eb)
        # range in f64: a float32 max-min of an extreme-range field overflows
        rng = (float(x.max()) - float(x.min())) if x.numel() else 0.0
        return float(self.spec.eb) * rng

    def _bitmap(self, raw: bytes, count: int) -> torch.Tensor:
        return _unpackbits(torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(self.device), count)

    # -------------------------------------------------------------- compress
    def compress(self, x) -> bytes:
        """Compress ``x`` (numpy array or tensor) to a v2 container under the
        spec's bound; ``x`` moves to the compressor's device first. NaN and
        +-Inf points are taken out first and restored bit for bit on decode
        (the nfsafe container); a finite field pays one ``isfinite`` scan.
        A held call (a chunk of ``chunk_compress``) adds to the telemetry of
        the call that holds it."""
        if not self._telemetry_hold:
            self.last_telemetry = None
        self._telemetry()
        xt = torch.as_tensor(x).to(device=self.device, dtype=torch.float32).contiguous()
        fin = torch.isfinite(xt)
        if xt.numel() and not bool(fin.all()):
            return self._compress_nonfinite(xt, fin)
        return self._compress_finite(xt)

    def _compress_finite(self, x: torch.Tensor) -> bytes:
        sp = self.spec
        if sp.eb_mode == "pw_rel":
            return self._verify_repair(x, self._compress_pw_rel(x), bound=float(sp.eb), rel=True)
        psnr_hdr = {}
        if sp.psnr_target is not None:
            eb_abs = self._psnr_target_eb(x)
            psnr_hdr["psnr_target"] = float(sp.psnr_target)
        else:
            eb_abs = self._abs_eb(x)
        base_hdr = {"shape": list(x.shape), "predictor": sp.predictor, "eb_abs": eb_abs,
                    "anchor_stride": sp.anchor_stride, **psnr_hdr}
        if eb_abs == 0.0:  # constant (or empty) field: store the value verbatim
            v = np.float32(x.reshape(-1)[0].item() if x.numel() else 0)
            buf = _sections_pack(dict(base_hdr, mode="const"), [v.tobytes()])
        elif sp.predictor == "lorenzo":
            buf = self._compress_lorenzo(x, eb_abs, base_hdr)
        elif sp.predictor == "offset1d":
            buf = self._compress_offset1d(x, eb_abs, base_hdr)
        else:
            buf = self._compress_interp(x, eb_abs, base_hdr)
        return self._verify_repair(x, buf, bound=eb_abs, rel=False)

    # ---------------------------------------------------- non-finite ingest
    def _compress_nonfinite(self, x: torch.Tensor, fin: torch.Tensor) -> bytes:
        """The nfsafe wrapper: the NaN/+-Inf points as a bitmap and their
        exact bit patterns (zlib), and the field with those points set to the
        median of the finite ones as a complete inner container. A field
        with no finite point is a nonfinite container of the patterns only."""
        mask = ~fin.reshape(-1)
        flat = x.reshape(-1)
        n_bad = int(mask.sum())
        pats = flat.view(torch.int32)[mask].cpu().numpy().view(np.uint32)
        self._telemetry()["nonfinite"] = {"n": n_bad, "total": int(x.numel())}
        if n_bad == x.numel():
            header = {"shape": list(x.shape), "mode": "nonfinite", "n_nonfinite": n_bad}
            return _sections_pack(header, [zlib.compress(pats.tobytes(), 6)])
        fill = _median_f32(flat[~mask])
        xf = torch.where(mask, torch.tensor(np.float32(fill), device=x.device), flat).reshape(x.shape)
        ibuf = self._compress_finite(xf)
        header = {"shape": list(x.shape), "mode": "nfsafe", "n_nonfinite": n_bad, "fill": fill}
        return _sections_pack(header, [ibuf, _packbits(mask).cpu().numpy().tobytes(),
                                       zlib.compress(pats.tobytes(), 6)])

    def _decompress_nonfinite(self, sections, shape) -> torch.Tensor:
        pats = np.frombuffer(zlib.decompress(sections[0]), np.int32).copy()
        return torch.from_numpy(pats).to(self.device).view(torch.float32).reshape(shape)

    def _decompress_nfsafe(self, sections, shape, tel: dict) -> torch.Tensor:
        ihdr, isec = _sections_unpack(sections[0])
        y = self._decompress_sections(ihdr, isec, tel).reshape(-1).to(torch.float32).clone()
        mask = self._bitmap(sections[1], int(y.numel()))
        pats = np.frombuffer(zlib.decompress(sections[2]), np.int32).copy()
        y.view(torch.int32)[mask] = torch.from_numpy(pats).to(self.device)  # NaN payloads included
        return y.reshape(shape)

    # ------------------------------------------------------------- pw_rel
    def _compress_pw_rel(self, x: torch.Tensor) -> bytes:
        """Point-wise relative bound (SZ3's ``pw_rel``) in the log domain:
        ``y = ln|x|`` is compressed under an absolute bound below
        ``log1p(eb)``, with a margin for the float32 storage of ``y`` and the
        rounding of ``exp(y')`` to float32; signs and exact zeros ride
        bitmaps. The log is taken in float64 on the field's device."""
        sp = self.spec
        eb = float(sp.eb)
        flat = x.reshape(-1)
        zero = flat == 0.0
        nz = ~zero
        sign = torch.signbit(flat)  # over all points: -0.0 rides the zero bitmap and keeps its sign
        mag = flat[nz].to(torch.float64).abs()
        y64 = torch.log(mag)
        y32 = y64.to(torch.float32)
        cast = (y64 - y32.to(torch.float64)).abs()
        cast_err = float(cast.max()) if y32.numel() else 0.0
        slack = 1.2e-7  # f64 -> f32 rounding of exp(y') on the way back out
        eb_log = (float(np.log1p(eb)) - cast_err - slack) * (1.0 - 2e-4)
        if eb_log <= 0:
            worst = float(mag[torch.argmax(cast)])
            raise ValueError(f"eb={eb:g} is below the float32 pw_rel transform's resolution at |x|={worst:.6g} "
                             f"(log-domain cast error {cast_err:.3g} eats the whole log1p(eb) budget); "
                             "use a larger bound or eb_mode='abs'")
        fill = float(y32.min()) if y32.numel() else 0.0  # zero slots: inert filler
        y = torch.full_like(flat, fill)
        y[nz] = y32
        inner = Compressor(dataclasses.replace(sp, eb_mode="abs", eb=eb_log, verify="off"),
                           device=self.device, plan_cache=self.plan_cache)
        ibuf = inner.compress(y.reshape(x.shape))
        itel = inner.last_telemetry or {}
        tel = self._telemetry()
        for k in ("pipeline", "plan_cache"):
            if k in itel:
                tel[k] = itel[k]
        self.last_plan = inner.last_plan
        header = {"shape": list(x.shape), "mode": "pw_rel", "predictor": sp.predictor, "eb_rel": eb,
                  "eb_abs": float(eb_log), "n_zero": int(zero.sum())}
        return _sections_pack(header, [ibuf, _packbits(sign).cpu().numpy().tobytes(),
                                       _packbits(zero).cpu().numpy().tobytes()])

    def _decompress_pw_rel(self, sections, shape, tel: dict) -> torch.Tensor:
        ihdr, isec = _sections_unpack(sections[0])
        y = self._decompress_sections(ihdr, isec, tel).reshape(-1)
        sign = self._bitmap(sections[1], int(y.numel()))
        zero = self._bitmap(sections[2], int(y.numel()))
        out = torch.exp(y.to(torch.float64))
        out[zero] = 0.0  # zero first, negate second: a signed zero slot decodes to -0.0
        out[sign] = -out[sign]
        return out.to(torch.float32).reshape(shape)

    # -------------------------------------------------------- psnr target
    @staticmethod
    def _psnr_trial_field(x: torch.Tensor) -> torch.Tensor:
        """The field itself when small, else a centred crop of at most 64 per axis."""
        if x.numel() <= (1 << 20):
            return x
        return x[tuple(slice(None) if d <= 64 else slice(d // 2 - 32, d // 2 + 32) for d in x.shape)].contiguous()

    def _psnr_target_eb(self, x: torch.Tensor) -> float:
        """Bisect (in log space) the absolute eb whose reconstruction of the
        trial field lands 0.5 dB above ``spec.psnr_target`` (range-normalized
        MSE), each trial a compress + decompress of the port's own
        Compressor on this device with the cheap fixed configuration."""
        sp = self.spec
        target = float(sp.psnr_target)
        rng = (float(x.max()) - float(x.min())) if x.numel() else 0.0
        if rng == 0.0:
            return 0.0  # constant field: the const container, PSNR inf
        trial = self._psnr_trial_field(x)
        tspec = dataclasses.replace(sp, psnr_target=None, eb_mode="abs", eb=1.0,
                                    predictor="interp" if sp.predictor == "auto" else sp.predictor,
                                    pipeline="none", pipeline_candidates=None, autotune=False, verify="off")
        mse_aim = rng * rng * 10.0 ** (-(target + 0.5) / 10.0)
        trials = 0

        def mse_at(eb_abs: float) -> float:
            nonlocal trials
            trials += 1
            comp = Compressor(dataclasses.replace(tspec, eb=float(eb_abs)), device=self.device)
            d = trial.to(torch.float64) - comp.decompress(comp.compress(trial), out="device").to(torch.float64)
            return float((d * d).mean())

        eb0 = min(float(np.sqrt(3.0 * mse_aim)), 0.25 * rng)  # uniform quantization: mse ~ eb^2 / 3
        lo = hi = eb0
        if mse_at(eb0) <= mse_aim:  # feasible: push eb up until it breaks
            grown = False
            for _ in range(8):
                hi = lo * 4.0
                if mse_at(hi) > mse_aim:
                    grown = True
                    break
                lo = hi
            if not grown:
                hi = lo
        else:  # infeasible at the model guess: tighten until it holds
            for _ in range(12):
                lo = lo / 4.0
                if mse_at(lo) <= mse_aim:
                    break
            else:
                raise ValueError(f"psnr_target={target:g} dB unreachable: trial mse {mse_at(lo):.3g} > "
                                 f"target {mse_aim:.3g} even at eb={lo:.3g}")
        while hi / lo > 1.02:  # log-bisect, lo on the feasible side
            mid = float(np.sqrt(lo * hi))
            if mse_at(mid) <= mse_aim:
                lo = mid
            else:
                hi = mid
        self._telemetry()["psnr_search"] = {"target_db": target, "eb_abs": float(lo), "trials": trials,
                                            "trial_elems": int(trial.numel())}
        return float(lo)

    # ------------------------------------------------------------- interp
    def _plan_cache_key(self, x: torch.Tensor):
        """Plan-cache key of this field under this spec (the JAX package's),
        or None when there is no cache or nothing to tune."""
        sp = self.spec
        if self.plan_cache is None or sp.predictor not in ("interp", "auto"):
            return None
        if not (sp.predictor == "auto" or sp.autotune or sp.pipeline == "auto"):
            return None
        extra = (sp.predictor, int(sp.anchor_stride), tuple(sp.plan_anchor_strides), bool(sp.autotune),
                 bool(sp.reorder), sp.pipeline, tuple(sp.pipeline_candidates or ()), sp.psnr_target)
        return plan_signature(tuple(x.shape), np.float32, sp.eb, sp.eb_mode, stats_bucket(x), extra=extra)

    def _tune_interp(self, blocks: torch.Tensor, eb_abs: float, batch: int, padded_shapes,
                     presampled_of: int | None = None):
        """The (anchor stride, splines, schemes, plan) the predictor will run;
        ``plan`` is the planner's PredictorPlan under ``predictor="auto"``
        (also recorded on this thread's ``last_plan``), else None.
        ``blocks`` is the full block batch, or the tuner's own sample of it
        with ``presampled_of`` the true block count."""
        sp = self.spec
        if sp.predictor == "auto":
            with span("compress.plan"):
                plan = autotune_plan(blocks, 2.0 * eb_abs, tuple(sp.plan_anchor_strides),
                                     field_shape=(batch,) + tuple(padded_shapes),
                                     trial_pipeline=sp.pipeline if sp.pipeline != "auto" else "cr", reorder=sp.reorder,
                                     presampled_of=presampled_of)
            self.last_plan = plan
            return plan.anchor_stride, plan.splines, plan.schemes, plan
        stride, levels = sp.anchor_stride, sp.levels
        if sp.autotune:
            with span("compress.autotune"):
                splines, schemes = autotune(blocks, 2.0 * eb_abs, levels, stride, presampled=presampled_of is not None)
        else:
            splines, schemes = tuple(sp.splines[: len(levels)]), tuple(sp.schemes[: len(levels)])
        return stride, splines, schemes, None

    def _encode_codes(self, seq, pipeline_override: str | None = None) -> tuple[bytes, dict]:
        """Lossless-encode the code stream: (payload, header fields). Under
        ``pipeline="auto"`` the orchestrator chooses and its record lands in
        the header (``pchoice``); a plan-cache hit replays the recorded
        pipeline instead (``pcached``). A failure raises: nothing falls back."""
        sp = self.spec
        tel = self._telemetry()
        fixed = sp.pipeline if sp.pipeline != "auto" else pipeline_override
        if fixed is not None:
            hdr = {"pipeline": fixed}
            if sp.pipeline == "auto":
                hdr["pcached"] = True  # a plan-cache replay, not a spec-fixed pipeline
            tel["pipeline"] = fixed
            return pipelines.encode(seq, fixed, tel=tel), hdr
        with span("compress.orchestrate"):
            payload, record = orchestrate.encode_auto(seq, candidates=sp.pipeline_candidates, tel=tel)
        tel["pipeline"] = record["pipeline"]
        return payload, {"pipeline": record["pipeline"], "pchoice": record}

    def _compress_interp(self, x: torch.Tensor, eb_abs: float, base_hdr: dict) -> bytes:
        sp = self.spec
        xb, spatial = _spatial_view(x)
        ndim, batch = len(spatial), int(xb.shape[0])
        with span("compress.blocks"):
            padded = blk.pad_field_batch_t(xb, blk.ANCHOR_STRIDE)
            padded_shapes = tuple(int(s) for s in padded.shape[1:])
            blocks = blk.gather_blocks_batch_t(padded, blk.ANCHOR_STRIDE)
        # plan cache: a recurring field signature replays the predictor plan
        # and (pipeline="auto") the orchestrator's choice, skipping both tuners
        with span("compress.plan_cache"):
            ckey = self._plan_cache_key(x)
            cached = self.plan_cache.get(ckey) if ckey is not None else None
        pipe_override = None
        if cached is not None:
            self._telemetry()["plan_cache"] = "hit"
            stride, splines, schemes = int(cached["stride"]), tuple(cached["splines"]), tuple(cached["schemes"])
            if sp.predictor == "auto" and cached.get("plan") is not None:
                self.last_plan = PredictorPlan.from_header(cached["plan"])
            pipe_override = cached.get("pipeline")
        else:
            if ckey is not None:
                self._telemetry()["plan_cache"] = "miss"
            # the plan cached below is this call's own, whatever other threads tune meanwhile
            stride, splines, schemes, plan = self._tune_interp(blocks, eb_abs, batch, padded_shapes)
        steps = build_steps(ndim, blk.BLOCK, levels_for_stride(stride), splines, schemes)
        with span("compress.predict"):
            codes_b, _ = _interp.compress_blocks(blocks, 2.0 * eb_abs, steps, stride, with_recon=False)
        del blocks
        if self._device_engine:
            # codes stay on the device through scatter, reorder and the
            # lossless twins; outliers are the code == 0 points
            with span("compress.scatter_reorder"):
                cgrid = blk.scatter_blocks_batch_t(codes_b, batch, padded_shapes, blk.ANCHOR_STRIDE)
                oi_t = torch.nonzero(cgrid.reshape(-1) == 0).reshape(-1)
                ov = padded.reshape(-1)[oi_t].cpu().numpy()
                oi = oi_t.cpu().numpy().astype(np.int64)
                anc = blk.anchor_grid_batch_t(padded, stride).cpu().numpy()
                seq = reorder_codes_batch_t(cgrid, stride, sp.reorder)
        else:
            padded_np = padded.cpu().numpy()
            cgrid = blk.scatter_blocks_batch(codes_b.cpu().numpy(), batch, padded_shapes, blk.ANCHOR_STRIDE)
            oi = np.flatnonzero(cgrid.reshape(-1) == 0).astype(np.int64)  # outliers, batch-global
            ov = padded_np.reshape(-1)[oi]
            anc = blk.anchor_grid_batch(padded_np, stride)
            seq = reorder_codes_batch(cgrid, stride, sp.reorder)
        payload, penc = self._encode_codes(seq, pipe_override)
        header = dict(base_hdr, mode="interp", anchor_stride=int(stride), padded=list(padded_shapes),
                      batch=batch, splines=list(splines), schemes=list(schemes), reorder=bool(sp.reorder),
                      n_outliers=int(oi.size), **penc)
        buf = _sections_pack(header, [payload, anc.astype(np.float32, copy=False).tobytes(),
                                      oi.tobytes(), ov.astype(np.float32, copy=False).tobytes()])
        if ckey is not None and cached is None:
            with span("compress.plan_cache"):
                self.plan_cache.put(ckey, {
                    "stride": int(stride), "splines": tuple(splines), "schemes": tuple(schemes),
                    "plan": None if plan is None else plan.to_header(),
                    # only a pipeline the orchestrator chose needs a replay
                    "pipeline": self._telemetry().get("pipeline") if sp.pipeline == "auto" else None})
        return buf

    def _compress_lorenzo(self, x: torch.Tensor, eb_abs: float, base_hdr: dict) -> bytes:
        xb, spatial = _spatial_view(x)
        with span("compress.predict"):
            codes, oi, ov = _lor.lorenzo_encode(xb, 2.0 * eb_abs, len(spatial))
        seq = codes.reshape(-1)
        payload, penc = self._encode_codes(seq if self._device_engine else seq.cpu().numpy())
        header = dict(base_hdr, mode="lorenzo", batch=int(xb.shape[0]), spatial=list(spatial),
                      n_outliers=int(oi.numel()), **penc)
        return _sections_pack(header, [payload, oi.cpu().numpy().astype(np.int64).tobytes(),
                                       ov.cpu().numpy().astype(np.int32).tobytes()])

    def _compress_offset1d(self, x: torch.Tensor, eb_abs: float, base_hdr: dict) -> bytes:
        with span("compress.predict"):
            codes = lor.offset1d_encode(x, 2.0 * eb_abs)
        payload, hdr = fl_encode(codes.cpu().numpy())
        return _sections_pack(dict(base_hdr, mode="offset1d", fl=hdr), [payload])

    # ------------------------------------------------ bound verification
    def _verify_check(self, x: torch.Tensor, buf: bytes, *, rel: bool):
        """Decode ``buf`` on the compressor's device and return (worst error,
        points checked): absolute, or point-wise relative (``rel``; a zero
        must decode to zero); every point, or under "sample" the JAX
        package's ``np.linspace`` stride sample."""
        hold, self._telemetry_hold = self._telemetry_hold, True
        try:
            y = self.decompress(buf, out="device")
        finally:
            self._telemetry_hold = hold
        xf, yf = x.reshape(-1).to(torch.float64), y.reshape(-1).to(torch.float64)
        n = int(xf.numel())
        if not n:
            return 0.0, 0
        if self.spec.verify == "sample" and n > _VERIFY_SAMPLE:
            idx = torch.from_numpy(np.linspace(0, n - 1, _VERIFY_SAMPLE).astype(np.int64)).to(self.device)
            xf, yf = xf[idx], yf[idx]
        if rel:
            nz = xf != 0.0
            err = float(((yf[nz] - xf[nz]).abs() / xf[nz].abs()).max()) if bool(nz.any()) else 0.0
            if bool((yf[~nz] != 0.0).any()):  # the exact-zero contract of pw_rel
                err = float("inf")
            return err, int(xf.numel())
        return float((yf - xf).abs().max()), int(xf.numel())

    def _verify_repair(self, x: torch.Tensor, buf: bytes, *, bound: float, rel: bool) -> bytes:
        """Decode-and-check the fresh container; on a violation re-encode at
        a halved bound (absolute, or pw_rel's relative one), checked against
        the ORIGINAL bound, up to ``_REPAIR_ATTEMPTS`` times, then raise
        :class:`BoundViolationError`. The outcome lands in
        ``last_telemetry["verify"]``."""
        sp = self.spec
        if sp.verify == "off":
            return buf
        tel = self._telemetry()
        with span("compress.verify"):
            max_err, checked = self._verify_check(x, buf, rel=rel)
        repairs, cur = 0, float(bound)
        limit = bound * (1.0 + _VERIFY_SLACK) + 1e-12
        while max_err > limit:
            if repairs >= _REPAIR_ATTEMPTS or cur <= 0.0:
                tel["verify"] = {"mode": sp.verify, "checked": checked, "max_err": max_err,
                                 "bound": bound, "repairs": repairs}
                raise BoundViolationError(
                    f"bound violation survived {repairs} repair(s): max err {max_err:.6g} > declared "
                    f"bound {bound:.6g} (verify={sp.verify!r}, {checked} points checked)",
                    max_err=max_err, bound=bound, repairs=repairs)
            repairs += 1
            cur *= _REPAIR_TIGHTEN
            rspec = (dataclasses.replace(sp, eb=cur, verify="off") if rel else
                     dataclasses.replace(sp, eb_mode="abs", eb=cur, psnr_target=None, verify="off"))
            try:
                buf = Compressor(rspec, device=self.device, plan_cache=self.plan_cache).compress(x)
            except ValueError as e:  # the tightened bound fell off the codec's range
                tel["verify"] = {"mode": sp.verify, "checked": checked, "max_err": max_err,
                                 "bound": bound, "repairs": repairs}
                raise BoundViolationError(
                    f"bound violation (max err {max_err:.6g} > {bound:.6g}) and repair rung {repairs} "
                    f"cannot encode at eb={cur:.6g}: {e}", max_err=max_err, bound=bound, repairs=repairs) from e
            max_err, checked = self._verify_check(x, buf, rel=rel)
        tel["verify"] = {"mode": sp.verify, "checked": checked, "max_err": max_err,
                         "bound": bound, "repairs": repairs}
        return buf

    # ------------------------------------------------------------- inspect
    @staticmethod
    def inspect(buf: bytes) -> dict:
        """Container header + section sizes, without decompressing.

        A v3 (chunked) container gives its global header, each frame's
        byte size, a per-frame ``frame_crc_ok`` mask, each frame's own
        inspect dict under ``frames`` (a compressor chunk stream), and for a
        damaged stream a ``damage`` DamageReport: inspect does not raise for
        frame damage, it reports what a salvage pass would recover.
        """
        if frames_mod.is_v3(buf):
            try:
                header, table = frames_mod.frame_table(buf)
            except ContainerError:  # structurally damaged: what a salvage pass recovers
                header = frames_mod.read_header(buf)
                good, report = frames_mod.scan_frames(buf)
                out = dict(header, n_frames=len(good), frame_bytes=[len(p) for _, p in good],
                           frame_indices=[i for i, _ in good], damage=report)
                if header.get("kind") == "chunks":
                    out["frames"] = [Compressor.inspect(p) for _, p in good]
                return out
            crc_ok, payloads = [], []
            for t in table:
                try:
                    payloads.append(frames_mod.read_frame(buf, t))
                    crc_ok.append(True)
                except FrameCRCError:
                    payloads.append(None)
                    crc_ok.append(False)
            out = dict(header, n_frames=len(table), frame_bytes=[size for _, size, _ in table], frame_crc_ok=crc_ok)
            if not all(crc_ok):
                report = DamageReport(declared_frames=len(table), frames_ok=sum(crc_ok),
                                      frames_damaged=len(table) - sum(crc_ok))
                for i, ok in enumerate(crc_ok):
                    if not ok:
                        report.add("crc", table[i][0], index=i, detail="payload CRC32 mismatch")
                out["damage"] = report
            if header.get("kind") == "chunks":  # frames are themselves containers
                out["frames"] = [None if p is None else Compressor.inspect(p) for p in payloads]
            return out
        header, sections = _sections_unpack(buf)
        out = dict(header, section_bytes=[len(s) for s in sections])
        if header.get("mode") in ("pw_rel", "nfsafe"):  # section 0 is a full inner container
            out["inner"] = Compressor.inspect(bytes(sections[0]))
        if header.get("mode") == "interp" and header.get("predictor") == "auto" and "splines" in header:
            out["pplan"] = {"ndim": len(header["padded"]), "anchor_stride": int(header["anchor_stride"]),
                            "splines": list(header["splines"]), "schemes": list(header["schemes"])}
        return out

    # ------------------------------------------------------------ decompress
    def decompress(self, buf: bytes, frames=None, *, on_error: str = "raise", fill_value: float = 0.0,
                   out: str = "numpy"):
        """Decompress a v1/v2/v3 container.

        ``out="numpy"`` returns a host ndarray; ``out="device"`` a tensor on
        the compressor's device (a CUDA tensor on the card; a v3 stream's
        chunks concatenate there). Records ``last_telemetry["decode"]``
        (engine, out, seconds, bytes, MB/s).

        ``frames``: v3 only, the frame indices to decode, in any order; the
        result is those chunks concatenated along the chunk axis in that
        order (``None``: every frame, the whole field).

        ``on_error``: ``"raise"`` raises the typed error of the first damage;
        ``"skip"`` (v3) leaves damaged chunks out; ``"fill"`` decodes them as
        ``fill_value`` chunks of their shape (also a single v1/v2 container
        whose header still gives the shape). A salvaging call records the
        DamageReport and the per-requested-chunk intact mask on
        ``last_damage`` (None when intact). Kernel and device errors
        (:data:`DEVICE_ERRORS`) propagate under every mode.
        """
        if on_error not in ("raise", "skip", "fill"):
            raise ValueError(f"on_error must be 'raise', 'skip' or 'fill', got {on_error!r}")
        if out not in ("numpy", "device"):
            raise ValueError(f"out must be 'numpy' or 'device', got {out!r}")
        hold = self._telemetry_hold
        if not hold:
            self.last_telemetry = None
        tel = self._telemetry()
        t0 = time.perf_counter()
        self.last_damage = None
        if frames_mod.is_v3(buf):
            result = self._decompress_v3(buf, frames, on_error=on_error, fill_value=fill_value, out=out)
        else:
            if frames is not None:
                raise ValueError("frames= is only meaningful for v3 (chunked) containers")
            try:
                header, sections = _sections_unpack(buf)
                result = self._decompress_sections(header, sections, tel)
            except DEVICE_ERRORS:
                raise
            except Exception as e:
                if on_error != "fill":
                    raise
                # salvage a single container only where its header still gives the shape
                try:
                    shape = tuple(_sections_unpack(buf)[0]["shape"])
                except Exception:
                    raise e from None
                report = DamageReport()
                report.add("decode", 0, index=0, detail=repr(e))
                report.frames_damaged = 1
                self.last_damage = {"report": report, "chunks_ok": [False], "on_error": on_error}
                result = self._fill(shape, fill_value, out)
        if out == "numpy" and isinstance(result, torch.Tensor):
            result = result.cpu().numpy()
        if not hold:
            self._sync()
            dt = time.perf_counter() - t0
            nbytes = int(result.nbytes) if isinstance(result, np.ndarray) else result.numel() * result.element_size()
            tel["decode"] = {"engine": "device" if self._device_engine else "numpy", "out": out,
                             "seconds": dt, "bytes": nbytes, "mbps": (nbytes / dt / 1e6) if dt > 0 else 0.0}
        return result

    def _fill(self, shape, fill_value: float, out: str):
        """A damaged chunk under on_error="fill": ``fill_value`` in its shape."""
        if out == "device":
            return torch.full(shape, float(np.float32(fill_value)), dtype=torch.float32, device=self.device)
        return np.full(shape, np.float32(fill_value), np.float32)

    @staticmethod
    def _chunk_shape(header: dict, i: int) -> tuple:
        """Chunk ``i``'s field shape from a v3 chunk-stream header."""
        shape = list(header["shape"])
        shape[int(header.get("axis", 0))] = int(header["chunk_sizes"][i])
        return tuple(shape)

    def _salvage_payloads(self, buf, on_error: str):
        """(header, {frame index: payload}, DamageReport) of a v3 stream.
        ``on_error="raise"`` raises on the first damage; the salvage modes
        walk a structurally damaged stream with ``frames.scan_frames`` and
        leave CRC-damaged frames out otherwise."""
        with span("decompress.frames"):
            try:
                header, table = frames_mod.frame_table(buf)
            except ContainerError:
                if on_error == "raise":
                    raise
                header = frames_mod.read_header(buf)
                good, report = frames_mod.scan_frames(buf)
                return header, dict(good), report
            report = DamageReport(declared_frames=len(table))
            payloads = {}
            for i, t in enumerate(table):
                try:
                    payloads[i] = frames_mod.read_frame(buf, t)
                    report.frames_ok += 1
                except FrameCRCError:
                    if on_error == "raise":
                        raise
                    report.add("crc", t[0], index=i, detail="payload CRC32 mismatch")
                    report.frames_damaged += 1
            return header, payloads, report

    def _decode_frame(self, payload, on_error: str, out: str):
        """(chunk, None) of one v3 frame, or under salvage (None, error) for a
        frame that does not decode (a resync false positive, garbage past the
        CRC); kernel and device errors propagate."""
        if on_error == "raise":
            return self.decompress(payload, out=out), None
        try:
            return self.decompress(payload, out=out), None
        except DEVICE_ERRORS:
            raise
        except Exception as e:
            return None, e

    @staticmethod
    def _note_decode_damage(report: DamageReport, i: int, err: Exception | None) -> None:
        if err is not None:
            report.add("decode", -1, index=i, detail=repr(err))
            report.frames_damaged += 1

    def _assemble_v3(self, header: dict, idx, parts, report: DamageReport, on_error: str, fill_value: float,
                     out: str):
        """Concatenate the decoded chunks (None: dropped by salvage) along the
        chunk axis, filling or skipping the dropped ones; records
        ``last_damage`` for a damaged stream."""
        mask = [p is not None for p in parts]
        if on_error == "fill":
            parts = [self._fill(self._chunk_shape(header, i), fill_value, out) if p is None else p
                     for i, p in zip(idx, parts)]
        parts = [p for p in parts if p is not None]
        if not report.ok:
            self.last_damage = {"report": report, "chunks_ok": mask, "on_error": on_error}
        if not parts:
            raise ContainerError(f"no decodable frames in damaged v3 container ({report.summary()})")
        if len(parts) == 1:
            return parts[0]
        axis = int(header.get("axis", 0))
        return torch.cat(parts, dim=axis) if out == "device" else np.concatenate(parts, axis=axis)

    def _v3_request(self, buf, frames, on_error: str):
        """(header, payloads, report, frame indices) of a decode request."""
        header, payloads, report = self._salvage_payloads(buf, on_error)
        if header.get("kind") != "chunks":
            raise ValueError(f"v3 container kind {header.get('kind')!r} is not a compressor chunk stream; "
                             "use its producer's reader")
        idx = list(range(len(header["chunk_sizes"]))) if frames is None else [int(i) for i in frames]
        if not idx:
            raise ValueError("frames= selected no frames; pass at least one index (or None for all)")
        return header, payloads, report, idx

    def _decompress_v3(self, buf, frames=None, *, on_error: str = "raise", fill_value: float = 0.0,
                       out: str = "numpy"):
        """Chunked container v3: each frame (a v1/v2 container of one chunk)
        decodes on its own, and the chunks concatenate along the chunk axis;
        under salvage a damaged chunk costs only itself."""
        header, payloads, report, idx = self._v3_request(buf, frames, on_error)
        parts = []
        # the frames' decompress() calls add to this call's telemetry
        hold, self._telemetry_hold = self._telemetry_hold, True
        try:
            for i in idx:
                if i in payloads:
                    part, err = self._decode_frame(payloads[i], on_error, out)
                    self._note_decode_damage(report, i, err)
                    parts.append(part)
                elif on_error == "raise":
                    raise ContainerError(f"frame {i} missing from v3 container")
                else:
                    parts.append(None)
        finally:
            self._telemetry_hold = hold
        return self._assemble_v3(header, idx, parts, report, on_error, fill_value, out)

    def _decompress_sections(self, header, sections, tel: dict) -> torch.Tensor:
        shape = tuple(header["shape"])
        mode = header["mode"]
        if mode == "const":
            v = float(np.frombuffer(sections[0], np.float32)[0])
            return torch.full(shape, v, dtype=torch.float32, device=self.device)
        if mode == "interp":
            return self._decompress_interp(header, sections, shape, tel)
        if mode == "lorenzo":
            return self._decompress_lorenzo(header, sections, shape, tel)
        if mode == "offset1d":
            codes = torch.from_numpy(fl_decode(sections[0], header["fl"])).to(self.device)
            with span("decompress.predict"):
                return lor.offset1d_decode(codes, 2.0 * float(header["eb_abs"])).reshape(shape)
        if mode == "pw_rel":
            return self._decompress_pw_rel(sections, shape, tel)
        if mode == "nfsafe":
            return self._decompress_nfsafe(sections, shape, tel)
        if mode == "nonfinite":
            return self._decompress_nonfinite(sections, shape)
        raise ContainerError(f"unknown container mode {mode!r}")

    def _decompress_interp(self, header, sections, shape, tel: dict) -> torch.Tensor:
        dev = self.device
        stride = int(header["anchor_stride"])
        padded_shapes = tuple(int(s) for s in header["padded"])
        batch = int(header["batch"])
        ndim = len(padded_shapes)
        anc_shape = tuple((d - 1) // stride + 1 for d in padded_shapes)
        levels = levels_for_stride(stride)
        # containers without recorded step tables decode with cubic/md
        splines = tuple(header.get("splines", ("cubic",) * len(levels)))
        schemes = tuple(header.get("schemes", ("md",) * len(levels)))
        steps = build_steps(ndim, blk.BLOCK, levels, splines, schemes)
        reorder = header.get("reorder", True)
        spatial = shape[len(shape) - ndim :] if len(shape) >= ndim else shape
        sl = (slice(None),) + tuple(slice(0, s) for s in spatial)
        anc = np.frombuffer(sections[1], np.float32).reshape((batch,) + anc_shape)
        oi = np.frombuffer(sections[2], np.int64)
        ov = np.frombuffer(sections[3], np.float32)
        if self._device_engine:
            seq = pipelines.decode(sections[0], device=dev, tel=tel)
        else:
            seq = pipelines.decode(sections[0])
        with span("decompress.blocks"):
            if self._device_engine:
                cgrid = restore_codes_batch_t(seq, batch, padded_shapes, fill=128, stride=stride, reorder=reorder)
                cb = blk.gather_blocks_batch_t(cgrid, blk.ANCHOR_STRIDE)
            else:
                cgrid = restore_codes_batch(seq, batch, padded_shapes, fill=128, dtype=np.uint8,
                                            stride=stride, reorder=reorder)
                cb = torch.from_numpy(blk.gather_blocks_batch(cgrid, blk.ANCHOR_STRIDE)).to(dev)
            # the decoder takes each block's anchors and its outliers, no dense grids
            ab = blk.gather_blocks_batch_t(torch.from_numpy(anc.copy()).to(dev), blk.ANCHOR_STRIDE // stride)
            keys, src = blk.block_keys_t(torch.from_numpy(oi.copy()).to(dev), padded_shapes)
            vals = torch.from_numpy(ov.copy()).to(dev)[src]
        with span("decompress.predict"):
            recon_b = _interp.decompress_blocks(cb, ab, keys, vals, 2.0 * float(header["eb_abs"]), steps, stride)
        del cb, ab, keys, vals
        with span("decompress.scatter"):
            out = blk.scatter_blocks_batch_t(recon_b, batch, padded_shapes, blk.ANCHOR_STRIDE)
            return out[sl].reshape(shape)

    def _decompress_lorenzo(self, header, sections, shape, tel: dict) -> torch.Tensor:
        dev = self.device
        spatial = tuple(int(s) for s in header["spatial"])
        oi = np.frombuffer(sections[1], np.int64)
        ov = np.frombuffer(sections[2], np.int32)
        if self._device_engine:
            seq = pipelines.decode(sections[0], device=dev, tel=tel)
        else:
            seq = torch.from_numpy(pipelines.decode(sections[0]).copy()).to(dev)
        with span("decompress.predict"):
            codes = seq.reshape((int(header["batch"]),) + spatial)
            ofull = torch.zeros(codes.numel(), dtype=torch.int32, device=dev)
            if oi.size:
                ofull[torch.from_numpy(oi.copy()).to(dev)] = torch.from_numpy(ov.copy()).to(dev)
            out = lor.lorenzo_decode(codes, ofull.view(codes.shape), 2.0 * float(header["eb_abs"]), len(spatial))
        return out.reshape(shape)


# ------------------------------------------------------------------ presets
# The JAX package's presets; ``device`` is the Compressor's (the card unless "cpu").
def cusz_hi_auto(eb=1e-3, *, device=None, **kw) -> Compressor:
    """Orchestrated mode: the per-field best-fit lossless pipeline (§5.2)."""
    return Compressor(CompressorSpec(eb=eb, pipeline="auto", **kw), device=device)


def cusz_hi_autoplan(eb=1e-3, *, device=None, **kw) -> Compressor:
    """Fully synergistic mode: the per-level spline/scheme/stride planner
    (§5.1.3) and the per-field best-fit lossless pipeline (§5.2)."""
    return Compressor(CompressorSpec(eb=eb, predictor="auto", pipeline="auto", **kw), device=device)


def cusz_hi_cr(eb=1e-3, *, device=None, **kw) -> Compressor:
    return Compressor(CompressorSpec(eb=eb, pipeline="cr", **kw), device=device)


def cusz_hi_crz(eb=1e-3, *, device=None, **kw) -> Compressor:
    """Beyond-paper mode: the CR pipeline with a zstd tail stage (zlib where
    zstandard does not import)."""
    return Compressor(CompressorSpec(eb=eb, pipeline="crz", **kw), device=device)


def cusz_hi_tp(eb=1e-3, *, device=None, **kw) -> Compressor:
    """Throughput mode: the CR predictor with the ``tp`` pipeline."""
    return Compressor(CompressorSpec(eb=eb, pipeline="tp", **kw), device=device)


def cusz_l(eb=1e-3, *, device=None) -> Compressor:
    """cuSZ-L baseline: Lorenzo + Huffman."""
    return Compressor(CompressorSpec(eb=eb, predictor="lorenzo", pipeline="hf"), device=device)


def cusz_i(eb=1e-3, *, device=None) -> Compressor:
    """cuSZ-I baseline: stride-8 anchors, 3 levels, 1D scheme, Huffman only."""
    return Compressor(
        CompressorSpec(eb=eb, predictor="interp", pipeline="hf", anchor_stride=8, autotune=False,
                       splines=("cubic",) * 3, schemes=("1d",) * 3, reorder=False),
        device=device)


def cuszp2_like(eb=1e-3, *, device=None) -> Compressor:
    """cuSZp2-like baseline: 1-D offset prediction + fixed-length encoding."""
    return Compressor(CompressorSpec(eb=eb, predictor="offset1d", pipeline="none"), device=device)


def fzgpu_like(eb=1e-3, *, device=None) -> Compressor:
    """FZ-GPU-like baseline: Lorenzo + bitshuffle + de-redundancy."""
    return Compressor(CompressorSpec(eb=eb, predictor="lorenzo", pipeline="fz"), device=device)
