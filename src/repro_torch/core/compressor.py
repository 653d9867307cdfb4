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
JSON header) and v2 are read, the LLP2 stream framing and the spec-string
grammar are the same, so a container written by either package decodes in
the other and ``CompressorSpec.from_string(s).to_string()`` agrees.

Device: ``Compressor(device=None)`` runs on ``"cuda"`` and raises when
CUDA is absent; ``device="cpu"`` runs the plain torch predictor and the
host lossless stages. On the card nothing falls back: a kernel that fails
to build or launch raises, and ``last_telemetry["fallbacks"]`` stays empty.
The one host route there is chosen by the format, not by an error: an hf
stream without per-chunk offsets (containers written before the offset
table existed) decodes on the host, recorded as
``last_telemetry["hf_decode"] == "host-legacy"``.

Ported so far: ``predictor="interp"`` and ``"lorenzo"``, ``eb_mode`` rel
or abs, fixed pipelines of ported stages (cr, tp, fz, fzh, hf, lvl, none),
``verify`` off/sample/full, containers v1/v2, and the presets
``cusz_hi_cr``, ``cusz_hi_tp``, ``cusz_l``, ``cusz_i`` and ``fzgpu_like``.
Other spec values parse and round-trip as strings and raise
:class:`~repro_torch.core.errors.NotPortedError` when used, as do
non-finite input and v3 containers.

Tracing: each stage of the main path runs inside a
``torch.profiler.record_function`` span (``compress.blocks``,
``compress.autotune``, ``compress.predict`` (also the Lorenzo encode),
``compress.scatter_reorder``,
``<stage>.encode``, ``compress.verify``, ``<stage>.decode``,
``decompress.blocks``, ``decompress.predict`` (also the Lorenzo prefix
sums), ``decompress.scatter``);
a span records only while a profiler is active.

Error-bound contract: ||x - decompress(compress(x))||_inf <= eb_abs, with
eb_abs = eb * value_range(x) in the paper's default "rel" mode.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import time

import numpy as np
import torch
from torch.profiler import record_function as span

from ..kernels import interp3d as _interp
from ..kernels import lorenzo3d as _lor
from . import blocks as blk
from . import lorenzo as lor
from .autotune import DEFAULT_STRIDES, autotune, levels_for_stride
from .errors import BoundViolationError, ContainerError, NotPortedError, SpecError
from .lossless import pipelines
from .reorder import reorder_codes_batch, reorder_codes_batch_t, restore_codes_batch, restore_codes_batch_t
from .serial import pack_obj, unpack_obj
from .stencils import SPLINES, build_steps

MAGIC_V1 = b"CSZH1\n"
MAGIC = b"CSZH2\n"
MAGIC_V3 = b"CSZH3\n"

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
    predictor: str = "interp"             # interp | lorenzo (ported) | auto | offset1d
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
        if self.pipeline != "auto" and not pipelines.known_pipeline(self.pipeline):
            raise ValueError(f"unknown pipeline {self.pipeline!r}; registered pipelines: "
                             f"{', '.join(sorted(pipelines.PIPELINES))} (or 'auto')")
        if self.pipeline_candidates is not None and not self.pipeline_candidates:
            raise ValueError("pipeline_candidates must be None or a non-empty sequence of pipeline names")
        for nm in self.pipeline_candidates or ():
            if not pipelines.known_pipeline(nm):
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
    if buf[: len(MAGIC_V3)] == MAGIC_V3:
        raise NotPortedError("container v3 (chunked frames)")
    raise ContainerError(f"bad container magic {bytes(buf[:6])!r}; expected {MAGIC!r} or {MAGIC_V1!r}")


def _spatial_view(x: torch.Tensor):
    """Fold >3-D tensors into (batch, spatial<=3)."""
    nd = min(x.dim(), 3)
    spatial = tuple(int(s) for s in x.shape[x.dim() - nd :])
    batch = int(np.prod(x.shape[: x.dim() - nd], dtype=np.int64)) if x.dim() > nd else 1
    return x.reshape((batch,) + spatial), spatial


class Compressor:
    def __init__(self, spec: CompressorSpec | None = None, *, device=None, **kw):
        self.spec = spec or CompressorSpec(**kw)
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; Compressor runs on the card unless given device='cpu'")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"Compressor runs on 'cuda' or 'cpu', got {dev}")
        self.device = dev
        # reset by compress() and decompress(): backend, engine, device,
        # fallbacks (always empty: nothing falls back), pipeline, verify,
        # decode timing, and the routes the stream format chose (hf_decode)
        self.last_telemetry = None
        self._hold = False  # a nested decompress (verify) adds to the caller's telemetry

    @property
    def _device_engine(self) -> bool:
        return self.spec.engine == "device" or (self.spec.engine == "auto" and self.device.type == "cuda")

    def _telemetry(self) -> dict:
        if self.last_telemetry is None:
            self.last_telemetry = {"backend": self.spec.backend, "engine": self.spec.engine,
                                   "device": str(self.device), "fallbacks": []}
        return self.last_telemetry

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_ported(self) -> None:
        sp = self.spec
        if sp.predictor not in ("interp", "lorenzo"):
            raise NotPortedError(f"predictor={sp.predictor!r}")
        if sp.eb_mode == "pw_rel":
            raise NotPortedError("eb_mode='pw_rel'")
        if sp.psnr_target is not None:
            raise NotPortedError("psnr_target")
        if sp.pipeline == "auto":
            raise NotPortedError("pipeline='auto' (the orchestrator)")
        pipelines.get_pipeline(sp.pipeline)

    def _abs_eb(self, x: torch.Tensor) -> float:
        if self.spec.eb_mode == "abs":
            return float(self.spec.eb)
        # range in f64: a float32 max-min of an extreme-range field overflows
        rng = (float(x.max()) - float(x.min())) if x.numel() else 0.0
        return float(self.spec.eb) * rng

    # -------------------------------------------------------------- compress
    def compress(self, x) -> bytes:
        """Compress ``x`` (numpy array or tensor) to a v2 container under the
        spec's bound; ``x`` moves to the compressor's device first."""
        self.last_telemetry = None
        self._telemetry()
        self._check_ported()
        xt = torch.as_tensor(x).to(device=self.device, dtype=torch.float32).contiguous()
        if xt.numel() and not bool(torch.isfinite(xt).all()):
            raise NotPortedError("non-finite input (NaN/Inf ingest)")
        eb_abs = self._abs_eb(xt)
        base_hdr = {"shape": list(xt.shape), "predictor": self.spec.predictor,
                    "eb_abs": eb_abs, "anchor_stride": self.spec.anchor_stride}
        if eb_abs == 0.0:  # constant (or empty) field: store the value verbatim
            v = np.float32(xt.reshape(-1)[0].item() if xt.numel() else 0)
            buf = _sections_pack(dict(base_hdr, mode="const"), [v.tobytes()])
        elif self.spec.predictor == "lorenzo":
            buf = self._compress_lorenzo(xt, eb_abs, base_hdr)
        else:
            buf = self._compress_interp(xt, eb_abs, base_hdr)
        return self._verify_repair(xt, buf, bound=eb_abs)

    def _compress_interp(self, x: torch.Tensor, eb_abs: float, base_hdr: dict) -> bytes:
        sp = self.spec
        xb, spatial = _spatial_view(x)
        ndim, batch = len(spatial), int(xb.shape[0])
        with span("compress.blocks"):
            padded = blk.pad_field_batch_t(xb, blk.ANCHOR_STRIDE)
            padded_shapes = tuple(int(s) for s in padded.shape[1:])
            blocks = blk.gather_blocks_batch_t(padded, blk.ANCHOR_STRIDE)
        stride, levels = sp.anchor_stride, sp.levels
        if sp.autotune:
            with span("compress.autotune"):
                splines, schemes = autotune(blocks, 2.0 * eb_abs, levels, stride)
        else:
            splines, schemes = tuple(sp.splines[: len(levels)]), tuple(sp.schemes[: len(levels)])
        steps = build_steps(ndim, blk.BLOCK, levels, splines, schemes)
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
        payload = pipelines.encode(seq, sp.pipeline)
        self._telemetry()["pipeline"] = sp.pipeline
        header = dict(base_hdr, mode="interp", anchor_stride=int(stride), padded=list(padded_shapes),
                      batch=batch, splines=list(splines), schemes=list(schemes), reorder=bool(sp.reorder),
                      n_outliers=int(oi.size), pipeline=sp.pipeline)
        return _sections_pack(header, [payload, anc.astype(np.float32, copy=False).tobytes(),
                                       oi.tobytes(), ov.astype(np.float32, copy=False).tobytes()])

    def _compress_lorenzo(self, x: torch.Tensor, eb_abs: float, base_hdr: dict) -> bytes:
        sp = self.spec
        xb, spatial = _spatial_view(x)
        with span("compress.predict"):
            codes, oi, ov = _lor.lorenzo_encode(xb, 2.0 * eb_abs, len(spatial))
        seq = codes.reshape(-1)
        payload = pipelines.encode(seq if self._device_engine else seq.cpu().numpy(), sp.pipeline)
        self._telemetry()["pipeline"] = sp.pipeline
        header = dict(base_hdr, mode="lorenzo", batch=int(xb.shape[0]), spatial=list(spatial),
                      n_outliers=int(oi.numel()), pipeline=sp.pipeline)
        return _sections_pack(header, [payload, oi.cpu().numpy().astype(np.int64).tobytes(),
                                       ov.cpu().numpy().astype(np.int32).tobytes()])

    # ------------------------------------------------ bound verification
    def _verify_check(self, x: torch.Tensor, buf: bytes):
        """Decode ``buf`` on the compressor's device and return (worst
        absolute error, points checked): every point, or under "sample"
        the JAX package's ``np.linspace`` stride sample."""
        hold, self._hold = self._hold, True
        try:
            y = self.decompress(buf, out="device")
        finally:
            self._hold = hold
        xf, yf = x.reshape(-1), y.reshape(-1)
        n = int(xf.numel())
        if not n:
            return 0.0, 0
        if self.spec.verify == "sample" and n > _VERIFY_SAMPLE:
            idx = torch.from_numpy(np.linspace(0, n - 1, _VERIFY_SAMPLE).astype(np.int64)).to(self.device)
            xf, yf = xf[idx], yf[idx]
        return float((yf.double() - xf.double()).abs().max()), int(xf.numel())

    def _verify_repair(self, x: torch.Tensor, buf: bytes, *, bound: float) -> bytes:
        """Decode-and-check the fresh container; on a violation re-encode at
        a halved absolute bound, checked against the ORIGINAL bound, up to
        ``_REPAIR_ATTEMPTS`` times, then raise :class:`BoundViolationError`.
        The outcome lands in ``last_telemetry["verify"]``."""
        sp = self.spec
        if sp.verify == "off":
            return buf
        tel = self._telemetry()
        with span("compress.verify"):
            max_err, checked = self._verify_check(x, buf)
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
            inner = Compressor(dataclasses.replace(sp, eb_mode="abs", eb=cur, psnr_target=None, verify="off"),
                               device=self.device)
            buf = inner.compress(x)
            max_err, checked = self._verify_check(x, buf)
        tel["verify"] = {"mode": sp.verify, "checked": checked, "max_err": max_err,
                         "bound": bound, "repairs": repairs}
        return buf

    # ------------------------------------------------------------- inspect
    @staticmethod
    def inspect(buf: bytes) -> dict:
        """Container header + section sizes, without decompressing (v1/v2)."""
        header, sections = _sections_unpack(buf)
        out = dict(header, section_bytes=[len(s) for s in sections])
        if header.get("mode") in ("pw_rel", "nfsafe"):  # section 0 is a full inner container
            out["inner"] = Compressor.inspect(bytes(sections[0]))
        if header.get("mode") == "interp" and header.get("predictor") == "auto" and "splines" in header:
            out["pplan"] = {"ndim": len(header["padded"]), "anchor_stride": int(header["anchor_stride"]),
                            "splines": list(header["splines"]), "schemes": list(header["schemes"])}
        return out

    # ------------------------------------------------------------ decompress
    def decompress(self, buf: bytes, *, out: str = "numpy"):
        """Decompress a v1/v2 container.

        ``out="numpy"`` returns a host ndarray; ``out="device"`` a tensor on
        the compressor's device (a CUDA tensor on the card). Records
        ``last_telemetry["decode"]`` (engine, out, seconds, bytes, MB/s).
        """
        if out not in ("numpy", "device"):
            raise ValueError(f"out must be 'numpy' or 'device', got {out!r}")
        hold = self._hold
        if not hold:
            self.last_telemetry = None
        tel = self._telemetry()
        t0 = time.perf_counter()
        header, sections = _sections_unpack(buf)
        result = self._decompress_sections(header, sections, tel)
        if out == "numpy":
            result = result.cpu().numpy()
        if not hold:
            self._sync()
            dt = time.perf_counter() - t0
            nbytes = int(result.nbytes) if isinstance(result, np.ndarray) else result.numel() * result.element_size()
            tel["decode"] = {"engine": "device" if self._device_engine else "numpy", "out": out,
                             "seconds": dt, "bytes": nbytes, "mbps": (nbytes / dt / 1e6) if dt > 0 else 0.0}
        return result

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
        if mode in ("offset1d", "pw_rel", "nfsafe", "nonfinite"):
            raise NotPortedError(f"container mode {mode!r}")
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
def cusz_hi_cr(eb=1e-3, *, device=None, **kw) -> Compressor:
    return Compressor(CompressorSpec(eb=eb, pipeline="cr", **kw), device=device)


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


def fzgpu_like(eb=1e-3, *, device=None) -> Compressor:
    """FZ-GPU-like baseline: Lorenzo + bitshuffle + de-redundancy."""
    return Compressor(CompressorSpec(eb=eb, predictor="lorenzo", pipeline="fz"), device=device)
