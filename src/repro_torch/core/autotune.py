"""Data-adaptive interpolation tuning (paper §5.1.3), the lossy half of the
synergistic orchestration. Two tuners, as in the JAX package
(``repro.core.autotune``):

* :func:`autotune`, the legacy per-level (spline x scheme) argmin of the
  summed absolute prediction error over a uniform sample of blocks, with
  quantization feedback between levels; the default spec
  (``predictor="interp", autotune=True``) runs it, as plain torch on the
  caller's device. Its trial pass divides by ``twoeb`` where the
  predictor's quantizer multiplies by ``1/twoeb``, as the JAX package
  writes them; its error sums are float32 reductions whose order differs
  between frameworks, so a near-tie may break the other way.
* :func:`autotune_plan`, the planner behind ``predictor="auto"``: per
  candidate anchor stride, a greedy per-level sweep over every spline x
  scheme, each level scored by the entropy of its quantization codes (the
  orchestrator's cost model, repro_torch.core.lossless.orchestrate), then
  every uniform configuration, then trial encodes of the best-scored
  candidates through the real pipeline. It emits a :class:`PredictorPlan`.

Every trial pass of the planner is one call of the interp encode kernel
(repro_torch.kernels.interp3d.compress_blocks, the plain predictor on a
CPU tensor) over the sampled blocks, and every code histogram one call of
histogram256. The kernel takes a full step hierarchy, so the candidate at
level l runs behind the levels already chosen and in front of its own
(spline, scheme) repeated down to level 1; level l's codes are then read
at level l's points, which later levels never change. At level 0 these
hierarchies are the uniform configurations themselves, and at the last
level the winner's is the greedy plan's, so one stride costs
(levels x candidates) launches. The emits, scores and plan are the JAX
package's wherever the codes agree.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..kernels import interp3d as _interp
from ..kernels.histogram import histogram256
from . import blocks as _blk
from .lossless import pipelines as _pipelines
from .lossless.orchestrate import histogram_stats
from .predictor import RADIUS, _predict, _StepTensors, anchor_mask, f32
from .reorder import reorder_codes_batch_t
from .serial import pack_obj, unpack_obj
from .stencils import SCHEMES, SPLINES, build_steps, levels_for_stride

SAMPLE_FRACTION = 0.002
MIN_SAMPLE_BLOCKS = 8
EXHAUSTIVE_BLOCKS = 64       # sample every block of a field this small
ANCHOR_BITS = 32             # anchors are stored as raw float32
OUTLIER_BITS = 96            # i64 index + f32 value per outlier
DEFAULT_STRIDES = (16, 8)    # candidate anchor strides of predictor="auto"


def legacy_sample_indices(nb: int) -> np.ndarray:
    """Block indices :func:`autotune` samples out of ``nb`` blocks."""
    ns = min(nb, max(MIN_SAMPLE_BLOCKS, int(round(SAMPLE_FRACTION * nb))))
    return np.linspace(0, nb - 1, ns).astype(np.int64)


def _level_pass(recon: torch.Tensor, orig: torch.Tensor, twoeb: torch.Tensor, steps):
    """Run one level's steps; return (new_recon, sum |orig-pred| over targets)."""
    err = torch.zeros((), dtype=torch.float32, device=orig.device)
    zero = torch.zeros((), dtype=torch.float32, device=orig.device)
    for step in steps:
        st = _StepTensors(step, orig.device)
        pred = _predict(recon, st)
        err = err + torch.sum(torch.where(st.mask, torch.abs(orig - pred), zero))
        q = torch.round((orig - pred) / twoeb)
        outl = torch.abs(q) > RADIUS
        rec = torch.where(outl, orig, pred + q * twoeb)
        recon = torch.where(st.mask, rec, recon)
    return recon, err


def autotune(blocks: torch.Tensor, twoeb: float, levels=(8, 4, 2, 1), anchor_every: int = 16,
             presampled: bool = False):
    """Per-level (spline x scheme) argmin of absolute error.

    blocks: (nb, B..) tensor. Returns (splines, schemes) tuples, one entry
    per level. Ties keep the first candidate in (spline, scheme) order.
    ``presampled=True``: ``blocks`` already are the
    :func:`legacy_sample_indices` sample.
    """
    ndim = blocks.dim() - 1
    B = int(blocks.shape[1])
    if presampled:
        sample = blocks
    else:
        idx = torch.from_numpy(legacy_sample_indices(int(blocks.shape[0]))).to(blocks.device)
        sample = blocks.index_select(0, idx)
    am = torch.from_numpy(anchor_mask(tuple(sample.shape[1:]), anchor_every)).to(blocks.device)
    recon = torch.where(am, sample, torch.zeros((), dtype=torch.float32, device=blocks.device))
    tw = f32(twoeb, blocks.device)
    chosen_splines, chosen_schemes = [], []
    for s in levels:
        best = None
        for spline in SPLINES:
            for scheme in SCHEMES:
                steps = build_steps(ndim, B, (s,), (spline,), (scheme,))
                _, err = _level_pass(recon, sample, tw, steps)
                err = float(err)
                if best is None or err < best[0]:
                    best = (err, spline, scheme)
        _, spline, scheme = best
        chosen_splines.append(spline)
        chosen_schemes.append(scheme)
        recon, _ = _level_pass(recon, sample, tw, build_steps(ndim, B, (s,), (spline,), (scheme,)))
    return tuple(chosen_splines), tuple(chosen_schemes)


def candidate_splines() -> tuple[str, ...]:
    return SPLINES


def candidate_schemes(ndim: int) -> tuple[str, ...]:
    """"md" and the two extreme sequential orderings (one sweep in 1-D)."""
    if ndim <= 1:
        return ("md",)
    fwd = "1d-" + "".join(map(str, range(ndim)))
    rev = "1d-" + "".join(map(str, reversed(range(ndim))))
    return ("md", fwd, rev)


def fixed_step_baselines(nlev: int = 4) -> dict:
    """Uniform fixed-steps configurations (CompressorSpec keywords) that
    ``predictor="auto"`` must match or beat."""
    return {
        "cubic-md": dict(splines=("cubic",) * nlev, schemes=("md",) * nlev),
        "linear-md": dict(splines=("linear",) * nlev, schemes=("md",) * nlev),
        "cubic-1d": dict(splines=("cubic",) * nlev, schemes=("1d",) * nlev),
        "natural-cubic-md": dict(splines=("natural-cubic",) * nlev, schemes=("md",) * nlev),
    }


@dataclasses.dataclass(frozen=True)
class PredictorPlan:
    """Per-field interpolation plan emitted by :func:`autotune_plan`.

    ``splines`` / ``schemes`` hold one entry per level (largest stride
    first); ``est_bits_per_code`` is the winner's score; ``candidates`` the
    scored alternatives ``((label, bits per code), ...)``.
    """

    ndim: int
    anchor_stride: int
    splines: tuple[str, ...]
    schemes: tuple[str, ...]
    est_bits_per_code: float = 0.0
    sampled_blocks: int = 0
    candidates: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "splines", tuple(self.splines))
        object.__setattr__(self, "schemes", tuple(self.schemes))
        object.__setattr__(self, "candidates", tuple(tuple(c) for c in self.candidates))
        if len(self.splines) != len(self.levels) or len(self.schemes) != len(self.levels):
            raise ValueError(f"plan needs {len(self.levels)} per-level entries for anchor_stride="
                             f"{self.anchor_stride}, got splines={self.splines} schemes={self.schemes}")

    @property
    def levels(self) -> tuple[int, ...]:
        return levels_for_stride(self.anchor_stride)

    def __str__(self) -> str:
        """Compact display form, e.g. ``s16:linear/1d-012,cubic/md,...``."""
        return f"s{self.anchor_stride}:" + ",".join(f"{sp}/{sc}" for sp, sc in zip(self.splines, self.schemes))

    def steps(self, B: int = 17):
        return build_steps(self.ndim, B, self.levels, self.splines, self.schemes)

    def to_header(self, include_candidates: bool = False) -> dict:
        """Plain-dict form for the container header (repro_torch.core.serial);
        the candidates only on request (kilobytes of labels)."""
        h = {"ndim": int(self.ndim), "anchor_stride": int(self.anchor_stride), "splines": list(self.splines),
             "schemes": list(self.schemes), "est_bits_per_code": float(self.est_bits_per_code),
             "sampled_blocks": int(self.sampled_blocks)}
        if include_candidates:
            h["candidates"] = [[str(lbl), float(bits)] for lbl, bits in self.candidates]
        return h

    @classmethod
    def from_header(cls, h: dict) -> "PredictorPlan":
        return cls(ndim=int(h["ndim"]), anchor_stride=int(h["anchor_stride"]), splines=tuple(h["splines"]),
                   schemes=tuple(h["schemes"]), est_bits_per_code=float(h.get("est_bits_per_code", 0.0)),
                   sampled_blocks=int(h.get("sampled_blocks", 0)),
                   candidates=tuple((lbl, bits) for lbl, bits in h.get("candidates", ())))

    def to_bytes(self) -> bytes:
        """Compact binary form (repro_torch.core.serial), as a plan-cache entry carries it."""
        return pack_obj(self.to_header())

    @classmethod
    def from_bytes(cls, buf: bytes) -> "PredictorPlan":
        return cls.from_header(unpack_obj(buf))


# ---------------------------------------------------------- plan-cache keys
_SIG_VERSION = "ps1"        # bumped when the signature's meaning changes
_STATS_SAMPLE_CAP = 65536   # stats-bucket subsample size (uniform stride)
_STD_BUCKET_QUARTERS = 4    # std bucket resolution: quarter powers of two


def stats_bucket(x) -> tuple[int, int]:
    """Coarse distribution bucket of a field for plan-cache keys: the
    power-of-two exponent of its value range and its range-normalized
    standard deviation in quarter powers of two. A tensor's strided
    subsample (<= ``_STATS_SAMPLE_CAP`` points) is read to the host, so the
    bucket is the JAX package's numpy arithmetic exactly."""
    flat = x.reshape(-1)
    n = int(flat.numel()) if isinstance(flat, torch.Tensor) else flat.size
    if n == 0:
        return (0, 0)
    if n > _STATS_SAMPLE_CAP:
        flat = flat[:: max(1, n // _STATS_SAMPLE_CAP)]
    if isinstance(flat, torch.Tensor):
        flat = flat.cpu().numpy()
    lo = float(np.min(flat))
    rng = float(np.max(flat)) - lo
    if not math.isfinite(rng) or rng <= 0.0:
        return (-(1 << 20), 0)  # constant (or non-finite) field: its own bucket
    b_rng = math.frexp(rng)[1]
    rel_std = float(np.std(flat)) / rng
    if rel_std <= 0.0:
        return (b_rng, -(1 << 20))
    return (b_rng, int(round(_STD_BUCKET_QUARTERS * math.log2(rel_std))))


def plan_signature(shape, dtype, eb: float, eb_mode: str, bucket=(), *, extra=()) -> tuple:
    """Hashable plan-cache key: field geometry, error-bound config, coarse
    stats bucket and the caller's extras (the spec knobs that steer the
    tuners)."""
    return (_SIG_VERSION, tuple(int(s) for s in shape), np.dtype(dtype).str, float(eb), str(eb_mode),
            tuple(bucket), tuple(extra))


# ------------------------------------------------------------------ planner
def plan_sample_indices(nb: int) -> np.ndarray:
    """Block indices :func:`autotune_plan` samples out of ``nb`` blocks:
    all of them up to ``EXHAUSTIVE_BLOCKS``, else a uniform sample."""
    if nb <= EXHAUSTIVE_BLOCKS:
        return np.arange(nb, dtype=np.int64)
    ns = min(nb, max(MIN_SAMPLE_BLOCKS, int(round(SAMPLE_FRACTION * nb))))
    return np.linspace(0, nb - 1, ns).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _level_points(ndim: int, stride: int) -> tuple[np.ndarray, ...]:
    """Per level (largest first), the flat block indices of its target
    points, ascending: the union of the level's step masks (the same for
    every spline and scheme)."""
    levels = levels_for_stride(stride)
    steps = build_steps(ndim, _blk.BLOCK, levels, ("linear",) * len(levels), ("md",) * len(levels))
    out = []
    for s in levels:
        m = np.zeros((_blk.BLOCK,) * ndim, bool)
        for st in steps:
            if st.level == s:
                m |= st.mask
        out.append(np.flatnonzero(m.reshape(-1)))
    return tuple(out)


def _level_emits(codes: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """One level's codes out of (ns, B**ndim) full-hierarchy codes, block-major
    then row-major: the JAX package's ``_level_emits`` of that level's grid."""
    return codes.index_select(1, points).reshape(-1)


def _code_bits(hist, n_outliers: int) -> float:
    """Estimated encoded bits of a code stream with byte counts ``hist``: its
    entropy (the orchestrator's cost model) plus the outliers' raw storage."""
    hist = np.asarray(hist, np.int64)
    n = int(hist.sum())
    if n == 0:
        return 0.0
    return n * histogram_stats(hist)["entropy"] + int(n_outliers) * OUTLIER_BITS


def _hist(t: torch.Tensor) -> np.ndarray:
    return histogram256(t).cpu().numpy()


def _anchor_count(field_shape, sample_shape, n_blocks: int, stride: int) -> int:
    """Anchors the container will store: exact from the (batch, *padded)
    field shape, else counted per block over all ``n_blocks`` blocks."""
    if field_shape is not None:
        per = 1
        for d in field_shape[1:]:
            per *= (d - 1) // stride + 1
        return int(field_shape[0]) * per
    return n_blocks * int(np.count_nonzero(anchor_mask(tuple(sample_shape), stride)))


def _hierarchy_codes(sample: torch.Tensor, twoeb: float, stride: int, config) -> torch.Tensor:
    """Codes (ns, B**ndim) of one full step hierarchy, ``config`` one
    (spline, scheme) per level: one launch of the interp encode."""
    ndim = sample.dim() - 1
    levels = levels_for_stride(stride)
    steps = build_steps(ndim, _blk.BLOCK, levels, tuple(c[0] for c in config), tuple(c[1] for c in config))
    codes, _ = _interp.compress_blocks(sample, twoeb, steps, stride, with_recon=False)
    return codes.reshape(int(sample.shape[0]), -1)


def _sweep(sample: torch.Tensor, twoeb: float, stride: int):
    """Greedy per-level sweep with quantization feedback. Returns the greedy
    config, its codes and the codes of every uniform config."""
    ndim = sample.dim() - 1
    pts = [torch.from_numpy(p).to(sample.device) for p in _level_points(ndim, stride)]
    cands = [(sp, sc) for sp in candidate_splines() for sc in candidate_schemes(ndim)]
    chosen: list[tuple[str, str]] = []
    uniform: dict = {}
    best = None
    for li in range(len(pts)):
        best = None
        for cand in cands:
            codes = _hierarchy_codes(sample, twoeb, stride, tuple(chosen) + (cand,) * (len(pts) - li))
            if li == 0:
                uniform[cand] = codes
            hist = _hist(_level_emits(codes, pts[li]))
            bits = _code_bits(hist, int(hist[0]))
            if best is None or bits < best[0]:
                best = (bits, cand, codes)
        chosen.append(best[1])
    return tuple(chosen), best[2], uniform, pts


def autotune_plan(blocks: torch.Tensor, twoeb: float, anchor_strides: tuple[int, ...] = DEFAULT_STRIDES,
                  field_shape: tuple[int, ...] | None = None, trial_pipeline: str = "cr", max_trials: int = 6,
                  reorder: bool = True, presampled_of: int | None = None) -> PredictorPlan:
    """The planner behind ``predictor="auto"`` (the JAX package's
    ``autotune_plan``).

    blocks: (nb, B..) f32 blocks on the device the trials run on;
    ``field_shape``: the (batch, *padded) shape, for an exact anchor count
    and, when every block is sampled, trial streams built through the real
    block scatter and level reorder. ``presampled_of=N``: ``blocks`` already
    are the :func:`plan_sample_indices` sample of an N-block field.

    Per candidate stride: the greedy per-level plan and every uniform
    (spline, scheme) configuration, pre-scored by the entropy of their codes
    plus outlier and anchor storage; then the ``max_trials`` best are
    trial-encoded through ``trial_pipeline`` and the smallest total wins.
    """
    ndim = blocks.dim() - 1
    B = int(blocks.shape[1])
    if presampled_of is not None:
        nb, sample = int(presampled_of), blocks
    else:
        nb = int(blocks.shape[0])
        sample = blocks if nb <= EXHAUSTIVE_BLOCKS else blocks.index_select(
            0, torch.from_numpy(plan_sample_indices(nb)).to(blocks.device))
    sample = sample.to(torch.float32).contiguous()
    ns = int(sample.shape[0])
    scale = nb / ns  # sampled code bits -> full-field code bits
    n_points = nb * B**ndim  # normalization only; comparisons use totals
    exact = ns == nb and field_shape is not None
    cands: list[dict] = []

    def consider(stride, config, codes, pts, anchor_bits, tag):
        seq = torch.cat([_level_emits(codes, p) for p in pts])
        hist = _hist(seq)
        cands.append({
            "label": f"{tag}:stride{stride}:" + ",".join(f"{sp}/{sc}" for sp, sc in config),
            "stride": stride, "splines": tuple(c[0] for c in config), "schemes": tuple(c[1] for c in config),
            # anchors keep code 128, the JAX package's fill of the combined grid
            "seq": seq, "combined": codes if exact else None, "n_out": int(hist[0]),
            "anchor_bits": anchor_bits,
            "est": (anchor_bits + _code_bits(hist, int(hist[0])) * scale) / max(n_points, 1),
        })

    for stride in anchor_strides:
        anchor_bits = _anchor_count(field_shape, sample.shape[1:], nb, stride) * ANCHOR_BITS
        greedy, g_codes, uniform, pts = _sweep(sample, twoeb, stride)
        consider(stride, greedy, g_codes, pts, anchor_bits, "greedy")
        for cand, codes in uniform.items():
            config = (cand,) * len(pts)
            if config != greedy:  # else already scored as the greedy plan
                consider(stride, config, codes, pts, anchor_bits, "uniform")

    order = sorted(cands, key=lambda c: (c["est"], c["label"]))[: max(1, max_trials)]
    batch = int(field_shape[0]) if field_shape is not None else 1
    for c in order:
        if exact:  # the realized stream: block scatter and level reorder, as the compressor's encode
            cgrid = _blk.scatter_blocks_batch_t(c["combined"].reshape(sample.shape), batch,
                                                tuple(field_shape[1:]), B - 1)
            seq = reorder_codes_batch_t(cgrid, c["stride"], reorder)
            n_out = int((seq == 0).sum())
        else:
            seq, n_out = c["seq"], c["n_out"]
        code_bits = 8.0 * len(_pipelines.encode(seq, trial_pipeline)) + n_out * OUTLIER_BITS
        c["trial"] = (c["anchor_bits"] + code_bits * (1.0 if exact else scale)) / max(n_points, 1)
    winner = min(order, key=lambda c: (c["trial"], c["label"]))
    return PredictorPlan(ndim=ndim, anchor_stride=winner["stride"], splines=winner["splines"],
                         schemes=winner["schemes"], est_bits_per_code=winner["trial"], sampled_blocks=ns,
                         candidates=tuple((c["label"], c.get("trial", c["est"])) for c in cands))
