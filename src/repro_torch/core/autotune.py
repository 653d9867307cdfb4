"""Legacy spline autotuner (paper §5.1.3), plain torch on the caller's device.

:func:`autotune` picks, per level, the (spline x scheme) pair with the
smallest summed absolute prediction error over a uniform sample of blocks,
with quantization feedback between levels. It is what
``CompressorSpec(predictor="interp", autotune=True)`` — the default spec —
runs before the predictor. The per-level planner behind
``predictor="auto"`` is not ported yet.

Its trial pass divides by ``twoeb`` where the predictor's quantizer
multiplies by ``1/twoeb``; both are kept as the JAX package writes them.
The error sums are float32 reductions, whose order differs between
frameworks, so a near-tie between two candidates may break the other way.
"""
from __future__ import annotations

import numpy as np
import torch

from .predictor import RADIUS, _predict, _StepTensors, anchor_mask, f32
from .stencils import SCHEMES, SPLINES, build_steps

SAMPLE_FRACTION = 0.002
MIN_SAMPLE_BLOCKS = 8
DEFAULT_STRIDES = (16, 8)    # candidate anchor strides of predictor="auto" (spec grammar)


def levels_for_stride(stride: int) -> tuple[int, ...]:
    lv, s = [], stride // 2
    while s >= 1:
        lv.append(s)
        s //= 2
    return tuple(lv)


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


def autotune(blocks: torch.Tensor, twoeb: float, levels=(8, 4, 2, 1), anchor_every: int = 16):
    """Per-level (spline x scheme) argmin of absolute error.

    blocks: (nb, B..) tensor. Returns (splines, schemes) tuples, one entry
    per level. Ties keep the first candidate in (spline, scheme) order.
    """
    ndim = blocks.dim() - 1
    B = int(blocks.shape[1])
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
