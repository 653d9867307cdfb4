"""The port's quality metrics against the JAX package's (repro.core.metrics)
on the same numpy inputs, and as torch tensors.

Exact: ``nonfinite_count``, ``max_rel_err`` (a float64 max of the same
IEEE quotients), ``bit_rate`` and the host metrics ``value_range``,
``max_abs_err``, ``psnr``, ``compression_ratio``. Within ``RTOL = 1e-9``:
``ssim`` (float64 cumulative sums and a mean, summed in another order than
numpy's) and ``spectral_error`` (torch's FFT against numpy's pocketfft and
a float64 index_add in place of ``np.bincount``); both are means of
float64 terms of order one, so summation order moves them by far less.
"""
import numpy as np
import pytest
import torch

from repro.core import metrics as rm
from repro_torch.core import metrics as tm

RTOL = 1e-9


def _smooth(shape, seed=0):
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 3 * np.pi, n) for n in shape], indexing="ij")
    x = np.sin(grids[0]) + 0.5 * np.cos(grids[-1]) + 0.05 * rng.standard_normal(shape)
    return x.astype(np.float32)


def _case(name):
    rng = np.random.default_rng(11)
    if name == "smooth3d":
        x = _smooth((18, 20, 22))
    elif name == "smooth2d":
        x = _smooth((40, 33))
    elif name == "smooth1d":
        x = _smooth((301,))
    elif name == "small":  # smaller than the ssim window along an axis
        x = _smooth((3, 40, 5))
    elif name == "constant":
        x = np.full((6, 7), 2.5, np.float32)
        return x, x.copy()
    elif name == "zeros":
        x = np.zeros((9, 9), np.float32)
        return x, (x + np.float32(1e-3)).astype(np.float32)
    elif name == "nonfinite":
        x = _smooth((16, 17))
        x[2, 3], x[5, 5], x[7, 1] = np.nan, np.inf, -np.inf
    elif name == "all_nonfinite":
        x = np.full((4, 5), np.nan, np.float32)
        return x, x.copy()
    elif name == "empty":
        x = np.zeros((0, 4), np.float32)
        return x, x.copy()
    elif name == "zero_points":  # pw_rel-style: exact zeros, one decoded off zero
        x = _smooth((12, 13))
        x[::3] = 0.0
        y = (x * (1 + 1e-4 * rng.standard_normal(x.shape))).astype(np.float32)
        y[3, 4] = 1e-6
        return x, y
    else:
        raise ValueError(name)
    y = (x + rng.normal(0, 1e-3, x.shape)).astype(np.float32)
    if name == "nonfinite":
        y[1, 1] = np.nan
    return x, y


CASES = ("smooth3d", "smooth2d", "smooth1d", "small", "constant", "zeros", "nonfinite", "all_nonfinite", "empty",
         "zero_points")


def _close(a: float, b: float) -> bool:
    if np.isinf(a) or np.isinf(b) or np.isnan(a) or np.isnan(b):
        return a == b or (np.isnan(a) and np.isnan(b))
    return abs(a - b) <= RTOL * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("tensor", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_metrics_match_the_reference(case, tensor):
    x, y = _case(case)
    a, b = (torch.from_numpy(x), torch.from_numpy(y)) if tensor else (x, y)
    buf = b"\0" * 113
    assert tm.nonfinite_count(a, b) == rm.nonfinite_count(x, y)
    assert tm.nonfinite_count(a) == rm.nonfinite_count(x)
    assert tm.max_rel_err(a, b) == rm.max_rel_err(x, y)
    assert tm.bit_rate(a, buf) == rm.bit_rate(x, buf)
    assert _close(tm.ssim(a, b), rm.ssim(x, y))
    assert _close(tm.ssim(a, b, window=3), rm.ssim(x, y, window=3))
    assert _close(tm.spectral_error(a, b), rm.spectral_error(x, y))
    assert _close(tm.spectral_error(a, b, nbins=7), rm.spectral_error(x, y, nbins=7))
    tq, rq = tm.quality_report(a, b, buf), rm.quality_report(x, y, buf)
    assert set(tq) == set(rq)
    for k in rq:
        assert _close(float(tq[k]), float(rq[k])), k


def test_identical_fields_score_perfectly():
    x = torch.from_numpy(_smooth((10, 11, 12)))
    assert tm.ssim(x, x) == pytest.approx(1.0, abs=1e-12)
    assert tm.spectral_error(x, x) == 0.0
    assert tm.max_rel_err(x, x) == 0.0


def test_shape_mismatch_raises_as_the_reference():
    x, y = np.zeros((4, 5), np.float32), np.zeros((5, 4), np.float32)
    for fn in ("ssim", "spectral_error"):
        with pytest.raises(ValueError, match="shape mismatch"):
            getattr(rm, fn)(x, y)
        with pytest.raises(ValueError, match="shape mismatch"):
            getattr(tm, fn)(torch.from_numpy(x), torch.from_numpy(y))
