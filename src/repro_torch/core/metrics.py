"""Compression quality metrics (paper §6.1.4): the rate/distortion pair.

Numpy arithmetic in float64 over the jointly-finite points, as in the JAX
package; torch tensors are accepted and copied to the host first.
"""
from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):  # torch.Tensor on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


def value_range(x) -> float:
    """max - min over the finite points, in float64; 0.0 when none."""
    x = _host(x)
    if not x.size:
        return 0.0
    xf = np.asarray(x, np.float64).reshape(-1)
    xf = xf[np.isfinite(xf)]
    return float(xf.max() - xf.min()) if xf.size else 0.0


def max_abs_err(a, b) -> float:
    a, b = _host(a), _host(b)
    if not a.size:
        return 0.0
    x = a.astype(np.float64).reshape(-1)
    y = b.astype(np.float64).reshape(-1)
    m = np.isfinite(x) & np.isfinite(y)
    return float(np.max(np.abs(x[m] - y[m]))) if m.any() else 0.0


def _psnr_scale(orig: np.ndarray) -> float:
    rng = value_range(orig)
    if rng > 0:
        return rng
    fin = orig[np.isfinite(orig)] if orig.size else orig
    peak = float(np.max(np.abs(fin.astype(np.float64)))) if fin.size else 0.0
    return peak if peak > 0 else 1.0


def psnr(orig, recon) -> float:
    """Range-normalized PSNR in dB; ``inf`` for a perfect reconstruction."""
    orig, recon = _host(orig), _host(recon)
    if not orig.size:
        return float("inf")
    a = orig.astype(np.float64).reshape(-1)
    b = recon.astype(np.float64).reshape(-1)
    m = np.isfinite(a) & np.isfinite(b)
    if not m.any():
        return float("inf")
    d = a[m] - b[m]
    mse = float(np.mean(d * d))
    if mse == 0.0:
        return float("inf")
    return 20.0 * np.log10(_psnr_scale(orig)) - 10.0 * np.log10(mse)


def compression_ratio(orig, compressed: bytes) -> float:
    nbytes = orig.nbytes if isinstance(orig, np.ndarray) else orig.numel() * orig.element_size()
    return nbytes / max(1, len(compressed))
