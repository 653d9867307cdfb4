"""Compression quality metrics (paper §6.1.4), the JAX package's
(``repro.core.metrics``) on numpy arrays and torch tensors.

``value_range``, ``max_abs_err``, ``psnr`` and ``compression_ratio`` take
the host route: numpy float64 arithmetic over the jointly-finite points,
as in the JAX package (a tensor is copied to the host first), so they give
its floats exactly. ``nonfinite_count``, ``max_rel_err``, ``bit_rate``,
``ssim``, ``spectral_error`` and ``quality_report`` run as torch float64
arithmetic on the tensor's device (a numpy array: on the CPU).

Non-finite points follow the JAX package's rules: the flat metrics skip
points where either field is non-finite; ``ssim`` and ``spectral_error``
replace them in both fields by the finite mean of ``orig`` (0.0 where
nothing is finite), so that they add no structural difference; and
``quality_report`` counts them under ``n_nonfinite``.
"""
from __future__ import annotations

import numpy as np
import torch


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


# ------------------------------------------------------------ on the device
def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def nonfinite_count(orig, recon=None) -> int:
    """Points the metrics mask out: non-finite in ``orig`` or (when given)
    in ``recon``."""
    bad = ~torch.isfinite(_t(orig))
    if recon is not None:
        bad = bad | ~torch.isfinite(_t(recon))
    return int(bad.sum())


def max_rel_err(orig, recon) -> float:
    """Max point-wise relative error ``|x - x'| / |x|`` over the nonzero
    points of ``orig`` (what ``eb_mode="pw_rel"`` bounds); a zero point
    reconstructed nonzero gives ``inf``; non-finite points are masked out."""
    a, b = _t(orig), _t(recon)
    if not a.numel():
        return 0.0
    a, b = a.reshape(-1).to(torch.float64), b.reshape(-1).to(a.device, torch.float64)
    m = torch.isfinite(a) & torch.isfinite(b)
    a, b = a[m], b[m]
    if not a.numel():
        return 0.0
    nz = a != 0.0
    if bool((~nz).any()) and bool((b[~nz] != 0.0).any()):
        return float("inf")
    if bool(nz.any()):
        return float(((a[nz] - b[nz]).abs() / a[nz].abs()).max())
    return 0.0


def bit_rate(orig, compressed: bytes) -> float:
    """Bits per element (32 / CR for float32); 0.0 for an empty field."""
    n = _t(orig).numel()
    return 0.0 if n == 0 else 8.0 * len(compressed) / n


def _scale(a: torch.Tensor) -> float:
    """The normalizer of psnr and ssim: the finite range, else the peak
    magnitude, else 1.0 (``a`` float64)."""
    fin = a[torch.isfinite(a)]
    if not fin.numel():
        return 1.0
    rng = float(fin.max() - fin.min())
    if rng > 0:
        return rng
    peak = float(fin.abs().max())
    return peak if peak > 0 else 1.0


def _neutralized_pair(orig: torch.Tensor, recon: torch.Tensor):
    """float64 copies with the points where either is non-finite set to the
    finite mean of ``orig`` (0.0 when nothing is finite)."""
    a = orig.to(torch.float64)
    b = recon.to(a.device, torch.float64)
    m = torch.isfinite(a) & torch.isfinite(b)
    if bool(m.all()):
        return a, b
    fa = torch.isfinite(a)
    fill = float(a[fa].mean()) if bool(fa.any()) else 0.0
    return torch.where(m, a, fill), torch.where(m, b, fill)


def _win_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    """Moving average over a ``win``-wide window along every axis (valid
    region), by differences of cumulative sums."""
    for ax in range(x.dim()):
        c = torch.cumsum(x, dim=ax, dtype=torch.float64)
        pad = list(c.shape)
        pad[ax] = 1
        c = torch.cat([torch.zeros(pad, dtype=c.dtype, device=c.device), c], dim=ax)
        x = (c.narrow(ax, win, c.shape[ax] - win) - c.narrow(ax, 0, c.shape[ax] - win)) / win
    return x


def ssim(orig, recon, *, window: int = 7) -> float:
    """Mean SSIM-style index over an N-d uniform ``window``-wide box
    (shrunk to the field where it is smaller), with the stabilizers
    ``C1 = (0.01 L)^2`` and ``C2 = (0.03 L)^2``, ``L`` the range of
    ``orig`` (its peak magnitude when constant). Identical fields give 1.0."""
    a, b = _t(orig), _t(recon)
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 1.0
    L = _scale(a.reshape(-1).to(torch.float64))
    a, b = _neutralized_pair(a, b)
    win = max(1, min(int(window), *a.shape))
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    mu_a, mu_b = _win_mean(a, win), _win_mean(b, win)
    var_a = torch.clamp(_win_mean(a * a, win) - mu_a**2, min=0.0)
    var_b = torch.clamp(_win_mean(b * b, win) - mu_b**2, min=0.0)
    cov = _win_mean(a * b, win) - mu_a * mu_b
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float((num / den).mean())


def _radial_spectrum(x: torch.Tensor, nbins: int) -> torch.Tensor:
    """Mean power per |k| shell of ``x`` (float64), DC excluded."""
    power = torch.fft.rfftn(x).abs() ** 2
    freqs = [torch.fft.fftfreq(n, dtype=torch.float64, device=x.device) for n in x.shape[:-1]]
    freqs.append(torch.fft.rfftfreq(x.shape[-1], dtype=torch.float64, device=x.device))
    k = torch.sqrt(sum(kk**2 for kk in torch.meshgrid(*freqs, indexing="ij")))
    kmax = float(k.max())
    if kmax == 0.0:
        return power.reshape(-1)[:1]
    bins = torch.clamp((k / kmax * nbins).to(torch.int64), max=nbins - 1).reshape(-1)
    keep = k.reshape(-1) > 0  # DC carries the mean, not structure
    p = power.reshape(-1)[keep]
    sums = torch.zeros(nbins, dtype=torch.float64, device=x.device).index_add_(0, bins[keep], p)
    counts = torch.bincount(bins[keep], minlength=nbins)
    nz = counts > 0
    return sums[nz] / counts[nz]


def spectral_error(orig, recon, *, nbins: int = 32) -> float:
    """Mean absolute log10 ratio of the isotropic power spectra: 0.0 when
    the reconstruction keeps the field's spectrum. Shells below ``1e-20``
    of the peak power are skipped; constant and empty fields score 0.0
    against themselves."""
    a, b = _t(orig), _t(recon)
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() <= 1:
        return 0.0
    a, b = _neutralized_pair(a, b)
    sa, sb = _radial_spectrum(a, nbins), _radial_spectrum(b, nbins)
    peak = float(sa.max()) if sa.numel() else 0.0
    floor = peak * 1e-20 if peak > 0 else 0.0
    keep = sa > floor
    if not bool(keep.any()):
        return 0.0 if not bool((sb > floor).any()) else float("inf")
    ratio = (sb[keep] + floor) / (sa[keep] + floor) if floor > 0 else sb[keep] / sa[keep]
    return float(torch.log10(torch.clamp(ratio, min=1e-300)).abs().mean())


def quality_report(orig, recon, compressed: bytes | None = None) -> dict:
    """Every quality metric of one (field, reconstruction) pair, the JAX
    package's row: psnr, ssim, spectral_error, max_abs_err, max_rel_err,
    n_nonfinite, and with ``compressed`` cr and bit_rate."""
    out = {"psnr": psnr(orig, recon), "ssim": ssim(orig, recon), "spectral_error": spectral_error(orig, recon),
           "max_abs_err": max_abs_err(orig, recon), "max_rel_err": max_rel_err(orig, recon),
           "n_nonfinite": nonfinite_count(orig, recon)}
    if compressed is not None:
        out["cr"] = compression_ratio(orig, compressed)
        out["bit_rate"] = bit_rate(orig, compressed)
    return out
