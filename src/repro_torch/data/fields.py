"""Synthetic scientific fields for the compressor benchmarks (6 families).

Real SDRBench files are not redistributable in this container; these
generators produce spectrally-shaped random fields whose roughness/
anisotropy mimics each dataset family (benchmarks accept --data-dir to use
real files instead). Spectral synthesis: white noise filtered by a
power-law |k|^-alpha spectrum; higher alpha -> smoother (more compressible).
"""
from __future__ import annotations

import numpy as np


def _spectral_field(shape, alpha, seed, aniso=None):
    rng = np.random.default_rng(seed)
    white = rng.standard_normal(shape).astype(np.float32)
    F = np.fft.rfftn(white)
    ks = np.meshgrid(*[np.fft.fftfreq(n) for n in shape[:-1]] + [np.fft.rfftfreq(shape[-1])], indexing="ij")
    if aniso is None:
        aniso = (1.0,) * len(shape)
    k2 = sum((a * k) ** 2 for a, k in zip(aniso, ks))
    filt = (k2 + 1e-6) ** (-alpha / 2.0)
    filt.flat[0] = 0.0
    out = np.fft.irfftn(F * filt, s=shape).astype(np.float32)
    out /= max(np.abs(out).max(), 1e-12)
    return out


DATASETS = {
    # name: (shape, generator)
    "cesm": ((1800, 3600), lambda s: _spectral_field((1800, 3600), 2.2, s, aniso=(1.0, 1.0))),
    "jhtdb": ((256, 256, 256), lambda s: _spectral_field((256, 256, 256), 1.9, s)),          # turbulence: ~k^-5/3 energy
    "miranda": ((256, 384, 384), lambda s: np.tanh(4 * _spectral_field((256, 384, 384), 2.6, s))),  # sharp hydro interfaces
    "nyx": ((256, 256, 256), lambda s: np.exp(2.0 * _spectral_field((256, 256, 256), 2.0, s))),     # lognormal density
    "qmcpack": ((64, 115, 69, 69), lambda s: _spectral_field((64, 115, 69, 69), 1.6, s)),
    "rtm": ((256, 256, 235), lambda s: _spectral_field((256, 256, 235), 2.4, s, aniso=(2.0, 1.0, 1.0))),
}


def get_field(name: str, seed: int = 0) -> np.ndarray:
    shape, gen = DATASETS[name]
    return gen(seed)


def load_or_generate(name: str, data_dir: str | None = None, seed: int = 0) -> np.ndarray:
    if data_dir:
        import pathlib

        for f in sorted(pathlib.Path(data_dir).glob(f"{name}*")):
            if f.suffix in (".f32", ".dat", ".bin"):
                return np.fromfile(f, np.float32).reshape(DATASETS[name][0])
    return get_field(name, seed)


def predictor_suite(side: int = 48) -> dict:
    """Synthetic field suite for the predictor-autotuning dimension: one
    stream class per regime a spline/scheme/stride choice discriminates
    (smooth spectra, exact ramps, axis anisotropy, additive noise,
    sparse impulses). Shared by benchmarks.bench_lossless and the
    auto-vs-fixed CR-floor tests so the gate always matches the
    published suite."""
    rng = np.random.default_rng(11)
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, side)] * 3, indexing="ij"))
    smooth = (np.sin(g[0] * 6.3) * np.cos(g[1] * 5.1) + 0.5 * np.sin(g[2] * 9.9 + g[0] * 3)).astype(np.float32)
    return {
        "smooth": smooth,
        "ramp": (2.0 * g[0] - 0.7 * g[1] + 0.3 * g[2]).astype(np.float32),
        "aniso": (np.sin(g[0] * 40.0) + 0.01 * g[1] + 0.01 * g[2]).astype(np.float32),
        "noisy": (smooth + 0.05 * rng.standard_normal((side,) * 3)).astype(np.float32),
        "sparse": np.where(rng.random((side,) * 3) < 0.01, rng.standard_normal((side,) * 3), 0.0).astype(np.float32),
    }
