"""Deterministic "real-field" fixtures: weather/CFD-like structured grids.

The quality metrics (PSNR/SSIM/spectral error) are only meaningful on
fields with real spatial structure — smooth synoptic gradients, fronts,
vortices, plumes — not on the white/spectral noise the predictor suite
uses. These generators build that structure *analytically* (sums of
separable waves, tanh fronts, Gaussian vortices) plus seeded rng detail
smoothed by a cumsum box filter, deliberately avoiding FFT so the bytes
are reproducible across BLAS/FFT builds. The committed fixture
``tests/data/real_fields.npz`` is generated by ``python -m
repro_torch.data.realfields <out.npz>``; tests and the CI quality gate read
the committed file, the bench regenerates on the fly when it is absent.
"""
from __future__ import annotations

import numpy as np

FIXTURE_SEED = 20260808


def _box_smooth(x: np.ndarray, win: int, passes: int = 2) -> np.ndarray:
    """Separable cumsum box filter (repeated => ~Gaussian), same shape.
    Pure sums — deterministic everywhere numpy is."""
    x = x.astype(np.float64)
    for _ in range(passes):
        for ax in range(x.ndim):
            n = x.shape[ax]
            w = max(1, min(win, n))
            pad = [(0, 0)] * x.ndim
            pad[ax] = (w // 2, w - 1 - w // 2)
            xp = np.pad(x, pad, mode="edge")
            c = np.cumsum(xp, axis=ax)
            lead = [slice(None)] * x.ndim
            lag = [slice(None)] * x.ndim
            lead[ax] = slice(w, w + n)
            lag[ax] = slice(0, n)
            zero = [slice(None)] * x.ndim
            zero[ax] = slice(0, 1)
            c = np.concatenate([np.zeros_like(c[tuple(zero)]), c], axis=ax)
            x = (c[tuple(lead)] - c[tuple(lag)]) / w
    return x


def _grid(shape):
    axes = [np.linspace(0.0, 1.0, n) for n in shape]
    return np.meshgrid(*axes, indexing="ij")


def temperature(shape=(96, 128), seed: int = FIXTURE_SEED) -> np.ndarray:
    """2-D synoptic temperature: meridional gradient + planetary waves +
    a sharp tanh front + smoothed mesoscale detail. Kelvin-scaled."""
    y, x = _grid(shape)
    rng = np.random.default_rng(seed)
    base = 300.0 - 40.0 * y
    waves = 6.0 * np.sin(2 * np.pi * (3 * x + 0.7 * y)) * np.cos(2 * np.pi * 1.5 * y)
    front = -8.0 * np.tanh((y - 0.45 - 0.12 * np.sin(2 * np.pi * 2 * x)) / 0.03)
    detail = 1.5 * _box_smooth(rng.standard_normal(shape), 7)
    return (base + waves + front + detail).astype(np.float32)


def pressure(shape=(96, 128), seed: int = FIXTURE_SEED + 1) -> np.ndarray:
    """2-D mean-sea-level pressure: very smooth — a few broad highs/lows
    on a background, in hPa. The 'easy' end of the compressibility range."""
    y, x = _grid(shape)
    rng = np.random.default_rng(seed)
    field = np.full(shape, 1013.0)
    for _ in range(5):
        cy, cx = rng.uniform(0.1, 0.9, 2)
        amp = rng.uniform(-25.0, 25.0)
        sig = rng.uniform(0.12, 0.3)
        field = field + amp * np.exp(-(((y - cy) ** 2 + (x - cx) ** 2) / (2 * sig**2)))
    return field.astype(np.float32)


def vorticity(shape=(64, 64, 64), seed: int = FIXTURE_SEED + 2) -> np.ndarray:
    """3-D CFD-like vorticity magnitude: a handful of Gaussian vortex
    tubes over smoothed fine-grained turbulence. Multi-scale and signed."""
    z, y, x = _grid(shape)
    rng = np.random.default_rng(seed)
    field = np.zeros(shape)
    for _ in range(8):
        cz, cy, cx = rng.uniform(0.15, 0.85, 3)
        amp = rng.uniform(-3.0, 3.0)
        sig = rng.uniform(0.05, 0.15)
        # tube: localized in two axes, elongated along a random third
        ax = rng.integers(0, 3)
        r2 = [(z - cz) ** 2, (y - cy) ** 2, (x - cx) ** 2]
        r2[ax] = 0.15 * r2[ax]
        field = field + amp * np.exp(-(sum(r2)) / (2 * sig**2))
    turb = _box_smooth(rng.standard_normal(shape), 3, passes=1)
    return (field + 0.4 * turb).astype(np.float32)


def humidity(shape=(96, 128), seed: int = FIXTURE_SEED + 3) -> np.ndarray:
    """2-D specific-humidity-like field: strictly positive with several
    orders of magnitude of dynamic range (exponential of a smooth field)
    — the natural pw_rel workload."""
    y, x = _grid(shape)
    rng = np.random.default_rng(seed)
    logq = (-2.0 - 4.0 * y + 0.8 * np.sin(2 * np.pi * (2 * x + y))
            + 1.2 * _box_smooth(rng.standard_normal(shape), 9))
    return np.exp(logq).astype(np.float32)


REAL_FIELDS = {
    "temperature": temperature,
    "pressure": pressure,
    "vorticity": vorticity,
    "humidity": humidity,
}


def real_suite(seed: int = FIXTURE_SEED) -> dict[str, np.ndarray]:
    """All real-field fixtures at their default shapes, keyed by name.
    Same content the committed ``tests/data/real_fields.npz`` holds."""
    return {name: gen() for name, gen in REAL_FIELDS.items()}


def load_real_fields(path=None) -> dict[str, np.ndarray]:
    """The fixture suite: the committed npz when present (tests and CI
    gates want bytes pinned across numpy versions), else regenerated."""
    import pathlib

    if path is None:
        root = pathlib.Path(__file__).resolve().parents[3]
        path = root / "tests" / "data" / "real_fields.npz"
    path = pathlib.Path(path)
    if path.exists():
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    return real_suite()


def save_real_fields(path) -> dict[str, np.ndarray]:
    suite = real_suite()
    np.savez_compressed(path, **suite)
    return suite


if __name__ == "__main__":  # python -m repro_torch.data.realfields tests/data/real_fields.npz
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "tests/data/real_fields.npz"
    suite = save_real_fields(out)
    for k, v in suite.items():
        print(f"{k}: {v.shape} {v.dtype} range [{v.min():.4g}, {v.max():.4g}]")
