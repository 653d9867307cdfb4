"""Adversarial input corpus for the guaranteed-bound runtime.

Every generator here produces a field class that historically broke (or
silently degraded) an error-bounded compressor: non-finite fill regions,
extreme dynamic ranges that overflow float32 reductions, denormal
magnitudes below the pw_rel transform's resolution, constant planes that
collapse the value range, and single-voxel outliers that stress the
outlier section. The contract every spec must satisfy on every one of
these is **bound-or-typed-error**: either the round-trip honors the
declared bound (bit-exactly on non-finite points), or compress raises a
typed error (``ValueError`` family / ``BoundViolationError``) — silent
corruption is the only forbidden outcome. ``tests/test_torch_testing.py``
sweeps the full spec × corpus grid on the port (``tests/test_adversarial.py``
does so on the JAX package, whose corpus this is, field for field).

All generators are deterministic under an explicit seed (default: the
chaos-lane :func:`repro_torch.testing.faults.fault_seed`), so a CI failure
names a cell that replays exactly.
"""
from __future__ import annotations

import numpy as np

from .faults import fault_seed


def _rng(seed: int | None) -> np.random.Generator:
    return np.random.default_rng(fault_seed() if seed is None else seed)


def _smooth(rng: np.random.Generator, shape) -> np.ndarray:
    x = rng.standard_normal(shape)
    for ax in range(x.ndim):
        x = np.cumsum(x, axis=ax)
    x /= max(1.0, float(np.max(np.abs(x))))
    return x.astype(np.float32)


def nan_slab(shape=(24, 24, 24), *, frac: float = 0.2, seed: int | None = None) -> np.ndarray:
    """A smooth field with a contiguous NaN slab (masked ocean region)."""
    x = _smooth(_rng(seed), shape)
    k = max(1, int(shape[0] * frac))
    x[:k] = np.nan
    return x


def inf_edges(shape=(24, 24, 24), *, seed: int | None = None) -> np.ndarray:
    """±Inf on the boundary faces (sensor saturation at the domain edge)."""
    x = _smooth(_rng(seed), shape)
    x[0, ...] = np.inf
    x[-1, ...] = -np.inf
    return x


def scattered_nonfinite(shape=(24, 24, 24), *, frac: float = 0.01,
                        seed: int | None = None) -> np.ndarray:
    """NaN / +Inf / -Inf sprinkled at random points (bad pixels)."""
    rng = _rng(seed)
    x = _smooth(rng, shape)
    flat = x.reshape(-1)
    n = max(3, int(flat.size * frac))
    idx = rng.choice(flat.size, size=n, replace=False)
    flat[idx[0::3]] = np.nan
    flat[idx[1::3]] = np.inf
    flat[idx[2::3]] = -np.inf
    return x


def all_nan(shape=(16, 16), **_kw) -> np.ndarray:
    """Entirely non-finite (an unwritten/poisoned allocation)."""
    return np.full(shape, np.nan, np.float32)


def denormal_heavy(shape=(24, 24, 24), *, seed: int | None = None) -> np.ndarray:
    """Magnitudes straddling the float32 denormal range (~1e-38..1e-45)."""
    rng = _rng(seed)
    mag = 10.0 ** rng.uniform(-45.0, -30.0, size=shape)
    sgn = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    return (mag * sgn).astype(np.float32)


def huge_dynamic_range(shape=(24, 24, 24), *, seed: int | None = None) -> np.ndarray:
    """Values spanning ~1e±30: a float32 max-min overflows to inf."""
    rng = _rng(seed)
    mag = 10.0 ** rng.uniform(-30.0, 30.0, size=shape)
    sgn = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    x = (mag * sgn).astype(np.float32)
    x.reshape(-1)[0] = np.float32(-3e38)  # pin the range to near-overflow
    x.reshape(-1)[-1] = np.float32(3e38)
    return x


def constant_plane(shape=(24, 24, 24), *, value: float = 2.5, **_kw) -> np.ndarray:
    """A constant field (zero dynamic range)."""
    return np.full(shape, np.float32(value), np.float32)


def constant_with_plane(shape=(24, 24, 24), *, seed: int | None = None) -> np.ndarray:
    """Smooth everywhere except one constant plane (a land/sea mask fill)."""
    x = _smooth(_rng(seed), shape)
    x[shape[0] // 2] = 0.0
    return x


def single_voxel_outlier(shape=(24, 24, 24), *, spike: float = 1e6,
                         seed: int | None = None) -> np.ndarray:
    """A smooth O(1) field with one enormous spike voxel."""
    x = _smooth(_rng(seed), shape)
    c = tuple(d // 2 for d in shape)
    x[c] = np.float32(spike)
    return x


def signed_zeros(shape=(16, 16), *, seed: int | None = None) -> np.ndarray:
    """A field mixing -0.0, +0.0 and small mixed-sign values (the pw_rel
    sign/zero bitmap edge cases)."""
    rng = _rng(seed)
    x = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    flat = x.reshape(-1)
    flat[0::7] = 0.0
    flat[1::7] = -0.0
    return x


# name -> generator; every cell of the tier-1 sweep and the tier-2
# property test draws from this registry
CORPUS = {
    "nan_slab": nan_slab,
    "inf_edges": inf_edges,
    "scattered_nonfinite": scattered_nonfinite,
    "all_nan": all_nan,
    "denormal_heavy": denormal_heavy,
    "huge_dynamic_range": huge_dynamic_range,
    "constant_plane": constant_plane,
    "constant_with_plane": constant_with_plane,
    "single_voxel_outlier": single_voxel_outlier,
    "signed_zeros": signed_zeros,
}


def corpus_field(name: str, *, seed: int | None = None) -> np.ndarray:
    """One corpus field by registry name, deterministic under ``seed``."""
    return CORPUS[name](seed=seed)
