"""Static interpolation step tables for the cuSZ-Hi predictor.

Each 1-D spline interpolation along a dimension is expressed as a small
banded (B,B) matrix applied along that axis. The plain torch predictor
applies it as a tensordot; the CUDA interp kernels read only the banded
rows (at most four taps, packed by repro_torch.kernels.interp3d). All
index sets are compile-time constants because the block shape (17^ndim) is
fixed, so each (level, sub-step) becomes: up to `ndim` matmuls, a static
blend-weight grid, and a static target mask.

Splines (SZ3/QoZ family, §5.1.2):
  cubic centred  (-1, 9, 9, -1)/16          at (c-3s, c-s, c+s, c+3s)
  natural cubic  (-3, 23, 23, -3)/40        at (c-3s, c-s, c+s, c+3s)
  quad  asym     (3, 6, -1)/8               at (c-s, c+s, c+3s)   [left edge]
                 (-1, 6, 3)/8               at (c-3s, c-s, c+s)   [right edge]
  linear         (1, 1)/2                   at (c-s, c+s)

The natural-cubic weights are the QoZ/HPEZ "natural spline" variant; both
cubics share the quadratic/linear edge fallbacks, so either is usable at
every level.

Multi-dimensional scheme: at each level, sub-step m predicts the points with
exactly m "odd" coordinates by averaging the 1-D interpolations along those
odd dims — restricted to the dims whose stencil order is maximal ("only
prediction values with the highest spline order will be used and averaged").
1-D-sequence scheme: classic SZ3 pass per dim (dim d odd; later dims even;
earlier dims anything). ``"1d"`` sweeps dims in natural order; ``"1d-<perm>"``
(e.g. ``"1d-210"``) sweeps them in the given permutation — the sequential
orderings the per-level autotuner searches over.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

CUBIC = ((-3, -1.0 / 16), (-1, 9.0 / 16), (1, 9.0 / 16), (3, -1.0 / 16))
NAT_CUBIC = ((-3, -3.0 / 40), (-1, 23.0 / 40), (1, 23.0 / 40), (3, -3.0 / 40))
QUAD_L = ((-3, -1.0 / 8), (-1, 6.0 / 8), (1, 3.0 / 8))
QUAD_R = ((-1, 3.0 / 8), (1, 6.0 / 8), (3, -1.0 / 8))
LINEAR = ((-1, 0.5), (1, 0.5))

_FULL_STENCILS = {"cubic": CUBIC, "natural-cubic": NAT_CUBIC}

SPLINES = ("linear", "cubic", "natural-cubic")
SCHEMES = ("1d", "md")
LEVELS = (8, 4, 2, 1)  # anchor stride 16 -> 4-level hierarchy (paper §5.1.1)


def scheme_dims(scheme: str, ndim: int) -> tuple[int, ...] | None:
    """Sweep order of a sequential scheme, or None for the "md" scheme.

    Raises ValueError for malformed scheme names (the error lists the valid
    forms) so typos fail before any step table is built.
    """
    if scheme == "md":
        return None
    if scheme == "1d":
        return tuple(range(ndim))
    if scheme.startswith("1d-"):
        try:
            dims = tuple(int(ch) for ch in scheme[3:])
        except ValueError:
            dims = ()
        if sorted(dims) == list(range(ndim)):
            return dims
    raise ValueError(
        f"unknown scheme {scheme!r} for ndim={ndim}; expected 'md', '1d', or "
        f"'1d-<perm of 0..{ndim - 1}>' (e.g. '1d-{''.join(map(str, reversed(range(ndim))))}')"
    )


def interp_matrix(B: int, s: int, spline: str) -> tuple[np.ndarray, np.ndarray]:
    """(B,B) row-operator + per-coordinate stencil order (3=cubic,2=quad,1=linear)."""
    if spline not in SPLINES:
        raise ValueError(f"unknown spline {spline!r}; one of {SPLINES}")
    full = _FULL_STENCILS.get(spline)
    M = np.zeros((B, B), np.float32)
    order = np.zeros(B, np.int32)
    for c in range(s, B, 2 * s):
        if full is not None and c - 3 * s >= 0 and c + 3 * s <= B - 1:
            stencil, order[c] = full, 3
        elif full is not None and c + 3 * s <= B - 1:
            stencil, order[c] = QUAD_R, 2
        elif full is not None and c - 3 * s >= 0:
            stencil, order[c] = QUAD_L, 2
        else:
            stencil, order[c] = LINEAR, 1
        for off, w in stencil:
            M[c, c + off * s] = w
    return M, order


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: build_steps is lru_cached,
class Step:                                     # so equal configs share Step objects (jit-cache friendly)
    """One vectorized prediction pass: pred = sum_d w_d * (M_d @_axis_d recon)."""

    level: int                      # interpolation stride s
    dims: tuple[int, ...]           # dims with a matmul this step
    matrices: tuple                 # per dim in `dims`: (B,B) np.float32
    weights: tuple                  # per dim in `dims`: (B,)*ndim np.float32 blend grid
    mask: np.ndarray                # (B,)*ndim bool — points assigned this step


def _coord_grids(B: int, ndim: int):
    return np.meshgrid(*([np.arange(B)] * ndim), indexing="ij")


@functools.lru_cache(maxsize=None)
def build_steps(
    ndim: int,
    B: int = 17,
    levels: tuple[int, ...] = LEVELS,
    splines: tuple[str, ...] = ("cubic",) * 4,
    schemes: tuple[str, ...] = ("md",) * 4,
) -> tuple[Step, ...]:
    """Static step list for one (spline, scheme) configuration per level."""
    assert len(splines) == len(levels) and len(schemes) == len(levels)
    coords = _coord_grids(B, ndim)
    steps: list[Step] = []
    for s, spline, scheme in zip(levels, splines, schemes):
        M, order = interp_matrix(B, s, spline)
        on_lattice = np.ones((B,) * ndim, bool)
        odd = []
        for d in range(ndim):
            on_lattice &= coords[d] % s == 0
            odd.append(coords[d] % (2 * s) == s)
        odd = np.stack(odd)  # (ndim, B..)
        ord_d = np.stack([order[coords[d]] for d in range(ndim)])  # (ndim, B..)
        if scheme == "md":
            n_odd = odd.sum(0)
            for m in range(1, ndim + 1):
                mask = on_lattice & (n_odd == m)
                if not mask.any():
                    continue
                # per-point max order among odd dims; dims at max order share weight
                ord_masked = np.where(odd, ord_d, -1)
                omax = ord_masked.max(0)
                used = odd & (ord_masked == omax[None])
                cnt = used.sum(0)
                dims, mats, wts = [], [], []
                for d in range(ndim):
                    w = np.where(mask & used[d], 1.0 / np.maximum(cnt, 1), 0.0).astype(np.float32)
                    if w.any():
                        dims.append(d)
                        mats.append(M)
                        wts.append(w)
                steps.append(Step(s, tuple(dims), tuple(mats), tuple(wts), mask))
        else:
            sweep = scheme_dims(scheme, ndim)  # raises on malformed names
            for i, d in enumerate(sweep):
                mask = on_lattice & odd[d]
                for e in sweep[i + 1 :]:
                    mask &= ~odd[e]  # dims later in the sweep still even at this level
                if not mask.any():
                    continue
                w = mask.astype(np.float32)
                steps.append(Step(s, (d,), (M,), (w,), mask))
    # Invariant (full hierarchies only): every non-anchor point covered once.
    if levels and levels[0] * 2 - 1 <= B and 1 in levels:
        cover = np.zeros((B,) * ndim, np.int32)
        for st in steps:
            cover += st.mask
        anchors = np.ones((B,) * ndim, bool)
        for d in range(ndim):
            anchors &= coords[d] % (2 * levels[0]) == 0
        assert (cover[anchors] == 0).all() and (cover[~anchors] == 1).all(), "step coverage broken"
    return tuple(steps)


def config_key(splines, schemes) -> tuple:
    return (tuple(splines), tuple(schemes))
