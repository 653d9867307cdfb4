"""Numpy emulations of the Lorenzo encode and histogram256 CUDA kernels,
step for step as the kernels run them, against the plain versions and the
JAX package. The kernels themselves run only on the card
(tests/test_torch_cuda.py); these hold their algorithms to the reference
here, at small sizes.

Lorenzo (csrc/lorenzo3d.cu): each CTA owns a tile of ``ty`` rows of y by
``8 // ty * WARP_Z`` points of z in one row of the batch and marches up to
MARCH planes along x, starting one plane early (the halo plane) unless it
starts at x == 0. Per plane: Dx against the previous plane's pq, Dz with
the warp's halo column for its first lane, Dy from the row above (the halo
row for the tile's first), all in wrapping uint32; outliers are appended
in no order to a list of ``outlier_capacity(n)`` slots, which is sized
again and refilled when it overflows, then sorted by flat index.

histogram256 (csrc/histogram.cu): an unaligned head and a ragged tail of
under 16 bytes each counted by CTA 0, the 16-B vectors in between strided
over the grid's threads, every byte into its warp's copy of the bins.
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import lorenzo as rlor
from repro_torch.core import lorenzo as tlor
from repro_torch.kernels.lorenzo3d import ops as klor

# ---------------------------------------------------------------- Lorenzo


def _pq(v: np.ndarray, twoeb: np.float32) -> np.ndarray:
    """__float2int_rn(__fdiv_rn(v, twoeb)) as uint32 bits: IEEE f32 division,
    half to even, saturated to the int32 range."""
    with np.errstate(over="ignore"):  # beyond f32: inf, then saturated
        q = np.rint(v.astype(np.float32) / twoeb).astype(np.float64)
    q = np.clip(q, -2.0**31, 2.0**31 - 1).astype(np.int64)
    return (q & 0xFFFFFFFF).astype(np.uint32)


def _is_outlier(c: np.ndarray) -> np.ndarray:
    s = c.view(np.int32)
    return (s > 127) | ((s < -127) & (s != np.iinfo(np.int32).min))


def _codes_of(c: np.ndarray) -> np.ndarray:
    s = c.view(np.int32)
    return np.where(_is_outlier(c), 0, np.clip(s, -127, 127) + 128).astype(np.uint8)


def _run_kernel(xf, twoeb, ty, cap, codes, stats):
    """One launch over the (rows, X, Y, Z) field ``xf``: writes ``codes``
    (same shape) and returns the outlier list as the kernel leaves it, in
    no order, truncated to ``cap``, and the count."""
    rows, X, Y, Z = xf.shape
    wz = 8 // ty
    tz, krows = wz * klor.WARP_Z, ty + 1 if ty > 1 else 1
    lst, count = [], 0
    rng = np.random.default_rng(0)
    for r, xc, yt, zt in itertools.product(range(rows), range(-(-X // klor.MARCH)), range(-(-Y // ty)),
                                           range(-(-Z // tz))):
        ys = yt * ty - 1 + np.arange(krows) if ty > 1 else np.array([yt])
        row_in = (ys >= 0) & (ys < Y)
        zs = zt * tz + np.arange(tz)
        z_in = zs < Z
        zw = zt * tz + klor.WARP_Z * np.arange(wz)  # each warp's first z; its halo column is zw - 1
        has_h = (zw > 0) & (zw < Z)  # a warp past the field's end loads no halo column
        writes = row_in & ((np.arange(krows) > 0) if ty > 1 else True)
        x0 = xc * klor.MARCH
        x1 = min(x0 + klor.MARCH, X)
        prev = np.zeros((krows, tz), np.uint32)
        prev_h = np.zeros((krows, wz), np.uint32)
        for x in range(max(x0 - 1, 0), x1):
            plane = np.zeros((krows, tz), np.float32)
            plane[np.ix_(row_in, z_in)] = xf[r, x][np.ix_(ys[row_in], zs[z_in])]
            q = _pq(plane, twoeb)
            halo = np.zeros((krows, wz), np.float32)
            halo[np.ix_(row_in, has_h)] = xf[r, x][np.ix_(ys[row_in], zw[has_h] - 1)]
            q_h = np.where(row_in[:, None] & has_h[None], _pq(halo, twoeb), np.uint32(0))
            stats["quantized"] += q.size + int((row_in[:, None] & has_h).sum())  # every lane, halo columns
            a, prev = q - prev, q  # Dx
            a_h, prev_h = q_h - prev_h, q_h
            if x < x0:
                continue  # the halo plane only primes prev
            left = np.concatenate([np.zeros((krows, 1), np.uint32), a[:, :-1]], 1)
            left[:, ::klor.WARP_Z] = a_h  # each warp's lane 0 takes its halo column
            c = a - left  # Dz
            if ty > 1:
                c[1:] -= c[:-1].copy()  # Dy: the row above, as it stood after Dz
            out = writes[:, None] & z_in[None] & _is_outlier(c)
            for wr in np.flatnonzero(writes):
                flat = ((r * X + x) * Y + ys[wr]) * Z + zs[z_in]
                codes.reshape(-1)[flat] = _codes_of(c[wr, z_in])
            flat = (((r * X + x) * Y + ys[:, None]) * Z + zs[None])[out]
            order = rng.permutation(flat.size)  # warps reserve their slots in no set order
            for i, v in zip(flat[order], c[out].view(np.int32)[order]):
                if count < cap:
                    lst.append((int(i), int(v)))
                count += 1
    return lst, count


def emulate_lorenzo(x: np.ndarray, twoeb: float, nd: int, stats=None):
    """The kernel's walk and the wrapper's handling of its list: (codes,
    ascending outlier indices, their deltas)."""
    stats = {"quantized": 0, "launches": 0} if stats is None else stats
    rows, X, Y, Z, ty = klor.launch_plan(x.shape, nd)
    xf = np.ascontiguousarray(x, np.float32).reshape(rows, X, Y, Z)
    codes = np.zeros(x.shape, np.uint8)
    cap = klor.outlier_capacity(x.size)
    while True:
        lst, count = _run_kernel(xf, np.float32(twoeb), ty, cap, codes, stats)
        stats["launches"] += 1
        if count <= cap:
            break
        cap = count
    lst.sort()
    idx = np.array([i for i, _ in lst], np.int64)
    vals = np.array([v for _, v in lst], np.int32)
    return codes, idx, vals


def _field(shape, seed, scale=1.0, every=101):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32).cumsum(-1) * np.float32(scale)
    x.reshape(-1)[::every] += np.float32(500.0 * scale)  # forced outliers
    return x


LORENZO_SHAPES = [
    ((70, 9, 33), 3),        # a march over three chunks; y straddles the 8-row tile
    ((33, 17, 129), 3),      # z straddles the 128-point warp, y two tiles
    ((3, 7, 127), 3),
    ((2, 9, 31), 3),         # Z not a multiple of 4
    ((34, 1, 257), 3),       # Y == 1: the 1-row tile
    ((1, 9, 130), 3),        # X == 1: runs as (9, 1, 130) and marches along y
    ((5, 7, 1), 3),          # Z == 1
    ((2, 3, 34, 10, 31), 3),  # batched: 6 rows, the march resets in each
    ((1029,), 1), ((3, 1500), 1), ((5, 1), 1),
    ((37, 45), 2), ((40, 1030), 2), ((2, 4, 40, 50), 2),
]


@pytest.mark.parametrize("shape,nd", LORENZO_SHAPES, ids=str)
@pytest.mark.parametrize("twoeb,scale", [(0.02, 1.0), (2e-6, 1e4)], ids=["outliers", "int32-edge"])
def test_lorenzo_tile_walk_equals_plain_and_reference(shape, nd, twoeb, scale):
    """|x| ~ 1e4 at 2eb 2e-6 passes 2^31: saturated pq, wrapping deltas."""
    x = _field(shape, sum(shape), scale)
    codes, idx, vals = emulate_lorenzo(x, twoeb, nd)
    pc, po, pfull = tlor.lorenzo_encode(torch.from_numpy(x), twoeb, nd)
    pidx = np.flatnonzero(po.numpy().reshape(-1))
    assert np.array_equal(codes, pc.numpy())
    assert np.array_equal(idx, pidx) and np.array_equal(vals, pfull.numpy().reshape(-1)[pidx])
    rc, ro, rfull, _ = rlor.lorenzo_encode(jnp.asarray(x), jnp.float32(twoeb), nd)
    assert np.array_equal(codes, np.asarray(rc))
    assert np.array_equal(idx, np.flatnonzero(np.asarray(ro).reshape(-1)))
    assert np.array_equal(vals, np.asarray(rfull).reshape(-1)[idx])
    if scale == 1.0:
        assert idx.size > 0


def test_lorenzo_int32_min_delta_is_code_one():
    x = np.array([[[1e4, -1e4, 5e3, 3e9, -3e9, 1e38, -1e38, 0.0, 1.0]]], np.float32)
    codes, idx, vals = emulate_lorenzo(x, 2e-6, 3)
    pc, po, pfull = tlor.lorenzo_encode(torch.from_numpy(x), 2e-6, 3)
    assert int(pfull.min()) == -2**31 and np.array_equal(codes, pc.numpy())
    assert np.array_equal(idx, np.flatnonzero(po.numpy().reshape(-1)))


def lorenzo_case_field(kind: str, shape) -> np.ndarray:
    """A field whose every point is an outlier (a checkerboard of +-500), one
    whose last point alone is (a spike there), or one with none."""
    if kind == "all-outliers":
        return (np.indices(shape).sum(0) % 2 * 1000.0 - 500.0).astype(np.float32)
    x = np.zeros(shape, np.float32)
    if kind == "one-outlier":
        x[(-1,) * len(shape)] = 50.0
    return x


@pytest.mark.parametrize("kind", ["all-outliers", "one-outlier", "none"])
def test_lorenzo_outlier_list_overflow_and_order(kind):
    """Every point an outlier overflows the first list: the kernel runs
    again at the exact total; one outlier needs no sort."""
    x = lorenzo_case_field(kind, (9, 20, 140))
    stats = {"quantized": 0, "launches": 0}
    codes, idx, vals = emulate_lorenzo(x, 0.02, 3, stats)
    pc, po, pfull = tlor.lorenzo_encode(torch.from_numpy(x), 0.02, 3)
    pidx = np.flatnonzero(po.numpy().reshape(-1))
    assert np.array_equal(codes, pc.numpy()) and np.array_equal(idx, pidx)
    assert np.array_equal(vals, pfull.numpy().reshape(-1)[pidx])
    n_out = {"all-outliers": x.size, "one-outlier": 1, "none": 0}[kind]
    assert idx.size == n_out
    assert stats["launches"] == (2 if n_out > klor.outlier_capacity(x.size) else 1)


def test_lorenzo_tile_walk_quantizes_each_point_about_once():
    """At most (9/8)(1 + 1/WARP_Z)(33/32) quantizations per point (every lane
    of the halo row, the halo columns, the halo plane), down from 8."""
    i, j, k = np.indices((64, 16, 256), dtype=np.float32)
    x = (np.sin(0.05 * i) + np.cos(0.1 * j) * np.sin(0.02 * k)).astype(np.float32)  # smooth: few outliers
    stats = {"quantized": 0, "launches": 0}
    emulate_lorenzo(x, 0.02, 3, stats)
    assert stats["launches"] == 1
    assert 1.0 < stats["quantized"] / x.size <= 9 / 8 * (1 + 1 / klor.WARP_Z) * 33 / 32


@pytest.mark.parametrize("shape,nd,plan", [
    ((512, 512, 512), 3, (1, 512, 512, 512, 8)), ((4, 9, 1, 33), 3, (4, 9, 1, 33, 1)),
    ((6, 37, 45), 2, (6, 37, 1, 45, 1)), ((3, 1500), 1, (3, 1, 1, 1500, 1)), ((1, 9, 130), 3, (1, 9, 1, 130, 1)),
])
def test_lorenzo_launch_plan(shape, nd, plan):
    assert klor.launch_plan(shape, nd) == plan


# ---------------------------------------------------------------- histogram256


HIST_THREADS = 512  # threads per CTA of csrc/histogram.cu


def emulate_histogram(data: np.ndarray, addr: int, grid: int = 5) -> np.ndarray:
    """The kernel over ``data`` placed at an address that is ``addr`` mod 16,
    with ``grid`` CTAs: the head up to the first 16-B boundary and the tail
    after the last whole vector counted by threads 0-15 of CTA 0, vector j
    by thread j mod (grid * HIST_THREADS), every byte into its thread's warp
    copy of the bins."""
    n = data.size
    head = min((16 - addr % 16) % 16, n)
    nvec = (n - head) // 16
    bins = np.zeros((grid, HIST_THREADS // 32, 256), np.int64)
    vecs = data[head: head + 16 * nvec].reshape(nvec, 16)
    thread = np.repeat(np.arange(nvec) % (grid * HIST_THREADS), 16)
    np.add.at(bins, (thread // HIST_THREADS, thread % HIST_THREADS // 32, vecs.reshape(-1)), 1)
    edge = np.concatenate([data[:head], data[head + 16 * nvec:]])
    assert head < 16 and edge.size - head < 16
    np.add.at(bins[0, 0], edge, 1)
    return bins.sum((0, 1))


def _hist_stream(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind.startswith("const"):
        return np.full(n + 16, int(kind[5:]), np.uint8)
    d = rng.integers(0, 256, n + 16, dtype=np.uint8)
    if kind == "center90":
        d[rng.random(n + 16) < 0.9] = 128
    return d


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 8191, 8193, 100_003])
@pytest.mark.parametrize("kind", ["const0", "const128", "const255", "uniform", "center90"])
def test_histogram_emulation_equals_bincount(kind, n):
    d = _hist_stream(kind, n)
    for off in range(16):  # each head offset
        x = d[off: off + n]
        assert np.array_equal(emulate_histogram(x, off), np.bincount(x, minlength=256))
