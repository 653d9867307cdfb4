"""The port's plain predictor, block geometry and autotuner against the JAX
package, and the interp kernels' step tables against the plain predictor.

Tolerances: codes agree in >= 99.99% of points (the JAX package's own
criterion for its Pallas kernel, tests/test_kernels.py); float recon may
differ by float32 tie-breaks between frameworks, so it is held to 2 eb of
the reference and to the bound eb on non-outliers.
"""
import itertools

import numpy as np
import pytest
import torch

import repro.core.autotune as rauto
import repro.core.blocks as rblk
import repro.core.predictor as rpred
import repro.core.reorder as rreo
from repro.core.stencils import build_steps as rbuild
from repro.kernels.interp3d import compress_blocks_ref
from repro_torch.core import autotune as tauto
from repro_torch.core import blocks as tblk
from repro_torch.core import predictor as tpred
from repro_torch.core import reorder as treo
from repro_torch.core.stencils import build_steps
from repro_torch.kernels.interp3d import pack_steps

import jax.numpy as jnp


def _steps(spline, scheme, levels=(8, 4, 2, 1), ndim=3):
    return build_steps(ndim, 17, levels, (spline,) * len(levels), (scheme,) * len(levels))


def _port(blocks, eb, steps, stride=16):
    c, r = tpred.compress_blocks(torch.from_numpy(blocks), 2 * eb, steps, stride)
    return c.numpy(), c.numpy() == 0, r.numpy()


@pytest.mark.parametrize("spline", ["linear", "cubic", "natural-cubic"])
@pytest.mark.parametrize("scheme", ["md", "1d", "1d-210"])
@pytest.mark.parametrize("nb", [1, 5])
def test_plain_compress_blocks_matches_reference(spline, scheme, nb):
    rng = np.random.default_rng(nb)
    blocks = rng.standard_normal((nb, 17, 17, 17)).astype(np.float32)
    eb = 0.01
    levels = (8, 4, 2, 1)
    ck, ok, rk = _port(blocks, eb, _steps(spline, scheme))
    rsteps = rbuild(3, 17, levels, (spline,) * 4, (scheme,) * 4)
    cr, orf, rr = compress_blocks_ref(blocks, 2 * eb, rsteps)
    assert (ck == cr).mean() >= 0.9999
    assert np.allclose(rk, rr, atol=2 * eb)
    assert np.abs(rk - blocks)[~ok].max() <= eb * (1 + 1e-4)
    assert np.array_equal(orf, cr == 0)  # the reference's outlier mask is the code-0 points


@pytest.mark.parametrize("eb", [1e-1, 1e-3])
@pytest.mark.parametrize("scheme", ["1d", "md"])
def test_plain_anchor_stride8_matches_reference(eb, scheme):
    rng = np.random.default_rng(7)
    blocks = rng.standard_normal((3, 17, 17, 17)).astype(np.float32)
    levels = (4, 2, 1)
    ck, ok, _ = _port(blocks, eb, _steps("cubic", scheme, levels), stride=8)
    cr, _, _ = compress_blocks_ref(blocks, 2 * eb, rbuild(3, 17, levels, ("cubic",) * 3, (scheme,) * 3), anchor_every=8)
    assert (ck == cr).mean() >= 0.9999


@pytest.mark.parametrize("scheme", ["md", "1d-210"])
def test_plain_decompress_blocks_matches_reference(scheme):
    rng = np.random.default_rng(11)
    g = np.linspace(0, 3, 17)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    blocks = (np.sin(X + rng.random((4, 1, 1, 1))) * np.cos(2 * Y) + 0.01 * rng.standard_normal((4, 17, 17, 17)) + Z)
    blocks = blocks.astype(np.float32)
    eb = 1e-3
    steps = _steps("cubic", scheme)
    ck, ok, rk = _port(blocks, eb, steps)
    ct, bt = torch.from_numpy(ck), torch.from_numpy(blocks)
    dt = tpred.decompress_blocks(ct, *tpred.decode_inputs(bt, ct, 16), 2 * eb, steps, 16).numpy()
    assert np.array_equal(dt, rk)  # the plain replay is bit-exact with the plain encoder
    rsteps = rbuild(3, 17, (8, 4, 2, 1), ("cubic",) * 4, (scheme,) * 4)
    dr = np.asarray(rpred.decompress_blocks(jnp.asarray(ck), jnp.asarray(blocks), jnp.asarray(blocks),
                                            jnp.float32(2 * eb), rsteps, 16))
    assert np.abs(dr - blocks)[~ok].max() <= eb * (1 + 1e-4)
    assert np.abs(dr - dt).max() <= 2 * eb


def _kernel_emulation(blocks, codes_in, twoeb, steps, stride, decode=False):
    """The interp kernels' loop, in numpy float32, driven by the compact
    tables exactly as csrc/interp3d.cu reads them: one tile per block,
    updated in place, step after step; per target point, pred = sum over
    its used dims (u16 point word: index | dims mask << 13) of w * (sum of
    tap products; columns from the row's word, coefficients from its
    pattern), w = 1 / (used dims), each operation rounded to float32;
    then quantize against the original value in the tile and overwrite it
    (encode), or replay the code, a code-0 point keeping the outlier value
    placed before the first step (decode). Vectorized over blocks and over
    a step's points (a step reads only anchors and earlier targets).
    Returns (codes, recon)."""
    tb = pack_steps(steps, stride)
    nb, ndim = blocks.shape[0], blocks.ndim - 1
    V = 17**ndim
    coords = np.stack(np.unravel_index(np.arange(V), (17,) * ndim))
    sd = 17 ** np.arange(ndim - 1, -1, -1)
    anchor = np.all(coords % stride == 0, axis=0)
    orig = blocks.reshape(nb, V)
    tw = np.float32(twoeb)
    inv = np.float32(1) / tw
    if decode:
        codes = codes_in.reshape(nb, V)
        anchors, keys, vals = (t.numpy() for t in tpred.decode_inputs(torch.from_numpy(blocks),
                                                                        torch.from_numpy(codes_in), stride))
        tile = np.zeros((nb, V), np.float32)
        tile[:, anchor] = anchors.reshape(nb, -1)  # row-major anchor slots, as the kernel's anchor_index
        b, at = keys // V, keys % V
        keep = (codes[b, at] == 0) & ~anchor[at]
        tile[b[keep], at[keep]] = vals[keep]
    else:
        codes = np.full((nb, V), 128, np.uint8)
        tile = orig.copy()
    pts = tb["pts"].astype(np.int64)
    for k in range(tb["n_steps"]):
        pk = pts[tb["step_off"][k]: tb["step_off"][k + 1]]
        idx, dmask = pk & 0x1FFF, pk >> 13
        meta, coef = tb["meta"][tb["step_op"][k]], tb["coef"][tb["step_op"][k]]
        used = np.array([bin(m).count("1") for m in dmask])
        w = np.where(used == 1, np.float32(1), np.where(used == 2, np.float32(0.5), np.float32(1) / np.float32(3)))
        w = w.astype(np.float32)
        pred = np.zeros((nb, idx.size), np.float32)
        for d in range(ndim):
            on = (dmask >> d & 1) == 1
            c = coords[d, idx]
            base = idx - c * sd[d]
            acc = np.zeros((nb, idx.size), np.float32)
            for t in range(4):
                has = on & ((meta[c] & 7) > t)
                col = (meta[c] >> (3 + 5 * t)) & 31
                term = coef[(meta[c] >> 23) & 3, t] * tile[:, np.where(has, base + col * sd[d], 0)]
                acc = np.where(has, acc + term, acc)
            pred = np.where(on, pred + w * acc, pred)
        if decode:
            q = codes[:, idx].astype(np.int32) - 128
            tile[:, idx] = np.where(q == -128, tile[:, idx], pred + q.astype(np.float32) * tw)
        else:
            o = tile[:, idx]
            q = np.rint((o - pred) * inv)
            out = np.abs(q) > 127
            tile[:, idx] = np.where(out, o, pred + q * tw)
            codes[:, idx] = np.where(out, 0, np.clip(q, -128, 127) + 128).astype(np.uint8)
    return codes.reshape(blocks.shape), tile.reshape(blocks.shape)


@pytest.mark.parametrize("spline,scheme,levels", [
    ("cubic", "md", (8, 4, 2, 1)), ("natural-cubic", "1d-210", (8, 4, 2, 1)), ("linear", "1d", (4, 2, 1)),
])
def test_kernel_tables_reproduce_the_plain_predictor_bit_for_bit(spline, scheme, levels):
    rng = np.random.default_rng(5)
    blocks = (rng.standard_normal((3, 17, 17, 17)).cumsum(1) * 0.1).astype(np.float32)
    eb, stride = 1e-2, 2 * levels[0]
    steps = _steps(spline, scheme, levels)
    ck, ok, rk = _port(blocks, eb, steps, stride)
    ce, re = _kernel_emulation(blocks, None, 2 * eb, steps, stride)
    assert np.array_equal(ce, ck) and np.array_equal(re, rk)
    _, rd = _kernel_emulation(blocks, ck, 2 * eb, steps, stride, decode=True)
    assert np.array_equal(rd, rk)


def _schemes(ndim):
    return ["md", "1d"] + ["1d-" + "".join(map(str, p)) for p in itertools.permutations(range(ndim))]


_ALL_CONFIGS = [(nd, stride, spline, scheme) for nd in (1, 2, 3) for stride in (16, 8, 4)
                for spline in ("linear", "cubic", "natural-cubic") for scheme in _schemes(nd)]


@pytest.mark.parametrize("ndim,stride,spline,scheme", _ALL_CONFIGS)
def test_steps_allow_one_tile_in_place(ndim, stride, spline, scheme):
    """What lets the kernels update one tile in place, read off the step
    matrices (not the packed tables): every non-anchor point is the target
    of exactly one step, and every tap of every used dim reads an anchor or
    a target of an earlier step."""
    levels = tauto.levels_for_stride(stride)
    steps = build_steps(ndim, 17, levels, (spline,) * len(levels), (scheme,) * len(levels))
    grids = np.meshgrid(*([np.arange(17)] * ndim), indexing="ij")
    done = np.all([g % stride == 0 for g in grids], axis=0)
    hits = np.zeros(done.shape, np.int32)
    for st in steps:
        for d, M, w in zip(st.dims, st.matrices, st.weights):
            for pt in zip(*np.nonzero(st.mask & (w != 0))):
                for j in np.flatnonzero(M[pt[d]]):
                    tap = list(pt)
                    tap[d] = j
                    assert done[tuple(tap)], f"step at level {st.level} reads {tuple(tap)} for {pt}"
        hits += st.mask
        done |= st.mask
    anchors = np.all([g % stride == 0 for g in grids], axis=0)
    assert (hits[anchors] == 0).all() and (hits[~anchors] == 1).all()
    tb = pack_steps(steps, stride)  # and the kernels' tables accept them
    assert tb["pts"].size == (~anchors).sum()


@pytest.mark.parametrize("ndim,stride,spline,scheme", [
    (1, 16, "cubic", "md"), (1, 4, "linear", "1d"), (2, 16, "natural-cubic", "md"), (2, 8, "cubic", "1d-10"),
    (2, 4, "cubic", "md"), (3, 16, "linear", "md"), (3, 8, "cubic", "1d"), (3, 4, "natural-cubic", "1d-120"),
])
def test_kernel_emulation_matches_plain_with_outliers(ndim, stride, spline, scheme):
    """The compact tables, the in-place tile and the pre-placed outliers
    reproduce the plain encoder and decoder bit for bit, on blocks with a
    slab of outliers in every third block."""
    rng = np.random.default_rng(ndim * 100 + stride)
    blocks = (rng.standard_normal((7,) + (17,) * ndim).cumsum(1) * 0.1).astype(np.float32)
    blocks[::3, 3] += 100.0
    eb = 1e-2
    levels = tauto.levels_for_stride(stride)
    steps = build_steps(ndim, 17, levels, (spline,) * len(levels), (scheme,) * len(levels))
    ck, ok, rk = _port(blocks, eb, steps, stride)
    assert ok.any()
    ce, re = _kernel_emulation(blocks, None, 2 * eb, steps, stride)
    assert np.array_equal(ce, ck) and np.array_equal(re, rk)
    _, rd = _kernel_emulation(blocks, ck, 2 * eb, steps, stride, decode=True)
    assert np.array_equal(rd, rk)


@pytest.mark.parametrize("shape", [(40, 33, 17), (17, 17, 17), (1, 50), (70,), (2, 20, 18, 19)])
def test_block_twins_match_reference(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    nd = min(x.ndim, 3)
    xb = x.reshape((-1,) + x.shape[x.ndim - nd:])
    pr = rblk.pad_field_batch(xb)
    assert np.array_equal(tblk.pad_field_batch(xb), pr)
    assert np.array_equal(tblk.pad_field_batch_t(torch.from_numpy(xb)).numpy(), pr)
    br = rblk.gather_blocks_batch(pr)
    assert np.array_equal(tblk.gather_blocks_batch(pr), br)
    assert np.array_equal(tblk.gather_blocks_batch_t(torch.from_numpy(pr)).numpy(), br)
    ps = tuple(pr.shape[1:])
    # scatter with distinct values per block copy pins the face-ownership rule
    tagged = np.arange(br.size, dtype=np.int64).reshape(br.shape)
    sr = rblk.scatter_blocks_batch(tagged, xb.shape[0], ps)
    assert np.array_equal(tblk.scatter_blocks_batch(tagged, xb.shape[0], ps), sr)
    assert np.array_equal(tblk.scatter_blocks_batch_t(torch.from_numpy(tagged), xb.shape[0], ps).numpy(), sr)
    for stride in (16, 8):
        ar = rblk.anchor_grid_batch(pr, stride)
        assert np.array_equal(tblk.anchor_grid_batch(pr, stride), ar)
        assert np.array_equal(tblk.anchor_grid_batch_t(torch.from_numpy(pr), stride).numpy(), ar)
        # the decoder's per-block anchors are the reference's dense anchor grid, gathered
        dense = rblk.gather_blocks_batch(rblk.place_anchors_batch(ps, ar, stride))
        ab = tblk.gather_blocks_batch_t(torch.from_numpy(ar), 16 // stride).numpy()
        assert np.array_equal(ab, dense[(slice(None),) + (slice(None, None, stride),) * nd])


@pytest.mark.parametrize("shape", [(2, 49, 33, 17), (1, 33, 65), (1, 81)])
def test_block_keys_are_the_dense_outlier_grid_gathered(shape):
    """block_keys_t puts each outlier in every closed block that holds it,
    as gathering a dense outlier grid into blocks does (faces shared)."""
    rng = np.random.default_rng(len(shape))
    size = int(np.prod(shape))
    flat = np.unique(np.concatenate([rng.integers(0, size, 40), np.arange(0, size, 16)]))  # many face points
    vals = rng.standard_normal(flat.size).astype(np.float32) + 5
    grid = np.zeros(size, np.float32)
    grid[flat] = vals
    dense = rblk.gather_blocks_batch(grid.reshape(shape))
    keys, src = tblk.block_keys_t(torch.from_numpy(flat), shape[1:])
    assert keys.unique().numel() == keys.numel()
    got = np.zeros(dense.size, np.float32)
    got[keys.numpy()] = vals[src.numpy()]
    assert np.array_equal(got.reshape(dense.shape), dense)


@pytest.mark.parametrize("shape", [(33, 49, 17), (65,), (17, 33)])
@pytest.mark.parametrize("stride", [16, 8])
@pytest.mark.parametrize("reorder", [True, False])
def test_reorder_twins_match_reference(shape, stride, reorder):
    grids = np.random.default_rng(2).integers(0, 256, (2,) + shape, dtype=np.uint8)
    sr = rreo.reorder_codes_batch(grids, stride, reorder)
    assert np.array_equal(treo.reorder_codes_batch(grids, stride, reorder), sr)
    st = treo.reorder_codes_batch_t(torch.from_numpy(grids), stride, reorder)
    assert np.array_equal(st.numpy(), sr)
    back = rreo.restore_codes_batch(sr, 2, shape, fill=128, dtype=np.uint8, stride=stride, reorder=reorder)
    assert np.array_equal(treo.restore_codes_batch(sr, 2, shape, 128, np.uint8, stride, reorder), back)
    assert np.array_equal(treo.restore_codes_batch_t(st, 2, shape, 128, stride, reorder).numpy(), back)


def _smooth3d():
    g = np.linspace(0, 4 * np.pi, 48)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.05 * np.cos(3 * X)).astype(np.float32)


def _golden():
    import pathlib

    return np.load(pathlib.Path(__file__).parent / "data" / "golden_field.npy")


@pytest.mark.parametrize("field", [_smooth3d, _golden], ids=["smooth3d", "golden"])
@pytest.mark.parametrize("stride", [16, 8])
def test_autotune_picks_the_reference_plan(field, stride):
    x = field()
    blocks = rblk.gather_blocks_batch(rblk.pad_field_batch(x[None]))
    eb = 1e-3 * float(x.max() - x.min())
    levels = rauto.levels_for_stride(stride)
    assert tauto.levels_for_stride(stride) == levels
    assert np.array_equal(tauto.legacy_sample_indices(blocks.shape[0]), rauto.legacy_sample_indices(blocks.shape[0]))
    ref = rauto.autotune(blocks, 2 * eb, levels, stride)
    assert tauto.autotune(torch.from_numpy(blocks), 2 * eb, levels, stride) == ref
