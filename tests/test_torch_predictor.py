"""The port's plain predictor, block geometry and autotuner against the JAX
package, and the interp kernels' step tables against the plain predictor.

Tolerances: codes agree in >= 99.99% of points (the JAX package's own
criterion for its Pallas kernel, tests/test_kernels.py); float recon may
differ by float32 tie-breaks between frameworks, so it is held to 2 eb of
the reference and to the bound eb on non-outliers.
"""
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
    """The interp kernels' loop, in numpy float32, driven by the packed
    tables exactly as csrc/interp3d.cu reads them: per step and target
    point, pred = sum over used dims of w * (sum of tap products), each
    operation rounded to float32, then quantize (encode) or replay (decode).
    Vectorized over blocks; returns (codes, recon)."""
    tb = pack_steps(steps, stride)
    nb = blocks.shape[0]
    orig = blocks.reshape(nb, -1)
    V = orig.shape[1]
    idx_all = np.arange(V)
    coords = np.stack([idx_all // 289, (idx_all // 17) % 17, idx_all % 17])
    anchor = np.all(coords % stride == 0, axis=0)
    rec = np.where(anchor[None], orig, np.float32(0)).astype(np.float32)
    codes = np.full((nb, V), 128, np.uint8) if not decode else codes_in.reshape(nb, -1)
    tw = np.float32(twoeb)
    inv = np.float32(1) / tw
    sd = (289, 17, 1)
    for k in range(tb["n_steps"]):
        for p in range(tb["step_off"][k], tb["step_off"][k + 1]):
            idx, dmask, w = int(tb["pts"][p]) & 0xFFFF, int(tb["pts"][p]) >> 16, tb["wts"][p]
            pred = np.zeros(nb, np.float32)
            for d in range(3):
                if not dmask >> d & 1:
                    continue
                c = coords[d, idx]
                base = idx - c * sd[d]
                acc = np.zeros(nb, np.float32)
                for t in range(tb["tapn"][k, c]):
                    acc = acc + tb["tapw"][k, c, t] * rec[:, base + int(tb["tapj"][k, c, t]) * sd[d]]
                pred = pred + w * acc
            if decode:
                q = codes[:, idx].astype(np.int32) - 128
                rec[:, idx] = np.where(q == -128, orig[:, idx], pred + q.astype(np.float32) * tw)
            else:
                o = orig[:, idx]
                q = np.rint((o - pred) * inv)
                out = np.abs(q) > 127
                rec[:, idx] = np.where(out, o, pred + q * tw)
                codes[:, idx] = np.where(out, 0, np.clip(q, -128, 127) + 128).astype(np.uint8)
    return codes.reshape(blocks.shape), rec.reshape(blocks.shape)


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
