"""The port's predictor planner (``predictor="auto"``) against the JAX
package's (``repro.core.autotune``): plan records, plan-cache keys, the
per-level code streams of the trial passes and the plans themselves on
smooth, anisotropic, sparse and noisy fields in 1-D, 2-D and 3-D, at the
default strides and under a stride restriction.

Tolerance: where every trial code agrees with the reference the plan,
every candidate's score and the plan's bytes are equal; on fields where
float tie-breaks between the frameworks flip a few codes of a losing
candidate, the candidate list is the same and the winner's score lies
within 0.1 % of the reference winner's. The trial passes run through
``kernels.interp3d.compress_blocks``, here its plain version."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.autotune as RA
import repro_torch.core.autotune as TA
from repro.core import blocks as rblk
from repro.data import predictor_suite
from repro_torch.core.stencils import build_steps
from repro_torch.kernels import interp3d as tinterp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and torch's spinning thread pools in all of
    them oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SUITE = predictor_suite(side=32)


def _smooth_big():
    g = np.linspace(0, 4 * np.pi, 96)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.3 * np.exp(-((X - 6) ** 2 + (Y - 6) ** 2) / 8)).astype(np.float32)


def _walk():
    rng = np.random.default_rng(5)
    return np.cumsum(np.cumsum(np.cumsum(rng.standard_normal((33, 33, 33)).astype(np.float32), 0), 1), 2)


def _line(n: int, noise: float):
    g = np.linspace(0, 1, n)
    return (np.sin(g * 20) + 0.1 * np.cos(g * 97) + noise * np.random.default_rng(n).standard_normal(n)).astype(
        np.float32)


FIELDS = {
    # every trial code agrees with the reference: plans equal exactly
    "ramp": lambda: SUITE["ramp"], "aniso": lambda: SUITE["aniso"], "sparse": lambda: SUITE["sparse"],
    "smooth_big": _smooth_big, "smooth2d": lambda: SUITE["smooth"][:, :, 5].copy(),
    "aniso2d": lambda: SUITE["aniso"][:, 3, :].copy(), "smooth1d": lambda: _line(1000, 0.0),
    "noisy1d": lambda: _line(2000, 0.05),
    # a few codes of losing candidates flip on float ties
    "walk": _walk,
    "golden": lambda: np.load(__import__("pathlib").Path(__file__).parent / "data" / "golden_field.npy"),
    "noisy2d": lambda: SUITE["noisy"][7].copy(),
}
EXACT = {"ramp", "aniso", "sparse", "smooth_big", "smooth2d", "aniso2d", "smooth1d", "noisy1d"}
CASES = [(name, (16, 8)) for name in FIELDS] + [("ramp", (8,)), ("aniso", (16, 8, 4)), ("smooth2d", (8,)),
                                                ("noisy1d", (16,))]


def _blocks(x: np.ndarray):
    padded = rblk.pad_field_batch(x[None], rblk.ANCHOR_STRIDE)
    return rblk.gather_blocks_batch(padded, rblk.ANCHOR_STRIDE), (1,) + padded.shape[1:]


@functools.lru_cache(maxsize=None)
def _plans(name: str, strides: tuple):
    x = FIELDS[name]()
    blocks, fshape = _blocks(x)
    twoeb = 2e-3 * float(x.max() - x.min())
    rp = RA.autotune_plan(blocks, twoeb, strides, field_shape=fshape)
    tp = TA.autotune_plan(torch.from_numpy(blocks), twoeb, strides, field_shape=fshape)
    return rp, tp


@pytest.mark.parametrize("name,strides", CASES, ids=[f"{n}-{'.'.join(map(str, s))}" for n, s in CASES])
def test_plan_matches_the_reference(name, strides):
    rp, tp = _plans(name, strides)
    assert [lbl for lbl, _ in tp.candidates] == [lbl for lbl, _ in rp.candidates]
    assert tp.sampled_blocks == rp.sampled_blocks and tp.anchor_stride in strides
    if name in EXACT:
        assert tp.to_bytes() == rp.to_bytes()
        assert tp.to_header(include_candidates=True) == rp.to_header(include_candidates=True)
    else:
        assert abs(tp.est_bits_per_code - rp.est_bits_per_code) <= 1e-3 * rp.est_bits_per_code


def test_plan_records_round_trip():
    rp, tp = _plans("aniso", (16, 8))
    assert TA.PredictorPlan.from_header(tp.to_header(include_candidates=True)) == tp
    lean = TA.PredictorPlan.from_header(tp.to_header())
    assert (lean.anchor_stride, lean.splines, lean.schemes) == (tp.anchor_stride, tp.splines, tp.schemes)
    assert TA.PredictorPlan.from_bytes(tp.to_bytes()).to_header() == tp.to_header()
    assert TA.PredictorPlan.from_bytes(rp.to_bytes()) == TA.PredictorPlan.from_header(rp.to_header())
    assert str(tp) == str(rp) and tp.levels == rp.levels
    assert tp.steps() == build_steps(tp.ndim, 17, tp.levels, tp.splines, tp.schemes)
    with pytest.raises(ValueError, match="per-level"):
        TA.PredictorPlan(ndim=3, anchor_stride=16, splines=("cubic",) * 3, schemes=("md",) * 3)


def test_candidate_lists_and_baselines_match():
    assert TA.candidate_splines() == RA.candidate_splines()
    for nd in (1, 2, 3):
        assert TA.candidate_schemes(nd) == RA.candidate_schemes(nd)
    for nlev in (2, 3, 4):
        assert TA.fixed_step_baselines(nlev) == RA.fixed_step_baselines(nlev)
    assert (TA.EXHAUSTIVE_BLOCKS, TA.ANCHOR_BITS, TA.OUTLIER_BITS) == (RA.EXHAUSTIVE_BLOCKS, RA.ANCHOR_BITS,
                                                                      RA.OUTLIER_BITS)
    for nb in (1, 8, 64, 65, 216, 4096, 32768):
        assert np.array_equal(TA.plan_sample_indices(nb), RA.plan_sample_indices(nb))


def test_code_bits_match():
    rng = np.random.default_rng(0)
    for _ in range(5):
        hist = rng.integers(0, 1000, 256) * (rng.random(256) < 0.3)
        assert TA._code_bits(hist, int(hist[0])) == RA._code_bits(hist, int(hist[0]))
    assert TA._code_bits(np.zeros(256, np.int64), 0) == 0.0


BUCKET_FIELDS = {
    "smooth": lambda: SUITE["smooth"], "big": lambda: np.random.default_rng(3).standard_normal((50, 50, 50)).astype(
        np.float32) * 1e3, "constant": lambda: np.full((4, 5), 2.5, np.float32),
    "empty": lambda: np.zeros((0, 3), np.float32), "tiny-range": lambda: (1 + 1e-7 * SUITE["noisy"]).astype(np.float32),
}


@pytest.mark.parametrize("name", list(BUCKET_FIELDS))
def test_stats_bucket_and_plan_signature_match(name):
    x = BUCKET_FIELDS[name]()
    b = RA.stats_bucket(x)
    assert TA.stats_bucket(x) == b
    assert TA.stats_bucket(torch.from_numpy(x.copy())) == b
    extra = ("auto", 16, (16, 8), True, True, "auto", (), None)
    sig = RA.plan_signature(x.shape, x.dtype, 1e-3, "rel", b, extra=extra)
    assert TA.plan_signature(x.shape, x.dtype, 1e-3, "rel", b, extra=extra) == sig
    assert TA.plan_signature(torch.Size(x.shape), np.float32, 1e-3, "rel", b, extra=extra) == sig
    assert hash(sig) == hash(TA.plan_signature(x.shape, np.float32, 1e-3, "rel", b, extra=extra))


@pytest.mark.parametrize("name,exact", [("smooth_big", True), ("walk", False)])
@pytest.mark.parametrize("stride", [16, 8])
def test_level_emits_equal_the_reference_greedy_grids(name, exact, stride):
    """Level l's codes of the full-hierarchy pass, read at level l's points,
    are JAX's per-level ``_greedy_levels`` grids."""
    x = FIELDS[name]()
    blocks, _ = _blocks(x)
    sample = blocks[RA.plan_sample_indices(blocks.shape[0])]
    twoeb = 2e-3 * float(x.max() - x.min())
    r_splines, r_schemes, grids = RA._greedy_levels(jnp.asarray(sample), jnp.float32(twoeb), stride, 3, 17)
    greedy, codes, uniform, pts = TA._sweep(torch.from_numpy(sample), twoeb, stride)
    assert greedy == tuple(zip(r_splines, r_schemes))
    assert len(uniform) == len(TA.candidate_splines()) * len(TA.candidate_schemes(3))
    for grid, p in zip(grids, pts):
        ref, got = RA._level_emits(np.asarray(grid)), TA._level_emits(codes, p).numpy()
        assert got.shape == ref.shape
        if exact:
            assert np.array_equal(got, ref)
        else:
            assert (got == ref).mean() >= 0.9999


def _count_trials(monkeypatch):
    seen = []
    real = tinterp.compress_blocks

    def counting(blocks, twoeb, steps, stride, **kw):
        seen.append((steps, stride))
        return real(blocks, twoeb, steps, stride, **kw)

    monkeypatch.setattr(tinterp, "compress_blocks", counting)
    return seen


def test_trial_passes_are_one_kernel_call_per_level_and_candidate(monkeypatch):
    seen = _count_trials(monkeypatch)
    blocks, fshape = _blocks(SUITE["noisy"])
    TA.autotune_plan(torch.from_numpy(blocks), 0.01, (16, 8, 4), field_shape=fshape)
    per_stride = {s: sum(1 for _, st in seen if st == s) for s in (16, 8, 4)}
    assert per_stride == {16: 9 * 4, 8: 9 * 3, 4: 9 * 2}
    assert all(st == s for s in (16, 8, 4) for steps, st in seen if steps[0].level == s // 2)
    # the kernel's step-table cache holds one planner run at every stride
    assert len({id(steps) for steps, _ in seen}) <= tinterp.ops._device_tables.cache_info().maxsize - 8


def test_planner_runs_through_presampled_blocks():
    x = _smooth_big()
    blocks, fshape = _blocks(x)
    twoeb = 2e-3 * float(x.max() - x.min())
    sample = torch.from_numpy(blocks[TA.plan_sample_indices(blocks.shape[0])])
    full = TA.autotune_plan(torch.from_numpy(blocks), twoeb, (8,), field_shape=fshape)
    assert TA.autotune_plan(sample, twoeb, (8,), field_shape=fshape, presampled_of=blocks.shape[0]) == full
