"""repro_torch.testing against repro.testing, and the port's guarantees under it.

The injectors give the JAX package's bytes for the same seed and offsets,
and the adversarial corpus the same fields. The encoder-fault hook
(``perturb_quant_codes``) perturbs as many codes of the port's predictor as
the JAX package's injector does of its own, ``verify="sample"`` repairs the
violation, ``verify="off"`` keeps it, and a persistent fault raises
``BoundViolationError``. The corpus sweep holds the port to bound-or-typed-
error under abs, rel and pw_rel, as ``tests/test_adversarial.py`` holds the
JAX package."""
import io

import numpy as np
import pytest
import torch

import repro.core as R
import repro.testing as rt
import repro_torch.core as T
import repro_torch.testing as tt
from repro_torch.core import compressor as tcomp
from repro_torch.core.errors import BoundViolationError, SpecError

SEEDS = (0, 1, 7, 20260808)
SPECS = ("lossy,abs,1e-2,verify=full", "lossy,rel,1e-3,verify=full", "lossy,pw_rel,1e-2,verify=full")
TYPED_ERRORS = (ValueError, SpecError, BoundViolationError)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _field(shape=(32, 32, 32), seed=None):
    """tests/test_guarantees.py's field: a normalised random walk."""
    rng = rt.fault_rng(seed)
    x = rng.standard_normal(shape)
    for ax in range(x.ndim):
        x = np.cumsum(x, axis=ax)
    return (x / max(1.0, float(np.max(np.abs(x))))).astype(np.float32)


@pytest.fixture(scope="module")
def v3_streams():
    """A sync-marked and a plain v3 stream of four chunks (the port's writer)."""
    x = _field((24, 20))
    return {sync: T.chunk_compress(x, n_chunks=4, device="cpu", sync=sync) for sync in (False, True)}


# ------------------------------------------------------------------ injectors
def test_fault_seed_reads_the_same_variable(monkeypatch):
    assert tt.fault_seed() == rt.fault_seed()
    for raw in ("123", "not a number"):
        monkeypatch.setenv("REPRO_FAULTS", raw)
        assert tt.fault_seed() == rt.fault_seed()
        assert tt.fault_seed(5) == rt.fault_seed(5)
    assert np.array_equal(tt.fault_rng().integers(0, 1 << 30, 8), rt.fault_rng().integers(0, 1 << 30, 8))


@pytest.mark.parametrize("seed", SEEDS)
def test_storage_injectors_give_the_jax_bytes(seed):
    buf = np.random.default_rng(seed).integers(0, 256, 997, dtype=np.uint8).tobytes()
    for offset in (0, 1, 500, 996, -1, -997):
        for bit in (0, 3, 7, 9):
            assert tt.bit_flip(buf, offset, bit) == rt.bit_flip(buf, offset, bit)
    for frac in (0.0, 0.25, 0.5, 0.999, 1.0):
        assert tt.truncate_fraction(buf, frac) == rt.truncate_fraction(buf, frac)
        for garbage in (0, 1, 64):
            assert (tt.torn_tail(buf, frac, garbage=garbage, seed=seed)
                    == rt.torn_tail(buf, frac, garbage=garbage, seed=seed))
    for mod in (tt, rt):
        with pytest.raises(ValueError):
            mod.truncate_fraction(buf, 1.5)


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_frame_injectors_give_the_jax_bytes(v3_streams, sync, seed):
    buf = v3_streams[sync]
    rng = np.random.default_rng(seed)
    for index in range(4):
        assert tt.drop_frame(buf, index) == rt.drop_frame(buf, index)
        for offset in (0, int(rng.integers(1, 40)), -1):
            bit = int(rng.integers(0, 8))
            assert tt.corrupt_frame(buf, index, offset=offset, bit=bit) == rt.corrupt_frame(
                buf, index, offset=offset, bit=bit)
    for mod in (tt, rt):
        with pytest.raises(ValueError):
            mod.corrupt_frame(buf, 0, offset=1 << 20)


@pytest.mark.parametrize("fail_ops", [("write", "read"), ("write",), ("flush",)])
def test_flaky_file_fails_the_same_calls(fail_ops):
    def run(mod):
        sink = io.BytesIO()
        f = mod.FlakyFile(sink, fail_calls={2, 3}, fail_ops=fail_ops)
        outcome = []
        for op in ("write", "write", "flush", "write", "flush", "read"):
            try:
                getattr(f, op)(*((b"ab",) if op == "write" else ()))
                outcome.append("ok")
            except OSError:
                outcome.append("fault")
        return outcome, f.calls, f.faults, sink.getvalue()

    assert run(tt) == run(rt)


# --------------------------------------------------------------------- corpus
def test_corpus_registry_is_the_jax_one():
    assert list(tt.CORPUS) == list(rt.CORPUS)


@pytest.mark.parametrize("seed", (None, 0, 123))
@pytest.mark.parametrize("name", sorted(rt.CORPUS))
def test_corpus_fields_are_bit_equal(name, seed):
    a, b = tt.corpus_field(name, seed=seed), rt.corpus_field(name, seed=seed)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------- encoder fault
def _jax_perturbed(x, **kw) -> int:
    with rt.perturb_quant_codes(**kw) as stats:
        R.Compressor(R.CompressorSpec(eb=1e-3, verify="off")).compress(x)
    return stats["perturbed"]


def test_injected_violation_caught_and_repaired():
    x = _field()
    comp = T.Compressor(T.CompressorSpec(eb=1e-3, verify="sample"), device="cpu")
    with tt.perturb_quant_codes(n_calls=1, delta=8, frac=0.02) as stats:
        buf = comp.compress(x)
    assert stats["perturbed"] > 0
    assert stats["perturbed"] == _jax_perturbed(x, n_calls=1, delta=8, frac=0.02)
    tel = comp.last_telemetry
    assert tel["verify"]["mode"] == "sample" and tel["verify"]["repairs"] >= 1
    y = comp.decompress(buf)
    rng = float(np.max(x)) - float(np.min(x))
    assert np.max(np.abs(x.astype(np.float64) - y.astype(np.float64))) <= 1e-3 * rng * (1 + 2e-4)
    assert tcomp._CODE_FAULT is None  # disarmed on exit


def test_injected_violation_off_mode_is_silent():
    x = _field()
    comp = T.Compressor(T.CompressorSpec(eb=1e-3, verify="off"), device="cpu")
    with tt.perturb_quant_codes(n_calls=1, delta=8, frac=0.02) as stats:
        buf = comp.compress(x)
    assert stats["perturbed"] == _jax_perturbed(x, n_calls=1, delta=8, frac=0.02) > 0
    y = comp.decompress(buf)
    rng = float(np.max(x)) - float(np.min(x))
    assert np.max(np.abs(x.astype(np.float64) - y.astype(np.float64))) > 1e-3 * rng


def test_persistent_fault_exhausts_ladder():
    x = _field()
    comp = T.Compressor(T.CompressorSpec(eb=1e-3, verify="sample"), device="cpu")
    with tt.perturb_quant_codes(n_calls=99, delta=16, frac=0.05) as stats:
        with pytest.raises(BoundViolationError) as ei:
            comp.compress(x)
    assert stats["calls"] == 1 + ei.value.repairs  # the first encode and every repair rung
    assert ei.value.repairs >= 1
    assert ei.value.max_err > ei.value.bound > 0


def test_planner_trials_never_reach_the_hook():
    """predictor="auto" runs dozens of trial encodes before its one real
    predictor pass; only that pass is perturbed, as in the JAX package."""
    x = _field((24, 24, 24))
    comp = T.Compressor(T.CompressorSpec(eb=1e-3, predictor="auto", verify="off"), device="cpu")
    with tt.perturb_quant_codes(n_calls=99, frac=0.01) as stats:
        comp.compress(x)
    assert stats["calls"] == 1 and stats["perturbed"] > 0


def test_fault_reaches_each_chunk_frame():
    """The port's v3 frames are compress() of each chunk (shard_compress's
    too), so a fault armed for every call perturbs each frame's predictor
    pass once."""
    x = _field((32, 24))
    with tt.perturb_quant_codes(n_calls=99, frac=0.05) as stats:
        T.chunk_compress(x, n_chunks=4, spec=T.CompressorSpec(verify="off"), device="cpu")
    assert stats["calls"] == 4


# ----------------------------------------------------------- adversarial sweep
def _assert_bound(x: np.ndarray, y: np.ndarray, spec) -> None:
    assert y.shape == x.shape and y.dtype == np.float32
    fin = np.isfinite(x)
    assert np.array_equal(_bits(x[~fin]), _bits(y[~fin]))
    assert np.isfinite(y[fin]).all()
    if not fin.any():
        return
    xf, yf = x[fin].astype(np.float64), y[fin].astype(np.float64)
    tol = 2e-4  # the systemwide f32-rounding slack (1e-4) plus margin, as tests/test_adversarial.py
    if spec.eb_mode == "abs":
        assert np.max(np.abs(xf - yf)) <= spec.eb * (1 + tol)
    elif spec.eb_mode == "rel":
        rng = float(np.max(xf)) - float(np.min(xf))
        assert np.max(np.abs(xf - yf)) <= spec.eb * rng * (1 + tol) + 1e-30
    else:
        zero = xf == 0.0
        assert np.array_equal(_bits(x[fin][zero]), _bits(y[fin][zero]))
        nz = ~zero
        if nz.any():
            assert np.max(np.abs(xf[nz] - yf[nz]) / np.abs(xf[nz])) <= spec.eb * (1 + tol)


@pytest.mark.parametrize("spec_str", SPECS)
@pytest.mark.parametrize("name", sorted(rt.CORPUS))
def test_bound_or_typed_error(name, spec_str):
    x = tt.corpus_field(name, seed=tt.fault_seed())
    spec = T.CompressorSpec.from_string(spec_str)
    comp = T.Compressor(spec, device="cpu")
    try:
        buf = comp.compress(x)
    except TYPED_ERRORS:
        return  # a typed refusal is a legal outcome; silence is not
    _assert_bound(x, comp.decompress(buf), spec)


@pytest.mark.parametrize("name", sorted(rt.CORPUS))
def test_default_verify_sample_contract(name):
    x = tt.corpus_field(name, seed=tt.fault_seed())
    spec = T.CompressorSpec(eb=1e-3)
    comp = T.Compressor(spec, device="cpu")
    try:
        buf = comp.compress(x)
    except TYPED_ERRORS:
        return
    if np.isfinite(x).any() and not np.isfinite(x).all():
        assert comp.last_telemetry.get("nonfinite", {}).get("n", 0) > 0
    _assert_bound(x, comp.decompress(buf), spec)

