"""The port's remaining single-field modes against the JAX package:
``cusz_hi_auto`` and ``cusz_hi_autoplan`` (the planner and the
orchestrator), ``cusz_hi_crz`` (zstd tail, under both codecs),
``cuszp2_like`` (offset1d + fixed-length encoding), NaN/Inf ingest (the
nfsafe and nonfinite containers), ``pw_rel`` and ``psnr_target``.

Each container decodes in the other package within its bound
(``eb * (1 + 1e-4)``, point-wise relative for pw_rel, the target for
psnr_target), both ways; where the two packages' code streams agree the
containers are byte-equal, and they agree in >= 99.99 % of codes
everywhere; ``inspect`` gives the same dict; the device engine's torch
twins on CPU tensors give the host route's bytes."""
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.lossless import flenc as rfl
from repro.core.lossless import pipelines as rpipe
from repro_torch.core.compressor import _sections_unpack


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and torch's spinning thread pools in all of
    them oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def registries_as_shipped(monkeypatch):
    """Both packages' pipeline registries without the pipelines another test
    file registered into one of them and left there (tests/test_orchestrate.py
    registers a third-party pipeline in the JAX package's): pipeline="auto"
    weighs every registered pipeline, so a leftover would change one side's
    choice and the containers compared here."""
    from repro.core.lossless import pipelines as rpp
    from repro_torch.core.lossless import pipelines as tpp

    for name in set(rpp.PIPELINES) - set(tpp.PIPELINES):
        monkeypatch.delitem(rpp.PIPELINES, name)
    for name in set(tpp.PIPELINES) - set(rpp.PIPELINES):
        monkeypatch.delitem(tpp.PIPELINES, name)

DATA = pathlib.Path(__file__).parent / "data"
SLACK = 1e-4


def _smooth_big():
    g = np.linspace(0, 4 * np.pi, 96)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.3 * np.exp(-((X - 6) ** 2 + (Y - 6) ** 2) / 8)).astype(np.float32)


def _golden_nonfinite():
    x = np.load(DATA / "golden_field.npy").copy()
    x.reshape(-1)[::97] = np.float32(np.nan)
    x[1, 2, 3], x[4, 5, 6], x[7, 8, 9] = np.inf, -np.inf, np.nan
    x.view(np.uint32)[2, 2, 2] = 0x7FC0BEEF  # a NaN payload
    return x


def _golden_zeros():
    x = np.load(DATA / "golden_field.npy").copy()
    x.reshape(-1)[::13] = 0.0
    x.reshape(-1)[5::29] = -0.0
    return x


FIELDS = {"golden": lambda: np.load(DATA / "golden_field.npy"), "golden_nonfinite": _golden_nonfinite,
          "golden_zeros": _golden_zeros, "smooth3d_big": _smooth_big}
MODES = {
    "cusz_hi_auto": dict(pipeline="auto"),
    "cusz_hi_autoplan": dict(predictor="auto", pipeline="auto"),
    "cusz_hi_crz": dict(pipeline="crz"),
    "cuszp2_like": dict(predictor="offset1d", pipeline="none"),
    "pw_rel": dict(eb_mode="pw_rel", eb=1e-2),
    "psnr_target": dict(psnr_target=60.0),
    "autoplan_pw_rel": dict(predictor="auto", pipeline="auto", eb_mode="pw_rel", eb=1e-2),
}
CASES = [(m, f) for m in MODES for f in ("golden", "golden_nonfinite") if (m, f) != ("autoplan_pw_rel", "golden")] + [
    ("cusz_hi_autoplan", "smooth3d_big"), ("cuszp2_like", "smooth3d_big"), ("pw_rel", "golden_zeros")]
IDS = [f"{m}-{f}" for m, f in CASES]
_CACHE: dict = {}


def _pair(mode: str, field: str):
    """(x, port container, port telemetry, port plan, reference container, reference compressor)."""
    key = (mode, field)
    if key not in _CACHE:
        x = FIELDS[field]()
        tc = T.Compressor(T.CompressorSpec(**MODES[mode]), device="cpu")
        tb = tc.compress(x)
        rc = R.Compressor(R.CompressorSpec(**MODES[mode]))
        _CACHE[key] = (x, tb, tc.last_telemetry, tc.last_plan, rc.compress(x), rc)
    return _CACHE[key]


def _codes(buf: bytes) -> np.ndarray:
    """The quantization codes a container carries (through wrapper modes)."""
    header, sections = _sections_unpack(buf)
    if header["mode"] in ("pw_rel", "nfsafe"):
        return _codes(bytes(sections[0]))
    if header["mode"] == "offset1d":
        return rfl.fl_decode(bytes(sections[0]), header["fl"])
    if header["mode"] in ("const", "nonfinite"):
        return np.zeros(0, np.uint8)
    return rpipe.decode(sections[0])


def _innermost(info: dict) -> dict:
    """The inspect dict of the container a wrapper (nfsafe, pw_rel) holds."""
    return _innermost(info["inner"]) if "inner" in info else info


def _check_decode(mode: str, x: np.ndarray, y: np.ndarray, buf: bytes):
    fin = np.isfinite(x)
    assert np.array_equal(y.view(np.uint32)[~fin], x.view(np.uint32)[~fin])  # exact bit patterns
    xf, yf = x[fin].astype(np.float64), y[fin].astype(np.float64)
    spec = MODES[mode]
    if spec.get("eb_mode") == "pw_rel":
        nz = xf != 0
        assert float((np.abs(yf[nz] - xf[nz]) / np.abs(xf[nz])).max()) <= spec["eb"] * (1 + SLACK)
        assert np.array_equal(y[x == 0].view(np.uint32), x[x == 0].view(np.uint32))  # zeros and their signs
    elif "psnr_target" in spec:
        mse = float(np.mean((yf - xf) ** 2))
        assert 10 * np.log10((xf.max() - xf.min()) ** 2 / mse) >= spec["psnr_target"]
    else:
        assert float(np.abs(yf - xf).max()) <= _innermost(T.Compressor.inspect(buf))["eb_abs"] * (1 + SLACK)


@pytest.mark.parametrize("mode,field", CASES, ids=IDS)
def test_containers_match_the_reference(mode, field):
    x, tb, tel, plan, rb, rc = _pair(mode, field)
    tcodes, rcodes = _codes(tb), _codes(rb)
    assert tcodes.shape == rcodes.shape
    agree = float((tcodes == rcodes).mean()) if tcodes.size else 1.0
    assert agree >= 0.9999
    if agree == 1.0:
        assert tb == rb
    assert T.Compressor.inspect(tb) == R.Compressor.inspect(tb)
    assert T.Compressor.inspect(rb) == R.Compressor.inspect(rb)
    rtel = rc.last_telemetry
    assert tel.get("pipeline") == rtel.get("pipeline") and tel.get("nonfinite") == rtel.get("nonfinite")
    assert tel.get("psnr_search") == rtel.get("psnr_search")
    if MODES[mode].get("predictor") == "auto":
        assert plan is not None and str(plan) == str(rc.last_plan)
        assert _innermost(T.Compressor.inspect(tb))["pplan"] == _innermost(R.Compressor.inspect(rb))["pplan"]


@pytest.mark.parametrize("mode,field", CASES, ids=IDS)
def test_containers_cross_decode_within_the_bound(mode, field):
    x, tb, _, _, rb, _ = _pair(mode, field)
    _check_decode(mode, x, R.Compressor().decompress(tb), tb)
    for engine in ("numpy", "device"):
        tc = T.Compressor(T.CompressorSpec(engine=engine), device="cpu")
        _check_decode(mode, x, tc.decompress(rb), rb)
        _check_decode(mode, x, tc.decompress(tb), tb)


@pytest.mark.parametrize("mode", list(MODES))
def test_device_engine_gives_the_host_route_bytes(mode):
    x, tb, _, _, _, _ = _pair(mode, "golden_nonfinite")
    tc = T.Compressor(T.CompressorSpec(engine="device", **MODES[mode]), device="cpu")
    assert tc.compress(x) == tb


@pytest.mark.parametrize("codec", ["zstandard", "zlib"])
def test_crz_containers_under_both_codecs(codec, monkeypatch):
    if codec == "zstandard":
        pytest.importorskip("zstandard")
    else:
        monkeypatch.setitem(sys.modules, "zstandard", None)
    x = np.load(DATA / "golden_field.npy")
    tc = T.cusz_hi_crz(device="cpu")
    tb = tc.compress(x)
    assert tb == R.cusz_hi_crz().compress(x)
    _check_decode("cusz_hi_crz", x, R.Compressor().decompress(tb), tb)
    _check_decode("cusz_hi_crz", x, T.Compressor(device="cpu").decompress(tb), tb)


def test_presets_are_the_reference_specs():
    for name in ("cusz_hi_auto", "cusz_hi_autoplan", "cusz_hi_crz", "cuszp2_like"):
        assert getattr(T, name)(device="cpu").spec.to_string() == getattr(R, name)().spec.to_string()


def test_all_nonfinite_field():
    x = np.full((5, 6), np.nan, np.float32)
    x[0, :3] = [np.inf, -np.inf, np.float32(np.nan)]
    tc = T.Compressor(device="cpu")
    tb = tc.compress(x)
    assert tb == R.Compressor().compress(x) and T.Compressor.inspect(tb)["mode"] == "nonfinite"
    assert tc.last_telemetry["nonfinite"] == {"n": 30, "total": 30}
    for y in (tc.decompress(tb), R.Compressor().decompress(tb)):
        assert np.array_equal(y.view(np.uint32), x.view(np.uint32))


@pytest.mark.parametrize("n_bad", [1, 2, 5, 6])
def test_nonfinite_fill_is_the_reference_median(n_bad):
    """np.median averages the two middle values of an even count in float32."""
    x = (np.random.default_rng(n_bad).standard_normal(64) * 1e3).astype(np.float32).reshape(4, 4, 4)
    x.reshape(-1)[:n_bad] = np.nan
    fill = T.Compressor.inspect(T.Compressor(device="cpu").compress(x))["fill"]
    assert fill == R.Compressor.inspect(R.Compressor().compress(x))["fill"]


def test_pw_rel_below_float32_resolution_raises_like_the_reference():
    x = np.load(DATA / "golden_field.npy")
    with pytest.raises(ValueError, match="resolution"):
        R.Compressor(R.CompressorSpec(eb_mode="pw_rel", eb=1e-9)).compress(x)
    with pytest.raises(ValueError, match="resolution"):
        T.Compressor(T.CompressorSpec(eb_mode="pw_rel", eb=1e-9), device="cpu").compress(x)


def test_psnr_target_constant_field_is_const():
    x = np.full((9, 9), 3.5, np.float32)
    tb = T.Compressor(T.CompressorSpec(psnr_target=40.0), device="cpu").compress(x)
    assert tb == R.Compressor(R.CompressorSpec(psnr_target=40.0)).compress(x)
    assert T.Compressor.inspect(tb)["mode"] == "const"
