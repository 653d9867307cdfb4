"""The port's compressor against the JAX package on the main path (default
spec: interp, rel 1e-3, autotune, "cr", container v2, verify="sample").

Containers are byte-equal where the code streams are; code streams agree
in >= 99.99% of points (float tie-breaks between frameworks); each package
decodes the other's containers within eb * (1 + 1e-4), the repo-wide
float32 slack.
"""
import pathlib

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import metrics as rm
from repro.core.compressor import _sections_unpack as r_unpack
from repro.core.lossless import pipelines as rpipe
from repro_torch.core import metrics as tm
from repro_torch.core.compressor import _sections_unpack as t_unpack

DATA = pathlib.Path(__file__).parent / "data"
SLACK = 1e-4


def _smooth3d():
    g = np.linspace(0, 4 * np.pi, 48)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.05 * np.cos(3 * X)).astype(np.float32)


def _smooth3d_big():
    g = np.linspace(0, 4 * np.pi, 96)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.3 * np.exp(-((X - 6) ** 2 + (Y - 6) ** 2) / 8)).astype(np.float32)


FIELDS = {"smooth3d": _smooth3d, "smooth3d_big": _smooth3d_big,
          "golden": lambda: np.load(DATA / "golden_field.npy")}


@pytest.fixture(scope="module")
def containers():
    """Per field: (x, reference container, port container, port telemetry)."""
    out = {}
    for name, make in FIELDS.items():
        x = make()
        comp = T.Compressor(device="cpu")
        tb = comp.compress(x)
        out[name] = (x, R.Compressor().compress(x), tb, comp.last_telemetry)
    return out


def _err_over_eb(x, y, buf):
    return float(np.abs(np.asarray(y, np.float64) - x).max()) / R.Compressor.inspect(buf)["eb_abs"]


@pytest.mark.parametrize("name", list(FIELDS))
def test_containers_match_the_reference(containers, name):
    x, rb, tb, _ = containers[name]
    rh, rs = r_unpack(rb)
    th, ts = t_unpack(tb)
    assert th == rh  # same header: eb, padded shape, the autotuned plan, pipeline
    rc, tc = rpipe.decode(rs[0]), rpipe.decode(ts[0])
    assert rc.shape == tc.shape
    agree = (rc == tc).mean()
    assert agree >= 0.9999
    if agree == 1.0:
        assert tb == rb


@pytest.mark.parametrize("name", list(FIELDS))
def test_containers_cross_decode_within_the_bound(containers, name):
    x, rb, tb, _ = containers[name]
    assert _err_over_eb(x, R.Compressor().decompress(tb), tb) <= 1 + SLACK
    for engine in ("numpy", "device"):
        assert _err_over_eb(x, T.Compressor(device="cpu", engine=engine).decompress(rb), rb) <= 1 + SLACK
        assert _err_over_eb(x, T.Compressor(device="cpu", engine=engine).decompress(tb), tb) <= 1 + SLACK


@pytest.mark.parametrize("name", ["smooth3d", "golden"])
def test_device_engine_writes_the_same_container(containers, name):
    x, _, tb, _ = containers[name]
    comp = T.Compressor(device="cpu", engine="device")
    assert comp.compress(torch.from_numpy(x)) == tb
    assert comp.last_telemetry["fallbacks"] == []
    y = comp.decompress(tb, out="device")
    assert isinstance(y, torch.Tensor) and tuple(y.shape) == x.shape and y.dtype == torch.float32
    assert np.array_equal(y.numpy(), T.Compressor(device="cpu").decompress(tb))


def test_verify_telemetry(containers):
    x, _, tb, tel = containers["smooth3d_big"]
    assert tel["fallbacks"] == [] and tel["pipeline"] == "cr"
    v = tel["verify"]
    assert v["mode"] == "sample" and v["checked"] == 1 << 16 and v["repairs"] == 0
    assert v["max_err"] <= v["bound"] * (1 + SLACK)
    assert T.Compressor.inspect(tb) == R.Compressor.inspect(tb)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("engine", ["numpy", "device"])
def test_golden_containers_decode_within_the_bound(version, engine):
    buf = (DATA / f"golden_v{version}.bin").read_bytes()
    x = np.load(DATA / "golden_field.npy")
    comp = T.Compressor(device="cpu", engine=engine)
    y = comp.decompress(buf)
    assert y.shape == x.shape and y.dtype == np.float32
    assert _err_over_eb(x, y, buf) <= 1 + SLACK
    assert np.abs(y - R.Compressor().decompress(buf)).max() <= 2 * R.Compressor.inspect(buf)["eb_abs"]
    if engine == "device":  # these streams carry no hf offset table: the format picks the host decoder
        assert comp.last_telemetry["hf_decode"] == "host-legacy"
        assert comp.last_telemetry["fallbacks"] == []


@pytest.mark.parametrize("anchor_stride", [16, 8])
def test_outliers_on_shared_faces_decode_within_the_bound(anchor_stride):
    """Spikes on block faces, edges and a corner's neighbour are outliers
    that several closed blocks share; each block's decode gets the value."""
    x = _smooth3d()[:40, :36, :33].copy()
    for p in [(16, 5, 7), (16, 16, 9), (32, 16, 1), (3, 32, 32), (17, 16, 16), (16, 8, 8)]:
        x[p] += 50.0
    spec = dict(eb=1e-3, eb_mode="abs", anchor_stride=anchor_stride)
    rb = R.Compressor(R.CompressorSpec(**spec)).compress(x)
    tb = T.Compressor(T.CompressorSpec(**spec), device="cpu").compress(x)
    assert r_unpack(tb)[0]["n_outliers"] >= 6
    for buf in (rb, tb):
        ys = [T.Compressor(device="cpu", engine=e).decompress(buf) for e in ("numpy", "device")]
        assert np.array_equal(ys[0], ys[1])
        assert _err_over_eb(x, ys[0], buf) <= 1 + SLACK
    assert _err_over_eb(x, R.Compressor().decompress(tb), tb) <= 1 + SLACK


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_full_verify_repairs_a_float32_overshoot_at_an_absolute_bound(package):
    """Values near 100 under an absolute bound of 1e-2: one float32 ulp at
    100 is 7.6e-6, so the reconstruction can land beyond eb * (1 + 1e-4).
    Unverified, it does; verify="full" sees it and one repair (a halved
    bound) holds the declared bound. Both packages behave alike."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 40, 40)).astype(np.float32).cumsum(0)
    x[:, 10:14] += 100.0
    mod, kw = (T, {"device": "cpu"}) if package == "torch" else (R, {})

    def roundtrip(verify):
        comp = mod.Compressor(mod.CompressorSpec(eb=1e-2, eb_mode="abs", verify=verify), **kw)
        buf = comp.compress(x)
        return np.asarray(mod.Compressor(**kw).decompress(buf)), buf, comp.last_telemetry

    y, buf, _ = roundtrip("off")
    assert _err_over_eb(x, y, buf) > 1 + SLACK
    y, buf, tel = roundtrip("full")
    assert tel["verify"]["repairs"] == 1 and tel["verify"]["checked"] == x.size
    assert float(np.abs(y.astype(np.float64) - x).max()) <= 1e-2


@pytest.mark.parametrize("shape", [(12, 10, 9), (1,), (40,), (3, 4, 5, 6)])
def test_constant_field(shape):
    x = np.full(shape, 3.25, np.float32)
    tb = T.Compressor(device="cpu").compress(x)
    assert tb == R.Compressor().compress(x)
    y = T.Compressor(device="cpu").decompress(tb)
    assert y.shape == shape and np.all(y == np.float32(3.25))


@pytest.mark.parametrize("spec", [
    dict(eb=1e-2, eb_mode="abs"), dict(anchor_stride=8), dict(autotune=False, pipeline="hf", reorder=False),
    dict(backend="pallas", verify="full"),
])
def test_spec_variants_match_the_reference(spec):
    x = np.load(DATA / "golden_field.npy")
    rb = R.Compressor(R.CompressorSpec(**spec)).compress(x)
    tb = T.Compressor(T.CompressorSpec(**spec), device="cpu").compress(x)
    assert r_unpack(tb)[0] == r_unpack(rb)[0]
    assert _err_over_eb(x, R.Compressor().decompress(tb), tb) <= 1 + SLACK
    assert _err_over_eb(x, T.Compressor(device="cpu").decompress(rb), rb) <= 1 + SLACK


@pytest.mark.parametrize("shape", [(2, 20, 18, 19), (50, 45), (300,)])
def test_batched_and_low_rank_fields(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32).cumsum(-1)
    rb = R.Compressor().compress(x)
    tb = T.Compressor(device="cpu").compress(x)
    assert r_unpack(tb)[0] == r_unpack(rb)[0]
    y = T.Compressor(device="cpu").decompress(rb)
    assert y.shape == shape and _err_over_eb(x, y, rb) <= 1 + SLACK


@pytest.mark.parametrize("case", ["smooth", "constant", "nonfinite", "empty"])
def test_metrics_match_the_reference(case):
    rng = np.random.default_rng(4)
    x = {"smooth": _smooth3d()[:20], "constant": np.full((5, 6), 2.0, np.float32),
         "nonfinite": np.array([1.0, np.nan, 3.0, np.inf], np.float32), "empty": np.zeros(0, np.float32)}[case]
    y = (x + rng.normal(0, 1e-3, x.shape)).astype(np.float32)
    buf = b"\0" * 97
    assert tm.value_range(x) == rm.value_range(x)
    assert tm.max_abs_err(x, y) == rm.max_abs_err(x, y)
    assert tm.psnr(x, y) == rm.psnr(x, y)
    assert tm.compression_ratio(x, buf) == rm.compression_ratio(x, buf)
    assert tm.max_abs_err(torch.from_numpy(x), torch.from_numpy(y)) == rm.max_abs_err(x, y)
