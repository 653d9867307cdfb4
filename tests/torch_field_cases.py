"""Fields and container checks shared by the port's compressor and Lorenzo
tests, which are split by field so that each file's module fixture
compresses one field (``--dist loadfile`` runs each file whole on one
worker). Not a test file.
"""
import pathlib

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.compressor import _sections_unpack as r_unpack
from repro.core.lossless import pipelines as rpipe
from repro_torch.core.compressor import _sections_unpack as t_unpack

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while a module runs (the suite runs in several
    worker processes at once; each module's fixture compresses with both
    packages)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SLACK = 1e-4
PRESETS = ["fzgpu_like", "cusz_l", "cusz_hi_tp"]


def smooth3d():
    g = np.linspace(0, 4 * np.pi, 48)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.05 * np.cos(3 * X)).astype(np.float32)


def smooth3d_big():
    g = np.linspace(0, 4 * np.pi, 96)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.3 * np.exp(-((X - 6) ** 2 + (Y - 6) ** 2) / 8)).astype(np.float32)


def spiky():
    """A random walk with forced outliers: spikes far beyond 127 * 2eb."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((30, 33, 37)).astype(np.float32).cumsum(2)
    x.reshape(-1)[rng.choice(x.size, 200, replace=False)] += rng.choice([-50.0, 50.0], 200).astype(np.float32)
    return x


def golden():
    return np.load(DATA / "golden_field.npy")


def err_over_eb(x, y, buf):
    return float(np.abs(np.asarray(y, np.float64) - x).max()) / R.Compressor.inspect(buf)["eb_abs"]


# ------------------------------------------------ the main path (default spec)
def compressor_containers(fields: dict) -> dict:
    """Per field: (x, reference container, port container, port telemetry)."""
    out = {}
    for name, make in fields.items():
        x = make()
        comp = T.Compressor(device="cpu")
        tb = comp.compress(x)
        out[name] = (x, R.Compressor().compress(x), tb, comp.last_telemetry)
    return out


def check_containers_match(containers, name):
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


def check_cross_decode(containers, name):
    x, rb, tb, _ = containers[name]
    assert err_over_eb(x, R.Compressor().decompress(tb), tb) <= 1 + SLACK
    for engine in ("numpy", "device"):
        assert err_over_eb(x, T.Compressor(device="cpu", engine=engine).decompress(rb), rb) <= 1 + SLACK
        assert err_over_eb(x, T.Compressor(device="cpu", engine=engine).decompress(tb), tb) <= 1 + SLACK


def check_device_engine(containers, name):
    x, _, tb, _ = containers[name]
    comp = T.Compressor(device="cpu", engine="device")
    assert comp.compress(torch.from_numpy(x)) == tb
    assert comp.last_telemetry["fallbacks"] == []
    y = comp.decompress(tb, out="device")
    assert isinstance(y, torch.Tensor) and tuple(y.shape) == x.shape and y.dtype == torch.float32
    assert np.array_equal(y.numpy(), T.Compressor(device="cpu").decompress(tb))


# ------------------------------------------------ Lorenzo and the TP preset
def lorenzo_containers(fields: dict) -> dict:
    """Per (field, preset): (x, reference container, port container, port telemetry)."""
    out = {}
    for name, make in fields.items():
        x = make()
        for preset in PRESETS:
            comp = getattr(T, preset)(device="cpu")
            tb = comp.compress(x)
            out[name, preset] = (x, getattr(R, preset)().compress(x), tb, comp.last_telemetry)
    return out


def check_lorenzo_containers_match(containers, field, preset):
    x, rb, tb, tel = containers[field, preset]
    rh, rs = r_unpack(rb)
    th, ts = t_unpack(tb)
    assert th == rh
    assert tel["fallbacks"] == [] and tel["verify"]["repairs"] == 0
    if th["mode"] == "lorenzo":
        assert tb == rb
        return
    rc, tc = rpipe.decode(rs[0]), rpipe.decode(ts[0])
    assert rc.shape == tc.shape and (rc == tc).mean() >= 0.9999
    if (rc == tc).all():
        assert tb == rb


def check_lorenzo_cross_decode(containers, field, preset):
    x, rb, tb, _ = containers[field, preset]
    assert err_over_eb(x, R.Compressor().decompress(tb), tb) <= 1 + SLACK
    for engine in ("numpy", "device"):
        for buf in (rb, tb):
            y = T.Compressor(device="cpu", engine=engine).decompress(buf)
            assert y.shape == x.shape and err_over_eb(x, y, buf) <= 1 + SLACK


def check_lorenzo_device_engine(containers, field, preset):
    x, rb, _, _ = containers[field, preset]
    comp = T.Compressor(getattr(T, preset)(device="cpu").spec, device="cpu", engine="device")
    assert comp.compress(torch.from_numpy(x)) == rb
    y = comp.decompress(rb, out="device")
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    assert np.array_equal(y.numpy(), T.Compressor(device="cpu", engine="numpy").decompress(rb))
