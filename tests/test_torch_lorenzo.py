"""The port's Lorenzo path and the throughput (TP) preset against the JAX
package: the plain Lorenzo encode/decode (the lorenzo3d kernel's plain
version), the Pallas kernel in interpret mode, and the ``fzgpu_like``,
``cusz_l`` and ``cusz_hi_tp`` containers.

Lorenzo is integer arithmetic after one f32 division, so its containers are
byte-equal to the JAX package's; the TP containers are byte-equal wherever
the interp codes agree (float tie-breaks between frameworks, as for the
CR path). Each package decodes the other's containers within
eb * (1 + 1e-4), the repo-wide float32 slack.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as R
import repro_torch.core as T
from repro.core import lorenzo as rlor
from repro.core.compressor import _sections_unpack as r_unpack
from repro.core.lossless import pipelines as rpipe
from repro.kernels.lorenzo3d.ops import lorenzo_encode_pallas
from repro_torch.core import lorenzo as tlor
from repro_torch.core.compressor import _sections_unpack as t_unpack
from repro_torch.kernels import lorenzo3d as klor

SLACK = 1e-4


def _smooth3d():
    g = np.linspace(0, 4 * np.pi, 48)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.05 * np.cos(3 * X)).astype(np.float32)


def _smooth3d_big():
    g = np.linspace(0, 4 * np.pi, 96)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.3 * np.exp(-((X - 6) ** 2 + (Y - 6) ** 2) / 8)).astype(np.float32)


def _spiky():
    """A random walk with forced outliers: spikes far beyond 127 * 2eb."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((30, 33, 37)).astype(np.float32).cumsum(2)
    x.reshape(-1)[rng.choice(x.size, 200, replace=False)] += rng.choice([-50.0, 50.0], 200).astype(np.float32)
    return x


FIELDS = {"smooth3d": _smooth3d, "smooth3d_big": _smooth3d_big, "spiky": _spiky}
PRESETS = ["fzgpu_like", "cusz_l", "cusz_hi_tp"]


def _err_over_eb(x, y, buf):
    return float(np.abs(np.asarray(y, np.float64) - x).max()) / R.Compressor.inspect(buf)["eb_abs"]


def _shaped(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32).cumsum(-1)
    x.reshape(-1)[:: 97] *= 300.0  # outliers
    return x


SHAPES = [((500,), 1), ((37, 45), 2), ((13, 17, 19), 3), ((3, 9, 10, 11), 3), ((2, 4, 40, 50), 2), ((6, 70), 1)]


@pytest.mark.parametrize("shape,nd", SHAPES, ids=lambda v: str(v))
def test_plain_lorenzo_equals_the_reference(shape, nd):
    x = _shaped(shape, sum(shape))
    twoeb = np.float32(0.02)
    rc, ro, rfull, _ = rlor.lorenzo_encode(jnp.asarray(x), jnp.float32(twoeb), nd)
    tc, to, tfull = tlor.lorenzo_encode(torch.from_numpy(x), float(twoeb), nd)
    assert np.array_equal(tc.numpy(), np.asarray(rc))
    assert np.array_equal(to.numpy(), np.asarray(ro)) and to.any()
    assert np.array_equal(tfull.numpy(), np.asarray(rfull))
    ofull = np.where(np.asarray(ro), np.asarray(rfull), 0).astype(np.int32)
    ry = np.asarray(rlor.lorenzo_decode(rc, jnp.asarray(ofull), jnp.float32(twoeb), nd))
    ty = tlor.lorenzo_decode(tc, torch.from_numpy(ofull), float(twoeb), nd)
    assert np.array_equal(ty.numpy(), ry)
    assert float(np.abs(ry - x).max()) <= twoeb / 2 * (1 + SLACK)
    # the kernel's wrapper on a CPU tensor: codes, and the outliers as ascending flat indices
    kc, ki, kv = klor.lorenzo_encode(torch.from_numpy(x), float(twoeb), nd)
    fi = np.flatnonzero(np.asarray(ro).reshape(-1))
    assert np.array_equal(kc.numpy(), np.asarray(rc))
    assert np.array_equal(ki.numpy(), fi) and np.array_equal(kv.numpy(), np.asarray(rfull).reshape(-1)[fi])


@pytest.mark.parametrize("shape", [(8, 16, 128), (20, 9, 130)])
def test_plain_lorenzo_equals_the_pallas_kernel(shape):
    x = _shaped(shape, 11)
    twoeb = 0.05
    ck, ok, cfk = lorenzo_encode_pallas(x, twoeb)
    tc, to, tfull = tlor.lorenzo_encode(torch.from_numpy(x), twoeb, 3)
    assert np.array_equal(tc.numpy(), ck) and np.array_equal(to.numpy(), ok) and ok.any()
    assert np.array_equal(tfull.numpy(), cfk)


def test_int32_edges_follow_the_reference():
    """|x| / 2eb beyond 2^31 saturates, the deltas wrap, and a delta of
    INT32_MIN is no outlier (JAX's wrapping abs) and clips to code 1."""
    x = np.array([[[1e4, -1e4, 5e3, 3e9, -3e9, 1e38, -1e38, 0.0, 1.0]]], np.float32)
    twoeb = 2e-6
    rc, ro, rfull, _ = rlor.lorenzo_encode(jnp.asarray(x), jnp.float32(twoeb), 3)
    tc, to, tfull = tlor.lorenzo_encode(torch.from_numpy(x), twoeb, 3)
    assert np.array_equal(tfull.numpy(), np.asarray(rfull)) and int(tfull.min()) == -2**31
    assert np.array_equal(tc.numpy(), np.asarray(rc)) and np.array_equal(to.numpy(), np.asarray(ro))
    assert np.array_equal(tlor.prequantize(torch.from_numpy(x), twoeb).numpy(),
                          np.asarray(jnp.rint(jnp.asarray(x) / jnp.float32(twoeb)).astype(jnp.int32)))


@pytest.mark.parametrize("preset", ["fzgpu_like", "cusz_l"])
def test_saturating_field_fails_verify_as_in_the_reference(preset):
    """abs eb 1e-6 on a field near 1e4: x / 2eb passes 2^31. Both packages
    write the same container with verify off, and both refuse it with verify on."""
    x = (1e4 + np.random.default_rng(3).standard_normal((16, 16, 16))).astype(np.float32)
    spec = dict(eb=1e-6, eb_mode="abs", predictor="lorenzo", pipeline=getattr(R, preset)().spec.pipeline)
    rb = R.Compressor(R.CompressorSpec(verify="off", **spec)).compress(x)
    assert T.Compressor(T.CompressorSpec(verify="off", **spec), device="cpu").compress(x) == rb
    with pytest.raises(R.BoundViolationError):
        R.Compressor(R.CompressorSpec(**spec)).compress(x)
    with pytest.raises(T.BoundViolationError):
        T.Compressor(T.CompressorSpec(**spec), device="cpu").compress(x)


@pytest.fixture(scope="module")
def containers():
    """Per (field, preset): (x, reference container, port container, port telemetry)."""
    out = {}
    for name, make in FIELDS.items():
        x = make()
        for preset in PRESETS:
            comp = getattr(T, preset)(device="cpu")
            tb = comp.compress(x)
            out[name, preset] = (x, getattr(R, preset)().compress(x), tb, comp.last_telemetry)
    return out


CASES = [(f, p) for f in FIELDS for p in PRESETS]


@pytest.mark.parametrize("field,preset", CASES)
def test_containers_match_the_reference(containers, field, preset):
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


@pytest.mark.parametrize("field,preset", CASES)
def test_containers_cross_decode_within_the_bound(containers, field, preset):
    x, rb, tb, _ = containers[field, preset]
    assert _err_over_eb(x, R.Compressor().decompress(tb), tb) <= 1 + SLACK
    for engine in ("numpy", "device"):
        for buf in (rb, tb):
            y = T.Compressor(device="cpu", engine=engine).decompress(buf)
            assert y.shape == x.shape and _err_over_eb(x, y, buf) <= 1 + SLACK


@pytest.mark.parametrize("field", ["smooth3d", "spiky"])
@pytest.mark.parametrize("preset", ["fzgpu_like", "cusz_l"])
def test_device_engine_writes_the_same_lorenzo_container(containers, field, preset):
    x, rb, _, _ = containers[field, preset]
    comp = T.Compressor(getattr(T, preset)(device="cpu").spec, device="cpu", engine="device")
    assert comp.compress(torch.from_numpy(x)) == rb
    y = comp.decompress(rb, out="device")
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    assert np.array_equal(y.numpy(), T.Compressor(device="cpu", engine="numpy").decompress(rb))


@pytest.mark.parametrize("preset", PRESETS + ["cusz_hi_cr", "cusz_i"])
def test_preset_specs_match_the_reference(preset):
    tsp, rsp = getattr(T, preset)(device="cpu").spec, getattr(R, preset)().spec
    assert tsp.to_string() == rsp.to_string()
    assert T.CompressorSpec.from_string(tsp.to_string()) == tsp


@pytest.mark.parametrize("shape", [(2, 20, 18, 19), (50, 45), (300,), (1, 1, 1)])
def test_batched_and_low_rank_lorenzo_fields(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32).cumsum(-1)
    spec = dict(eb=1e-3, eb_mode="abs", predictor="lorenzo", pipeline="fz")
    rb = R.Compressor(R.CompressorSpec(**spec)).compress(x)
    assert T.Compressor(T.CompressorSpec(**spec), device="cpu").compress(x) == rb
    y = T.Compressor(device="cpu").decompress(rb)
    assert y.shape == shape and _err_over_eb(x, y, rb) <= 1 + SLACK


def test_cusz_i_matches_the_reference():
    x = _smooth3d()
    rb = R.cusz_i().compress(x)
    tb = T.cusz_i(device="cpu").compress(x)
    assert t_unpack(tb)[0] == r_unpack(rb)[0]
    assert _err_over_eb(x, R.Compressor().decompress(tb), tb) <= 1 + SLACK
    assert _err_over_eb(x, T.Compressor(device="cpu").decompress(rb), rb) <= 1 + SLACK
