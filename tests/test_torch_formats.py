"""Formats shared between the packages, byte for byte: the serial header
codec, stage headers, LLP2 framing, the spec grammar and the step tables."""
import numpy as np
import pytest

import repro.core.compressor as rc
import repro.core.lossless.pipelines as rpipe
import repro.core.lossless.stages as rstages
import repro.core.serial as rserial
import repro.core.stencils as rsten
import repro_torch.core.compressor as tc
import repro_torch.core.lossless.pipelines as tpipe
import repro_torch.core.lossless.stages as tstages
import repro_torch.core.serial as tserial
import repro_torch.core.stencils as tsten
from repro.core.errors import SpecError as RSpecError
from repro_torch.core.errors import SpecError as TSpecError

OBJECTS = [
    None, True, False, 0, -1, 2**62, 1.5, -0.0, float("inf"), "", "nyx", b"\x00\xff",
    [1, "a", [2.5, None]], {"shape": [512, 512, 512], "eb_abs": 1e-3, "splines": ["cubic"] * 4},
    {"nested": {"k": [True, {"x": b"raw"}]}}, np.int64(7), np.float32(0.1),
]


@pytest.mark.parametrize("obj", OBJECTS, ids=lambda o: type(o).__name__)
def test_serial_bytes_equal(obj):
    b = tserial.pack_obj(obj)
    assert b == rserial.pack_obj(obj)
    assert tserial.unpack_obj(b) == rserial.unpack_obj(b)


@pytest.mark.parametrize("name,hdr", [
    ("hf", {"n": 12345}),
    ("hf", {"n": 3000, "offs": np.arange(3, dtype="<u4").tobytes()}),
    ("rre4", {"n": 99, "nsym": 25, "k": 4}),
    ("rze1", {"n": 0, "nsym": 0, "k": 1}),
    ("tcms8", {"n": 17, "k": 8}),
])
def test_stage_headers_bytes_equal(name, hdr):
    hb = tstages.get_stage(name).pack_header(hdr)
    assert hb == rstages.get_stage(name).pack_header(hdr)
    assert tstages.get_stage(name).unpack_header(hb) == rstages.get_stage(name).unpack_header(hb)


@pytest.mark.parametrize("pipeline", ["cr", "hf", "lvl", "none"])
def test_llp2_framing_bytes_equal(pipeline):
    rng = np.random.default_rng(3)
    data = np.clip(np.rint(rng.normal(128, 3, 20000)), 0, 255).astype(np.uint8)
    data[::97] = 0
    assert tpipe.get_pipeline(pipeline) == rpipe.get_pipeline(pipeline)
    buf = tpipe.encode(data, pipeline)
    assert buf == rpipe.encode(data, pipeline)
    assert np.array_equal(tpipe.decode(buf), data)


def test_store_through_and_legacy_json_meta_streams_decode():
    incompressible = np.random.default_rng(1).integers(0, 256, 4096, dtype=np.uint8)
    buf = rpipe.encode(incompressible, "cr")  # stages that expand are stored through
    assert tpipe.encode(incompressible, "cr") == buf
    assert np.array_equal(tpipe.decode(buf), incompressible)
    codes = np.full(50000, 128, np.uint8)
    codes[::7] = 127
    legacy = rpipe.encode_v1(codes, "cr")
    assert np.array_equal(tpipe.decode(legacy), codes)


SPECS = [
    "lossy,rel,0.001", "lossy,abs,1e-05", "lossy,rel,0.01,pipeline=hf", "lossy,psnr,60",
    "lossy,rel,0.001,anchor_stride=8,autotune=false,splines=cubic:cubic:linear,schemes=1d:md:1d-210",
    "lossy,abs,0.5,backend=pallas,engine=device,verify=off,reorder=false",
    "lossy,rel,0.001,predictor=auto,pipeline=auto,plan_anchor_strides=16:8,pipeline_candidates=cr:tp",
    "lossy,pw_rel,0.01,pipeline=fz", "lossy,rel,0.001,predictor=lorenzo,pipeline=crz",
    " lossy , rel , 1e-3 , verify = full ",
]


@pytest.mark.parametrize("s", SPECS)
def test_spec_strings_round_trip_identically(s):
    r, t = rc.CompressorSpec.from_string(s), tc.CompressorSpec.from_string(s)
    assert t.to_string() == r.to_string()
    assert tc.CompressorSpec.from_string(t.to_string()) == t
    assert dataclass_dict(t) == dataclass_dict(r)


def dataclass_dict(spec):
    import dataclasses

    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


@pytest.mark.parametrize("s", ["", "lossless", "lossy,rel", "lossy,foo,1", "lossy,rel,x",
                               "lossy,rel,1e-3,bogus=1", "lossy,rel,1e-3,eb=1", "lossy,rel,1e-3,autotune=maybe",
                               "lossy,rel,1e-3,pipeline=nope", "lossy,rel,1e-3,anchor_stride=5"])
def test_bad_spec_strings_raise_in_both(s):
    with pytest.raises(RSpecError):
        rc.CompressorSpec.from_string(s)
    with pytest.raises(TSpecError):
        tc.CompressorSpec.from_string(s)


@pytest.mark.parametrize("levels", [(8, 4, 2, 1), (4, 2, 1)], ids=["stride16", "stride8"])
@pytest.mark.parametrize("scheme", ["md", "1d", "1d-210", "1d-102"])
@pytest.mark.parametrize("spline", ["linear", "cubic", "natural-cubic"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_build_steps_tables_equal(ndim, spline, scheme, levels):
    if ndim == 2 and scheme in ("1d-210", "1d-102"):
        scheme = "1d-10"
    L = len(levels)
    ts = tsten.build_steps(ndim, 17, levels, (spline,) * L, (scheme,) * L)
    rs = rsten.build_steps(ndim, 17, levels, (spline,) * L, (scheme,) * L)
    assert len(ts) == len(rs)
    for a, b in zip(ts, rs):
        assert a.level == b.level and a.dims == b.dims
        assert np.array_equal(a.mask, b.mask)
        for Ma, Mb, wa, wb in zip(a.matrices, b.matrices, a.weights, b.weights):
            assert np.array_equal(Ma, Mb) and np.array_equal(wa, wb)
