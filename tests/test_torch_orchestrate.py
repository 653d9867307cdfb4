"""The port's lossless orchestrator and its stage hooks against the JAX
package (``repro.core.lossless.orchestrate``): the samples, statistics,
estimates and choice records are equal float for float, the streams byte
for byte, for numpy arrays (host stages) and for CPU tensors (the torch
twins and the histogram's plain version, the code that runs on the card);
every registered pipeline, ``crz`` included, encodes byte-equal and
cross-decodes under both zstd codecs (zstandard, and zlib where its import
is blocked)."""
import sys

import numpy as np
import pytest
import torch

import repro.core.lossless.orchestrate as rorc
import repro.core.lossless.pipelines as rpipe
import repro.core.lossless.stages as rstages
import repro_torch.core.lossless.orchestrate as torc
import repro_torch.core.lossless.pipelines as tpipe
import repro_torch.core.lossless.stages as tstages


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and torch's spinning thread pools in all of
    them oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

KINDS = ("numpy", "tensor")


def _codes(n: int, seed: int, center: float, outliers: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = np.clip(np.rint(rng.laplace(128, 2.0, n)), 1, 255).astype(np.uint8)
    d[rng.random(n) < center] = 128
    d[rng.random(n) < outliers] = 0
    return d


def _runs(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(0, 256, n // 37 + 1, dtype=np.uint8), 37)[:n]


STREAMS = {
    "empty": np.zeros(0, np.uint8),
    "one": np.full(1, 7, np.uint8),
    "constant": np.full(70_000, 128, np.uint8),
    "zeros": np.zeros(5000, np.uint8),
    "random-small": np.random.default_rng(1).integers(0, 256, 20_000, dtype=np.uint8),
    "random-large": np.random.default_rng(2).integers(0, 256, 200_001, dtype=np.uint8),
    "codes-small": _codes(40_000, 3, 0.5, 0.001),
    "codes-large": _codes(300_000, 4, 0.8, 0.002),
    "sparse": _codes(150_000, 5, 0.995, 0.0),
    "runs": _runs(250_000, 6),
}


@pytest.fixture(scope="module", autouse=True)
def builtin_registry():
    """Hold the JAX registry to the pipelines both packages register: a JAX
    test run earlier in this process may have added its own."""
    extra = {nm: rpipe.PIPELINES.pop(nm) for nm in list(rpipe.PIPELINES) if nm not in tpipe.PIPELINES}
    assert sorted(rpipe.PIPELINES) == sorted(tpipe.PIPELINES)
    yield
    rpipe.PIPELINES.update(extra)


@pytest.fixture(params=["zstandard", "zlib"])
def codec(request, monkeypatch):
    """The zstd stage's codec: zstandard, or zlib with its import blocked in both packages."""
    if request.param == "zstandard":
        pytest.importorskip("zstandard")
    else:
        monkeypatch.setitem(sys.modules, "zstandard", None)
    return request.param


def _as(kind: str, data: np.ndarray):
    return torch.from_numpy(data.copy()) if kind == "tensor" else data


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(STREAMS))
def test_sample_and_stats_match_the_reference(name, kind):
    data = STREAMS[name]
    s = torc.sample_stream(_as(kind, data))
    assert isinstance(s, torch.Tensor) == (kind == "tensor")
    assert np.array_equal(_np(s), rorc.sample_stream(data))
    assert torc.stream_stats(s, n_total=data.size) == rorc.stream_stats(rorc.sample_stream(data), n_total=data.size)
    assert torc.stream_stats(_as(kind, data)) == rorc.stream_stats(data)


@pytest.mark.parametrize("name", list(STREAMS))
def test_estimates_and_portable_pipelines_match(name):
    stats = rorc.stream_stats(rorc.sample_stream(STREAMS[name]), n_total=STREAMS[name].size)
    for nm, stages in tpipe.PIPELINES.items():
        assert torc.estimate_pipeline(stages, stats) == rorc.estimate_pipeline(stages, stats), nm
        for st in stages:
            assert tstages.get_stage(st).estimate(stats) == rstages.get_stage(st).estimate(stats), st
            assert tstages.get_stage(st).portable == rstages.get_stage(st).portable, st
    assert torc.portable_pipelines() == rorc.portable_pipelines()
    assert "crz" not in torc.portable_pipelines()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(STREAMS))
def test_choice_record_and_stream_match(name, kind):
    data = STREAMS[name]
    t_buf, t_rec = torc.encode_auto(_as(kind, data))
    r_buf, r_rec = rorc.encode_auto(data)
    assert t_buf == r_buf and t_rec == r_rec
    assert list(t_rec["estimates"]) == list(r_rec["estimates"])  # the header packs dicts in order
    assert list(t_rec["trial_bytes"]) == list(r_rec["trial_bytes"])
    assert np.array_equal(rpipe.decode(t_buf), data)


@pytest.mark.parametrize("kind", KINDS)
def test_choice_record_matches_under_both_codecs(kind, codec):
    for name in ("codes-small", "runs"):
        assert torc.choose_pipeline(_as(kind, STREAMS[name])) == rorc.choose_pipeline(STREAMS[name])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kw", [dict(max_trials=2), dict(candidates=("tp", "cr", "fz")), dict(portable_only=True),
                                dict(sample_bytes=1 << 12)])
def test_choice_options_match(kw, kind):
    data = STREAMS["codes-large"]
    assert torc.choose_pipeline(_as(kind, data), **kw) == rorc.choose_pipeline(data, **kw)


def test_unknown_candidate_raises_like_the_reference():
    with pytest.raises(ValueError, match="registered pipelines"):
        torc.choose_pipeline(STREAMS["codes-small"], candidates=("cr", "nope"))


def _round_trip(pipeline: str, data: np.ndarray):
    """Encode in both packages (host and tensor routes), decode in both."""
    rb = rpipe.encode(data, pipeline)
    assert tpipe.encode(data, pipeline) == rb
    tel = {}
    assert tpipe.encode(torch.from_numpy(data.copy()), pipeline, tel=tel) == rb
    assert np.array_equal(tpipe.decode(rb), data)
    assert np.array_equal(rpipe.decode(rb), data)
    dtel = {}
    out = tpipe.decode(rb, device="cpu", tel=dtel)
    assert isinstance(out, torch.Tensor) and np.array_equal(out.numpy(), data)
    return rb, tel, dtel


@pytest.mark.parametrize("name", ["empty", "one", "codes-small", "codes-large", "runs", "random-large"])
@pytest.mark.parametrize("pipeline", sorted(tpipe.PIPELINES))
def test_every_pipeline_encodes_byte_equal_and_cross_decodes(pipeline, name):
    rb, tel, dtel = _round_trip(pipeline, STREAMS[name])
    if pipeline == "crz":
        assert tel["host_stages"] == ["zstd.encode"]  # the stream's format, not a fallback
        assert dtel.get("host_stages", []) == (["zstd.decode"] if "zstd" in _applied(rb) else [])
    else:
        assert "host_stages" not in tel and "host_stages" not in dtel


@pytest.mark.parametrize("name", ["empty", "codes-large", "random-large"])
def test_crz_encodes_byte_equal_under_both_codecs(name, codec):
    rb, tel, _ = _round_trip("crz", STREAMS[name])
    assert tel["host_stages"] == ["zstd.encode"]


def _applied(buf: bytes) -> list[str]:
    """Names of the stages an LLP2 stream applied (not stored through)."""
    mv, out, off = memoryview(buf), [], 5
    for _ in range(mv[4]):
        flags, nlen = mv[off], mv[off + 1]
        name = bytes(mv[off + 2 : off + 2 + nlen]).decode()
        off += 2 + nlen
        hlen = int.from_bytes(mv[off : off + 4], "little")
        off += 4 + hlen
        if not flags & 1:
            out.append(name)
    return out


def test_zstd_stage_records_its_codec(codec):
    data = STREAMS["codes-large"]
    payload, hdr = tstages.get_stage("zstd").encode(data)
    assert hdr == {"c": "zstd" if codec == "zstandard" else "zlib"}
    assert (payload, hdr) == rstages.get_stage("zstd").encode(data)
    packed = tstages.get_stage("zstd").pack_header(hdr)
    assert packed == rstages.get_stage("zstd").pack_header(hdr)
    assert tstages.get_stage("zstd").unpack_header(packed) == hdr
    assert np.array_equal(tstages.get_stage("zstd").decode(payload, hdr), data)


def test_zstd_stream_needs_zstandard_to_decode(monkeypatch):
    pytest.importorskip("zstandard")
    payload, hdr = tstages.get_stage("zstd").encode(STREAMS["codes-small"])
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        tstages.get_stage("zstd").decode(payload, hdr)
