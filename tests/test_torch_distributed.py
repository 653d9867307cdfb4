"""Chunked container v3 in the port (repro_torch.core.distributed and the
v3 reader of repro_torch.core.compressor) against the JAX package.

- The port writes the JAX package's v3 bytes wherever the codes agree (the
  golden field in every spec tried), and each
  package decodes the other's streams within each chunk's own bound
  (``eb * (1 + 1e-4)``).
- The golden v3 fixtures, intact and damaged, decode within the bound of
  golden_field.npy and within 1e-4 eb of the live JAX decode, with the JAX
  package's damage reports and chunk masks under on_error="skip"/"fill".
- ``shard_compress(devices=["cpu"] * k)`` equals ``chunk_compress(n_chunks=k)``
  byte for byte, routes as the JAX package does, maps nested structures,
  streams to a sink, writes const frames for constant chunks, and raises
  (no fallback, no trailer) when a shard fails; ``shard_decompress`` gives
  the sequential decode with any worker count, salvage included.
- The v1 writers, ``presampled_of`` and the error paths of salvage.
"""
import io
import pathlib
import threading

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import distributed as RD
from repro.core import frames as rframes
from repro.core.compressor import _sections_pack_v1 as r_pack_v1
from repro.core.compressor import _sections_unpack as r_unpack
from repro.core.lossless import pipelines as rpipe
from repro_torch.core import compressor as tcomp
from repro_torch.core import distributed as TD
from repro_torch.core import frames as tframes
from repro_torch.core.compressor import _sections_pack_v1 as t_pack_v1
from repro_torch.core.compressor import _sections_unpack as t_unpack
from repro_torch.core.lossless import pipelines as tpipe
from repro_torch.kernels.build import KernelError

DATA = pathlib.Path(__file__).parent / "data"
SLACK = 1e-4
GOLDEN_SPEC = dict(eb=1e-2, pipeline="cr", autotune=False)  # tests/data/gen_golden.py's spec
GOLDEN_V3 = ("golden_v3", "golden_v3_bitflip", "golden_v3_trunc", "golden_v3_torn")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden():
    return np.load(DATA / "golden_field.npy")


def _field(shape=(24, 18, 20), seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32).cumsum(0).cumsum(1)


def _chunk_bounds(buf) -> list:
    """(slice tuple, eb_abs) of each chunk of a v3 compressor stream."""
    info = T.Compressor.inspect(buf)
    axis, out, lo = info["axis"], [], 0
    for size, fr in zip(info["chunk_sizes"], info["frames"]):
        sl = tuple(slice(lo, lo + size) if d == axis else slice(None) for d in range(len(info["shape"])))
        out.append((sl, fr["eb_abs"]))
        lo += size
    return out


def _within_chunk_bounds(x, y, buf) -> float:
    """Largest err / eb over the chunks, each against its own bound."""
    worst = 0.0
    for sl, eb in _chunk_bounds(buf):
        err = float(np.abs(y[sl].astype(np.float64) - x[sl]).max())
        worst = max(worst, err / eb if eb else (0.0 if err == 0 else np.inf))
    return worst


def _report(r) -> tuple:
    return (tuple((x.kind, x.offset, x.index, x.detail) for x in r.records), r.frames_ok, r.frames_damaged,
            r.bytes_skipped, r.declared_frames, r.truncated, r.summary())


# ------------------------------------------------------------- both ways
def test_the_port_writes_the_golden_v3_stream_of_the_live_reference():
    """golden_v3.bin's recipe (tests/data/gen_golden.py). The committed file
    predates the f64 range and the hf offset table, so neither package
    rewrites it byte for byte; both write the same bytes today."""
    buf = T.chunk_compress(_golden(), n_chunks=4, spec=T.CompressorSpec(**GOLDEN_SPEC), device="cpu")
    assert buf == RD.chunk_compress(_golden(), n_chunks=4, spec=R.CompressorSpec(**GOLDEN_SPEC))


@pytest.mark.parametrize("n_chunks,axis,sync", [(4, 0, False), (3, 1, False), (5, 2, True), (1, 0, False)])
def test_chunk_compress_bytes_equal_the_reference(n_chunks, axis, sync):
    x = _golden()
    tb = T.chunk_compress(x, axis=axis, n_chunks=n_chunks, sync=sync, device="cpu")
    rb = RD.chunk_compress(x, axis=axis, n_chunks=n_chunks, sync=sync)
    assert tb == rb


@pytest.mark.parametrize("n_chunks,axis", [(4, 0), (3, 2)])
def test_each_package_decodes_the_others_v3(n_chunks, axis):
    x = _field()
    tb = T.chunk_compress(x, axis=axis, n_chunks=n_chunks, device="cpu")
    rb = RD.chunk_compress(x, axis=axis, n_chunks=n_chunks)
    assert _within_chunk_bounds(x, R.Compressor().decompress(tb), tb) <= 1 + SLACK
    assert _within_chunk_bounds(x, T.Compressor(device="cpu").decompress(rb), rb) <= 1 + SLACK
    assert tframes.read_header(tb) == rframes.read_header(rb)
    # the same chunk geometry, each chunk its own container (np.linspace bounds, per-chunk bound)
    ti, ri = T.Compressor.inspect(tb), R.Compressor.inspect(rb)
    assert ti["chunk_sizes"] == ri["chunk_sizes"] and ti["frame_crc_ok"] == ri["frame_crc_ok"]
    assert [f["eb_abs"] for f in ti["frames"]] == [f["eb_abs"] for f in ri["frames"]]


@pytest.mark.parametrize("on_error", ["skip", "fill"])
@pytest.mark.parametrize("name", GOLDEN_V3)
def test_golden_v3_decodes_with_the_references_damage(name, on_error):
    buf = (DATA / f"{name}.bin").read_bytes()
    x = _golden()
    tc, rc = T.Compressor(device="cpu"), R.Compressor()
    yt, yr = tc.decompress(buf, on_error=on_error), rc.decompress(buf, on_error=on_error)
    assert yt.shape == yr.shape and yt.dtype == np.float32
    eb = 1e-2 * float(x.max() - x.min())
    assert float(np.abs(yt.astype(np.float64) - yr).max()) <= eb * SLACK
    dt, dr = tc.last_damage, rc.last_damage
    assert (dt is None) == (dr is None) == (name == "golden_v3")
    sizes = T.Compressor.inspect((DATA / "golden_v3.bin").read_bytes())["chunk_sizes"]
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    mask = [True] * 4 if dt is None else dt["chunks_ok"]
    if dt is not None:
        assert dt["chunks_ok"] == dr["chunks_ok"] and dt["on_error"] == on_error
        assert _report(dt["report"]) == _report(dr["report"])
    kept = np.concatenate([x[bounds[i]:bounds[i + 1]] for i in range(4) if mask[i] or on_error == "fill"])
    ok_rows = np.concatenate([np.full(sizes[i], mask[i]) for i in range(4) if mask[i] or on_error == "fill"])
    err = np.abs(yt[ok_rows].astype(np.float64) - kept[ok_rows]).max()
    assert err <= eb * (1 + SLACK)
    if on_error == "fill":
        assert np.all(yt[~ok_rows] == 0.0)
    if name != "golden_v3":
        with pytest.raises(T.ContainerError):
            T.Compressor(device="cpu").decompress(buf)


@pytest.mark.parametrize("name", GOLDEN_V3)
def test_inspect_v3_equals_the_reference(name):
    buf = (DATA / f"{name}.bin").read_bytes()
    ti, ri = T.Compressor.inspect(buf), R.Compressor.inspect(buf)
    assert ("damage" in ti) == ("damage" in ri)
    if "damage" in ti:
        assert _report(ti.pop("damage")) == _report(ri.pop("damage"))
    tf_, rf_ = ti.pop("frames"), ri.pop("frames")
    assert ti == ri
    assert [f is None for f in tf_] == [f is None for f in rf_]
    for a, b in zip(tf_, rf_):
        if a is not None:
            assert a == b


@pytest.mark.parametrize("frames", [[2, 0], [3], [1, 1, 2]])
def test_partial_decode_gives_the_slices_in_the_order_asked(frames):
    buf = (DATA / "golden_v3.bin").read_bytes()
    comp = T.Compressor(device="cpu")
    full = comp.decompress(buf)
    sizes = comp.inspect(buf)["chunk_sizes"]
    b = np.concatenate([[0], np.cumsum(sizes)])
    part = comp.decompress(buf, frames=frames)
    assert np.array_equal(part, np.concatenate([full[b[i]:b[i + 1]] for i in frames]))
    eb = 1e-2 * float(_golden().max() - _golden().min())
    assert float(np.abs(part.astype(np.float64) - R.Compressor().decompress(buf, frames=frames)).max()) <= eb * SLACK
    dev = comp.decompress(buf, frames=frames, out="device")
    assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), part)


def test_decompress_argument_errors_match_the_reference():
    v2 = (DATA / "golden_v2.bin").read_bytes()
    v3 = (DATA / "golden_v3.bin").read_bytes()
    comp = T.Compressor(device="cpu")
    with pytest.raises(ValueError, match="on_error"):
        comp.decompress(v3, on_error="ignore")
    with pytest.raises(ValueError, match="frames="):
        comp.decompress(v2, frames=[0])
    with pytest.raises(ValueError, match="selected no frames"):
        comp.decompress(v3, frames=[])
    other = tframes.pack_frames({"kind": "grads"}, [b"x"])
    with pytest.raises(ValueError, match="not a compressor chunk stream"):
        comp.decompress(other)


def test_a_damaged_single_container_fills_as_the_reference():
    v2 = bytearray((DATA / "golden_v2.bin").read_bytes())
    v2[-200:] = bytes(200)  # the outlier and anchor sections no longer decode to the field's geometry
    v2 = bytes(v2[:-150])
    tc, rc = T.Compressor(device="cpu"), R.Compressor()
    yt, yr = tc.decompress(v2, on_error="fill", fill_value=7.0), rc.decompress(v2, on_error="fill", fill_value=7.0)
    assert np.array_equal(yt, yr) and np.all(yt == 7.0)
    assert tc.last_damage["chunks_ok"] == rc.last_damage["chunks_ok"] == [False]
    with pytest.raises(Exception):
        tc.decompress(v2)
    dev = tc.decompress(v2, on_error="fill", fill_value=7.0, out="device")
    assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), yt)


def test_v3_decode_to_the_device_concatenates_there():
    buf = (DATA / "golden_v3_bitflip.bin").read_bytes()
    comp = T.Compressor(device="cpu")
    for on_error in ("skip", "fill"):
        host = comp.decompress(buf, on_error=on_error)
        dev = comp.decompress(buf, on_error=on_error, out="device")
        assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), host)
    assert comp.last_telemetry["decode"]["out"] == "device"


# ----------------------------------------------------------- the writers
def test_chunk_compress_streams_and_aborts_on_failure(monkeypatch):
    x = _field()
    sink = io.BytesIO()
    assert T.chunk_compress(x, n_chunks=3, out=sink, device="cpu") == 3
    assert sink.getvalue() == T.chunk_compress(x, n_chunks=3, device="cpu")
    calls = []
    real = T.Compressor.compress

    def fail_third(self, arr):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("encode failed")
        return real(self, arr)

    monkeypatch.setattr(T.Compressor, "compress", fail_third)
    sink = io.BytesIO()
    with pytest.raises(RuntimeError, match="encode failed"):
        T.chunk_compress(x, n_chunks=3, out=sink, device="cpu")
    with pytest.raises(T.TruncatedContainerError):
        tframes.frame_table(sink.getvalue())
    assert len(tframes.scan_frames(sink.getvalue())[0]) == 2


def test_chunk_compress_gathers_the_chunks_telemetry_and_honours_a_hold():
    comp = T.Compressor(device="cpu")
    T.chunk_compress(_field(), n_chunks=3, compressor=comp)
    tel = comp.last_telemetry
    assert tel["fallbacks"] == [] and tel["pipeline"] == "cr" and tel["verify"]["repairs"] == 0
    comp._telemetry()["mark"] = 1
    comp._telemetry_hold = True
    try:
        T.chunk_compress(_field(), n_chunks=2, compressor=comp)
    finally:
        comp._telemetry_hold = False
    assert comp.last_telemetry["mark"] == 1


@pytest.mark.parametrize("k,axis", [(2, 0), (4, 0), (3, 1), (4, 2)])
def test_shard_compress_equals_chunk_compress(k, axis):
    x = _field((24, 18, 20))
    sb = T.shard_compress(x, ["cpu"] * k, axis=axis)
    assert sb == T.chunk_compress(x, axis=axis, n_chunks=k, device="cpu")
    info = T.Compressor.inspect(sb)
    assert info["chunk_sizes"] == [x.shape[axis] // k] * k
    # each frame is an independent compress of its chunk
    _, payloads = tframes.unpack_frames(sb)
    for (sl, _), p in zip(_chunk_bounds(sb), payloads):
        assert bytes(p) == T.Compressor(device="cpu").compress(np.ascontiguousarray(x[sl]))


def test_shard_compress_takes_tensors_and_a_spec():
    x = _field((16, 18, 20))
    spec = T.CompressorSpec(eb=1e-2, predictor="auto")
    sb = T.shard_compress(torch.from_numpy(x), ["cpu"] * 2, spec=spec)
    assert sb == T.chunk_compress(x, n_chunks=2, spec=spec, device="cpu")
    comp = T.Compressor(spec, device="cpu")
    T.shard_compress(x, ["cpu"] * 2, compressor=comp)
    assert comp.last_plan is not None and comp.last_telemetry["fallbacks"] == []


@pytest.mark.parametrize("case", ["one_device", "non_dividing", "lorenzo"])
def test_shard_compress_routes_as_the_reference(case, monkeypatch):
    x = _golden()  # 20 rows: 3 devices do not divide them
    devices = {"one_device": ["cpu"], "non_dividing": ["cpu"] * 3, "lorenzo": ["cpu"] * 4}[case]
    kw = {"predictor": "lorenzo"} if case == "lorenzo" else {}
    spec = T.CompressorSpec(**kw)
    routed = []
    real = TD.chunk_compress

    def spy(*a, **kw):
        routed.append(kw["n_chunks"])
        return real(*a, **kw)

    monkeypatch.setattr(TD, "chunk_compress", spy)
    sb = T.shard_compress(x, devices, spec=spec)
    assert routed == [len(devices)]
    assert sb == real(x, n_chunks=len(devices), spec=spec, device="cpu")
    assert sb == RD.chunk_compress(x, n_chunks=len(devices), spec=R.CompressorSpec(**kw))


def test_shard_compress_maps_nested_structures_and_rejects_scalars():
    a, b = _field((8, 18, 20), 1), _field((4, 9, 10), 2)
    tree = {"w": a, "pair": (b, [a]), "t": torch.from_numpy(b)}
    out = T.shard_compress(tree, ["cpu"] * 2)
    assert set(out) == {"w", "pair", "t"} and isinstance(out["pair"], tuple) and isinstance(out["pair"][1], list)
    assert out["w"] == out["pair"][1][0] == T.chunk_compress(a, n_chunks=2, device="cpu")
    assert out["pair"][0] == out["t"] == T.chunk_compress(b, n_chunks=2, device="cpu")
    with pytest.raises(TypeError, match="ndim >= 1"):
        T.shard_compress({"w": a, "step": np.float32(3.0)}, ["cpu"] * 2)
    with pytest.raises(ValueError, match="out= takes a single container"):
        T.shard_compress({"w": a}, ["cpu"] * 2, out=io.BytesIO())


def test_shard_compress_streams_to_a_sink():
    x = _field((16, 18, 20))

    class Sink(io.BytesIO):
        flushes = 0

        def flush(self):
            self.flushes += 1

    sink = Sink()
    assert T.shard_compress(x, ["cpu"] * 4, out=sink, sync=True) == 4
    assert sink.getvalue() == T.chunk_compress(x, n_chunks=4, sync=True, device="cpu")
    assert sink.flushes >= 5  # a flush per frame and one for the trailer


def test_constant_chunks_become_const_frames():
    x = _field((16, 18, 20))
    x[:8] = 2.5
    sb = T.shard_compress(x, ["cpu"] * 2)
    modes = [f["mode"] for f in T.Compressor.inspect(sb)["frames"]]
    assert modes == ["const", "interp"]
    assert sb == RD.chunk_compress(x, n_chunks=2)
    y = T.Compressor(device="cpu").decompress(sb)
    assert np.all(y[:8] == 2.5) and _within_chunk_bounds(x, y, sb) <= 1 + SLACK


def test_a_failing_shard_raises_with_no_fallback_and_no_trailer(monkeypatch):
    x = _field((16, 18, 20))
    real = T.Compressor.compress
    lock, calls = threading.Lock(), []

    def fail_second(self, arr):
        with lock:
            calls.append(1)
            n = len(calls)
        if n == 2:
            raise KernelError("interp_encode launch failed with CUDA error 719")
        return real(self, arr)

    monkeypatch.setattr(T.Compressor, "compress", fail_second)
    comp = T.Compressor(device="cpu")
    sink = io.BytesIO()
    with pytest.raises(KernelError):
        T.shard_compress(x, ["cpu"] * 4, compressor=comp, out=sink)
    assert comp.last_telemetry["fallbacks"] == []
    with pytest.raises(T.TruncatedContainerError):
        tframes.frame_table(sink.getvalue())


def test_salvage_never_swallows_a_kernel_error(monkeypatch):
    buf = (DATA / "golden_v3.bin").read_bytes()

    def broken(*a, **kw):
        raise KernelError("interp_decode launch failed with CUDA error 719")

    monkeypatch.setattr(tcomp._interp, "decompress_blocks", broken)
    for on_error in ("skip", "fill"):
        with pytest.raises(KernelError):
            T.Compressor(device="cpu").decompress(buf, on_error=on_error)
        with pytest.raises(KernelError):
            T.shard_decompress(buf, workers=3, on_error=on_error, device="cpu")
        with pytest.raises(KernelError):
            T.Compressor(device="cpu").decompress((DATA / "golden_v2.bin").read_bytes(), on_error="fill")


# --------------------------------------------------------- sharded decode
@pytest.mark.parametrize("name", GOLDEN_V3)
@pytest.mark.parametrize("on_error", ["skip", "fill"])
def test_shard_decompress_equals_the_sequential_decode(name, on_error):
    buf = (DATA / f"{name}.bin").read_bytes()
    one = T.Compressor(device="cpu")
    y1 = T.shard_decompress(buf, workers=1, on_error=on_error, compressor=one)
    four = T.Compressor(device="cpu")
    y4 = T.shard_decompress(buf, workers=4, on_error=on_error, compressor=four)
    assert np.array_equal(y1, y4)
    assert (one.last_damage is None) == (four.last_damage is None)
    if one.last_damage is not None:
        assert one.last_damage["chunks_ok"] == four.last_damage["chunks_ok"]
        assert _report(one.last_damage["report"]) == _report(four.last_damage["report"])
    rc = R.Compressor()
    yr = RD.shard_decompress(buf, workers=4, on_error=on_error, compressor=rc)
    assert yr.shape == y4.shape
    if rc.last_damage is not None:
        assert four.last_damage["chunks_ok"] == rc.last_damage["chunks_ok"]
    dev = T.shard_decompress(buf, workers=4, on_error=on_error, device="cpu", out="device")
    assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), y4)


def test_shard_decompress_selects_frames_and_reads_the_worker_variable(monkeypatch):
    buf = (DATA / "golden_v3.bin").read_bytes()
    seq = T.Compressor(device="cpu").decompress(buf, frames=[3, 1])
    assert np.array_equal(T.shard_decompress(buf, [3, 1], workers=2, device="cpu"), seq)
    assert TD._decode_workers() == 1
    monkeypatch.setenv("REPRO_DECODE_WORKERS", "3")
    assert TD._decode_workers() == 3
    assert np.array_equal(T.shard_decompress(buf, [3, 1], device="cpu"), seq)
    monkeypatch.setenv("REPRO_DECODE_WORKERS", "many")
    assert TD._decode_workers() == 1
    with pytest.raises(T.ContainerError):
        T.shard_decompress((DATA / "golden_v3_trunc.bin").read_bytes(), workers=2, device="cpu")


def test_shard_compress_needs_a_card_unless_given_cpu_devices():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in T.default_devices())
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.shard_compress(_field((8, 18, 20)))


# ------------------------------------------------ v1 writers, presampling
@pytest.mark.parametrize("pipeline", ["cr", "hf", "tp", "fz", "lvl", "none", ("rre1", "rze1")])
def test_encode_v1_equals_the_reference(pipeline):
    rng = np.random.default_rng(3)
    for data in (np.repeat(rng.integers(120, 137, 4000).astype(np.uint8), 3), np.zeros(0, np.uint8),
                 rng.integers(0, 256, 3001).astype(np.uint8)):
        tb = tpipe.encode_v1(data, pipeline)
        assert tb == rpipe.encode_v1(data, pipeline)
        assert np.array_equal(tpipe.decode(tb), data)


def test_the_v1_container_writer_gives_the_references_bytes():
    """golden_v1.bin's recipe (tests/data/gen_golden.py) in both packages."""
    x = _golden()
    built = []
    for comp, unpack, pack_v1, pipe in ((T.Compressor(T.CompressorSpec(**GOLDEN_SPEC), device="cpu"), t_unpack,
                                         t_pack_v1, tpipe),
                                        (R.Compressor(R.CompressorSpec(**GOLDEN_SPEC)), r_unpack, r_pack_v1, rpipe)):
        header, sections = unpack(comp.compress(x))
        v1_header = {k: v for k, v in header.items() if k != "pipeline"}
        built.append(pack_v1(v1_header, [pipe.encode_v1(pipe.decode(sections[0]), "cr")] + list(sections[1:])))
    assert built[0] == built[1] and built[0][:6] == b"CSZH1\n"
    eb = t_unpack(built[0])[0]["eb_abs"]
    assert float(np.abs(T.Compressor(device="cpu").decompress(built[0]).astype(np.float64) - x).max()) <= eb * (1 + SLACK)
    hdr = {"shape": [3], "mode": "const", "eb_abs": 0.5}
    assert t_pack_v1(hdr, [b"ab", b""]) == r_pack_v1(hdr, [b"ab", b""])
    assert t_unpack(t_pack_v1(hdr, [b"ab", b""]))[0] == r_unpack(r_pack_v1(hdr, [b"ab", b""]))[0]


@pytest.mark.parametrize("predictor", ["auto", "interp"])
def test_presampled_tuning_gives_the_references_plan(predictor):
    from repro.core import blocks as rblk
    from repro.core.autotune import legacy_sample_indices, plan_sample_indices
    from repro_torch.core import blocks as tblk

    x = _golden()
    spec = dict(eb=1e-2, predictor=predictor)
    xb = x[None]
    padded = rblk.pad_field_batch(xb, rblk.ANCHOR_STRIDE)
    blocks = rblk.gather_blocks_batch(padded, rblk.ANCHOR_STRIDE)
    nb = blocks.shape[0]
    sample = blocks[(plan_sample_indices if predictor == "auto" else legacy_sample_indices)(nb)]
    eb_abs = 1e-2 * float(x.max() - x.min())
    rt = R.Compressor(R.CompressorSpec(**spec))._tune_interp(sample, eb_abs, 1, padded.shape[1:], presampled_of=nb)
    tc = T.Compressor(T.CompressorSpec(**spec), device="cpu")
    tt = tc._tune_interp(torch.from_numpy(sample), eb_abs, 1, padded.shape[1:], presampled_of=nb)
    full = tc._tune_interp(tblk.gather_blocks_batch_t(torch.from_numpy(padded)), eb_abs, 1, padded.shape[1:])
    assert tuple(tt[:3]) == tuple(rt) == tuple(full[:3])
    if predictor == "auto":
        assert tt[3] == full[3] and tt[3] == tc.last_plan
        assert tt[3].to_header() == R.PredictorPlan.from_header(tt[3].to_header()).to_header()
    else:
        assert tt[3] is None
