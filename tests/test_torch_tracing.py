"""The port's container and transfer spans, on the CPU under ``torch.profiler``.

A round trip of a small field through ``Compressor(engine="device")`` (the
lossless twins and the device-side framing run as on the card, on CPU
tensors) for the interp and the Lorenzo predictors. Each of the spans
around the host and transfer work (``compress.ingest``, ``compress.pack``,
``lossless.pack``, ``decompress.parse``, ``lossless.parse``,
``lossless.upload``, ``decompress.upload``, ``hf.table``) appears where its
work runs, the I/O spans never nest in each other, their names stay out of
the stage metrics' ``.encode`` / ``.decode`` and the harness's ``bench.``,
and the spans change no byte. ``last_telemetry["decode"]`` keeps the route,
the result's size and the uploaded bytes, and no timing."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import Compressor, CompressorSpec

IO_SPANS = ("compress.ingest", "compress.pack", "lossless.pack", "decompress.parse", "lossless.parse",
            "lossless.upload", "decompress.upload")
NEW_SPANS = IO_SPANS + ("hf.table",)
COMPRESS_SIDE = ("compress.ingest", "compress.pack", "lossless.pack", "hf.table")
DECOMPRESS_SIDE = ("decompress.parse", "lossless.parse", "lossless.upload", "decompress.upload", "hf.table")
# the span each new span sits in directly (None: no program span around it)
PARENTS = {"compress.ingest": {None}, "compress.pack": {None}, "lossless.pack": {None},
           "decompress.parse": {None, "compress.verify"}, "lossless.parse": {None, "compress.verify"},
           "lossless.upload": {None, "compress.verify"},
           "decompress.upload": {"decompress.blocks", "decompress.predict"},
           "hf.table": {"hf.encode", "hf.decode"}}
UPLOAD_HOST = {"interp": "decompress.blocks", "lorenzo": "decompress.predict"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field() -> torch.Tensor:
    """A smooth 3-D field with a few spikes, so that both predictors keep outliers."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((20, 18, 17)).astype(np.float32).cumsum(0).cumsum(1) * 0.1
    x.reshape(-1)[rng.choice(x.size, 12, replace=False)] += 40.0
    return torch.from_numpy(x)


def _spans(prof):
    """(name, start_ns, end_ns, parent name or None) of every span, in start order."""
    ev = sorted(((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation()), key=lambda r: (r[1], -r[2]))
    out, stack = [], []
    for name, s, e in ev:
        while stack and stack[-1][2] <= s:
            stack.pop()
        out.append((name, s, e, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


@pytest.fixture(scope="module", params=["interp", "lorenzo"])
def traced(request):
    """The predictor, the spans of its compress and of its decompress, the
    telemetry after the decompress, and the containers with and without the
    profiler."""
    x = _field()
    comp = Compressor(CompressorSpec(engine="device", predictor=request.param), device="cpu")
    plain = comp.compress(x)
    with profile(activities=[ProfilerActivity.CPU]) as pc:
        buf = comp.compress(x)
    with profile(activities=[ProfilerActivity.CPU]) as pd:
        y = comp.decompress(buf, out="device")
    tel = dict(comp.last_telemetry)
    return {"predictor": request.param, "compress": _spans(pc), "decompress": _spans(pd), "tel": tel,
            "buf": buf, "plain": plain, "x": x, "y": y}


def test_every_new_span_appears_on_the_side_that_holds_its_work(traced):
    for side, names in (("compress", COMPRESS_SIDE), ("decompress", DECOMPRESS_SIDE)):
        seen = {n for n, *_ in traced[side]}
        assert set(names) <= seen, (side, sorted(set(names) - seen))
    # verify's decode runs the read path's spans inside compress.verify
    in_verify = {n for n, _, _, p in traced["compress"] if p == "compress.verify"}
    assert {"decompress.parse", "lossless.parse", "lossless.upload"} <= in_verify


def test_each_new_span_sits_where_its_work_runs(traced):
    for side in ("compress", "decompress"):
        for name, _, _, parent in traced[side]:
            if name in PARENTS:
                assert parent in PARENTS[name], (side, name, parent)


def test_no_io_span_nests_in_another(traced):
    for side in ("compress", "decompress"):
        io = [(n, s, e) for n, s, e, _ in traced[side] if n in IO_SPANS]
        for i, (a, sa, ea) in enumerate(io):
            for b, sb, eb in io[i + 1:]:
                assert ea <= sb or eb <= sa, (side, a, b)


def test_new_names_stay_out_of_the_stage_and_harness_patterns():
    for name in NEW_SPANS:
        assert not name.endswith((".encode", ".decode")) and not name.startswith("bench.")


def test_each_decompress_upload_lies_inside_the_blocks_or_predict_span(traced):
    for side in ("compress", "decompress"):
        ups = [(s, e, p) for n, s, e, p in traced[side] if n == "decompress.upload"]
        assert ups, side  # verify's decode and the decompress both upload anchors or outliers
        hosts = [(s, e) for n, s, e, _ in traced[side] if n == UPLOAD_HOST[traced["predictor"]]]
        for s, e, parent in ups:
            assert parent == UPLOAD_HOST[traced["predictor"]]
            assert any(hs <= s and e <= he for hs, he in hosts)


def test_the_spans_change_no_byte_and_the_decode_holds_its_bound(traced):
    assert traced["buf"] == traced["plain"]
    x, y = traced["x"], traced["y"]
    eb = 1e-3 * float(x.max() - x.min())
    assert float((y - x).abs().max()) <= eb * (1 + 1e-4)


def test_decode_telemetry_holds_the_route_and_size_and_no_timing(traced):
    nbytes = traced["x"].numel() * 4
    tel = traced["tel"]["decode"]  # a CPU device: every upload is a plain copy
    assert tel == {"engine": "device", "out": "device", "bytes": nbytes, "staged_bytes": 0,
                   "pageable_bytes": tel["pageable_bytes"]} and tel["pageable_bytes"] > 0
    comp = Compressor(CompressorSpec(predictor=traced["predictor"]), device="cpu")
    comp.decompress(traced["buf"])
    tel = comp.last_telemetry["decode"]
    assert tel == {"engine": "numpy", "out": "numpy", "bytes": nbytes, "staged_bytes": 0,
                   "pageable_bytes": tel["pageable_bytes"]} and tel["pageable_bytes"] > 0
