"""The container and transfer readers (``host_io_ms.*``) and the idle under no program span
(``unspanned_idle.*``) on a synthetic trace: the side convention, the tuners' exclusion, nothing
read without device rows or without the program's spans, and a share computed by hand."""
from __future__ import annotations

import pytest

from portbench.harness import Run, metric_module
from portbench.tracing import Trace

MS = 1_000_000  # ns


def io_trace(calls: int = 1):
    """One compress (0-100 ms) and one decompress (120-160 ms), ``calls`` times, 200 ms apart.

    Compress: ingest 4, a trial pack inside compress.plan 2 (the planner's), hf.encode, the
    stream's pack 5, the container's pack 3, and in verify's decode parse 2 + 1, upload 2 and the
    anchors' upload 1: 18 ms of I/O on the compress side. Decompress: parse 5 + 1, upload 4, the
    anchors' upload 2: 12 ms."""
    spans, ops = [], []
    for k in range(calls):
        t = lambda ms: (200 * k + ms) * MS  # noqa: E731
        spans += [("bench.compress", t(0), t(100)), ("compress.ingest", t(0), t(4)),
                  ("compress.plan", t(10), t(30)), ("lossless.pack", t(20), t(22)),
                  ("hf.encode", t(40), t(44)), ("hf.table", t(41), t(42)), ("lossless.pack", t(45), t(50)),
                  ("compress.pack", t(50), t(53)), ("compress.verify", t(60), t(90)),
                  ("decompress.parse", t(60), t(62)), ("lossless.parse", t(62), t(63)),
                  ("lossless.upload", t(63), t(65)), ("decompress.blocks", t(70), t(80)),
                  ("decompress.upload", t(71), t(72)),
                  ("bench.decompress", t(120), t(160)), ("decompress.parse", t(120), t(125)),
                  ("lossless.parse", t(125), t(126)), ("lossless.upload", t(126), t(130)),
                  ("hf.decode", t(130), t(135)), ("decompress.blocks", t(135), t(145)),
                  ("decompress.upload", t(136), t(138)), ("decompress.predict", t(145), t(150))]
        ops += [("kernel_a", t(5), t(10)), ("compress_trials", t(10), t(30)), ("hf_encode_kernel", t(40), t(44)),
                ("verify_decode", t(62), t(90)), ("Memcpy DtoH (Device -> Pageable)", t(92), t(100)),
                ("Memcpy HtoD (Pageable -> Device)", t(122), t(124)), ("hf_decode_kernel", t(130), t(135)),
                ("interp_decode_kernel", t(139), t(150)), ("scatter", t(155), t(158))]
    return Trace(spans, ops)


def read(name, trace):
    return metric_module(name).read(Run({"spec": {}}, [], 0.0, {}, {}, trace=trace))


@pytest.mark.parametrize("calls", [1, 2])
def test_host_io_counts_verify_s_decode_on_the_compress_side(calls):
    tr = io_trace(calls)
    # verify's parse and uploads (6 ms) count on the compress side, never on the decompress side
    assert read("host_io_ms.compress", tr) == pytest.approx(4 + 5 + 3 + 2 + 1 + 2 + 1)
    assert read("host_io_ms.decompress", tr) == pytest.approx(5 + 1 + 4 + 2)


def test_host_io_leaves_out_the_tuners_trial_packs():
    tr = io_trace()
    assert tr.span_ms("compress", lambda n: n == "lossless.pack") == pytest.approx(2 + 5)
    assert read("host_io_ms.compress", tr) == pytest.approx(18)  # the 2 ms inside compress.plan left out


def test_host_io_reads_nothing_from_a_program_without_its_spans():
    old = Trace([("bench.compress", 0, 100 * MS), ("compress.verify", 60 * MS, 90 * MS),
                 ("hf.decode", 70 * MS, 75 * MS), ("bench.decompress", 120 * MS, 140 * MS),
                 ("decompress.blocks", 124 * MS, 130 * MS)], [("hf_decode_kernel", 122 * MS, 123 * MS)])
    for name in ("host_io_ms.compress", "host_io_ms.decompress"):
        assert read(name, old) is None and read(name, None) is None
    # the parent's trace still gives its idle under no program span: all but the busy 1 ms and blocks' 6
    assert read("unspanned_idle.decompress", old) == pytest.approx(100 * (20 - 1 - 6) / 20)


def test_unspanned_idle_reads_nothing_without_device_rows():
    tr = io_trace()
    bare = Trace(tr.spans, [])
    assert read("unspanned_idle.compress", bare) is None and read("unspanned_idle.decompress", bare) is None
    assert read("host_io_ms.compress", bare) == pytest.approx(18)  # host spans need no device rows


@pytest.mark.parametrize("calls", [1, 2])
def test_unspanned_idle_is_the_idle_under_bench_over_the_walls(calls):
    tr = io_trace(calls)
    # compress: idle 4-5, 30-40, 44-45, 53-60 and 90-92 ms under bench.compress alone, of a 100 ms wall
    assert read("unspanned_idle.compress", tr) == pytest.approx(100 * (1 + 10 + 1 + 7 + 2) / 100)
    # decompress: idle 150-155 and 158-160 ms under bench.decompress alone, of a 40 ms wall
    assert read("unspanned_idle.decompress", tr) == pytest.approx(100 * (5 + 2) / 40)
    gaps = dict(tr.breakdown(top=100)["idle_gaps"])
    assert gaps["lossless.upload"] == pytest.approx(calls * 4e-3)  # the stream's upload has its own name now
    # with the rest of the idle: every idle ms is under one span, and the busy time completes the walls
    assert sum(gaps.values()) == pytest.approx(tr.wall_s() - tr.busy_s())


IO_METRICS = ["host_io_ms.compress", "host_io_ms.decompress", "unspanned_idle.compress", "unspanned_idle.decompress"]


@pytest.mark.parametrize("name", IO_METRICS)
def test_each_io_metric_file_agrees_with_its_benchmark_entry(name):
    import json

    from conftest import ROOT

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    row = {m["name"]: m for m in bench["per_layer"]}[name]
    moved = {m["name"]: m for m in bench["end_to_end"]}[row["moves"]]
    cells = {w["name"] for w in bench["workloads"]}
    mod = metric_module(name)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == \
        (row["unit"], row["better"], row["source"], row["layer"], row["moves"])
    assert row["workloads"] and all(c in cells and c in moved.get("workloads", cells) for c in row["workloads"])
    assert row["layer"] in (ROOT / "PERF.md").read_text()
