"""The benchmark's arithmetic on synthetic inputs: the trace reduction, the rates, the roofline
counts, the container reader and the reference's check."""
from __future__ import annotations

import math
import struct

import pytest
import torch

from portbench import container, peaks, reference
from portbench.fields import field_seed, make_field
from portbench.harness import Call, Run, metric_module
from portbench.tracing import Trace, overlap, union

MS = 1_000_000  # ns


def trace_of_two_calls():
    spans = [("bench.compress", 0, 100 * MS), ("compress.autotune", 5 * MS, 25 * MS),
             ("compress.verify", 60 * MS, 90 * MS), ("hf.decode", 70 * MS, 75 * MS),
             ("decompress.blocks", 80 * MS, 84 * MS), ("hf.encode", 40 * MS, 44 * MS),
             ("compress.plan", 26 * MS, 36 * MS), ("rre4.encode", 30 * MS, 33 * MS),
             ("bench.decompress", 120 * MS, 140 * MS), ("hf.decode", 121 * MS, 123 * MS),
             ("decompress.blocks", 124 * MS, 130 * MS), ("decompress.scatter", 131 * MS, 133 * MS)]
    ops = [("void interp_encode_kernel<3, 16>(float const*)", 10 * MS, 20 * MS),
           ("hf_encode_kernel", 15 * MS, 30 * MS),  # overlaps the one before: counted once in busy time
           ("Memcpy DtoH (Device -> Pageable)", 95 * MS, 99 * MS),
           ("hf_decode_kernel", 110 * MS, 112 * MS),  # between calls: the reference's time, not busy
           ("hf_decode_kernel", 122 * MS, 123 * MS), ("interp_decode_kernel<3, 16>", 125 * MS, 135 * MS)]
    return Trace(spans, ops)


def test_union_and_overlap():
    assert union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
    assert overlap([(0, 4), (5, 10)], [(3, 6), (8, 20)]) == 1 + 1 + 2


def test_busy_is_the_union_inside_the_calls_and_idle_follows():
    tr = trace_of_two_calls()
    assert tr.n_calls("compress") == 1 and tr.n_calls("decompress") == 1
    assert tr.busy_s("compress") == pytest.approx((20 + 4) * 1e-3)
    assert tr.busy_s("decompress") == pytest.approx((1 + 10) * 1e-3)
    assert tr.wall_s() == pytest.approx(0.12) and tr.busy_s() == pytest.approx(0.035)
    run = Run({"spec": {}}, [], 0.0, {}, {}, trace=tr)
    assert metric_module("device_idle.compress").read(run) == pytest.approx(100 * (1 - 24 / 100))
    assert metric_module("device_idle.decompress").read(run) == pytest.approx(100 * (1 - 11 / 20))


def test_spans_count_on_the_side_of_the_call_that_holds_them():
    tr = trace_of_two_calls()
    run = Run({"spec": {}}, [], 0.0, {}, {}, trace=tr)
    read = lambda m: metric_module(m).read(run)
    assert read("verify_ms") == pytest.approx(30)
    assert read("tune_ms") == pytest.approx(20 + 10)
    # the sample decode inside compress.verify never counts as decompress time
    assert read("blocks_ms.decompress") == pytest.approx(6 + 2)
    assert read("lossless_ms.decompress") == pytest.approx(2)
    # the planner's trial encode (rre4 inside compress.plan) is the planner's time
    assert read("lossless_ms.compress") == pytest.approx(4)


def test_breakdown_names_the_host_span_behind_each_idle_gap():
    bd = trace_of_two_calls().breakdown()
    ops = dict((k, v) for k, v in bd["device_ops"])
    assert ops["hf_encode_kernel"] == pytest.approx(0.015) and len(bd["device_ops"]) <= 10
    gaps = dict((k, v) for k, v in bd["idle_gaps"])
    # 60-90 ms less the hf.decode and decompress.blocks spans inside it
    assert gaps["compress.verify"] == pytest.approx(0.021) and gaps["hf.decode"] == pytest.approx(0.005 + 0.001)
    assert sum(gaps.values()) == pytest.approx(0.12 - 0.035)


def calls(points=1000, hf=(100, 40), n=3):
    out = []
    for i in range(n):
        out.append(Call("compress", i, points, wall_s=0.5, container_bytes=250, hf=hf))
        out.append(Call("decompress", i, points, wall_s=0.1, container_bytes=250, hf=hf))
    out.append(Call("compress", 9, points, wall_s=9.0, error="RuntimeError"))  # a failed call counts no work
    return out


def test_rates_and_ratio_are_over_all_calls():
    run = Run({"spec": {"verify": "sample"}}, calls(), 1.5, {}, {"platform": "gpu",
                                                                        "memory_peak_bytes": 3 * 2**30})
    read = lambda m: metric_module(m).read(run)
    assert read("compress_GBps") == pytest.approx(3 * 4000 / 1.5 / 1e9)
    assert read("decompress_GBps") == pytest.approx(3 * 4000 / 0.3 / 1e9)
    assert read("cr") == pytest.approx(4000 / 250)
    assert read("peak_gib") == pytest.approx(3.0) and read("setup_s") == 1.5
    run.counters = {"plan_cache_hits": 3, "plan_cache_misses": 1}
    assert read("plan_cache_hit_share") == pytest.approx(75.0)


def test_roofline_counts_come_from_the_work_not_the_launches():
    tr = Trace([("bench.compress", 0, 10 * MS)],
               [("interp_encode_kernel<3,16>", 0, MS), ("interp_encode_kernel<3,16>", MS, 2 * MS),
                ("interp_decode_kernel<3,16>", 0, MS), ("hf_encode_kernel", 0, MS), ("hf_decode_kernel", 0, MS)])
    run = Run({"spec": {"verify": "sample"}}, calls(points=10**6, hf=(10**6, 4 * 10**5)), 0.0, {}, {},
              trace=tr, power_limit="700 W")
    read = lambda m: metric_module(m).read(run)
    # two launches (a trial among them) against three fields of work
    assert read("interp_encode_roofline") == pytest.approx(100 * 3 * 5e6 / peaks.HBM_BYTES_PER_S / 2e-3)
    # decodes: three decompresses and three verify decodes
    assert read("interp_decode_roofline") == pytest.approx(100 * 6 * 5e6 / peaks.HBM_BYTES_PER_S / 1e-3)
    assert read("hf_encode_roofline") == pytest.approx(100 * 3 * 1.4e6 / peaks.HBM_BYTES_PER_S / 1e-3)
    assert read("hf_decode_roofline") == pytest.approx(100 * 6 * 1.4e6 / peaks.HBM_BYTES_PER_S / 1e-3)
    assert all("bound by bytes" in n and "700 W" in n for n in run.notes)
    run.config["spec"]["verify"] = "off"
    assert read("hf_decode_roofline") == pytest.approx(100 * 3 * 1.4e6 / peaks.HBM_BYTES_PER_S / 1e-3)


def test_a_metric_with_nothing_to_read_returns_nothing():
    run = Run({"spec": {}}, [], 0.0, {}, {"platform": "cpu", "memory_peak_bytes": 0})
    for m in ("compress_GBps", "cr", "peak_gib", "verify_ms", "interp_decode_roofline", "device_idle.compress",
              "plan_cache_hit_share"):
        assert metric_module(m).read(run) is None
    run.trace = Trace([("bench.decompress", 0, MS)], [])
    assert metric_module("hf_decode_roofline").read(run) is None  # no rows: never 0 %


def test_roofline_names_what_bounds_it():
    assert peaks.roofline(3.35e12, 0.0, 2.0) == (50.0, "bytes")
    assert peaks.roofline(1.0, 67e12, 4.0) == (25.0, "flops")


def llp2(records, payload: bytes) -> bytes:
    out = bytearray(b"LLP2") + bytes([len(records)])
    for name, stored, hdr in records:
        out += struct.pack("<BB", int(stored), len(name)) + name.encode() + struct.pack("<I", len(hdr)) + hdr
    return bytes(out) + payload


def test_container_reader_counts_the_hf_stage_from_the_headers():
    stream = llp2([("hf", False, struct.pack("<QB", 5000, 1) + b"\0" * 8),
                   ("rre4", True, b""), ("tcms8", False, struct.pack("<QB", 2100, 8)),
                   ("rze1", False, struct.pack("<QQB", 2100, 7, 1))], b"x" * 900)
    buf = container.pack({"shape": [10, 10, 50], "mode": "interp", "eb_abs": 0.5}, [stream, b"a" * 16])
    header, sections = container.parse(buf)
    assert header == {"shape": [10, 10, 50], "mode": "interp", "eb_abs": 0.5}
    assert [len(s) for s in sections] == [len(stream), 16]
    assert container.hf_bytes(buf) == (5000, 2100)
    recs = container.stages(stream)
    assert [r["out"] for r in recs if not r["stored"]] == [2100, 2100, 900]
    for bad in (buf[:-1], b"CSZH1\n" + buf[6:], buf + b"\0"):
        with pytest.raises(container.ContainerFault):
            container.parse(bad)


def test_a_field_comes_from_its_seed_and_index():
    recipe = {"base_seed": 0, "alpha": 2.0, "post": "exp", "gain": 2.0}
    cpu = torch.device("cpu")
    a, b, other_index, other_seed = (make_field(recipe, (8, 9, 10), s, i, cpu)
                                     for s, i in ((2**31 + 7, 1), (2**31 + 7, 1), (2**31 + 7, 2), (5, 1)))
    assert torch.equal(a, b) and a.shape == (8, 9, 10) and a.dtype == torch.float32
    assert not torch.equal(a, other_index) and not torch.equal(a, other_seed)
    assert float(a.max()) <= math.exp(2.0) + 1e-5 and field_seed(-5, 0) != field_seed(5, 0)
    assert 0 <= field_seed(2**40, 3) < 2**63


def test_a_mix_states_only_what_the_generator_reads():
    from portbench.traffic import Mix

    ok = {"ops": ["compress", "decompress"], "plan_cache": "none", "why": "test"}
    assert Mix(ok).ops == ("compress", "decompress") and not Mix(ok).from_setup
    assert Mix(dict(ok, ops=["decompress"])).from_setup
    for bad in (dict(ok, loop="closed"), {k: v for k, v in ok.items() if k != "plan_cache"},
                dict(ok, ops=["decompress", "compress"]), dict(ok, ops=["compress"]), dict(ok, plan_cache="always")):
        with pytest.raises(ValueError):
            Mix(bad)


def test_the_reference_reads_every_point():
    x = torch.linspace(0, 1, 5000)
    y = x.clone()
    y[4321] += 0.25
    assert reference.max_abs_diff(x, y) == pytest.approx(0.25)
    y[17] = float("nan")
    assert reference.max_abs_diff(x, y) == math.inf
    assert reference.max_abs_diff(x, x[:-1]) == math.inf and reference.max_abs_diff(x, x.double()) == math.inf
    assert reference.abs_bound(1e-3, "rel", x) == pytest.approx(1e-3)


def test_the_bf16_control_breaks_the_bound():
    x = make_field({"alpha": 2.6, "post": "tanh", "gain": 4.0}, (16, 16, 16), 3, 0, torch.device("cpu"))
    codec = reference.PlainBF16(1e-3, "rel", torch.device("cpu"))
    y = codec.decompress(codec.compress(x))
    assert reference.max_abs_diff(x, y) / reference.abs_bound(1e-3, "rel", x) > 1.0001
