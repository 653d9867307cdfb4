"""Whole runs of the harness on the CPU at tiny sizes, through ``Compressor(device="cpu")``: each
mix, a cell added as files alone, the control and planted faults that ``correct`` must catch, and
the entry point's refusal without a card."""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_copy

CPU = torch.device("cpu")
CELLS = ["nyx512.roundtrip", "miranda.plan-roundtrip", "nyx512.decompress", "miranda.plan-cached-roundtrip"]


def run(bench, cell, trace=False, seconds=0.3, codec=None, seed=2**31 + 3):
    from portbench.harness import run_cell

    return run_cell(cell, seed, seconds, trace, CPU, bench_dir=bench, codec=codec)


@pytest.mark.parametrize("cell", CELLS)
def test_each_mix_runs_and_is_correct_on_the_cpu(tiny_bench, cell):
    out = run(tiny_bench, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks" and out["checks"]["max_err_over_eb"]["value"] <= 1.0001
    assert {"cr", "setup_s", "decompress_GBps"} <= set(out["metrics"])
    assert ("compress_GBps" in out["metrics"]) == (cell != "nyx512.decompress")
    assert out["device"]["platform"] == "cpu"  # a CPU run never reads as the card's


def test_a_traced_run_reports_the_per_layer_metrics(tiny_bench):
    out = run(tiny_bench, "miranda.plan-cached-roundtrip", trace=True)
    assert out["correct"]
    # set-up filled the cache with every field's plan: no lookup misses, the planner never runs
    assert out["metrics"]["plan_cache_hit_share"]["value"] == 100.0
    assert out["metrics"]["tune_ms"]["value"] == 0.0 and "verify_ms" in out["metrics"]
    assert out["device"]["window_s"] > 0 and set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_seed_times_the_same_work_and_judges_a_snapshot_of_its_own(tiny_bench):
    # the same resident fields, so the same containers in the window; each seed's snapshot is judged after it
    a, b = run(tiny_bench, "nyx512.decompress", seed=11), run(tiny_bench, "nyx512.decompress", seed=2**32 + 5)
    assert a["correct"] and b["correct"]
    assert a["metrics"]["cr"]["value"] == pytest.approx(b["metrics"]["cr"]["value"], rel=0.01)  # other counts a field
    assert a["checks"]["max_err_over_eb"]["value"] != b["checks"]["max_err_over_eb"]["value"]


def test_a_cell_added_as_files_alone_is_found_and_run(tiny_bench):
    (tiny_bench / "configs" / "tiny-aniso.json").write_text(json.dumps({
        "name": "tiny-aniso", "source": "test", "fields": 3, "shape": [9, 16, 12], "dtype": "float32",
        "recipe": {"base_seed": 4, "alpha": 2.4, "post": "tanh", "gain": 2.0, "aniso": [2.0, 1.0, 1.0]}, "assumed": ["test"],
        "spec": {"eb": 1e-2, "eb_mode": "rel", "predictor": "interp", "pipeline": "tp", "verify": "full"},
        "guarantee": {"eb": 1e-2, "eb_mode": "rel", "slack": 1e-4}}))
    (tiny_bench / "traffic" / "cached.json").write_text(json.dumps({
        "ops": ["compress", "decompress"], "plan_cache": "setup"}))
    (tiny_bench / "workloads" / "tiny.cached.json").write_text(json.dumps(
        {"config": "tiny-aniso", "traffic": "cached"}))
    (tiny_bench / "metrics" / "container_kib.py").write_text(
        'UNIT = "KiB"\nBETTER = "lower"\nSOURCE = "host_clock"\n\n\n'
        'def read(run):\n    c = run.of("decompress")\n    return sum(x.container_bytes for x in c) / len(c) / 1024\n')
    bench_json = tiny_bench.parent / "BENCHMARK.json"
    bench = json.loads(bench_json.read_text())
    bench["workloads"].append({"name": "tiny.cached", "config": "tiny-aniso", "traffic": "cached", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "container_kib", "unit": "KiB", "better": "lower", "bound": 0.01,
                                "source": "host_clock", "workloads": ["tiny.cached"]})
    bench_json.write_text(json.dumps(bench))
    out = run(tiny_bench, "tiny.cached")
    assert out["correct"] and out["metrics"]["container_kib"]["value"] > 0
    assert "compress_GBps" not in out["metrics"]  # listed for the issue's round-trip cells only
    assert run(tiny_bench, "nyx512.roundtrip")["correct"]  # the cells already there run as before


class Faulty:
    """The program with a fault planted underneath the timed path."""

    def __init__(self, cell, bench, fault):
        from portbench.fields import make_field
        from portbench.harness import load_cell
        from portbench.program import Program

        cfg = load_cell(cell, bench)["config"]
        self.inner = Program(cfg["spec"], CPU, plan_cache=False)
        self.fault = fault
        self.resident = [make_field(cfg["recipe"], cfg["shape"], cfg["recipe"]["base_seed"], i, CPU)
                         for i in range(cfg["fields"])]
        self.unseen = set()

    def compress(self, x):
        buf = self.inner.compress(x)
        if self.fault == "new_data" and not any(torch.equal(x, r) for r in self.resident):
            self.unseen.add(buf)  # a path that breaks on data the window never sends
        if self.fault == "container":  # one byte of the lossless payload altered where it is produced
            from portbench.container import parse

            sections = parse(buf)[1]
            start = len(buf) - sum(len(s) for s in sections)
            buf = bytearray(buf)
            buf[start + len(sections[0]) // 10] ^= 0x5A
            buf = bytes(buf)
        return buf

    def decompress(self, buf):
        y = self.inner.decompress(buf)
        if self.fault == "answer":  # one decoded point altered where it is produced
            y = y.clone()
            y.view(-1)[y.numel() // 2] += 1e-2 * float(y.max() - y.min())
        if self.fault == "new_data" and buf in self.unseen:
            y = y.clone()
            y.view(-1)[0] += 1e-2 * float(y.max() - y.min())
        if self.fault == "half":  # half of the field left out
            y = y.clone()
            y.view(-1)[y.numel() // 2:] = 0.0
        return y

    def counters(self):
        return {}

    def last_repairs(self):
        return self.inner.last_repairs()


@pytest.mark.parametrize("fault", ["answer", "container", "half", "new_data"])
def test_a_planted_fault_turns_correct_false(tiny_bench, fault):
    out = run(tiny_bench, "nyx512.roundtrip", codec=Faulty("nyx512.roundtrip", tiny_bench, fault))
    assert not out["correct"] and out["failed"] >= 1
    # ``failed`` counts the requests whose own numbers break the limits of ``checks``
    over = {k: v["value"] > v["limit"] for k, v in out["checks"].items()}
    assert any(over.values()) and (fault != "new_data" or out["failed"] == 2)


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_comes_out_not_correct(tiny_bench, cell):
    sys.path.insert(0, str(ROOT / "portbench"))
    from portbench.control import control_codec

    out = run(tiny_bench, cell, codec=control_codec(cell, CPU, tiny_bench))
    assert not out["correct"] and out["checks"]["max_err_over_eb"]["value"] > 1.0001


def test_run_py_without_a_card_exits_non_zero_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nyx512.roundtrip", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and '"metrics"' not in p.stdout and "CUDA card" in p.stderr


def test_run_py_in_a_directory_of_the_benchmark_alone_exits_non_zero(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nyx512.roundtrip", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and '"metrics"' not in p.stdout


@pytest.mark.cuda
def test_a_tiny_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tiny_copy(tmp_path)
    shutil.copytree(ROOT / "src", tmp_path / "src", ignore=shutil.ignore_patterns("_build", "__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nyx512.roundtrip", "--seed", "5",
                        "--seconds", "2", "--trace", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=900)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0 and out["correct"] and out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
