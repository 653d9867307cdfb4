"""BENCHMARK.json against the contract's shape and the files the harness finds by name."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
PER_LAYER = {m["name"]: m for m in BENCH["per_layer"]}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

ISSUE_CELLS = ["nyx512.roundtrip", "miranda.plan-roundtrip", "nyx512.decompress", "miranda.plan-cached-roundtrip"]
ISSUE_CONFIGS = ["nyx-512", "miranda-plan"]
ISSUE_MIXES = ["roundtrip", "decompress", "plan-cached-roundtrip"]
ISSUE_E2E = ["compress_GBps", "decompress_GBps", "cr", "peak_gib", "setup_s"]
ISSUE_PER_LAYER = ["verify_ms", "tune_ms", "plan_cache_hit_share", "blocks_ms.compress", "blocks_ms.decompress",
                   "lossless_ms.compress", "lossless_ms.decompress", "interp_encode_roofline",
                   "interp_decode_roofline", "hf_encode_roofline", "hf_decode_roofline", "device_idle.compress",
                   "device_idle.decompress"]


def metric(name):
    from portbench.harness import metric_module

    return metric_module(name)


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells at this length fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_name_and_unit_keeps_to_the_characters():
    names = [c["name"] for c in BENCH["configs"]] + list(CELLS) + list(E2E) + list(PER_LAYER)
    names += [w["config"] for w in CELLS.values()] + [w["traffic"] for w in CELLS.values()]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(CELLS) == len(BENCH["workloads"]) and len(set(E2E) | set(PER_LAYER)) == len(E2E) + len(PER_LAYER)
    for m in list(E2E.values()) + list(PER_LAYER.values()):
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in [c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]] + \
            [w["why"] for w in CELLS.values()] + [m["layer"] for m in PER_LAYER.values()]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_the_issue_names_appear_letter_for_letter():
    assert list(CELLS) == ISSUE_CELLS
    assert [c["name"] for c in BENCH["configs"]] == ISSUE_CONFIGS
    assert sorted({w["traffic"] for w in CELLS.values()}) == sorted(ISSUE_MIXES)
    assert sorted(E2E) == sorted(ISSUE_E2E) and list(PER_LAYER) == ISSUE_PER_LAYER


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in CELLS.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len({(x["config"], x["traffic"]) for x in CELLS.values()}) == len(CELLS)
    for m in E2E.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in PER_LAYER.values():
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", ISSUE_CELLS)
def test_each_cell_file_names_a_config_and_a_mix_that_exist(cell):
    from portbench.harness import BENCH_DIR, load_cell

    own = json.loads((BENCH_DIR / "workloads" / f"{cell}.json").read_text())
    assert (own["config"], own["traffic"]) == (CELLS[cell]["config"], CELLS[cell]["traffic"])
    assert load_cell(cell)["config"]["name"] == own["config"]
    assert (BENCH_DIR / "traffic" / f"{own['traffic']}.json").exists()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_file_states_its_source_assumptions_and_guarantee(cfg):
    own = json.loads((ROOT / cfg["file"]).read_text())
    assert own["name"] == cfg["name"] and own["source"] == cfg["source"]
    assert own["assumed"] and own["guarantee"]["slack"] >= 0 and own["dtype"] == "float32"
    assert cfg["file"].startswith("portbench/") and cfg["reduced"] == []
    assert len([c for c in BENCH["configs"] if c["file"] == cfg["file"]]) == 1


@pytest.mark.parametrize("name", ISSUE_E2E + ISSUE_PER_LAYER)
def test_each_metric_file_agrees_with_benchmark_json(name):
    row = E2E.get(name) or PER_LAYER[name]
    mod = metric(name)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (row["unit"], row["better"], row["source"])
    if name in PER_LAYER:
        assert (mod.LAYER, mod.MOVES) == (row["layer"], row["moves"])


@pytest.mark.parametrize("name", ISSUE_PER_LAYER)
def test_each_cell_of_a_per_layer_metric_reports_what_it_moves(name):
    row = PER_LAYER[name]
    moved = E2E[row["moves"]]
    assert row["workloads"], "every per-layer metric lists the cells that report it"
    for cell in row["workloads"]:
        assert cell in CELLS and ("workloads" not in moved or cell in moved["workloads"]), (name, cell)


@pytest.mark.parametrize("cell", ISSUE_CELLS)
def test_each_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one(cell):
    from portbench.harness import metric_names

    e2e = metric_names(BENCH, cell, trace=False)
    assert "setup_s" in e2e and len(e2e) >= 2 and metric_names(BENCH, cell, trace=True)


def test_layers_are_the_ones_perf_md_lists():
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in PER_LAYER.values()}:
        assert layer in perf, layer
