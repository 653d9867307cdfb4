"""Shared fixtures of the benchmark's own tests (run them from the repo root:
``python -m pytest portbench/tests``; the tier-1 run collects ``tests/`` only)."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny stand-ins for the configurations' shapes, for CPU runs
TINY = {"nyx-512": ([20, 18, 17], 2), "miranda-plan": ([12, 20, 19], 2)}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_copy(dst: pathlib.Path) -> pathlib.Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``dst`` with the
    configurations cut to tiny shapes; returns the copy's ``portbench``."""
    bench = dst / "portbench"
    shutil.copytree(ROOT / "portbench", bench, ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name, (shape, n) in TINY.items():
        p = bench / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg["shape"], cfg["fields"] = shape, n
        p.write_text(json.dumps(cfg))
    return bench


@pytest.fixture
def tiny_bench(tmp_path) -> pathlib.Path:
    return tiny_copy(tmp_path)
