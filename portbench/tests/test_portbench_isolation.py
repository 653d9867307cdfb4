"""What the benchmark may import: never the JAX stack or the JAX package, and the program only
from the program side of the harness."""
from __future__ import annotations

import ast
import sys

import pytest

from conftest import ROOT

SOURCES = sorted((ROOT / "portbench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# modules of the yardstick: they judge and count, so they import nothing of the program
YARDSTICK = ["reference.py", "container.py", "tracing.py", "peaks.py", "fields.py", "traffic.py"]


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_the_jax_stack_or_the_jax_package(path):
    # compared by whole top-level name: repro_torch is not repro
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK + [p.name for p in sorted((ROOT / "portbench" / "metrics").glob("*.py"))])
def test_the_yardstick_imports_nothing_of_the_program(name):
    path = ROOT / "portbench" / name if (ROOT / "portbench" / name).exists() else ROOT / "portbench" / "metrics" / name
    assert "repro_torch" not in top_level_imports(path)


def test_only_the_program_side_imports_the_program():
    users = [p.relative_to(ROOT).as_posix() for p in SOURCES if "repro_torch" in top_level_imports(p)]
    assert users == ["portbench/program.py"]


def test_the_leak_check_compares_whole_top_level_names(monkeypatch):
    from portbench.harness import leaked_modules

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert leaked_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert leaked_modules() == ["jax", "repro"]
