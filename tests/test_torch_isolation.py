"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
runs on the card unless asked for the CPU, and has no hidden fallbacks."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import Compressor, CompressorSpec, NotPortedError
from repro_torch.core.lossless import get_stage, pipelines, register_stage
from repro_torch.kernels import histogram as hist
from repro_torch.kernels import interp3d as interp

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_or_repro(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_and_repro_out_of_sys_modules():
    code = ("import sys, repro_torch.core, repro_torch.kernels, repro_torch.core.lossless.engine; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, check=True)
    assert out.stdout.strip() == "[]"


def test_compressor_runs_on_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        assert Compressor().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Compressor()
    assert Compressor(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        Compressor(device="meta")


def test_wrappers_raise_instead_of_falling_back():
    """Only a CPU tensor takes the plain version; another device raises."""
    with pytest.raises(ValueError):
        hist.histogram256(torch.empty(16, dtype=torch.uint8, device="meta"))
    steps = CompressorSpec().levels
    from repro_torch.core.stencils import build_steps

    st = build_steps(3, 17, steps, ("cubic",) * 4, ("md",) * 4)
    with pytest.raises(ValueError):
        interp.compress_blocks(torch.empty((1, 17, 17, 17), device="meta"), 0.1, st, 16)
    with pytest.raises(ValueError):
        empty = torch.empty(0, device="meta")
        interp.decompress_blocks(torch.empty((1, 17, 17, 17), dtype=torch.uint8, device="meta"),
                                 torch.empty((1, 2, 2, 2), device="meta"), empty.long(), empty, 0.1, st, 16)


@pytest.mark.parametrize("spec", [
    dict(predictor="lorenzo"), dict(predictor="auto"), dict(predictor="offset1d"),
    dict(pipeline="tp"), dict(pipeline="auto"), dict(eb_mode="pw_rel"), dict(psnr_target=60.0),
])
def test_unported_spec_values_parse_then_raise_at_compress(spec):
    sp = CompressorSpec(**spec)
    assert CompressorSpec.from_string(sp.to_string()) == sp
    with pytest.raises(NotPortedError):
        Compressor(sp, device="cpu").compress(np.ones((8, 8, 8), np.float32))


def test_unported_inputs_and_stages_raise():
    x = np.ones((8, 8, 8), np.float32)
    x[1, 2, 3] = np.nan
    with pytest.raises(NotPortedError):
        Compressor(device="cpu").compress(x)
    with pytest.raises(NotPortedError):
        Compressor(device="cpu").decompress(b"CSZH3\n" + bytes(32))
    for name in ("bit1", "zstd"):
        with pytest.raises(NotPortedError):
            get_stage(name)
        with pytest.raises(NotPortedError):
            register_stage(name, lambda d: d, lambda p, h: p)
    with pytest.raises(NotPortedError):
        pipelines.register_pipeline("bit1-first", ("bit1", "rre1"))
    for name in pipelines.UNPORTED_PIPELINES:
        with pytest.raises(NotPortedError):
            pipelines.encode(np.zeros(4, np.uint8), name)
