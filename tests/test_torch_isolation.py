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

from repro_torch.core import Compressor, CompressorSpec, chunk_compress
from repro_torch.core.lossless import get_stage, pipelines, register_stage
from repro_torch.kernels import bitshuffle as bits
from repro_torch.kernels import histogram as hist
from repro_torch.kernels import interp3d as interp
from repro_torch.kernels import lorenzo3d as lor

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_bench.py"]
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
    with pytest.raises(ValueError):
        bits.bitshuffle(torch.empty(16, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        bits.bitunshuffle(torch.empty(8192, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        lor.lorenzo_encode(torch.empty((4, 4, 4), device="meta"), 0.1, 3)
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
    dict(pipeline="crz"), dict(predictor="auto"), dict(predictor="offset1d"),
    dict(predictor="lorenzo", pipeline="crz"), dict(pipeline="auto"), dict(eb_mode="pw_rel"), dict(psnr_target=60.0),
])
def test_spec_values_parse_compress_and_decompress_within_the_bound(spec):
    sp = CompressorSpec(**spec)
    assert CompressorSpec.from_string(sp.to_string()) == sp
    x = np.linspace(1.0, 2.0, 512, dtype=np.float32).reshape(8, 8, 8) ** 2
    comp = Compressor(sp, device="cpu")
    buf = comp.compress(x)
    y = comp.decompress(buf).astype(np.float64)
    if sp.eb_mode == "pw_rel":
        assert np.max(np.abs(y - x) / np.abs(x)) <= sp.eb * (1 + 1e-4)
    elif sp.psnr_target is not None:
        assert 10 * np.log10(float(x.max() - x.min()) ** 2 / np.mean((y - x) ** 2)) >= sp.psnr_target
    else:
        assert np.max(np.abs(y - x)) <= Compressor.inspect(buf)["eb_abs"] * (1 + 1e-4)


def test_unported_inputs_and_stages_raise():
    """Container v3, NaN/Inf input and the zstd stage are ported: none raises."""
    x = np.ones((8, 8, 8), np.float32)
    x[1, 2, 3] = np.nan
    y = Compressor(device="cpu").decompress(Compressor(device="cpu").compress(x))
    assert np.array_equal(y.view(np.uint32), x.view(np.uint32))
    v3 = chunk_compress(x, n_chunks=3, device="cpu")
    assert v3[:6] == b"CSZH3\n"
    y3 = Compressor(device="cpu").decompress(v3)
    assert np.array_equal(y3.view(np.uint32), x.view(np.uint32))
    assert get_stage("zstd").portable is False and get_stage("zstd").encode_device is None
    with pytest.raises(ValueError, match="already registered"):
        register_stage("zstd", lambda d: d, lambda p, h: p)
    data = np.repeat(np.arange(64, dtype=np.uint8), 100)
    for pipe in (("rre1", "zstd"), "crz"):
        assert np.array_equal(pipelines.decode(pipelines.encode(data, pipe)), data)
