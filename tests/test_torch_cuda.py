"""The port's CUDA kernels and its card path, on an NVIDIA card.

Skipped where CUDA is absent (the check runs inside a fixture, never at
import). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The plain torch predictor applies the banded taps in the kernels' order
with every operation rounded on its own, so kernel and plain agree bit for
bit; the histogram is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Compressor
from repro_torch.core import predictor as plain
from repro_torch.core.autotune import levels_for_stride
from repro_torch.core.stencils import build_steps
from repro_torch.kernels import histogram as hist
from repro_torch.kernels import interp3d as interp
from repro_torch.kernels import launch_counts, reset_launch_counts

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _steps(ndim, stride, spline, scheme):
    lv = levels_for_stride(stride)
    return build_steps(ndim, 17, lv, (spline,) * len(lv), (scheme,) * len(lv))


@pytest.mark.parametrize("ndim,scheme", [(3, "md"), (3, "1d-210"), (2, "md"), (2, "1d-10"), (1, "md")])
@pytest.mark.parametrize("stride", [16, 8])
@pytest.mark.parametrize("spline", ["linear", "cubic", "natural-cubic"])
def test_interp_kernels_match_plain(cuda, ndim, scheme, stride, spline):
    g = torch.Generator(device=cuda).manual_seed(ndim * 100 + stride)
    blocks = torch.randn((37,) + (17,) * ndim, generator=g, device=cuda).cumsum(1)
    blocks[::3, 3] += 100.0  # a slab of outliers in every third block
    eb = 1e-2
    steps = _steps(ndim, stride, spline, scheme)
    ck, rk = interp.compress_blocks(blocks, 2 * eb, steps, stride)
    cp, rp = plain.compress_blocks(blocks, 2 * eb, steps, stride)
    assert torch.equal(ck, cp) and torch.equal(rk, rp)
    c_only, none = interp.compress_blocks(blocks, 2 * eb, steps, stride, with_recon=False)
    assert none is None and torch.equal(c_only, ck)
    dec_in = plain.decode_inputs(blocks, ck, stride)
    assert dec_in[1].numel() > 0  # the replay sees outliers
    dk = interp.decompress_blocks(ck, *dec_in, 2 * eb, steps, stride)
    assert torch.equal(dk, rk)
    assert torch.equal(plain.decompress_blocks(ck, *dec_in, 2 * eb, steps, stride), dk)
    anchors, keys, vals = dec_in  # keys in any order give the same replay
    perm = torch.randperm(keys.numel(), generator=g, device=cuda)
    assert torch.equal(interp.decompress_blocks(ck, anchors, keys[perm], vals[perm], 2 * eb, steps, stride), dk)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 8191, 8193, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 7])
def test_histogram_kernel_is_exact(cuda, n, offset):
    g = torch.Generator(device=cuda).manual_seed(n)
    d = torch.randint(0, 256, (n + offset,), generator=g, device=cuda, dtype=torch.uint8)
    d[(torch.rand(n + offset, generator=g, device=cuda) < 0.8)] = 128
    x = d[offset:]
    assert torch.equal(hist.histogram256(x), torch.bincount(x, minlength=256))


def test_wrappers_check_their_inputs(cuda):
    steps = _steps(3, 16, "cubic", "md")
    with pytest.raises(TypeError):
        interp.compress_blocks(torch.zeros((2, 17, 17, 17), dtype=torch.float64, device=cuda), 0.1, steps)
    with pytest.raises(ValueError):
        interp.compress_blocks(torch.zeros((2, 17, 17, 18), device=cuda), 0.1, steps)
    with pytest.raises(ValueError):
        interp.compress_blocks(torch.zeros((17, 17, 17, 2), device=cuda).permute(3, 0, 1, 2), 0.1, steps)
    codes = torch.full((2, 17, 17, 17), 128, dtype=torch.uint8, device=cuda)
    keys, vals = torch.zeros(0, dtype=torch.int64, device=cuda), torch.zeros(0, device=cuda)
    with pytest.raises(ValueError):  # stride-16 blocks have 2 anchors per dim
        interp.decompress_blocks(codes, torch.zeros((2, 3, 3, 3), device=cuda), keys, vals, 0.1, steps, 16)
    with pytest.raises(TypeError):
        interp.decompress_blocks(codes, torch.zeros((2, 2, 2, 2), device=cuda), keys.int(), vals, 0.1, steps, 16)
    with pytest.raises(TypeError):
        hist.histogram256(torch.zeros(8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        hist.histogram256(torch.zeros(16, dtype=torch.uint8, device=cuda)[::2])


def test_card_and_cpu_write_the_same_container(cuda):
    gr = np.linspace(0, 4 * np.pi, 48)
    X, Y, Z = np.meshgrid(gr, gr, gr, indexing="ij")
    x = (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.05 * np.cos(3 * X)).astype(np.float32)
    comp = Compressor()
    reset_launch_counts()
    buf = comp.compress(x)
    y = comp.decompress(buf, out="device")
    counts = launch_counts()
    assert all(v > 0 for v in counts.values()), counts
    assert comp.last_telemetry["fallbacks"] == []
    assert y.is_cuda and tuple(y.shape) == x.shape
    assert buf == Compressor(device="cpu").compress(x)
    eb = Compressor.inspect(buf)["eb_abs"]
    assert float(np.abs(Compressor(device="cpu").decompress(buf) - x).max()) <= eb * (1 + 1e-4)
    assert np.array_equal(y.cpu().numpy(), Compressor(device="cpu").decompress(buf))
