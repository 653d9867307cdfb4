"""The port's CUDA kernels and its card path, on an NVIDIA card.

Skipped where CUDA is absent (the check runs inside a fixture, never at
import). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The plain torch predictor applies the banded taps in the kernels' order
with every operation rounded on its own, so kernel and plain agree bit for
bit; the histogram, the bitshuffle and the Lorenzo encode are exact.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import Compressor
from repro_torch.core import frames as tframes
from repro_torch.core import lorenzo as plain_lorenzo
from repro_torch.core import predictor as plain
from repro_torch.core.lossless import bitshuffle as host_bit
from repro_torch.core.autotune import levels_for_stride
from repro_torch.core.stencils import build_steps
from repro_torch.kernels import bitshuffle as bits
from repro_torch.kernels import histogram as hist
from repro_torch.kernels import interp3d as interp
from repro_torch.kernels import lorenzo3d as lor
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
@pytest.mark.parametrize("stride", [16, 8, 4])
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


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("nb", [0, 1, 131, 133, 4097])
def test_interp_kernels_ragged_block_counts(cuda, ndim, nb):
    """Block counts that are no multiple of the persistent grid or of the
    blocks a CTA holds (8 in 2-D, 32 in 1-D), with outliers, as slices of a
    larger tensor (the decoder's codes then start unaligned)."""
    g = torch.Generator(device=cuda).manual_seed(nb * 10 + ndim)
    full = torch.randn((nb + 1,) + (17,) * ndim, generator=g, device=cuda).cumsum(1)
    full[1::3, 2] += 100.0
    blocks, eb = full[1:], 1e-2
    steps = _steps(ndim, 16, "cubic", "md")
    ck, rk = interp.compress_blocks(blocks, 2 * eb, steps, 16)
    cp, rp = plain.compress_blocks(blocks, 2 * eb, steps, 16)
    assert torch.equal(ck, cp) and torch.equal(rk, rp)
    dec_in = plain.decode_inputs(blocks, ck, 16)
    codes = torch.cat([torch.zeros((1,) + ck.shape[1:], dtype=torch.uint8, device=cuda), ck])[1:]
    assert torch.equal(interp.decompress_blocks(codes, *dec_in, 2 * eb, steps, 16), rk)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 8191, 8193, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 7])
def test_histogram_kernel_is_exact(cuda, n, offset):
    g = torch.Generator(device=cuda).manual_seed(n)
    d = torch.randint(0, 256, (n + offset,), generator=g, device=cuda, dtype=torch.uint8)
    d[(torch.rand(n + offset, generator=g, device=cuda) < 0.8)] = 128
    x = d[offset:]
    assert torch.equal(hist.histogram256(x), torch.bincount(x, minlength=256))


def _hist_stream(kind, n, device):
    g = torch.Generator(device=device).manual_seed(n)
    if kind.startswith("const"):
        return torch.full((n,), int(kind[5:]), dtype=torch.uint8, device=device)
    d = torch.randint(0, 256, (n,), generator=g, device=device, dtype=torch.uint8)
    if kind == "center90":
        d[torch.rand(n, generator=g, device=device) < 0.9] = 128
    return d


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 8191, 8193, 1_000_003, 512**3])
@pytest.mark.parametrize("kind", ["const0", "const128", "const255", "uniform", "center90"])
def test_histogram_kernel_streams_at_every_offset(cuda, kind, n):
    """One byte value everywhere (every lane on one bin), uniform, and 90 %
    the center code (counted in registers), at each of the 16 head offsets."""
    d = _hist_stream(kind, n + 15, cuda)
    for off in range(16):
        x = d[off: off + n]
        assert torch.equal(hist.histogram256(x), torch.bincount(x, minlength=256)), off


@pytest.mark.parametrize("n", [0, 1, 31, 8191, 8192, 8193, 1_000_003])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("block", [8192, 1024, 32])
def test_bitshuffle_kernels_are_exact(cuda, n, offset, block):
    g = torch.Generator(device=cuda).manual_seed(n + block)
    d = torch.randint(0, 256, (n + offset,), generator=g, device=cuda, dtype=torch.uint8)
    x = d[offset:]  # offset 3: an unaligned input
    planes = bits.bitshuffle(x, block)
    assert torch.equal(planes, bits.bitshuffle_plain(x, block))
    assert planes.cpu().numpy().tobytes() == host_bit.bitshuffle_encode(x.cpu().numpy(), block)[0]
    back = bits.bitunshuffle(planes, block)
    assert torch.equal(back, bits.bitunshuffle_plain(planes, block))
    assert torch.equal(back[:n], x) and not back[n:].any()


def _lorenzo_field(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).cumsum(-1)
    x.view(-1)[::101] += 500.0  # forced outliers
    return x.contiguous()


# Z around the 4-point lane groups and the 256-point warp, Y around the
# 8-row tile, X == 1 (runs as a march along y), a 700-plane march and
# batched fields
LORENZO_EDGE_SHAPES = ([((5, y, z), 3) for y in (1, 7, 9) for z in (1, 31, 33, 127, 129, 257, 513)]
                       + [((1, 9, 129), 3), ((1, 7, 513), 3), ((700, 9, 33), 3), ((3, 40, 9, 129), 3),
                          ((4, 33, 70), 2), ((2, 3, 600), 1)])


@pytest.mark.parametrize("shape,nd", [((1000,), 1), ((37, 45), 2), ((33, 35, 70), 3), ((3, 9, 31, 40), 3),
                                      ((5, 129), 1), ((2, 3, 17, 33), 2), ((64, 64, 64), 3), ((1, 1, 1), 3)]
                         + LORENZO_EDGE_SHAPES)
@pytest.mark.parametrize("twoeb", [0.02, 2e-6])
def test_lorenzo_kernel_is_exact(cuda, shape, nd, twoeb):
    x = _lorenzo_field(shape, sum(shape), cuda)
    if twoeb < 1e-3:
        x = x * 1e4  # |x| / 2eb beyond 2^31: saturation and wrapping deltas
    codes, idx, vals = lor.lorenzo_encode(x, twoeb, nd)
    pc, po, pfull = plain_lorenzo.lorenzo_encode(x, twoeb, nd)
    pidx = torch.nonzero(po.reshape(-1)).reshape(-1)
    assert torch.equal(codes, pc) and torch.equal(idx, pidx) and torch.equal(vals, pfull.reshape(-1)[pidx])
    cc, ci, cv = lor.lorenzo_encode(x.cpu(), twoeb, nd)  # the plain version on the CPU agrees too
    assert torch.equal(cc, codes.cpu()) and torch.equal(ci, idx.cpu()) and torch.equal(cv, vals.cpu())
    if twoeb > 1e-3:
        assert idx.numel() > 0


def _lorenzo_case_field(kind, shape, device):
    if kind == "all-outliers":  # a checkerboard of +-500: every delta is a multiple of 25000
        ix = torch.stack(torch.meshgrid(*[torch.arange(s, device=device) for s in shape], indexing="ij")).sum(0)
        return (ix % 2).float() * 1000.0 - 500.0
    x = torch.zeros(shape, device=device)
    x.view(-1)[-1] = 50.0  # a spike on the last point: its delta alone is an outlier
    return x


@pytest.mark.parametrize("kind,expect", [("all-outliers", 100 * 100 * 260), ("one-outlier", 1)])
def test_lorenzo_kernel_all_and_one_outlier(cuda, kind, expect):
    x = _lorenzo_case_field(kind, (100, 100, 260), cuda)
    reset_launch_counts()
    codes, idx, vals = lor.lorenzo_encode(x, 0.02, 3)
    pc, po, pfull = plain_lorenzo.lorenzo_encode(x, 0.02, 3)
    pidx = torch.nonzero(po.reshape(-1)).reshape(-1)
    assert torch.equal(codes, pc) and torch.equal(idx, pidx) and torch.equal(vals, pfull.reshape(-1)[pidx])
    assert idx.numel() == expect
    # the first outlier list holds 1/64 of the points; more overflow it, and the kernel runs again
    assert launch_counts()["lorenzo_encode"] == (2 if expect > lor.ops.outlier_capacity(x.numel()) else 1)


@pytest.mark.parametrize("twoeb", [2e-3, 2e-6, 1.0, 3.7e5, 2.0**-60, 2.0**60, 1e-30, 1e30])
def test_lorenzo_quantization_matches_ieee_division(cuda, twoeb):
    """The kernel's division takes a fast path inside 2eb in [2^-60, 2^60]:
    random float bit patterns over every exponent, and values next to the
    rounding ties, against the plain version's IEEE division."""
    g = torch.Generator(device=cuda).manual_seed(7)
    v = torch.randint(-2**31, 2**31, (1 << 22,), generator=g, device=cuda, dtype=torch.int64)
    v = v.to(torch.int32).view(torch.float32)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    ties = (torch.randint(-2**24, 2**24, (1 << 20,), generator=g, device=cuda).float() + 0.5) * \
        torch.tensor(twoeb, dtype=torch.float32, device=cuda)
    inf = torch.full_like(ties, float("inf"))
    x = torch.cat([v, ties, torch.nextafter(ties, inf), torch.nextafter(ties, -inf)])
    codes, idx, vals = lor.lorenzo_encode(x, twoeb, 1)
    pc, po, pfull = plain_lorenzo.lorenzo_encode(x, twoeb, 1)
    pidx = torch.nonzero(po).reshape(-1)
    assert torch.equal(codes, pc) and torch.equal(idx, pidx) and torch.equal(vals, pfull[pidx])


def test_wrappers_check_their_inputs(cuda):
    steps = _steps(3, 16, "cubic", "md")
    with pytest.raises(TypeError):
        interp.compress_blocks(torch.zeros((2, 17, 17, 17), dtype=torch.float64, device=cuda), 0.1, steps)
    with pytest.raises(ValueError):
        interp.compress_blocks(torch.zeros((2, 17, 17, 18), device=cuda), 0.1, steps)
    with pytest.raises(ValueError):
        interp.compress_blocks(torch.zeros((17, 17, 17, 2), device=cuda).permute(3, 0, 1, 2), 0.1, steps)
    with pytest.raises(ValueError):  # the kernels are built for anchor strides 16, 8 and 4
        interp.compress_blocks(torch.zeros((2, 17, 17, 17), device=cuda), 0.1, _steps(3, 2, "cubic", "md"), 2)
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
    with pytest.raises(TypeError):
        bits.bitshuffle(torch.zeros(8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        bits.bitunshuffle(torch.zeros(100, dtype=torch.uint8, device=cuda), 64)
    with pytest.raises(ValueError):  # the kernels take blocks that are a multiple of 32 bytes
        bits.bitshuffle(torch.zeros(100, dtype=torch.uint8, device=cuda), 24)
    with pytest.raises(TypeError):
        lor.lorenzo_encode(torch.zeros((4, 4, 4), dtype=torch.float64, device=cuda), 0.1, 3)
    with pytest.raises(ValueError):
        lor.lorenzo_encode(torch.zeros((4, 4, 8), device=cuda)[..., ::2], 0.1, 3)


def _smooth48():
    gr = np.linspace(0, 4 * np.pi, 48)
    X, Y, Z = np.meshgrid(gr, gr, gr, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.05 * np.cos(3 * X)).astype(np.float32)


def test_card_and_cpu_write_the_same_container(cuda):
    x = _smooth48()
    comp = Compressor()
    reset_launch_counts()
    buf = comp.compress(x)
    y = comp.decompress(buf, out="device")
    counts = launch_counts()
    assert all(counts[k] > 0 for k in ("interp_encode", "interp_decode", "histogram256")), counts
    assert comp.last_telemetry["fallbacks"] == []
    assert y.is_cuda and tuple(y.shape) == x.shape
    assert buf == Compressor(device="cpu").compress(x)
    eb = Compressor.inspect(buf)["eb_abs"]
    assert float(np.abs(Compressor(device="cpu").decompress(buf) - x).max()) <= eb * (1 + 1e-4)
    assert np.array_equal(y.cpu().numpy(), Compressor(device="cpu").decompress(buf))


# kernels each path launches; bit1 never shrinks a stream, so the shared
# format stores it through and no decode reaches the bitunshuffle kernel
PATH_KERNELS = {"cusz_hi_tp": ("interp_encode", "interp_decode", "bitshuffle"),
                "fzgpu_like": ("lorenzo_encode", "bitshuffle"),
                "cusz_l": ("lorenzo_encode", "histogram256")}


@pytest.mark.parametrize("preset", list(PATH_KERNELS))
def test_presets_write_the_same_container_on_card_and_cpu(cuda, preset):
    x = _smooth48()
    x[5, 6, 7] += 10.0  # an outlier
    comp = getattr(T, preset)()
    reset_launch_counts()
    buf = comp.compress(x)
    y = comp.decompress(buf, out="device")
    counts = launch_counts()
    assert all(counts[k] > 0 for k in PATH_KERNELS[preset]), counts
    assert counts["bitunshuffle"] == 0, counts
    assert comp.last_telemetry["fallbacks"] == []
    assert buf == getattr(T, preset)(device="cpu").compress(x)
    eb = Compressor.inspect(buf)["eb_abs"]
    assert float(np.abs(y.cpu().numpy() - x).max()) <= eb * (1 + 1e-4)
    assert np.array_equal(y.cpu().numpy(), Compressor(device="cpu").decompress(buf))


@pytest.mark.parametrize("strides", [(16, 8), (8,), (16, 8, 4)])
def test_planner_on_the_card_equals_the_cpu(cuda, strides):
    """Codes bit-equal and integer histograms: the same plan, candidates and scores."""
    from repro_torch.core import blocks as blk
    from repro_torch.core.autotune import autotune_plan

    x = torch.from_numpy(_smooth48())
    padded = blk.pad_field_batch_t(x[None])
    blocks = blk.gather_blocks_batch_t(padded)
    fshape = (1,) + tuple(padded.shape[1:])
    twoeb = 2e-3 * float(x.max() - x.min())
    reset_launch_counts()
    card = autotune_plan(blocks.to(cuda), twoeb, strides, field_shape=fshape)
    counts = launch_counts()
    assert counts["interp_encode"] == 9 * sum(len(levels_for_stride(s)) for s in strides), counts
    assert counts["histogram256"] > counts["interp_encode"], counts
    cpu = autotune_plan(blocks, twoeb, strides, field_shape=fshape)
    assert card.to_header(include_candidates=True) == cpu.to_header(include_candidates=True)


@pytest.mark.parametrize("kind", ["codes", "random", "runs"])
def test_orchestrator_on_the_card_equals_the_cpu(cuda, kind):
    from repro_torch.core.lossless import orchestrate

    g = torch.Generator().manual_seed(7)
    n = 300_001
    if kind == "random":
        data = torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8)
    elif kind == "runs":
        data = torch.randint(0, 256, (n // 37 + 1,), generator=g, dtype=torch.uint8).repeat_interleave(37)[:n]
    else:
        data = (128 + torch.randn(n, generator=g) * 2).round().clamp(1, 255).to(torch.uint8)
        data[torch.rand(n, generator=g) < 0.001] = 0
    reset_launch_counts()
    card = orchestrate.encode_auto(data.to(cuda))
    assert launch_counts()["histogram256"] > 0
    assert card == orchestrate.encode_auto(data) == orchestrate.encode_auto(data.numpy())


def _nonfinite48():
    x = _smooth48()
    x.reshape(-1)[::97] = np.float32(np.nan)
    x[1, 2, 3], x[4, 5, 6] = np.inf, -np.inf
    return x


MODE_CASES = {
    "cusz_hi_auto": (lambda dev: T.cusz_hi_auto(device=dev), _smooth48),
    "cusz_hi_autoplan": (lambda dev: T.cusz_hi_autoplan(device=dev), _smooth48),
    "cusz_hi_crz": (lambda dev: T.cusz_hi_crz(device=dev), _smooth48),
    "cuszp2_like": (lambda dev: T.cuszp2_like(device=dev), _smooth48),
    "nonfinite": (lambda dev: Compressor(device=dev), _nonfinite48),
    "autoplan_nonfinite": (lambda dev: T.cusz_hi_autoplan(device=dev), _nonfinite48),
}


@pytest.mark.parametrize("mode", list(MODE_CASES))
def test_modes_write_the_same_container_on_card_and_cpu(cuda, mode):
    make, field = MODE_CASES[mode]
    x = field()
    comp = make(None)
    reset_launch_counts()
    buf = comp.compress(x)
    y = comp.decompress(buf, out="device").cpu().numpy()
    if mode != "cuszp2_like":
        assert launch_counts()["interp_encode"] > 0
    assert buf == make("cpu").compress(x)
    fin = np.isfinite(x)
    assert np.array_equal(y.view(np.uint32)[~fin], x.view(np.uint32)[~fin])
    info = Compressor.inspect(buf)
    eb = (info.get("inner") or info)["eb_abs"]
    assert float(np.abs(y[fin] - x[fin]).max()) <= eb * (1 + 1e-4)
    assert np.array_equal(y.view(np.uint32), Compressor(device="cpu").decompress(buf).view(np.uint32))


def test_pw_rel_and_psnr_target_hold_on_the_card(cuda):
    x = _smooth48()
    y = Compressor(T.CompressorSpec(eb_mode="pw_rel", eb=1e-2)).decompress(
        Compressor(T.CompressorSpec(eb_mode="pw_rel", eb=1e-2)).compress(x))
    nz = x != 0
    assert float(np.max(np.abs(y[nz].astype(np.float64) - x[nz]) / np.abs(x[nz]))) <= 1e-2 * (1 + 1e-4)
    comp = Compressor(T.CompressorSpec(psnr_target=60.0))
    y = comp.decompress(comp.compress(x)).astype(np.float64)
    assert 10 * np.log10(float(x.max() - x.min()) ** 2 / np.mean((y - x) ** 2)) >= 60.0


# ------------------------------------------------------ chunked frames (v3)
def _walk(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32).cumsum(0).cumsum(1)


@pytest.mark.parametrize("k", [2, 4])
def test_shard_compress_on_the_card_equals_independent_compresses(cuda, k):
    """Four shards on one card (four threads, a stream each): every frame is
    the card's Compressor.compress of its chunk, the stream is
    chunk_compress's and the CPU's, and the launches are exact."""
    x = torch.from_numpy(_walk((32, 36, 40))).to(cuda)
    reset_launch_counts()
    sb = T.shard_compress(x, [cuda] * k)
    counts = launch_counts()
    assert counts["interp_encode"] == k and counts["histogram256"] == k and counts["interp_decode"] == k
    assert sb == T.chunk_compress(x, n_chunks=k, device=cuda)
    assert sb == T.chunk_compress(x.cpu().numpy(), n_chunks=k, device="cpu")
    _, payloads = tframes.unpack_frames(sb)
    rows = 32 // k
    for i, p in enumerate(payloads):
        assert bytes(p) == Compressor(device=cuda).compress(x[i * rows:(i + 1) * rows])
    seq = Compressor(device=cuda).decompress(sb, out="device")
    par = T.shard_decompress(sb, workers=k, device=cuda, out="device")
    assert par.is_cuda and torch.equal(par, seq)


def test_threads_share_a_compressor_and_plan_cache_on_the_card(cuda, monkeypatch):
    from test_torch_threads import shared_compressor_keeps_each_threads_plan

    shared_compressor_keeps_each_threads_plan(cuda, monkeypatch)
