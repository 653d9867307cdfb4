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


# ------------------------------------------------------------ Huffman (slice 13)
import repro_torch.core.lossless.engine as teng
from repro_torch.core.lossless import huffman as thf
from repro_torch.kernels import huffman as khf
from torch_hf_streams import KINDS as HF_KINDS
from torch_hf_streams import LENGTHS as HF_LENGTHS
from torch_hf_streams import damaged as hf_damaged
from torch_hf_streams import stream as hf_stream


def _hf_codebook(data: np.ndarray):
    counts = np.bincount(data, minlength=256)
    codes, lens, *_ = thf.canonical_codes(thf.code_lengths(counts))
    return lens, codes, counts


@pytest.mark.parametrize("n", HF_LENGTHS)
@pytest.mark.parametrize("kind", HF_KINDS)
def test_hf_kernels_match_plain(cuda, kind, n):
    """Payload and chunk sizes of the encode kernel, sized by the symbol
    counts as the engine calls it, and the decode kernel's symbols, equal
    the plain versions and the host coder (whose bytes the JAX package's
    equal: tests/test_torch_huffman.py) byte for byte; one launch a call."""
    data = hf_stream(kind, n)
    lens, codes, counts = _hf_codebook(data)
    d = torch.from_numpy(data).to(cuda)
    reset_launch_counts()
    payload, cb = khf.hf_encode(d, lens, codes, counts)
    pp, pcb = khf.hf_encode_plain(d, lens, codes)
    assert torch.equal(payload, pp) and np.array_equal(cb, pcb)
    ref, rh = thf.encode(data)
    assert payload.cpu().numpy().tobytes() == ref and dict({"n": n}, **thf.offset_table(cb)) == rh
    out = teng.hf_decode_device(payload, rh)
    assert out.is_cuda and torch.equal(out, d)
    assert launch_counts()["hf_encode"] == 1 and launch_counts()["hf_decode"] == (1 if n else 0)
    assert np.array_equal(teng.hf_decode_device(payload.cpu(), rh).numpy(), data)


def _at_alignment(t: torch.Tensor, align: int) -> torch.Tensor:
    buf = torch.zeros(t.numel() + 32, dtype=t.dtype, device=t.device)
    skip = (align - buf.data_ptr()) % 16
    out = buf[skip:skip + t.numel()]
    out.copy_(t)
    assert out.data_ptr() % 16 == align
    return out


def _hf_decode_inputs(payload: bytes, header: dict, device):
    buf = np.frombuffer(payload, np.uint8)
    n = header["n"]
    nck = max(1, -(-n // 1024))
    _, lens, first_code, sym_table, offsets, counts = thf.canonical_codes(buf[:256].copy())
    maxlen = int(lens.max())
    lut = torch.from_numpy(thf._pair_lut(first_code, counts, sym_table, offsets, maxlen).view(np.int16)).to(device)
    offs = torch.from_numpy(np.frombuffer(header["offs"], "<u4").copy()).to(device)
    return torch.from_numpy(buf[256 + 2 * nck:].copy()).to(device), offs, lut, maxlen


@pytest.mark.parametrize("align", range(16))
def test_hf_decode_kernel_at_every_alignment_of_the_bits(cuda, align):
    """The bits at each start alignment 0-15 of their 16-byte word (the
    kernel loads from the base rounded down), whole and truncated, decode
    as the plain version decodes them."""
    n = 300_001
    data = hf_stream("deep" if align % 2 else "codes", n)
    ref, rh = thf.encode(data)
    bits, offs, lut, maxlen = _hf_decode_inputs(ref, rh, cuda)
    assert torch.equal(khf.hf_decode(_at_alignment(bits, align), offs, lut, maxlen, n).cpu(), torch.from_numpy(data))
    cut = bits[: bits.numel() // 2]
    assert torch.equal(khf.hf_decode(_at_alignment(cut, align), offs, lut, maxlen, n),
                       khf.hf_decode_plain(cut, offs, lut, maxlen, n))


@pytest.mark.parametrize("offset", [1, 3, 7, 13])
def test_hf_encode_kernel_of_a_view_at_an_odd_offset(cuda, offset):
    """x[offset:] (the lanes' loads shifted by the input's misalignment, the
    ragged tail) encodes to the plain version's and the host coder's bytes."""
    data = hf_stream("uniform" if offset == 13 else "codes", 300_001 + offset)
    x = torch.from_numpy(data).to(cuda)[offset:]
    lens, codes, counts = _hf_codebook(data[offset:])
    payload, cb = khf.hf_encode(x, lens, codes, counts)
    pp, pcb = khf.hf_encode_plain(x, lens, codes)
    assert torch.equal(payload, pp) and np.array_equal(cb, pcb)
    assert payload.cpu().numpy().tobytes() == thf.encode(data[offset:])[0]


def test_hf_encode_kernel_raises_on_short_counts(cuda):
    """Counts that do not describe the input size the payload short: the
    kernel writes nothing past it and the wrapper raises."""
    data = hf_stream("codes", 300_001)
    lens, codes, counts = _hf_codebook(data)
    with pytest.raises(ValueError):
        khf.hf_encode(torch.from_numpy(data).to(cuda), lens, codes, counts // 2)
    torch.cuda.synchronize()


def test_hf_decode_kernel_in_four_threads_at_once(cuda):
    """Four threads, each on its own CUDA stream, decode streams of four
    different code lengths at once (as shard_decompress does)."""
    import threading

    jobs = []
    for kind, n in (("one", 300_001), ("uniform", 300_001), ("deep", 20_000), ("codes", 300_001)):
        data = hf_stream(kind, n)
        ref, rh = thf.encode(data)
        jobs.append((torch.from_numpy(data).to(cuda), _hf_decode_inputs(ref, rh, cuda)))
    assert len({inputs[3] for _, inputs in jobs}) == 4
    ok = []

    def run(x, inputs):
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            outs = [khf.hf_decode(*inputs, int(x.numel())) for _ in range(3)]
            torch.cuda.current_stream(cuda).synchronize()
        ok.append(all(torch.equal(o, x) for o in outs))

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert ok == [True] * 4


@pytest.mark.parametrize("how", ["flip", "trunc", "offsets", "offsets-max"])
def test_hf_decode_kernel_equals_plain_on_damaged_streams(cuda, how):
    """Bytes past the stream read as zero, as the plain version's clamp to
    its zero-padded last word gives, so damaged bytes decode to the plain
    version's symbols (pinned on the CPU in tests/test_torch_huffman.py)."""
    n = 300_001
    ref, rh = thf.encode(hf_stream("codes", n))
    if how.startswith("offsets"):  # chunk entry points past the stream's end
        offs = np.frombuffer(rh["offs"], "<u4").astype(np.int64)
        offs[2:] += 1 << 20
        if how == "offsets-max":
            offs[1::2] = 0xFFFFFFFF
        rh = dict(rh, offs=offs.astype("<u4").tobytes())
    else:
        ref = hf_damaged(ref, n, how)
    p = torch.from_numpy(np.frombuffer(ref, np.uint8).copy())
    assert torch.equal(teng.hf_decode_device(p.to(cuda), rh).cpu(), teng.hf_decode_device(p, rh))


def test_hf_engine_launches_its_kernels(cuda):
    """The engine's hf twins run on the kernels: an encode is one histogram256
    and one hf_encode, a decode one hf_decode; an empty stream decodes
    without a launch."""
    d = torch.from_numpy(hf_stream("codes", 5000)).to(cuda)
    reset_launch_counts()
    payload, header = teng.hf_encode_device(d)
    assert {k: launch_counts()[k] for k in ("histogram256", "hf_encode", "hf_decode")} == \
        {"histogram256": 1, "hf_encode": 1, "hf_decode": 0}
    assert torch.equal(teng.hf_decode_device(payload, header), d) and launch_counts()["hf_decode"] == 1
    empty, eh = teng.hf_encode_device(d[:0])
    assert empty.numel() == 258 and teng.hf_decode_device(empty, eh).numel() == 0
    assert launch_counts()["hf_encode"] == 2 and launch_counts()["hf_decode"] == 1


def test_hf_wrappers_check_their_inputs(cuda):
    data = hf_stream("codes", 5000)
    lens, codes, counts = _hf_codebook(data)
    d = torch.from_numpy(data).to(cuda)
    with pytest.raises(ValueError):
        khf.hf_encode(d.int(), lens, codes, counts)
    with pytest.raises(ValueError):
        khf.hf_encode(d[::2], lens, codes, counts)
    with pytest.raises(ValueError):
        khf.hf_encode(d, lens, codes, counts[:255])
    payload, cb = khf.hf_encode(d, lens, codes, counts)
    bits = payload[256 + 2 * cb.size:]
    offs = torch.zeros(cb.size, dtype=torch.uint32, device=cuda)
    lut = torch.zeros(1 << 10, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        khf.hf_decode(bits, offs, lut, 17, 5000)
    with pytest.raises(ValueError):
        khf.hf_decode(bits, offs, lut.int(), 10, 5000)
    with pytest.raises(ValueError):
        khf.hf_decode(bits, offs[:-1], lut, 10, 5000)
    with pytest.raises(ValueError):
        khf.hf_decode(bits, offs.cpu(), lut, 10, 5000)
    with pytest.raises(ValueError):
        khf.hf_decode(bits, offs.to(torch.int64), lut, 10, 5000)


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


# ------------------------------------------------------ the pinned staging ring
import importlib
import os
import threading

from repro_torch.core import staging
from repro_torch.core.compressor import _sections_unpack

RING_SIZES = [0, 1, staging.SMALL, staging.SMALL + 1, staging.CHUNK - 1, staging.CHUNK, staging.CHUNK + 1,
              3 * staging.CHUNK + 17]


@pytest.mark.parametrize("n", RING_SIZES)
def test_staging_ring_uploads_byte_equal(cuda, n):
    """Above ``staging.SMALL`` bytes an upload goes through the ring, at
    most that many by the plain asynchronous copy; both are byte-equal."""
    raw = np.random.default_rng(n).integers(0, 256, n + 5, np.uint8).tobytes()
    tel = {}
    y = staging.upload(memoryview(raw)[5:], cuda, tel)  # a view at an odd offset
    assert y.is_cuda and y.dtype == torch.uint8 and bytes(y.cpu().numpy()) == raw[5:]
    staged = n > staging.SMALL
    assert tel == {"decode": {"staged_bytes": n if staged else 0, "pageable_bytes": 0 if staged else n}}
    f = np.frombuffer(raw, np.float32, count=n // 4, offset=1).reshape(-1, 1)  # typed, unaligned
    z = staging.upload(f, cuda)
    assert z.dtype == torch.float32 and tuple(z.shape) == f.shape and z.cpu().numpy().tobytes() == f.tobytes()


def _ring_fields():
    return [_walk((96, 96, 96), seed) for seed in (1, 2)]


def _jax_decode(buf: bytes) -> np.ndarray:
    """The JAX package's decode of ``buf``, on the host's CPU, never the card."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    R = importlib.import_module("repro.core")
    return np.asarray(R.Compressor().decompress(bytes(buf)))


def _check_ring_decode(y: np.ndarray, x: np.ndarray, ref: np.ndarray, buf: bytes) -> None:
    """A card decode holds the bound of the field and of the JAX package's
    decode (which differs from the port's by float rounding alone)."""
    eb = T.Compressor.inspect(buf)["eb_abs"]
    assert y.shape == x.shape == ref.shape
    assert float(np.abs(y.astype(np.float64) - x).max()) <= eb * (1 + 1e-4)
    assert float(np.abs(y.astype(np.float64) - ref).max()) <= 2 * eb


def test_two_decodes_in_a_row_reuse_the_ring(cuda, monkeypatch):
    """Decodes queued back to back through a ring of two 4 KiB chunks, which
    the code stream's upload wraps many times, hold against the JAX
    package's decodes, and the repeats are bit for bit the first."""
    comp = Compressor()
    xs = _ring_fields()
    bufs = [comp.compress(x) for x in xs]
    refs = [_jax_decode(b) for b in bufs]
    monkeypatch.setattr(staging._local, "ring", staging.Ring(4096, 2))
    ys = [comp.decompress(b, out="device") for b in bufs + bufs]
    ys = [y.cpu().numpy() for y in ys]
    for y, x, ref, b in zip(ys, xs + xs, refs + refs, bufs + bufs):
        _check_ring_decode(y, x, ref, b)
    assert all(np.array_equal(ys[i], ys[i + 2]) for i in range(2))


def test_two_threads_decode_through_one_compressor_at_once(cuda):
    comp = Compressor()
    xs = _ring_fields()
    bufs = [comp.compress(x) for x in xs]
    refs = [_jax_decode(b) for b in bufs]
    start = threading.Barrier(2)
    got, rings, errors = {}, {}, []

    def decode(i):
        try:
            staging._local.ring = staging.Ring(4096, 2)  # the stream's upload wraps it many times
            start.wait(timeout=60)
            ys = [comp.decompress(bufs[i], out="device") for _ in range(4)]
            got[i] = [y.cpu().numpy() for y in ys]
            rings[i] = staging._local.ring
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=decode, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert rings[0] is not rings[1]
    for i in range(2):
        for y in got[i]:
            _check_ring_decode(y, xs[i], refs[i], bufs[i])
        assert all(np.array_equal(y, got[i][0]) for y in got[i])


@pytest.mark.parametrize("pipeline", ["cr", "none"])
def test_card_decode_stages_every_upload(cuda, pipeline):
    """Every upload of a decode above ``staging.SMALL`` bytes (here the
    code stream) is staged, the smaller ones (anchors, outliers) are not."""
    comp = Compressor(pipeline=pipeline)
    buf = comp.compress(_ring_fields()[0])
    held = comp.last_telemetry["decode"]  # verify's decode, added to the compress's record
    comp.decompress(buf, out="device")
    tel = comp.last_telemetry["decode"]
    _, sections = _sections_unpack(buf)
    assert held == {"staged_bytes": tel["staged_bytes"], "pageable_bytes": tel["pageable_bytes"]}
    small = sum(len(s) for s in sections[1:])
    assert len(sections[0]) > staging.SMALL and all(len(s) <= staging.SMALL for s in sections[1:])
    if pipeline == "none":  # the stream but its 5 bytes of LLP2 framing; the anchors and the outliers
        assert tel["staged_bytes"] == len(sections[0]) - 5 and tel["pageable_bytes"] == small
    else:  # the stages' tables and flag bitmaps besides, each where its size puts it
        assert tel["staged_bytes"] > staging.SMALL and tel["pageable_bytes"] >= small


# ------------------------------------------------------ checkpoints and guarantees
@pytest.mark.parametrize("shape", [(9, 1024), (16, 300), (1, 17, 64)])
def test_fields_of_one_block_row_compress_on_the_card(cuda, shape):
    """One block along every dim but the last: the gathered blocks are
    contiguous, and the card writes the CPU's container."""
    x = _walk(shape[-2:]).reshape(shape) if len(shape) == 3 else _walk(shape)
    buf = Compressor().compress(x)
    assert buf == Compressor(device="cpu").compress(x)
    y = Compressor().decompress(buf, out="device")
    assert float((y.cpu() - torch.from_numpy(x)).abs().max()) <= Compressor.inspect(buf)["eb_abs"] * (1 + 1e-4)


def test_checkpoint_on_the_card_equals_the_cpu(cuda, tmp_path):
    from repro_torch import checkpoint as ckpt

    tree = {"w": torch.from_numpy(_walk((48, 256))).to(cuda), "b": torch.arange(9, dtype=torch.int32, device=cuda),
            "h": torch.linspace(-1, 1, 12, device=cuda).to(torch.bfloat16), "lr": 1e-3}
    reset_launch_counts()
    ckpt.save(tree, tmp_path / "card", 1, eb=1e-3)
    assert launch_counts()["interp_encode"] > 0
    ckpt.save(tree, tmp_path / "cpu", 1, eb=1e-3, device="cpu")
    files = [sorted((tmp_path / d / "step_00000001").iterdir()) for d in ("card", "cpu")]
    assert [f.read_bytes() for f in files[0]] == [f.read_bytes() for f in files[1]]
    out, _ = ckpt.restore(tree, tmp_path / "card", 1)
    assert all(out[k].is_cuda for k in ("w", "b", "h")) and torch.equal(out["b"], tree["b"])
    assert out["h"].dtype == torch.bfloat16 and torch.equal(out["h"], tree["h"])


def test_async_snapshot_on_the_card_survives_in_place_update(cuda, tmp_path):
    from repro_torch import checkpoint as ckpt

    tree = {"w": torch.from_numpy(_walk((64, 128))).to(cuda), "s": torch.tensor(3, device=cuda)}
    ref = {k: v.clone() for k, v in tree.items()}
    saver = ckpt.AsyncCheckpointer(tmp_path)
    saver.submit(tree, 1)
    tree["w"].add_(1)
    tree["s"].add_(1)
    saver.close()
    ckpt.save(ref, tmp_path / "sync", 1)
    a = sorted((tmp_path / "step_00000001").iterdir())
    b = sorted((tmp_path / "sync" / "step_00000001").iterdir())
    assert [f.read_bytes() for f in a] == [f.read_bytes() for f in b]


def test_encoder_fault_is_repaired_on_the_card(cuda):
    from repro_torch.core.errors import BoundViolationError
    from repro_torch.testing import perturb_quant_codes

    x = _walk((32, 32, 32))
    comp = Compressor(T.CompressorSpec(eb=1e-3, verify="sample"))
    with perturb_quant_codes(n_calls=1, delta=8, frac=0.02) as stats:
        buf = comp.compress(x)
    assert stats["perturbed"] > 0 and comp.last_telemetry["verify"]["repairs"] >= 1
    y = comp.decompress(buf)
    assert float(np.abs(y - x).max()) <= 1e-3 * float(x.max() - x.min()) * (1 + 2e-4)
    with perturb_quant_codes(n_calls=99, delta=16, frac=0.05):
        with pytest.raises(BoundViolationError):
            comp.compress(x)


def test_compressd_on_the_card_equals_in_process(cuda):
    """The daemon on the card returns the in-process card container and
    decodes it as the card decodes it; its kernels run in its workers."""
    from repro_torch.launch.compressd import CompressdClient, CompressdServer

    x = _walk((48, 48, 48))
    with CompressdServer("127.0.0.1:0", workers=2).start() as srv:
        assert srv.device.type == "cuda"
        reset_launch_counts()
        with CompressdClient(srv.address, timeout=60) as c:
            buf = c.compress(torch.from_numpy(x).to(cuda))
            assert c.last_info["fallbacks"] == 0
            y = c.decompress(buf)
        launches = launch_counts()
    assert launches["interp_encode"] > 0 and launches["interp_decode"] > 0
    comp = Compressor()
    assert buf == comp.compress(x)
    assert np.array_equal(y, comp.decompress(buf))


def test_gradient_packer_card_bytes_equal_host_bytes(cuda):
    from repro_torch.optim import pack_quantized, pack_quantized_sharded, quantize_shard, unpack_quantized_sharded

    g = torch.from_numpy(np.random.default_rng(5).laplace(0, 1e-3, (256, 384)).astype(np.float32))
    q_host, s_host = quantize_shard(g)
    q_card, s_card = quantize_shard(g.to(cuda))
    assert torch.equal(q_card.cpu(), q_host) and float(s_card) == float(s_host)
    for pipe in ("auto", "tp", "none", "cr"):
        assert pack_quantized(q_card, s_card, pipe) == pack_quantized(q_host.numpy(), s_host, pipe)
    shards = [((slice(i * 64, (i + 1) * 64), slice(None)), q_card[i * 64:(i + 1) * 64]) for i in range(4)]
    buf = pack_quantized_sharded(shards, s_card)
    assert buf == pack_quantized_sharded([(ix, t.cpu()) for ix, t in shards], s_host)
    assert np.array_equal(unpack_quantized_sharded(buf)[0], q_host.numpy())


SERVE_ARCHS = ["codeqwen1.5-7b", "deepseek-moe-16b", "gemma3-12b", "granite-34b", "internvl2-1b", "mamba2-370m",
               "olmoe-1b-7b", "recurrentgemma-2b", "whisper-small", "yi-34b"]


def _serve_on(device, cfg, params, batch, steps: int):
    """Prefill logits and ``steps`` greedy decode logits, as host arrays."""
    from repro_torch.models import decode_step, prefill

    params = _to(params, device)
    batch = _to(batch, device)
    S = batch["tokens"].shape[1] + (cfg.n_img_tokens if "img" in batch else 0)
    logits, cache = prefill(params, cfg, batch, cache_len=S + steps)
    out = [logits.float().cpu().numpy()]
    tok = logits.argmax(-1)
    for i in range(steps):
        logits, cache = decode_step(params, cfg, tok, S + i, cache)
        out.append(logits.float().cpu().numpy())
        tok = logits.argmax(-1)
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_scaled_architectures_serve_on_the_card_as_on_the_cpu(cuda, arch):
    """The port's own weights drawn on the CPU and moved to the card:
    prefill logits and 4 greedy decode steps within the reference's own
    tolerances (0.05; 0.15 for the ssm and hybrid families), since the
    card sums bf16 products in another order than the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(arch)
    cfg = cfg.scaled(capacity_factor=100.0) if cfg.n_experts else cfg.scaled()
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
    if cfg.stub_frontend == "vit":
        batch["img"] = torch.randn((2, cfg.n_img_tokens, cfg.d_model), generator=g).to(torch.bfloat16)
    if cfg.enc_layers:
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g).to(torch.bfloat16)
    tol = 0.15 if ("ssm" in cfg.pattern or "rglru" in cfg.pattern) else 0.05
    card, host = _serve_on(cuda, cfg, params, batch, 4), _serve_on("cpu", cfg, params, batch, 4)
    for step, (a, b) in enumerate(zip(card, host)):
        assert np.isfinite(a).all() and float(np.abs(a - b).max()) < tol, step


def test_kv_roundtrip_on_the_card_writes_the_cpu_frames(cuda, monkeypatch):
    """One scaled gemma3 prefill cache paged on the card and on the CPU:
    the same stream byte for byte, the same restored leaves, and the
    interp and histogram kernels launched."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params, prefill

    streams = []

    class Writer(serve.FrameWriter):  # keeps the file each stream went to
        def __init__(self, f, *args, **kwargs):
            streams.append(f)
            super().__init__(f, *args, **kwargs)

    monkeypatch.setattr(serve, "FrameWriter", Writer)
    cfg = get_config("gemma3-12b").scaled()
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    _, cache = prefill(params, cfg, {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=g)}, cache_len=64)
    host, hs = serve._kv_roundtrip(cache, serve.DEFAULT_KV_SPEC)
    reset_launch_counts()
    card, cs = serve._kv_roundtrip(_to(cache, cuda), serve.DEFAULT_KV_SPEC)
    launches = launch_counts()
    assert all(launches[k] > 0 for k in ("interp_encode", "interp_decode", "histogram256")), launches
    assert len(streams) == 2 and streams[1].getvalue() == streams[0].getvalue()
    assert cs == hs
    for a, b in zip(card["stack"], host["stack"]):
        for k in a:
            assert a[k].is_cuda and torch.equal(a[k].cpu(), b[k])


# ------------------------------------------------------------ training (slice 10)
TRAIN_LIMITS = (0.02, 0.05, 0.1)  # |loss diff|, grad norm relative, worst leaf of AdamW m (0.1 x the gradient), relative


def _train_step_both(cuda, arch, npods=0):
    """One train step of ``arch`` at .scaled() on the card and on the CPU
    from the same state and batch."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.runtime.steps import make_train_state, make_train_step

    cfg = get_config(arch).scaled()
    state = make_train_state(cfg, torch.Generator().manual_seed(0), npods=npods, device="cpu")
    extras = {}
    if cfg.stub_frontend == "vit":
        extras["img"] = (cfg.n_img_tokens, cfg.d_model)
    if cfg.enc_layers:
        extras["frames"] = (cfg.enc_seq, cfg.d_model)
    batch = next(TokenPipeline(cfg.vocab, 4, 32, extras=extras))
    mesh = types.SimpleNamespace(shape={"pod": npods}) if npods else None
    step = make_train_step(cfg, mesh, lr=1e-3, compress_pods=bool(npods))
    card = step(tree_map(lambda t: t.to(cuda), state), batch)
    return card, step(state, batch)


def _check_train_step(card, host):
    from repro_torch.core.tree import leaf_paths

    (cs, cm), (hs, hm) = card, host
    assert all(t.is_cuda for _, t in leaf_paths(cs))
    assert np.isfinite(float(cm["loss"])) and abs(float(cm["loss"]) - float(hm["loss"])) < TRAIN_LIMITS[0]
    assert abs(float(cm["grad_norm"]) - float(hm["grad_norm"])) < TRAIN_LIMITS[1] * float(hm["grad_norm"])
    for (n, a), (_, b) in zip(leaf_paths(cs.opt.m), leaf_paths(hs.opt.m)):
        nb = float(b.double().norm())
        d = float((a.cpu().double() - b.double()).norm())
        assert (d / nb if nb > 0 else d) < TRAIN_LIMITS[2], n


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_scaled_architectures_train_on_the_card_as_on_the_cpu(cuda, arch):
    """One plain train step (loss, autograd, clip, AdamW) card vs CPU: the
    loss, the grad norm and AdamW's m (0.1 x the clipped gradient after the
    first step); bf16 products sum in another order on the card."""
    _check_train_step(*_train_step_both(cuda, arch))


def test_compressed_pod_step_on_the_card_as_on_the_cpu(cuda):
    card, host = _train_step_both(cuda, "mamba2-370m", npods=2)
    _check_train_step(card, host)
    from repro_torch.core.tree import leaf_paths

    assert all(float(r.abs().max()) > 0 for _, r in leaf_paths(card[0].resid) if r.numel() > 1)


def test_pod_exchange_payloads_on_the_card_equal_the_cpu(cuda):
    from repro_torch.runtime.steps import pod_exchange

    g = torch.Generator().manual_seed(3)
    grads, resid = torch.randn((2, 300, 17), generator=g), 1e-3 * torch.randn((2, 300, 17), generator=g)
    ca, cr, cq, cs = pod_exchange(grads.to(cuda), resid.to(cuda))
    ha, hr, hq, hs = pod_exchange(grads, resid)
    assert torch.equal(cq.cpu(), hq) and torch.equal(cs.cpu(), hs)
    assert torch.allclose(ca.cpu(), ha, rtol=1e-6, atol=1e-7) and torch.allclose(cr.cpu(), hr, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("policy", ["nothing", "dots", "mixer"])
def test_remat_on_the_card_keeps_the_loss(cuda, policy):
    """Remat recomputes the same kernels, so the loss is bit-equal; the
    gradients agree to the card's atomics (index_add_ and the embedding's
    backward add in no fixed order)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaf_paths
    from repro_torch.models import init_params, loss_fn

    cfg = get_config("olmoe-1b-7b").scaled()
    g = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, g, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=g, device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for c in (dataclasses.replace(cfg, remat=False), dataclasses.replace(cfg, remat=True, remat_policy=policy)):
        leaves = [t.detach().requires_grad_() for _, t in leaf_paths(params)]
        it = iter(leaves)
        from repro_torch.core.tree import tree_map

        loss = loss_fn(tree_map(lambda _: next(it), params), c, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-6)


def test_adamw_on_the_card_matches_the_cpu(cuda):
    from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_with_warmup, init_opt

    g = torch.Generator().manual_seed(1)
    p = {"a": torch.randn((64, 33), generator=g), "b": torch.randn(100, generator=g)}
    hp, cp = p, _to(p, cuda)
    ho, co = init_opt(hp), init_opt(cp)
    for _ in range(3):
        grads = {"a": torch.randn((64, 33), generator=g), "b": torch.randn(100, generator=g)}
        hg, hn = clip_by_global_norm(grads, 1.0)
        cg, cn = clip_by_global_norm(_to(grads, cuda), 1.0)
        assert torch.allclose(cn.cpu(), hn, rtol=1e-6)
        hp, ho = adamw_update(hp, hg, ho, 1e-3)
        cp, co = adamw_update(cp, cg, co, 1e-3)
        for k in p:
            assert torch.allclose(cp[k].cpu(), hp[k], rtol=1e-6, atol=1e-9)
    assert int(co.step) == 3 and co.step.is_cuda
    assert torch.allclose(cosine_with_warmup(torch.tensor(150, device=cuda)).cpu(), cosine_with_warmup(150))


def test_trainer_and_cli_train_on_the_card(cuda, tmp_path):
    """The train CLI at its default device: the loss falls over 30 steps of
    mamba2-370m at .scaled(), a second run resumes from its checkpoint."""
    from repro_torch.core.tree import leaf_paths
    from repro_torch.launch import train

    args = ["--scaled", "--arch", "mamba2-370m", "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path)]
    first = train.run(args + ["--steps", "30", "--save-every", "10"])
    assert all(t.is_cuda for _, t in leaf_paths(first["trainer"].state))
    assert np.mean(first["losses"][-5:]) < np.mean(first["losses"][:5]) - 0.3
    again = train.run(args + ["--steps", "32"])
    assert again["start_step"] == 30 and again["steps"] == 32 and np.isfinite(again["losses"]).all()


def test_train_state_specs_place_nothing(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import state_specs

    st = state_specs(get_config("whisper-small"))
    assert st.params["embed"].device.type == "meta" and torch.cuda.memory_allocated() >= 0


# ------------------------------------------------------------ the device mesh
MESH_TWIN = """
import dataclasses
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core.tree import leaf_paths, tree_map
from repro_torch.models.layers import init_moe, moe_ffn
from repro_torch.runtime import partitioning as part
from repro_torch.runtime.partitioning import NamedSharding, P
from repro_torch.runtime.sharding_rules import activation_rules, place
from repro_torch.runtime.steps import make_train_state, make_train_step, state_shardings

dev = torch.device("cuda", torch.cuda.current_device())
mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
out = {"backend": dist.get_backend()}
batch = pickle.load(open(ARGS[0], "rb"))
for name, arch, ep in (("olmoe", "olmoe-1b-7b", False), ("olmoe_ep", "olmoe-1b-7b", True), ("mamba2", "mamba2-370m", False)):
    cfg = dataclasses.replace(get_config(arch).scaled(), moe_expert_parallel=ep)
    res = {}
    for kind, m in (("plain", None), ("mesh", mesh)):
        st = make_train_state(cfg, torch.Generator(device=dev).manual_seed(1), device=dev, mesh=m)
        new, met = make_train_step(cfg, m, grad_clip=1e30)(st, batch[arch])
        res[kind] = (float(met["loss"]), float(met["grad_norm"]),
                     [(t.full_tensor() if m is not None else t).cpu().numpy() for _, t in leaf_paths(new.opt.m)])
        if m is not None:
            res["kept"] = all(tuple(a.placements) == tuple(b.placements) for (_, a), (_, b) in zip(leaf_paths(new), leaf_paths(st)))
    out[name] = res
cfg = get_config("deepseek-moe-16b").scaled()
p = init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
x = torch.randn(4, 8, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
y1, aux1 = moe_ffn(x, p, cfg)
with part.mesh_rules(mesh, activation_rules(cfg, mesh)), implicit_replication():
    pd = place(p, tree_map(lambda _: NamedSharding(mesh, P()), p))
    y, aux = moe_ffn(place(x, NamedSharding(mesh, P("data", None, None))), pd, cfg)
out["moe"] = (float((y.full_tensor() - y1).abs().max()), float(aux.full_tensor()), float(aux1))
cfg = get_config("gemma3-12b").scaled()
st = make_train_state(cfg, torch.Generator(device=dev).manual_seed(2), device=dev)
ckpt.save(st, os.path.join(OUT, "plain"), 1)
tmpl = make_train_state(cfg, device="meta")
placed, _ = ckpt.restore(tmpl, os.path.join(OUT, "plain"), shardings=state_shardings(tmpl, cfg, mesh))
out["restore_equal"] = all(type(b).__name__ == "DTensor" and torch.equal(a, b.to_local()) for (_, a), (_, b) in zip(leaf_paths(st), leaf_paths(placed)))
ckpt.save(placed, os.path.join(OUT, "placed"), 1)
finish(out)
"""


@pytest.fixture(scope="module")
def mesh_twin(tmp_path_factory):
    """One rank of an NCCL process group on the card, in a subprocess (the
    pytest process keeps no process group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    import pickle

    import torch_mesh_ranks as ranks
    from repro_torch.configs import get_config

    tmp = tmp_path_factory.mktemp("mesh_twin")
    batches = {a: ranks.step_batch(get_config(a).scaled()) for a in ("olmoe-1b-7b", "mamba2-370m")}
    with open(tmp / "batch.pkl", "wb") as f:
        pickle.dump(batches, f)
    return tmp, ranks.run_ranks(MESH_TWIN, 1, tmp, args=[tmp / "batch.pkl"], device="cuda", timeout=120)[0]


@pytest.mark.parametrize("name", ["olmoe", "olmoe_ep", "mamba2"])
def test_the_mesh_step_on_a_one_rank_nccl_mesh_matches_the_plain_step(mesh_twin, name):
    import torch_mesh_ranks as ranks

    _, out = mesh_twin
    assert out["backend"] == "nccl"
    (lp, gp, mp), (lm, gm, mm) = out[name]["plain"], out[name]["mesh"]
    assert abs(lp - lm) < 5e-4 and abs(gp - gm) / gp < 3e-3 and max(ranks.rel_errors(mm, mp)) < 6e-2
    assert out[name]["kept"]


def test_moe_ffn_on_a_one_rank_nccl_mesh_matches_one_device(mesh_twin):
    dy, aux, aux1 = mesh_twin[1]["moe"]
    assert dy < 1e-5 and abs(aux - aux1) < 1e-6


def test_restore_onto_a_one_rank_nccl_mesh_and_its_placed_save(mesh_twin):
    tmp, out = mesh_twin
    assert out["restore_equal"]
    plain, placed = tmp / "plain" / "step_00000001", tmp / "placed" / "step_00000001"
    names = sorted(p.name for p in plain.glob("*.bin"))
    assert names and names == sorted(p.name for p in placed.glob("*.bin"))
    assert all((plain / n).read_bytes() == (placed / n).read_bytes() for n in names)
