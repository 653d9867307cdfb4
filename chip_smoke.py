#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and check it.

    PYTHONPATH=src python3 chip_smoke.py [--seed 0] [--side 512] [--out results.json]

Phases, in order; any failure exits non-zero:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     all started together);
  3. every kernel against its plain torch version on the card: interp encode
     and decode bit for bit (torch.equal, and decode == the encoder's recon)
     over rank 1-3 x anchor stride 16/8/4 x spline x scheme on random, smooth
     and outlier-heavy blocks, at block counts 1, 131, 133, 4096 and 4097;
     every kernel's registers, shared memory and spills are printed from
     the ptxas report in phase 2; histogram256 against torch.bincount at
     ragged lengths up to 512^3 and every head offset 0-15, on one byte
     value everywhere (0, 128, 255), uniform and 90 % center-code streams;
     bitshuffle and bitunshuffle (exact, and against the host bit1 stage)
     at ragged lengths up to 512^3; the Lorenzo encode (exact) on 1-D, 2-D,
     3-D and batched fields around its tile's edges (Z in {1, 31, 33, 127,
     129, 257, 513}, Y in {1, 7, 9}, X == 1, a 700-plane march) with forced
     outliers and int32 saturation, an all-outlier and a one-outlier field,
     and its quantization against IEEE division on random float bit
     patterns and values next to rounding ties;
     then the planner (predictor="auto") on the card and on the CPU over the
     same sampled blocks of the 512^3 field below: the same PredictorPlan,
     candidate labels and scores (so the same trial bytes);
  4. five paths at full size on one Nyx-like lognormal 512^3 float32 field
     made on the card from --seed: the main path (the default spec: interp,
     autotune, pipeline cr), then the presets cusz_hi_tp (pipeline tp),
     fzgpu_like (Lorenzo + fz), cusz_l (Lorenzo + hf) and cusz_hi_autoplan
     (the planner and the orchestrator); each compress() then
     decompress(out="device"), with launch counts reset just before and
     read just after, and each path's kernels checked as launched; then the
     orchestrator's choice on the main path's code stream, on the card and
     on the CPU: the same record;
  5. for the same five, the card's container against the port's CPU path
     on a 96^3 field (the Lorenzo containers byte-equal); then byte-equal
     containers for cusz_hi_auto, cusz_hi_autoplan, cusz_hi_crz, cuszp2_like
     and a field with NaN/+-Inf, and pw_rel and psnr_target holding their
     bound and target (their byte equality reported);
  6. per-kernel times at the paths' shapes (CUDA events) beside the plain
     version, the byte/operation bound and, for the histogram,
     torch.bincount as a library yardstick; the histogram also on a uniform
     random stream of the main path's length;
  7. where the time goes: one more compress + decompress of the field on
     each path under torch.profiler, by tracing span (host wall and device
     time) and by device kernel, with the device's idle share; the
     cusz_hi_autoplan path twice more with a plan cache, a miss then a hit;
     and the field as a v3 stream of 4 chunks (chunk_compress + decompress);
  8. frames v3 and the data layer on the same field (default spec): the
     4-chunk chunk_compress with its launch counts, each frame byte-equal to
     Compressor().compress of its chunk, the decode within each chunk's
     bound, frames=[2, 0]; shard_compress over [cuda:0] * 4 (four threads,
     four streams) byte-equal to it; shard_decompress with 4 workers sharing
     one Compressor bit-equal to the sequential decode; a bit flip, a
     truncation and a torn tail, on plain and sync-marked streams, salvaged
     under on_error="skip" and "fill"; the golden v3 fixtures decoded on the
     card (equal to the CPU decode); two threads sharing one Compressor and
     plan cache keeping their own plans; and repro_torch.io writing and
     reading a two-variable dataset.
Prints one JSON line of kernels, then, as the last line,
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints no result.

The bitunshuffle kernel is held against its plain version and timed, but
no path launches it: bit1 never shrinks a stream, so the LLP2 format (the
JAX package's) stores the stage through and no decode reaches its inverse.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
SLACK = 1e-4               # repo-wide f32 bound slack
MIN_AGREE = 0.9999         # code agreement, kernel vs plain

# the paths of phase 4: preset (None: the default spec) and the kernels its
# compress + decompress must launch
PATHS = {
    "main": (None, ("interp_encode", "interp_decode", "histogram256")),
    "cusz_hi_tp": ("cusz_hi_tp", ("interp_encode", "interp_decode", "bitshuffle")),
    "fzgpu_like": ("fzgpu_like", ("lorenzo_encode", "bitshuffle")),
    "cusz_l": ("cusz_l", ("lorenzo_encode", "histogram256")),
    # the planner's trials launch interp_encode and histogram256, the orchestrator's tp/fz/fzh trials bitshuffle
    "cusz_hi_autoplan": ("cusz_hi_autoplan", ("interp_encode", "interp_decode", "histogram256", "bitshuffle")),
}
# phase 5: presets and fields whose card container must equal the CPU path's byte for byte
BYTE_EQUAL_96 = ("cusz_hi_auto", "cusz_hi_autoplan", "cusz_hi_crz", "cuszp2_like", "nonfinite")
# phase 8: the field as a v3 stream of this many chunks, and the launches one
# chunk_compress + decompress of it makes under the default spec: per chunk the
# main path's 1 encode, 1 hf histogram and 2 decodes (verify's and the decode's)
V3_CHUNKS = 4
V3_LAUNCHES = {"interp_encode": 4, "interp_decode": 8, "histogram256": 4, "bitshuffle": 0, "bitunshuffle": 0,
               "lorenzo_encode": 0}
GOLDEN_V3 = ("golden_v3", "golden_v3_bitflip", "golden_v3_trunc", "golden_v3_torn")


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def nyx_like(side: int, seed: int, device):
    """Lognormal spectral field, the 'nyx' recipe of the synthetic datasets:
    white noise filtered by |k|^-2, normalized to [-1, 1], then exp(2 f)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    white = torch.randn((side,) * 3, generator=g, device=device, dtype=torch.float32)
    spec = torch.fft.rfftn(white)
    del white
    k = torch.fft.fftfreq(side, device=device)
    kz = torch.fft.rfftfreq(side, device=device)
    k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + kz[None, None, :] ** 2
    filt = (k2 + 1e-6) ** (-2.0 / 2.0)
    filt[0, 0, 0] = 0.0
    out = torch.fft.irfftn(spec * filt, s=(side,) * 3)
    del spec, filt, k2
    out /= out.abs().max().clamp(min=1e-12)
    return torch.exp(2.0 * out).contiguous()


def smooth_big(side: int = 96):
    """The 96^3 smooth test field (sin/cos plus a Gaussian bump), numpy."""
    import numpy as np

    gr = np.linspace(0, 4 * np.pi, side)
    X, Y, Z = np.meshgrid(gr, gr, gr, indexing="ij")
    return (np.sin(X) * np.cos(Y) * np.sin(Z) + 0.3 * np.exp(-((X - 6) ** 2 + (Y - 6) ** 2) / 8)).astype(np.float32)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs after one warm-up (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, key: str, iters: int) -> float:
    """Device time per call of ``fn`` of the kernels whose names hold ``key``,
    over ``iters`` calls, from torch.profiler: the kernels alone, without
    the wrapper's host work or its other launches (memsets, copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    t = [e.time_range.elapsed_us() / 1e3 for e in prof.events() if e.device_type == DeviceType.CUDA and key in e.name]
    check(len(t) >= iters, f"the profiler saw {len(t)} launches of {key} in {iters} calls")
    return sum(t) / iters


INTERP_SPLINES = ("linear", "cubic", "natural-cubic")
HIST_STREAMS = ("const0", "const128", "const255", "uniform", "center90")


def hist_stream(kind: str, n: int, g):
    """n bytes on the card: one value everywhere (constN), uniform, or 90 %
    the center code 128 (the compressor's code streams)."""
    import torch

    if kind.startswith("const"):
        return torch.full((n,), int(kind[5:]), dtype=torch.uint8, device=g.device)
    d = torch.randint(0, 256, (n,), generator=g, device=g.device, dtype=torch.uint8)
    if kind == "center90":
        d[torch.rand(n, generator=g, device=g.device) < 0.9] = 128
    return d


def interp_cases() -> list[tuple]:
    """(ndim, kind, nb, stride, spline, scheme) of phase 3: every rank and
    anchor stride the kernels are built for, the block counts that leave
    a ragged tail for the persistent loop (1, 131, 133, 4097), and blocks
    with a slab of outliers in every third block."""
    cases = []
    for kind in ("random", "smooth", "outliers"):
        for stride in (16, 8, 4):
            for spline in INTERP_SPLINES:
                for scheme in ("md", "1d", "1d-210"):
                    cases.append((3, kind, 4096, stride, spline, scheme))
    for nd, schemes in ((2, ("md", "1d-10")), (1, ("md",))):
        for kind in ("random", "outliers"):
            for stride in (16, 8, 4):
                for spline in INTERP_SPLINES:
                    for scheme in schemes:
                        cases.append((nd, kind, 4097, stride, spline, scheme))
    for nd in (1, 2, 3):
        for nb in (1, 131, 133, 4097):
            cases.append((nd, "outliers", nb, 16, "cubic", "md"))
    return cases


def lorenzo_shapes() -> list[tuple]:
    """(shape, spatial dims) of phase 3's Lorenzo fields: every Z in {1, 31,
    33, 127, 129, 257, 513} (around the 4-point lane groups and the 256-point
    warp) with every Y in {1, 7, 9} (around the 8-row tile), X == 1, a long
    march, batched fields, 1-D and 2-D, beside the shapes of earlier checks."""
    shapes = [((1_000_003,), 1), ((37, 45), 2), ((1000, 999), 2), ((33, 35, 70), 3), ((129, 257, 100), 3),
              ((3, 9, 31, 40), 3), ((4, 6, 65, 63), 2), ((7, 3001), 1), ((1, 1, 1), 3)]
    shapes += [((5, y, z), 3) for y in (1, 7, 9) for z in (1, 31, 33, 127, 129, 257, 513)]
    shapes += [((1, 9, 129), 3), ((1, 7, 513), 3), ((700, 9, 33), 3), ((3, 40, 9, 129), 3), ((4, 33, 70), 2),
               ((2, 3, 600), 1)]
    return shapes


def lorenzo_case_field(kind: str, shape, device):
    """Every point an outlier (a checkerboard of +-500 at 2eb 0.02), or only
    the last one (a spike there)."""
    import torch

    if kind == "all-outliers":
        ix = torch.stack(torch.meshgrid(*[torch.arange(s, device=device) for s in shape], indexing="ij")).sum(0)
        return (ix % 2).float() * 1000.0 - 500.0
    x = torch.zeros(shape, device=device)
    x.view(-1)[-1] = 50.0
    return x


# bounds of the quantization check: inside the kernel's fast division range
# [2^-60, 2^60], at its ends and outside it
QUANT_BOUNDS = (2e-3, 2e-6, 1.0, 3.7e5, 2.0**-60, 2.0**60, 1e-30, 1e30)


def quantization_field(twoeb: float, g):
    """A 1-D f32 field for the quantization x / 2eb: 2^24 random bit patterns
    (every exponent, NaN replaced by 0), then 2^22 values (k + 1/2) * 2eb
    next to a rounding tie and each of their two neighbours."""
    import torch

    dev = g.device
    bits = torch.randint(-2**31, 2**31, (1 << 24,), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    v = bits.view(torch.float32)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    k = torch.randint(-2**24, 2**24, (1 << 22,), generator=g, device=dev).float()
    ties = (k + 0.5) * torch.tensor(twoeb, dtype=torch.float32, device=dev)
    inf = torch.full_like(ties, float("inf"))
    return torch.cat([v, ties, torch.nextafter(ties, inf), torch.nextafter(ties, -inf)]).contiguous()


def phase_kernels(device, seed: int) -> None:
    import torch

    from repro_torch.core import predictor as plain
    from repro_torch.core.autotune import levels_for_stride
    from repro_torch.core.stencils import build_steps
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import interp3d as interp

    g = torch.Generator(device=device).manual_seed(seed + 1)

    def blocks_of(kind: str, nb: int, nd: int):
        shape = (nb,) + (17,) * nd
        if kind == "random":
            return torch.randn(shape, generator=g, device=device), 1e-2
        if kind == "outliers":  # |q| > 127 on a slab of every third block
            f = torch.randn(shape, generator=g, device=device).cumsum(1)
            f[::3, 3] += 100.0
            # the compressor's default bound, 1e-3 of the range: an absolute 1e-2 on
            # values near 100 is below what float32 reconstructs within 1e-4 of eb
            return f, 1e-3 * float(f.max() - f.min())
        c = torch.linspace(0, 1, 17, device=device)
        ph = torch.rand((nb, nd), generator=g, device=device) * 6.0
        f = torch.zeros(shape, device=device)
        for d in range(nd):
            view = [nb] + [1] * nd
            view[d + 1] = 17
            f = f + torch.sin((3 + d) * c.view(view[1:])[None] + ph[:, d].view([nb] + [1] * nd))
        return f.contiguous(), 1e-3 * float(f.max() - f.min())

    worst_ratio, n_outliers = 0.0, 0
    cases = interp_cases()
    for nd, kind, nb, stride, spline, scheme in cases:
        blocks, eb = blocks_of(kind, nb, nd)
        L = len(levels_for_stride(stride))
        steps = build_steps(nd, 17, levels_for_stride(stride), (spline,) * L, (scheme,) * L)
        ck, rk = interp.compress_blocks(blocks, 2 * eb, steps, stride)
        cp, rp = plain.compress_blocks(blocks, 2 * eb, steps, stride)
        c_only, no_recon = interp.compress_blocks(blocks, 2 * eb, steps, stride, with_recon=False)
        torch.cuda.synchronize()
        label = f"{nd}-D {kind} nb={nb} stride={stride} {spline}/{scheme}"
        check(torch.equal(ck, cp) and torch.equal(rk, rp), f"interp encode != plain ({label})")
        check(no_recon is None and torch.equal(c_only, ck), f"interp encode without recon: other codes ({label})")
        ok = ck == 0
        err = (rk - blocks).abs()[~ok]
        ratio = float(err.max()) / eb if err.numel() else 0.0
        check(ratio <= 1 + SLACK, f"interp encode bound: max err/eb {ratio:.6f} ({label})")
        dec_in = plain.decode_inputs(blocks, ck, stride)
        check(kind != "outliers" or dec_in[1].numel() > 0, f"no outliers in an outlier case ({label})")
        dk = interp.decompress_blocks(ck, *dec_in, 2 * eb, steps, stride)
        check(torch.equal(dk, rk), f"interp decode does not reproduce the encoder's recon bit for bit ({label})")
        check(torch.equal(plain.decompress_blocks(ck, *dec_in, 2 * eb, steps, stride), dk),
              f"interp decode != plain decode ({label})")
        worst_ratio, n_outliers = max(worst_ratio, ratio), n_outliers + int(dec_in[1].numel())
    say(f"interp encode/decode == plain bit for bit in {len(cases)} cases (ndim 1-3, strides 16/8/4, "
        f"nb 1..4097, {n_outliers} outliers in all), worst err/eb {worst_ratio:.6f}, "
        f"decode == encoder recon in every case")
    sizes = (0, 1, 15, 16, 17, 8191, 8193, 10**6 + 3, 512**3)
    for kind in HIST_STREAMS:
        base = hist_stream(kind, max(sizes) + 15, g)
        for n in sizes:
            for off in range(16):  # every head offset of the 16-B vectors
                x = base[off : off + n]
                check(torch.equal(hist.histogram256(x), torch.bincount(x, minlength=256)),
                      f"histogram256 != bincount (n={n}, offset={off}, stream {kind})")
        del base
    say(f"histogram256 == torch.bincount for n in {sizes} at offsets 0-15, streams {', '.join(HIST_STREAMS)}")
    phase_bits_lorenzo(device, g)


def phase_bits_lorenzo(device, g) -> None:
    import torch

    from repro_torch.core import lorenzo as plain_lorenzo
    from repro_torch.core.lossless import bitshuffle as host_bit
    from repro_torch.kernels import bitshuffle as bits
    from repro_torch.kernels import lorenzo3d as lor

    sizes = (0, 1, 8191, 8192, 8193, 10**6 + 3, 512**3)
    for n in sizes:
        d = torch.randint(0, 256, (n + 3,), generator=g, device=device, dtype=torch.uint8)
        for off in (0, 3):  # 3: an unaligned input, which the wrapper copies
            x = d[off : off + n]
            planes = bits.bitshuffle(x)
            check(torch.equal(planes, bits.bitshuffle_plain(x)), f"bitshuffle != plain (n={n}, offset={off})")
            back = bits.bitunshuffle(planes)
            check(torch.equal(back, bits.bitunshuffle_plain(planes)), f"bitunshuffle != plain (n={n}, offset={off})")
            check(torch.equal(back[:n], x), f"bitunshuffle(bitshuffle(x)) != x (n={n}, offset={off})")
        host = host_bit.bitshuffle_encode(x.cpu().numpy())[0]
        check(planes.cpu().numpy().tobytes() == host, f"bitshuffle != the host bit1 stage (n={n})")
    for block in (1024, 32):  # blocks other than the format's 8192
        x = d[: 5 * block - 3]
        planes = bits.bitshuffle(x, block)
        check(torch.equal(planes, bits.bitshuffle_plain(x, block)) and
              torch.equal(bits.bitunshuffle(planes, block), bits.bitunshuffle_plain(planes, block)),
              f"bitshuffle kernels != plain at block {block}")
    say(f"bitshuffle / bitunshuffle == plain and == the host bit1 stage for n in {sizes}, aligned and unaligned")

    def lorenzo_check(x, twoeb, nd, label):
        codes, idx, vals = lor.lorenzo_encode(x, twoeb, nd)
        pc, po, pfull = plain_lorenzo.lorenzo_encode(x, twoeb, nd)
        pidx = torch.nonzero(po.reshape(-1)).reshape(-1)
        check(torch.equal(codes, pc) and torch.equal(idx, pidx) and torch.equal(vals, pfull.reshape(-1)[pidx]),
              f"lorenzo encode != plain ({label})")
        return int(idx.numel())

    shapes = lorenzo_shapes()
    n_out = 0
    for shape, nd in shapes:
        for twoeb, scale in ((0.02, 1.0), (2e-6, 1e4)):  # 2e-6 on |x| ~ 1e4: x / 2eb passes 2^31
            x = torch.randn(shape, generator=g, device=device).cumsum(-1) * scale
            x.view(-1)[:: 101] += 500.0 * scale  # forced outliers
            n_out += lorenzo_check(x, twoeb, nd, f"shape {shape}, ndim {nd}, 2eb {twoeb}")
    for kind, expect in (("all-outliers", 100 * 100 * 260), ("one-outlier", 1)):
        got = lorenzo_check(lorenzo_case_field(kind, (100, 100, 260), device), 0.02, 3, kind)
        check(got == expect, f"lorenzo encode: {got} outliers in the {kind} field, not {expect}")
    for twoeb in QUANT_BOUNDS:
        lorenzo_check(quantization_field(twoeb, g), twoeb, 1, f"quantization at 2eb {twoeb}")
    say(f"lorenzo encode == plain (codes, ascending outlier indices, deltas) on {len(shapes)} shapes x 2 bounds "
        f"({n_out} outliers in all), an all-outlier and a one-outlier field, and on random float bit patterns "
        f"and values next to rounding ties at 2eb in {QUANT_BOUNDS}")


def _is_span(name: str) -> bool:
    return name.startswith(("compress.", "decompress.")) or name.endswith((".encode", ".decode"))


def _innermost_name(mangled: str) -> str:
    """The last name of a mangled nested name (_ZN<len><name>...<len><name>E...),
    so that a kernel in an anonymous namespace reads as its own name."""
    i, name = 3, mangled
    if not mangled.startswith("_ZN"):
        return mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j: j + int(mangled[i:j])], j + int(mangled[i:j])
    return name


def ptxas_report(log: pathlib.Path) -> list[str]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its registers, shared
    memory and spills, one line each, the interp kernels named with their
    (ndim, anchor stride) instantiation and the Lorenzo kernel with its
    (tile rows, vector loads)."""
    import re

    if not log.exists():
        return []
    out, name, spill = [], "?", ""
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            t = (re.search(r"(interp_(?:en|de)code_kernel)ILi(\d)ELi(\d+)E", m.group(1))
                 or re.search(r"(lorenzo_kernel)ILi(\d)ELb([01])E", m.group(1)))
            name = f"{t.group(1)}<{t.group(2)},{t.group(3)}>" if t else _innermost_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return out


def interp_ops(tables: dict) -> tuple[int, int]:
    """Operations of one 3-D block under the packed step tables: per target
    point and used dim 2 per tap + 2 (blend); and the number of target
    points (each then takes 5 operations to quantize or 2 to dequantize)."""
    import numpy as np

    pts = tables["pts"].astype(np.int64)
    ops = 0
    for k in range(tables["n_steps"]):
        pk = pts[tables["step_off"][k]: tables["step_off"][k + 1]]
        idx, dmask = pk & 0x1FFF, pk >> 13
        taps = tables["meta"][tables["step_op"][k]] & 7
        c = np.stack(np.unravel_index(idx, (17, 17, 17)))
        for d in range(3):
            on = (dmask >> d & 1) == 1
            ops += int((2 * taps[c[d, on]] + 2).sum())
    return ops, int(pts.size)


def interp_main_shapes(x, header: dict, iters: int) -> dict:
    """The interp kernels at the main path's shapes: the 17^3 blocks of the
    field ``x`` under the plan in ``header`` (a container's: splines,
    schemes, anchor stride, eb_abs). Runs the encode as the main path calls
    it (codes only) and with its recon, and the decode on what a container
    gives it; checks the codes, recon and decode against the plain
    predictor and the decode against the encoder's recon, all bit for bit;
    then times both kernels with CUDA events over ``iters`` launches.
    Returns the inputs (blocks, steps, twoeb, stride, codes, decode_inputs),
    the largest kernel-vs-plain differences and the two times in ms."""
    import torch

    from repro_torch.core import predictor as plain
    from repro_torch.core.autotune import levels_for_stride
    from repro_torch.core.blocks import gather_blocks_batch_t, pad_field_batch_t
    from repro_torch.core.stencils import build_steps
    from repro_torch.kernels import interp3d as interp

    twoeb, stride = 2.0 * header["eb_abs"], int(header["anchor_stride"])
    steps = build_steps(3, 17, levels_for_stride(stride), tuple(header["splines"]), tuple(header["schemes"]))
    blocks = gather_blocks_batch_t(pad_field_batch_t(x[None]))
    ck, _ = interp.compress_blocks(blocks, twoeb, steps, stride, with_recon=False)  # the main path's call
    ckr, rk = interp.compress_blocks(blocks, twoeb, steps, stride)
    cp, rp = plain.compress_blocks(blocks, twoeb, steps, stride)
    enc_err = float((rk - rp).abs().max())
    check(torch.equal(ck, ckr), "main-path shapes: encode without recon gives other codes")
    check(torch.equal(ck, cp) and torch.equal(rk, rp), f"main-path shapes: encode != plain (recon by {enc_err})")
    del cp, rp, ckr
    dec_in = plain.decode_inputs(blocks, ck, stride)  # what the container gives the decoder
    dk = interp.decompress_blocks(ck, *dec_in, twoeb, steps, stride)
    dp = plain.decompress_blocks(ck, *dec_in, twoeb, steps, stride)
    dec_err = float((dk - dp).abs().max())
    check(torch.equal(dk, dp), f"main-path shapes: decode kernel vs plain differs by {dec_err}")
    check(torch.equal(dk, rk), "main-path shapes: decode != encoder recon")
    del dk, dp, rk
    return {"blocks": blocks, "steps": steps, "twoeb": twoeb, "stride": stride, "codes": ck,
            "decode_inputs": dec_in, "encode_err": enc_err, "decode_err": dec_err,
            "encode_ms": cuda_ms(lambda: interp.compress_blocks(blocks, twoeb, steps, stride, with_recon=False),
                                 iters),
            "decode_ms": cuda_ms(lambda: interp.decompress_blocks(ck, *dec_in, twoeb, steps, stride), iters)}


def phase_profile(comp, x, label: str, compress=None, decompress=None) -> dict:
    """Profile one compress + decompress (``compress(x)`` and
    ``decompress(buf)``, by default ``comp``'s, decoding to the device);
    returns the breakdown: per tracing span its host wall time and the device
    time of the kernels launched inside it (spans opened in worker threads
    do not appear; their kernels do), per kernel name its device time, and
    the device's busy and idle share of the wall time (busy: the union of the
    kernels' intervals, so kernels that overlap on several streams count
    once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        buf = (compress or comp.compress)(x)
        if decompress is None:
            comp.decompress(buf, out="device")
        else:
            decompress(buf)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels, intervals = {}, {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CPU and _is_span(e.name):
            r = spans.setdefault(e.name, {"span": e.name, "count": 0, "host_ms": 0.0, "device_ms": 0.0})
            r["count"] += 1
            r["host_ms"] += e.time_range.elapsed_us() / 1e3
            r["device_ms"] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False) and not _is_span(e.name):
            ms = e.time_range.elapsed_us() / 1e3
            intervals.append((e.time_range.start, e.time_range.end))
            k = kernels.setdefault(e.name[:90], {"name": e.name[:90], "count": 0, "device_ms": 0.0})
            k["count"] += 1
            k["device_ms"] += ms
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3
    spans = sorted(spans.values(), key=lambda r: -r["host_ms"])
    kernels = sorted(kernels.values(), key=lambda r: -r["device_ms"])[:15]
    idle = 1.0 - busy_ms / wall_ms
    say(f"profile {label} (compress + decompress, {x.numel()} points): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"device idle share {idle:.3f}")
    for r in spans:
        say(f"  span {r['span']:<26} x{r['count']:<3} host {r['host_ms']:9.2f} ms  device {r['device_ms']:9.2f} ms")
    for r in kernels:
        say(f"  kernel x{r['count']:<5} {r['device_ms']:9.2f} ms  {r['name']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": idle, "spans": spans, "kernels": kernels}


def run_path(name: str, comp, x, expect) -> tuple[dict, bytes]:
    """One compress + decompress(out="device") of ``x``, with the launch
    counts reset just before and read just after; checks the bound, the
    telemetry and that each kernel in ``expect`` was launched."""
    import numpy as np
    import torch

    from repro_torch.core.compressor import _sections_unpack
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    buf = comp.compress(x)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    tel_c = comp.last_telemetry
    t0 = time.perf_counter()
    y = comp.decompress(buf, out="device")
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tel_d = comp.last_telemetry
    header, _ = _sections_unpack(buf)
    eb_abs = header["eb_abs"]
    check(y.device == x.device and tuple(y.shape) == tuple(x.shape) and y.dtype == torch.float32,
          f"{name}: decompress(out='device') gave {y.device} {tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(y).all()), f"{name}: decoded field has non-finite values")
    diff = y.double() - x.double()
    del y
    err_ratio = float(diff.abs().max()) / eb_abs
    rng = float(x.max()) - float(x.min())
    p = 20 * np.log10(rng) - 10 * np.log10(float((diff * diff).mean()))  # range-normalized, as metrics.psnr
    del diff
    mb = x.numel() * 4 / 1e6
    cr = x.numel() * 4 / len(buf)
    say(f"path {name} {tuple(x.shape)}: mode {header['mode']} pipeline {header['pipeline']}, CR {cr:.4f}, "
        f"max err/eb_abs {err_ratio:.7f}, PSNR {p:.3f} dB, compress {t_c:.3f} s ({mb / t_c:.1f} MB/s), "
        f"decompress {t_d:.3f} s ({mb / t_d:.1f} MB/s), peak device memory {peak_gib:.2f} GiB, "
        f"n_outliers {header['n_outliers']}")
    say(f"  {name} compress telemetry: {json.dumps(tel_c, default=str)}")
    say(f"  {name} decompress telemetry: {json.dumps(tel_d, default=str)}")
    say(f"  {name} launches: {launches}")
    check(err_ratio <= 1 + SLACK, f"{name}: bound violated: max err/eb {err_ratio}")
    check(tel_c["fallbacks"] == [] and tel_d["fallbacks"] == [], f"{name}: fallbacks recorded on the card")
    check(tel_c["verify"]["repairs"] == 0, f"{name}: verify repaired the container: {tel_c['verify']}")
    for k in expect:
        check(launches[k] > 0, f"kernel {k} was not launched on the {name} path")
    return {"shape": list(x.shape), "cr": cr, "err_over_eb": err_ratio, "psnr_db": p, "compress_s": t_c,
            "decompress_s": t_d, "compress_mbps": mb / t_c, "decompress_mbps": mb / t_d, "peak_gib": peak_gib,
            "bytes": len(buf), "n_outliers": header["n_outliers"], "telemetry_compress": tel_c,
            "telemetry_decompress": tel_d, "launches": launches}, buf


def bitshuffle_path_shapes(buf_fz: bytes, device, iters: int) -> dict:
    """The bitshuffle kernels at the fz path's bit1 input (the 512^3 Lorenzo
    codes, from the container ``buf_fz``): checked against their plain
    versions and the round trip, then timed with CUDA events."""
    import torch

    from repro_torch.core.compressor import _sections_unpack
    from repro_torch.core.lossless import pipelines
    from repro_torch.kernels import bitshuffle as bits

    seq = pipelines.decode(_sections_unpack(buf_fz)[1][0], device=device)  # bit1 is fz's first stage
    planes = bits.bitshuffle(seq)
    bs_err = int((planes.int() - bits.bitshuffle_plain(seq).int()).abs().max())
    check(bs_err == 0, f"path shapes: bitshuffle differs from plain by {bs_err}")
    back = bits.bitunshuffle(planes)
    bu_err = int((back.int() - bits.bitunshuffle_plain(planes).int()).abs().max())
    check(bu_err == 0 and torch.equal(back[: seq.numel()], seq), f"path shapes: bitunshuffle differs by {bu_err}")
    del back
    return {"n": int(seq.numel()), "padded": int(planes.numel()), "bs_err": bs_err, "bu_err": bu_err,
            "bs_ms": cuda_ms(lambda: bits.bitshuffle(seq), iters),
            "bs_plain_ms": cuda_ms(lambda: bits.bitshuffle_plain(seq), 3),
            "bu_ms": cuda_ms(lambda: bits.bitunshuffle(planes), iters),
            "bu_plain_ms": cuda_ms(lambda: bits.bitunshuffle_plain(planes), 3)}


def lorenzo_path_shapes(x, buf_fz: bytes, iters: int) -> dict:
    """The Lorenzo encode at the fz path's shapes: the field ``x`` under the
    bound of its container ``buf_fz``. The wrapper call (kernel, host read of
    the outlier count, sort) is checked against the plain version (codes,
    ascending outlier indices, deltas) and timed with CUDA events; the
    kernel alone by the profiler."""
    import torch

    from repro_torch.core import lorenzo as plain_lorenzo
    from repro_torch.core.compressor import _sections_unpack
    from repro_torch.kernels import lorenzo3d as lor

    header = _sections_unpack(buf_fz)[0]
    twoeb, nd = 2.0 * float(header["eb_abs"]), len(header["spatial"])
    xb = x.reshape((int(header["batch"]),) + tuple(header["spatial"]))
    codes, idx, vals = lor.lorenzo_encode(xb, twoeb, nd)
    pc, po, pfull = plain_lorenzo.lorenzo_encode(xb, twoeb, nd)
    pidx = torch.nonzero(po.reshape(-1)).reshape(-1)
    err = max(int((codes.int() - pc.int()).abs().max()),
              int((vals.long() - pfull.reshape(-1)[pidx].long()).abs().max()) if idx.numel() else 0)
    check(torch.equal(idx, pidx) and err == 0, f"path shapes: lorenzo encode differs from plain by {err}")
    del pc, po, pfull, pidx, codes

    def plain_call():
        c, o, full = plain_lorenzo.lorenzo_encode(xb, twoeb, nd)
        i = torch.nonzero(o.reshape(-1)).reshape(-1)
        return c, i, full.reshape(-1)[i]

    return {"shape": tuple(xb.shape), "points": int(xb.numel()), "n_outliers": int(idx.numel()), "err": err,
            "ms": cuda_ms(lambda: lor.lorenzo_encode(xb, twoeb, nd), iters),
            "kernel_ms": kernel_device_ms(lambda: lor.lorenzo_encode(xb, twoeb, nd), "lorenzo", iters),
            "plain_ms": cuda_ms(plain_call, 3)}


def histogram_path_shapes(seq, g, iters: int) -> dict:
    """histogram256 at the main path's hf input ``seq`` (mostly the center
    code) and on a uniform random stream of its length: each checked against
    torch.bincount and timed with CUDA events (on ``seq`` also the kernel
    alone, by the profiler), beside the plain version and torch.bincount
    itself on ``seq``."""
    import torch

    from repro_torch.kernels import histogram as hist

    err = int((hist.histogram256(seq) - torch.bincount(seq, minlength=256)).abs().max())
    check(err == 0, f"main-path shapes: histogram256 differs from torch.bincount by {err}")
    uni = hist_stream("uniform", int(seq.numel()), g)
    u_err = int((hist.histogram256(uni) - torch.bincount(uni, minlength=256)).abs().max())
    check(u_err == 0, f"uniform stream: histogram256 differs from torch.bincount by {u_err}")
    out = {"n": int(seq.numel()), "err": err, "uniform_ms": cuda_ms(lambda: hist.histogram256(uni), iters)}
    del uni
    out.update(ms=cuda_ms(lambda: hist.histogram256(seq), iters),
               kernel_ms=kernel_device_ms(lambda: hist.histogram256(seq), "histogram256", iters),
               plain_ms=cuda_ms(lambda: hist.histogram256_plain(seq), iters),
               library_ms=cuda_ms(lambda: torch.bincount(seq, minlength=256), iters))
    return out


def phase_planner(x, device) -> dict:
    """The planner on the card and on the CPU over the same sampled blocks of
    ``x`` (rel eb 1e-3, default strides): the same plan, candidate labels and
    scores, exactly (the codes are bit-equal and the histograms integers, so
    the trial encodes' byte counts, which the scores hold, are equal too)."""
    import torch

    from repro_torch.core import blocks as blk
    from repro_torch.core.autotune import autotune_plan, plan_sample_indices
    from repro_torch.kernels import launch_counts, reset_launch_counts

    padded = blk.pad_field_batch_t(x[None])
    blocks = blk.gather_blocks_batch_t(padded)
    nb = int(blocks.shape[0])
    sample = blocks.index_select(0, torch.from_numpy(plan_sample_indices(nb)).to(device)).contiguous()
    del blocks
    twoeb = 2e-3 * (float(x.max()) - float(x.min()))
    fshape = (1,) + tuple(int(s) for s in padded.shape[1:])
    del padded
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    card = autotune_plan(sample, twoeb, field_shape=fshape, presampled_of=nb)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = launch_counts()
    t0 = time.perf_counter()
    cpu = autotune_plan(sample.cpu(), twoeb, field_shape=fshape, presampled_of=nb)
    cpu_s = time.perf_counter() - t0
    check(card.to_header(include_candidates=True) == cpu.to_header(include_candidates=True),
          f"planner: card plan {card} {card.candidates} != cpu plan {cpu} {cpu.candidates}")
    check(launches["interp_encode"] > 0 and launches["histogram256"] > 0, f"planner launches: {launches}")
    say(f"planner on {int(sample.shape[0])} of {nb} blocks: card == cpu: plan {card}, {len(card.candidates)} "
        f"candidates with equal scores, est {card.est_bits_per_code:.6f} bits/code; card {card_s:.3f} s "
        f"({launches['interp_encode']} interp_encode, {launches['histogram256']} histogram256 launches), "
        f"cpu {cpu_s:.3f} s")
    return {"plan": str(card), "candidates": [list(c) for c in card.candidates], "sampled_blocks": card.sampled_blocks,
            "card_s": card_s, "cpu_s": cpu_s, "launches": launches}


def phase_orchestrator(seq) -> dict:
    """The orchestrator's choice on the code stream ``seq`` (a CUDA tensor)
    on the card, on a CPU tensor and on a numpy array: the same record."""
    from repro_torch.core.lossless import orchestrate

    t0 = time.perf_counter()
    best, rec = orchestrate.choose_pipeline(seq)
    card_s = time.perf_counter() - t0
    for host in (seq.cpu(), seq.cpu().numpy()):
        hb, hrec = orchestrate.choose_pipeline(host)
        check((hb, hrec) == (best, rec), f"orchestrator: card {best} {rec} != {type(host).__name__} {hb} {hrec}")
    say(f"orchestrator on {int(seq.numel())} codes: card == cpu: {best}, trial_bytes {rec['trial_bytes']}, "
        f"card {card_s:.3f} s")
    return {"pipeline": best, "record": rec, "card_s": card_s}


def nonfinite_field(x):
    """``x`` (numpy) with NaN, +Inf, -Inf and a NaN payload sprinkled in."""
    import numpy as np

    y = x.copy()
    y.reshape(-1)[::997] = np.float32(np.nan)
    y.reshape(-1)[5::1999] = np.inf
    y.reshape(-1)[7::2999] = -np.inf
    y.view(np.uint32).reshape(-1)[11] = 0x7FC0BEEF
    return y


def phase_modes_96(xs, device) -> dict:
    """On the 96^3 field: the presets and the NaN/Inf field byte-equal
    between the card and the CPU path, and each decoding within its bound;
    pw_rel and psnr_target holding their bound and target, with their byte
    equality reported."""
    import numpy as np

    import repro_torch.core as core
    from repro_torch.core import Compressor, CompressorSpec

    out = {}
    cases = {name: ((lambda dev, name=name: getattr(core, name)(device=dev)), xs) for name in BYTE_EQUAL_96[:-1]}
    cases["nonfinite"] = ((lambda dev: Compressor(device=dev)), nonfinite_field(xs))
    cases["pw_rel"] = ((lambda dev: Compressor(CompressorSpec(eb_mode="pw_rel", eb=1e-2), device=dev)), xs)
    cases["psnr_target"] = ((lambda dev: Compressor(CompressorSpec(psnr_target=60.0), device=dev)), xs)
    for name, (make, field) in cases.items():
        card = make(device)
        bc, bh = card.compress(field), make("cpu").compress(field)
        y = Compressor(device="cpu").decompress(bc)
        fin = np.isfinite(field)
        check(np.array_equal(y.view(np.uint32)[~fin], field.view(np.uint32)[~fin]), f"96^3 {name}: non-finite points")
        xf, yf = field[fin].astype(np.float64), y[fin].astype(np.float64)
        if name == "pw_rel":
            nz = xf != 0
            err = float((np.abs(yf[nz] - xf[nz]) / np.abs(xf[nz])).max()) / 1e-2
            check(err <= 1 + SLACK, f"96^3 pw_rel: max relative err / eb {err}")
            metric = f"max rel err/eb {err:.7f}"
        elif name == "psnr_target":
            p = 10 * np.log10((xf.max() - xf.min()) ** 2 / float(np.mean((yf - xf) ** 2)))
            check(p >= 60.0, f"96^3 psnr_target: {p:.3f} dB < 60")
            err, metric = p, f"PSNR {p:.3f} dB (target 60)"
        else:
            info = Compressor.inspect(bc)
            eb = (info.get("inner") or info)["eb_abs"]
            err = float(np.abs(yf - xf).max()) / eb
            check(err <= 1 + SLACK, f"96^3 {name}: max err/eb {err}")
            check(bc == bh, f"96^3 {name}: card and cpu containers differ")
            metric = f"max err/eb {err:.7f}"
        tel = card.last_telemetry
        say(f"96^3 {name}: containers equal {bc == bh}, {len(bc)} bytes, {metric}, pipeline {tel.get('pipeline')}, "
            f"host stages {tel.get('host_stages', [])}")
        out[name] = {"bytes_equal": bc == bh, "bytes": len(bc), "metric": err, "pipeline": tel.get("pipeline")}
    return out


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_reset(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device) -> float:
    import torch

    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else 0.0


def chunk_geometry(buf: bytes) -> list:
    """(first row, rows, eb_abs) of each chunk of a v3 chunk stream (axis 0)."""
    from repro_torch.core import Compressor

    info = Compressor.inspect(buf)
    check(info["axis"] == 0, f"chunk axis {info['axis']}")
    out, lo = [], 0
    for size, fr in zip(info["chunk_sizes"], info["frames"]):
        out.append((lo, size, fr["eb_abs"]))
        lo += size
    return out


def damaged_streams(buf: bytes, seed: int) -> dict:
    """name -> (damaged copy of the v3 stream ``buf``, the chunks that survive):
    a bit flipped inside frame 1's payload, the stream cut inside frame 2's
    payload, and a torn tail (cut inside frame 3's payload, then 96 bytes of
    seeded garbage)."""
    import numpy as np

    from repro_torch.core import frames

    _, table = frames.frame_table(buf)
    off1, size1, _ = table[1]
    flip = bytearray(buf)
    flip[off1 + size1 // 2] ^= 1 << 3
    garbage = np.random.default_rng(seed).integers(0, 256, 96, dtype=np.uint8).tobytes()
    return {"bitflip": (bytes(flip), [True, False, True, True]),
            "trunc": (buf[: table[2][0] + 16], [True, True, False, False]),
            "torn": (buf[: table[3][0] + 8] + garbage, [True, True, True, False])}


def phase_salvage(clean, streams: dict, geometry, device) -> dict:
    """Each damaged stream through decompress(on_error="skip" and "fill",
    out="device"): the chunks_ok mask as expected, every intact chunk equal
    to the clean decode ``clean``, the lost ones left out or zero."""
    import torch

    from repro_torch.core import Compressor

    out = {}
    for name, (buf, expect) in streams.items():
        for mode in ("skip", "fill"):
            comp = Compressor(device=device)
            t0 = time.perf_counter()
            y = comp.decompress(buf, on_error=mode, out="device")
            sync(device)
            dt = time.perf_counter() - t0
            dmg = comp.last_damage
            check(dmg is not None and dmg["chunks_ok"] == expect,
                  f"salvage {name}/{mode}: chunks_ok {None if dmg is None else dmg['chunks_ok']} != {expect}")
            row = 0
            for (lo, size, _), ok in zip(geometry, expect):
                if ok:
                    check(torch.equal(y[row: row + size], clean[lo: lo + size]),
                          f"salvage {name}/{mode}: intact chunk at row {lo} differs from the clean decode")
                elif mode == "fill":
                    check(bool((y[row: row + size] == 0).all()), f"salvage {name}/{mode}: lost chunk not filled")
                row += size if ok or mode == "fill" else 0
            check(row == int(y.shape[0]), f"salvage {name}/{mode}: {int(y.shape[0])} rows, expected {row}")
            out[f"{name}/{mode}"] = {"chunks_ok": dmg["chunks_ok"], "summary": dmg["report"].summary(), "s": dt}
        say(f"  salvage {name} ({len(buf)} bytes): chunks_ok {expect} under skip and fill; "
            f"{out[name + '/skip']['summary']}")
    return out


def phase_golden_v3(device) -> dict:
    """The committed golden v3 fixtures, intact and damaged, decoded on the
    card: equal to the port's CPU decode of the same bytes, with the same
    chunk mask, and within the bound of golden_field.npy."""
    import numpy as np

    from repro_torch.core import Compressor

    data = ROOT / "tests" / "data"
    x = np.load(data / "golden_field.npy").astype(np.float64)
    eb = 1e-2 * float(x.max() - x.min())  # tests/data/gen_golden.py's spec
    sizes = Compressor.inspect((data / "golden_v3.bin").read_bytes())["chunk_sizes"]
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    out = {}
    for name in GOLDEN_V3:
        buf = (data / f"{name}.bin").read_bytes()
        card, cpu = Compressor(device=device), Compressor(device="cpu")
        yc, yh = card.decompress(buf, on_error="fill"), cpu.decompress(buf, on_error="fill")
        mc = card.last_damage and card.last_damage["chunks_ok"]
        mh = cpu.last_damage and cpu.last_damage["chunks_ok"]
        check(np.array_equal(yc, yh) and mc == mh, f"golden {name}: card decode != cpu decode ({mc} vs {mh})")
        mask = mc or [True] * len(sizes)
        err = max(float(np.abs(yc[bounds[i]: bounds[i + 1]] - x[bounds[i]: bounds[i + 1]]).max())
                  for i in range(len(sizes)) if mask[i]) / eb
        check(err <= 1 + SLACK, f"golden {name}: max err/eb {err}")
        say(f"  golden {name}: card == cpu, chunks_ok {mask}, max err/eb {err:.7f}")
        out[name] = {"chunks_ok": mask, "err_over_eb": err}
    return out


def phase_threads(device) -> dict:
    """Two threads share one Compressor and one PlanCache on the card and
    compress two fields with predictor="auto" whose plans differ; the
    interleaving is forced (both tune before either caches). Each thread's
    last_plan, each cache entry and each container equal a single-threaded
    run's."""
    import threading

    import numpy as np

    from repro_torch.core import Compressor, CompressorSpec, PlanCache

    side = 24
    shape = (side,) * 3
    white = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ks = np.meshgrid(*[np.fft.fftfreq(n) for n in shape[:-1]] + [np.fft.rfftfreq(shape[-1])], indexing="ij")
    filt = (sum(k**2 for k in ks) + 1e-6) ** -1.0
    filt.flat[0] = 0.0
    f = np.fft.irfftn(np.fft.rfftn(white) * filt, s=shape, axes=(0, 1, 2)).astype(np.float32)
    g = np.arange(side, dtype=np.float32)
    fields = {"nyx": np.exp(2.0 * f / np.abs(f).max()).astype(np.float32),
              "ramp": (g[:, None, None] + 2 * g[None, :, None] + 3 * g[None, None, :]).astype(np.float32)}
    spec = CompressorSpec(predictor="auto")
    alone = {}
    for name, x in fields.items():
        cache = PlanCache()
        comp = Compressor(spec, device=device, plan_cache=cache)
        buf = comp.compress(x)
        (key,) = cache.keys()
        alone[name] = (comp.last_plan, key, cache.peek(key), buf)
    check(alone["nyx"][0] != alone["ramp"][0], f"threads: the two fields tune alike ({alone['nyx'][0]})")
    cache = PlanCache()
    comp = Compressor(spec, device=device, plan_cache=cache)
    barrier = threading.Barrier(len(fields), timeout=120)
    tune = comp._tune_interp

    def tune_then_wait(*args, **kwargs):
        out = tune(*args, **kwargs)
        barrier.wait()  # both threads have tuned before either caches its plan
        return out

    comp._tune_interp = tune_then_wait
    got, errors = {}, []

    def run(name):
        try:
            buf = comp.compress(fields[name])
            got[name] = (comp.last_plan, buf)
        except Exception as e:  # reported after the join
            errors.append(repr(e))
            barrier.abort()

    threads = [threading.Thread(target=run, args=(name,)) for name in fields]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads) and not errors, f"threads: {errors}")
    for name, (plan, key, entry, buf) in alone.items():
        check(got[name][0] == plan, f"threads: {name}'s last_plan {got[name][0]} != {plan}")
        check(cache.peek(key) == entry, f"threads: the cache entry of {name} is another field's")
        check(got[name][1] == buf, f"threads: {name}'s container differs from the single-threaded one")
    say(f"  threads: two threads on one Compressor and PlanCache kept their own plans: "
        f"nyx {alone['nyx'][0]}, ramp {alone['ramp'][0]}")
    return {name: str(alone[name][0]) for name in fields}


def phase_io(x, spec_str: str, smi: str, device) -> dict:
    """repro_torch.io on the card: the field in chunks along axis 0 (lossy,
    ``spec_str``) and a small int32 variable (lossless) written to a
    temporary file, then one chunk by random access and the whole dataset
    read back; the field within each chunk's bound, the int32 exact."""
    import tempfile

    import numpy as np

    import repro_torch.io as rio

    xh = x.cpu().numpy()
    n = xh.shape[0] // V3_CHUNKS
    steps = np.arange(64 * 64, dtype=np.int32).reshape(64, 64)
    ds = rio.Dataset.from_arrays({"density": xh, "steps": steps}, attrs={"source": "chip_smoke phase 8"})
    mb = xh.nbytes / 1e6
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "phase8.cszh3"
        t0 = time.perf_counter()
        man = rio.write(ds, path, compression={"density": spec_str, None: "lossless"},
                        chunks={"density": (n,) + xh.shape[1:]}, device=device)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = rio.read_variable(path, "density", chunks=1, device=device)
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = rio.read(path, device=device)
        read_s = time.perf_counter() - t0
    check(np.array_equal(back["steps"].data, steps), "io: the lossless int32 variable changed")
    check(np.array_equal(back["density"].data[n: 2 * n], one), "io: read_variable chunk 1 != the full read's")
    worst = 0.0
    for i in range(V3_CHUNKS):
        c = xh[i * n: (i + 1) * n].astype(np.float64)
        eb = 1e-3 * (c.max() - c.min())
        worst = max(worst, float(np.abs(back["density"].data[i * n: (i + 1) * n] - c).max()) / eb)
    check(worst <= 1 + SLACK, f"io: max err/eb {worst}")
    say(f"  io ({smi}): wrote {man['bytes_written']} bytes of {mb:.1f} MB in {write_s:.3f} s "
        f"({mb / write_s:.1f} MB/s), read chunk 1 in {one_s:.3f} s ({mb / V3_CHUNKS / one_s:.1f} MB/s), "
        f"read all in {read_s:.3f} s ({mb / read_s:.1f} MB/s), max err/eb {worst:.7f}")
    return {"bytes": man["bytes_written"], "write_s": write_s, "write_mbps": mb / write_s, "read_chunk_s": one_s,
            "read_chunk_mbps": mb / V3_CHUNKS / one_s, "read_s": read_s, "read_mbps": mb / read_s,
            "err_over_eb": worst}


def phase_v3(x, device, smi: str, seed: int) -> dict:
    """Phase 8: frames v3 and the data layer on the field ``x``."""
    import torch

    from repro_torch.core import Compressor, chunk_compress, frames, shard_compress, shard_decompress
    from repro_torch.kernels import launch_counts, reset_launch_counts

    out = {}
    sync(device)
    peak_reset(device)
    mb = x.numel() * 4 / 1e6
    comp = Compressor(device=device)
    reset_launch_counts()
    t0 = time.perf_counter()
    buf = chunk_compress(x, n_chunks=V3_CHUNKS, compressor=comp)
    sync(device)
    t_c = time.perf_counter() - t0
    tel_c = comp.last_telemetry
    t0 = time.perf_counter()
    y = comp.decompress(buf, out="device")
    sync(device)
    t_d = time.perf_counter() - t0
    launches = launch_counts()
    check(launches == V3_LAUNCHES, f"v3: launches {launches} != {V3_LAUNCHES}")
    check(tel_c["fallbacks"] == [] and comp.last_telemetry["fallbacks"] == [], "v3: fallbacks recorded on the card")
    geometry = chunk_geometry(buf)
    check(y.device == x.device and tuple(y.shape) == tuple(x.shape), f"v3: decoded {y.device} {tuple(y.shape)}")
    worst = max(float((y[lo: lo + n].double() - x[lo: lo + n].double()).abs().max()) / eb for lo, n, eb in geometry)
    check(worst <= 1 + SLACK, f"v3: max err/eb {worst} (each chunk against its own bound)")
    _, payloads = frames.unpack_frames(buf)
    for (lo, n, _), p in zip(geometry, payloads):
        check(bytes(p) == Compressor(device=device).compress(x[lo: lo + n]),
              f"v3: frame at row {lo} != Compressor().compress of its chunk")
    part = comp.decompress(buf, frames=[2, 0], out="device")
    (l2, n2, _), (l0, n0, _) = geometry[2], geometry[0]
    check(torch.equal(part, torch.cat([y[l2: l2 + n2], y[l0: l0 + n0]])), "v3: frames=[2, 0] != the slices")
    peak_c = peak_gib(device)
    say(f"phase 8 ({smi}): chunk_compress of {tuple(x.shape)} in {V3_CHUNKS} chunks: {len(buf)} bytes, "
        f"CR {x.numel() * 4 / len(buf):.4f}, max err/eb {worst:.7f}, compress {t_c:.3f} s ({mb / t_c:.1f} MB/s), "
        f"decompress {t_d:.3f} s ({mb / t_d:.1f} MB/s); launches {launches}; every frame == Compressor().compress "
        f"of its chunk; frames=[2, 0] == the slices")
    out["chunks"] = {"bytes": len(buf), "cr": x.numel() * 4 / len(buf), "err_over_eb": worst, "compress_s": t_c,
                     "decompress_s": t_d, "compress_mbps": mb / t_c, "decompress_mbps": mb / t_d,
                     "launches": launches, "telemetry_compress": tel_c}
    dev = [device] * V3_CHUNKS
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    sb = shard_compress(x, dev)
    sync(device)
    t_s = time.perf_counter() - t0
    shard_launches = launch_counts()
    check(sb == buf, "v3: shard_compress over [cuda:0] * 4 != chunk_compress")
    check(shard_launches["interp_encode"] == 4 and shard_launches["histogram256"] == 4
          and shard_launches["interp_decode"] == 4, f"v3: shard_compress launches {shard_launches}")
    sync_buf = shard_compress(x, dev, sync=True)
    header, _ = frames.unpack_frames(buf)
    check(sync_buf == frames.pack_frames(header, [bytes(p) for p in payloads], sync=True),
          "v3: the sync-marked stream != the same frames with sync markers")
    shared = Compressor(device=device)
    timings = {}
    for workers in (1, V3_CHUNKS, 1, V3_CHUNKS):
        sync(device)
        t0 = time.perf_counter()
        yw = shard_decompress(buf, workers=workers, compressor=shared, out="device")
        sync(device)
        timings.setdefault(workers, []).append(time.perf_counter() - t0)
        check(torch.equal(yw, y), f"v3: shard_decompress(workers={workers}) != the sequential decode")
        del yw
    say(f"  shard_compress over {V3_CHUNKS} x {device} ({V3_CHUNKS} threads, a stream each): == chunk_compress, "
        f"{t_s:.3f} s "
        f"({mb / t_s:.1f} MB/s), launches {shard_launches}; shard_decompress bit-equal: workers=1 "
        f"{timings[1][0]:.3f} / {timings[1][1]:.3f} s, workers=4 {timings[4][0]:.3f} / {timings[4][1]:.3f} s")
    out["shard"] = {"compress_s": t_s, "compress_mbps": mb / t_s, "launches": shard_launches,
                    "decompress_workers_s": {str(k): v for k, v in timings.items()}}
    out["salvage"] = phase_salvage(y, damaged_streams(buf, seed), geometry, device)
    out["salvage_sync"] = phase_salvage(y, damaged_streams(sync_buf, seed), geometry, device)
    del y, part
    out["peak_gib_v3"] = max(peak_c, peak_gib(device))
    out["golden"] = phase_golden_v3(device)
    out["threads"] = phase_threads(device)
    out["io"] = phase_io(x, "lossy,rel,0.001", smi, device)
    out["peak_gib"] = peak_gib(device)
    say(f"  phase 8 peak device memory: {out['peak_gib_v3']:.2f} GiB through the v3 checks, "
        f"{out['peak_gib']:.2f} GiB with io")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--side", type=int, default=512, help="edge of the cubic main-path field")
    ap.add_argument("--out", default=None, help="write the measurements here as JSON")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch.core as core
    from repro_torch.core import Compressor, CompressorSpec
    from repro_torch.core import predictor as plain
    from repro_torch.core.compressor import _sections_unpack
    from repro_torch.core.lossless import pipelines
    from repro_torch.kernels import interp3d as interp
    from repro_torch.kernels.build import build, build_dir

    device = torch.device("cuda", 0)
    results: dict = {}

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    results["card"] = smi
    try:  # the zstd stage's codec on this machine: zstandard, else zlib
        import zstandard
        results["zstd_codec"] = f"zstandard {zstandard.__version__}"
    except ImportError:
        results["zstd_codec"] = "zlib (zstandard does not import)"
    say(f"zstd stage codec: {results['zstd_codec']}")

    # 2. build
    t0 = time.perf_counter()
    secs = build()
    say(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name in secs:
        for line in ptxas_report(build_dir() / f"{name}.log"):
            say(f"  ptxas {name}: {line}")

    # 3. kernels vs plain, then the planner on the card against the CPU
    phase_kernels(device, args.seed)
    x = nyx_like(args.side, args.seed, device)
    torch.cuda.synchronize()
    results["planner"] = phase_planner(x, device)

    # 4. the paths at full size
    comps, bufs = {}, {}
    results["paths"] = {}
    for name, (preset, kernels) in PATHS.items():
        comp = Compressor(CompressorSpec()) if preset is None else getattr(core, preset)()
        results["paths"][name], bufs[name] = run_path(name, comp, x, kernels)
        comps[name] = comp
    results["main"] = results["paths"]["main"]
    header, sections = _sections_unpack(bufs["main"])
    say(f"main header: splines {header['splines']} schemes {header['schemes']} n_outliers {header['n_outliers']}")
    ap, ap_header = comps["cusz_hi_autoplan"].last_plan, _sections_unpack(bufs["cusz_hi_autoplan"])[0]
    say(f"cusz_hi_autoplan: plan {ap} ({len(ap.candidates)} candidates, est {ap.est_bits_per_code:.6f} bits/code), "
        f"pipeline {ap_header['pipeline']}, trial_bytes {ap_header['pchoice']['trial_bytes']}, "
        f"launches {results['paths']['cusz_hi_autoplan']['launches']}")
    results["autoplan"] = {"plan": str(ap), "candidates": len(ap.candidates), "pchoice": ap_header["pchoice"]}
    results["orchestrator"] = phase_orchestrator(pipelines.decode(sections[0], device=device))

    # 5. card path vs the port's CPU path
    xs = smooth_big()
    results["card_vs_cpu"] = {}
    for name, (preset, _) in PATHS.items():
        def make(dev=None, preset=preset):
            return Compressor(device=dev) if preset is None else getattr(core, preset)(device=dev)
        bc, bh = make().compress(xs), make("cpu").compress(xs)
        hc, sc = _sections_unpack(bc)
        hh, sh = _sections_unpack(bh)
        if hc["mode"] == "lorenzo":
            check(bc == bh, f"{name}: card and cpu Lorenzo containers differ")
            agree = 1.0
        else:
            check((hc["splines"], hc["schemes"]) == (hh["splines"], hh["schemes"]),
                  f"{name}: autotune differs: card {hc['splines']} {hc['schemes']} vs cpu {hh['splines']} {hh['schemes']}")
            cc, ch = pipelines.decode(sc[0]), pipelines.decode(sh[0])
            agree = float((cc == ch).mean()) if cc.shape == ch.shape else 0.0
            check(agree >= MIN_AGREE, f"{name}: card vs cpu code streams agree {agree:.6f}")
            if agree == 1.0:
                check(bc == bh, f"{name}: code streams equal but containers differ")
        ys = Compressor(device="cpu").decompress(bc)
        r96 = float(np.abs(ys.astype(np.float64) - xs).max()) / hc["eb_abs"]
        check(r96 <= 1 + SLACK, f"{name}: card container decoded on cpu: max err/eb {r96}")
        say(f"96^3 {name} card vs cpu: codes agree {agree:.7f}, containers equal {bc == bh}, "
            f"card container on cpu err/eb {r96:.7f}")
        results["card_vs_cpu"][name] = {"agree": agree, "bytes_equal": bc == bh, "err_over_eb": r96}
    results["modes_96"] = phase_modes_96(xs, device)

    # 6. kernel times at the paths' shapes
    im = interp_main_shapes(x, header, iters=10)
    blocks, steps, twoeb, stride, ck = im["blocks"], im["steps"], im["twoeb"], im["stride"], im["codes"]
    anchors, keys, vals = im["decode_inputs"]
    nb, V = int(blocks.shape[0]), 17 ** 3
    ops_pred, n_pts = interp_ops(interp.pack_steps(steps, stride))
    enc_plain = cuda_ms(lambda: plain.compress_blocks(blocks, twoeb, steps, stride), 2)
    dec_plain = cuda_ms(lambda: plain.decompress_blocks(ck, anchors, keys, vals, twoeb, steps, stride), 2)
    seq = pipelines.decode(sections[0], device=device)  # the hf stage's input on the main path
    hs = histogram_path_shapes(seq, torch.Generator(device=device).manual_seed(args.seed + 2), 20)
    bs = bitshuffle_path_shapes(bufs["fzgpu_like"], device, 20)
    lz = lorenzo_path_shapes(x, bufs["fzgpu_like"], 10)

    def bound(nbytes: float, ops: float):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # encode (codes only, as the main path calls it): reads the f32 block, writes u8 codes;
    # decode: reads u8 codes, the blocks' anchors and the outliers (i64 key + f32 value),
    # writes the f32 recon
    enc_b = bound(nb * V * (4 + 1), nb * (ops_pred + 5 * n_pts))
    dec_b = bound(nb * V * (1 + 4) + anchors.numel() * 4 + keys.numel() * (8 + 4), nb * (ops_pred + 2 * n_pts))
    hist_b = bound(hs["n"] + 256 * 8, hs["n"])
    # bitshuffle reads n bytes and writes the padded planes; about 30 integer operations per 8 bytes
    bs_b = bound(bs["n"] + bs["padded"], 30 * bs["padded"] / 8)
    bu_b = bound(2 * bs["padded"], 30 * bs["padded"] / 8)
    # Lorenzo: reads the f32 field, writes u8 codes and 12 B per outlier; one division,
    # one rounding and a dozen integer operations per point
    lz_b = bound(5 * lz["points"] + 12 * lz["n_outliers"], 14 * lz["points"])
    launches = {name: results["paths"][name]["launches"] for name in PATHS}
    kernels = [
        {"name": "interp_encode", "route": "cuda", "source": "src/repro_torch/csrc/interp3d.cu",
         "replaces": "src/repro/kernels/interp3d/interp3d.py:61", "launches": launches["main"]["interp_encode"],
         "path": "main", "max_abs_err": im["encode_err"], "ms": im["encode_ms"], "plain_ms": enc_plain,
         "bound_ms": enc_b[0], "bound_by": enc_b[1], "library_ms": None},
        {"name": "interp_decode", "route": "cuda", "source": "src/repro_torch/csrc/interp3d.cu",
         "replaces": "src/repro/core/predictor.py:88", "launches": launches["main"]["interp_decode"],
         "path": "main", "max_abs_err": im["decode_err"], "ms": im["decode_ms"], "plain_ms": dec_plain,
         "bound_ms": dec_b[0], "bound_by": dec_b[1], "library_ms": None},
        {"name": "histogram256", "route": "cuda", "source": "src/repro_torch/csrc/histogram.cu",
         "replaces": "src/repro/kernels/histogram/histogram.py:19", "launches": launches["main"]["histogram256"],
         "path": "main", "max_abs_err": hs["err"], "ms": hs["ms"], "plain_ms": hs["plain_ms"],
         "bound_ms": hist_b[0], "bound_by": hist_b[1], "library_ms": hs["library_ms"]},
        {"name": "bitshuffle", "route": "cuda", "source": "src/repro_torch/csrc/bitshuffle.cu",
         "replaces": "src/repro/kernels/bitshuffle/bitshuffle.py:19",
         "launches": launches["fzgpu_like"]["bitshuffle"], "path": "fzgpu_like", "max_abs_err": bs["bs_err"],
         "ms": bs["bs_ms"], "plain_ms": bs["bs_plain_ms"], "bound_ms": bs_b[0], "bound_by": bs_b[1],
         "library_ms": None},
        {"name": "bitunshuffle", "route": "cuda", "source": "src/repro_torch/csrc/bitshuffle.cu",
         "replaces": "src/repro/kernels/bitshuffle/bitshuffle.py:32",
         "launches": sum(launches[name]["bitunshuffle"] for name in launches), "path": None,
         "max_abs_err": bs["bu_err"], "ms": bs["bu_ms"], "plain_ms": bs["bu_plain_ms"], "bound_ms": bu_b[0],
         "bound_by": bu_b[1], "library_ms": None},
        {"name": "lorenzo_encode", "route": "cuda", "source": "src/repro_torch/csrc/lorenzo3d.cu",
         "replaces": "src/repro/kernels/lorenzo3d/lorenzo3d.py:22",
         "launches": launches["fzgpu_like"]["lorenzo_encode"], "path": "fzgpu_like", "max_abs_err": lz["err"],
         "ms": lz["ms"], "plain_ms": lz["plain_ms"], "bound_ms": lz_b[0], "bound_by": lz_b[1], "library_ms": None},
    ]
    say(f"main-path shapes: {nb} blocks of 17^3 (kernels == plain bit for bit, {keys.numel()} outlier keys), "
        f"hf input {hs['n']} bytes")
    say(f"fz-path shapes: bit1 input {bs['n']} bytes ({bs['padded']} padded), Lorenzo field {lz['shape']} with "
        f"{lz['n_outliers']} outliers")
    say(f"histogram256 on a uniform random stream of {hs['n']} bytes: {hs['uniform_ms']:.4f} ms "
        f"(on the main path's stream: {hs['ms']:.4f} ms, the kernel alone {hs['kernel_ms']:.4f} ms)")
    say(f"lorenzo_encode: the wrapper call {lz['ms']:.4f} ms, the kernel alone {lz['kernel_ms']:.4f} ms")
    results["kernels"] = kernels
    results["histogram_uniform_ms"] = hs["uniform_ms"]
    results["kernel_alone_ms"] = {"histogram256": hs["kernel_ms"], "lorenzo_encode": lz["kernel_ms"]}
    del im, blocks, ck, anchors, keys, vals, seq

    for k in kernels:
        k["launches_by_path"] = {name: launches[name][k["name"]] for name in PATHS}

    # 7. where the time goes
    results["profile"] = {name: phase_profile(comps[name], x, name) for name in PATHS}
    cache = core.PlanCache()
    for label in ("cusz_hi_autoplan, plan cache miss", "cusz_hi_autoplan, plan cache hit"):
        comp = Compressor(CompressorSpec(predictor="auto", pipeline="auto"), plan_cache=cache)
        results["profile"][label] = phase_profile(comp, x, label)
    check(cache.hits == 1 and cache.misses == 1, f"plan cache: {cache.stats()}")
    say(f"plan cache after the two profiled runs: {cache.stats()}")
    comp = Compressor()
    label = f"v3 chunks (chunk_compress, {V3_CHUNKS} chunks)"
    results["profile"][label] = phase_profile(
        comp, x, label, compress=lambda f: core.chunk_compress(f, n_chunks=V3_CHUNKS, compressor=comp))
    label = f"v3 shards (shard_compress over {V3_CHUNKS} x cuda:0, shard_decompress with {V3_CHUNKS} workers)"
    results["profile"][label] = phase_profile(
        comp, x, label, compress=lambda f: core.shard_compress(f, [device] * V3_CHUNKS),
        decompress=lambda b: core.shard_decompress(b, workers=V3_CHUNKS, compressor=comp, out="device"))

    # 8. frames v3 and the data layer
    results["v3"] = phase_v3(x, device, smi, args.seed)
    for k in kernels:
        k["launches_by_path"]["v3_chunks"] = results["v3"]["chunks"]["launches"][k["name"]]
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1, default=str))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
