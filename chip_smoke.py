#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and check it.

    PYTHONPATH=src python3 chip_smoke.py [--seed 0] [--side 512] [--out results.json]

Phases, in order; any failure exits non-zero:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source);
  3. every kernel against its plain torch version on the card: interp encode
     over spline x scheme x anchor stride on random and smooth blocks, interp
     decode (bit-equal to the encoder's recon), histogram256 against
     torch.bincount at ragged and unaligned lengths;
  4. the main path at full size: a Nyx-like lognormal 512^3 float32 field
     made on the card from --seed, Compressor().compress() then
     .decompress(out="device") under the default spec, with launch counts
     reset just before and read just after;
  5. the card's container against the port's CPU path on a 96^3 field;
  6. per-kernel times at the main path's shapes (CUDA events) beside the
     plain version, the byte/operation bound and, for the histogram,
     torch.bincount as a library yardstick;
  7. where the time goes: one more compress + decompress of the field under
     torch.profiler, by tracing span (host wall and device time) and by
     device kernel, with the device's idle share of the wall time.
Prints one JSON line of kernels, then, as the last line,
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints no result.
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


def phase_kernels(device, seed: int) -> None:
    import torch

    from repro_torch.core import predictor as plain
    from repro_torch.core.autotune import levels_for_stride
    from repro_torch.core.stencils import build_steps
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import interp3d as interp

    g = torch.Generator(device=device).manual_seed(seed + 1)

    def blocks_of(kind: str, nb: int):
        if kind == "random":
            return torch.randn((nb, 17, 17, 17), generator=g, device=device), 1e-2
        c = torch.linspace(0, 1, 17, device=device)
        ph = torch.rand((nb, 3), generator=g, device=device) * 6.0
        f = (torch.sin(3 * c[None, :, None, None] + ph[:, 0, None, None, None])
             * torch.cos(2 * c[None, None, :, None] + ph[:, 1, None, None, None])
             + 0.5 * torch.sin(5 * c[None, None, None, :] + ph[:, 2, None, None, None]))
        return f.contiguous(), 1e-3 * float(f.max() - f.min())

    cases = []
    for kind in ("random", "smooth"):
        for stride in (16, 8):
            for spline in ("linear", "cubic", "natural-cubic"):
                for scheme in ("md", "1d", "1d-210"):
                    cases.append((kind, 4096, stride, spline, scheme))
        cases += [(kind, 1, 16, "cubic", "md"), (kind, 257, 8, "natural-cubic", "1d-210")]
    worst_agree, worst_ratio = 1.0, 0.0
    for kind, nb, stride, spline, scheme in cases:
        blocks, eb = blocks_of(kind, nb)
        L = len(levels_for_stride(stride))
        steps = build_steps(3, 17, levels_for_stride(stride), (spline,) * L, (scheme,) * L)
        ck, rk = interp.compress_blocks(blocks, 2 * eb, steps, stride)
        cp, rp = plain.compress_blocks(blocks, 2 * eb, steps, stride)
        c_only, no_recon = interp.compress_blocks(blocks, 2 * eb, steps, stride, with_recon=False)
        torch.cuda.synchronize()
        ok = ck == 0
        agree = float((ck == cp).float().mean())
        err = (rk - blocks).abs()[~ok]
        ratio = float(err.max()) / eb if err.numel() else 0.0
        label = f"{kind} nb={nb} stride={stride} {spline}/{scheme}"
        check(agree >= MIN_AGREE, f"interp encode vs plain: codes agree {agree:.6f} < {MIN_AGREE} ({label})")
        check(ratio <= 1 + SLACK, f"interp encode bound: max err/eb {ratio:.6f} ({label})")
        check(no_recon is None and torch.equal(c_only, ck), f"interp encode without recon: other codes ({label})")
        dec_in = plain.decode_inputs(blocks, ck, stride)
        dk = interp.decompress_blocks(ck, *dec_in, 2 * eb, steps, stride)
        dp = plain.decompress_blocks(ck, *dec_in, 2 * eb, steps, stride)
        check(torch.equal(dk, rk), f"interp decode does not reproduce the encoder's recon bit for bit ({label})")
        derr = (dp - blocks).abs()[~ok]
        dratio = float(derr.max()) / eb if derr.numel() else 0.0
        check(dratio <= 1 + SLACK, f"plain decode of kernel codes: max err/eb {dratio:.6f} ({label})")
        worst_agree, worst_ratio = min(worst_agree, agree), max(worst_ratio, ratio, dratio)
    say(f"interp encode/decode vs plain: {len(cases)} cases, worst code agreement {worst_agree:.6f}, "
        f"worst err/eb {worst_ratio:.6f}, decode == encoder recon bit for bit in every case")
    sizes = (0, 1, 8191, 8193, 10**6 + 3, 512**3)
    for n in sizes:
        for skew in (False, True):
            d = torch.randint(0, 256, (n + 3,), generator=g, device=device, dtype=torch.uint8)
            if skew:  # quantization-code-like: mostly the center code
                d = torch.where(torch.rand(n + 3, generator=g, device=device) < 0.9, torch.full_like(d, 128), d)
            for off in (0, 3):  # 3: an unaligned start exercises the scalar head
                x = d[off : off + n]
                check(torch.equal(hist.histogram256(x), torch.bincount(x, minlength=256)),
                      f"histogram256 != bincount (n={n}, offset={off}, skewed={skew})")
    say(f"histogram256 == torch.bincount for n in {sizes}, aligned and unaligned, uniform and skewed")


def _is_span(name: str) -> bool:
    return name.startswith(("compress.", "decompress.")) or name.endswith((".encode", ".decode"))


def phase_profile(comp, x) -> dict:
    """Profile one compress + decompress; returns the breakdown: per tracing
    span its host wall time and the device time of the kernels launched
    inside it, per kernel name its device time, and the device's busy and
    idle share of the wall time (one stream, so kernel times do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        buf = comp.compress(x)
        comp.decompress(buf, out="device")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels = {}, {}
    busy_ms = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and _is_span(e.name):
            r = spans.setdefault(e.name, {"span": e.name, "count": 0, "host_ms": 0.0, "device_ms": 0.0})
            r["count"] += 1
            r["host_ms"] += e.time_range.elapsed_us() / 1e3
            r["device_ms"] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False) and not _is_span(e.name):
            ms = e.time_range.elapsed_us() / 1e3
            busy_ms += ms
            k = kernels.setdefault(e.name[:90], {"name": e.name[:90], "count": 0, "device_ms": 0.0})
            k["count"] += 1
            k["device_ms"] += ms
    spans = sorted(spans.values(), key=lambda r: -r["host_ms"])
    kernels = sorted(kernels.values(), key=lambda r: -r["device_ms"])[:15]
    idle = 1.0 - busy_ms / wall_ms
    say(f"profile (compress + decompress, {x.numel()} points): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"device idle share {idle:.3f}")
    for r in spans:
        say(f"  span {r['span']:<26} x{r['count']:<3} host {r['host_ms']:9.2f} ms  device {r['device_ms']:9.2f} ms")
    for r in kernels:
        say(f"  kernel x{r['count']:<5} {r['device_ms']:9.2f} ms  {r['name']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": idle, "spans": spans, "kernels": kernels}


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
    from repro_torch.core import Compressor, CompressorSpec
    from repro_torch.core import predictor as plain
    from repro_torch.core.blocks import gather_blocks_batch_t, pad_field_batch_t
    from repro_torch.core.compressor import _sections_unpack
    from repro_torch.core.lossless import pipelines
    from repro_torch.core.stencils import build_steps
    from repro_torch.core.autotune import levels_for_stride
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import interp3d as interp
    from repro_torch.kernels import launch_counts, reset_launch_counts
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

    # 2. build
    t0 = time.perf_counter()
    secs = build()
    say(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name in secs:
        log = (build_dir() / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {name}: {line.strip()}")

    # 3. kernels vs plain
    phase_kernels(device, args.seed)

    # 4. the main path at full size
    x = nyx_like(args.side, args.seed, device)
    torch.cuda.synchronize()
    comp = Compressor(CompressorSpec())
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
    header, sections = _sections_unpack(buf)
    eb_abs = header["eb_abs"]
    check(y.device == device and tuple(y.shape) == tuple(x.shape) and y.dtype == torch.float32,
          f"decompress(out='device') gave {y.device} {tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(y).all()), "decoded field has non-finite values")
    err_ratio = float((y.double() - x.double()).abs().max()) / eb_abs
    mb = x.numel() * 4 / 1e6
    cr = x.numel() * 4 / len(buf)
    diff = y.double() - x.double()
    rng = float(x.max()) - float(x.min())
    p = 20 * np.log10(rng) - 10 * np.log10(float((diff * diff).mean()))  # range-normalized, as metrics.psnr
    del diff
    say(f"main path {args.side}^3: CR {cr:.4f}, max err/eb_abs {err_ratio:.7f}, PSNR {p:.3f} dB, "
        f"compress {t_c:.3f} s ({mb / t_c:.1f} MB/s), decompress {t_d:.3f} s ({mb / t_d:.1f} MB/s), "
        f"peak device memory {peak_gib:.2f} GiB")
    say(f"header: splines {header['splines']} schemes {header['schemes']} n_outliers {header['n_outliers']}")
    say(f"compress telemetry: {json.dumps(tel_c, default=str)}")
    say(f"decompress telemetry: {json.dumps(tel_d, default=str)}")
    say(f"launches on the main path: {launches}")
    check(err_ratio <= 1 + SLACK, f"main path bound violated: max err/eb {err_ratio}")
    check(tel_c["fallbacks"] == [] and tel_d["fallbacks"] == [], "fallbacks recorded on the card")
    check(tel_c["verify"]["repairs"] == 0, f"verify repaired the container: {tel_c['verify']}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    results["main"] = {"side": args.side, "cr": cr, "err_over_eb": err_ratio, "psnr_db": p,
                       "compress_s": t_c, "decompress_s": t_d, "compress_mbps": mb / t_c,
                       "decompress_mbps": mb / t_d, "peak_gib": peak_gib, "bytes": len(buf), "telemetry_compress": tel_c,
                       "telemetry_decompress": tel_d, "launches": launches}

    # 5. card path vs the port's CPU path
    xs = smooth_big()
    bc = Compressor().compress(xs)
    bh = Compressor(device="cpu").compress(xs)
    hc, sc = _sections_unpack(bc)
    hh, sh = _sections_unpack(bh)
    check((hc["splines"], hc["schemes"]) == (hh["splines"], hh["schemes"]),
          f"autotune differs: card {hc['splines']} {hc['schemes']} vs cpu {hh['splines']} {hh['schemes']}")
    cc, ch = pipelines.decode(sc[0]), pipelines.decode(sh[0])
    agree = float((cc == ch).mean()) if cc.shape == ch.shape else 0.0
    check(agree >= MIN_AGREE, f"card vs cpu code streams agree {agree:.6f}")
    if agree == 1.0:
        check(bc == bh, "code streams equal but containers differ")
    ys = Compressor(device="cpu").decompress(bc)
    r96 = float(np.abs(ys.astype(np.float64) - xs).max()) / hc["eb_abs"]
    check(r96 <= 1 + SLACK, f"card container decoded on cpu: max err/eb {r96}")
    say(f"96^3 card vs cpu: same plan, codes agree {agree:.7f}, containers equal {bc == bh}, "
        f"card container on cpu err/eb {r96:.7f}")
    results["card_vs_cpu"] = {"agree": agree, "bytes_equal": bc == bh, "err_over_eb": r96}

    # 6. kernel times at the main path's shapes
    twoeb = 2.0 * eb_abs
    stride = int(header["anchor_stride"])
    steps = build_steps(3, 17, levels_for_stride(stride), tuple(header["splines"]), tuple(header["schemes"]))
    blocks = gather_blocks_batch_t(pad_field_batch_t(x[None]))
    del y
    nb, V = int(blocks.shape[0]), 17 ** 3
    ck, _ = interp.compress_blocks(blocks, twoeb, steps, stride, with_recon=False)  # the main path's call
    ckr, rk = interp.compress_blocks(blocks, twoeb, steps, stride)
    cp, rp = plain.compress_blocks(blocks, twoeb, steps, stride)
    enc_err = float((rk - rp).abs().max())
    enc_agree = float((ck == cp).float().mean())
    del cp, rp
    check(torch.equal(ck, ckr), "main-path shapes: encode without recon gives other codes")
    check(enc_agree >= MIN_AGREE, f"main-path shapes: codes agree kernel vs plain {enc_agree:.7f} < {MIN_AGREE}")
    # where codes disagree both recons are within eb of the field, so at most 2 eb apart
    check(enc_err <= twoeb * (1 + SLACK), f"main-path shapes: encoder recon kernel vs plain differs by {enc_err}")
    anchors, keys, vals = plain.decode_inputs(blocks, ck, stride)  # what the container gives the decoder
    dk = interp.decompress_blocks(ck, anchors, keys, vals, twoeb, steps, stride)
    dp = plain.decompress_blocks(ck, anchors, keys, vals, twoeb, steps, stride)
    dec_err = float((dk - dp).abs().max())
    check(dec_err <= eb_abs * SLACK, f"main-path shapes: decode kernel vs plain differs by {dec_err}")
    check(torch.equal(dk, rk), "main-path shapes: decode != encoder recon")
    del dk, dp, rk, ckr
    tables = interp.pack_steps(steps, stride)
    taps = tables["tapn"].astype(np.int64)
    # operations per block, per target point: 2 per tap + 2 (blend) per used dim; then
    # 5 to quantize (encode) or 2 to dequantize (decode)
    ops_pred, n_pts = 0, 0
    for k in range(tables["n_steps"]):
        for rec in tables["pts"][tables["step_off"][k]: tables["step_off"][k + 1]]:
            idx, dmask = int(rec) & 0xFFFF, int(rec) >> 16
            c = (idx // 289, (idx // 17) % 17, idx % 17)
            ops_pred += sum(2 * int(taps[k, c[d]]) + 2 for d in range(3) if dmask >> d & 1)
            n_pts += 1
    enc_ms = cuda_ms(lambda: interp.compress_blocks(blocks, twoeb, steps, stride, with_recon=False), 10)
    enc_plain = cuda_ms(lambda: plain.compress_blocks(blocks, twoeb, steps, stride), 2)
    dec_ms = cuda_ms(lambda: interp.decompress_blocks(ck, anchors, keys, vals, twoeb, steps, stride), 10)
    dec_plain = cuda_ms(lambda: plain.decompress_blocks(ck, anchors, keys, vals, twoeb, steps, stride), 2)
    seq = pipelines.decode(sections[0], device=device)  # the hf stage's input on the main path
    h_err = int((hist.histogram256(seq) - torch.bincount(seq, minlength=256)).abs().max())
    check(h_err == 0, f"main-path shapes: histogram256 differs from torch.bincount by {h_err}")
    h_ms = cuda_ms(lambda: hist.histogram256(seq), 20)
    h_plain = cuda_ms(lambda: hist.histogram256_plain(seq), 20)
    h_lib = cuda_ms(lambda: torch.bincount(seq, minlength=256), 20)

    def bound(nbytes: float, ops: float):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # encode (codes only, as the main path calls it): reads the f32 block, writes u8 codes;
    # decode: reads u8 codes, the blocks' anchors and the outliers (i64 key + f32 value),
    # writes the f32 recon
    enc_b = bound(nb * V * (4 + 1), nb * (ops_pred + 5 * n_pts))
    dec_b = bound(nb * V * (1 + 4) + anchors.numel() * 4 + keys.numel() * (8 + 4), nb * (ops_pred + 2 * n_pts))
    hist_b = bound(seq.numel() + 256 * 8, seq.numel())
    kernels = [
        {"name": "interp_encode", "route": "cuda", "source": "src/repro_torch/csrc/interp3d.cu",
         "replaces": "src/repro/kernels/interp3d/interp3d.py:61", "launches": launches["interp_encode"],
         "max_abs_err": enc_err, "ms": enc_ms, "plain_ms": enc_plain, "bound_ms": enc_b[0],
         "bound_by": enc_b[1], "library_ms": None},
        {"name": "interp_decode", "route": "cuda", "source": "src/repro_torch/csrc/interp3d.cu",
         "replaces": "src/repro/core/predictor.py:88", "launches": launches["interp_decode"],
         "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain, "bound_ms": dec_b[0],
         "bound_by": dec_b[1], "library_ms": None},
        {"name": "histogram256", "route": "cuda", "source": "src/repro_torch/csrc/histogram.cu",
         "replaces": "src/repro/kernels/histogram/histogram.py:19", "launches": launches["histogram256"],
         "max_abs_err": h_err, "ms": h_ms, "plain_ms": h_plain, "bound_ms": hist_b[0],
         "bound_by": hist_b[1], "library_ms": h_lib},
    ]
    say(f"main-path shapes: {nb} blocks of 17^3 (codes agree kernel vs plain {enc_agree:.7f}, "
        f"{keys.numel()} outlier keys), hf input {seq.numel()} bytes")
    results["kernels"] = kernels
    del blocks, ck, anchors, keys, vals, seq

    # 7. where the time goes
    results["profile"] = phase_profile(comp, x)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1, default=str))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
