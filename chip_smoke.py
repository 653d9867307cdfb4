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
     patterns and values next to rounding ties; the Huffman encode and
     decode (payload, chunk sizes and symbols exact) at ragged lengths up to
     512^3 on uniform, 90 % center-code, one-symbol and 16-bit-deep
     streams, the encode also of views at odd offsets, the decode also of
     bits at every alignment 0-15, after a bit flip, a truncation and chunk
     offsets past the stream's end, and in four threads at once;
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
     random stream of the main path's length; the Huffman encode and decode
     at the main path's hf input (no PyTorch call computes a Huffman code);
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
     reading a two-variable dataset;
  9. checkpoints and guarantees: whisper-small's parameters (published
     widths, depth cut to 1 decoder + 1 encoder layer: 34 leaves, 96,192,000
     float32 N(0, 0.02^2) from --seed on the card, and an int32 step) through
     repro_torch.checkpoint.save(eb=1e-3) and restore on the card, every
     frame within its bound and the launches of that path counted (reset
     before the save, read after the restore: the kernels line's
     launches_by_path["checkpoint"]); a profiled save of one decoder layer's
     attention and MLP w1; an AsyncCheckpointer snapshot of the state updated
     in place right after submit (its files equal the synchronous save's);
     a small tree's leaf files card == CPU, and a bit-flipped leaf restored
     under strict=False from the earlier step; the adversarial corpus x
     (abs, rel, pw_rel) holding the bound or raising a typed error on the
     card, and perturb_quant_codes repaired by verify="sample" and raising
     BoundViolationError when persistent;
 10. the compressd service on the card (repro_torch.launch.compressd): an
     in-process daemon (4 workers) takes the 512^3 field, its container
     byte-equal to phase 4's and its compress + decompress launching exactly
     the main path's kernels (the kernels line's launches_by_path
     ["compressd"]), one round trip profiled with every thread's spans; four
     tenant threads (a 256^3 Nyx-like field, a 4096^2 N(0, 0.02^2) field, a
     gemma3-12b KV page of (4*1024*8, 256), a (128, 512, 512) v3 chunk), 4
     compresses each, against 1 and then 4 workers: every container == the
     in-process one, 1 plan-cache miss and 3 hits per tenant; phase 9's
     whisper-small parameters saved twice under REPRO_COMPRESSD (single
     containers, every leaf of the second save a plan-cache hit) and
     restored without the daemon; Laplace gradients of whisper-small's leaf
     shapes quantized and packed from the card, byte-equal to the host path,
     and as 4 row shards; the CLI over a unix socket: a 96^3 container ==
     in-process, an oversize request and a damaged container typed, SIGTERM
     and exit code 0;
 11. serving (repro_torch.launch.serve, repro_torch.models): 11a the entry
     point users run, serve --arch gemma3-12b --kv-compress at its defaults
     (batch 4, prompt 32, 32 tokens) on the whole published model (48
     layers, 8.934 B fp32 parameters from seed 0), every logit finite and 12
     KV frames, launches counted (the kernels line's launches_by_path
     ["serve"]); 11b the long-prompt KV paging at gemma3-12b's published
     widths, depth cut to one group (5 local + 1 global layers), batch 4,
     prompt 4096 (blockwise prefill), 32 tokens: its 12-leaf cache (303 MB
     bf16) through _kv_roundtrip in process with the launches counted from
     before the offload to after the restore (launches_by_path["serve_kv"]),
     every frame's float32 decode within eb * (1 + 1e-4) of its leaf and the
     restored leaf equal to it cast back, greedy tokens from the restored
     and the untouched cache (reported), one profiled offload + restore of a
     local and a global layer's K (2 of the 12 leaves);
     11c the first two layers of that cache (4 of its 12 leaves) through an
     in-process daemon: every container equal to 11b's (a plan-cache hit
     carries "pcached" where the in-process one
     carries the orchestrator's "pchoice"), the restored leaves equal to
     11b's, the hits counted; 11d the ten
     architectures at .scaled(), the port's weights drawn on the CPU and
     moved to the card, prefill and 4 decode steps card vs CPU within the
     reference's own tolerances (bf16 products sum in another order there);
 12. training (repro_torch.runtime, repro_torch.optim, repro_torch.launch.train):
     12a the whole published whisper-small (12 + 12 layers, 277,976,064
     parameters from --seed) trained at the train CLI's batch 8 x seq 64:
     one warm-up step, 4 timed steps (every loss and grad norm finite, every
     parameter leaf the model reads changed, the launches of the compression
     kernels counted: the kernels line's launches_by_path["train_step"]),
     one profiled step, 4 steps on one fixed batch (the loss falls), and one
     step with remat on and off (equal losses, lower peak memory with
     remat); 12b the train CLI with --ckpt-eb 1e-3 on whisper-small at
     published widths, depth cut to 1 + 1 layers, then again with one more
     step on the same --ckpt-dir and --mesh 1,1: the second run resumes from the first
     one's final step, its restored state within every frame's bound of the
     saved one (params, AdamW m and v), the launches of both runs counted
     (launches_by_path["train_ckpt"]); 12c one train step of the ten
     architectures at .scaled() and of the compressed pod step (2 pods,
     mamba2-370m) card vs CPU: the loss, the grad norm, AdamW's m and
     every updated parameter within its elementwise bound;
 13. the device mesh (repro_torch.launch.mesh, DTensor placements,
     local_map) on a one-rank NCCL process group: 13a olmoe-1b-7b at
     published widths, depth cut to MESH_LAYERS, the plain train step
     against the mesh step in the FFN-sharded and the expert-parallel MoE
     form (the first step's loss and grad norm compared under deterministic
     kernels, then timed steps, peak memory and a profiled step each); 13b
     is 12b's second CLI run, on --mesh 1,1 (the resume places the restored
     state; the final save gathers it through rank 0); 13c the compressed
     pod step on a (1, 1, 1) pod mesh against the global view (equal int8
     payloads);
 14. the dry run (repro_torch.launch.dryrun), which touches no card: 14a the
     CLI in three subprocesses at once (mamba2-370m decode_32k on (16, 16),
     gemma3-12b prefill_32k on (2, 16, 16), olmoe-1b-7b train_4k on
     (2, 16, 16) with --compress-pods), each OK; 14b the dry run's live-bytes
     tracker over 12a's step on shape-only tensors against the card's
     max_memory_allocated of that step (within 0.8-1.25x). Every phase's
     seconds are printed at the end.
Prints one JSON line of kernels, then, as the last line,
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints no result.

The bitunshuffle kernel is held against its plain version and timed, but
no path launches it: bit1 never shrinks a stream, so the LLP2 format (the
JAX package's) stores the stage through and no decode reaches its inverse.
"""
from __future__ import annotations

import argparse
import json
import math
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
    "main": (None, ("interp_encode", "interp_decode", "histogram256", "hf_encode", "hf_decode")),
    "cusz_hi_tp": ("cusz_hi_tp", ("interp_encode", "interp_decode", "bitshuffle")),
    "fzgpu_like": ("fzgpu_like", ("lorenzo_encode", "bitshuffle")),
    "cusz_l": ("cusz_l", ("lorenzo_encode", "histogram256", "hf_encode", "hf_decode")),
    # the planner's trials launch interp_encode and histogram256, the orchestrator's tp/fz/fzh trials bitshuffle
    "cusz_hi_autoplan": ("cusz_hi_autoplan", ("interp_encode", "interp_decode", "histogram256", "bitshuffle",
                                              "hf_encode", "hf_decode")),
}
# phase 5: presets and fields whose card container must equal the CPU path's byte for byte
BYTE_EQUAL_96 = ("cusz_hi_auto", "cusz_hi_autoplan", "cusz_hi_crz", "cuszp2_like", "nonfinite")
# phase 8: the field as a v3 stream of this many chunks, and the launches one
# chunk_compress + decompress of it makes under the default spec: per chunk the
# main path's 1 encode, 1 hf histogram and hf encode, and 2 decodes (verify's and the decode's)
V3_CHUNKS = 4
V3_LAUNCHES = {"interp_encode": 4, "interp_decode": 8, "histogram256": 4, "bitshuffle": 0, "bitunshuffle": 0,
               "lorenzo_encode": 0, "hf_encode": 4, "hf_decode": 8}
GOLDEN_V3 = ("golden_v3", "golden_v3_bitflip", "golden_v3_trunc", "golden_v3_torn")
# phase 9: whisper-small (src/repro/configs/whisper_small.py, arXiv:2212.04356) at its published
# widths (d_model 768, 12 heads, d_ff 3072, vocab 51865, untied lm_head, qkv biases), depth cut
# from 12 decoder + 12 encoder layers to 1 + 1
WHISPER_SMALL = {"d_model": 768, "d_ff": 3072, "vocab": 51865, "dec_layers": 1, "enc_layers": 1}
CKPT_EB = 1e-3
# phase 10: the daemon's worker counts compared, requests per tenant, row shards
# of the packed gradient, and the CLI's drain budget (seconds)
COMPRESSD_WORKERS = (1, 4)
TENANT_REQUESTS = 4
GRAD_SHARDS = 4
CLI_DRAIN_S = 30
# phase 11: gemma3-12b (src/repro/configs/gemma3_12b.py, hf:google/gemma-3) at its published widths;
# 11b cuts its depth from 48 layers to one pattern group (5 local + 1 global) and pages the KV cache
# of a 4096-token prompt (blockwise prefill: two 2048-query tiles, the tile above the diagonal skipped)
SERVE_CUT_LAYERS = 6
SERVE_BATCH = 4
SERVE_PROMPT = 4096
SERVE_TOKENS = 32
SERVE_ARCH_STEPS = 4
# 11c sends the first layers' K and V of 11b's cache through the daemon (4 of its 12 leaves; cut in PR 21)
SERVE_DAEMON_LAYERS = 2
# phase 12: whisper-small trained whole at the train CLI's defaults (batch 8, seq 64): timed steps after one
# warm-up, steps on one fixed batch; 12b's CLI runs (depth cut to WHISPER_SMALL's 1 + 1 layers) take this many
# steps, then one more after the restore
TRAIN_BATCH = 8
TRAIN_SEQ = 64
TRAIN_STEPS = 4  # 8 until PR 21
TRAIN_FIXED = 4
CLI_STEPS = 2
# 12a: remat recomputes the forward with the same kernels; the gradients may differ only by the card's
# unordered atomic adds (the embedding's backward), so the grad norm is held to this relative difference
REMAT_GRAD_NORM_RTOL = 1e-5
# phase 13: olmoe-1b-7b (src/repro/configs/olmoe_1b_7b.py, arXiv:2409.02060) at its published widths (d_model
# 2048, 16 heads, 64 experts, top-8, d_expert 1024, vocab 50304), depth cut from 16 layers to MESH_LAYERS: the
# float32 state of the whole model (params, grads, m and v) is ~110 GB; 4 layers peaked at 62.23 GiB, above
# the 60 GiB this phase allows itself, so 3 (~1.4 B parameters); one warm-up step and MESH_STEPS timed steps,
# plain and on the mesh, at the train CLI's batch and sequence length
MESH_LAYERS = 3
MESH_STEPS = 5
# the mesh step against the plain step: the CPU tests' moe limits (tests/test_torch_mesh_step.py MESH_LIMITS):
# max |loss difference| and the grad norm's relative difference
MESH_CARD_LIMITS = (5e-4, 3e-3)


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


def whisper_small_shapes(d_model: int, d_ff: int, vocab: int, dec_layers: int, enc_layers: int) -> dict:
    """The parameter tree of repro.models.model.init_params for whisper-small,
    as float32 tensors on the ``meta`` device (shapes only): the embedding,
    the untied lm_head, the decoder stack (self attention with q/k/v biases,
    cross attention, MLP, three norms) and the encoder stack, each stack's
    layers along a leading axis."""
    import torch

    d, f = d_model, d_ff

    def t(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def attn(n):
        return {"bk": t(n, d), "bq": t(n, d), "bv": t(n, d), "wk": t(n, d, d), "wo": t(n, d, d), "wq": t(n, d, d),
                "wv": t(n, d, d)}

    def block(n, cross: bool):
        b = {"attn": attn(n), "ln1": t(n, d), "ln2": t(n, d), "mlp": {"w1": t(n, d, f), "w2": t(n, f, d)}}
        if cross:
            b.update(cross=attn(n), ln_x=t(n, d))
        return b

    return {"embed": t(vocab, d), "enc_norm": t(d), "enc_stack": [block(enc_layers, False)], "final_norm": t(d),
            "lm_head": t(d, vocab), "stack": [block(dec_layers, True)]}


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
    phase_huffman(device, g)


HF_STREAMS = ("uniform", "center90", "one", "deep")
HF_SIZES = (0, 1, 1023, 1024, 1025, 300_001, 10**6 + 3, 512**3 - 3)


def hf_stream(kind: str, n: int, g):
    """n symbols on the card for the hf kernels: uniform or 90 % center-code
    bytes (hist_stream), one symbol everywhere (a one-entry codebook), or
    symbol k with probability 2^-(k+1), whose codebook is length-limited to
    16 bits from about 10^5 symbols on."""
    import torch

    if kind == "one":
        return torch.full((n,), 128, dtype=torch.uint8, device=g.device)
    if kind == "deep":
        u = torch.rand(n, generator=g, device=g.device, dtype=torch.float64)
        return (-torch.log2(1 - u)).floor().clamp(max=255).to(torch.uint8)
    return hist_stream(kind, n, g)


def hf_codebook(data) -> tuple:
    """The host codebook of ``data`` as the engine builds it: (lens, codes,
    counts), the counts being the symbol histogram it was built from."""
    import torch

    from repro_torch.core.lossless import huffman as hf

    counts = torch.bincount(data, minlength=256).cpu().numpy()
    codes, lens, *_ = hf.canonical_codes(hf.code_lengths(counts))
    return lens, codes, counts


def hf_decode_inputs(payload, chunk_bytes, device) -> tuple:
    """hf_decode's inputs (bits, offs, lut, maxlen) from an encode's payload
    and chunk sizes, as the engine derives them from the stream's header."""
    import numpy as np
    import torch

    from repro_torch.core.lossless import huffman as hf

    _, lens, first_code, sym_table, offsets, counts = hf.canonical_codes(payload[:256].cpu().numpy())
    maxlen = int(lens.max())
    lut = torch.from_numpy(hf._pair_lut(first_code, counts, sym_table, offsets, maxlen).view(np.int16)).to(device)
    offs = np.frombuffer(hf.offset_table(chunk_bytes)["offs"], "<u4").copy()
    return payload[256 + 2 * chunk_bytes.size:], torch.from_numpy(offs).to(device), lut, maxlen


def at_alignment(t, align: int):
    """A copy of the 1-D tensor ``t`` that starts ``align`` bytes past a
    16-byte boundary."""
    import torch

    buf = torch.zeros(t.numel() + 32, dtype=t.dtype, device=t.device)
    skip = (align - buf.data_ptr()) % 16
    out = buf[skip:skip + t.numel()]
    out.copy_(t)
    check(out.data_ptr() % 16 == align, f"at_alignment: {out.data_ptr() % 16} != {align}")
    return out


def phase_huffman(device, g) -> None:
    """The hf kernels against their plain versions, byte for byte: the
    encode's payload and chunk sizes (with the symbol counts, as the engine
    calls it), the decode's symbols (== the input), on
    HF_STREAMS at HF_SIZES; the encode of views at odd offsets; the decode
    of bits at every alignment 0-15 of their 16-byte word, whole and
    truncated; the decode after a bit flip, a truncation and chunk offsets
    past the stream's end (up to the largest u32); four threads decoding
    streams of different code lengths at once, each on its own stream."""
    import numpy as np
    import torch

    from repro_torch.core.lossless import huffman as hf
    from repro_torch.kernels import huffman as khf

    deepest, aligned = 0, {}
    for kind in HF_STREAMS:
        base = hf_stream(kind, max(HF_SIZES), g)
        for n in HF_SIZES:
            x = base[:n]
            lens, codes, counts = hf_codebook(x)
            pk, cbk = khf.hf_encode(x, lens, codes, counts)
            pp, cbp = khf.hf_encode_plain(x, lens, codes)
            check(torch.equal(pk, pp) and np.array_equal(cbk, cbp), f"hf_encode != plain (n={n}, stream {kind})")
            del pp
            if n <= HF_ALIGN_SIZE:
                ref, rh = hf.encode(x.cpu().numpy())
                check(pk.cpu().numpy().tobytes() == ref and dict({"n": n}, **hf.offset_table(cbk)) == rh,
                      f"hf_encode != the host coder (n={n}, stream {kind})")
            if n == 0:
                continue
            inputs = hf_decode_inputs(pk, cbk, device)
            dk = khf.hf_decode(*inputs, n)
            check(torch.equal(dk, x), f"hf_decode(hf_encode(x)) != x (n={n}, stream {kind})")
            check(torch.equal(khf.hf_decode_plain(*inputs, n), dk), f"hf_decode != plain (n={n}, stream {kind})")
            if kind == "deep":
                deepest = max(deepest, inputs[3])
            if n == HF_ALIGN_SIZE:
                aligned[kind] = (x.clone(), inputs)
        for k in (1, 3, 7, 13):  # views at odd offsets: the lanes' shifted loads
            x = base[k:k + HF_ALIGN_SIZE]
            lens, codes, counts = hf_codebook(x)
            pk, cbk = khf.hf_encode(x, lens, codes, counts)
            pp, cbp = khf.hf_encode_plain(x, lens, codes)
            check(torch.equal(pk, pp) and np.array_equal(cbk, cbp), f"hf_encode of x[{k}:] != plain (stream {kind})")
        del base
    check(deepest == 16, f"the deep stream's longest code is {deepest} bits, not 16")
    for kind, (x, (bits, offs, lut, maxlen)) in aligned.items():
        n = int(x.numel())
        cut = bits[: bits.numel() // 2]
        plain_cut = khf.hf_decode_plain(cut, offs, lut, maxlen, n)
        for align in range(16):
            check(torch.equal(khf.hf_decode(at_alignment(bits, align), offs, lut, maxlen, n), x),
                  f"hf_decode of bits at alignment {align} != x (stream {kind})")
            check(torch.equal(khf.hf_decode(at_alignment(cut, align), offs, lut, maxlen, n), plain_cut),
                  f"hf_decode of truncated bits at alignment {align} != plain (stream {kind})")
    x = hf_stream("center90", max(HF_SIZES), g)
    n = int(x.numel())
    payload, cb = khf.hf_encode(x, *hf_codebook(x))
    bits, offs, lut, maxlen = hf_decode_inputs(payload, cb, device)
    flipped = bits.clone()
    flipped[bits.numel() // 3] ^= 0x10
    past = offs.to(torch.int64) + (torch.arange(offs.numel(), device=device) >= 2) * (1 << 20)
    past[-1] = 0xFFFFFFFF
    damaged = {"a bit flip": (flipped, offs), "a truncation": (bits[: bits.numel() // 2], offs),
               "offsets past the end": (bits, past.to(torch.uint32))}
    for label, (b, o) in damaged.items():
        dk = khf.hf_decode(b, o, lut, maxlen, n)
        check(torch.equal(dk, khf.hf_decode_plain(b, o, lut, maxlen, n)), f"hf_decode != plain after {label}")
        check(not torch.equal(dk, x), f"hf_decode after {label} gave the clean stream")
    del x, payload, bits, flipped, past
    maxlens = hf_decode_in_threads(device, aligned)
    say(f"hf_encode / hf_decode == plain byte for byte for n in {HF_SIZES}, streams {', '.join(HF_STREAMS)} "
        f"(deep: {deepest}-bit codes), == the host coder up to {HF_ALIGN_SIZE}; "
        f"hf_encode of views at offsets 1, 3, 7, 13; hf_decode of bits at alignments 0-15, whole and "
        f"truncated; hf_decode == plain after {', '.join(damaged)}; four threads decoding {maxlens}-bit codes")


HF_ALIGN_SIZE = 300_001


def hf_decode_in_threads(device, streams: dict) -> list:
    """Four threads on one card, each on its own CUDA stream, decoding the
    streams of different code lengths at once (as shard_decompress does),
    three times each; every decode == its input. Returns the maxlens."""
    import contextlib
    import threading

    import torch

    from repro_torch.kernels import huffman as khf

    jobs = sorted(streams.values(), key=lambda v: v[1][3])
    errors = []

    def run(x, inputs):
        try:
            side = torch.cuda.stream(torch.cuda.Stream(device)) if device.type == "cuda" else contextlib.nullcontext()
            with side:
                outs = [khf.hf_decode(*inputs, int(x.numel())) for _ in range(3)]
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
            if not all(torch.equal(o, x) for o in outs):
                errors.append(f"maxlen {inputs[3]}")
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    check(not errors and not any(t.is_alive() for t in threads), f"hf_decode in four threads: {errors}")
    return [inputs[3] for _, inputs in jobs]


def huffman_path_shapes(seq, iters: int) -> dict:
    """The hf kernels at the main path's hf input ``seq``: each checked
    against its plain version byte for byte, then the wrapper call timed with
    CUDA events (the encode's includes its host read of the chunk table) and
    the kernels alone by the profiler, beside the plain versions."""
    import numpy as np
    import torch

    from repro_torch.kernels import huffman as khf

    n = int(seq.numel())
    lens, codes, counts = hf_codebook(seq)
    payload, cb = khf.hf_encode(seq, lens, codes, counts)
    pp, pcb = khf.hf_encode_plain(seq, lens, codes)
    enc_err = int((payload.int() - pp.int()).abs().max()) if payload.shape == pp.shape else 255
    check(enc_err == 0 and np.array_equal(cb, pcb), f"main-path shapes: hf_encode differs from plain by {enc_err}")
    del pp
    inputs = hf_decode_inputs(payload, cb, seq.device)
    out = khf.hf_decode(*inputs, n)
    dec_err = int((out.int() - khf.hf_decode_plain(*inputs, n).int()).abs().max())
    check(dec_err == 0 and torch.equal(out, seq), f"main-path shapes: hf_decode differs from plain by {dec_err}")
    del out
    return {"n": n, "payload_bytes": int(payload.numel()), "maxlen": inputs[3], "encode_err": enc_err,
            "decode_err": dec_err,
            "encode_ms": cuda_ms(lambda: khf.hf_encode(seq, lens, codes, counts), iters),
            "encode_kernel_ms": kernel_device_ms(lambda: khf.hf_encode(seq, lens, codes, counts), "hf_", iters),
            "encode_plain_ms": cuda_ms(lambda: khf.hf_encode_plain(seq, lens, codes), 2),
            "decode_ms": cuda_ms(lambda: khf.hf_decode(*inputs, n), iters),
            "decode_kernel_ms": kernel_device_ms(lambda: khf.hf_decode(*inputs, n), "hf_decode", iters),
            "decode_plain_ms": cuda_ms(lambda: khf.hf_decode_plain(*inputs, n), 2)}


def _is_span(name: str) -> bool:
    return name.startswith(("compress.", "decompress.", "checkpoint.", "compressd.", "serve.")) or \
        name.endswith((".encode", ".decode"))


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


def profile_run(run, label: str, all_threads: bool = False, tally: dict | None = None) -> dict:
    """Profile ``run()``; returns the breakdown: per tracing span its host
    wall time and the device time of the kernels launched inside it (spans
    opened in other threads appear only with ``all_threads``, where this
    torch's profiler offers it; their kernels always do), per kernel name
    its device time, the number of device kernels and copies, and the device's busy and
    idle share of the wall time (busy: the union of the kernels' intervals,
    so kernels that overlap on several streams count once). ``tally``:
    {label: substring}; the count and device time of the kernels whose full
    name holds each substring."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if all_threads:
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            say("  (this torch's profiler records the spans of the calling thread only)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels, intervals = {}, {}, []
    tallied = {k: {"count": 0, "device_ms": 0.0} for k in tally or {}}
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
            for key, part in (tally or {}).items():
                if part in e.name:
                    tallied[key]["count"] += 1
                    tallied[key]["device_ms"] += ms
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3
    spans = sorted(spans.values(), key=lambda r: -r["host_ms"])
    kernels = sorted(kernels.values(), key=lambda r: -r["device_ms"])[:15]
    idle = 1.0 - busy_ms / wall_ms
    say(f"profile {label}: wall {wall_ms:.1f} ms, {len(intervals)} device kernels and copies, device busy {busy_ms:.1f} ms, "
        f"device idle share {idle:.3f}")
    for key, r in tallied.items():
        say(f"  kernels holding {tally[key]!r} ({key}): x{r['count']}, {r['device_ms']:.2f} ms")
    for r in spans:
        say(f"  span {r['span']:<26} x{r['count']:<3} host {r['host_ms']:9.2f} ms  device {r['device_ms']:9.2f} ms")
    for r in kernels:
        say(f"  kernel x{r['count']:<5} {r['device_ms']:9.2f} ms  {r['name']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": idle, "device_ops": len(intervals),
            "spans": spans, "kernels": kernels, "tally": tallied}


def phase_profile(comp, x, label: str, compress=None, decompress=None) -> dict:
    """Profile one compress + decompress (``compress(x)`` and
    ``decompress(buf)``, by default ``comp``'s, decoding to the device)."""
    def run():
        buf = (compress or comp.compress)(x)
        if decompress is None:
            comp.decompress(buf, out="device")
        else:
            decompress(buf)

    return profile_run(run, f"{label} (compress + decompress, {x.numel()} points)")


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
    check(all(shard_launches[k] == 4 for k in ("interp_encode", "histogram256", "interp_decode", "hf_encode",
                                                 "hf_decode")), f"v3: shard_compress launches {shard_launches}")
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


def whisper_small_state(seed: int, device) -> dict:
    """Phase 9's training state on ``device``: every whisper-small parameter
    (whisper_small_shapes at WHISPER_SMALL) drawn N(0, 0.02^2) from a
    torch.Generator seeded with ``seed``, and an int32 step."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        if isinstance(node, list):
            return [make(v) for v in node]
        return torch.randn(node.shape, generator=g, device=device, dtype=torch.float32).mul_(0.02)

    return {"params": make(whisper_small_shapes(**WHISPER_SMALL)),
            "step": torch.tensor(1000 + seed, dtype=torch.int32, device=device)}


def state_template() -> dict:
    """The restore template of phase 9's state: tensors on the meta device."""
    import torch

    return {"params": whisper_small_shapes(**WHISPER_SMALL), "step": torch.empty((), dtype=torch.int32, device="meta")}


def check_restored(state, restored, manifest: dict, step_dir: pathlib.Path, label: str) -> float:
    """Every leaf of ``restored`` against ``state``: an error-bounded leaf
    within each of its frames' bound (each frame takes rel eb of its own
    chunk of the leaf's 2-D field), the rest bit-equal. Returns the worst
    err/eb."""
    import torch

    from repro_torch.checkpoint.codec import _as_field
    from repro_torch.core.tree import leaf_paths

    worst = 0.0
    for (key, a), (key_b, b) in zip(leaf_paths(state), leaf_paths(restored)):
        check(key == key_b and b.device == a.device and b.dtype == a.dtype and b.shape == a.shape,
              f"{label}: leaf {key}: restored {key_b} {b.device} {b.dtype} {tuple(b.shape)}")
        meta = manifest["leaves"][key]
        if meta["mode"] != "cuszhi3":
            check(torch.equal(a, b), f"{label}: lossless leaf {key} differs")
            continue
        fa, fb = _as_field(a), _as_field(b)
        for lo, n, eb_abs in chunk_geometry((step_dir / meta["file"]).read_bytes()):
            if eb_abs == 0:  # a constant chunk (rows of an optimizer moment no batch reached) is stored exactly
                check(torch.equal(fa[lo: lo + n], fb[lo: lo + n]), f"{label}: leaf {key} rows {lo}-{lo + n}: constant "
                      "chunk not restored exactly")
                continue
            err = float((fa[lo: lo + n].double() - fb[lo: lo + n].double()).abs().max()) / eb_abs
            check(err <= 1 + SLACK, f"{label}: leaf {key} rows {lo}-{lo + n}: max err/eb {err}")
            worst = max(worst, err)
    return worst


def phase_checkpoint_state(device, smi: str, seed: int, directory: pathlib.Path) -> dict:
    """Phase 9a: whisper-small's parameters saved with eb and restored on the
    card, with the launch counts of that path; one more save profiled; then
    an AsyncCheckpointer snapshot of the same state, mutated in place right
    after submit."""
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.core.tree import leaf_paths
    from repro_torch.core import Compressor
    from repro_torch.kernels import launch_counts, reset_launch_counts

    state = whisper_small_state(seed, device)
    leaves = leaf_paths(state)
    n_float = sum(t.numel() for _, t in leaves if t.dtype == torch.float32)
    mb = sum(t.numel() * t.element_size() for _, t in leaves) / 1e6
    say(f"phase 9 ({smi}): whisper-small (src/repro/configs/whisper_small.py, arXiv:2212.04356) parameters at "
        f"published widths {WHISPER_SMALL} (depth cut from 12 + 12 layers to 1 + 1): {len(leaves) - 1} parameter "
        f"leaves, {n_float} float32 values ({mb:.1f} MB) + an int32 step, N(0, 0.02^2) from seed {seed}; "
        f"save(eb={CKPT_EB:g}) and restore on {device}")
    sync(device)
    peak_reset(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    manifest = ckpt.save(state, directory, 1, eb=CKPT_EB, device=device)
    sync(device)
    t_save = time.perf_counter() - t0
    save_launches = launch_counts()
    t0 = time.perf_counter()
    restored, rman = ckpt.restore(state_template(), directory, 1, device=device)
    sync(device)
    t_restore = time.perf_counter() - t0
    launches = launch_counts()
    for k in ("interp_encode", "interp_decode", "histogram256", "hf_encode", "hf_decode"):
        check(launches[k] > 0, f"checkpoint: kernel {k} was not launched on the save + restore path")
    check("salvage" not in rman, f"checkpoint: clean restore reported salvage {rman.get('salvage')}")
    worst = check_restored(state, restored, manifest, directory / "step_00000001", "checkpoint")
    n_frames = sum(m.get("n_frames", 0) for m in manifest["leaves"].values())
    modes = {}
    for m in manifest["leaves"].values():
        modes[m["mode"]] = modes.get(m["mode"], 0) + 1
    say(f"  save {t_save:.3f} s ({mb / t_save:.1f} MB/s), restore {t_restore:.3f} s ({mb / t_restore:.1f} MB/s), "
        f"CR {manifest['cr']} ({manifest['raw_bytes']} -> {manifest['compressed_bytes']} bytes), {n_frames} v3 frames, "
        f"leaf modes {modes}, max err/eb {worst:.7f}, peak device memory {peak_gib(device):.2f} GiB ({smi})")
    say(f"  launches: save {save_launches}; save + restore {launches}")
    out = {"model": "whisper-small", "widths": WHISPER_SMALL, "leaves": len(leaves), "float32_values": n_float,
           "mb": mb, "eb": CKPT_EB, "save_s": t_save, "restore_s": t_restore, "save_mbps": mb / t_save,
           "restore_mbps": mb / t_restore, "cr": manifest["cr"], "raw_bytes": manifest["raw_bytes"],
           "compressed_bytes": manifest["compressed_bytes"], "frames": n_frames, "modes": modes,
           "err_over_eb": worst, "launches": launches, "save_launches": save_launches,
           "pipelines": sorted({f["pipeline"] for m in manifest["leaves"].values() if m["mode"] == "cuszhi3"
                                for f in Compressor.inspect((directory / "step_00000001" / m["file"]).read_bytes())
                                ["frames"]})}
    say(f"  frame pipelines chosen: {out['pipelines']}")
    # the profiler's own parse costs seconds per frame (tens of thousands of host
    # events each), so one decoder layer's self-attention and first MLP matrix
    # (7 frames, 10 leaves) stand for the state's 100 frames
    layer = state["params"]["stack"][0]
    part = {"attn": layer["attn"], "mlp_w1": layer["mlp"]["w1"]}
    out["profile_save"] = profile_run(lambda: ckpt.save(part, directory / "profiled", 1, eb=CKPT_EB, device=device),
                                      "checkpoint.save of the decoder layer's attention and MLP w1 (7 frames)")
    # AsyncCheckpointer: the snapshot is taken at submit; an optimizer-like in-place
    # update right after it must not reach the saved state
    saver = ckpt.AsyncCheckpointer(directory, eb=CKPT_EB, device=device)
    sync(device)
    t0 = time.perf_counter()
    saver.submit(state, 2)
    t_submit = time.perf_counter() - t0
    for _, t in leaves:
        t.add_(1)
    t0 = time.perf_counter()
    saver.close(timeout=900)
    t_close = time.perf_counter() - t0
    step1, step2 = directory / "step_00000001", directory / "step_00000002"
    for key, meta in manifest["leaves"].items():
        check((step1 / meta["file"]).read_bytes() == (step2 / meta["file"]).read_bytes(),
              f"async: leaf {key} of the snapshot differs from the synchronous save of the same state")
    restored2, _ = ckpt.restore(state_template(), directory, 2, device=device)
    for (key, a), (_, b) in zip(leaf_paths(restored), leaf_paths(restored2)):
        check(torch.equal(a, b), f"async: restored leaf {key} != the synchronous save's restore")
    del restored, restored2
    say(f"  AsyncCheckpointer: submit blocked {t_submit * 1e3:.1f} ms (pinned host copies of {mb:.1f} MB queued), "
        f"the state then updated in place (+1 on every leaf); close waited {t_close:.3f} s; the saved leaves == "
        f"the synchronous save's byte for byte, and restore to the same tensors")
    out.update(async_submit_ms=t_submit * 1e3, async_close_s=t_close)
    return out


def phase_checkpoint_small(device, directory: pathlib.Path) -> dict:
    """Phase 9b: a small tree saved on the card and on the CPU (the leaf files
    and manifests byte-equal), then a leaf of a later step damaged
    (repro_torch.testing.faults.bit_flip) and restored under strict=False
    from the earlier step."""
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.testing import bit_flip

    xs = smooth_big()[0]  # 96 x 96: the error-bounded path
    tree = {"w": torch.from_numpy(xs).to(device), "b": torch.arange(40, dtype=torch.int32, device=device),
            "h": torch.linspace(-2, 2, 24, device=device).to(torch.bfloat16), "lr": 3e-4, "none": None}
    files = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        d = directory / name
        ckpt.save(tree, d, 1, eb=CKPT_EB, device=dev)
        files[name] = {f.name: f.read_bytes() for f in sorted((d / "step_00000001").iterdir())}
    check(files["card"] == files["cpu"], "checkpoint: card and cpu leaf files differ: "
          + str([k for k in files["card"] if files["card"].get(k) != files["cpu"].get(k)]))
    d = directory / "card"
    m2 = ckpt.save(tree, d, 2, eb=CKPT_EB, device=device)
    wfile = d / "step_00000002" / m2["leaves"]["w"]["file"]
    buf = wfile.read_bytes()
    wfile.write_bytes(bit_flip(buf, len(buf) // 2, 6))
    out, man = ckpt.restore(tree, d, 2, device=device, strict=False)
    sal = man.get("salvage", {})
    check(list(sal.get("damaged", {})) == ["w"] and sal["fallback_steps"] == {"w": 1} and sal["lost"] == [],
          f"checkpoint: salvage {sal}")
    ref, _ = ckpt.restore(tree, d, 1, device=device)
    check(all(torch.equal(out[k], ref[k]) for k in ("w", "b", "h")), "checkpoint: salvaged leaves != step 1's")
    say(f"  small tree: card and cpu leaf files byte-equal ({len(files['card'])} files, modes "
        f"{sorted({m['mode'] for m in m2['leaves'].values()})}); a bit flip in step 2's w restored under "
        f"strict=False from step 1: salvage {sal['fallback_steps']}, damaged {list(sal['damaged'])}")
    return {"files": len(files["card"]), "salvage": sal}


def phase_guarantees(device) -> dict:
    """Phase 9c: the adversarial corpus x {abs, rel, pw_rel} (verify=full)
    holds the bound or raises a typed error on the card; an injected encoder
    fault (perturb_quant_codes) is repaired by verify="sample", kept by
    verify="off", and a persistent one raises BoundViolationError."""
    import numpy as np

    from repro_torch.core import Compressor, CompressorSpec
    from repro_torch.core.errors import BoundViolationError, SpecError
    from repro_torch.testing import CORPUS, corpus_field, fault_rng, fault_seed, perturb_quant_codes

    outcomes = {}
    for name in sorted(CORPUS):
        x = corpus_field(name, seed=fault_seed())
        for spec_str in ("lossy,abs,1e-2,verify=full", "lossy,rel,1e-3,verify=full", "lossy,pw_rel,1e-2,verify=full"):
            sp = CompressorSpec.from_string(spec_str)
            comp = Compressor(sp, device=device)
            try:
                buf = comp.compress(x)
            except (ValueError, SpecError, BoundViolationError) as e:
                outcomes[f"{name} {sp.eb_mode}"] = type(e).__name__
                continue
            y = comp.decompress(buf)
            fin = np.isfinite(x)
            check(np.array_equal(x[~fin].view(np.uint32), y[~fin].view(np.uint32)) and np.isfinite(y[fin]).all(),
                  f"corpus {name} {spec_str}: non-finite points not restored bit for bit")
            xf, yf = x[fin].astype(np.float64), y[fin].astype(np.float64)
            if xf.size:
                if sp.eb_mode == "abs":
                    err = np.abs(xf - yf).max() / sp.eb
                elif sp.eb_mode == "rel":
                    err = np.abs(xf - yf).max() / max(sp.eb * (xf.max() - xf.min()), 1e-30)
                else:
                    zero = xf == 0.0
                    check(np.array_equal(x[fin][zero].view(np.uint32), y[fin][zero].view(np.uint32)),
                          f"corpus {name} pw_rel: zeros not exact")
                    err = (np.abs(xf - yf)[~zero] / np.abs(xf[~zero])).max() / sp.eb if (~zero).any() else 0.0
                check(err <= 1 + 2e-4, f"corpus {name} {spec_str}: max err/eb {err}")
            outcomes[f"{name} {sp.eb_mode}"] = "held"
    rng = fault_rng()
    x = rng.standard_normal((32, 32, 32))
    for ax in range(3):
        x = np.cumsum(x, axis=ax)
    x = (x / max(1.0, float(np.max(np.abs(x))))).astype(np.float32)
    xr = float(x.max()) - float(x.min())
    comp = Compressor(CompressorSpec(eb=1e-3, verify="sample"), device=device)
    with perturb_quant_codes(n_calls=1, delta=8, frac=0.02) as stats:
        buf = comp.compress(x)
    repairs = comp.last_telemetry["verify"]["repairs"]
    err = float(np.abs(comp.decompress(buf).astype(np.float64) - x).max()) / (1e-3 * xr)
    check(stats["perturbed"] > 0 and repairs >= 1 and err <= 1 + 2e-4,
          f"fault: perturbed {stats['perturbed']}, repairs {repairs}, err/eb {err}")
    off = Compressor(CompressorSpec(eb=1e-3, verify="off"), device=device)
    with perturb_quant_codes(n_calls=1, delta=8, frac=0.02) as stats_off:
        err_off = float(np.abs(off.decompress(off.compress(x)).astype(np.float64) - x).max()) / (1e-3 * xr)
    check(err_off > 1, f"fault with verify=off: err/eb {err_off} (the injected violation did not show)")
    try:
        with perturb_quant_codes(n_calls=99, delta=16, frac=0.05):
            comp.compress(x)
        raise SmokeFailure("a persistent encoder fault did not raise BoundViolationError")
    except BoundViolationError as e:
        persistent = {"repairs": e.repairs, "max_err": e.max_err, "bound": e.bound}
    held = sum(v == "held" for v in outcomes.values())
    say(f"  guarantees on {device}: the corpus x (abs, rel, pw_rel) held the bound in {held} cells and raised a "
        f"typed error in {len(outcomes) - held} ({ {k: v for k, v in outcomes.items() if v != 'held'} }); "
        f"perturb_quant_codes: {stats['perturbed']} codes perturbed, verify=sample repaired it in {repairs} "
        f"rung(s) (err/eb {err:.7f}), verify=off kept it (err/eb {err_off:.2f}, {stats_off['perturbed']} "
        f"codes), a persistent fault raised BoundViolationError after {persistent['repairs']} repairs")
    return {"corpus": outcomes, "perturbed": stats["perturbed"], "repairs": repairs, "err_over_eb": err,
            "off_err_over_eb": err_off, "persistent": persistent}


def phase_checkpoint(device, smi: str, seed: int) -> dict:
    """Phase 9: checkpoints and guarantees on the card."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        out = phase_checkpoint_state(device, smi, seed, pathlib.Path(d) / "state")
        out["small"] = phase_checkpoint_small(device, pathlib.Path(d) / "small")
    out["guarantees"] = phase_guarantees(device)
    return out


# ------------------------------------------------------------------ phase 10
def socket_dir() -> str:
    """A fresh directory for unix sockets, short enough for AF_UNIX's 107-byte paths."""
    import tempfile

    base = tempfile.gettempdir()
    return tempfile.mkdtemp(prefix="cpd", dir=base if len(base) <= 60 else "/tmp")


def phase_daemon_field(srv, x, buf_main: bytes, main: dict, smi: str) -> dict:
    """Phase 10a: the field through the in-process daemon ``srv`` on the
    card: one compress + decompress with the launch counts reset just before
    and read just after (they must equal the main path's), the container
    byte-equal to phase 4's in-process one, the decode within the bound;
    then one more round trip profiled, every thread's spans recorded."""
    import numpy as np
    import torch

    from repro_torch.core import Compressor
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.compressd import CompressdClient

    device = x.device
    mb = x.numel() * 4 / 1e6
    with CompressdClient(srv.address, stream="field", timeout=600) as c:
        check(c.ping(), "compressd: no pong")
        sync(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        buf = c.compress(x)  # the card tensor goes to the host once, then over the socket
        t_c = time.perf_counter() - t0
        info_c = dict(c.last_info)
        t0 = time.perf_counter()
        y = c.decompress(buf)
        t_d = time.perf_counter() - t0
        info_d = dict(c.last_info)
        launches = launch_counts()
        check(buf == buf_main, "compressd: the daemon's container differs from the in-process Compressor().compress")
        check(launches == main["launches"], f"compressd: launches {launches} != the main path's {main['launches']}")
        check(info_c["fallbacks"] == 0, f"compressd: fallbacks {info_c['fallbacks']}")
        eb_abs = Compressor.inspect(buf)["eb_abs"]
        yt = torch.from_numpy(y).to(device)
        check(tuple(yt.shape) == tuple(x.shape) and y.dtype == np.float32, f"compressd: decoded {y.shape} {y.dtype}")
        err = float((yt.double() - x.double()).abs().max()) / eb_abs
        del yt, y
        check(err <= 1 + SLACK, f"compressd: max err/eb {err}")
        say(f"  10a 512^3 through the daemon (workers=4, {smi}): compress {t_c:.3f} s ({mb / t_c:.1f} MB/s; the "
            f"daemon's compress {info_c['seconds']:.3f} s, plan cache {info_c['plan_cache']}), decompress {t_d:.3f} s "
            f"({mb / t_d:.1f} MB/s; the daemon's {info_d['seconds']:.3f} s); in process {main['compress_s']:.3f} / "
            f"{main['decompress_s']:.3f} s; socket and copies {1 - info_c['seconds'] / t_c:.3f} / "
            f"{1 - info_d['seconds'] / t_d:.3f} of the walls; container == in-process, err/eb {err:.7f}, "
            f"launches {launches} (== main)")
        prof = profile_run(lambda: c.decompress(c.compress(x)),
                           "compressd round trip of the 512^3 field (plan cache hit; every thread)", all_threads=True)
    return {"compress_s": t_c, "decompress_s": t_d, "compress_mbps": mb / t_c, "decompress_mbps": mb / t_d,
            "daemon_compress_s": info_c["seconds"], "daemon_decompress_s": info_d["seconds"],
            "socket_share_compress": 1 - info_c["seconds"] / t_c, "socket_share_decompress": 1 - info_d["seconds"] / t_d,
            "in_process_compress_s": main["compress_s"], "in_process_decompress_s": main["decompress_s"],
            "err_over_eb": err, "launches": launches, "profile": prof}


def tenant_fields(x, seed: int) -> dict:
    """Phase 10b's four tenants, host arrays made on the card from ``seed``: a
    256^3 Nyx-like field; a (4096, 4096) checkpoint-like field N(0, 0.02^2);
    a KV page of gemma3-12b's local layers (src/repro/configs/gemma3_12b.py:
    batch 4 x window 1024 x 8 KV heads rows of d_head 256), Nyx-recipe
    values; and a (128, 512, 512) v3 chunk of the 512^3 field."""
    import torch

    device = x.device
    g = torch.Generator(device=device).manual_seed(seed + 10)
    fields = {"nyx256": nyx_like(256, seed + 11, device),
              "ckpt4096": torch.randn((4096, 4096), generator=g, device=device).mul_(0.02),
              "kv_page": nyx_like(256, seed + 12, device)[:128].reshape(4 * 1024 * 8, 256),
              "v3_chunk": x[:128]}
    return {k: v.cpu().numpy() for k, v in fields.items()}


def phase_tenants(fields: dict, refs: dict, device, workers: int, smi: str) -> dict:
    """Phase 10b: four client threads, a stream each, TENANT_REQUESTS
    compresses each, against a fresh daemon of ``workers`` workers: every
    container == the tenant's in-process one, the plan cache missed once and
    hit TENANT_REQUESTS - 1 times per tenant; the last container of each
    decoded by the daemon within the bound."""
    import threading

    import numpy as np

    from repro_torch.core import Compressor
    from repro_torch.launch.compressd import CompressdClient, CompressdServer

    got, errors = {}, []

    def tenant(name):
        try:
            with CompressdClient(srv.address, stream=name, timeout=600) as c:
                got[name] = [c.compress(fields[name]) for _ in range(TENANT_REQUESTS)]
        except Exception as e:  # reported by the check below
            errors.append((name, repr(e)))

    with CompressdServer("127.0.0.1:0", workers=workers, device=device).start() as srv:
        threads = [threading.Thread(target=tenant, args=(name,), name=f"tenant-{name}") for name in fields]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), f"tenants: {t.name} still running after 600 s")
        wall = time.perf_counter() - t0
        check(not errors, f"tenants: {errors}")
        st = srv.stats()
        worst = 0.0
        with CompressdClient(srv.address, timeout=600) as c:
            for name, x in fields.items():
                y = c.decompress(got[name][-1]).astype(np.float64)
                worst = max(worst, float(np.abs(y - x).max()) / Compressor.inspect(got[name][-1])["eb_abs"])
        check(worst <= 1 + SLACK, f"tenants: max err/eb {worst}")
    out = {"workers": workers, "wall_s": wall, "streams": {}}
    mb_total = 0.0
    for name, x in fields.items():
        rec = st["streams"][name]
        check(all(b == refs[name] for b in got[name]), f"tenants: {name}: a daemon container != the in-process one")
        check((rec["plan_cache_misses"], rec["plan_cache_hits"]) == (1, TENANT_REQUESTS - 1),
              f"tenants: {name}: plan cache misses/hits {rec['plan_cache_misses']}/{rec['plan_cache_hits']}")
        out["streams"][name] = {k: rec[k] for k in ("requests", "plan_cache_hits", "plan_cache_misses", "cr", "mbps",
                                                    "seconds")}
        mb_total += TENANT_REQUESTS * x.nbytes / 1e6
    out["mbps"] = mb_total / wall
    say(f"  10b tenants, workers={workers} ({smi}): {TENANT_REQUESTS} requests each, wall {wall:.3f} s "
        f"({out['mbps']:.1f} MB/s over all), containers == in-process, decode err/eb {worst:.7f}")
    for name, rec in out["streams"].items():
        say(f"    {name:<9} {fields[name].shape}: CR {rec['cr']:.4f}, {rec['mbps']:.1f} MB/s in the daemon, "
            f"plan cache {rec['plan_cache_misses']} miss / {rec['plan_cache_hits']} hits")
    return out


def phase_daemon_checkpoint(addr: str, device, smi: str, seed: int, in_process: dict) -> dict:
    """Phase 10c: phase 9's whisper-small parameters saved twice under
    REPRO_COMPRESSD=addr and restored without it: every error-bounded leaf a
    single container (mode "cuszhi"), every one of the second save a plan
    cache hit, every leaf within its bound, both steps the same tensors."""
    import os
    import tempfile

    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.core.tree import leaf_paths
    from repro_torch.core import Compressor

    state = whisper_small_state(seed, device)
    leaves = leaf_paths(state)
    mb = sum(t.numel() * t.element_size() for _, t in leaves) / 1e6
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cpd_") as d:
        d = pathlib.Path(d)
        before = os.environ.get("REPRO_COMPRESSD")
        os.environ["REPRO_COMPRESSD"] = addr
        try:
            mans, walls = [], []
            for step in (1, 2):
                sync(device)
                t0 = time.perf_counter()
                mans.append(ckpt.save(state, d, step, eb=CKPT_EB, device=device))
                sync(device)
                walls.append(time.perf_counter() - t0)
        finally:
            if before is None:
                del os.environ["REPRO_COMPRESSD"]
            else:
                os.environ["REPRO_COMPRESSD"] = before
        t0 = time.perf_counter()
        r1, _ = ckpt.restore(state_template(), d, 1, device=device)
        sync(device)
        t_restore = time.perf_counter() - t0
        r2, _ = ckpt.restore(state_template(), d, 2, device=device)
        eb_keys = [k for k, m in mans[1]["leaves"].items() if m["mode"] != "zlib" and m["mode"] != "zstd"]
        check(eb_keys and all(mans[s]["leaves"][k]["mode"] == "cuszhi" for s in (0, 1) for k in eb_keys),
              f"checkpoint via compressd: leaf modes {[mans[1]['leaves'][k]['mode'] for k in eb_keys]}")
        outcomes = [[mans[s]["leaves"][k]["compressd"]["plan_cache"] for k in eb_keys] for s in (0, 1)]
        check(all(o == "hit" for o in outcomes[1]), f"checkpoint via compressd: second save's plan cache {outcomes[1]}")
        worst = 0.0
        for (key, a), (_, b), (_, b2) in zip(leaves, leaf_paths(r1), leaf_paths(r2)):
            check(torch.equal(b, b2), f"checkpoint via compressd: leaf {key} of step 1 != step 2")
            meta = mans[0]["leaves"][key]
            if meta["mode"] != "cuszhi":
                check(torch.equal(a, b), f"checkpoint via compressd: lossless leaf {key} differs")
                continue
            eb_abs = Compressor.inspect((d / "step_00000001" / meta["file"]).read_bytes())["eb_abs"]
            err = float((a.double() - b.double()).abs().max()) / eb_abs
            check(err <= 1 + SLACK, f"checkpoint via compressd: leaf {key}: max err/eb {err}")
            worst = max(worst, err)
        del r1, r2
    say(f"  10c whisper-small parameters ({mb:.1f} MB, {len(eb_keys)} error-bounded leaves as single containers) "
        f"through the daemon ({smi}): save 1 {walls[0]:.3f} s (plan cache {sorted(set(outcomes[0]))}), save 2 "
        f"{walls[1]:.3f} s (all hits), restore without the daemon {t_restore:.3f} s, CR {mans[1]['cr']}, max err/eb "
        f"{worst:.7f}; in process (phase 9, v3 frames): save {in_process['save_s']:.3f} s, restore "
        f"{in_process['restore_s']:.3f} s, CR {in_process['cr']}")
    return {"save1_s": walls[0], "save2_s": walls[1], "restore_s": t_restore, "cr": mans[1]["cr"],
            "eb_leaves": len(eb_keys), "err_over_eb": worst, "save1_plan_cache": outcomes[0],
            "in_process_save_s": in_process["save_s"], "in_process_restore_s": in_process["restore_s"]}


def laplace_grads(seed: int, device) -> list:
    """(key, tensor) per leaf of whisper-small's parameter shapes: Laplace(0,
    1e-3) values drawn on ``device`` by the inverse CDF from ``seed``."""
    import torch

    from repro_torch.core.tree import leaf_paths

    g = torch.Generator(device=device).manual_seed(seed + 20)
    out = []
    for key, t in leaf_paths(whisper_small_shapes(**WHISPER_SMALL)):
        u = torch.rand(t.shape, generator=g, device=device) - 0.5
        out.append((key, -1e-3 * torch.sign(u) * torch.log1p(-2 * u.abs())))
    return out


def phase_grad_packer(device, seed: int, smi: str) -> dict:
    """Phase 10d: every leaf's gradient quantized on the card and packed
    (pipeline="auto") from the card tensor: the bytes == the same call on a
    host copy, unpack gives the int8 and the scale exactly; the lm_head's
    codes as 4 row shards on the card reassemble exactly, frames=[0] only
    its slice."""
    import struct

    import numpy as np
    import torch

    from repro_torch.core.serial import unpack_obj
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import (pack_quantized, pack_quantized_sharded, quantize_shard, unpack_quantized,
                                   unpack_quantized_sharded)

    grads = laplace_grads(seed, device)
    n_int8 = packed = 0
    t_card = t_host = 0.0
    chosen = {}
    reset_launch_counts()
    for key, gt in grads:
        q, scale = quantize_shard(gt)
        sync(device)
        t0 = time.perf_counter()
        buf = pack_quantized(q, scale)
        t_card += time.perf_counter() - t0
        qh = q.cpu().numpy()
        t0 = time.perf_counter()
        ref = pack_quantized(qh, scale.cpu())
        t_host += time.perf_counter() - t0
        check(buf == ref, f"grad packer: leaf {key}: card bytes != host bytes")
        q2, s2 = unpack_quantized(buf)
        check(np.array_equal(q2, qh) and s2 == float(scale), f"grad packer: leaf {key}: unpack differs")
        (hlen,) = struct.unpack_from("<I", buf, 0)
        name = unpack_obj(buf[4:4 + hlen])["pipeline"]
        chosen[name] = chosen.get(name, 0) + 1
        n_int8 += qh.nbytes
        packed += len(buf)
    launches = launch_counts()
    lm = dict(grads)["lm_head"]
    q, scale = quantize_shard(lm)
    rows = q.shape[0] // GRAD_SHARDS
    shards = [((slice(i * rows, (i + 1) * rows), slice(None)), q[i * rows:(i + 1) * rows]) for i in range(GRAD_SHARDS)]
    sbuf = pack_quantized_sharded(shards, scale)
    full, s_full = unpack_quantized_sharded(sbuf)
    qh = q.cpu().numpy()
    check(np.array_equal(full, qh) and s_full == float(scale), "grad packer: the sharded payload does not reassemble")
    part, _ = unpack_quantized_sharded(sbuf, frames=[0])
    check(np.array_equal(part[:rows], qh[:rows]) and not part[rows:].any(), "grad packer: frames=[0] filled more")
    say(f"  10d gradient packer ({smi}): {len(grads)} leaves of whisper-small's shapes, Laplace(0, 1e-3) from seed "
        f"{seed + 20}: {n_int8} int8 bytes packed to {packed} ({n_int8 / packed:.4f}x), pipelines {chosen}; from the "
        f"card {t_card:.3f} s ({n_int8 / t_card / 1e6:.1f} MB/s of int8), from the host {t_host:.3f} s "
        f"({n_int8 / t_host / 1e6:.1f} MB/s), bytes equal; launches {launches}; lm_head as {GRAD_SHARDS} row shards "
        f"on {device} reassembled ({len(sbuf)} bytes), frames=[0] only its slice")
    return {"int8_bytes": n_int8, "packed_bytes": packed, "card_s": t_card, "host_s": t_host,
            "card_mbps": n_int8 / t_card / 1e6, "host_mbps": n_int8 / t_host / 1e6, "pipelines": chosen,
            "launches": launches, "sharded_bytes": len(sbuf)}


def phase_cli(device, xs, smi: str) -> dict:
    """Phase 10e: ``python -m repro_torch.launch.compressd`` on the card over a
    unix socket: a 96^3 compress == in-process, an oversize request typed and
    the connection alive, a damaged v3 container typed as a ContainerError
    subclass, then SIGTERM and exit code 0 within the drain budget."""
    import os
    import shutil
    import signal

    import numpy as np

    from repro_torch.core import Compressor, chunk_compress, frames
    from repro_torch.core.errors import ContainerError, RequestTooLargeError
    from repro_torch.launch.compressd import CompressdClient, wait_ready

    d = socket_dir()
    addr = f"unix:{d}/cpd.sock"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + (
        [os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.compressd", "--addr", addr, "--workers", "4",
                             "--max-request-mb", "4", "--drain-s", str(CLI_DRAIN_S), "--device", str(device)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        wait_ready(addr, timeout=120)
        t_ready = time.perf_counter() - t0
        with CompressdClient(addr, timeout=120) as c:
            buf = c.compress(xs)
            check(buf == Compressor(device=device).compress(xs), "cli: the 96^3 container != in-process")
            try:
                c.compress(np.zeros((128, 128, 128), np.float32))
                raise SmokeFailure("cli: an 8 MiB request under a 4 MiB cap was not rejected")
            except RequestTooLargeError:
                pass
            check(c.ping(), "cli: the connection did not survive the rejection")
            v3 = bytearray(chunk_compress(xs, n_chunks=4, device=device))
            off, size, _ = frames.frame_table(bytes(v3))[1][1]
            v3[off + size // 2] ^= 1 << 2
            try:
                c.decompress(bytes(v3))
                raise SmokeFailure("cli: a damaged container decoded")
            except ContainerError as e:
                check(type(e) is not ContainerError, "cli: the damage came back untyped")
                damage = type(e).__name__
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=CLI_DRAIN_S + 30)
        t_exit = time.perf_counter() - t0
        printed = proc.stdout.read()
        check(rc == 0, f"cli: exit code {rc} after SIGTERM: {printed}")
        banner = next((ln for ln in printed.splitlines() if "compressd listening on" in ln), "")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        shutil.rmtree(d, ignore_errors=True)
    say(f"  10e CLI ({smi}): '{banner}', ready {t_ready:.1f} s after the start; 96^3 container == in-process; "
        f"oversize -> RequestTooLargeError, then ping; a bit flip in frame 1 -> {damage}; SIGTERM -> exit 0 in "
        f"{t_exit:.2f} s")
    return {"ready_s": t_ready, "exit_s": t_exit, "damage_error": damage, "banner": banner}


def phase_compressd(x, buf_main: bytes, main: dict, ckpt_in_process: dict, xs, smi: str, seed: int) -> dict:
    """Phase 10: the compressd service on the card."""
    from repro_torch.core import Compressor
    from repro_torch.launch.compressd import CompressdServer

    device = x.device
    t10 = time.perf_counter()
    say(f"phase 10 ({smi}): the compressd service on {device}")
    out = {}
    with CompressdServer("127.0.0.1:0", workers=4, max_request_bytes=512 << 20, device=device).start() as srv:
        out["field"] = phase_daemon_field(srv, x, buf_main, main, smi)
        out["checkpoint"] = phase_daemon_checkpoint(srv.address, device, smi, seed, ckpt_in_process)
    fields = tenant_fields(x, seed)
    refs = {name: Compressor(device=device).compress(f) for name, f in fields.items()}
    out["tenants"] = {w: phase_tenants(fields, refs, device, w, smi) for w in COMPRESSD_WORKERS}
    del fields, refs
    out["grad_packer"] = phase_grad_packer(device, seed, smi)
    out["cli"] = phase_cli(device, xs, smi)
    out["wall_s"] = time.perf_counter() - t10
    say(f"phase 10 took {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 11
def serve_cache_leaves(cache) -> list:
    """(name, tensor) of every leaf of a cache, in the JAX package's order."""
    from repro_torch.core.tree import leaf_paths

    return leaf_paths(cache)


def kv_roundtrip_recorded(cache, **kwargs) -> tuple:
    """``serve._kv_roundtrip`` of ``cache`` at the default KV spec, with
    serve's FrameWriter swapped for a subclass that keeps the file its
    stream went to: (restored cache, stats, the stream's bytes)."""
    from repro_torch.launch import serve

    files = []

    class Writer(serve.FrameWriter):
        def __init__(self, f, *args, **kw):
            files.append(f)
            super().__init__(f, *args, **kw)

    real, serve.FrameWriter = serve.FrameWriter, Writer
    try:
        restored, stats = serve._kv_roundtrip(cache, serve.DEFAULT_KV_SPEC, **kwargs)
    finally:
        serve.FrameWriter = real
    return restored, stats, files[0].getvalue()


def greedy_tokens(params, cfg, first, cache, pos0: int, steps: int):
    """``steps`` greedy tokens decoded from ``cache`` (updated in place),
    starting with ``first``; (B, steps) on the host."""
    import torch

    from repro_torch.models import decode_step

    tok, out = first, [first]
    for i in range(steps - 1):
        logits, cache = decode_step(params, cfg, tok, pos0 + i, cache)
        tok = logits.argmax(-1)
        out.append(tok)
    return torch.stack(out, 1).cpu()


def phase_serve_entry(device, smi: str) -> dict:
    """Phase 11a: ``repro_torch.launch.serve`` as users run it, on the whole
    published gemma3-12b, at its defaults (batch 4, prompt 32, 32 tokens),
    with --kv-compress: ``main`` is ``run`` returning what it prints. Then
    one more decode step from the state it ended in, profiled."""
    import torch

    from repro_torch.configs import get_config, param_count
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import decode_step

    argv = ["--arch", "gemma3-12b", "--kv-compress"]
    cfg = get_config("gemma3-12b")
    say(f"  11a: serve {' '.join(argv)} on {device} ({smi}): gemma3-12b at full width, {cfg.n_layers} layers "
        f"({cfg.n_groups} groups of 5 local + 1 global), d_model {cfg.d_model}, vocab {cfg.vocab}, "
        f"{param_count(cfg) / 1e9:.3f} B parameters ({param_count(cfg) * 4 / 1e9:.1f} GB float32)")
    sync(device)
    peak_reset(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    r = serve.run(argv)
    sync(device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = peak_gib(device)
    kv = r["kv"]
    check(r["logits_finite"], "11a: a non-finite logit")
    check(r["tokens"].shape == (4, 32), f"11a: tokens {r['tokens'].shape}")
    check(kv is not None and kv["frames"] == 12 and "damage" not in kv, f"11a: kv stats {kv}")
    total = 32 + 32  # prompt + tokens: every layer's capacity (gemma3's window is 1024)
    want = sum(2 * cfg.n_groups * 4 * min(cfg.window if kind == "local" else total, total) * cfg.n_kv_heads
               * cfg.d_head * 2 for kind in cfg.pattern)
    check(kv["raw_bytes"] == want, f"11a: raw bytes {kv['raw_bytes']} != {want}")
    for k in ("interp_encode", "interp_decode", "histogram256", "hf_encode", "hf_decode"):
        check(launches[k] > 0, f"11a: kernel {k} was not launched")
    tok_s = 32 * 4 / r["decode_s"]
    say(f"  11a done in {wall:.1f} s ({smi}): prefill {r['prefill_s'] * 1e3:.1f} ms, kv offload+restore "
        f"{r['kv_s']:.3f} s (CR {kv['cr']:.4f}, {kv['raw_bytes']} B in 12 frames, pipelines {kv['pipelines']}), "
        f"decode {r['decode_s'] * 1e3:.1f} ms ({tok_s:.1f} tok/s), peak device memory {peak:.2f} GiB; "
        f"launches {launches}")
    # one more greedy step from the state decoding ended in, profiled: its
    # kernels, each fp32 master's cast to bf16 at its matmul, and the other
    # copies (activation casts, cache writes)
    tok = torch.from_numpy(r["tokens"][:, -1]).to(device)
    step = profile_run(lambda: decode_step(r["params"], r["cfg"], tok, 32 + 31, r["cache"]),
                       "11a one decode step (gemma3-12b, batch 4, position 63)",
                       tally={"casts to bf16": "bfloat16_copy_kernel", "other copies": "direct_copy_kernel"})
    out = {"wall_s": wall, "prefill_s": r["prefill_s"], "kv_s": r["kv_s"], "decode_s": r["decode_s"],
           "decode_tok_s": tok_s, "peak_gib": peak, "kv": kv, "launches": launches,
           "params": param_count(cfg), "tokens": r["tokens"][0, :16].tolist(), "decode_step_profile": step}
    del r
    torch.cuda.empty_cache()
    return out


def check_kv_frames(stream: bytes, cache, restored, label: str) -> float:
    """Every frame of ``stream`` decoded to float32 on the card lies within
    eb * (1 + 1e-4) of its leaf's float32 value (eb from the leaf's own
    value range), and the restored leaf is that decode cast back."""
    import io

    import torch

    from repro_torch.core import Compressor, frames
    from repro_torch.launch.serve import _pages

    leaves = [t for _, t in serve_cache_leaves(cache)]
    back = [t for _, t in serve_cache_leaves(restored)]
    framed = [i for i, t in enumerate(leaves) if _pages(t)]
    comp = Compressor(device=leaves[0].device)
    worst, n = 0.0, 0
    for k, frame in frames.FrameReader(io.BytesIO(stream)).iter_frames():
        i = framed[k]
        x = leaves[i].float()
        y = comp.decompress(frame, out="device").reshape(x.shape)
        eb_abs = 1e-3 * (float(x.max()) - float(x.min()))
        check(abs(Compressor.inspect(frame)["eb_abs"] - eb_abs) <= 1e-6 * eb_abs, f"{label}: frame {k} eb_abs")
        err = float((y.double() - x.double()).abs().max()) / eb_abs
        check(err <= 1 + SLACK, f"{label}: frame {k} (leaf {i}): max err/eb {err}")
        check(torch.equal(back[i], y.to(back[i].dtype)), f"{label}: leaf {i} is not its frame's decode")
        worst, n = max(worst, err), n + 1
        del x, y
    check(n == len(framed), f"{label}: {n} frames for {len(framed)} leaves")
    return worst


def phase_serve_paging(device, smi: str, seed: int) -> tuple[dict, dict]:
    """Phase 11b: the long-prompt KV paging at gemma3-12b's published widths,
    depth cut to one pattern group: prefill, the cache through
    _kv_roundtrip in process with the launches counted, the bound per leaf,
    greedy decoding from the restored and the untouched cache, one profiled
    offload + restore. Returns the results and (cache, stream) for 11c."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, param_count
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import DEFAULT_KV_SPEC, _kv_roundtrip
    from repro_torch.models import init_params, prefill

    cfg = dataclasses.replace(get_config("gemma3-12b"), n_layers=SERVE_CUT_LAYERS)
    B, P, T = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    say(f"  11b: gemma3-12b at published widths, depth cut from 48 to {cfg.n_layers} layers (5 local + 1 global), "
        f"{param_count(cfg) / 1e9:.3f} B parameters; batch {B}, prompt {P}, {T} tokens, spec {DEFAULT_KV_SPEC!r}")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=device)
    sync(device)
    peak_reset(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, {"tokens": tokens}, cache_len=P + T)
    sync(device)
    t_prefill = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "11b: non-finite prefill logits")
    leaves = serve_cache_leaves(cache)
    shapes = sorted({tuple(t.shape) for _, t in leaves})
    kv_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    want = sorted({(1, B, min(cfg.window, P + T), cfg.n_kv_heads, cfg.d_head), (1, B, P + T, cfg.n_kv_heads, cfg.d_head)})
    check(len(leaves) == 12 and shapes == want, f"11b: cache leaves {len(leaves)} of {shapes}, not {want}")
    untouched = [t.clone() for _, t in leaves]
    sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    restored, stats, stream = kv_roundtrip_recorded(cache)
    sync(device)
    t_kv = time.perf_counter() - t0
    launches = launch_counts()
    peak = peak_gib(device)
    for k in ("interp_encode", "interp_decode", "histogram256", "hf_encode", "hf_decode"):
        check(launches[k] > 0, f"11b: kernel {k} was not launched on the serve_kv path")
    check(stats["frames"] == 12 and stats["raw_bytes"] == kv_bytes and "damage" not in stats, f"11b: stats {stats}")
    worst = check_kv_frames(stream, cache, restored, "11b")
    mb = kv_bytes / 1e6
    say(f"  11b kv paging ({smi}): {len(leaves)} leaves {shapes}, {mb:.1f} MB bf16 ({2 * mb:.1f} MB as float32), "
        f"prefill {t_prefill * 1e3:.1f} ms, offload + restore {t_kv:.3f} s ({2 * mb / t_kv:.1f} MB/s of float32), "
        f"CR {stats['cr']:.4f}, pipelines {stats['pipelines']}, max err/eb {worst:.7f}, peak {peak:.2f} GiB; "
        f"launches {launches}")
    first = logits.argmax(-1)
    restored_leaves = [t.clone() for _, t in serve_cache_leaves(restored)]  # for 11c: decoding writes the cache
    t0 = time.perf_counter()
    toks_restored = greedy_tokens(params, cfg, first, restored, P, T)
    sync(device)
    t_decode = time.perf_counter() - t0
    it = iter(untouched)
    from repro_torch.core.tree import tree_map

    toks_plain = greedy_tokens(params, cfg, first, tree_map(lambda _: next(it), cache), P, T)
    agree = float((toks_restored == toks_plain).float().mean())
    first_diff = [int((toks_restored[b] != toks_plain[b]).nonzero()[0]) if bool((toks_restored[b] != toks_plain[b]).any())
                  else None for b in range(B)]
    say(f"  11b greedy decode of {T} tokens from the restored cache: {t_decode * 1e3:.1f} ms "
        f"({B * T / t_decode:.1f} tok/s); tokens equal to the untouched cache's: {agree:.4f} (first difference per "
        f"sequence: {first_diff}; reported, not checked: the offload is lossy)")
    del untouched, toks_plain
    # the profile's own parse costs seconds per frame, so one local and one global
    # layer's K (2 of the 12 leaves) stand for the cache
    part = {"stack": [{"k": cache["stack"][0]["k"]}, {"k": cache["stack"][-1]["k"]}]}
    part_mb = sum(t.numel() * t.element_size() for _, t in serve_cache_leaves(part)) / 1e6
    prof = profile_run(lambda: _kv_roundtrip(part, DEFAULT_KV_SPEC),
                       f"11b serve_kv offload + restore of a local and a global layer's K (2 of {len(leaves)} "
                       f"leaves, {part_mb:.1f} MB bf16)")
    out = {"cut_layers": cfg.n_layers, "params": param_count(cfg), "batch": B, "prompt": P, "tokens": T,
           "prefill_s": t_prefill, "kv_s": t_kv, "kv_mb": mb, "stats": stats, "err_over_eb": worst, "peak_gib": peak,
           "launches": launches, "decode_s": t_decode, "token_agreement": agree, "first_difference": first_diff,
           "profile": prof}
    del params, logits, restored
    return out, {"cache": cache, "stream": stream, "kv_s": t_kv, "restored": restored_leaves, "err_over_eb": worst}


def phase_serve_daemon(device, smi: str, paged: dict) -> dict:
    """Phase 11c: the first SERVE_DAEMON_LAYERS layers of 11b's cache (their
    K and V, the first frames of 11b's stream) through an in-process port
    daemon on the card: every container equal to 11b's in-process one (a
    plan-cache hit says "pcached" in place of the orchestrator's "pchoice"
    record and is otherwise byte-equal), the bound per leaf, the plan-cache
    hits."""
    import io

    from repro_torch.core import frames
    from repro_torch.core.compressor import _sections_unpack
    from repro_torch.launch.compressd import CompressdServer

    import torch

    cache = {"stack": paged["cache"]["stack"][:SERVE_DAEMON_LAYERS]}
    n = len(serve_cache_leaves(cache))
    stream = paged["stream"]
    with CompressdServer("127.0.0.1:0", workers=2, max_request_bytes=512 << 20, device=device).start() as srv:
        sync(device)
        t0 = time.perf_counter()
        restored, stats, daemon_stream = kv_roundtrip_recorded(cache, compressd=srv.address)
        sync(device)
        wall = time.perf_counter() - t0
    want = [f for _, f in frames.FrameReader(io.BytesIO(stream)).iter_frames()]
    got = [f for _, f in frames.FrameReader(io.BytesIO(daemon_stream)).iter_frames()]
    check(len(want) == 12 and len(got) == n == 2 * SERVE_DAEMON_LAYERS, f"11c: {len(got)} frames of {n} leaves")
    equal = hits = 0
    for k, (g, w) in enumerate(zip(got, want)):
        if g == w:
            equal += 1
            continue
        (gh, gs), (wh, ws) = _sections_unpack(g), _sections_unpack(w)
        check(gh.pop("pcached", None) is True and wh.pop("pchoice", {}).get("pipeline") == gh.get("pipeline"),
              f"11c: frame {k} differs from 11b's and is no plan-cache hit")
        check(gh == wh and [bytes(s) for s in gs] == [bytes(s) for s in ws], f"11c: frame {k} differs from 11b's")
        hits += 1
    check(stats.get("plan_cache_hits", 0) == hits > 0, f"11c: plan-cache hits {stats.get('plan_cache_hits')} vs {hits}")
    # the frames' payloads are 11b's, whose decodes 11b held to the bound: the
    # restored leaves must be 11b's bit for bit (no second decode of every frame)
    for (key, a), b in zip(serve_cache_leaves(restored), paged["restored"]):
        check(torch.equal(a, b), f"11c: restored leaf {key} differs from 11b's")
    worst = paged["err_over_eb"]
    say(f"  11c the first {SERVE_DAEMON_LAYERS} layers' {n} leaves of the cache through an in-process daemon ({smi}): "
        f"{wall:.3f} s (all 12 in process {paged['kv_s']:.3f} s), "
        f"{equal} containers byte-equal to 11b's and {hits} plan-cache hits equal to them but for the orchestrator "
        f"record (pcached for pchoice), {stats['plan_cache_hits']} hits counted, restored leaves == 11b's (max "
        f"err/eb {worst:.7f} there)")
    return {"wall_s": wall, "equal": equal, "hits": hits, "stats": stats, "err_over_eb": worst}


def scaled_serve(cfg, params, batch, device, steps: int) -> list:
    """Prefill logits and ``steps`` greedy decode logits of ``cfg`` on
    ``device`` (params and batch moved there), as host float32 tensors."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import decode_step, prefill

    params = tree_map(lambda t: t.to(device), params)
    batch = {k: v.to(device) for k, v in batch.items()}
    S = batch["tokens"].shape[1] + (batch["img"].shape[1] if "img" in batch else 0)
    logits, cache = prefill(params, cfg, batch, cache_len=S + steps)
    out = [logits.float().cpu()]
    for i in range(steps):
        logits, cache = decode_step(params, cfg, logits.argmax(-1), S + i, cache)
        out.append(logits.float().cpu())
    return out


def phase_serve_archs(device, smi: str, seed: int) -> dict:
    """Phase 11d: each of the ten architectures at .scaled(), the port's own
    weights drawn on the CPU and moved to the card: prefill logits and 4
    greedy decode steps on the card against the CPU, within the reference's
    own tolerances (0.05; 0.15 for the ssm and hybrid families), since the
    card sums bf16 products in another order than the CPU."""
    import torch

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import init_params

    out = {}
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        cfg = cfg.scaled(capacity_factor=100.0) if cfg.n_experts else cfg.scaled()
        g = torch.Generator().manual_seed(seed)
        params = init_params(cfg, g, "cpu")
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
        if cfg.stub_frontend == "vit":
            batch["img"] = torch.randn((2, cfg.n_img_tokens, cfg.d_model), generator=g).to(torch.bfloat16)
        if cfg.enc_layers:
            batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g).to(torch.bfloat16)
        tol = 0.15 if ("ssm" in cfg.pattern or "rglru" in cfg.pattern) else 0.05
        card = scaled_serve(cfg, params, batch, device, SERVE_ARCH_STEPS)
        host = scaled_serve(cfg, params, batch, "cpu", SERVE_ARCH_STEPS)
        diffs = [float((a - b).abs().max()) for a, b in zip(card, host)]
        check(all(bool(torch.isfinite(a).all()) for a in card), f"11d {arch}: non-finite logits on the card")
        check(max(diffs) < tol, f"11d {arch}: card vs cpu logits {diffs} (tolerance {tol})")
        out[arch] = {"family": cfg.family, "max_diff": max(diffs), "tol": tol}
    say(f"  11d ten architectures at .scaled(), card vs cpu ({smi}): prefill + {SERVE_ARCH_STEPS} decode steps, max "
        f"|logit difference| " + ", ".join(f"{a} {r['max_diff']:.4f} (< {r['tol']})" for a, r in out.items()))
    return out


def phase_serve(device, smi: str, seed: int) -> dict:
    """Phase 11: the LM serving path on the card."""
    t11 = time.perf_counter()
    say(f"phase 11 ({smi}): serving (repro_torch.launch.serve, repro_torch.models) on {device}")
    out = {"entry": phase_serve_entry(device, smi)}
    out["paging"], paged = phase_serve_paging(device, smi, seed)
    out["daemon"] = phase_serve_daemon(device, smi, paged)
    del paged
    out["archs"] = phase_serve_archs(device, smi, seed)
    out["wall_s"] = time.perf_counter() - t11
    say(f"phase 11 took {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 12
def train_leaves(tree) -> list:
    from repro_torch.core.tree import leaf_paths

    return leaf_paths(tree)


def train_step_run(step, state, batch, device) -> tuple:
    """One train step, its host wall (ending in a synchronize) in ms, and
    its loss and grad norm as floats."""
    import torch

    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    return state, ms, float(m["loss"]), float(m["grad_norm"])


def phase_train_whole(device, smi: str, seed: int) -> dict:
    """Phase 12a: the whole published whisper-small (12 encoder + 12 decoder
    layers) trains on the card: make_train_state from --seed, the plain
    train step at the CLI's batch and sequence length, one warm-up step,
    TRAIN_STEPS timed steps, one profiled step; then TRAIN_FIXED steps on
    one fixed batch (the loss must fall), and remat on against off on one
    step (equal losses, lower peak memory with remat)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, param_count
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.runtime.steps import batch_to, make_train_state, make_train_step

    cfg = get_config("whisper-small")
    t0 = time.perf_counter()
    state0 = make_train_state(cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    torch.cuda.synchronize(device)
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in train_leaves(state0.params))
    state_gb = 3 * 4 * n_params / 1e9
    say(f"phase 12a ({smi}): whisper-small whole (src/repro/configs/whisper_small.py, arXiv:2212.04356: 12 encoder + "
        f"12 decoder layers, d_model 768, 12 heads, d_ff 3072, vocab 51865), {n_params} parameters "
        f"(param_count {param_count(cfg)}), float32 params + m + v {state_gb:.3f} GB, made from seed {seed} on {device} "
        f"in {t_init:.2f} s; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, frames ({cfg.enc_seq}, {cfg.d_model}), remat "
        f"{cfg.remat} ({cfg.remat_policy})")
    from repro_torch.kernels import launch_counts, reset_launch_counts

    data = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed, extras={"frames": (cfg.enc_seq, cfg.d_model)})
    step = make_train_step(cfg, None, lr=1e-3)
    peak_reset(device)
    state, warm_ms, loss, gnorm = train_step_run(step, state0, batch_to(next(data), device), device)
    say(f"  warm-up step {warm_ms:.1f} ms, loss {loss:.4f}, grad norm {gnorm:.4f}")
    step_ms, losses, norms = [], [], []
    reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        batch = batch_to(next(data), device)
        torch.cuda.synchronize(device)
        state, ms, loss, gnorm = train_step_run(step, state, batch, device)
        step_ms.append(ms)
        losses.append(loss)
        norms.append(gnorm)
    launches = launch_counts()
    peak = peak_gib(device)
    check(all(map(math.isfinite, losses + norms)), f"12a: non-finite loss or grad norm: {losses} {norms}")
    mean_ms = sum(step_ms) / len(step_ms)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (mean_ms / 1e3)
    say(f"  {TRAIN_STEPS} steps: {mean_ms:.1f} ms a step (min {min(step_ms):.1f}, max {max(step_ms):.1f}), {tok_s:.1f} "
        f"tokens/s, peak {peak:.2f} GiB ({smi})")
    say(f"  losses {[round(x, 4) for x in losses]}; grad norms {[round(x, 4) for x in norms]}")
    # every leaf moves but the cross-attention q/k/v biases, which the model
    # never reads (the JAX package's cross-attention has no biases): zero
    # gradient, zero values, so weight decay leaves them too
    unread = {n for n, _ in train_leaves(state0.params) if "_cross_b" in n}
    same = {n for (n, a), (_, b) in zip(train_leaves(state0.params), train_leaves(state.params)) if torch.equal(a, b)}
    check(same == unread, f"12a: parameter leaves left unchanged {sorted(same)}, expected {sorted(unread)}")
    del state0
    batch = batch_to(next(data), device)
    prof = profile_run(lambda: step(state, batch), f"12a: one train step of the whole whisper-small ({smi})",
                       tally={"fp32 -> bf16 casts": "bfloat16_copy_kernel", "other copies": "direct_copy_kernel"})
    # the loss must fall on one fixed batch
    fixed = batch_to(next(data), device)
    s, fixed_losses = state, []
    for _ in range(TRAIN_FIXED):
        prev = s
        s, _, loss, _ = train_step_run(step, s, fixed, device)
        fixed_losses.append(loss)
    adamw_err = adamw_step_errors(prev, s, lr=1e-3)
    del s, prev
    check(fixed_losses[-1] < fixed_losses[0], f"12a: the loss did not fall on a fixed batch: {fixed_losses}")
    check(adamw_err <= 1.0, f"12a: the last step's parameters are {adamw_err} x their bound from AdamW's formula")
    say(f"  {TRAIN_FIXED} steps on one fixed batch: losses {[round(x, 4) for x in fixed_losses]}; the last step's "
        f"parameters against AdamW's formula on its own m and v: worst |dp| {adamw_err:.4f} x its bound (<= 1)")
    # remat on against off, one step each from the same state and batch
    remat = {}
    for on in (True, False):
        st = make_train_step(dataclasses.replace(cfg, remat=on), None, lr=1e-3)
        torch.cuda.synchronize(device)
        peak_reset(device)
        base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0  # what phase 14b subtracts
        _, ms, loss, gnorm = train_step_run(st, state, fixed, device)
        remat[on] = {"ms": ms, "loss": loss, "grad_norm": gnorm, "peak_gib": peak_gib(device), "base_bytes": base,
                     "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    check(remat[True]["loss"] == remat[False]["loss"], f"12a: remat changed the loss: {remat}")
    gn_rel = abs(remat[True]["grad_norm"] - remat[False]["grad_norm"]) / remat[False]["grad_norm"]
    check(gn_rel <= REMAT_GRAD_NORM_RTOL,
          f"12a: remat moved the grad norm by {gn_rel} relative (limit {REMAT_GRAD_NORM_RTOL}): {remat}")
    check(remat[True]["peak_gib"] < remat[False]["peak_gib"], f"12a: remat did not lower peak memory: {remat}")
    say(f"  remat on: {remat[True]['ms']:.1f} ms, peak {remat[True]['peak_gib']:.2f} GiB; off: {remat[False]['ms']:.1f} "
        f"ms, peak {remat[False]['peak_gib']:.2f} GiB; losses equal ({remat[True]['loss']:.6f}), grad norms "
        f"{remat[True]['grad_norm']:.6f} / {remat[False]['grad_norm']:.6f} (relative difference {gn_rel:.3e}, limit "
        f"{REMAT_GRAD_NORM_RTOL})")
    return {"params": n_params, "param_count": param_count(cfg), "state_gb": state_gb, "warm_ms": warm_ms,
            "step_ms": step_ms, "mean_step_ms": mean_ms, "tokens_per_s": tok_s, "peak_gib": peak, "losses": losses,
            "grad_norms": norms, "fixed_losses": fixed_losses, "adamw_over_bound": adamw_err, "remat": {str(k): v for k, v in remat.items()},
            "remat_grad_norm_rel": gn_rel,
            "profile": prof, "launches": launches}


def phase_train_cli(device, smi: str, seed: int, directory: pathlib.Path) -> dict:
    """Phase 12b: the train CLI (repro_torch.launch.train.run) on whisper-small at
    published widths, depth cut to WHISPER_SMALL's 1 + 1 layers (the CLI has
    no depth flag: get_config is wrapped), with error-bounded checkpoints
    (--ckpt-eb 1e-3); then again on the same --ckpt-dir with one more step:
    it must resume from the first run's final step, its restored state
    within each frame's bound of the saved one, the launches of the path
    counted."""
    import dataclasses

    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.runtime.train_loop import Trainer

    class Recording(Trainer):
        """Keeps the state its restore produced, and the restore's wall."""

        def _restore(self):
            t0 = time.perf_counter()
            super()._restore()
            if self.step:
                torch.cuda.synchronize(self.device)
                self.restored, self.restore_s = self.state, time.perf_counter() - t0

    real_config, real_trainer = train.get_config, train.Trainer
    cut = {"n_layers": WHISPER_SMALL["dec_layers"], "enc_layers": WHISPER_SMALL["enc_layers"]}
    train.get_config = lambda arch: dataclasses.replace(real_config(arch), **cut)
    train.Trainer = Recording
    args = ["--arch", "whisper-small", "--ckpt-eb", f"{CKPT_EB:g}", "--ckpt-dir", str(directory), "--save-every", "1000"]
    say(f"phase 12b ({smi}): python -m repro_torch.launch.train {' '.join(args)} --steps {CLI_STEPS}, then (13b) "
        f"--steps {CLI_STEPS + 1} --mesh 1,1; whisper-small at published widths, depth cut to {cut}")
    try:
        reset_launch_counts()
        first = train.run(args + ["--steps", str(CLI_STEPS)])
        first_launches = launch_counts()
        # 13b: the resume places the restored state on a one-rank (data, model) mesh (NCCL on the card), and the
        # final save gathers the placed state through rank 0
        second = train.run(args + ["--steps", str(CLI_STEPS + 1), "--mesh", "1,1"])
        launches = launch_counts()
    finally:
        train.get_config, train.Trainer = real_config, real_trainer
    for k in ("interp_encode", "interp_decode", "histogram256", "hf_encode", "hf_decode"):
        check(launches[k] > 0, f"12b: kernel {k} was not launched on the trainer's checkpoint path")
    tr1, tr2 = first["trainer"], second["trainer"]
    check(second["start_step"] == CLI_STEPS and tr2.step == CLI_STEPS + 1,
          f"12b: the second run resumed at {second['start_step']} and ended at {tr2.step}")
    check(all(map(math.isfinite, first["losses"] + second["losses"])), "12b: non-finite loss")
    step_dir = directory / f"step_{CLI_STEPS:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    placed = [t for _, t in train_leaves(tr2.restored)]
    check(all(type(t).__name__ == "DTensor" for t in placed), "13b: the resumed state is not placed on the mesh")
    restored = tree_map(lambda t: t.full_tensor(), tr2.restored)
    worst = check_restored(tr1.state, restored, manifest, step_dir, "13b")
    final_dir = directory / f"step_{CLI_STEPS + 1:08d}"
    final = json.loads((final_dir / "manifest.json").read_text())
    check(sorted(final["leaves"]) == sorted(manifest["leaves"]) and final["step"] == CLI_STEPS + 1,
          f"13b: the placed final save holds {sorted(final['leaves'])[:3]}... at step {final['step']}")
    n_frames = sum(m.get("n_frames", 0) for m in manifest["leaves"].values())
    n_state = sum(t.numel() * t.element_size() for _, t in train_leaves(tr1.state))
    save_s = first["wall_s"] - sum(first["step_s"])
    say(f"  run 1: {CLI_STEPS} steps ({[round(x * 1e3, 1) for x in first['step_s']]} ms), final save of "
        f"{n_state / 1e6:.1f} MB (params + m + v + step) {save_s:.3f} s ({n_state / 1e6 / save_s:.1f} MB/s), CR "
        f"{manifest['cr']}, {n_frames} v3 frames, {len(manifest['leaves'])} leaves")
    say(f"  run 2 (13b, --mesh 1,1): restored step {second['start_step']} placed on the mesh in {tr2.restore_s:.3f} s "
        f"({n_state / 1e6 / tr2.restore_s:.1f} MB/s), max err/eb {worst:.7f} over every frame, 1 step, final save of "
        f"the placed state (CR {final['cr']}); wall {second['wall_s']:.3f} s; losses {first['losses']} then "
        f"{second['losses']}")
    say(f"  launches: run 1 {first_launches}; both runs {launches}")
    return {"widths": WHISPER_SMALL, "state_mb": n_state / 1e6, "save_s": save_s, "restore_s": tr2.restore_s,
            "placed_final_cr": final["cr"],
            "cr": manifest["cr"], "frames": n_frames, "err_over_eb": worst, "launches": launches,
            "first_launches": first_launches, "losses": first["losses"] + second["losses"],
            "walls_s": [first["wall_s"], second["wall_s"]]}


# phase 12c, card against CPU after one train step: max |loss difference|, the grad norm's relative
# difference, and the worst parameter leaf's ||m_card - m_cpu|| / ||m_cpu|| (after the first step AdamW's m
# is 0.1 x the clipped gradient); bf16 products sum in another order on the card. Each limit is a few times
# the worst reading of PR 20's chip runs (9.0e-5, 7.2e-4, 3.2e-2, all on recurrentgemma-2b)
TRAIN_CARD_LIMITS = (5e-4, 4e-3, 0.1)


def first_step_param_errors(card_state, host_state, lr: float, b1: float = 0.9, eps: float = 1e-8) -> dict:
    """The updated parameters of one AdamW step from one state, card against
    CPU, each element held to its own bound. The first step moves a
    parameter by ``lr * (g / (|g| + eps) + wd * p)``; the decay term is the
    same on both sides. Let delta be a leaf's largest gradient difference
    |g_card - g_cpu| (read from m = (1 - b1) g). Where |g_cpu| <= 2 delta
    the two gradients may differ in sign, and the parameters by up to
    2 lr. Elsewhere both gradients have the sign of g_cpu and at least half
    its size, so they differ by at most min(2 lr, 2 lr eps / |g_cpu|). Four
    ulps of |p| + lr are added for the rounding. Returns the worst
    |dp| / bound, the share of elements in the sign band, and, for the
    elements that differ by more than 1e-6, their count, their largest
    |g_cpu|, and the share of all gradients that are that small."""
    import torch

    worst, n, n_band, moved, g_moved, g_all = 0.0, 0, 0, 0, 0.0, []
    for (_, pa), (_, pb), (_, ma), (_, mb) in zip(train_leaves(card_state.params), train_leaves(host_state.params),
                                                  train_leaves(card_state.opt.m), train_leaves(host_state.opt.m)):
        ulp = torch.finfo(pb.dtype).eps
        pa, pb = pa.cpu().double(), pb.double()
        g = mb.double() / (1 - b1)
        delta = float((ma.cpu().double() - mb.double()).abs().max()) / (1 - b1)
        band = g.abs() <= 2 * delta
        tight = torch.clamp(2 * lr * eps / g.abs(), max=2 * lr)
        bound = torch.where(band, torch.full_like(g, 2 * lr), tight) + 4 * ulp * (pb.abs() + lr)
        d = (pa - pb).abs()
        worst = max(worst, float((d / bound).max()))
        n, n_band = n + g.numel(), n_band + int(band.sum())
        far = d > 1e-6
        moved += int(far.sum())
        if far.any():
            g_moved = max(g_moved, float(g.abs()[far].max()))
        g_all.append(g.abs().reshape(-1))
    g_all = torch.cat(g_all)
    return {"worst_over_bound": worst, "band_share": n_band / n, "moved": moved, "moved_share": moved / n,
            "moved_max_g": g_moved, "moved_g_quantile": float((g_all <= g_moved).double().mean()) if moved else 0.0}


# the train step's AdamW against its own formula: each updated parameter against p - lr * ((m / c1) /
# (sqrt(v / c2) + eps) + wd * p), computed in float64 from the step's own m and v, within 2^-23 x (4 lr (|a| +
# wd |p|) + |p_new|): room for 8 half-ulp roundings in the update and 2 in the parameter (eager ops, no FMA)
def adamw_step_errors(old_state, new_state, lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                      wd: float = 0.1) -> float:
    """The worst updated parameter's distance from the AdamW formula over
    its bound (<= 1 holds)."""
    import torch

    t = new_state.opt.step.to(torch.float32)
    c1 = float(1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t))
    c2 = float(1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t))
    worst = 0.0
    for (_, p0), (_, p1), (_, m), (_, v) in zip(train_leaves(old_state.params), train_leaves(new_state.params),
                                                train_leaves(new_state.opt.m), train_leaves(new_state.opt.v)):
        p0 = p0.to(p1.device).double()
        a = (m.double() / c1) / (torch.sqrt(v.double() / c2) + eps)
        ref = p0 - lr * (a + wd * p0)
        bound = torch.finfo(p1.dtype).eps * (4 * lr * (a.abs() + wd * p0.abs()) + ref.abs()) + 1e-30
        worst = max(worst, float(((p1.double() - ref).abs() / bound).max()))
    return worst


def phase_train_archs(device, smi: str, seed: int) -> dict:
    """Phase 12c: one plain train step of each of the ten architectures at
    .scaled() on the card against the CPU (the port's weights drawn on the
    CPU and moved); then the compressed pod step (2 pods) on mamba2-370m."""
    import types

    import torch

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.runtime.steps import make_train_state, make_train_step

    def one(arch, npods=0):
        cfg = get_config(arch).scaled()
        state = make_train_state(cfg, torch.Generator().manual_seed(seed), npods=npods, device="cpu")
        extras = {}
        if cfg.stub_frontend == "vit":
            extras["img"] = (cfg.n_img_tokens, cfg.d_model)
        if cfg.enc_layers:
            extras["frames"] = (cfg.enc_seq, cfg.d_model)
        batch = next(TokenPipeline(cfg.vocab, 4, 32, seed=seed, extras=extras))
        mesh = types.SimpleNamespace(shape={"pod": npods}) if npods else None
        step = make_train_step(cfg, mesh, lr=1e-3, compress_pods=bool(npods))
        card_state, card = step(tree_map(lambda t: t.to(device), state), batch)
        host_state, host = step(state, batch)
        dl = abs(float(card["loss"]) - float(host["loss"]))
        dn = abs(float(card["grad_norm"]) - float(host["grad_norm"])) / float(host["grad_norm"])
        m_err = 0.0
        for (_, a), (_, b) in zip(train_leaves(card_state.opt.m), train_leaves(host_state.opt.m)):
            nb = float(b.double().norm())
            d = float((a.cpu().double() - b.double()).norm())
            m_err = max(m_err, d / nb if nb > 0 else d)
        pe = first_step_param_errors(card_state, host_state, lr=1e-3)
        pe["adamw_over_bound"] = adamw_step_errors(state, card_state, lr=1e-3)
        lim = TRAIN_CARD_LIMITS
        label = f"{arch}{' (2 pods, compressed)' if npods else ''}"
        check(math.isfinite(float(card["loss"])) and dl < lim[0] and dn < lim[1] and m_err < lim[2],
              f"12c {label}: card vs cpu loss {dl}, grad norm {dn}, worst m leaf {m_err} (limits {lim})")
        check(pe["worst_over_bound"] <= 1.0 and pe["adamw_over_bound"] <= 1.0,
              f"12c {label}: an updated parameter lies outside its bound: {pe}")
        out = {"loss_diff": dl, "grad_norm_rel": dn, "m_rel": m_err, "params": pe}
        if npods:
            r = [float((a.cpu() - b).abs().max()) for (_, a), (_, b) in
                 zip(train_leaves(card_state.resid), train_leaves(host_state.resid))]
            out["resid_max_diff"] = max(r)
        return label, out

    out = dict(one(arch) for arch in sorted(ARCHS))
    label, r = one("mamba2-370m", npods=2)
    out[label] = r
    lim = TRAIN_CARD_LIMITS
    say(f"  12c one train step at .scaled(), card vs cpu ({smi}): |loss diff| (< {lim[0]}) / grad norm rel (< "
        f"{lim[1]}) / worst m leaf rel (< {lim[2]}) / worst updated parameter's |dp| over its bound (<= 1): " + "; ".join(
            f"{a} {r['loss_diff']:.2e} / {r['grad_norm_rel']:.2e} / {r['m_rel']:.2e} / "
            f"{r['params']['worst_over_bound']:.6f}" for a, r in out.items()))
    say("  12c the card's updated parameters against AdamW's formula on the card's own m and v, worst |dp| over "
        "its bound (<= 1): " + "; ".join(f"{a} {r['params']['adamw_over_bound']:.4f}" for a, r in out.items()))
    say("  12c updated parameters: share in the sign band |g_cpu| <= 2 delta / elements with |dp| > 1e-6 (share) / "
        "their largest |g_cpu| / share of all |g_cpu| that small: " + "; ".join(
            f"{a} {r['params']['band_share']:.4f} / {r['params']['moved']} ({r['params']['moved_share']:.4f}) / "
            f"{r['params']['moved_max_g']:.3e} / {r['params']['moved_g_quantile']:.4f}" for a, r in out.items()))
    return out


def phase_train(device, smi: str, seed: int) -> dict:
    """Phase 12: single-device LM training on the card."""
    import tempfile

    import torch

    t12 = time.perf_counter()
    say(f"phase 12 ({smi}): training (repro_torch.runtime, repro_torch.optim, repro_torch.launch.train) on {device}")
    out = {"whole": phase_train_whole(device, smi, seed)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        out["cli"] = phase_train_cli(device, smi, seed, pathlib.Path(d))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["archs"] = phase_train_archs(device, smi, seed)
    out["archs_s"] = time.perf_counter() - t0
    out["wall_s"] = time.perf_counter() - t12
    say(f"phase 12 took {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 13
def phase_mesh_steps(device, mesh, smi: str, seed: int) -> dict:
    """Phase 13a: olmoe-1b-7b at published widths, MESH_LAYERS layers, plain
    step (slice 10) then the mesh step on ``mesh`` from the same seed's
    state and the same batches, for the FFN-sharded and the
    expert-parallel MoE: one warm-up step (from the seed's state, under
    torch.use_deterministic_algorithms: the two kinds' losses and grad
    norms compared) and MESH_STEPS timed steps (the default kernels), the
    peak memory, one profiled step."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, param_count
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.runtime.steps import batch_to, make_train_state, make_train_step

    cfg0 = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=MESH_LAYERS)
    data = TokenPipeline(cfg0.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
    batches = [batch_to(next(data), device) for _ in range(1 + MESH_STEPS)]
    say(f"phase 13a ({smi}): olmoe-1b-7b (src/repro/configs/olmoe_1b_7b.py, arXiv:2409.02060: d_model {cfg0.d_model}, "
        f"{cfg0.n_heads} heads, {cfg0.n_experts} experts, top-{cfg0.top_k}, d_expert {cfg0.d_expert}, vocab {cfg0.vocab}), "
        f"depth cut from 16 layers to {MESH_LAYERS} (param_count {param_count(cfg0)}); batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}; plain step, then the mesh step on {dict(mesh.shape)}")
    out = {}
    for form, ep in (("ffn_sharded", False), ("expert_parallel", True)):
        cfg = dataclasses.replace(cfg0, moe_expert_parallel=ep)
        res = {}
        for kind in ("plain", "mesh"):
            m = mesh if kind == "mesh" else None
            torch.cuda.empty_cache() if device.type == "cuda" else None
            peak_reset(device)
            state = make_train_state(cfg, torch.Generator(device=device).manual_seed(seed), device=device, mesh=m)
            step = make_train_step(cfg, m, lr=1e-3)
            # the compared first step runs deterministic kernels: the MoE combine's index_add_ otherwise adds
            # each token's top-8 bf16 contributions in the order the card's atomics land (a bf16 ulp apart,
            # then a routing flip downstream), run to run and kind to kind alike
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                state, warm_ms, loss, gnorm = train_step_run(step, state, batches[0], device)
            finally:
                torch.use_deterministic_algorithms(False)
            ms = []
            for b in batches[1:]:
                state, t, _, _ = train_step_run(step, state, b, device)
                ms.append(t)
            peak = peak_gib(device)
            mean = sum(ms) / len(ms)
            prof = profile_run(lambda: step(state, batches[1]), f"13a: one {kind} train step, {form} MoE ({smi})")
            res[kind] = {"warm_ms": warm_ms, "loss": loss, "grad_norm": gnorm, "step_ms": ms, "mean_step_ms": mean,
                         "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (mean / 1e3), "peak_gib": peak, "profile": prof}
            say(f"  13a {form} {kind}: deterministic warm-up {warm_ms:.1f} ms (loss {loss:.6f}, grad norm {gnorm:.6f}); {MESH_STEPS} "
                f"steps {mean:.1f} ms a step (min {min(ms):.1f}, max {max(ms):.1f}), "
                f"{res[kind]['tokens_per_s']:.1f} tokens/s, peak {peak:.2f} GiB ({smi})")
            del state, step
        p, q = res["plain"], res["mesh"]
        dl = abs(p["loss"] - q["loss"])
        dn = abs(p["grad_norm"] - q["grad_norm"]) / p["grad_norm"]
        check(math.isfinite(q["loss"]) and dl < MESH_CARD_LIMITS[0] and dn < MESH_CARD_LIMITS[1],
              f"13a {form}: mesh vs plain loss {dl}, grad norm {dn} (limits {MESH_CARD_LIMITS})")
        res["bit_equal"] = p["loss"] == q["loss"] and p["grad_norm"] == q["grad_norm"]
        res["extra_ms"] = q["mean_step_ms"] - p["mean_step_ms"]
        say(f"  13a {form}: mesh vs plain first step |loss diff| {dl:.3e} (< {MESH_CARD_LIMITS[0]}), grad norm rel "
            f"{dn:.3e} (< {MESH_CARD_LIMITS[1]}), bit-equal {res['bit_equal']}; the mesh step takes "
            f"{res['extra_ms']:+.1f} ms a step ({q['profile']['device_ops']} device kernels and copies against "
            f"{p['profile']['device_ops']}, idle share {q['profile']['device_idle_share']:.3f} against "
            f"{p['profile']['device_idle_share']:.3f})")
        out[form] = res
    return out


def phase_mesh_pods(device, smi: str, seed: int) -> dict:
    """Phase 13c: the compressed pod step on a (1, 1, 1) ("pod", "data",
    "model") mesh against slice 10's global view at one pod (mamba2-370m at
    .scaled(), as 12c): the int8 payloads equal, the loss and every updated
    parameter within 12c's limits."""
    import types

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import grad_compress
    from repro_torch.runtime import steps

    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device_type=device.type)
    cfg = get_config("mamba2-370m").scaled()
    batch = next(TokenPipeline(cfg.vocab, 4, 32, seed=seed))
    real_ex, real_q = steps.pod_exchange, grad_compress.quantize_shard
    gv_q, mesh_q = [], []
    def spy_global(g, r):
        out = real_ex(g, r)
        gv_q.append(out[2][0])  # the one pod's int8 payload
        return out

    def spy(t, amax=None):  # the payloads the pod step quantizes for the exchange
        q, scale = real_q(t, amax)
        mesh_q.append(q)
        return q, scale

    steps.pod_exchange, grad_compress.quantize_shard = spy_global, spy
    try:
        host = steps.make_train_state(cfg, torch.Generator(device=device).manual_seed(seed), npods=1, device=device)
        gv_state, gv = steps.make_train_step(cfg, types.SimpleNamespace(shape={"pod": 1}), lr=1e-3,
                                             compress_pods=True)(host, batch)
        placed = steps.make_train_state(cfg, torch.Generator(device=device).manual_seed(seed), npods=1, device=device,
                                        mesh=mesh)
        new, met = steps.make_train_step(cfg, mesh, lr=1e-3, compress_pods=True)(placed, batch)
    finally:
        steps.pod_exchange, grad_compress.quantize_shard = real_ex, real_q
    check(len(gv_q) == len(mesh_q) > 0, f"13c: {len(gv_q)} global-view payloads, {len(mesh_q)} exchanged")
    same = sum(bool(torch.equal(a, b)) for a, b in zip(gv_q, mesh_q))
    check(same == len(gv_q), f"13c: {len(gv_q) - same} of {len(gv_q)} int8 payloads differ from the global view's")
    full = tree_map(lambda t: t.full_tensor(), new)
    dl = abs(float(met["loss"]) - float(gv["loss"]))
    pe = first_step_param_errors(full, tree_map(lambda t: t.cpu(), gv_state), lr=1e-3)
    check(dl < TRAIN_CARD_LIMITS[0] and pe["worst_over_bound"] <= 1.0,
          f"13c: pod step vs global view loss {dl} (limit {TRAIN_CARD_LIMITS[0]}), parameters {pe}")
    say(f"  13c compressed pod step on {dict(mesh.shape)} vs the global view at 1 pod, mamba2-370m .scaled() ({smi}): "
        f"{same} of {len(gv_q)} int8 payloads equal, |loss diff| {dl:.3e} (< {TRAIN_CARD_LIMITS[0]}), worst updated "
        f"parameter {pe['worst_over_bound']:.6f} of its bound")
    return {"payloads": len(gv_q), "payloads_equal": same, "loss_diff": dl, "params": pe}


def phase_mesh(device, smi: str, seed: int) -> dict:
    """Phase 13: the device mesh on one card: a one-rank NCCL process group
    (gloo on the CPU), 13a the mesh train step of olmoe-1b-7b against the
    plain step, 13c the compressed pod step over a real pod axis (13b, the
    elastic restore, runs as 12b's second CLI run)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh

    t13 = time.perf_counter()
    init_process_group(device.type)
    mesh = make_mesh((1, 1), ("data", "model"), device_type=device.type)
    say(f"phase 13 ({smi}): the device mesh (repro_torch.launch.mesh, DTensor placements, local_map) on {device}: "
        f"{mesh}, backend {dist.get_backend()}, world {dist.get_world_size()}")
    out = {"steps": phase_mesh_steps(device, mesh, smi, seed)}
    torch.cuda.empty_cache() if device.type == "cuda" else None
    out["pods"] = phase_mesh_pods(device, smi, seed)
    out["wall_s"] = time.perf_counter() - t13
    say(f"phase 13 took {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 14
DRYRUN_CELLS = (("mamba2-370m", "decode_32k", ()), ("gemma3-12b", "prefill_32k", ("--multi-pod",)),
                ("olmoe-1b-7b", "train_4k", ("--multi-pod", "--compress-pods")))
DRYRUN_TIMEOUT = 140  # seconds, the three CLI runs together
TRACKER_RATIO = (0.8, 1.25)


def phase_dryrun_cli(smi: str) -> dict:
    """Phase 14a: the dry-run CLI (repro_torch.launch.dryrun) in subprocesses
    under this machine's torch, the three DRYRUN_CELLS at once, each a
    "fake" process group of 256 or 512 ranks with shape-only tensors and no
    card (CUDA_VISIBLE_DEVICES is empty): every run exits 0 and prints OK,
    and its record is read back."""
    import os
    import tempfile

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        t0 = time.perf_counter()
        procs = [(arch, shape, flags, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, *flags, "--out-dir", d],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)) for arch, shape, flags in DRYRUN_CELLS]
        try:
            for arch, shape, flags, p in procs:
                so, se = p.communicate(timeout=max(DRYRUN_TIMEOUT - (time.perf_counter() - t0), 1.0))
                name = f"{arch}__{shape}__{'pod2' if '--multi-pod' in flags else 'pod1'}"
                check(p.returncode == 0 and f"OK   {name}:" in so,
                      f"14a: dry run {name} {' '.join(flags)}: exit {p.returncode}\n{so[-2000:]}\n{se[-3000:]}")
                rec = json.loads((pathlib.Path(d) / f"{name}.json").read_text())
                line = next(ln for ln in so.splitlines() if ln.startswith("OK"))
                coll = {k: v for k, v in rec.get("collectives_total", rec["collectives"]).items() if "/" not in k}
                say(f"  14a {line}")
                say(f"      mesh {rec['mesh']}, {rec['kind']}, memory {rec['memory']}, collectives/dev {coll}"
                    + (f", pod axis {rec['collectives_by_axis'].get('pod')}" if "--compress-pods" in flags else ""))
                out[name] = {"line": line, "wall_s": time.perf_counter() - t0, "memory": rec["memory"],
                             "cost": rec.get("cost_total", rec["cost"]), "collectives": coll,
                             "trace_s": rec["trace_s"], "by_axis": rec["collectives_by_axis"]}
        finally:
            for *_, p in procs:
                p.kill()
                p.wait()
    return out


def phase_dryrun_tracker(whole: dict, smi: str, seed: int) -> dict:
    """Phase 14b: the dry run's live-bytes tracker over 12a's step (the
    whole whisper-small, remat on, batch TRAIN_BATCH x TRAIN_SEQ) traced on
    shape-only tensors with no mesh, against what 12a measured on the card
    for that step: max_memory_allocated less what was allocated before the
    step, plus the step's arguments (the state and the batch, which the
    tracker counts as they are). The ratio must lie in TRACKER_RATIO."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.specs import state_specs
    from repro_torch.runtime.steps import batch_to, make_train_step

    cfg = get_config("whisper-small")
    batch = batch_to(next(TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                                        extras={"frames": (cfg.enc_seq, cfg.d_model)})), "meta")
    t0 = time.perf_counter()
    rec = trace_step(make_train_step(cfg, None, lr=1e-3), (state_specs(cfg), batch))
    trace_s = time.perf_counter() - t0
    r = whole["remat"]["True"]
    mem = rec["memory"]
    measured = r["peak_bytes"] - r["base_bytes"] + mem["argument_bytes"]
    ratio = mem["peak_bytes"] / measured
    say(f"  14b tracker over 12a's step (whisper-small whole, remat on, batch {TRAIN_BATCH} x {TRAIN_SEQ}; traced on "
        f"meta in {trace_s:.1f} s): peak_bytes {mem['peak_bytes']} (arguments {mem['argument_bytes']}, outputs "
        f"{mem['output_bytes']}, temp {mem['temp_bytes']}); the card ({smi}): max_memory_allocated {r['peak_bytes']} "
        f"- allocated before {r['base_bytes']} + arguments = {measured}; ratio {ratio:.4f} (within {TRACKER_RATIO})")
    check(TRACKER_RATIO[0] <= ratio <= TRACKER_RATIO[1],
          f"14b: the tracker's peak {mem['peak_bytes']} is {ratio:.4f} x the card's {measured}")
    return {"tracker": mem, "trace_s": trace_s, "card_peak_bytes": r["peak_bytes"], "card_base_bytes": r["base_bytes"],
            "measured_bytes": measured, "ratio": ratio, "flops": rec["cost"]["flops"]}


def phase_dryrun(whole: dict, smi: str, seed: int) -> dict:
    """Phase 14: the dry run (repro_torch.launch.dryrun), which touches no card."""
    t14 = time.perf_counter()
    say(f"phase 14 ({smi}): the dry run (repro_torch.launch.dryrun) on a fake process group, shape-only tensors")
    out = {"cli": phase_dryrun_cli(smi), "tracker": phase_dryrun_tracker(whole, smi, seed)}
    out["wall_s"] = time.perf_counter() - t14
    say(f"phase 14 took {out['wall_s']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--side", type=int, default=512, help="edge of the cubic main-path field")
    ap.add_argument("--out", default=None, help="write the measurements here as JSON")
    args = ap.parse_args()
    t_start = time.perf_counter()

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
    phase_s: dict = {}
    last = [t_start]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now

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
    mark("1-2 card and build")
    for name in secs:
        for line in ptxas_report(build_dir() / f"{name}.log"):
            say(f"  ptxas {name}: {line}")

    # 3. kernels vs plain, then the planner on the card against the CPU
    phase_kernels(device, args.seed)
    x = nyx_like(args.side, args.seed, device)
    torch.cuda.synchronize()
    results["planner"] = phase_planner(x, device)
    mark("3 kernels and planner")

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
    mark("4 paths")

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
    mark("5 card vs cpu")

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
    hf = huffman_path_shapes(seq, 10)

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
    # the hf encode reads the n symbols and writes the payload; the decode reads the payload and writes n bytes
    hf_b = bound(hf["n"] + hf["payload_bytes"], 0)
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
        {"name": "hf_encode", "route": "cuda", "source": "src/repro_torch/csrc/huffman.cu",
         "replaces": "src/repro/core/lossless/engine.py:182", "launches": launches["main"]["hf_encode"],
         "path": "main", "max_abs_err": hf["encode_err"], "ms": hf["encode_ms"], "plain_ms": hf["encode_plain_ms"],
         "bound_ms": hf_b[0], "bound_by": hf_b[1], "library_ms": None},
        {"name": "hf_decode", "route": "cuda", "source": "src/repro_torch/csrc/huffman.cu",
         "replaces": "src/repro/core/lossless/engine.py:357", "launches": launches["main"]["hf_decode"],
         "path": "main", "max_abs_err": hf["decode_err"], "ms": hf["decode_ms"], "plain_ms": hf["decode_plain_ms"],
         "bound_ms": hf_b[0], "bound_by": hf_b[1], "library_ms": None},
    ]
    say(f"main-path shapes: {nb} blocks of 17^3 (kernels == plain bit for bit, {keys.numel()} outlier keys), "
        f"hf input {hs['n']} bytes")
    say(f"fz-path shapes: bit1 input {bs['n']} bytes ({bs['padded']} padded), Lorenzo field {lz['shape']} with "
        f"{lz['n_outliers']} outliers")
    say(f"histogram256 on a uniform random stream of {hs['n']} bytes: {hs['uniform_ms']:.4f} ms "
        f"(on the main path's stream: {hs['ms']:.4f} ms, the kernel alone {hs['kernel_ms']:.4f} ms)")
    say(f"lorenzo_encode: the wrapper call {lz['ms']:.4f} ms, the kernel alone {lz['kernel_ms']:.4f} ms")
    say(f"hf at the main path's input ({hf['n']} B, payload {hf['payload_bytes']} B, {hf['maxlen']}-bit codes): "
        f"hf_encode {hf['encode_ms']:.4f} ms per wrapper call (one kernel and the host read of the chunk table), "
        f"the kernels alone {hf['encode_kernel_ms']:.4f} ms, plain {hf['encode_plain_ms']:.2f} ms; hf_decode "
        f"{hf['decode_ms']:.4f} ms, the kernel alone {hf['decode_kernel_ms']:.4f} ms, plain {hf['decode_plain_ms']:.2f} "
        f"ms; bound {hf_b[0]:.4f} ms ({hf_b[1]})")
    results["kernels"] = kernels
    results["histogram_uniform_ms"] = hs["uniform_ms"]
    results["kernel_alone_ms"] = {"histogram256": hs["kernel_ms"], "lorenzo_encode": lz["kernel_ms"],
                                  "hf_encode": hf["encode_kernel_ms"], "hf_decode": hf["decode_kernel_ms"]}
    del im, blocks, ck, anchors, keys, vals, seq

    for k in kernels:
        k["launches_by_path"] = {name: launches[name][k["name"]] for name in PATHS}
    mark("6 kernel times")

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

    mark("7 profiles")
    # 8. frames v3 and the data layer
    results["v3"] = phase_v3(x, device, smi, args.seed)
    mark("8 v3")
    for k in kernels:
        k["launches_by_path"]["v3_chunks"] = results["v3"]["chunks"]["launches"][k["name"]]

    # 9. checkpoints and guarantees
    t9 = time.perf_counter()
    results["checkpoint"] = phase_checkpoint(device, smi, args.seed)
    results["phase9_s"] = time.perf_counter() - t9
    results["wall_s"] = time.perf_counter() - t_start
    say(f"phase 9 took {results['phase9_s']:.1f} s; the script {results['wall_s']:.1f} s from its start (build included)")
    mark("9 checkpoint")
    for k in kernels:
        k["launches_by_path"]["checkpoint"] = results["checkpoint"]["launches"][k["name"]]

    # 10. the compressd service
    results["compressd"] = phase_compressd(x, bufs["main"], results["paths"]["main"], results["checkpoint"], xs, smi,
                                           args.seed)
    mark("10 compressd")
    for k in kernels:
        k["launches_by_path"]["compressd"] = results["compressd"]["field"]["launches"][k["name"]]
        k["launches_by_path"]["grad_packer"] = results["compressd"]["grad_packer"]["launches"][k["name"]]

    # 11. serving
    results["serve"] = phase_serve(device, smi, args.seed)
    results["phase11_end_s"] = time.perf_counter() - t_start
    mark("11 serve")
    for k in kernels:
        k["launches_by_path"]["serve"] = results["serve"]["entry"]["launches"][k["name"]]
        k["launches_by_path"]["serve_kv"] = results["serve"]["paging"]["launches"][k["name"]]

    # 12. training (12b's resume runs on a one-rank mesh: 13b)
    results["train"] = phase_train(device, smi, args.seed)
    mark("12 training")
    for k in kernels:
        k["launches_by_path"]["train_step"] = results["train"]["whole"]["launches"][k["name"]]
        k["launches_by_path"]["train_ckpt"] = results["train"]["cli"]["launches"][k["name"]]

    # 13. the device mesh
    results["mesh"] = phase_mesh(device, smi, args.seed)
    mark("13 mesh")

    # 14. the dry run
    results["dryrun"] = phase_dryrun(results["train"]["whole"], smi, args.seed)
    mark("14 dry run")
    results["wall_s"] = time.perf_counter() - t_start
    results["phase_s"] = phase_s
    say("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    say(f"the script took {results['wall_s']:.1f} s from its start (build included)")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1, default=str))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
