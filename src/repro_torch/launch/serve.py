"""Batched serving driver: prefill a prompt batch, decode N tokens.

    python -m repro_torch.launch.serve --arch gemma3-12b --scaled --tokens 32 [--device cpu]
    python -m repro_torch.launch.serve --kv-compress [--compressd ADDR]

``--kv-compress`` pages the prefill KV cache out and back in through the
error-bounded compressor: after prefill, every float cache leaf rides the
cuSZ-Hi compressor with the orchestrated ``pipeline="auto"`` lossless
stack (best-fit registered pipeline per leaf) into a container-v3 frame
stream — one independently decodable frame per layer tensor, appended
incrementally — then the stream is read back frame by frame and decode
continues from the reconstructed cache: the paged-out/paged-in scenario
for long prompts. ``--compressd`` sends the leaves through a compressd
daemon (either package's) instead.

Flags, frame order and printed lines are the JAX package's
(``repro.launch.serve``). The driver runs on the card unless given
``--device cpu`` and raises where CUDA is absent. Tracing spans:
``serve.prefill``, ``serve.kv_offload``, ``serve.kv_restore``,
``serve.decode``.
"""
from __future__ import annotations

import argparse
import io
import time
import warnings

import torch
from torch.profiler import record_function as span

from ..configs import get_config
from ..core import Compressor, CompressorSpec
from ..core.frames import FrameReader, FrameWriter
from ..core.tree import leaf_paths, tree_map
from ..models import decode_step, init_params, model_device, prefill

DEFAULT_KV_SPEC = "lossy,rel,1e-3,autotune=false,pipeline=auto"
MIN_LEAF = 4096  # smaller leaves are bookkeeping, not KV data: they pass through


def _pages(leaf) -> bool:
    """Whether a cache leaf rides the compressor: a float tensor of at
    least MIN_LEAF elements."""
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and leaf.numel() >= MIN_LEAF


def _kv_roundtrip(cache, spec, compressd: str | None = None):
    """Offload+restore the float cache leaves as one v3 frame stream.

    Offload is *incremental*: each cache leaf (a layer's K or V tensor)
    compresses into its own container-v3 frame and is appended to the
    stream the moment it is ready. Restore streams the frames back in
    order (``FrameReader``) and rebuilds the cache leaf by leaf; each
    frame is independently decodable. Leaves go in the JAX package's
    flatten order (dict keys sorted). Non-float or tiny leaves pass
    through untouched.

    In process, a leaf is cast to float32 where it lives (no host bounce),
    compressed by a Compressor on that device and restored with
    ``decompress(..., out="device")``, cast back to the leaf's dtype. With
    ``compressd`` set (a daemon address, see
    :mod:`repro_torch.launch.compressd`) the per-leaf compress/decompress
    runs on the shared daemon instead; ``stats["plan_cache_hits"]`` counts
    its plan-cache hits. The frame-stream format is identical either way.

    Returns (restored cache, stats dict); a damaged frame leaves its leaf
    as it was and is reported under ``stats["damage"]``.
    """
    if isinstance(spec, str):  # canonical spec-string grammar
        spec = CompressorSpec.from_string(spec)
    leaves = [leaf for _, leaf in leaf_paths(cache)]
    framed = [i for i, leaf in enumerate(leaves) if _pages(leaf)]
    client = comp = None
    if compressd:
        from .compressd import CompressdClient

        client = CompressdClient(compressd, stream="serve-kv")
    else:
        comp = Compressor(spec, device=leaves[framed[0]].device if framed else "cpu")
    spec_str = spec.to_string()
    stats = {"raw_bytes": 0, "comp_bytes": 0, "frames": 0, "pipelines": {}}
    try:
        # ---- offload: one frame per float cache leaf, streamed as produced
        # (an encode failure aborts the writer: the stream stays truncated)
        sink = io.BytesIO()
        with span("serve.kv_offload"):
            with FrameWriter(sink, {"kind": "kvcache", "spec": spec_str}, sync=True) as writer:
                for i in framed:
                    leaf = leaves[i]
                    field = leaf.detach().float()
                    if client is not None:
                        buf = client.compress(field, spec=spec_str)
                        if (client.last_info or {}).get("plan_cache") == "hit":
                            stats["plan_cache_hits"] = stats.get("plan_cache_hits", 0) + 1
                    else:
                        buf = comp.compress(field)
                    writer.write_frame(buf)
                    picked = Compressor.inspect(buf).get("pipeline", "?")
                    stats["raw_bytes"] += leaf.numel() * leaf.element_size()
                    stats["comp_bytes"] += len(buf)
                    stats["pipelines"][picked] = stats["pipelines"].get(picked, 0) + 1
            stats["frames"] = writer.close()
        stats["stream_bytes"] = sink.tell()

        # ---- restore: stream the frames back, rebuilding leaf by leaf; a
        # damaged frame costs only its own layer (that leaf keeps its value)
        sink.seek(0)
        with span("serve.kv_restore"):
            reader = FrameReader(sink)
            for k, frame in reader.iter_frames(on_error="skip"):
                i = framed[k]
                leaf = leaves[i]
                if client is not None:
                    out = torch.from_numpy(client.decompress(frame)).to(leaf.device)
                else:
                    out = comp.decompress(frame, out="device")
                leaves[i] = out.reshape(leaf.shape).to(leaf.dtype)
            if not reader.damage.ok:
                stats["damage"] = reader.damage.summary()
    finally:
        if client is not None:
            client.close()
    it = iter(leaves)
    cache = tree_map(lambda _: next(it), cache)
    stats["cr"] = stats["raw_bytes"] / max(stats["comp_bytes"], 1)
    return cache, stats


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="prefill a prompt batch, decode N tokens")
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--scaled", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0, help="unused: decoding is greedy")
    ap.add_argument("--kv-compress", action="store_true",
                    help="offload/restore the prefill KV cache through pipeline='auto'")
    ap.add_argument("--kv-spec", default=None, metavar="SPEC",
                    help="compression spec string for --kv-compress "
                         "(CompressorSpec.from_string grammar; default "
                         f"{DEFAULT_KV_SPEC!r})")
    ap.add_argument("--kv-eb", type=float, default=None,
                    help="DEPRECATED: use --kv-spec 'lossy,rel,EB,...' instead")
    ap.add_argument("--compressd", default=None, metavar="ADDR",
                    help="route --kv-compress through a compressd daemon at "
                         "ADDR (host:port or unix:/path) instead of in-process")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; 'cpu' to run on the host)")
    return ap


def run(argv=None) -> dict:
    """The driver behind :func:`main`: parse ``argv``, serve, print the
    JAX package's lines, and return what they report: ``prefill_logits``
    (B, V), ``tokens`` (B, --tokens) greedy tokens, ``logits_finite``
    (every prefill and decode logit finite), ``kv`` (the offload's stats,
    or None), and the walls ``prefill_s``, ``kv_s``, ``decode_s``; also
    the state decoding ended in: ``cfg``, ``params`` and ``cache``."""
    ap = _parser()
    args = ap.parse_args(argv)
    kv_spec = args.kv_spec or DEFAULT_KV_SPEC
    if args.kv_compress and args.kv_eb is not None:
        if args.kv_spec is not None:
            ap.error("--kv-eb and --kv-spec are mutually exclusive")
        warnings.warn("--kv-eb is deprecated; use --kv-spec "
                      f"'lossy,rel,{args.kv_eb:g},autotune=false,pipeline=auto'",
                      DeprecationWarning, stacklevel=2)
        kv_spec = f"lossy,rel,{args.kv_eb:g},autotune=false,pipeline=auto"
    device = model_device(args.device)

    cfg = get_config(args.arch)
    if args.scaled:
        cfg = cfg.scaled()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    total = args.prompt_len + args.tokens
    batch = {"tokens": torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen, device=device)}
    if cfg.stub_frontend == "vit":
        batch["img"] = torch.zeros((args.batch, 0, cfg.d_model), dtype=torch.bfloat16, device=device)
    if cfg.enc_layers:
        batch["frames"] = torch.randn((args.batch, cfg.enc_seq, cfg.d_model), generator=gen,
                                      device=device).to(torch.bfloat16)

    _sync(device)
    t0 = time.perf_counter()
    with span("serve.prefill"):
        logits, cache = prefill(params, cfg, batch, cache_len=total)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits
    finite = torch.isfinite(logits).all()

    kv, t_kv = None, None
    if args.kv_compress:
        t0 = time.perf_counter()
        cache, kv = _kv_roundtrip(cache, kv_spec, compressd=args.compressd)
        _sync(device)
        t_kv = time.perf_counter() - t0
        via = f" via compressd {args.compressd} ({kv.get('plan_cache_hits', 0)} plan-cache hits)" \
            if args.compressd else ""
        print(
            f"kv-cache offload: {kv['raw_bytes']/2**20:.1f} MiB -> {kv['comp_bytes']/2**20:.1f} MiB "
            f"in {kv['frames']} layer-frames (CR {kv['cr']:.2f}, spec={kv_spec!r}, "
            f"pipelines {kv['pipelines']}, {t_kv:.2f}s roundtrip){via}"
        )

    tok = torch.argmax(logits, -1)
    out = [tok]
    t0 = time.perf_counter()
    with span("serve.decode"):
        for i in range(args.tokens - 1):
            logits, cache = decode_step(params, cfg, tok, args.prompt_len + i, cache)
            finite = finite & torch.isfinite(logits).all()
            tok = torch.argmax(logits, -1)
            out.append(tok)
        _sync(device)
    t_decode = time.perf_counter() - t0
    toks = torch.stack(out, 1).cpu().numpy()
    print(f"prefill {args.prompt_len} tok x{args.batch}: {t_prefill*1e3:.1f} ms")
    print(f"decode  {args.tokens} tok x{args.batch}: {t_decode*1e3:.1f} ms "
          f"({args.tokens*args.batch/max(t_decode,1e-9):.1f} tok/s)")
    print("sample:", toks[0, :16].tolist())
    return {"cfg": cfg, "params": params, "cache": cache, "prefill_logits": prefill_logits, "tokens": toks,
            "logits_finite": bool(finite), "kv": kv, "prefill_s": t_prefill, "kv_s": t_kv, "decode_s": t_decode}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
