"""Per-field best-fit lossless pipeline (paper §5.2's exploration), online.

The best encoding stack depends on the data: dense high-entropy code
streams want Huffman first (``cr``), sparse or run-heavy streams want
shuffle and run reduction (``tp``, ``fz``), near-incompressible streams want
store-through (``none``). Per field this module

1. samples the code stream: four contiguous windows, so runs survive (a
   strided sample would destroy them); a tensor is sliced on its device;
2. computes cheap statistics of the sample: byte-histogram entropy, zero
   and outlier fractions and the run fraction. For a tensor the histogram
   is repro_torch.kernels.histogram.histogram256 (the CUDA kernel on the
   card, its plain version on the CPU); for a numpy array ``np.bincount``.
   Both are exact integer counts and ``run_frac`` is an exact integer
   ratio, so every statistic, estimate and choice is the same either way;
3. pre-scores every registered pipeline by the stages' ``estimate`` hooks,
   trial-encodes the sample through the best candidates (on the tensor's
   device for a tensor) and picks the smallest output.

The choice and its record (``pipeline``, ``stats``, ``estimates``,
``trial_bytes``) are the JAX package's (``repro.core.lossless.orchestrate``)
float for float; the compressor writes the record into the container
header, and decode never re-infers anything.
"""
from __future__ import annotations

import numpy as np
import torch

from ...kernels.histogram import histogram256
from .pipelines import PIPELINES, encode, get_pipeline
from .stages import get_stage

DEFAULT_SAMPLE_BYTES = 1 << 16
_N_SLICES = 4


def _flat_u8(data):
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).to(torch.uint8)
    return np.ascontiguousarray(data, np.uint8).reshape(-1)


def sample_stream(data, sample_bytes: int = DEFAULT_SAMPLE_BYTES):
    """``_N_SLICES`` evenly spaced contiguous windows of ``data`` (the
    stream itself when it fits the budget); a tensor stays on its device."""
    data = _flat_u8(data)
    n = int(data.numel()) if isinstance(data, torch.Tensor) else data.size
    if n <= sample_bytes:
        return data
    per = sample_bytes // _N_SLICES
    starts = [(n - per) * i // (_N_SLICES - 1) for i in range(_N_SLICES)]
    parts = [data[s : s + per] for s in starts]
    return torch.cat(parts) if isinstance(data, torch.Tensor) else np.concatenate(parts)


def histogram_stats(hist) -> dict:
    """Entropy (bits per byte), zero and outlier fractions of 256 byte counts."""
    hist = np.asarray(hist, np.int64)
    m = int(hist.sum())
    if m == 0:
        return {"entropy": 0.0, "zero_frac": 0.0, "outlier_frac": 0.0}
    p = hist[hist > 0].astype(np.float64) / m
    return {"entropy": float(-(p * np.log2(p)).sum()), "zero_frac": float(hist[0]) / m,
            # outliers: codes far from the 128-centred quantization band
            "outlier_frac": float(hist[:64].sum() + hist[192:].sum()) / m}


def stream_stats(sample, n_total: int | None = None) -> dict:
    """Statistics of a uint8 sample that drive the stages' cost hooks."""
    sample = _flat_u8(sample)
    if isinstance(sample, torch.Tensor):
        n = int(sample.numel())
        hist = histogram256(sample).cpu().numpy()
        # exact integer ratio: np.mean's float64 arithmetic on the host path
        run_frac = float(int((sample[1:] == sample[:-1]).sum())) / (n - 1) if n > 1 else 0.0
    else:
        n = sample.size
        hist = np.bincount(sample, minlength=256)
        run_frac = float(np.mean(sample[1:] == sample[:-1])) if n > 1 else 0.0
    hs = histogram_stats(hist)
    return {"n": int(n_total if n_total is not None else n), "sample_n": int(n), "entropy": hs["entropy"],
            "zero_frac": hs["zero_frac"], "run_frac": run_frac, "outlier_frac": hs["outlier_frac"]}


def estimate_pipeline(stages, stats: dict) -> float:
    """Predicted compressed fraction: the product of the stages' cost hooks."""
    frac = 1.0
    for name in stages:
        frac *= min(1.0, float(get_stage(name).estimate(stats)))
    return frac


def portable_pipelines() -> list[str]:
    """Registered pipelines whose every stage decodes without an optional package."""
    return sorted(nm for nm, stages in PIPELINES.items() if all(get_stage(s).portable for s in stages))


def _choose(data, candidates=None, *, sample_bytes: int = DEFAULT_SAMPLE_BYTES, max_trials: int | None = None,
            portable_only: bool = False, tel: dict | None = None):
    if candidates is not None:
        names = sorted(candidates)
    elif portable_only:
        names = portable_pipelines()
    else:
        names = sorted(PIPELINES)
    for nm in names:
        get_pipeline(nm)  # raises with the registered list on typos
    data = _flat_u8(data)
    sample = sample_stream(data, sample_bytes)
    n = int(data.numel()) if isinstance(data, torch.Tensor) else data.size
    stats = stream_stats(sample, n_total=n)
    est = {nm: estimate_pipeline(get_pipeline(nm), stats) for nm in names}
    order = sorted(names, key=lambda nm: (est[nm], nm))
    if max_trials is not None:
        order = order[: max(1, max_trials)]
    bufs = {nm: encode(sample, nm, tel=tel) for nm in order}
    trial = {nm: len(b) for nm, b in bufs.items()}
    best = min(order, key=lambda nm: (trial[nm], nm))
    record = {"pipeline": best, "stats": stats, "estimates": est, "trial_bytes": trial}
    # a stream that fits the sample budget is its own sample: the winning
    # trial is the final encoding
    sample_n = int(sample.numel()) if isinstance(sample, torch.Tensor) else sample.size
    return best, record, (bufs[best] if sample_n == n else None)


def choose_pipeline(data, candidates=None, **kw) -> tuple[str, dict]:
    """``(name, record)`` of the best-fit registered pipeline for ``data``.

    ``candidates`` narrows the search, ``portable_only=True`` restricts it
    to :func:`portable_pipelines`, ``max_trials`` caps the trial encodes to
    the best-estimated candidates.
    """
    best, record, _ = _choose(data, candidates, **kw)
    return best, record


def encode_auto(data, **kw) -> tuple[bytes, dict]:
    """Choose the best-fit pipeline, then encode: ``(stream, record)``. A
    stream no larger than the sample budget is encoded once."""
    best, record, full = _choose(data, **kw)
    if full is not None:
        return full, record
    return encode(data, best, tel=kw.get("tel")), record
