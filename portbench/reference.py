"""The plain reference that decides ``correct``: the configuration's guarantee, worked out again.

It reads only what the harness made itself (the input fields) and what the
program handed back (container bytes, decoded fields), never anything the
program derived. Plain PyTorch; nothing of the program is imported.

- The guarantee of an error-bounded compressor in ``rel`` mode: every
  decoded point within ``eb * (max x - min x)`` of its input, the range
  taken in float64 from the input. ``max_abs_diff`` walks a field in slabs
  so that the check adds little memory; a non-finite point, or a decoded
  field of another shape or type, reads as an infinite error.
- ``plain_bf16`` is the control: a plain uniform quantizer under the same
  bound, computed in bfloat16, the precision below the configuration's
  float32, put in the program's place.
"""
from __future__ import annotations

import math

import torch

SLAB_POINTS = 1 << 24  # points a slab of the error check reads at once


def value_range(x: torch.Tensor) -> float:
    """max - min of a field, in float64."""
    return float(x.max().double() - x.min().double()) if x.numel() else 0.0


def abs_bound(eb: float, eb_mode: str, x: torch.Tensor) -> float:
    """The absolute bound of the configuration's ``rel`` guarantee on field ``x``."""
    if eb_mode != "rel":
        raise ValueError(f"the reference knows the 'rel' bound, not {eb_mode!r}")
    return float(eb) * value_range(x)


def max_abs_diff(x: torch.Tensor, y) -> float:
    """max |y - x| over every point in float64; inf where ``y`` is not a
    float32 tensor of ``x``'s shape on ``x``'s device or holds a non-finite
    point."""
    if (not isinstance(y, torch.Tensor) or y.shape != x.shape or y.dtype != torch.float32
            or y.device != x.device):
        return math.inf
    xf, yf = x.reshape(-1), y.reshape(-1)
    worst = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo in range(0, xf.numel(), SLAB_POINTS):
        d = (yf[lo: lo + SLAB_POINTS].double() - xf[lo: lo + SLAB_POINTS].double()).abs()
        worst = torch.maximum(worst, d.max())
    finite = bool(torch.isfinite(yf).all())
    return float(worst) if finite else math.inf


class PlainBF16:
    """The control codec: ``q = round(x / 2eb)``, ``x' = 2eb q``, every step
    in bfloat16, carried in a container v2 of the benchmark's own writer."""

    def __init__(self, eb: float, eb_mode: str, device):
        self.eb, self.eb_mode, self.device = float(eb), eb_mode, device

    def compress(self, x: torch.Tensor) -> bytes:
        from .container import pack

        eb_abs = abs_bound(self.eb, self.eb_mode, x)
        step = torch.tensor(2.0 * eb_abs, dtype=torch.bfloat16, device=x.device)
        q = torch.round(x.to(torch.bfloat16) / step).to(torch.int32)
        header = {"shape": list(x.shape), "mode": "plain-bf16", "eb_abs": eb_abs}
        return pack(header, [q.cpu().numpy().tobytes()])

    def decompress(self, buf: bytes) -> torch.Tensor:
        import numpy as np

        from .container import parse

        header, sections = parse(buf)
        q = torch.from_numpy(np.frombuffer(sections[0], np.int32).copy()).to(self.device)
        step = torch.tensor(2.0 * header["eb_abs"], dtype=torch.bfloat16, device=self.device)
        return (q.to(torch.bfloat16) * step).to(torch.float32).reshape(header["shape"])

    def counters(self) -> dict:
        return {}

    def last_repairs(self) -> int:
        return 0
