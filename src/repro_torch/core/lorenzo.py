"""Lorenzo-extrapolation decomposition (the cuSZ-L baseline, §2.2/§6.1.2), plain torch.

cuSZ's dual-quant trick: pre-quantize values to integers
(``pq = rint(x / 2eb)`` in f32, error <= eb), then take the exact integer
Lorenzo difference along every spatial axis. Decompression is an exact
integer prefix sum, so there is no reconstruction feedback loop. Deltas
with ``|c| > 127`` are outliers: the int32 delta is stored on the side and
the uint8 slot is the reserved code 0.

The same function as ``repro.core.lorenzo.lorenzo_encode`` /
``lorenzo_decode``, including the JAX package's int32 behaviour at the
edges: ``x / 2eb`` beyond the int32 range saturates to INT32_MIN/MAX (XLA's
convert), the differences and prefix sums wrap, and ``|c|`` is the wrapping
int32 abs, so ``c == INT32_MIN`` is not an outlier and clips to code 1. On
the card the encode is the lorenzo3d CUDA kernel
(repro_torch.kernels.lorenzo3d); the decode stays torch ops there too.
"""
from __future__ import annotations

import numpy as np
import torch

RADIUS = 127
CENTER = 128
_I32 = np.iinfo(np.int32)


def _twoeb(twoeb: float, device) -> torch.Tensor:
    # a 0-dim tensor on the field's device: torch divides by a CPU scalar on
    # the card as a multiply by its reciprocal, which is not IEEE division
    return torch.tensor(np.float32(twoeb), dtype=torch.float32, device=device)


def prequantize(x: torch.Tensor, twoeb: float) -> torch.Tensor:
    """``rint(x / twoeb)`` in f32 (half to even), saturated to int32."""
    q = torch.round(x.to(torch.float32) / _twoeb(twoeb, x.device))
    return q.to(torch.float64).clamp_(int(_I32.min), int(_I32.max)).to(torch.int32)


def _spatial_axes(ndim: int, ndim_spatial: int | None) -> range:
    nd = ndim if ndim_spatial is None else int(ndim_spatial)
    return range(ndim - nd, ndim)


def lorenzo_encode(x: torch.Tensor, twoeb: float, ndim_spatial: int | None = None):
    """x float (batch.., spatial) -> (codes u8, outlier mask bool, deltas int32)."""
    c = prequantize(x, twoeb).to(torch.int64)
    for ax in _spatial_axes(x.dim(), ndim_spatial):  # int64 differences, wrapped to int32 once at the end
        c = torch.diff(c, dim=ax, prepend=torch.zeros_like(c.narrow(ax, 0, 1)))
    c = c.to(torch.int32)
    outl = (c > RADIUS) | ((c < -RADIUS) & (c != int(_I32.min)))
    codes = torch.where(outl, 0, c.clamp(-RADIUS, RADIUS) + CENTER).to(torch.uint8)
    return codes, outl, c


def lorenzo_decode(codes: torch.Tensor, outlier_full: torch.Tensor, twoeb: float,
                   ndim_spatial: int | None = None) -> torch.Tensor:
    """u8 codes + a dense int32 outlier array (0 elsewhere) -> f32 recon."""
    q = torch.where(codes == 0, outlier_full.to(torch.int32), codes.to(torch.int32) - CENTER)
    for ax in _spatial_axes(codes.dim(), ndim_spatial):
        q = torch.cumsum(q, dim=ax).to(torch.int32)  # cumsum gives int64; int32 wraps as JAX's does
    return q.to(torch.float32) * _twoeb(twoeb, codes.device)


def offset1d_encode(x: torch.Tensor, twoeb: float) -> torch.Tensor:
    """cuSZp2-style 1-D offset prediction on the flattened field: the
    pre-quantized values' differences (int32, wrapping), first against 0."""
    pq = prequantize(x.reshape(-1), twoeb).to(torch.int64)
    return torch.diff(pq, prepend=pq.new_zeros(1)).to(torch.int32)


def offset1d_decode(codes: torch.Tensor, twoeb: float) -> torch.Tensor:
    """Inverse of :func:`offset1d_encode`: a wrapping int32 prefix sum times 2eb."""
    q = torch.cumsum(codes.to(torch.int64), 0).to(torch.int32)
    return q.to(torch.float32) * _twoeb(twoeb, codes.device)
