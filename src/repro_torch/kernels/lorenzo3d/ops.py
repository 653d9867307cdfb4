"""Wrapper of the Lorenzo encode CUDA kernel (csrc/lorenzo3d.cu).

``lorenzo_encode`` replaces the TPU kernel
``src/repro/kernels/lorenzo3d/lorenzo3d.py::_kernel`` (reached through
``lorenzo3d_codes``), with the pre-quantization of
``repro.core.lorenzo.lorenzo_encode`` fused in. Its plain version is
:func:`repro_torch.core.lorenzo.lorenzo_encode`.

On a CUDA tensor the wrapper launches the kernel or raises; a CPU tensor,
and only a CPU tensor, goes to the plain version. ``LAUNCHES`` counts the
kernel's launches: one per call, two when the outliers overflow the list
it sized first. The kernel writes the outliers in no order; the wrapper
sorts them by flat index, as ``torch.nonzero`` gives them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ...core import lorenzo as _plain
from ..build import KernelError, count_launch, library

LAUNCHES = {"lorenzo_encode": 0}
TILE_Y = 8    # rows of y in a tile where Y > 1, plus a halo row
WARP_Z = 256  # points of z per warp, 8 per lane; a tile has 8 // ty warps along z
MARCH = 32    # planes of x each CTA takes


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("lorenzo3d")
    vp, i64, i32, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.lorenzo_encode.argtypes = [vp, i64, i64, i64, i64, i32, i64, f, vp, vp, vp, i64, vp, vp, vp]
    lib.lorenzo_encode.restype = ctypes.c_int
    return lib


def launch_plan(shape, ndim_spatial: int) -> tuple[int, int, int, int, int]:
    """(rows, X, Y, Z, ty) of a (batch.., spatial) shape as the kernel takes
    it: 1-D fields as (rows, 1, 1, Z), 2-D fields (Y, Z) as (rows, Y, 1, Z),
    whose delta is the same and which march along Y; ``ty`` is the tile's
    rows of y, TILE_Y where Y > 1, else 1."""
    if not 0 <= ndim_spatial <= 3 or ndim_spatial > len(shape):
        raise ValueError(f"lorenzo_encode takes 0..3 spatial dims of a {len(shape)}-D tensor, got {ndim_spatial}")
    X, Y, Z = (1,) * (3 - ndim_spatial) + tuple(int(s) for s in shape[len(shape) - ndim_spatial:])
    if X == 1:
        X, Y = Y, 1
    rows = math.prod(int(s) for s in shape[: len(shape) - ndim_spatial])
    return rows, X, Y, Z, TILE_Y if Y > 1 else 1


def outlier_capacity(n: int) -> int:
    """Slots of the first outlier list: 1/64 of the points, at least 1024."""
    return min(n, max(1024, n // 64))


def lorenzo_encode(x: torch.Tensor, twoeb: float, ndim_spatial: int | None = None):
    """Lorenzo encode of a float32 (batch.., spatial) field.

    Returns (codes u8 of x's shape, outlier flat indices int64 ascending,
    their int32 deltas), on x's device.
    """
    nd = x.dim() if ndim_spatial is None else int(ndim_spatial)
    if x.device.type == "cpu":
        codes, outl, c = _plain.lorenzo_encode(x, twoeb, nd)
        idx = torch.nonzero(outl.reshape(-1)).reshape(-1)
        return codes, idx, c.reshape(-1)[idx]
    if x.device.type != "cuda":
        raise ValueError(f"lorenzo_encode takes a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"lorenzo_encode takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("lorenzo_encode takes a contiguous tensor")
    rows, X, Y, Z, ty = launch_plan(tuple(x.shape), nd)
    tiles = -(-Z // (8 // ty * WARP_Z)) * -(-Y // ty) * -(-X // MARCH) * rows
    if Y > 2**30 or Z > 2**30 or tiles >= 2**31:
        raise ValueError(f"lorenzo_encode: field {tuple(x.shape)} exceeds the kernel's index range")
    dev = x.device
    n = int(x.numel())
    codes = torch.empty(x.shape, dtype=torch.uint8, device=dev)
    if n == 0:
        return codes, torch.empty(0, dtype=torch.int64, device=dev), torch.empty(0, dtype=torch.int32, device=dev)
    lib = _lib()
    count = torch.empty(1, dtype=torch.int64, device=dev)
    total_h = torch.empty(1, dtype=torch.int64, pin_memory=True)  # the kernel's total, read once
    cap = outlier_capacity(n)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        while True:
            idx = torch.empty(cap, dtype=torch.int64, device=dev)
            vals = torch.empty(cap, dtype=torch.int32, device=dev)
            rc = lib.lorenzo_encode(ctypes.c_void_p(x.data_ptr()), rows, X, Y, Z, ty, MARCH, float(np.float32(twoeb)),
                                    ctypes.c_void_p(codes.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
                                    ctypes.c_void_p(vals.data_ptr()), cap, ctypes.c_void_p(count.data_ptr()),
                                    ctypes.c_void_p(total_h.data_ptr()), stream)
            if rc != 0:
                raise KernelError(f"lorenzo_encode launch failed with CUDA error {rc}")
            count_launch(LAUNCHES, "lorenzo_encode")
            total = int(total_h[0])  # the C call waited for it: it sizes the outputs
            if total <= cap:
                break
            cap = total  # the list overflowed: once more, at the exact total
    idx, vals = idx[:total], vals[:total]
    if total > 1:
        idx, order = torch.sort(idx)
        vals = vals[order]
    return codes, idx, vals
