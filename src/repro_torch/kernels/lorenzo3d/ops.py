"""Wrapper of the Lorenzo encode CUDA kernels (csrc/lorenzo3d.cu).

``lorenzo_encode`` replaces the TPU kernel
``src/repro/kernels/lorenzo3d/lorenzo3d.py::_kernel`` (reached through
``lorenzo3d_codes``), with the pre-quantization of
``repro.core.lorenzo.lorenzo_encode`` fused in. Its plain version is
:func:`repro_torch.core.lorenzo.lorenzo_encode`.

On a CUDA tensor the wrapper launches the kernels or raises; a CPU tensor,
and only a CPU tensor, goes to the plain version. ``LAUNCHES`` counts the
calls that launched them: a codes pass, then, when the field has outliers,
an outlier pass that writes them in order.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...core import lorenzo as _plain
from ..build import library

LAUNCHES = {"lorenzo_encode": 0}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("lorenzo3d")
    vp, i64, i32, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.lorenzo_tile.argtypes = []
    lib.lorenzo_tile.restype = ctypes.c_int
    lib.lorenzo_codes.argtypes = [vp, i64, i32, i32, i32, f, vp, vp, vp]
    lib.lorenzo_codes.restype = ctypes.c_int
    lib.lorenzo_outliers.argtypes = [vp, i64, i32, i32, i32, f, vp, vp, vp, vp, vp]
    lib.lorenzo_outliers.restype = ctypes.c_int
    return lib


def _field_geometry(shape, ndim_spatial: int) -> tuple[int, int, int, int]:
    """(rows, X, Y, Z) of a (batch.., spatial) shape: 1-D and 2-D fields run
    as (rows, 1, 1, Z) and (rows, 1, Y, Z)."""
    if not 0 <= ndim_spatial <= 3 or ndim_spatial > len(shape):
        raise ValueError(f"lorenzo_encode takes 0..3 spatial dims of a {len(shape)}-D tensor, got {ndim_spatial}")
    spatial = (1,) * (3 - ndim_spatial) + tuple(int(s) for s in shape[len(shape) - ndim_spatial:])
    rows = int(np.prod(shape[: len(shape) - ndim_spatial], dtype=np.int64))
    return (rows,) + spatial


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
    rows, X, Y, Z = _field_geometry(tuple(x.shape), nd)
    if rows * X * Y >= 2**32 or Z >= 2**31:
        raise ValueError(f"lorenzo_encode: field {tuple(x.shape)} exceeds the kernel's index range")
    dev = x.device
    n = int(x.numel())
    codes = torch.empty(x.shape, dtype=torch.uint8, device=dev)
    idx = torch.empty(0, dtype=torch.int64, device=dev)
    vals = torch.empty(0, dtype=torch.int32, device=dev)
    if n == 0:
        return codes, idx, vals
    lib = _lib()
    ncta = -(-n // lib.lorenzo_tile())
    counts = torch.empty(ncta, dtype=torch.int32, device=dev)
    geo = (ctypes.c_void_p(x.data_ptr()), n, X, Y, Z, float(np.float32(twoeb)))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.lorenzo_codes(*geo, ctypes.c_void_p(codes.data_ptr()), ctypes.c_void_p(counts.data_ptr()), stream)
        if rc != 0:
            raise RuntimeError(f"lorenzo_codes launch failed with CUDA error {rc}")
        LAUNCHES["lorenzo_encode"] += 1
        ends = torch.cumsum(counts, 0)
        total = int(ends[-1])
        if total:
            starts = ends - counts
            idx = torch.empty(total, dtype=torch.int64, device=dev)
            vals = torch.empty(total, dtype=torch.int32, device=dev)
            rc = lib.lorenzo_outliers(*geo, ctypes.c_void_p(starts.data_ptr()), ctypes.c_void_p(counts.data_ptr()),
                                      ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(vals.data_ptr()), stream)
            if rc != 0:
                raise RuntimeError(f"lorenzo_outliers launch failed with CUDA error {rc}")
    return codes, idx, vals
