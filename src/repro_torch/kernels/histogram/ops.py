"""Wrapper of the histogram256 CUDA kernel (csrc/histogram.cu).

Replaces the TPU kernel ``src/repro/kernels/histogram/histogram.py::_kernel``
(reached through ``ops.histogram256_pallas``). The plain version for a CPU
tensor is ``torch.bincount``; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import library

LAUNCHES = {"histogram256": 0}


def histogram256_plain(data: torch.Tensor) -> torch.Tensor:
    """Exact 256-bin counts (int64) of a uint8 tensor, by ``torch.bincount``."""
    return torch.bincount(data.reshape(-1), minlength=256).to(torch.int64)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("histogram")
    lib.histogram256.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.histogram256.restype = ctypes.c_int
    return lib


def histogram256(data: torch.Tensor) -> torch.Tensor:
    """Exact 256-bin counts (int64, on the input's device) of a uint8 tensor."""
    if data.device.type == "cpu":
        return histogram256_plain(data)
    if data.device.type != "cuda":
        raise ValueError(f"histogram256 takes a CPU or CUDA tensor, got {data.device}")
    if data.dtype != torch.uint8:
        raise TypeError(f"histogram256 takes uint8, got {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("histogram256 takes a contiguous tensor")
    out = torch.empty(256, dtype=torch.int64, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = _lib().histogram256(ctypes.c_void_p(data.data_ptr()), int(data.numel()),
                                 ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"histogram256 launch failed with CUDA error {rc}")
    LAUNCHES["histogram256"] += 1
    return out
