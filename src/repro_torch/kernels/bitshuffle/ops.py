"""Wrappers of the bit-plane shuffle CUDA kernels (csrc/bitshuffle.cu).

``bitshuffle`` replaces the TPU kernel
``src/repro/kernels/bitshuffle/bitshuffle.py::_kernel`` and
``bitunshuffle`` its ``_inv_kernel`` (both reached through
``bitshuffle_pallas_raw`` / ``bitunshuffle_pallas_raw`` from the JAX
engine's bit1 twins). The layout is the host stage's
(repro_torch.core.lossless.bitshuffle): per block, plane p holds bit 7-p of
every byte, packed MSB-first.

On a CUDA tensor each wrapper launches its kernel or raises; a CPU tensor,
and only a CPU tensor, goes to the plain version beside it. ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import KernelError, count_launch, library

BLOCK = 8192
LAUNCHES = {"bitshuffle": 0, "bitunshuffle": 0}


def _planes(g: torch.Tensor) -> torch.Tensor:
    """(nb, q, 8) bytes -> (nb, 8, q): byte q of plane p packs bit 7-p of
    bytes ``g[:, q, 0..7]``, MSB first."""
    out = []
    for p in range(8):
        bits = (g >> (7 - p)) & 1
        acc = bits[..., 0] << 7
        for j in range(1, 8):
            acc |= bits[..., j] << (7 - j)
        out.append(acc)
    return torch.stack(out, 1)


def _check_block(block: int) -> int:
    block = int(block)
    if block <= 0 or block % 8:
        raise ValueError(f"bitshuffle block must be a positive multiple of 8, got {block}")
    return block


def bitshuffle_plain(data: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Plain torch bitshuffle of a flat uint8 tensor, zero-padded to whole blocks."""
    block = _check_block(block)
    d = data.reshape(-1)
    n = int(d.numel())
    nb = -(-n // block)
    padded = torch.zeros(nb * block, dtype=torch.uint8, device=d.device)
    padded[:n] = d
    return _planes(padded.view(nb, block // 8, 8)).reshape(-1)


def bitunshuffle_plain(data: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Plain torch inverse: whole blocks of planes back to their bytes. Byte
    j of group q is plane-packing with the roles of bit and plane swapped,
    so it is ``_planes`` of the transposed view."""
    block = _check_block(block)
    d = data.reshape(-1)
    if d.numel() % block:
        raise ValueError(f"bitunshuffle takes whole blocks of {block} bytes, got {d.numel()}")
    nb = int(d.numel()) // block
    return _planes(d.view(nb, 8, block // 8).transpose(1, 2)).transpose(1, 2).reshape(-1)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("bitshuffle")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bitshuffle.argtypes = [vp, i64, vp, i64, i32, vp]
    lib.bitshuffle.restype = ctypes.c_int
    lib.bitunshuffle.argtypes = [vp, vp, i64, i32, vp]
    lib.bitunshuffle.restype = ctypes.c_int
    return lib


def _card_input(data: torch.Tensor, name: str) -> torch.Tensor:
    if data.device.type != "cuda":
        raise ValueError(f"{name} takes a CPU or CUDA tensor, got {data.device}")
    if data.dtype != torch.uint8:
        raise TypeError(f"{name} takes uint8, got {data.dtype}")
    d = data.reshape(-1).contiguous()
    if d.data_ptr() % 16:
        d = d.clone()  # the kernels load 16-byte vectors
    return d


def _card_block(block: int) -> int:
    block = _check_block(block)
    if block % 32:  # the kernels take four 8-byte groups a thread; the format's blocks are 8192
        raise ValueError(f"the bitshuffle kernels take blocks that are a multiple of 32 bytes, got {block}")
    return block


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def bitshuffle(data: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Bit planes of a flat uint8 tensor, per block; ``ceil(n/block)*block``
    bytes (the tail shuffles as zero padding), on the input's device."""
    if data.device.type == "cpu":
        return bitshuffle_plain(data, block)
    d = _card_input(data, "bitshuffle")
    block = _card_block(block)
    n = int(d.numel())
    nb = -(-n // block)
    out = torch.empty(nb * block, dtype=torch.uint8, device=d.device)
    if nb == 0:
        return out
    with torch.cuda.device(d.device):
        rc = _lib().bitshuffle(ctypes.c_void_p(d.data_ptr()), n, ctypes.c_void_p(out.data_ptr()), nb, block,
                               _stream(d.device))
    if rc != 0:
        raise KernelError(f"bitshuffle launch failed with CUDA error {rc}")
    count_launch(LAUNCHES, "bitshuffle")
    return out


def bitunshuffle(data: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Inverse of :func:`bitshuffle` over whole blocks: same length out."""
    if data.device.type == "cpu":
        return bitunshuffle_plain(data, block)
    d = _card_input(data, "bitunshuffle")
    block = _card_block(block)
    if d.numel() % block:
        raise ValueError(f"bitunshuffle takes whole blocks of {block} bytes, got {d.numel()}")
    nb = int(d.numel()) // block
    out = torch.empty_like(d)
    if nb == 0:
        return out
    with torch.cuda.device(d.device):
        rc = _lib().bitunshuffle(ctypes.c_void_p(d.data_ptr()), ctypes.c_void_p(out.data_ptr()), nb, block,
                                 _stream(d.device))
    if rc != 0:
        raise KernelError(f"bitunshuffle launch failed with CUDA error {rc}")
    count_launch(LAUNCHES, "bitunshuffle")
    return out
