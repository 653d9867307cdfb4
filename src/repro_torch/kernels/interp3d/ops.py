"""Wrappers of the interp encode/decode CUDA kernels (csrc/interp3d.cu).

``compress_blocks`` replaces the TPU kernel
``src/repro/kernels/interp3d/interp3d.py::_kernel`` (reached through
``ops.compress_blocks_pallas``); ``decompress_blocks`` is the kernel form
of the predictor's replay. Both take blocks in the public
``(nb, 17, .., 17)`` layout of repro_torch.core.predictor, which holds
their plain versions; the decode takes anchors and outliers compact.

On a CUDA tensor each wrapper launches its kernel or raises; a CPU tensor,
and only a CPU tensor, goes to the plain version. ``LAUNCHES`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...core import predictor as _plain
from ...core.stencils import Step
from ..build import library

LAUNCHES = {"interp_encode": 0, "interp_decode": 0}


@functools.lru_cache(maxsize=None)
def pack_steps(steps: tuple[Step, ...], anchor_every: int) -> dict:
    """Kernel tables of one step hierarchy (numpy).

    ``pts``: per target point, its flat index | used-dims mask << 16, step
    after step (``step_off`` delimits them); ``wts``: the point's blend
    weight. ``tapn/tapj/tapw``: per step and operator row, the banded
    row's taps (count, ascending columns, coefficients). Raises when a
    table does not have the shape the kernel assumes: one operator per
    step, at most four taps a row, one weight shared by a point's dims.
    The taps are the plain predictor's (``banded_rows``), in its order.
    """
    B = steps[0].mask.shape[0]
    ndim = steps[0].mask.ndim
    if B != 17 or not 1 <= ndim <= 3:
        raise ValueError(f"interp kernels take 17^ndim blocks with ndim 1..3, got B={B} ndim={ndim}")
    pts, wts, off = [], [], [0]
    tapn = np.zeros((len(steps), B), np.uint8)
    tapj = np.zeros((len(steps), B, _plain.MAX_TAPS), np.int8)
    tapw = np.zeros((len(steps), B, _plain.MAX_TAPS), np.float32)
    for k, st in enumerate(steps):
        M0 = st.matrices[0]
        if any(not np.array_equal(M, M0) for M in st.matrices):
            raise ValueError("interp kernels need one operator per step")
        idx = np.flatnonzero(st.mask.reshape(-1))
        dmask = np.zeros(idx.size, np.int32)
        w = np.zeros(idx.size, np.float32)
        for d, wd in zip(st.dims, st.weights):
            wv = wd.reshape(-1)[idx]
            used = wv != 0
            if np.any(used & (dmask != 0) & (w != wv)):
                raise ValueError("interp kernels need one blend weight per point")
            w = np.where(used, wv, w).astype(np.float32)
            dmask |= used.astype(np.int32) << d
        pts.append(idx.astype(np.int32) | (dmask << 16))
        wts.append(w)
        off.append(off[-1] + idx.size)
        tapn[k], tapj[k], tapw[k] = _plain.banded_rows(M0)
    return {
        "ndim": ndim,
        "n_steps": len(steps),
        "pts": np.concatenate(pts).astype(np.int32),
        "wts": np.concatenate(wts).astype(np.float32),
        "step_off": np.asarray(off, np.int32),
        "tapn": tapn,
        "tapj": tapj,
        "tapw": tapw,
    }


@functools.lru_cache(maxsize=64)
def _device_tables(steps: tuple[Step, ...], anchor_every: int, device: str) -> dict:
    tb = pack_steps(steps, anchor_every)
    out = dict(tb)
    for key in ("pts", "wts", "step_off", "tapn", "tapj", "tapw"):
        out[key] = torch.from_numpy(np.ascontiguousarray(tb[key])).to(device)
    return out


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(t: torch.Tensor, dtype, name: str, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_blocks(t: torch.Tensor, dtype, name: str):
    _check(t, dtype, name)
    if not 2 <= t.dim() <= 4 or any(int(s) != 17 for s in t.shape[1:]):
        raise ValueError(f"{name} must be (nb, 17, ..) with 1..3 spatial dims, got {tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("interp3d")
    vp, i64, i32, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    tables = [vp, vp, vp, i32, vp, vp, vp, vp]  # pts wts step_off n_steps tapn tapj tapw stream
    lib.interp_encode.argtypes = [vp, vp, vp, i64, i32, i32, f, f] + tables
    lib.interp_encode.restype = ctypes.c_int
    lib.interp_decode.argtypes = [vp, vp, vp, vp, i64, vp, i64, i32, i32, f] + tables
    lib.interp_decode.restype = ctypes.c_int
    return lib


def _table_args(tb: dict, device) -> list:
    stream = torch.cuda.current_stream(device).cuda_stream
    return [_p(tb["pts"]), _p(tb["wts"]), _p(tb["step_off"]), tb["n_steps"],
            _p(tb["tapn"]), _p(tb["tapj"]), _p(tb["tapw"]), ctypes.c_void_p(stream)]


def compress_blocks(blocks: torch.Tensor, twoeb: float, steps: tuple[Step, ...], anchor_every: int = 16,
                    *, with_recon: bool = True):
    """(nb, 17..) f32 blocks -> (codes u8, recon f32), same shape; the
    outliers are the code-0 points. ``with_recon=False`` returns recon None
    and the kernel writes the codes only."""
    if blocks.device.type == "cpu":
        codes, recon = _plain.compress_blocks(blocks, twoeb, steps, anchor_every)
        return codes, (recon if with_recon else None)
    _check_blocks(blocks, torch.float32, "blocks")
    codes = torch.empty(blocks.shape, dtype=torch.uint8, device=blocks.device)
    recon = torch.empty_like(blocks) if with_recon else None
    nb = int(blocks.shape[0])
    if nb == 0:
        return codes, recon
    tb = _device_tables(steps, int(anchor_every), str(blocks.device))
    if tb["ndim"] != blocks.dim() - 1:
        raise ValueError(f"step tables are {tb['ndim']}-D, blocks are {blocks.dim() - 1}-D")
    tw = np.float32(twoeb)
    with torch.cuda.device(blocks.device):
        rc = _lib().interp_encode(_p(blocks), _p(codes), None if recon is None else _p(recon), nb, tb["ndim"],
                                  int(anchor_every), float(tw), float(np.float32(1.0) / tw),
                                  *_table_args(tb, blocks.device))
    if rc != 0:
        raise RuntimeError(f"interp_encode launch failed with CUDA error {rc}")
    LAUNCHES["interp_encode"] += 1
    return codes, recon


def decompress_blocks(codes: torch.Tensor, anchors: torch.Tensor, out_keys: torch.Tensor, out_vals: torch.Tensor,
                      twoeb: float, steps: tuple[Step, ...], anchor_every: int = 16) -> torch.Tensor:
    """Replay: (nb, 17..) u8 codes, the blocks' anchors (nb, A..) f32 with
    A = 16 // anchor_every + 1, and the outliers as int64 keys
    ``block * 17**ndim + cell`` (unique, any order) with their f32 values
    -> f32 recon (nb, 17..)."""
    if codes.device.type == "cpu":
        return _plain.decompress_blocks(codes, anchors, out_keys, out_vals, twoeb, steps, anchor_every)
    _check_blocks(codes, torch.uint8, "codes")
    nb, ndim = int(codes.shape[0]), codes.dim() - 1
    _check(anchors, torch.float32, "anchors", (nb,) + (16 // int(anchor_every) + 1,) * ndim)
    _check(out_keys, torch.int64, "out_keys", (int(out_keys.numel()),))
    _check(out_vals, torch.float32, "out_vals", out_keys.shape)
    recon = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    if nb == 0:
        return recon
    tb = _device_tables(steps, int(anchor_every), str(codes.device))
    if tb["ndim"] != ndim:
        raise ValueError(f"step tables are {tb['ndim']}-D, codes are {ndim}-D")
    keys, order = torch.sort(out_keys)  # the kernel binary-searches them
    vals = out_vals[order]
    with torch.cuda.device(codes.device):
        rc = _lib().interp_decode(_p(codes), _p(anchors), _p(keys), _p(vals), int(keys.numel()), _p(recon), nb,
                                  ndim, int(anchor_every), float(np.float32(twoeb)), *_table_args(tb, codes.device))
    if rc != 0:
        raise RuntimeError(f"interp_decode launch failed with CUDA error {rc}")
    LAUNCHES["interp_decode"] += 1
    return recon
