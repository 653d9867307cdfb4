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
from ...core.stencils import Step, levels_for_stride
from ..build import KernelError, count_launch, library

LAUNCHES = {"interp_encode": 0, "interp_decode": 0}
ANCHOR_STRIDES = (16, 8, 4)  # the kernels' instantiations
MAX_PATTERNS = 4  # distinct rows (tap offsets and coefficients) of one level's operator


def _pack_rows(M: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One operator's rows: per row c the word tap count | column t << (3 + 5 t)
    | pattern << 23, and per pattern (a distinct row: tap offsets from c and
    coefficients) its coefficients. Rows without taps (never a target's)
    take pattern 0."""
    n, cols, cf = _plain.banded_rows(M)
    meta = np.zeros(M.shape[0], np.int32)
    coef = np.zeros((MAX_PATTERNS, _plain.MAX_TAPS), np.float32)
    patterns: list[tuple] = []
    for c in np.flatnonzero(n):
        key = (tuple(cols[c, : n[c]] - c), tuple(cf[c, : n[c]].tolist()))
        if key not in patterns:
            if len(patterns) == MAX_PATTERNS:
                raise ValueError(f"an operator has more than {MAX_PATTERNS} distinct rows")
            coef[len(patterns)] = cf[c]
            patterns.append(key)
        meta[c] = int(n[c]) | sum(int(cols[c, t]) << (3 + 5 * t) for t in range(_plain.MAX_TAPS)) \
            | patterns.index(key) << 23
    return meta, coef


def _coords(ndim: int) -> np.ndarray:
    """(ndim, 17**ndim) coordinates of each flat block index, dim 0 first."""
    return np.stack(np.unravel_index(np.arange(17**ndim), (17,) * ndim))


@functools.lru_cache(maxsize=None)
def pack_steps(steps: tuple[Step, ...], anchor_every: int) -> dict:
    """Kernel tables of one step hierarchy (numpy), in the compact form the
    kernels keep in shared memory.

    ``pts`` (u16): per target point, step after step (``step_off``
    delimits them) and within a step by used dims, its flat index | used-dims
    mask << 13; its blend weight is 1 / (number of used dims). ``step_op``:
    per step, its level's index; ``meta`` (i32): per level and operator row,
    the banded row's tap count | column t << (3 + 5 t) | pattern << 23, and
    ``coef`` (f32): per level and pattern (distinct row), its coefficients,
    in the plain predictor's order (``banded_rows``). ``image``: all of it
    as the int32 words the kernels copy into shared memory.

    Raises ValueError when the steps do not have the shape the kernels
    assume: 17^ndim blocks, ndim 1..3, an anchor stride of 16, 8 or 4 and
    its levels, one operator per level, two to four taps in a target's
    row, one blend weight 1 / (used dims) per point, every non-anchor point the target of exactly
    one step, and every tap on an anchor or a target of an earlier step
    (the kernels update one tile in place).
    """
    B = steps[0].mask.shape[0]
    ndim = steps[0].mask.ndim
    if B != 17 or not 1 <= ndim <= 3:
        raise ValueError(f"interp kernels take 17^ndim blocks with ndim 1..3, got B={B} ndim={ndim}")
    every = int(anchor_every)
    if every not in ANCHOR_STRIDES:
        raise ValueError(f"interp kernels take anchor strides {ANCHOR_STRIDES}, got {anchor_every}")
    levels = levels_for_stride(every)
    if len(steps) > ndim * len(levels):
        raise ValueError(f"{len(steps)} steps; the kernels take at most {ndim * len(levels)}")
    coords = _coords(ndim)
    sd = 17 ** np.arange(ndim - 1, -1, -1)
    meta = np.zeros((len(levels), B), np.int32)
    coef = np.zeros((len(levels), MAX_PATTERNS, _plain.MAX_TAPS), np.float32)
    ops = [None] * len(levels)
    done = np.all(coords % every == 0, axis=0)  # anchors
    pts, off, step_op = [], [0], []
    for st in steps:
        if st.level not in levels:
            raise ValueError(f"step at level {st.level}; anchor stride {every} has levels {levels}")
        op = levels.index(st.level)
        M0 = st.matrices[0]
        if any(not np.array_equal(M, M0) for M in st.matrices) or (ops[op] is not None and
                                                                     not np.array_equal(ops[op], M0)):
            raise ValueError("interp kernels need one operator per level")
        if ops[op] is None:
            ops[op] = M0
            meta[op], coef[op] = _pack_rows(M0)
        n, cols, _ = _plain.banded_rows(M0)
        idx = np.flatnonzero(st.mask.reshape(-1))
        if done[idx].any():
            raise ValueError("a point is the target of two steps or an anchor")
        dmask = np.zeros(idx.size, np.int32)
        for d, wd in zip(st.dims, st.weights):
            dmask |= (wd.reshape(-1)[idx] != 0).astype(np.int32) << d
        used = np.array([bin(m).count("1") for m in dmask])
        for d, wd in zip(st.dims, st.weights):
            wv = wd.reshape(-1)[idx]
            on = dmask >> d & 1 == 1
            if np.any(wv[on] != (np.float32(1) / used[on].astype(np.float32))):
                raise ValueError("interp kernels need the blend weight 1 / (used dims) per point")
            c = coords[d, idx[on]]
            if np.any(n[c] < 2):
                raise ValueError("interp kernels need two to four taps in a target's row")
            base = idx[on] - c * sd[d]
            for t in range(_plain.MAX_TAPS):
                has = n[c] > t
                if not done[base[has] + cols[c[has], t] * sd[d]].all():
                    raise ValueError("a tap reads a point that no earlier step reconstructs")
        done[idx] = True
        order = np.argsort(dmask, kind="stable")  # a warp's points share their used dims
        pts.append(idx[order] | (dmask[order] << 13))
        off.append(off[-1] + idx.size)
        step_op.append(op)
    if not done.all():
        raise ValueError("the steps leave points without a prediction")
    max_steps = ndim * len(levels)
    pts = np.concatenate(pts).astype(np.uint16)
    image = np.concatenate([
        coef.reshape(-1).view(np.int32), meta.reshape(-1),
        np.pad(np.asarray(off, np.int32), (0, max_steps + 1 - len(off)), mode="edge"),
        np.pad(np.asarray(step_op, np.int32), (0, max_steps - len(step_op))),
        np.pad(pts, (0, pts.size % 2)).view(np.int32),
    ]).astype(np.int32)
    return {
        "ndim": ndim,
        "every": every,
        "n_steps": len(steps),
        "pts": pts,
        "step_off": np.asarray(off, np.int32),
        "step_op": np.asarray(step_op, np.int32),
        "meta": meta,
        "coef": coef,
        "image": image,
    }


# One planner run (repro_torch.core.autotune.autotune_plan) at every anchor
# stride, (16, 8, 4), runs at most 3 splines x 3 schemes x (4 + 3 + 2)
# levels = 81 distinct step hierarchies; the cache holds them and the
# compressor's others, so one compress never evicts its own tables.
@functools.lru_cache(maxsize=128)
def _device_tables(steps: tuple[Step, ...], anchor_every: int, device: str) -> dict:
    tb = dict(pack_steps(steps, anchor_every))
    words = _lib().interp_table_words(tb["ndim"], tb["every"])
    if words != tb["image"].size:
        raise RuntimeError(f"step table image has {tb['image'].size} words, the kernels expect {words}")
    tb["image"] = torch.from_numpy(tb["image"]).to(device)
    return tb


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


def _check_stride(anchor_every) -> None:
    if anchor_every not in ANCHOR_STRIDES:
        raise ValueError(f"interp kernels take anchor strides {ANCHOR_STRIDES}, got {anchor_every}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("interp3d")
    vp, i64, i32, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    tables = [vp, i32, vp]  # image n_steps stream
    lib.interp_table_words.argtypes = [i32, i32]
    lib.interp_table_words.restype = ctypes.c_int
    lib.interp_encode.argtypes = [vp, vp, vp, i64, i32, i32, f, f] + tables
    lib.interp_encode.restype = ctypes.c_int
    lib.interp_decode.argtypes = [vp, vp, vp, vp, i64, vp, i64, i32, i32, f] + tables
    lib.interp_decode.restype = ctypes.c_int
    return lib


def _table_args(tb: dict, device) -> list:
    stream = torch.cuda.current_stream(device)
    # the cached image may be dropped while this stream still reads it (threads on other streams)
    tb["image"].record_stream(stream)
    return [_p(tb["image"]), tb["n_steps"], ctypes.c_void_p(stream.cuda_stream)]


def compress_blocks(blocks: torch.Tensor, twoeb: float, steps: tuple[Step, ...], anchor_every: int = 16,
                    *, with_recon: bool = True):
    """(nb, 17..) f32 blocks -> (codes u8, recon f32), same shape; the
    outliers are the code-0 points. ``with_recon=False`` returns recon None
    and the kernel writes the codes only."""
    if blocks.device.type == "cpu":
        codes, recon = _plain.compress_blocks(blocks, twoeb, steps, anchor_every)
        return codes, (recon if with_recon else None)
    _check_blocks(blocks, torch.float32, "blocks")
    _check_stride(anchor_every)
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
        raise KernelError(f"interp_encode launch failed with CUDA error {rc}")
    count_launch(LAUNCHES, "interp_encode")
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
    _check_stride(anchor_every)
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
    keys, order = torch.sort(out_keys)  # each CTA walks them in order
    vals = out_vals[order]
    with torch.cuda.device(codes.device):
        rc = _lib().interp_decode(_p(codes), _p(anchors), _p(keys), _p(vals), int(keys.numel()), _p(recon), nb,
                                  ndim, int(anchor_every), float(np.float32(twoeb)), *_table_args(tb, codes.device))
    if rc != 0:
        raise KernelError(f"interp_decode launch failed with CUDA error {rc}")
    count_launch(LAUNCHES, "interp_decode")
    return recon
