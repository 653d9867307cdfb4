"""Mapping-based quantization-code reordering (paper §5.1.4, Eq. 3).

Codes are emitted grouped by interpolation level — largest strides first —
row-major within each level. Anchor positions (every coordinate divisible
by the stride) carry no code and are excluded. The permutation is built
once per (shape, stride) and applied as a gather: with numpy on the host,
and with ``index_select`` on the tensor's device for the ``*_t`` twins.
Both give the JAX package's sequence byte for byte.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

ANCHOR_STRIDE = 16


@functools.lru_cache(maxsize=64)
def _level_of_shape(shape: tuple[int, ...], stride: int) -> np.ndarray:
    """Per-point hierarchy level: max l<=log2(stride) with 2^l | every coord."""
    lmax = int(np.log2(stride))
    lev = None
    for d in shape:
        c = np.arange(d)
        ld = np.full(d, 0, np.int8)
        for l in range(1, lmax + 1):
            ld[c % (1 << l) == 0] = l
        lev = ld if lev is None else np.minimum(lev[..., None], ld)
    return lev


@functools.lru_cache(maxsize=64)
def level_permutation(shape: tuple[int, ...], stride: int = ANCHOR_STRIDE):
    """(perm, pos): perm[j] = flat row-major index of the j-th code in the
    reordered sequence; pos undoes it (-1 at anchors)."""
    lev = _level_of_shape(shape, stride).reshape(-1)
    lmax = int(np.log2(stride))
    perm = np.concatenate([np.flatnonzero(lev == l) for l in range(lmax - 1, -1, -1)]).astype(np.int64)
    pos = np.full(int(np.prod(shape)), -1, np.int64)
    pos[perm] = np.arange(perm.size)
    return perm, pos


@functools.lru_cache(maxsize=64)
def flat_permutation(shape: tuple[int, ...], stride: int = ANCHOR_STRIDE) -> np.ndarray:
    """Non-anchor indices in plain row-major order (the no-reorder ablation)."""
    return np.sort(level_permutation(shape, stride)[0])


def _perm(shape, stride, reorder):
    return level_permutation(shape, stride)[0] if reorder else flat_permutation(shape, stride)


def reorder_codes_batch(grids: np.ndarray, stride: int = ANCHOR_STRIDE, reorder: bool = True) -> np.ndarray:
    """(batch, *shape) -> the per-item sequences concatenated."""
    perm = _perm(tuple(grids.shape[1:]), stride, reorder)
    return grids.reshape(grids.shape[0], -1)[:, perm].reshape(-1)


def restore_codes_batch(seq: np.ndarray, batch: int, shape: tuple[int, ...], fill, dtype,
                        stride: int = ANCHOR_STRIDE, reorder: bool = True) -> np.ndarray:
    """Inverse of reorder_codes_batch -> (batch, *shape); anchors get ``fill``."""
    perm = _perm(tuple(shape), stride, reorder)
    out = np.full((batch, int(np.prod(shape))), fill, dtype=dtype)
    out[:, perm] = seq.reshape(batch, perm.size)
    return out.reshape((batch,) + tuple(shape))


@functools.lru_cache(maxsize=4)
def _perm_t(shape: tuple[int, ...], stride: int, reorder: bool, device: str) -> torch.Tensor:
    """The permutation as an index tensor on ``device``, built there.

    Same bijection as the numpy permutation: per-point levels come from
    broadcast minima over per-dim levels, and each level's points are
    listed row-major by ``nonzero``. Building it on the device keeps a
    field-sized index off the host (a 513^3 field's is a GiB in int64).
    """
    dev = torch.device(device)
    lmax = int(np.log2(stride))
    lev = None
    for i, d in enumerate(shape):
        ld = torch.from_numpy(_level_of_shape((int(d),), stride)).to(dev)
        view = [1] * len(shape)
        view[i] = int(d)
        ld = ld.view(view)
        lev = ld if lev is None else torch.minimum(lev, ld)
    lev = lev.expand(tuple(int(d) for d in shape)).reshape(-1)
    if reorder:
        perm = torch.cat([torch.nonzero(lev == l).reshape(-1) for l in range(lmax - 1, -1, -1)])
    else:
        perm = torch.nonzero(lev < lmax).reshape(-1)
    if dev.type == "cuda":  # cached for every thread: finished before any other stream reads it
        torch.cuda.current_stream(dev).synchronize()
    return perm


def _perm_on_stream(shape, stride, reorder, device) -> torch.Tensor:
    """The cached permutation, marked as used by the current stream, so that
    its memory is not reused before this stream's reads when the cache
    drops it."""
    perm = _perm_t(shape, stride, bool(reorder), str(device))
    if perm.is_cuda:
        perm.record_stream(torch.cuda.current_stream(perm.device))
    return perm


def reorder_codes_batch_t(grids: torch.Tensor, stride: int = ANCHOR_STRIDE, reorder: bool = True) -> torch.Tensor:
    """Torch twin of reorder_codes_batch."""
    shape = tuple(int(s) for s in grids.shape[1:])
    perm = _perm_on_stream(shape, stride, reorder, grids.device)
    return grids.reshape(grids.shape[0], -1).index_select(1, perm).reshape(-1)


def restore_codes_batch_t(seq: torch.Tensor, batch: int, shape: tuple[int, ...], fill: int,
                          stride: int = ANCHOR_STRIDE, reorder: bool = True) -> torch.Tensor:
    """Torch twin of restore_codes_batch over a uint8 sequence."""
    shape = tuple(int(s) for s in shape)
    perm = _perm_on_stream(shape, stride, reorder, seq.device)
    out = torch.full((batch, int(np.prod(shape))), fill, dtype=seq.dtype, device=seq.device)
    out.index_copy_(1, perm, seq.reshape(batch, perm.numel()))
    return out.reshape((batch,) + shape)
