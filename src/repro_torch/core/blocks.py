"""Block partitioning for the cuSZ-Hi predictor (paper §5.1.1).

The field is cut into isotropic 17^ndim blocks whose corners are the
losslessly stored anchor points (anchor stride 16 per dim). Adjacent blocks
share their boundary faces; face points are predicted identically by both
owners (a face point's stencil never leaves the face), so the scatter back
to the field may take either copy. The ownership rule, shared with the JAX
package: each block owns its half-open [0, stride)^ndim cells, and the last
block along a dim also owns the global far face.

Every function has a host twin on numpy arrays and a ``*_t`` twin on torch
tensors (on any device); both give the same values in the same order.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

ANCHOR_STRIDE = 16
BLOCK = ANCHOR_STRIDE + 1  # 17: closed block [0, 16]^ndim


def padded_shape(shape: tuple[int, ...], stride: int = ANCHOR_STRIDE) -> tuple[int, ...]:
    """Each dim padded up to k*stride + 1 so every block is complete."""
    out = []
    for d in shape:
        k = max(1, -(-max(d - 1, 1) // stride))  # ceil((d-1)/stride), >= 1
        out.append(k * stride + 1)
    return tuple(out)


def block_grid(shape_padded: tuple[int, ...], stride: int = ANCHOR_STRIDE) -> tuple[int, ...]:
    return tuple((d - 1) // stride for d in shape_padded)


# --------------------------------------------------------------------- host
def pad_field_batch(xb: np.ndarray, stride: int = ANCHOR_STRIDE) -> np.ndarray:
    """Edge-replicate pad: (batch, *spatial) -> (batch, *padded)."""
    tgt = padded_shape(xb.shape[1:], stride)
    pads = [(0, 0)] + [(0, t - s) for s, t in zip(xb.shape[1:], tgt)]
    if all(p == (0, 0) for p in pads[1:]):
        return xb
    return np.pad(xb, pads, mode="edge")


def gather_blocks_batch(xpb: np.ndarray, stride: int = ANCHOR_STRIDE) -> np.ndarray:
    """(batch, *padded) -> (batch*nb, B, B, ...) overlapping closed blocks,
    block-major in row-major block-grid order per batch item."""
    B = stride + 1
    ndim = xpb.ndim - 1
    win = np.lib.stride_tricks.sliding_window_view(xpb, (B,) * ndim, axis=tuple(range(1, ndim + 1)))
    sl = (slice(None),) + tuple(slice(None, None, stride) for _ in range(ndim))
    blocks = win[sl]  # (batch, nb0, nb1, ..., B, B, ...)
    nb = int(np.prod(blocks.shape[1 : 1 + ndim]))
    # a copy even where the window view is already contiguous: the caller gets a writable array
    return np.array(blocks.reshape((xpb.shape[0] * nb,) + (B,) * ndim), order="C")


def scatter_blocks_batch(blocks: np.ndarray, batch: int, shape_padded: tuple[int, ...],
                         stride: int = ANCHOR_STRIDE) -> np.ndarray:
    """Inverse of gather_blocks_batch: (batch*nb, B..) -> (batch, *padded)."""
    ndim = len(shape_padded)
    nbs = block_grid(shape_padded, stride)
    out = np.empty((batch,) + tuple(shape_padded), dtype=blocks.dtype)
    bl = blocks.reshape((batch,) + nbs + (stride + 1,) * ndim)
    nil = (slice(None),)
    for far in itertools.product((False, True), repeat=ndim):
        # destination: interior cells on non-far dims, the last plane on far dims
        dst = tuple(slice(0, shape_padded[d] - 1) if not far[d] else slice(shape_padded[d] - 1, shape_padded[d])
                    for d in range(ndim))
        # source: every block, cells 0..stride-1 on non-far dims; last block, cell=stride on far dims
        src_blk = tuple(slice(None) if not far[d] else slice(nbs[d] - 1, nbs[d]) for d in range(ndim))
        src_cell = tuple(slice(0, stride) if not far[d] else slice(stride, stride + 1) for d in range(ndim))
        sub = bl[nil + src_blk + src_cell]
        perm = [0]
        for d in range(ndim):
            perm += [1 + d, 1 + ndim + d]
        sub = np.transpose(sub, perm)
        new_shape = (batch,) + tuple(sub.shape[1 + 2 * d] * sub.shape[2 + 2 * d] for d in range(ndim))
        out[nil + dst] = sub.reshape(new_shape)
    return out


def anchor_grid_batch(xpb: np.ndarray, stride: int = ANCHOR_STRIDE) -> np.ndarray:
    """(batch, *padded) -> (batch, *anchor_shape): every coordinate divisible by the stride."""
    sl = (slice(None),) + tuple(slice(None, None, stride) for _ in range(xpb.ndim - 1))
    return np.ascontiguousarray(xpb[sl])


# ------------------------------------------------------------------- torch
def pad_field_batch_t(xb: torch.Tensor, stride: int = ANCHOR_STRIDE) -> torch.Tensor:
    """Torch twin of pad_field_batch: ``F.pad`` in replicate mode is numpy's
    edge padding. The channel axis F.pad wants is a size-1 view."""
    spatial = tuple(xb.shape[1:])
    tgt = padded_shape(spatial, stride)
    if tgt == spatial:
        return xb
    pads = []
    for s, t in zip(reversed(spatial), reversed(tgt)):  # F.pad lists the last dim first
        pads += [0, t - s]
    return F.pad(xb.unsqueeze(1), pads, mode="replicate").squeeze(1)


def gather_blocks_batch_t(xpb: torch.Tensor, stride: int = ANCHOR_STRIDE) -> torch.Tensor:
    """Torch twin of gather_blocks_batch: one ``unfold`` per spatial dim
    gives the B-wide windows at the given stride; reshape copies them out.
    The result is contiguous, as the kernels require: where the field has
    one block along every dim but the last, reshape alone would return a
    strided view of the padded field."""
    B = stride + 1
    ndim = xpb.dim() - 1
    win = xpb
    for d in range(ndim):
        win = win.unfold(1 + d, B, stride)  # (batch, nb0.., B..) with window dims appended
    nb = 1
    for d in range(ndim):
        nb *= win.shape[1 + d]
    return win.reshape((xpb.shape[0] * nb,) + (B,) * ndim).contiguous()


def _owner_index(n_padded: int, stride: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per padded coordinate along one dim: (owning block, cell in it) under
    the ownership rule of the module docstring."""
    nbd = (n_padded - 1) // stride
    i = torch.arange(n_padded, device=device)
    blk = torch.clamp(i // stride, max=nbd - 1)
    return blk, i - blk * stride


def scatter_blocks_batch_t(blocks: torch.Tensor, batch: int, shape_padded: tuple[int, ...],
                           stride: int = ANCHOR_STRIDE) -> torch.Tensor:
    """Torch twin of scatter_blocks_batch: one advanced-indexing gather with
    per-dim owner/cell vectors broadcast against each other (no index grid
    of the field's size is materialized)."""
    ndim = len(shape_padded)
    nbs = block_grid(shape_padded, stride)
    bl = blocks.reshape((batch,) + nbs + (stride + 1,) * ndim)
    blk_idx, cell_idx = [], []
    for d, n in enumerate(shape_padded):
        b, c = _owner_index(int(n), stride, blocks.device)
        view = [1] * ndim
        view[d] = int(n)
        blk_idx.append(b.view(view))
        cell_idx.append(c.view(view))
    return bl[(slice(None),) + tuple(blk_idx) + tuple(cell_idx)]


def anchor_grid_batch_t(xpb: torch.Tensor, stride: int = ANCHOR_STRIDE) -> torch.Tensor:
    sl = (slice(None),) + tuple(slice(None, None, stride) for _ in range(xpb.dim() - 1))
    return xpb[sl].contiguous()


def block_keys_t(flat: torch.Tensor, shape_padded: tuple[int, ...],
                 stride: int = ANCHOR_STRIDE) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-local keys of batch-global flat indices into (batch, *padded).

    A point lies in one closed block per dim, or in two where it sits on a
    face shared by neighbours (cell 0 of one block is cell ``stride`` of the
    block before). Returns (keys, src): one int64 key
    ``block * (stride + 1)**ndim + cell`` per block that holds a point, in
    gather_blocks_batch's block order, and the position in ``flat`` of the
    point each key comes from.
    """
    ndim = len(shape_padded)
    nbs = block_grid(shape_padded, stride)
    B = stride + 1
    rem, coords = flat.to(torch.int64), []
    for n in reversed(shape_padded):
        coords.append(rem % n)
        rem = rem // n
    coords.reverse()
    item, pos = rem, torch.arange(flat.numel(), device=flat.device)
    owner = [torch.clamp(c // stride, max=nbs[d] - 1) for d, c in enumerate(coords)]
    keys, src = [], []
    for prev in itertools.product((False, True), repeat=ndim):  # per dim: owner, or the block before
        ok = torch.ones_like(pos, dtype=torch.bool)
        bidx, cidx = item, torch.zeros_like(item)
        for d in range(ndim):
            b, c = owner[d], coords[d] - owner[d] * stride
            if prev[d]:
                ok = ok & (c == 0) & (b > 0)
                b, c = b - 1, c + stride
            bidx = bidx * nbs[d] + b
            cidx = cidx * B + c
        keys.append((bidx * B**ndim + cidx)[ok])
        src.append(pos[ok])
    return torch.cat(keys), torch.cat(src)
