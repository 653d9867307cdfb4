"""Interpolation-based lossy decomposition (paper §5.1) — plain torch.

Runs the hierarchical spline prediction over a batch of closed 17^ndim
blocks, quantizes the prediction errors to uint8 codes (radius 127, code 0
reserved for outliers, paper §5.2.1) and keeps the reconstruction in lock
step, so compression and decompression replay the same arithmetic.

These are the plain versions that the CUDA interp kernels
(repro_torch.kernels.interp3d) are held against, and the predictor the
port runs on CPU tensors. Each step applies the banded rows of the spline
operator of stencils.py tap by tap, in the kernels' order: per used dim,
acc = sum of coef * neighbour over the row's taps (ascending column), then
pred = pred + w * acc, every product and sum rounded to float32 on its
own. So on the same inputs the kernels and these functions compute the
same floats. Importing this module turns TF32 off for matmuls and cuDNN.
"""
from __future__ import annotations

import numpy as np
import torch

from .stencils import Step

# TF32 keeps ~3 decimal digits; the predictor's codes depend on full fp32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RADIUS = 127
CENTER = 128  # uint8 code = q + 128; 0 marks an outlier


MAX_TAPS = 4  # cubic stencils reach c-3s .. c+3s


def banded_rows(M: np.ndarray):
    """Taps of each row c of a banded (B,B) operator: (count (B,), columns
    (B, MAX_TAPS) ascending, coefficients (B, MAX_TAPS) f32), zero-padded."""
    B = M.shape[0]
    n = np.zeros(B, np.uint8)
    cols = np.zeros((B, MAX_TAPS), np.int64)
    coef = np.zeros((B, MAX_TAPS), np.float32)
    for c in range(B):
        j = np.flatnonzero(M[c])
        if j.size > MAX_TAPS:
            raise ValueError(f"operator row {c} has {j.size} taps; at most {MAX_TAPS}")
        n[c], cols[c, : j.size], coef[c, : j.size] = j.size, j, M[c, j]
    return n, cols, coef


class _StepTensors:
    """A step's tables as tensors on one device: per used dim its blend
    weight grid and, per tap slot, the neighbour index and coefficient of
    every operator row (shaped to broadcast along that dim)."""

    def __init__(self, step: Step, device):
        ndim = step.mask.ndim
        self.mask = torch.from_numpy(np.ascontiguousarray(step.mask)).to(device)
        self.ops = []
        for d, M, w in zip(step.dims, step.matrices, step.weights):
            n, cols, coef = banded_rows(M)
            shape = [1] * (ndim + 1)
            shape[d + 1] = M.shape[0]
            taps = [(torch.from_numpy(cols[:, t].copy()).to(device),
                     torch.from_numpy(coef[:, t].copy()).to(device).view(shape))
                    for t in range(int(n.max()))]
            self.ops.append((d, torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(device), taps))


def _predict(recon: torch.Tensor, st: _StepTensors) -> torch.Tensor:
    pred = torch.zeros_like(recon)
    for d, w, taps in st.ops:
        acc = torch.zeros_like(recon)
        for cols, coef in taps:  # rows with fewer taps add 0 * x, which changes nothing
            acc = acc + coef * recon.index_select(d + 1, cols)
        pred = pred + w * acc
    return pred


def quantize_pred(orig, pred, twoeb, inv2eb):
    """The quantizer: (code i32 with 0 = outlier, outlier mask, feedback
    reconstruction). ``torch.round`` rounds half to even, like ``rint``.
    The CUDA kernels repeat exactly this arithmetic."""
    q = torch.round((orig - pred) * inv2eb)
    outl = q.abs() > RADIUS
    rec = torch.where(outl, orig, pred + q * twoeb)
    qi = q.clamp(-RADIUS - 1, RADIUS + 1).to(torch.int32)  # safe cast; outliers coded 0
    code = torch.where(outl, torch.zeros_like(qi), qi + CENTER)
    return code, outl, rec


def anchor_mask(spatial: tuple[int, ...], anchor_every: int) -> np.ndarray:
    m = np.zeros(spatial, bool)
    m[tuple(slice(None, None, anchor_every) for _ in spatial)] = True
    return m


def f32(value, device) -> torch.Tensor:
    """A 0-d float32 tensor: scalars enter the arithmetic as fp32, as in the reference."""
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def compress_blocks(blocks: torch.Tensor, twoeb: float, steps: tuple[Step, ...], anchor_every: int = 16):
    """blocks: (nb, B..) f32 with anchors in place.

    Returns (codes u8, recon f32), each (nb, B..); the outliers are the
    code-0 points (anchors keep the center code), and recon is what the
    decompressor reproduces (outliers patched exactly).
    """
    dev = blocks.device
    orig = blocks
    am = torch.from_numpy(anchor_mask(tuple(blocks.shape[1:]), anchor_every)).to(dev)
    recon = torch.where(am, orig, torch.zeros((), dtype=orig.dtype, device=dev))
    codes = torch.full(blocks.shape, CENTER, dtype=torch.int32, device=dev)
    tw = f32(twoeb, dev)
    inv = f32(np.float32(1.0) / np.float32(twoeb), dev)
    for step in steps:
        st = _StepTensors(step, dev)
        code, _, rec = quantize_pred(orig, _predict(recon, st), tw, inv)
        recon = torch.where(st.mask, rec, recon)
        codes = torch.where(st.mask, code, codes)
    return codes.to(torch.uint8), recon


def _anchor_slices(ndim: int, anchor_every: int) -> tuple:
    return (slice(None),) + (slice(None, None, anchor_every),) * ndim


def decode_inputs(blocks: torch.Tensor, codes: torch.Tensor, anchor_every: int = 16):
    """What a container gives the decoder, read off the original blocks:
    the blocks' anchors (nb, A..) with A = 16 // anchor_every + 1, and the
    outliers (code 0) as ascending keys ``block * B**ndim + cell`` with
    their values."""
    anchors = blocks[_anchor_slices(blocks.dim() - 1, anchor_every)].contiguous()
    keys = torch.nonzero(codes.reshape(-1) == 0).reshape(-1)
    return anchors, keys, blocks.reshape(-1)[keys]


def decompress_blocks(codes: torch.Tensor, anchors: torch.Tensor, out_keys: torch.Tensor, out_vals: torch.Tensor,
                      twoeb: float, steps: tuple[Step, ...], anchor_every: int = 16) -> torch.Tensor:
    """Replay of compress_blocks from the codes.

    codes (nb, B..) u8; anchors (nb, A..) f32, the blocks' anchor points
    (A = 16 // anchor_every + 1 per dim); the outliers as int64 keys
    ``block * B**ndim + cell`` (unique) with their f32 values. A code-0
    point without a stored value replays as 0.
    """
    dev = codes.device
    recon = torch.zeros(codes.shape, dtype=torch.float32, device=dev)
    recon[_anchor_slices(codes.dim() - 1, anchor_every)] = anchors
    outlier_vals = torch.zeros(codes.numel(), dtype=torch.float32, device=dev)
    outlier_vals[out_keys] = out_vals
    outlier_vals = outlier_vals.view(codes.shape)
    q = (codes.to(torch.int32) - CENTER).to(torch.float32)
    is_outl = codes == 0
    tw = f32(twoeb, dev)
    for step in steps:
        st = _StepTensors(step, dev)
        rec = torch.where(is_outl, outlier_vals, _predict(recon, st) + q * tw)
        recon = torch.where(st.mask, rec, recon)
    return recon
