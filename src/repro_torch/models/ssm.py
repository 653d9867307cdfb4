"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].

Prefill uses the chunked SSD algorithm: quadratic attention-like compute
within chunks, a sequential state recurrence across chunks. Decode is the
O(1)-per-token recurrent update — the reason this arch runs the long_500k
cell that full attention cannot.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..runtime import partitioning as part
from ..runtime.partitioning import P
from .layers import _dense_init, _mm32, _w, _zeros, rms_norm, silu


def init_ssm(gen, cfg: ModelConfig, *, lead=()):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N
    return {
        "in_proj": _dense_init(gen, (d, 2 * di + 2 * N + H), lead=lead),
        "conv_w": _dense_init(gen, (cfg.ssm_conv, conv_dim), scale=0.2, lead=lead),
        "A_log": _zeros(gen, (H,), lead=lead),            # A = -exp(A_log) = -1
        "D": torch.ones(tuple(lead) + (H,), dtype=torch.float32, device=gen.device),
        "dt_bias": _zeros(gen, (H,), lead=lead),
        "norm": _zeros(gen, (di,), lead=lead),
        "out_proj": _dense_init(gen, (di, d), lead=lead),
    }


def _causal_conv(x, w):
    """Depthwise causal conv: x (B,S,C), w (K,C)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i : i + x.shape[1]] * w[i].to(x.dtype) for i in range(K))
    return silu(out)


def _conv_placed(x, w):
    """:func:`_causal_conv` of a placed input: each batch block convolves on
    its own rank (the channels, ``in_proj``'s columns, are not split)."""
    mesh = part.region_mesh(x)
    if mesh is None:
        return _causal_conv(x, w)
    spec = part.resolve(("batch", None, None), tuple(x.shape), mesh)
    return part.shard_map(_causal_conv, mesh, in_specs=(spec, P(None, None)), out_specs=spec,
                          grad_axes=part.spec_axes(spec))(x, w)


def _split_proj(zxbcdt, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di : 2 * di]
    Bc = zxbcdt[..., 2 * di : 2 * di + N]
    Cc = zxbcdt[..., 2 * di + N : 2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N :]
    return z, xs, Bc, Cc, dt


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, return_state: bool = False):
    """xh: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N) -> y (B,S,H,P)."""
    B, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    nc = S // L
    xc = xh.reshape(B, nc, L, H, Pd).float()
    dtc = dt.reshape(B, nc, L, H).float()
    Bcc = Bm.reshape(B, nc, L, N).float()
    Ccc = Cm.reshape(B, nc, L, N).float()
    dA = dtc * A  # (B,nc,L,H) log-decay increments (negative)
    cum = torch.cumsum(dA, dim=2)
    # intra-chunk: scores[l,m] = (C_l . B_m) exp(cum_l - cum_m) dt_m, m <= l
    G = _mm32("bcln,bcmn->bclm", Ccc, Bcc)
    delta = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,L,M,H)
    ar = torch.arange(L, device=xh.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    W = torch.where(mask, torch.exp(delta), 0.0) * G[..., None]
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", W, xdt)
    # chunk-final states: S_c = sum_m exp(cum_L - cum_m) dt_m B_m (x) x_m
    wS = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B,nc,L,H)
    states = torch.einsum("bcmn,bcmh,bcmhp->bchnp", Bcc, wS, xc)
    chunk_decay = torch.exp(cum[:, :, -1])  # (B,nc,H)
    # inter-chunk recurrence across the nc chunks
    carry = torch.zeros((B, H, N, Pd), dtype=torch.float32, device=xh.device)
    prev_list = []
    for c in range(nc):
        prev_list.append(carry)
        carry = carry * chunk_decay[:, c][..., None, None] + states[:, c]
    final_state = carry
    prev_states = torch.stack(prev_list, 1)  # (B,nc,H,N,P) state before chunk
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", Ccc, torch.exp(cum), prev_states)
    y = (y_intra + y_inter).reshape(B, S, H, Pd)
    return (y, final_state) if return_state else y


def _ssd_placed(xh, dt, A, Bm, Cm, chunk: int, return_state: bool = False):
    """:func:`ssd_chunked` of placed inputs: each (batch, head) block runs
    on its own rank in a manual region (the sequence whole: the recurrence
    runs along it); an input the blocks share (B and C across heads, A
    across the batch) collects its gradient as the sum of the blocks'."""
    mesh = part.region_mesh(xh)
    if mesh is None:
        return ssd_chunked(xh, dt, A, Bm, Cm, chunk, return_state)
    xs = part.resolve(("batch", None, "ssm_heads", None), tuple(xh.shape), mesh)
    bs, hs = xs[0], xs[2]
    out = (xs, P(bs, hs, None, None)) if return_state else xs
    return part.shard_map(lambda *a: ssd_chunked(*a, chunk, return_state), mesh,
                          in_specs=(xs, P(bs, None, hs), P(hs), P(bs, None, None), P(bs, None, None)),
                          out_specs=out, grad_axes=part.spec_axes(xs))(xh, dt, A, Bm, Cm)


def ssm_block(x, p, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence SSD. x: (B,S,d) -> (B,S,d) [, decode-entry cache]."""
    B, S, d = x.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    zxbcdt = x @ _w(p["in_proj"], x)
    z, xs, Bc, Cc, dt = _split_proj(zxbcdt, cfg)
    cin = torch.cat([xs, Bc, Cc], -1)
    conv = _conv_placed(cin, p["conv_w"])
    xs, Bc, Cc = conv[..., :di], conv[..., di : di + N], conv[..., di + N :]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, H, Pd)
    xh = part.shard(xh, "batch", None, "ssm_heads", None)
    if return_cache:
        y, final_state = _ssd_placed(xh, dt, A, Bc, Cc, cfg.ssm_chunk, return_state=True)
    else:
        y, final_state = _ssd_placed(xh, dt, A, Bc, Cc, cfg.ssm_chunk), None
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(x.dtype) * silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    y = y @ _w(p["out_proj"], x)
    if return_cache:
        K = cfg.ssm_conv
        return y, {"state": final_state, "conv": cin[:, S - (K - 1) :]}
    return y


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *, device=None, lead=()):
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    return {
        "state": torch.zeros(tuple(lead) + (batch, H, N, Pd), dtype=torch.float32, device=device),
        "conv": torch.zeros(tuple(lead) + (batch, cfg.ssm_conv - 1, di + 2 * N), dtype=dtype, device=device),
    }


def ssm_decode(x1, p, cfg: ModelConfig, cache):
    """One-token recurrent update. x1: (B,1,d)."""
    B = x1.shape[0]
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    zxbcdt = x1 @ _w(p["in_proj"], x1)
    z, xs, Bc, Cc, dt = _split_proj(zxbcdt, cfg)
    cin = torch.cat([xs, Bc, Cc], -1)  # (B,1,conv_dim)
    win = torch.cat([cache["conv"], cin], 1)  # (B,K,conv_dim)
    conv = silu(torch.einsum("bkc,kc->bc", win, _w(p["conv_w"], x1)))[:, None]
    new_conv = win[:, 1:]
    xs, Bc, Cc = conv[..., :di], conv[..., di : di + N], conv[..., di + N :]
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)  # (B,H)
    xh = xs[:, 0].reshape(B, H, Pd).float()
    st = cache["state"] * a[..., None, None] + torch.einsum("bn,bh,bhp->bhnp", Bc[:, 0].float(), dt, xh)
    y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), st)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, 1, di).to(x1.dtype) * silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ _w(p["out_proj"], x1), {"state": st, "conv": new_conv}
