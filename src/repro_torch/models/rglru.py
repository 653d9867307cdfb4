"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Gated linear recurrence h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * u_t) with
input-dependent a_t = exp(-c * softplus(Lambda) * r_t). Prefill runs the
recurrence as a sequential loop over the sequence (the JAX package runs a
log-depth ``associative_scan``, which rounds in another order); decode is a
one-step update. Combined with windowed local attention this gives the
bounded-state long_500k path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..runtime import partitioning as part
from ..runtime.partitioning import P
from .layers import _dense_init, _w, gelu, sigmoid

_C = 8.0


def init_rglru(gen, cfg: ModelConfig, *, lead=()):
    d, L = cfg.d_model, cfg.lru_dim
    return {
        "w_gelu": _dense_init(gen, (d, L), lead=lead),
        "w_x": _dense_init(gen, (d, L), lead=lead),
        "conv_w": _dense_init(gen, (cfg.conv_width, L), scale=0.2, lead=lead),
        "w_r": _dense_init(gen, (L, L), lead=lead),
        "w_i": _dense_init(gen, (L, L), lead=lead),
        "lam": torch.full(tuple(lead) + (L,), 1.0, dtype=torch.float32, device=gen.device),  # softplus(1) ~ 1.31
        "w_out": _dense_init(gen, (L, d), lead=lead),
    }


def _gates(u, p):
    r = sigmoid((u @ _w(p["w_r"], u)).float())
    i = sigmoid((u @ _w(p["w_i"], u)).float())
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u.float())
    return a, b


def _conv(x, w):
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i : i + x.shape[1]] * w[i].to(x.dtype) for i in range(K))


def _scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1, from h_{-1} = 0."""
    hs = []
    h = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _scan_placed(a, b):
    """:func:`_scan` of placed gates: each (batch, channel) runs on its own
    rank in a manual region (the recurrence is elementwise)."""
    mesh = part.region_mesh(a)
    if mesh is None:
        return _scan(a, b)
    spec = part.resolve(("batch", None, "lru"), tuple(a.shape), mesh)
    return part.shard_map(_scan, mesh, in_specs=(spec, spec), out_specs=spec, grad_axes=part.spec_axes(spec))(a, b)


def _conv_placed(x, w):
    """:func:`_conv` of a placed input: each (batch, channel) block convolves
    on its own rank (the conv is depthwise along the sequence)."""
    mesh = part.region_mesh(x)
    if mesh is None:
        return _conv(x, w)
    spec = part.resolve(("batch", None, "lru"), tuple(x.shape), mesh)
    return part.shard_map(_conv, mesh, in_specs=(spec, P(None, spec[2])), out_specs=spec,
                          grad_axes=part.spec_axes(spec))(x, w)


def rglru_block(x, p, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence Griffin recurrent block. x: (B,S,d)."""
    gate = gelu(x @ _w(p["w_gelu"], x))
    xin = x @ _w(p["w_x"], x)
    u = _conv_placed(xin, p["conv_w"])
    a, b = _gates(u, p)
    h = _scan_placed(a, b)
    out = (h.to(x.dtype) * gate) @ _w(p["w_out"], x)
    if return_cache:
        K = cfg.conv_width
        return out, {"h": h[:, -1], "conv": xin[:, x.shape[1] - (K - 1) :]}
    return out


def rglru_init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *, device=None, lead=()):
    L = cfg.lru_dim
    return {
        "h": torch.zeros(tuple(lead) + (batch, L), dtype=torch.float32, device=device),
        "conv": torch.zeros(tuple(lead) + (batch, cfg.conv_width - 1, L), dtype=dtype, device=device),
    }


def rglru_decode(x1, p, cfg: ModelConfig, cache):
    """One-token update. x1: (B,1,d)."""
    gate = gelu(x1 @ _w(p["w_gelu"], x1))
    xin = x1 @ _w(p["w_x"], x1)  # (B,1,L)
    win = torch.cat([cache["conv"], xin], 1)  # (B,K,L)
    u = torch.einsum("bkl,kl->bl", win, _w(p["conv_w"], x1))[:, None]
    a, b = _gates(u, p)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = h[:, None].to(x1.dtype) * gate
    return y @ _w(p["w_out"], x1), {"h": h, "conv": win[:, 1:]}
