"""Shared transformer layers: RMSNorm, RoPE, GQA attention (global/local,
train/prefill/decode), dense MLP, MoE FFN (sort-based dispatch).

All functions are pure on plain dicts of tensors created by the matching
init_* functions, with the JAX package's keys (``repro.models.layers``).
Parameters are fp32 masters, each cast to bf16 at its matmul; compute
dtype is bf16. The products that the JAX package accumulates with
``preferred_element_type=float32`` (attention scores, the logits head)
take their bf16 operands up to float32 and multiply in float32: products
of two bf16 values are exact there, so only the summation order differs.
Importing this module turns TF32 off for matmuls, as the predictor does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..runtime import partitioning as part
from ..runtime.partitioning import P

# TF32 keeps ~3 decimal digits; the float32 products above must stay float32
torch.backends.cuda.matmul.allow_tf32 = False

CDTYPE = torch.bfloat16
NEG = -1e30  # the reference's mask value


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where the init functions build on
    the ``meta`` device (shapes and dtypes, no values): torch has no
    generator there."""

    device = torch.device("meta")


def _dense_init(gen: torch.Generator, shape, scale=None, *, lead=()):
    """N(0, scale^2) float32 of ``lead + shape`` on the generator's device;
    ``scale`` defaults to 1/sqrt(shape[0]) (``lead`` stacks layers, as
    ``jax.vmap`` of the JAX init does)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    g = gen if isinstance(gen, torch.Generator) else None
    return torch.randn(tuple(lead) + tuple(shape), generator=g, device=gen.device, dtype=torch.float32).mul_(scale)


def _zeros(gen: torch.Generator, shape, *, lead=()):
    return torch.zeros(tuple(lead) + tuple(shape), device=gen.device, dtype=torch.float32)


def _w(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The fp32 master ``p`` cast to ``like``'s dtype for its matmul."""
    return p.to(like.dtype)


def _mm32(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """einsum with float32 operands and output (the reference's
    ``preferred_element_type=jnp.float32`` on bf16 operands)."""
    return torch.einsum(spec, *(o.float() for o in ops))


def _scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``x``'s dtype: JAX rounds a Python
    float to a bf16 operand's dtype before it multiplies."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------- activations
# JAX evaluates these as compositions of elementwise ops, each rounded to
# the operand's dtype (bf16 here); torch's fused versions round once, so
# the port spells out the same compositions.
def sigmoid(x):
    """``jax.nn.sigmoid`` (``lax.logistic``): 1 / (1 + exp(-x)) op by op."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * sigmoid(x)


def gelu(x):
    """``jax.nn.gelu`` (its default tanh approximation), with JAX's
    constants rounded to ``x``'s dtype."""
    cdf = 0.5 * (1.0 + torch.tanh(_scalar(x, math.sqrt(2 / math.pi)) * (x + _scalar(x, 0.044715) * (x * x * x))))
    return x * cdf


def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope(x, positions, theta):
    """x: (..., S, H, dh); positions: (..., S), the same on every rank (a
    placed ``x`` gets its angles replicated on its mesh)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = torch.pow(torch.tensor(1.0 / theta, dtype=torch.float32, device=x.device),
                     torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None, None].float() * freq  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if part.is_placed(x) and not part.is_placed(cos):  # the angles, on every rank of x's mesh
        from torch.distributed.tensor import DTensor, Replicate

        cos, sin = (DTensor.from_local(t, x.device_mesh, [Replicate()] * x.device_mesh.ndim, run_check=False)
                    for t in (cos, sin))
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention
def init_attention(gen, cfg: ModelConfig, *, lead=()):
    d, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": _dense_init(gen, (d, H * dh), lead=lead),
        "wk": _dense_init(gen, (d, Hk * dh), lead=lead),
        "wv": _dense_init(gen, (d, Hk * dh), lead=lead),
        "wo": _dense_init(gen, (H * dh, d), lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, (H * dh,), lead=lead)
        p["bk"] = _zeros(gen, (Hk * dh,), lead=lead)
        p["bv"] = _zeros(gen, (Hk * dh,), lead=lead)
    return p


def _heads(t, n: int, dh: int, seq: str, heads: str):
    """A (B, S, n*dh) projection as (B, S, n, dh). Under a mesh it is first
    laid out by its logical axes (``seq``, ``heads``): the fused dim stays
    split over ``model`` only where the head count divides it (the rules'
    ``heads_ok`` / ``kv_ok``), so every rank holds whole heads; otherwise it
    moves to the sequence split (an all-to-all) or to every rank (an
    all-gather), as XLA reshards at the reshape."""
    B, S, _ = t.shape
    return part.settle_grad(part.shard(t, "batch", seq, heads).reshape(B, S, n, dh))


def _bias(b, x, n: int, dh: int):
    """A (n*dh,) bias as (n, dh), laid out to add to a (B, S, n, dh) ``x``."""
    b = _w(b, x)
    if part.is_placed(b) and part.is_placed(x) and not part.in_manual_region():
        from torch.distributed.tensor import Replicate, Shard

        pl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in x.placements)
        b = b.redistribute(b.device_mesh, pl)
    return b.reshape(n, dh)


def _qkv(x, p, cfg: ModelConfig, positions, use_rope=True):
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = _heads(x @ _w(p["wq"], x), H, dh, "seq", "heads")
    k = _heads(x @ _w(p["wk"], x), Hk, dh, "seq_kv", "kv_heads")
    v = _heads(x @ _w(p["wv"], x), Hk, dh, "seq_kv", "kv_heads")
    if "bq" in p:
        q = q + _bias(p["bq"], q, H, dh)
        k = k + _bias(p["bk"], k, Hk, dh)
        v = v + _bias(p["bv"], v, Hk, dh)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = part.shard(q, "batch", "seq", "heads", None)
    # K/V use their own seq rule: under sequence-TP ("seq"->model) they stay
    # replicated along seq so blockwise tiles slice without per-tile reshards
    k = part.shard(k, "batch", "seq_kv", "kv_heads", None)
    v = part.shard(v, "batch", "seq_kv", "kv_heads", None)
    return q, k, v


def _gqa_scores(q, k, cfg):
    """q: (B,S,H,dh), k: (B,T,Hk,dh) -> (B,Hk,G,S,T) fp32, no repeated KV."""
    B, S, H, dh = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = q.reshape(B, S, Hk, G, dh)
    return _mm32("bskgd,btkd->bkgst", qg, k) / math.sqrt(dh)


def _gqa_out(probs, v, cfg):
    """probs: (B,Hk,G,S,T); v: (B,T,Hk,dh) -> (B,S,H*dh)."""
    B, Hk, G, S, T = probs.shape
    o = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return o.reshape(B, S, Hk * G * v.shape[-1])


def _mask(kind, qi, ki, window):
    """Which keys ``ki`` each query ``qi`` sees: attn (causal), local
    (causal within the window) or bidir (all)."""
    if kind == "local":
        return (ki <= qi) & (qi - ki < window)
    if kind == "attn":
        return ki <= qi
    return torch.ones_like(ki <= qi)


def _attn_full(q, k, v, cfg, kind, q_off: int = 0):
    """Naive full-scores attention (exact reference; attn_chunk=0). ``q_off``:
    the position of q's first row (a rank's block of a split sequence)."""
    S, T = q.shape[1], k.shape[1]
    scores = _gqa_scores(q, k, cfg)
    qi = q_off + torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    scores = torch.where(_mask(kind, qi, ki, cfg.window)[None, None, None], scores, NEG)
    return _gqa_out(torch.softmax(scores, dim=-1), v, cfg)


def _attn_blockwise(q, k, v, cfg, kind, q_off: int = 0):
    """Flash-style blockwise attention (exact online softmax).

    Tiles both the query and KV axes with cfg.attn_chunk; statically skips
    fully-masked tiles (so local-attention FLOPs really are O(S*window)).
    """
    B, S, H, dh = q.shape
    T = k.shape[1]
    Hk = k.shape[2]
    G = H // Hk
    C = cfg.attn_chunk
    Cq, Ck = min(C, S), min(C, T)
    if S % Cq or T % Ck:  # fall back on exact full path for ragged shapes
        return _attn_full(q, k, v, cfg, kind, q_off)
    qg = q.reshape(B, S, Hk, G, dh)
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for q0 in range(0, S, Cq):
        qc = qg[:, q0 : q0 + Cq]
        m = torch.full((B, Hk, G, Cq), NEG, dtype=torch.float32, device=q.device)
        den = torch.zeros((B, Hk, G, Cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hk, G, Cq, dh), dtype=torch.float32, device=q.device)
        a0 = q_off + q0  # the chunk's first position
        qi = a0 + torch.arange(Cq, device=q.device)[:, None]
        for k0 in range(0, T, Ck):
            # static tile skipping: causal/local windows never look ahead,
            # local never looks further back than the window
            if kind in ("attn", "local") and k0 > a0 + Cq - 1:
                continue
            if kind == "local" and k0 + Ck - 1 < a0 - cfg.window + 1:
                continue
            kc, vc = k[:, k0 : k0 + Ck], v[:, k0 : k0 + Ck]
            s = _mm32("bskgd,btkd->bkgst", qc, kc) * scale
            ki = k0 + torch.arange(kc.shape[1], device=q.device)[None, :]
            s = torch.where(_mask(kind, qi, ki, cfg.window)[None, None, None], s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            pt = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + pt.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", pt.to(vc.dtype), vc)
            m = m_new
        o = acc / torch.clamp(den[..., None], min=1e-30)  # (B,Hk,G,Cq,dh)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, Cq, H * dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def _attn_core(q, k, v, cfg, kind, q_off: int = 0):
    if cfg.attn_chunk and max(q.shape[1], k.shape[1]) > cfg.attn_chunk:
        return _attn_blockwise(q, k, v, cfg, kind, q_off)
    return _attn_full(q, k, v, cfg, kind, q_off)


def _attn_placed(q, k, v, cfg, kind):
    """:func:`_attn_core` of placed q, k, v. Where batch and heads split them
    (q's heads and the kv heads over the same axis, or one kv head shared by
    all), every (batch, head) block attends on its own rank: the core runs
    per shard in a manual region, as GSPMD partitions it. Where q's heads
    split and the kv heads are whole, each rank takes the kv heads its q
    heads read. Where q's sequence splits over one axis (the sequence-TP
    fallback of heads that do not divide it) and k, v are whole there, each
    rank attends its block of queries from its offset. Otherwise the core
    runs on the DTensors."""
    mesh = part.region_mesh(q)
    if mesh is None:
        return _attn_core(q, k, v, cfg, kind)
    qs = part.resolve(("batch", "seq", "heads", None), tuple(q.shape), mesh)
    ks = part.resolve(("batch", "seq_kv", "kv_heads", None), tuple(k.shape), mesh)
    if ks[1] is not None or qs[0] != ks[0] or not (qs[1] is None or isinstance(qs[1], str)):
        return _attn_core(q, k, v, cfg, kind)
    out = P(qs[0], qs[1], qs[2])
    if qs[1] is not None and (qs[2] == ks[2] or (ks[2] is None and k.shape[2] == 1)):
        seq_axis, S_loc = qs[1], q.shape[1] // mesh.shape[qs[1]]
        body = lambda ql, kl, vl: _attn_core(ql, kl, vl, cfg, kind,  # noqa: E731
                                             part.axis_index(seq_axis) * S_loc)
    elif qs[1] is not None:
        return _attn_core(q, k, v, cfg, kind)
    elif qs[2] == ks[2] or (ks[2] is None and k.shape[2] == 1):
        body = lambda ql, kl, vl: _attn_core(ql, kl, vl, cfg, kind)  # noqa: E731
    elif ks[2] is None and isinstance(qs[2], str):
        body = _gqa_block_body(q.shape[2], k.shape[2], mesh.shape[qs[2]], qs[2], cfg, kind)
        if body is None:
            return _attn_core(q, k, v, cfg, kind)
    else:
        return _attn_core(q, k, v, cfg, kind)
    return part.shard_map(body, mesh, in_specs=(qs, ks, ks), out_specs=out, grad_axes=part.spec_axes(out))(q, k, v)


def _gqa_block_body(H: int, Hk: int, m: int, axis: str, cfg, kind):
    """The manual body where q's H heads split over ``axis`` (m ranks) and
    the Hk kv heads are whole on every rank (a kv-head count that does not
    divide the axis): each rank attends with the kv heads its own q heads
    read (q head h reads kv head h // (H / Hk)). None where a rank's q heads
    would straddle kv groups unevenly."""
    G, Hl = H // Hk, H // m
    if Hl % G and G % Hl:
        return None
    n = max(Hl // G, 1)

    def body(ql, kl, vl):
        k0 = part.axis_index(axis) * Hl // G
        return _attn_core(ql, kl[:, :, k0 : k0 + n], vl[:, :, k0 : k0 + n], cfg, kind)

    return body


def _attn_out(o):
    """The attention's (B, S, H*dh) output laid out for the output
    projection: the sequence whole (the sequence-TP fallback's split is
    gathered), the heads split where they divide. torch 2.11's DTensor
    flattens batch and sequence for a matmul only where the sequence is
    whole."""
    return part.shard(o, "batch", None, "heads")


def attention(x, p, cfg: ModelConfig, *, kind="attn", positions=None, memory=None):
    """Full-sequence attention. kind: attn|local|cross|bidir."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if kind == "cross":
        q = _heads(x @ _w(p["wq"], x), cfg.n_heads, cfg.d_head, "seq", "heads")
        k = _heads(memory @ _w(p["wk"], x), cfg.n_kv_heads, cfg.d_head, "seq_kv", "kv_heads")
        v = _heads(memory @ _w(p["wv"], x), cfg.n_kv_heads, cfg.d_head, "seq_kv", "kv_heads")
        return _attn_out(_attn_placed(q, k, v, cfg, "bidir")) @ _w(p["wo"], x)
    q, k, v = _qkv(x, p, cfg, positions)
    return _attn_out(_attn_placed(q, k, v, cfg, kind)) @ _w(p["wo"], x)


def attention_prefill(x, p, cfg: ModelConfig, *, kind="attn", cache_len=None):
    """Like attention() but also returns the KV cache (capacity cache_len)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(x, p, cfg, positions)
    out = _attn_out(_attn_placed(q, k, v, cfg, kind)) @ _w(p["wo"], x)
    C = cache_len or S
    if kind == "local":
        C = min(C, cfg.window)
    if C >= S:
        kc, vc = _pad_seq(k, C - S), _pad_seq(v, C - S)
    else:  # keep last C entries (ring base 0 when S % C == 0)
        kc, vc = k[:, S - C :], v[:, S - C :]
    return out, {"k": kc, "v": vc}


def _pad_seq(t, n: int):
    """(B, S, ...) -> (B, S + n, ...), zeros after. A placed ``t`` whose
    sequence is whole on every rank pads its local block (torch 2.11's
    DTensor has no rule for ``pad``)."""
    if not part.is_placed(t) or part.in_manual_region():
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, n))
    from torch.distributed.tensor import DTensor, Shard

    if any(p == Shard(1) for p in t.placements):
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, n))
    local = F.pad(t.to_local(), (0, 0) * (t.ndim - 2) + (0, n))
    shape = (t.shape[0], t.shape[1] + n) + tuple(t.shape[2:])
    return DTensor.from_local(local, t.device_mesh, t.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _kv_dequant(kq, scale, dtype):
    """int8 (B,C,Hk,dh) + per-(B,C,Hk) scale -> dtype."""
    return (kq.float() * scale[..., None]).to(dtype)


def _kv_quant(k):
    """Error-bounded int8 KV quantization: per-(token, head) scale,
    |err| <= scale/2 = max|k|/254 — the paper's quantizer at fixed rate,
    halving decode HBM traffic (KV is read every step, written once)."""
    k32 = k.float()
    scale = torch.clamp(k32.abs().amax(dim=-1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(k32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.float()


def position(pos) -> int:
    """A decode position as a Python int: an int, or a 0-d tensor that holds
    one (a DTensor's is read from its local block). A shape-only (``meta``)
    tensor has no value to read and raises."""
    if isinstance(pos, torch.Tensor):
        if part.is_shape_only(pos):
            raise TypeError("a shape-only pos has no value; pass the decode position as an int")
        pos = pos.to_local() if part.is_placed(pos) else pos
    return int(pos)


def _slot_write(buf, value, slot):
    """``buf[:, slot] = value`` in place, with ``lax.dynamic_update_slice``'s
    start clamped so the one-slot update stays inside ``buf``."""
    s = max(0, min(int(slot), buf.shape[1] - value.shape[1]))
    if part.is_placed(buf) and not part.in_manual_region():
        return _slot_write_placed(buf, value, s)
    buf[:, s : s + value.shape[1]] = value.to(buf.dtype)
    return buf


def _slot_write_placed(buf, value, s: int):
    """:func:`_slot_write` into a placed ``buf`` whose slot dim (1) may be
    split: ``value`` is laid out as ``buf`` with dim 1 whole, and each rank
    writes the part of the slots its block of ``buf`` holds into that block
    (a DTensor slice of a split dim would write into a gathered copy)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    pl = tuple(Replicate() if p == Shard(1) else p for p in buf.placements)
    v = value.to(buf.dtype).redistribute(buf.device_mesh, pl).to_local()
    size, off = compute_local_shape_and_global_offset(tuple(buf.shape), buf.device_mesh, tuple(buf.placements))
    lo, hi = max(s, off[1]), min(s + v.shape[1], off[1] + size[1])
    if lo < hi:
        buf.to_local()[:, lo - off[1] : hi - off[1]] = v[:, lo - s : hi - s]
    return buf


def _against_cache(q, kc):
    """A placed decode query (B, 1, H, dh) laid out against the placed cache
    ``kc`` (B, C, Hk, dh): split as the cache over batch and kv heads,
    whole over any axis that splits the cache's length (there each rank
    scores its own slots). Plain tensors come back as they are."""
    if not (part.is_placed(q) and part.is_placed(kc)) or part.in_manual_region():
        return q
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(c if c in (Shard(0), Shard(2)) else Replicate() for c in kc.placements)
    return q if tuple(q.placements) == pl else q.redistribute(q.device_mesh, pl)


def attention_decode(x1, p, cfg: ModelConfig, cache, pos, *, kind="attn", memory=None):
    """x1: (B,1,d); cache {'k','v'}: (B,C,Hk,dh); pos: index of the new token
    (an int or a 0-d tensor).

    Global attn: slot = pos (capacity >= seq_len). Local: ring slot = pos % window.
    With cfg.kv_quant the cache leaves are int8 + scales. The cache's
    tensors are updated in place (the JAX package donates them). Returns
    (out, new_cache).
    """
    B = x1.shape[0]
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pos = position(pos)
    if kind == "cross":
        q = _against_cache(_heads(x1 @ _w(p["wq"], x1), H, dh, "seq", "heads"), cache["k"])
        probs = torch.softmax(_gqa_scores(q, cache["k"], cfg), dim=-1)
        return _gqa_out(probs, cache["v"], cfg) @ _w(p["wo"], x1), cache
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x1.device)
    q, k1, v1 = _qkv(x1, p, cfg, positions)
    C = cache["k"].shape[1]
    slot = pos % C if kind == "local" else pos
    idx = torch.arange(C, device=x1.device)
    if kind == "local":
        valid = (idx <= slot) | (pos >= C)  # ring: all slots valid once warm
    else:
        valid = idx <= pos
    if cfg.kv_quant:
        k1q, k1s = _kv_quant(k1)
        v1q, v1s = _kv_quant(v1)
        kc = _slot_write(cache["k"], k1q, slot)
        vc = _slot_write(cache["v"], v1q, slot)
        ks = _slot_write(cache["k_scale"], k1s, slot)
        vs = _slot_write(cache["v_scale"], v1s, slot)
        new_cache = {"k": kc, "v": vc, "k_scale": ks, "v_scale": vs}
        kc, vc = _kv_dequant(kc, ks, x1.dtype), _kv_dequant(vc, vs, x1.dtype)
    else:
        kc = _slot_write(cache["k"], k1, slot)
        vc = _slot_write(cache["v"], v1, slot)
        new_cache = {"k": kc, "v": vc}
    q = _against_cache(q, kc)
    scores = _gqa_scores(q, kc, cfg)  # (B,Hk,G,1,C)
    scores = torch.where(valid[None, None, None, None, :], scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, vc, cfg) @ _w(p["wo"], x1)
    return out, new_cache


# ---------------------------------------------------------------- MLP
def init_mlp(gen, cfg: ModelConfig, d_ff=None, *, lead=()):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":  # llama-style gated
        return {"w1": _dense_init(gen, (d, ff), lead=lead), "w3": _dense_init(gen, (d, ff), lead=lead),
                "w2": _dense_init(gen, (ff, d), lead=lead)}
    return {"w1": _dense_init(gen, (d, ff), lead=lead), "w2": _dense_init(gen, (ff, d), lead=lead)}


def mlp(x, p, cfg: ModelConfig):
    h = x @ _w(p["w1"], x)
    # the FFN dim split over "model", the sequence whole: the sequence-TP
    # fallback of heads that do not divide is the attention's (torch 2.11's
    # DTensor cannot flatten a split sequence into w2's matmul)
    h = part.shard(h, "batch", None, "ffn")
    if "w3" in p:
        h = silu(h) * (x @ _w(p["w3"], x))
    else:
        h = gelu(h)
    return h @ _w(p["w2"], x)


# ---------------------------------------------------------------- MoE
def init_moe(gen, cfg: ModelConfig, *, lead=()):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    p = {
        "router": _dense_init(gen, (d, E), scale=0.02, lead=lead),
        "w1": _dense_init(gen, (E, d, f), lead=lead),
        "w3": _dense_init(gen, (E, d, f), lead=lead),
        "w2": _dense_init(gen, (E, f, d), lead=lead),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(gen, cfg, d_ff=cfg.n_shared * cfg.d_expert, lead=lead)
    return p


def _top_k(probs, K):
    """``lax.top_k``: the K largest along the last axis, the lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _dispatch(rows, el, rank, keep, E_loc: int, C: int):
    """The (E_loc, C, d) dispatch buffer: ``rows[i]`` at (``el[i]``,
    ``rank[i]``) where ``keep[i]``, zeros elsewhere. Static shapes, as
    ``.at[...].set(mode="drop")``: every row is written, a dropped one to a
    sentinel row past the E_loc * C slots, which is sliced off (no boolean
    index, no ``nonzero``, no host sync)."""
    d = rows.shape[-1]
    slot = torch.where(keep, el * C + rank, E_loc * C)
    buf = torch.zeros((E_loc * C + 1, d), dtype=rows.dtype, device=rows.device)
    buf = buf.index_put((slot,), rows)
    return buf[: E_loc * C].view(E_loc, C, d)


def _moe_local(x, p, cfg: ModelConfig, model_axis=None):
    """Token-choice top-k with capacity; runs per data shard (or on one
    device). x: (B,S,d) local tokens.

    Every token's k choices are sorted by expert (stably), ranked within
    their expert, and rows ranked at or past the capacity C are dropped.
    Two TP layouts over ``model_axis`` (an axis of the installed mesh):

      * FFN-sharded (default): every shard dispatches to ALL experts, the
        expert FFN dim sharded (w1/w3 columns, w2 rows);
      * expert-parallel (``cfg.moe_expert_parallel``): each shard owns
        E/m whole experts, from ``e0 = rank_in(model) * E_loc``, and builds
        only its (E/m, C, d) dispatch buffer; other experts' rows go to a
        sentinel row and are dropped.

    Contributions psum over the (T,d) combine either way. A model-sharded
    shared expert (deepseek) adds its partial before that psum (the JAX
    package adds it after, which keeps one shard's part only).
    Returns (y, aux_loss_local).
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    logits = (xt @ _w(p["router"], x)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = _top_k(probs, K)  # (T,K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # capacity: cf-limited at scale, lossless for tiny token counts (decode)
    C = int(min(T * K, max(math.ceil(T * K / E * cfg.capacity_factor), 8)))
    ef = eidx.reshape(-1)  # (T*K,)
    gf = gates.reshape(-1)
    tf_ = torch.arange(T, device=x.device).repeat_interleave(K)
    order = torch.argsort(ef, stable=True)
    es, gs, ts = ef[order], gf[order], tf_[order]
    # rank within expert segment
    rank = torch.arange(T * K, device=x.device) - torch.searchsorted(es, es, side="left")
    E_loc = p["w1"].shape[0]  # E (ffn-sharded) or E/m (expert-parallel)
    keep = rank < C
    if model_axis is not None and E_loc < E:
        e0 = part.axis_index(model_axis) * E_loc
        mine = (es >= e0) & (es < e0 + E_loc)
        el = torch.where(mine, es - e0, E_loc)  # sentinel row -> dropped
        keep = keep & mine
    else:
        el = es
    buf = _dispatch(xt[ts], el, rank, keep, E_loc, C)
    h = torch.einsum("ecd,edf->ecf", buf, _w(p["w1"], x))
    h = silu(h) * torch.einsum("ecd,edf->ecf", buf, _w(p["w3"], x))
    out_e = torch.einsum("ecf,efd->ecd", h, _w(p["w2"], x))
    contrib = out_e[el.clamp(0, E_loc - 1), rank % C] * gs[:, None].to(x.dtype) * keep[:, None]
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add_(0, ts, contrib)
    # shared experts (deepseek): dense path; a model-sharded one is a partial sum
    shared_partial = model_axis is not None and "shared" in p and \
        p["shared"]["w1"].shape[-1] < cfg.n_shared * cfg.d_expert
    if shared_partial:
        y = y + mlp(xt[None], p["shared"], cfg)[0]
    if model_axis is not None:
        y = part.psum(y, model_axis)  # combine first: psum the (T,d) result, not the (E,C,d) buffer
    # switch-style load-balance aux loss
    frac = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, ef, torch.ones_like(ef, dtype=torch.float32)) / (T * K)
    imp = probs.mean(0)
    aux = E * torch.sum(frac * imp)
    if "shared" in p and not shared_partial:
        y = y + mlp(xt[None], p["shared"], cfg)[0]
    return y.reshape(B, S, d), aux


def moe_ffn(x, p, cfg: ModelConfig):
    """MoE FFN; under a mesh, dispatch runs inside shard_map (tokens local to
    (pod, data); expert FFN dim, or whole experts, sharded over model;
    combine psum'd). With no mesh, inside a shard_map body, or on plain
    tensors under a mesh that places nothing, it is the one-device path."""
    mesh = part.region_mesh(x)
    if mesh is None:
        return _moe_local(x, p, cfg, None)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    model_axis = "model" if "model" in mesh.shape else None
    x_spec = P(dp_axes if x.shape[0] % math.prod(mesh.shape[a] for a in dp_axes) == 0 else None, None, None)
    ep_ok = cfg.moe_expert_parallel and model_axis and cfg.n_experts % mesh.shape[model_axis] == 0
    f_ok = model_axis and cfg.d_expert % mesh.shape[model_axis] == 0
    if ep_ok:  # expert-parallel: whole experts per shard
        w_specs = {
            "router": P(None, None),
            "w1": P(model_axis, None, None),
            "w3": P(model_axis, None, None),
            "w2": P(model_axis, None, None),
        }
        f_ok = True  # psum over model still required for the combine
    else:
        w_specs = {
            "router": P(None, None),
            "w1": P(None, None, model_axis) if f_ok else P(None, None, None),
            "w3": P(None, None, model_axis) if f_ok else P(None, None, None),
            "w2": P(None, model_axis, None) if f_ok else P(None, None, None),
        }
    if "shared" in p:
        sh_ok = model_axis and f_ok and all(v.shape[-1] % mesh.shape[model_axis] == 0
                                            for k, v in p["shared"].items() if k != "w2")
        w_specs["shared"] = {
            "w1": P(None, model_axis) if sh_ok else P(None, None),
            "w3": P(None, model_axis) if sh_ok else P(None, None),
            "w2": P(model_axis, None) if sh_ok else P(None, None),
        }
        if "w3" not in p["shared"]:
            w_specs["shared"].pop("w3")
    # the axes the body splits its work over (the tokens' and, with the
    # psum, model): there each rank's gradient of a replicated input is its
    # share of the total and the aux loss is averaged; over any other axis
    # (a batch that does not split over pod x data) every rank computes the
    # whole, once
    reduced = part.spec_axes(x_spec) + ((model_axis,) if f_ok else ())

    def body(xl, pl_):
        y, aux = _moe_local(xl, pl_, cfg, model_axis if f_ok else None)
        return y, part.pmean(aux, reduced)

    return part.shard_map(body, mesh, in_specs=(x_spec, w_specs), out_specs=(x_spec, P()), grad_axes=reduced)(
        x, {k: p[k] for k in w_specs})
