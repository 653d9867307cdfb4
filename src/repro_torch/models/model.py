"""Model assembly: one parameterized stack covering all 10 assigned archs.

Layers are tiled from cfg.pattern and run in *pattern groups*: the
parameters of each pattern position are stacked over the groups (leaves of
``[G, ...]``, the JAX package's scanned layout), and a Python loop walks
the group axis where the JAX package runs ``lax.scan``. Heterogeneous
patterns (gemma3 5L+1G, recurrentgemma RRL...) put the whole repeating
unit inside one group. deepseek's dense prefix runs as explicit layers
before the groups.

Entry points:
  init_params(cfg, generator, device)  -> params tree
  forward(params, cfg, batch)          -> (logits, aux)      [train/eval]
  loss_fn(params, cfg, batch)          -> scalar
  prefill(params, cfg, batch)          -> (logits, cache)
  decode_step(params, cfg, token, pos, cache) -> (logits, cache)
  init_cache(cfg, batch, seq_len)      -> cache tree         [decode entry state]

Trees are nested dicts and lists of tensors with the JAX package's keys,
so their leaves flatten in its order (dict keys sorted). ``init_params``
and ``init_cache`` build on the card unless given ``device="cpu"`` and
raise where CUDA is absent (``device="meta"`` gives shapes only); the other
functions run where their tensors are. ``decode_step`` updates the cache's
tensors in place.

Under ``cfg.remat`` each pattern group's function (``forward``'s and
``prefill``'s groups, the encoder's layers) runs under
``torch.utils.checkpoint`` when autograd records it: the backward pass
recomputes the group from its inputs (policy ``"nothing"``), keeping the
matmul outputs (``"dots"``) or each layer's mixer output (``"mixer"``).
Remat changes memory, never values.
"""
from __future__ import annotations

import functools
import math
import threading

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..configs.base import ModelConfig
from ..runtime import partitioning as part
from ..runtime.partitioning import P
from . import rglru as rg
from . import ssm as ssm_mod
from .layers import (
    CDTYPE,
    MetaGenerator,
    _dense_init,
    _heads,
    _mm32,
    _scalar,
    _zeros,
    attention,
    attention_decode,
    attention_prefill,
    init_attention,
    init_mlp,
    init_moe,
    mlp,
    moe_ffn,
    position,
    rms_norm,
)


def model_device(device=None) -> torch.device:
    """Where a model is built: the card unless ``device`` says otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the models run on the card unless given device='cpu'")
    return dev


# ------------------------------------------------------------------ helpers
def _slice(tree, g: int):
    """Group ``g`` of a tree of ``[G, ...]`` leaves (views)."""
    if isinstance(tree, dict):
        return {k: _slice(v, g) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice(v, g) for v in tree)
    return tree[g]


def _stack(trees: list):
    """The inverse of :func:`_slice`: one tree of leaves stacked over ``trees``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


def _layer_kinds(cfg: ModelConfig):
    """(kind, is_moe) per scanned pattern position."""
    out = []
    for k in cfg.pattern:
        is_moe = cfg.n_experts > 0 and k in ("attn", "local")
        out.append((k, is_moe))
    return tuple(out)


_NAMES = threading.local()  # .saved: names the running remat policy keeps; .marking: the name being marked
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def checkpoint_name(x, name: str):
    """``jax.ad_checkpoint.checkpoint_name``: mark ``x`` for a policy that
    saves it by name. Outside such a policy ``x`` comes back as it is;
    inside, as a copy made by one recognisable op (values unchanged)."""
    if name not in getattr(_NAMES, "saved", ()):
        return x
    _NAMES.marking = name
    try:
        return torch.ops.aten.clone.default(x)
    finally:
        _NAMES.marking = None


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _save_marked(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.clone.default and getattr(_NAMES, "marking", None) is not None:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(f, cfg: ModelConfig):
    """``f`` under ``torch.utils.checkpoint`` when ``cfg.remat`` (and autograd
    records the call): policy ``"nothing"`` saves only the inputs, ``"dots"``
    the matmul outputs, ``"mixer"`` each layer's mixer output."""
    if not cfg.remat:
        return f
    saved = ("mixer_out",) if cfg.remat_policy == "mixer" else ()

    def named(*args):
        old = getattr(_NAMES, "saved", ())
        _NAMES.saved = saved
        try:
            return f(*args)
        finally:
            _NAMES.saved = old

    if cfg.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy == "mixer":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_marked)
    else:
        context_fn = None

    def run(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        kw = {"context_fn": context_fn} if context_fn is not None else {}
        return checkpoint(named, *args, use_reentrant=False, **kw)

    return run


def _d(x):
    return x.to(CDTYPE)


# ------------------------------------------------------------------ init
def init_block(gen, cfg: ModelConfig, kind: str, *, moe: bool, cross: bool = False, dense_ff: int | None = None,
               lead=()):
    p: dict = {"ln1": _zeros(gen, (cfg.d_model,), lead=lead)}
    if kind in ("attn", "local", "bidir"):
        p["attn"] = init_attention(gen, cfg, lead=lead)
    elif kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, lead=lead)
    elif kind == "rglru":
        p["rglru"] = rg.init_rglru(gen, cfg, lead=lead)
    else:
        raise ValueError(kind)
    if cross:
        p["ln_x"] = _zeros(gen, (cfg.d_model,), lead=lead)
        p["cross"] = init_attention(gen, cfg, lead=lead)
    if kind != "ssm" and (cfg.d_ff > 0 or moe):
        p["ln2"] = _zeros(gen, (cfg.d_model,), lead=lead)
        p["moe" if moe else "mlp"] = init_moe(gen, cfg, lead=lead) if moe else init_mlp(gen, cfg, dense_ff, lead=lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, device=None) -> dict:
    """Random fp32 parameters with the JAX package's tree, drawn from
    ``generator`` (seed 0 on ``device`` when None; it must live on
    ``device``; None on ``"meta"``, where torch has no generator). The
    values differ from ``jax.random``'s draws."""
    dev = model_device(device)
    if generator is None:
        gen = MetaGenerator() if dev.type == "meta" else torch.Generator(device=dev).manual_seed(0)
    else:
        gen = generator
    if gen.device.type != dev.type:
        raise ValueError(f"the generator lives on {gen.device}, the parameters on {dev}")
    params: dict = {
        "embed": _dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": _zeros(gen, (cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(gen, (cfg.d_model, cfg.vocab), scale=0.02)
    cross = cfg.enc_layers > 0
    # dense prefix (deepseek first_dense)
    prefix = [init_block(gen, cfg, "attn", moe=False, cross=cross, dense_ff=cfg.d_ff) for _ in range(cfg.first_dense)]
    if prefix:
        params["prefix"] = prefix
    # pattern groups: each position's leaves stacked over the G groups
    G = cfg.n_groups
    params["stack"] = [init_block(gen, cfg, kind, moe=moe, cross=cross, lead=(G,)) for kind, moe in _layer_kinds(cfg)]
    if cfg.enc_layers:  # whisper encoder
        params["enc_stack"] = [init_block(gen, cfg, "bidir", moe=False, lead=(cfg.enc_layers,))]
        params["enc_norm"] = _zeros(gen, (cfg.d_model,))
    return params


# ------------------------------------------------------------------ blocks
def block_apply(x, p, cfg: ModelConfig, kind: str, moe: bool, memory=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _branch_in(x, p["ln1"], cfg)
    if kind in ("attn", "local", "bidir"):
        m = attention(h, p["attn"], cfg, kind=kind)
    elif kind == "ssm":
        m = ssm_mod.ssm_block(h, p["ssm"], cfg)
    else:
        m = rg.rglru_block(h, p["rglru"], cfg)
    m = checkpoint_name(m, "mixer_out")
    x = x + m
    if "cross" in p and memory is not None:
        h = _branch_in(x, p["ln_x"], cfg)
        x = x + attention(h, p["cross"], cfg, kind="cross", memory=memory)
    if "moe" in p:
        h = _branch_in(x, p["ln2"], cfg)
        f, aux = moe_ffn(h, p["moe"], cfg)
        x = x + f
    elif "mlp" in p:
        h = _branch_in(x, p["ln2"], cfg)
        x = x + mlp(h, p["mlp"], cfg)
    x = part.shard(x, "batch", "act_seq", "embed")
    return x, aux


# ------------------------------------------------------------------ forward
def _embed(params, cfg: ModelConfig, tokens):
    """``bf16(embed)[tokens] * sqrt(d)`` as the JAX package computes it
    (the rows are gathered before the cast: the same values, without a
    bf16 copy of the whole table). A placed table gathers through
    ``embedding``, whose sharding rules DTensor has (a vocab-split table
    too); plain indexing's backward has none in every torch release."""
    table = params["embed"]
    if part.region_mesh(table) is not None:
        rows = _embed_placed(table, tokens, part.region_mesh(table))
    else:
        rows = torch.nn.functional.embedding(tokens, table) if part.is_placed(table) else table[tokens]
    x = _d(rows)
    return x * _scalar(x, math.sqrt(cfg.d_model))


def _embed_placed(table, tokens, mesh):
    """The rows of a placed (V, d) table for ``tokens``, in a manual region:
    each rank looks its tokens up in its block of the vocab (rows of other
    blocks are zeros) and the blocks' rows are summed over the vocab's axis
    (one real row plus zeros: the gather's values). DTensor's own
    vocab-parallel embedding leaves a masked partial sum whose gradient
    torch 2.11 cannot redistribute."""
    vs = part.resolve(("vocab", None), tuple(table.shape), mesh)
    ts = part.resolve(("batch",) + (None,) * (tokens.ndim - 1), tuple(tokens.shape), mesh)
    ax = vs[0]

    def body(tab, tok):
        if ax is None:
            return tab[tok]
        n = tab.shape[0]
        idx = tok.long() - part.axis_index(ax) * n
        mine = (idx >= 0) & (idx < n)
        return part.psum(tab[idx.clamp(0, n - 1)] * mine[..., None], ax)

    out = P(*ts, None)
    if not part.is_placed(tokens):
        tokens = part.place_like(tokens, mesh.device_mesh, part.placements(ts, mesh))
    return part.shard_map(body, mesh, in_specs=(vs, ts), out_specs=out, grad_axes=part.spec_axes(out))(table, tokens)


def _embed_inputs(params, cfg: ModelConfig, batch):
    x = _embed(params, cfg, batch["tokens"])
    if cfg.stub_frontend == "vit" and "img" in batch:
        x = torch.cat([_d(batch["img"]), x], dim=1)
    return part.shard(x, "batch", "act_seq", "embed")


def _encode(params, cfg: ModelConfig, frames):
    """Whisper encoder over stub frame embeddings (B, enc_seq, d)."""
    x = part.shard(_d(frames), "batch", "act_seq", "embed")

    def grp(x, sl):
        x, _ = block_apply(x, sl, cfg, "bidir", False)
        return x

    f = _remat(grp, cfg)
    stacked = params["enc_stack"][0]
    for g in range(cfg.enc_layers):
        x = f(x, _slice(stacked, g))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _branch_in(x, scale, cfg: ModelConfig):
    """A branch's input from the residual stream: ``rms_norm``; where the
    rules split the stream's sequence (``act_seq``), then whole over it, as
    Megatron's sequence parallelism gathers it before the branch's matmuls
    (torch 2.11's DTensor flattens batch and sequence for a matmul only where
    the sequence is whole)."""
    h = rms_norm(x, scale, cfg.norm_eps)
    return part.shard(h, "batch", None, "embed") if part.get_rules().get("act_seq") else h


def _logits(params, cfg: ModelConfig, x):
    x = _branch_in(x, params["final_norm"], cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # bf16 operands, fp32 accumulation (the reference's preferred_element_type)
    logits = _mm32("bsd,dv->bsv", x.to(CDTYPE), head.to(CDTYPE))
    return part.shard(logits, "batch", "act_seq", "vocab")


def forward(params, cfg: ModelConfig, batch):
    """Full-sequence forward. Returns (logits (B,S,V), aux loss scalar)."""
    memory = _encode(params, cfg, batch["frames"]) if cfg.enc_layers else None
    x = _embed_inputs(params, cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params.get("prefix", []):
        x, aux = block_apply(x, p, cfg, "attn", False, memory)
        aux_total = aux_total + aux
    kinds = _layer_kinds(cfg)

    def group_fn(x, slices):
        aux_g = torch.zeros((), dtype=torch.float32, device=x.device)
        for p_i, (kind, moe) in enumerate(kinds):
            x, aux = block_apply(x, slices[p_i], cfg, kind, moe, memory)
            aux_g = aux_g + aux
        return x, aux_g

    f = _remat(group_fn, cfg)
    auxs = []
    for g in range(cfg.n_groups):
        x, aux_g = f(x, _slice(params["stack"], g))
        auxs.append(aux_g)
    # the JAX package adds the scanned groups' stacked aux terms with one sum
    return _logits(params, cfg, x), aux_total + torch.stack(auxs).sum()


def _logsumexp(logits):
    """``logsumexp`` over the vocab. Placed logits (the vocab split over
    ``model``) take it as max + log(sum(exp(x - max))): a max and a sum
    all-reduce of (B, S) numbers, where DTensor's ``logsumexp`` gathers
    the whole vocab first. The max is a constant to the gradient."""
    if not part.is_placed(logits):
        return torch.logsumexp(logits, dim=-1)
    m = logits.detach().amax(dim=-1, keepdim=True)
    # the sum whole over the vocab's axis, its gradient too (DTensor would
    # otherwise pick the gradient's layout, and then gather the vocab to match it)
    total = part.settle_grad(_summed(torch.sum(torch.exp(logits - m), dim=-1)))
    return torch.log(total) + m[..., 0]


def _summed(t):
    """A placed ``t`` with its partial sums reduced (``Partial`` -> ``Replicate``)."""
    from torch.distributed.tensor import Partial, Replicate

    pl = tuple(Replicate() if isinstance(p, Partial) else p for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh, pl)


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy over the positions whose label is >= 0,
    in float32, plus ``cfg.aux_loss_coef`` times the MoE balance loss. On
    the vit family the image positions carry label -1."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    if cfg.stub_frontend == "vit" and "img" in batch:  # image positions carry no loss
        pad = torch.full(batch["img"].shape[:2], -1, dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    mask = labels >= 0
    lse = _logsumexp(logits)
    # the label's logit: a gather equals the JAX package's masked sum, which
    # adds that one logit to zeros; on a mesh the logits' vocab axis is
    # split, and the masked sum (a partial sum per shard) is what runs
    if part.is_placed(logits):
        from torch.distributed.tensor import Replicate, Shard

        # the vocab iota split as the logits' vocab axis, so the mask, the
        # masked sum and its gradient stay split too
        iota_v = part.place_like(torch.arange(logits.shape[-1], dtype=labels.dtype, device=labels.device),
                                 logits.device_mesh, [Shard(0) if pl == Shard(logits.ndim - 1) else Replicate()
                                                      for pl in logits.placements])
        ll = torch.sum(torch.where(labels[..., None] == iota_v, logits, 0.0), dim=-1)
        ll = part.settle_grad(_summed(ll))  # whole over the vocab's axis, its gradient too
    else:
        ll = torch.take_along_dim(logits, labels.clamp(min=0).long()[..., None], dim=-1)[..., 0]
    nll = torch.where(mask, lse - ll, torch.zeros((), dtype=lse.dtype, device=lse.device))
    loss = nll.sum() / torch.clamp(mask.sum(), min=1)
    return loss + cfg.aux_loss_coef * aux


# ------------------------------------------------------------------ caches
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=CDTYPE, device=None):
    """Decode-entry cache: capacity seq_len KV (window for local), states for
    ssm/rglru, precomputed cross-attn KV for enc-dec. Zeros on the card
    unless given ``device="cpu"``."""
    dev = model_device(device)
    Hk, dh = cfg.n_kv_heads, cfg.d_head
    G = cfg.n_groups

    def zeros(shape, dt, lead):
        return torch.zeros(tuple(lead) + tuple(shape), dtype=dt, device=dev)

    def kv(C, lead):
        if cfg.kv_quant:
            return {
                "k": zeros((batch, C, Hk, dh), torch.int8, lead),
                "v": zeros((batch, C, Hk, dh), torch.int8, lead),
                "k_scale": zeros((batch, C, Hk), torch.float32, lead),
                "v_scale": zeros((batch, C, Hk), torch.float32, lead),
            }
        return {"k": zeros((batch, C, Hk, dh), dtype, lead), "v": zeros((batch, C, Hk, dh), dtype, lead)}

    def one(kind, lead=()):
        if kind == "attn":
            c = kv(seq_len, lead)
        elif kind == "local":
            c = kv(min(cfg.window, seq_len), lead)
        elif kind == "ssm":
            c = ssm_mod.ssm_init_cache(cfg, batch, dtype, device=dev, lead=lead)
        else:
            c = rg.rglru_init_cache(cfg, batch, dtype, device=dev, lead=lead)
        if cfg.enc_layers:
            c = dict(c, xk=zeros((batch, cfg.enc_seq, Hk, dh), dtype, lead),
                     xv=zeros((batch, cfg.enc_seq, Hk, dh), dtype, lead))
        return c

    cache = {"stack": [one(kind, (G,)) for kind, _ in _layer_kinds(cfg)]}
    if cfg.first_dense:
        cache["prefix"] = [one("attn") for _ in range(cfg.first_dense)]
    return cache


def _block_decode(x1, p, cfg, kind, cache, pos):
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "local"):
        m, new = attention_decode(h, p["attn"], cfg, cache, pos, kind=kind)
    elif kind == "ssm":
        m, new = ssm_mod.ssm_decode(h, p["ssm"], cfg, {"state": cache["state"], "conv": cache["conv"]})
    else:
        m, new = rg.rglru_decode(h, p["rglru"], cfg, {"h": cache["h"], "conv": cache["conv"]})
    new_cache = dict(cache, **new)
    x1 = x1 + m
    if "cross" in p:
        h = rms_norm(x1, p["ln_x"], cfg.norm_eps)
        m, _ = attention_decode(h, p["cross"], cfg, {"k": cache["xk"], "v": cache["xv"]}, pos, kind="cross")
        x1 = x1 + m
    if "moe" in p:
        h = rms_norm(x1, p["ln2"], cfg.norm_eps)
        f, _ = moe_ffn(h, p["moe"], cfg)
        x1 = x1 + f
    elif "mlp" in p:
        h = rms_norm(x1, p["ln2"], cfg.norm_eps)
        x1 = x1 + mlp(h, p["mlp"], cfg)
    return x1, new_cache


def _write_back(stacked, group, sliced, new):
    """Copy group ``g``'s new leaves into the stacked cache where a leaf is
    a new tensor (the recurrent states); attention leaves come back as the
    views of ``sliced`` they were updated in place through."""
    for k, v in new.items():
        if v is not sliced[k]:
            stacked[k][group].copy_(v)


def decode_step(params, cfg: ModelConfig, token, pos, cache):
    """token: (B,) int; pos: slot of the new token, an int or a 0-d tensor.

    Returns (logits (B,V), cache): the cache's tensors are updated in
    place and the same tree is returned."""
    pos = position(pos)
    x = _embed(params, cfg, token)[:, None]  # (B,1,d)
    new_prefix = []
    for p, c in zip(params.get("prefix", []), cache.get("prefix", [])):
        x, nc = _block_decode(x, p, cfg, "attn", c, pos)
        new_prefix.append(nc)
    kinds = _layer_kinds(cfg)
    for g in range(cfg.n_groups):
        pslice = _slice(params["stack"], g)
        for p_i, (kind, _) in enumerate(kinds):
            stacked = cache["stack"][p_i]
            sliced = _slice(stacked, g)
            x, nc = _block_decode(x, pslice[p_i], cfg, kind, sliced, pos)
            _write_back(stacked, g, sliced, nc)
    logits = _logits(params, cfg, x)[:, 0]
    new_cache = {"stack": list(cache["stack"])}
    if new_prefix:
        new_cache["prefix"] = new_prefix
    return logits, new_cache


def prefill(params, cfg: ModelConfig, batch, cache_len: int | None = None):
    """Run the context once, returning (last-token logits, decode cache)."""
    memory = _encode(params, cfg, batch["frames"]) if cfg.enc_layers else None
    x = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    C = cache_len or S

    def block_prefill(x, p, kind):
        h = _branch_in(x, p["ln1"], cfg)
        if kind in ("attn", "local"):
            m, kvc = attention_prefill(h, p["attn"], cfg, kind=kind, cache_len=C)
        elif kind == "ssm":
            m, kvc = ssm_mod.ssm_block(h, p["ssm"], cfg, return_cache=True)
        else:
            m, kvc = rg.rglru_block(h, p["rglru"], cfg, return_cache=True)
        x = x + m
        if "cross" in p and memory is not None:
            h = _branch_in(x, p["ln_x"], cfg)
            x = x + attention(h, p["cross"], cfg, kind="cross", memory=memory)
            kvc = dict(kvc,
                       xk=_heads(memory @ p["cross"]["wk"].to(x.dtype), cfg.n_kv_heads, cfg.d_head, "seq_kv", "kv_heads"),
                       xv=_heads(memory @ p["cross"]["wv"].to(x.dtype), cfg.n_kv_heads, cfg.d_head, "seq_kv", "kv_heads"))
        if "moe" in p:
            h = _branch_in(x, p["ln2"], cfg)
            f, _ = moe_ffn(h, p["moe"], cfg)
            x = x + f
        elif "mlp" in p:
            h = _branch_in(x, p["ln2"], cfg)
            x = x + mlp(h, p["mlp"], cfg)
        return x, kvc

    new_prefix = []
    for p in params.get("prefix", []):
        x, c = block_prefill(x, p, "attn")
        new_prefix.append(c)
    kinds = _layer_kinds(cfg)

    def group_fn(x, pslice):
        cs = []
        for p_i, (kind, _) in enumerate(kinds):
            x, c = block_prefill(x, pslice[p_i], kind)
            cs.append(c)
        return x, cs

    f = _remat(group_fn, cfg)
    groups = []
    for g in range(cfg.n_groups):
        x, cs = f(x, _slice(params["stack"], g))
        groups.append(cs)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    cache = {"stack": _stack(groups)}
    if new_prefix:
        cache["prefix"] = new_prefix
    return logits, cache
