"""Parameter sharding rules: param path + shape -> partition spec.

The JAX package's policy (``repro.runtime.sharding_rules``), as pure
functions of a leaf's path, its shape, the config and the mesh's axis
sizes:

  * tensor parallelism over 'model': FFN hidden dim, attention heads (when
    head counts divide), vocab/embedding, expert FFN dim, LRU width;
  * FSDP (ZeRO-3) over 'data' for archs above a parameter threshold: the
    non-TP matrix dim is sharded; optimizer state mirrors parameters;
  * parameters are replicated across 'pod' (cross-pod sync is the explicit,
    optionally compressed, gradient exchange in runtime/steps.py).

Archs whose head counts don't divide the model axis (yi 56H, internvl2 14H,
whisper 12H, recurrentgemma 10H) keep attention weights model-replicated and
parallelize attention over the sequence instead (activation rules). A mesh
is anything with an axis -> size ``.shape`` mapping; tree leaves need only
a ``.shape`` (tensors on the ``meta`` device will do). :func:`tree_shardings`
and :func:`place` need a real mesh (``launch.mesh.make_mesh``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, param_count
from ..core.tree import children, leaf_paths, tree_map
from .partitioning import NamedSharding, P, is_placed, is_shape_only, mesh_device

FSDP_THRESHOLD = 2_000_000_000
SEQPAR_THRESHOLD = 8_000_000_000  # residual-stream sequence parallelism


def _ok(dim: int, mesh, ax: str | None):
    return ax if ax and ax in mesh.shape and dim % mesh.shape[ax] == 0 else None


def use_fsdp(cfg: ModelConfig) -> bool:
    if cfg.force_fsdp >= 0:
        return bool(cfg.force_fsdp)
    return param_count(cfg) >= FSDP_THRESHOLD


def use_seqpar(cfg: ModelConfig) -> bool:
    if cfg.force_seqpar >= 0:
        return bool(cfg.force_seqpar)
    return param_count(cfg) >= SEQPAR_THRESHOLD


def activation_rules(cfg: ModelConfig, mesh) -> dict:
    """Logical-axis rules for this arch (see runtime.partitioning)."""
    m = mesh.shape.get("model", 1)
    heads_ok = cfg.n_heads % m == 0
    kv_ok = cfg.n_kv_heads % m == 0
    big = use_seqpar(cfg)
    return {
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        # sequence-TP fallback for attention when heads don't divide
        "seq": None if heads_ok else "model",
        "seq_kv": None,  # KV never seq-sharded in train: blockwise tiles slice freely
        "kv_seq": "model",
        "ffn": "model",
        "vocab": "model",
        "expert_ffn": "model",
        "ssm_heads": "model",
        "batch": ("pod", "data") if "pod" in mesh.shape else ("data",),
        # sequence parallelism on the saved residual stream: bounds the
        # per-device remat carries of deep/wide archs (yi, granite, ...)
        "act_seq": "model" if big else None,
        "embed": None,
        "lru": "model",
        "experts": None,
    }


def param_pspec(path: str, shape: tuple, cfg: ModelConfig, mesh) -> P:
    fsdp = "data" if use_fsdp(cfg) else None
    m = mesh.shape.get("model", 1)
    name = path.split("/")[-1]
    in_attn = "/attn/" in path or "/cross/" in path
    in_moe = "/moe/" in path and "/shared/" not in path
    lead = (None,) * (len(shape) - 2)  # stacked group axes / expert axis prefix

    def spec(*tail):
        # drop axes that don't divide
        full = lead + tail
        fixed = []
        for ax, dim in zip(full, shape):
            fixed.append(_ok(dim, mesh, ax) if isinstance(ax, str) else None if ax is None else ax)
        return P(*fixed)

    if name == "embed":
        return P(_ok(shape[0], mesh, "model"), _ok(shape[1], mesh, fsdp))
    if name == "lm_head":
        return P(_ok(shape[0], mesh, fsdp), _ok(shape[1], mesh, "model"))
    if in_moe:
        if name == "router":
            return spec(None, None)
        ep = cfg.moe_expert_parallel and cfg.n_experts % max(m, 1) == 0
        if name in ("w1", "w3"):
            # (E, d, f): expert-parallel shards E; else TP on f
            return P(_ok(shape[0], mesh, "model"), _ok(shape[1], mesh, fsdp), None) if ep else spec(fsdp, "model")
        if name == "w2":
            return P(_ok(shape[0], mesh, "model"), None, _ok(shape[2], mesh, fsdp)) if ep else spec("model", fsdp)
    if in_attn:
        # projections are 2-axis sharded regardless of head divisibility:
        # storage is FSDP-style; a gather on use where heads don't divide
        if name in ("wq", "wk", "wv"):
            return spec(fsdp, "model")
        if name in ("bq", "bk", "bv"):
            return spec("model")
        if name == "wo":
            return spec("model", fsdp)
    if "/mlp/" in path or "/shared/" in path:
        if name in ("w1", "w3"):
            return spec(fsdp, "model")
        if name == "w2":
            return spec("model", fsdp)
    if "/ssm/" in path:
        if name == "in_proj":
            return spec(fsdp, None)
        if name == "out_proj":
            return spec("model", fsdp)
        return spec(*([None] * len(shape)))
    if "/rglru/" in path:
        if name in ("w_gelu", "w_x"):
            return spec(fsdp, "model")
        if name in ("w_r", "w_i"):
            return spec("model", None)
        if name == "w_out":
            return spec("model", fsdp)
        if name == "conv_w":
            return spec(None, "model")
        return spec(*([None] * len(shape)))
    # norms, biases, scalars
    return spec(*([None] * len(shape)))


def map_with_path(fn, tree, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, where ``path``
    is ``/``-joined keys as the JAX package writes ``jax.tree_util`` key
    paths (``/stack/0/attn/wq``; a dataclass field as ``/.name``)."""
    kids = children(tree)
    if kids is None:
        return fn(path, tree)
    if tree is None:
        return None
    is_dc = not isinstance(tree, (dict, list, tuple))

    def key(k):
        return f".{k}" if is_dc else str(k)

    mapped = {k: map_with_path(fn, child, f"{path}/{key(k)}") for k, child in kids}
    if isinstance(tree, dict):
        return type(tree)((k, mapped[k]) for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(mapped[k] for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(mapped[i] for i in range(len(tree)))
    return dataclasses.replace(tree, **mapped)


def tree_pspecs(tree, cfg: ModelConfig, mesh):
    """Tree of partition specs matching ``tree`` (works on meta tensors)."""
    return map_with_path(lambda path, leaf: param_pspec(path, tuple(leaf.shape), cfg, mesh), tree)


def tree_shardings(tree, cfg: ModelConfig, mesh):
    """``tree_pspecs`` as :class:`NamedSharding` s on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), tree_pspecs(tree, cfg, mesh))


def place(tree, shardings):
    """``jax.device_put(tree, shardings)``: every leaf as a DTensor laid out
    by its :class:`NamedSharding` (a tree of them, or one for every leaf),
    on the mesh's device. Rank 0's values are the ones placed (a
    ``distribute_tensor`` scatter), so ranks that drew different values
    still agree. DTensor leaves are redistributed where their placements
    differ and kept where they agree. A shape-only leaf (``meta`` or fake)
    becomes a DTensor of this rank's shape-only block, with no copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    flat = [leaf for _, leaf in leaf_paths(tree)]
    shs = [shardings] * len(flat) if isinstance(shardings, NamedSharding) else \
        [s for _, s in leaf_paths(shardings)]
    if len(shs) != len(flat):
        raise ValueError(f"{len(flat)} leaves, {len(shs)} shardings")
    out = []
    for leaf, sh in zip(flat, shs, strict=True):
        dm = sh.mesh.device_mesh
        if is_placed(leaf):
            same = leaf.device_mesh == dm and tuple(leaf.placements) == tuple(sh.placements)
            out.append(leaf if same else leaf.redistribute(dm, sh.placements))
            continue
        if is_shape_only(leaf):
            size = tuple(s.stop - s.start for s in sh.local_slices(tuple(leaf.shape)))
            local = torch.empty(size, dtype=leaf.dtype, device=leaf.device)
            out.append(DTensor.from_local(local, dm, sh.placements, run_check=False, shape=leaf.shape,
                                          stride=leaf.stride()))
            continue
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
        out.append(distribute_tensor(t.detach().to(mesh_device(dm)), dm, sh.placements))
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def cache_pspec(path: str, shape: tuple, cfg: ModelConfig, mesh, rules: dict) -> P:
    """KV-cache / recurrent-state sharding for serve steps."""
    name = path.split("/")[-1]
    dp = rules.get("batch", ("data",))
    dp = dp if isinstance(dp, tuple) else (dp,)
    bs = 1
    for a in dp:
        bs *= mesh.shape.get(a, 1)
    batch_ax = dp if shape[0] % max(bs, 1) == 0 and bs > 1 else None
    if name in ("k", "v", "xk", "xv") and len(shape) == 4:
        # (B, T, Hk, dh): prefer cache-length sharding, else kv heads
        t_ax = _ok(shape[1], mesh, "model")
        h_ax = _ok(shape[2], mesh, "model") if t_ax is None else None
        return P(batch_ax, t_ax, h_ax, None)
    if name == "state" and len(shape) == 4:  # (B, H, N, P)
        return P(batch_ax, _ok(shape[1], mesh, "model"), None, None)
    if name == "h":  # (B, L)
        return P(batch_ax, _ok(shape[1], mesh, "model"))
    return P(batch_ax, *([None] * (len(shape) - 1)))


def cache_pspecs(tree, cfg: ModelConfig, mesh, rules: dict):
    def one(ps, leaf):
        shp = tuple(leaf.shape)
        if len(shp) >= 1 and "/stack/" in ps:  # stacked group axis leads
            inner = cache_pspec(ps, shp[1:], cfg, mesh, rules)
            return P(None, *inner)
        return cache_pspec(ps, shp, cfg, mesh, rules)

    return map_with_path(one, tree)
