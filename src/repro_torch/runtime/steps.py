"""Train, prefill and serve steps on one device.

``make_train_step``: loss -> gradients (``torch.autograd.grad`` over the
parameter leaves) -> global-norm clip -> [the compressed cross-pod
exchange] -> AdamW, the JAX package's step (``repro.runtime.steps``) with
its arithmetic. The state is a tree of tensors and the step a plain
function: it returns a new :class:`TrainState` and leaves the one it was
given as it was (the JAX package donates it). Batch leaves (numpy arrays or
tensors) move to the parameters' device first, as ``jit`` moves its
arguments.

The compressed step is the JAX package's cross-pod exchange in its global
view: the batch splits into ``mesh.shape["pod"]`` slices, each pod's loss
and gradients are computed in turn, each gradient plus its error-feedback
residual is quantized to int8 with a per-tensor scale (the new residual is
what the quantization lost), and the pods' dequantized gradients are
averaged before the clip. On one device this is the single-node meaning of
that step; across processes the same exchange is
:func:`repro_torch.optim.grad_compress.pod_allreduce_compressed`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.tree import leaf_paths, tree_map
from ..models import decode_step, init_params, loss_fn, prefill
from ..optim.adamw import OptState, adamw_update, clip_by_global_norm, init_opt
from ..optim.grad_compress import quantize_shard
from . import sharding_rules as rules_mod
from .partitioning import P


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: OptState
    resid: Any  # error-feedback residuals, leading 'pod' axis; () when off


def make_train_state(cfg: ModelConfig, generator: torch.Generator | None = None, *, npods: int = 0, device=None):
    """Parameters from ``generator`` (see ``init_params``: on the card unless
    ``device`` says otherwise, ``"meta"`` for shapes only), zero AdamW
    moments, and zero residuals of shape ``(npods, *p.shape)`` when
    ``npods``."""
    params = init_params(cfg, generator, device)
    opt = init_opt(params)
    resid = ()
    if npods:
        resid = tree_map(lambda p: torch.zeros((npods,) + tuple(p.shape), dtype=torch.float32, device=p.device), params)
    return TrainState(params=params, opt=opt, resid=resid)


def state_pspecs(state_shapes: TrainState, cfg: ModelConfig, mesh) -> TrainState:
    """Partition specs for a TrainState (leaves need only a ``.shape``)."""
    p_spec = rules_mod.tree_pspecs(state_shapes.params, cfg, mesh)
    m_spec = rules_mod.tree_pspecs(state_shapes.opt.m, cfg, mesh)
    v_spec = rules_mod.tree_pspecs(state_shapes.opt.v, cfg, mesh)
    if isinstance(state_shapes.resid, tuple) and state_shapes.resid == ():
        r_spec = ()
    else:
        r_spec = tree_map(lambda ps: P("pod", *ps), p_spec)
    return TrainState(params=p_spec, opt=OptState(m=m_spec, v=v_spec, step=P()), resid=r_spec)


def batch_pspecs(batch_shapes, mesh):
    dp = ("pod", "data") if "pod" in mesh.shape else ("data",)

    def one(leaf):
        size = 1
        for a in dp:
            size *= mesh.shape[a]
        shape = tuple(leaf.shape)
        ax = dp if shape and shape[0] % size == 0 else None
        return P(ax, *([None] * (len(shape) - 1)))

    return tree_map(one, batch_shapes)


def batch_to(batch, device):
    """Every leaf of ``batch`` as a tensor on ``device`` (numpy arrays are
    copied over; tensors already there come back as they are)."""
    def one(x):
        t = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        return t.to(device, non_blocking=True)

    return tree_map(one, batch)


def _device_of(tree) -> torch.device:
    return next(leaf for _, leaf in leaf_paths(tree)).device


def _with_leaves(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def pod_exchange(g, r):
    """The compressed cross-pod exchange of one gradient leaf, in its
    global view. g: ``(npods, ...)`` per-pod gradients; r: their residuals.
    Each pod's ``t = g + r`` is quantized by :func:`quantize_shard`;
    returns ``(mean over pods of q * scale, t - q * scale, q, scale)``: the
    averaged gradient, the new residuals, and the int8 payloads and scales
    (``(npods, 1, ...)``) the pods exchange."""
    t = g.float() + r
    qs = [quantize_shard(tp) for tp in t]
    q = torch.stack([q for q, _ in qs])
    scale = torch.stack([s for _, s in qs]).reshape((-1,) + (1,) * (t.ndim - 1))
    new_r = t - q.float() * scale
    return torch.mean(q.float() * scale, dim=0), new_r, q, scale


def make_train_step(cfg: ModelConfig, mesh=None, *, lr=3e-4, grad_clip=1.0, compress_pods=False):
    """Returns ``step(state, batch) -> (state, metrics)`` with metrics
    ``{"loss", "grad_norm"}`` (0-d float32 tensors). The compressed
    exchange runs when ``compress_pods`` and ``mesh`` has a ``"pod"`` axis
    (``mesh`` is anything with an axis -> size ``.shape``)."""

    def _cast_params(params):
        """bf16_params: every fp32 matrix cast to bf16 before use (the
        gradient still reaches the fp32 master through the cast)."""
        if not cfg.bf16_params:
            return params
        return tree_map(lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 and p.ndim >= 2 else p, params)

    def loss_and_grads(params, batch):
        leaves = [p.detach().requires_grad_() for _, p in leaf_paths(params)]
        with torch.enable_grad():
            loss = loss_fn(_cast_params(_with_leaves(params, leaves)), cfg, batch)
            # leaves no path reaches (whisper's cross-attention biases) get
            # zeros, as jax.grad gives them
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), _with_leaves(params, grads)

    def update(state: TrainState, grads, resid, metrics: dict):
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            new_params, new_opt = adamw_update(state.params, grads, state.opt, lr)
        return TrainState(new_params, new_opt, resid), dict(metrics, grad_norm=gnorm)

    def plain_step(state: TrainState, batch):
        batch = batch_to(batch, _device_of(state.params))
        loss, grads = loss_and_grads(state.params, batch)
        return update(state, grads, state.resid, {"loss": loss})

    if not (compress_pods and mesh is not None and "pod" in mesh.shape):
        return plain_step

    npods = mesh.shape["pod"]

    def compressed_step(state: TrainState, batch):
        batch = batch_to(batch, _device_of(state.params))
        pods = [tree_map(lambda x, i=i: x.reshape((npods, x.shape[0] // npods) + tuple(x.shape[1:]))[i], batch)
                for i in range(npods)]
        losses, per_pod = [], []
        for b in pods:
            loss, grads = loss_and_grads(state.params, b)
            losses.append(loss)
            per_pod.append([g for _, g in leaf_paths(grads)])
        with torch.no_grad():
            flat_r = [r for _, r in leaf_paths(state.resid)]
            pairs = [pod_exchange(torch.stack([pod[i] for pod in per_pod]), r) for i, r in enumerate(flat_r)]
            del per_pod
            grads = _with_leaves(state.params, [p[0] for p in pairs])
            new_resid = _with_leaves(state.resid, [p[1] for p in pairs])
            loss = torch.stack(losses).mean()
        return update(state, grads, new_resid, {"loss": loss})

    return compressed_step


def make_prefill_step(cfg: ModelConfig):
    def step(params, batch):
        return prefill(params, cfg, batch)

    return step


def make_serve_step(cfg: ModelConfig):
    def step(params, cache, token, pos):
        return decode_step(params, cfg, token, pos, cache)

    return step
