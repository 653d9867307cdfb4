"""Train, prefill and serve steps, on one device or a device mesh.

``make_train_step``: loss -> gradients (``torch.autograd.grad`` over the
parameter leaves) -> global-norm clip -> [the compressed cross-pod
exchange] -> AdamW, the JAX package's step (``repro.runtime.steps``) with
its arithmetic. The state is a tree of tensors and the step a plain
function: it returns a new :class:`TrainState` and leaves the one it was
given as it was (the JAX package donates it). Batch leaves (numpy arrays or
tensors) move to the parameters' device first, as ``jit`` moves its
arguments.

The compressed step is the JAX package's cross-pod exchange. Its global
view (a ``mesh`` that is only an axis -> size ``.shape``): the batch splits
into ``mesh.shape["pod"]`` slices, each pod's loss and gradients are
computed in turn, each gradient plus its error-feedback residual is
quantized to int8 with a per-tensor scale (the new residual is what the
quantization lost), and the pods' dequantized gradients are averaged
before the clip.

Under a device mesh (``launch.mesh.make_mesh``) the state's leaves are
DTensors placed by :func:`state_pspecs` (TP over ``model``, FSDP over
``data`` where ``use_fsdp``, replicated over ``pod``) and the batch is
placed by :func:`batch_pspecs`. The loss runs on DTensors under the
activation rules, so the mean over the batch's ``pod x data`` shards is
the loss's own mean, taken once; each gradient is redistributed to its
parameter's placements, the clip's norm is one float32 number on every
rank (each leaf's sum of squares in ``leaf_paths`` order), and AdamW runs
on the local shards. The step returns the state with the placements it
was given. With ``compress_pods`` each pod computes its loss and
gradients on its slice of the batch over the ``("data", "model")``
sub-mesh; each rank quantizes its block of its pod's gradient with the
whole gradient's scale, and the pods exchange those int8 blocks over the
``pod`` axis's process group
(:func:`repro_torch.optim.grad_compress.pod_allreduce_compressed`); the
residuals are ``(npods, ...)`` leaves sharded over ``pod``.
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
from ..optim.grad_compress import pod_allreduce_compressed, quantize_shard
from . import partitioning as part
from . import sharding_rules as rules_mod
from .partitioning import NamedSharding, P


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: OptState
    resid: Any  # error-feedback residuals, leading 'pod' axis; () when off


def _placing(mesh) -> bool:
    """A mesh that places tensors (a ``launch.mesh.Mesh``), not just a shape."""
    return mesh is not None and hasattr(mesh, "device_mesh")


def make_train_state(cfg: ModelConfig, generator: torch.Generator | None = None, *, npods: int = 0, device=None,
                     mesh=None):
    """Parameters from ``generator`` (see ``init_params``: on the card unless
    ``device`` says otherwise, ``"meta"`` for shapes only), zero AdamW
    moments, and zero residuals of shape ``(npods, *p.shape)`` when
    ``npods``. Under a device mesh (``mesh``, else the installed one) the
    leaves are DTensors placed by :func:`state_pspecs` on the mesh's device
    (rank 0's draw)."""
    mesh = mesh if mesh is not None else part.get_mesh()
    if _placing(mesh):
        device = part.mesh_device(mesh.device_mesh)
    params = init_params(cfg, generator, device)
    opt = init_opt(params)
    resid = ()
    if npods:
        resid = tree_map(lambda p: torch.zeros((npods,) + tuple(p.shape), dtype=torch.float32, device=p.device), params)
    state = TrainState(params=params, opt=opt, resid=resid)
    if _placing(mesh):
        state = rules_mod.place(state, state_shardings(state, cfg, mesh))
    return state


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


def state_shardings(state_shapes: TrainState, cfg: ModelConfig, mesh) -> TrainState:
    """:func:`state_pspecs` as :class:`NamedSharding` s on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), state_pspecs(state_shapes, cfg, mesh))


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
    copied over; tensors already there come back as they are). Placed
    (DTensor) and shape-only (``meta``, fake) leaves are kept as they are:
    they have a layout, or no values, to move."""
    def one(x):
        if part.is_placed(x) or part.is_shape_only(x):
            return x
        t = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        return t.to(device, non_blocking=True)

    return tree_map(one, batch)


def place_batch(batch, mesh):
    """Every leaf of ``batch`` as a DTensor placed by :func:`batch_pspecs`."""
    batch = batch_to(batch, part.mesh_device(mesh.device_mesh))
    return rules_mod.place(batch, tree_map(lambda s: NamedSharding(mesh, s), batch_pspecs(batch, mesh)))


def _device_of(tree) -> torch.device:
    return next(leaf for _, leaf in leaf_paths(tree)).device


def _local(t):
    return t.to_local() if part.is_placed(t) else t


def _like(local, ref):
    """``local`` as a DTensor with ``ref``'s mesh and placements."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def _on_sub(t, sub):
    """A DTensor of the full mesh, replicated or split over its leading
    (``pod``) axis, as this pod's DTensor on the sub-mesh ``sub``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.to_local(), sub.device_mesh, tuple(t.placements[1:]), run_check=False)


def _full(t):
    return t.full_tensor() if part.is_placed(t) else t


def _sums_over_mesh(refs):
    """``global_norm``'s ``reduce`` on a device mesh whose blocks are placed
    as the DTensors ``refs``: each leaf's sum of squares over its distinct
    blocks (a block replicated over an axis counts once: only the rank at
    coordinate 0 there adds it), all leaves in one all-reduce."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    def reduce(sums):
        own = [s if all(c == 0 for c, pl in zip(r.device_mesh.get_coordinate(), r.placements) if pl == Replicate())
               else torch.zeros_like(s) for s, r in zip(sums, refs, strict=True)]
        total = torch.stack(own)
        dist.all_reduce(total)  # a mesh spans the whole process group
        return list(total.unbind())

    return reduce


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
    ``{"loss", "grad_norm"}`` (0-d float32 tensors, the same on every
    rank). The compressed exchange runs when ``compress_pods`` and ``mesh``
    has a ``"pod"`` axis. ``mesh`` is a device mesh (the state must then be
    placed on it, as :func:`make_train_state` places it) or anything with
    an axis -> size ``.shape`` (the one-device global view)."""

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

    pods = compress_pods and mesh is not None and "pod" in mesh.shape
    if _placing(mesh):
        return _mesh_train_step(cfg, mesh, loss_and_grads, lr=lr, grad_clip=grad_clip, compress_pods=pods)
    if not pods:
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


def _mesh_train_step(cfg: ModelConfig, mesh, loss_and_grads, *, lr, grad_clip, compress_pods):
    """The step on a device mesh (see the module's docstring)."""
    from torch.distributed.tensor.experimental import implicit_replication

    def rules_for(m):
        return part.get_rules() if part.get_mesh() is m else rules_mod.activation_rules(cfg, m)

    def grads_on(m, params, batch):
        """Loss and gradients under ``m``'s rules; each gradient placed as
        its parameter."""
        with part.mesh_rules(m, rules_for(m)), implicit_replication():
            loss, grads = loss_and_grads(params, batch)
            flat = [g.redistribute(p.device_mesh, p.placements)
                    for (_, g), (_, p) in zip(leaf_paths(grads), leaf_paths(params), strict=True)]
            return _full(loss), flat

    def update(state: TrainState, flat_g, resid, loss):
        """Clip by the global norm, then AdamW on the local shards."""
        with torch.no_grad():
            grads, norm = clip_by_global_norm(_with_leaves(state.params, [_local(g) for g in flat_g]), grad_clip,
                                              _sums_over_mesh(flat_g))
            new_p, new_opt = adamw_update(tree_map(_local, state.params), grads, tree_map(_local, state.opt), lr)

            def back(new, ref):
                return _with_leaves(ref, [_like(n, r) for (_, n), (_, r) in
                                          zip(leaf_paths(new), leaf_paths(ref), strict=True)])

            new_state = TrainState(back(new_p, state.params),
                                   OptState(m=back(new_opt.m, state.opt.m), v=back(new_opt.v, state.opt.v),
                                            step=_like(new_opt.step, state.opt.step)), resid)
        return new_state, {"loss": loss, "grad_norm": norm}

    def mesh_step(state: TrainState, batch):
        loss, flat_g = grads_on(mesh, state.params, place_batch(batch, mesh))
        return update(state, flat_g, state.resid, loss)

    if not compress_pods:
        return mesh_step

    npods = mesh.shape["pod"]
    sub = mesh.sub(mesh.axis_names[1:])
    pod_group = mesh.get_group("pod")
    sub_groups = [mesh.get_group(a) for a in mesh.axis_names[1:]]

    def pod_step(state: TrainState, batch):
        import torch.distributed as dist

        batch = tree_map(lambda b: _on_sub(b, sub), place_batch(batch, mesh))
        params = tree_map(lambda p: _on_sub(p, sub), state.params)
        loss, flat_g = grads_on(sub, params, batch)
        with torch.no_grad():
            # each rank quantizes its block of its pod's gradient with the
            # whole gradient's scale (a max over the sub-mesh), so the int8
            # payloads are the global view's; only the int8 blocks cross pods
            local_r = [r.to_local()[0] for _, r in leaf_paths(state.resid)]
            avg, new_r = pod_allreduce_compressed([_local(g) for g in flat_g], local_r, group=pod_group,
                                                  shard_groups=sub_groups)
            grads = [_like(a, p) for a, (_, p) in zip(avg, leaf_paths(state.params), strict=True)]
            resid = _with_leaves(state.resid, [_like(r[None], ref) for r, (_, ref) in
                                               zip(new_r, leaf_paths(state.resid), strict=True)])
            loss = loss.clone()
            dist.all_reduce(loss, group=pod_group)
            loss = loss / npods
        return update(state, grads, resid, loss)

    return pod_step


def _replicating(tree):
    """Where ``tree``'s leaves are placed, DTensor's ``implicit_replication``
    (the plain tensors a step makes, its masks and positions, join as
    replicated, as in the mesh train step); else nothing."""
    import contextlib

    if not any(part.is_placed(t) for _, t in leaf_paths(tree)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def make_prefill_step(cfg: ModelConfig):
    """``step(params, batch) -> (last-token logits, cache)``; on placed
    parameters the batch is placed by :func:`batch_pspecs` first."""
    def step(params, batch):
        with _replicating(params):
            mesh = part.get_mesh()
            if _placing(mesh) and any(part.is_placed(t) for _, t in leaf_paths(params)):
                batch = place_batch(batch, mesh)
            return prefill(params, cfg, batch)

    return step


def make_serve_step(cfg: ModelConfig):
    """``step(params, cache, token, pos) -> (logits, cache)``: one decode
    step; ``pos`` is an int or a 0-d tensor."""
    def step(params, cache, token, pos):
        with _replicating(params):
            return decode_step(params, cfg, token, pos, cache)

    return step
