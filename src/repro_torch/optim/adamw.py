"""AdamW with the JAX package's arithmetic, on trees of tensors.

The formula is ``repro.optim.adamw``'s, not ``torch.optim.AdamW``'s (which
decays as ``p * (1 - lr * wd)`` and divides by ``sqrt(v) / sqrt(c2) + eps``):
``u = (m / c1) / (sqrt(v / c2) + eps) + wd * p`` with ``c1 = 1 - b1**t`` and
``c2 = 1 - b2**t`` computed in float32 from the step count, as XLA computes
them. The moments mirror the parameters' tree; :class:`OptState` is a
dataclass, so the shared tree walk names its leaves ``opt_m_...``,
``opt_v_...`` and ``opt_step`` inside a train state, as the JAX package's
checkpoints do. The functions return new tensors and leave their inputs as
they were.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.tree import leaf_paths, tree_map


@dataclasses.dataclass
class OptState:
    m: Any
    v: Any
    step: torch.Tensor  # 0-d int32: updates applied so far


def init_opt(params) -> OptState:
    """Zero moments (float32, each parameter's shape and device) at step 0."""
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = [leaf for _, leaf in leaf_paths(params)]
    dev = leaves[0].device if leaves else None
    return OptState(m=tree_map(z, params), v=tree_map(z, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads, reduce=None) -> torch.Tensor:
    """sqrt of the float32 sum of every leaf's sum of squares, the leaves
    added in the tree walk's order (``jax.tree.leaves``'). ``reduce`` maps
    the list of the leaves' sums to the whole tensors' sums where the leaves
    are ranks' blocks of them (one collective for all; the step on a device
    mesh passes it)."""
    sums = [torch.sum(torch.square(g.float())) for _, g in leaf_paths(grads)]
    if reduce is not None:
        sums = reduce(sums)
    g2 = None
    for s in sums:
        g2 = s if g2 is None else g2 + s
    return torch.sqrt(g2)


def clip_by_global_norm(grads, max_norm: float, reduce=None):
    """``(grads * min(1, max_norm / max(norm, 1e-9)), norm)``; ``reduce`` as
    :func:`global_norm`'s."""
    norm = global_norm(grads, reduce)
    # a tensor numerator: torch turns ``number / tensor`` into reciprocal-then-multiply
    scale = torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(params, grads, opt: OptState, lr, *, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """One AdamW step: ``(new_params, new OptState)``; each parameter keeps
    its dtype, the moments are float32."""
    step = opt.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
    flat_p = [x for _, x in leaf_paths(params)]
    flat_g = [x for _, x in leaf_paths(grads)]
    flat_m = [x for _, x in leaf_paths(opt.m)]
    flat_v = [x for _, x in leaf_paths(opt.v)]
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v, strict=True):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + eps) + wd * p.float()
        new_p.append((p.float() - lr * u).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    its = [iter(new_p), iter(new_m), iter(new_v)]
    return (tree_map(lambda _: next(its[0]), params),
            OptState(m=tree_map(lambda _: next(its[1]), opt.m), v=tree_map(lambda _: next(its[2]), opt.v), step=step))
