"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak=3e-4, warmup=100, total=10000, floor=0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``. ``step`` may be a number or a tensor
    (taken as float32); a tensor gives a float32 tensor, as the JAX
    package's ``jnp`` arithmetic does."""
    step = step.to(torch.float32) if isinstance(step, torch.Tensor) else torch.tensor(float(step), dtype=torch.float32)
    warm = peak * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
