"""repro_torch.models — the LM stack on plain tensor trees.

The JAX package's ``repro.models`` (layers, model, rglru, ssm) as plain
functions on nested dicts and lists of tensors with its keys; ``convert``
carries its parameters and caches across as numpy trees.
"""
from .model import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    model_device,
    prefill,
)
