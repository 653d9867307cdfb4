"""repro_torch.models — the LM stack's serving half on plain tensor trees.

The JAX package's ``repro.models`` (layers, model, rglru, ssm) as plain
functions on nested dicts and lists of tensors with its keys; ``convert``
carries its parameters and caches across as numpy trees.
"""
from .model import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    model_device,
    prefill,
)
