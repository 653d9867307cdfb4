"""Shape-and-dtype stand-ins for every model input — no allocation.

The JAX package's ``repro.launch.specs`` with tensors on the ``meta``
device where it has ``jax.ShapeDtypeStruct``s, built by the port's own
init functions. input_specs(arch, shape) gives the *step argument* specs
for the cell:
  train_4k   -> train_step(state, batch)
  prefill_32k-> prefill_step(params, batch)
  decode_32k / long_500k -> serve_step(params, cache, token, pos)
"""
from __future__ import annotations

import torch

from ..configs import SHAPES, get_config
from ..configs.base import ModelConfig
from ..models import init_cache, init_params
from ..runtime import partitioning as part
from ..runtime.steps import make_train_state

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, seq: int, gbatch: int) -> dict:
    """Training/prefill batch: tokens+labels (+ stub-frontend embeddings)."""
    text = seq
    out = {}
    if cfg.stub_frontend == "vit":
        text = seq - cfg.n_img_tokens
        out["img"] = _spec((gbatch, cfg.n_img_tokens, cfg.d_model), torch.bfloat16)
    if cfg.enc_layers:
        out["frames"] = _spec((gbatch, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    out["tokens"] = _spec((gbatch, text), torch.int32)
    out["labels"] = _spec((gbatch, text), torch.int32)
    return out


def state_specs(cfg: ModelConfig, *, npods: int = 0):
    """The train state's shapes, placed on no mesh (an installed one too)."""
    with part.mesh_rules(None):
        return make_train_state(cfg, None, npods=npods, device=META)


def params_specs(cfg: ModelConfig):
    return init_params(cfg, None, META)


def cache_specs(cfg: ModelConfig, gbatch: int, seq: int):
    return init_cache(cfg, gbatch, seq, device=META)


def input_specs(arch: str, shape: str, *, npods: int = 0, cfg: ModelConfig | None = None):
    """Returns (kind, specs dict) for the (arch x shape) cell."""
    cfg = cfg or get_config(arch)
    seq, gbatch, kind = SHAPES[shape]
    if kind == "train":
        return kind, {
            "state": state_specs(cfg, npods=npods),
            "batch": batch_specs(cfg, seq, gbatch),
        }
    if kind == "prefill":
        return kind, {
            "params": params_specs(cfg),
            "batch": batch_specs(cfg, seq, gbatch),
        }
    # decode: one new token against a cache of `seq`
    return kind, {
        "params": params_specs(cfg),
        "cache": cache_specs(cfg, gbatch, seq),
        "token": _spec((gbatch,), torch.int32),
        "pos": _spec((), torch.int32),
    }
