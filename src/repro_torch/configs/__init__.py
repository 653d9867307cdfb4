"""Architecture registry: --arch <id> -> ModelConfig.

The JAX package's configs (``repro.configs``) copied field for field, so
the port reads them without importing that package; plain data, no torch.
"""
from __future__ import annotations

from .base import ModelConfig, active_param_count, param_count  # noqa: F401
from .codeqwen15_7b import CONFIG as _codeqwen
from .deepseek_moe_16b import CONFIG as _deepseek
from .gemma3_12b import CONFIG as _gemma3
from .granite_34b import CONFIG as _granite
from .internvl2_1b import CONFIG as _internvl2
from .mamba2_370m import CONFIG as _mamba2
from .olmoe_1b_7b import CONFIG as _olmoe
from .recurrentgemma_2b import CONFIG as _rgemma
from .whisper_small import CONFIG as _whisper
from .yi_34b import CONFIG as _yi

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _internvl2,
        _whisper,
        _yi,
        _codeqwen,
        _gemma3,
        _granite,
        _mamba2,
        _rgemma,
        _olmoe,
        _deepseek,
    )
}

# input shapes assigned to every LM arch: (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention (DESIGN.md §Arch-applicability)
LONG_CONTEXT_OK = {"mamba2-370m", "recurrentgemma-2b", "gemma3-12b"}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; long_500k only where applicable."""
    for a in ARCHS:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_CONTEXT_OK and not include_skipped:
                continue
            yield a, s
