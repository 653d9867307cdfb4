"""RecurrentGemma-2B [arXiv:2402.19427]: RG-LRU + local attention, ~1:2.

26 layers = 2 x 13-layer pattern (RRL RRL RRL RRL R): 18 recurrent + 8 local
attention — the paper's (R,R,A) tiling with the odd tail folded in.
"""
from .base import ModelConfig

_P = ("rglru", "rglru", "local") * 4 + ("rglru",)

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab=256000,
    pattern=_P,
    window=2048,
    lru_width=2560,
    act="gelu",
    tie_embeddings=True,
)
