"""Gemma3-12B [hf:google/gemma-3 family]: 5 local : 1 global, 128k context."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    act="gelu",
    rope_theta=1e6,
    tie_embeddings=True,
)
