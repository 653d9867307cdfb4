"""Mamba2-370m [arXiv:2405.21060]: attention-free SSD (state-space duality)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab=50280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    tie_embeddings=True,
)
