"""InternVL2-1B [arXiv:2404.16821]: InternLM2 LM backbone + InternViT frontend.

The ViT is a stub per assignment: input_specs supplies precomputed patch
embeddings (n_img_tokens x d_model) concatenated ahead of the text tokens.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    rope_theta=1e6,
    stub_frontend="vit",
    n_img_tokens=256,
    tie_embeddings=True,
)
