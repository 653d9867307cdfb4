"""Granite-34B-code [arXiv:2405.04324]: deep MQA (kv=1) llama-arch."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    act="gelu",
)
