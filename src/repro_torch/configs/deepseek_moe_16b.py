"""DeepSeekMoE-16B [arXiv:2401.06066]: 2 shared + 64 routed top-6, first layer dense."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,           # dense prefix layer FFN
    vocab=102400,
    n_experts=64,
    top_k=6,
    n_shared=2,
    d_expert=1408,
    first_dense=1,
)
