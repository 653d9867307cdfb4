"""Whisper-small [arXiv:2212.04356]: 12L enc + 12L dec, conv frontend stubbed.

input_specs supplies precomputed mel-frame embeddings (enc_seq x d_model);
positions use RoPE on the backbone (absolute-positional tables are a
tokenizer/frontend artifact; noted in DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,          # decoder depth; encoder depth below
    enc_layers=12,
    enc_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    qkv_bias=True,
    stub_frontend="audio",
)
