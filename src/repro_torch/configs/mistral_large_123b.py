"""Mistral Large 2 (123B) [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

Dense, 88L, d_model=12288, 96 q / 8 kv heads (GQA), d_ff=28672, vocab=32768.
The deepest/widest dense assignment — the memory-capacity stress cell.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    n_layers=88,
    d_model=12288,
    vocab_size=32768,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    mlp_kind="swiglu",
    rope_kind="rope",
    rope_theta=1e6,
    block_kinds=("attn",),
    mlp_kinds=("dense",),
)
