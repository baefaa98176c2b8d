"""Qwen3 1.7B [hf:Qwen/Qwen3-1.7B; family hf:Qwen/Qwen3-8B].

Dense, GQA (16 q / 8 kv heads, head_dim 128), qk-norm (RMSNorm on per-head
q,k before RoPE), SwiGLU. 28L, d_model=2048, d_ff=6144, vocab=151936.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    n_layers=28,
    d_model=2048,
    vocab_size=151936,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    d_ff=6144,
    mlp_kind="swiglu",
    rope_kind="rope",
    rope_theta=1e6,
    tie_embeddings=True,
    block_kinds=("attn",),
    mlp_kinds=("dense",),
)
