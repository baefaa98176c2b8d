"""Qwen2-VL 2B [arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B-Instruct].

VLM *backbone only* per the assignment: 28L, d_model=1536, 12 q / 2 kv heads
(head_dim 128), d_ff=8960, vocab=151936, M-RoPE (multimodal rotary: the
head_dim halves are split into temporal/height/width sections rotated by
separate position ids). The vision frontend is a stub — ``input_specs()``
provides precomputed patch embeddings of shape (batch, seq, d_model) plus the
(3, batch, seq) M-RoPE position ids.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    n_layers=28,
    d_model=1536,
    vocab_size=151936,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    mlp_kind="swiglu",
    rope_kind="mrope",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    input_mode="embeddings",
    tie_embeddings=True,
    block_kinds=("attn",),
    mlp_kinds=("dense",),
)
