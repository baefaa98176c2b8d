"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-235B-A22B; family hf:Qwen/Qwen3-30B-A3B].

Fine-grained MoE: 94L, d_model=4096, 64 q / 4 kv heads (head_dim 128,
qk-norm), 128 experts top-8 with per-expert d_ff=1536, vocab=151936.
The expert-parallel stress cell (128 experts over the model axis).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    vocab_size=151936,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    qk_norm=True,
    d_ff=1536,
    mlp_kind="swiglu",
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    rope_kind="rope",
    rope_theta=1e6,
    block_kinds=("attn",),
    mlp_kinds=("moe",),
)
