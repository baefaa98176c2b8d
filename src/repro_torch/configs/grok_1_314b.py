"""Grok-1 314B [hf:xai-org/grok-1; unverified].

Coarse MoE: 64L, d_model=6144, 48 q / 8 kv heads (head_dim 128), 8 experts
top-2 with d_ff=32768, vocab=131072. 8 experts < 16-way model axis → the
sharding rules use expert-TP (shard d_ff within experts) instead of pure EP
(DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    vocab_size=131072,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    mlp_kind="swiglu",
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    rope_kind="rope",
    rope_theta=1e4,
    block_kinds=("attn",),
    mlp_kinds=("moe",),
)
