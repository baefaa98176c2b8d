"""Jamba v0.1 52B [arXiv:2403.19887; hf:ai21labs/Jamba-v0.1].

Hybrid Mamba+attention at 1:7 interleave (one attention layer per 8-layer
cycle, at position 3 as in the release), MoE (16 experts, top-2) on every
other layer. 32L, d_model=4096, 32 q heads / 8 kv heads, d_ff=14336,
vocab=65536. The release uses Mamba-1 blocks; we instantiate Mamba-2 (SSD)
blocks — the state-space-duality form maps onto the MXU as chunked matmuls,
whereas Mamba-1's diagonal scan does not (hardware adaptation, DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    vocab_size=65536,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    mlp_kind="swiglu",
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_kind="none",  # Jamba uses no positional encoding in attention
    block_kinds=("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba"),
    mlp_kinds=("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe"),
    subquadratic=True,  # 4 attention layers; KV cache is small => long_500k runs
)
