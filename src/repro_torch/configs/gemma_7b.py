"""Gemma 7B [arXiv:2403.08295; hf:google/gemma-7b].

Dense: 28L, d_model=3072, 16 heads with head_dim=256 (q/k/v project to 4096 >
d_model — exercised explicitly), kv=16 (MHA on 7b; MQA on 2b), GeGLU with
d_ff=24576, vocab=256000 (the embedding-dominated assignment), embeddings
scaled by sqrt(d_model), tied LM head.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    vocab_size=256000,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    mlp_kind="geglu",
    rope_kind="rope",
    rope_theta=1e4,
    embed_scale=True,
    tie_embeddings=True,
    block_kinds=("attn",),
    mlp_kinds=("dense",),
)
