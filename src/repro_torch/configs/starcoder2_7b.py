"""StarCoder2-7B [arXiv:2402.19173; hf:bigcode/starcoder2-7b].

Dense code model: 32L, d_model=4608, 36 q / 4 kv heads (GQA), RoPE,
d_ff=18432, vocab=49152. (The release uses sliding-window attention in half
the layers; the assignment specifies the dense-GQA backbone, which we follow.)
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    n_layers=32,
    d_model=4608,
    vocab_size=49152,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    mlp_kind="gelu",  # StarCoder2 uses an ungated GELU FFN (d_ff = 4·d_model)
    rope_kind="rope",
    rope_theta=1e5,
    block_kinds=("attn",),
    mlp_kinds=("dense",),
)
